"""Derived features: a copy of ``lfm_quant_tpu/data/features.py`` (the
port imports nothing from the JAX package).

``add_derived_features(panel, specs)`` appends price- and
fundamental-momentum columns computed on the host from the panel's own
returns and features (``mom_<L>_<S>``, ``vol_<K>``, ``rev_<K>``,
``chg_<name>_<K>``), each winsorized and z-scored per month like the
loader's columns (``winsorize_zscore``, ``standardize_column``, shared
with ``data/compustat.py``); ``DataConfig.derived_features`` names them
for ``train/loop.py resolve_panel``. Below the docstring the module is
its original line for line, the ``Panel`` import aside
(``tests/test_torch_panel.py`` holds it to that and its panels byte-equal
to the original's), so its comments speak of the JAX package's device.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence, Tuple

import numpy as np

from lfm_quant_tpu_torch.data.panel import Panel

_SPEC_RE = re.compile(
    r"^(?:mom_(?P<mL>\d+)_(?P<mS>\d+)|vol_(?P<vK>\d+)|rev_(?P<rK>\d+)"
    r"|chg_(?P<cname>.+)_(?P<cK>\d+))$")

# One small-month policy for the whole panel: months with fewer valid
# firms than this get no standardized values (the loader invalidates
# them outright; derived columns zero-fill). Shared with
# data/compustat.py so base and derived columns never drift apart.
MIN_CROSS_SECTION = 5


def winsorize_zscore(x: np.ndarray,
                     winsor: Optional[Tuple[float, float]]) -> np.ndarray:
    """One month's valid cross-section ``[K, F]`` (or ``[K]``) →
    winsorized + z-scored per column — THE standardization recipe, used
    by the loader's fundamental columns (data/compustat.py) and the
    derived columns here. Order-statistic quantiles (no interpolation):
    an interpolated 99th pct is itself dragged by a single extreme
    outlier."""
    if winsor is not None:
        lo = np.nanquantile(x, winsor[0], axis=0, method="higher")
        hi = np.nanquantile(x, winsor[1], axis=0, method="lower")
        x = np.clip(x, lo, hi)
    mu = x.mean(axis=0)
    sd = x.std(axis=0)
    sd = np.where(sd < 1e-8, 1.0, sd)
    return (x - mu) / sd


def _trailing_log_returns(panel: Panel) -> Tuple[np.ndarray, np.ndarray]:
    """(lr, obs): lr[i, u] = log1p of the return earned over (u-1, u]
    — ``panel.returns[:, u-1]`` (forward-indexed) — and obs marks it
    observed. Column 0 has no trailing month."""
    n, t = panel.returns.shape
    rv = panel.ret_valid if panel.ret_valid is not None else panel.valid
    lr = np.zeros((n, t), np.float64)
    obs = np.zeros((n, t), bool)
    lr[:, 1:] = np.log1p(np.clip(panel.returns[:, :-1], -0.9999, None))
    obs[:, 1:] = rv[:, :-1]
    lr[~obs] = 0.0
    return lr, obs


def _window_sum(x: np.ndarray, obs: np.ndarray, lo: int, hi: int
                ) -> np.ndarray:
    """At each anchor t: sum of ``x[:, u]`` over the trailing months
    ``u`` in ``(t-lo, t-hi]``; NaN where any constituent month is
    unobserved (or the window extends before the panel)."""
    n, t = x.shape
    out = np.full((n, t), np.nan)
    if lo >= t:
        return out
    cs = np.concatenate([np.zeros((n, 1)), np.cumsum(x, axis=1)], axis=1)
    cn = np.concatenate([np.zeros((n, 1), int),
                         np.cumsum(obs, axis=1)], axis=1)
    width = lo - hi
    # anchor t in [lo, T): window months [t-lo+1, t-hi] = cs[b] - cs[a]
    # with a = t-lo+1, b = t-hi+1.
    b = np.arange(lo - hi + 1, t - hi + 1)
    a = b - width
    vals = cs[:, b] - cs[:, a]
    full = (cn[:, b] - cn[:, a]) == width
    out[:, lo:] = np.where(full, vals, np.nan)
    return out


def _raw_column(panel: Panel, spec: str, lr_obs=None) -> np.ndarray:
    """[N, T] raw derived values (NaN = unavailable at that anchor).

    ``lr_obs``: precomputed :func:`_trailing_log_returns` pair, so a
    multi-spec load does the panel-wide log-return pass once."""
    m = _SPEC_RE.match(spec)
    if not m:
        raise ValueError(
            f"unknown feature spec {spec!r}; expected mom_<L>_<S>, "
            "vol_<K>, rev_<K> or chg_<name>_<K>")
    g = m.groupdict()
    if g["cname"] is None and lr_obs is None:
        lr_obs = _trailing_log_returns(panel)
    if g["mL"] is not None:
        L, S = int(g["mL"]), int(g["mS"])
        if not 0 <= S < L:
            raise ValueError(f"{spec!r}: need lookback > skip >= 0")
        lr, obs = lr_obs
        return _window_sum(lr, obs, L, S)
    if g["vK"] is not None:
        K = int(g["vK"])
        if K < 2:
            raise ValueError(f"{spec!r}: vol needs K >= 2")
        lr, obs = lr_obs
        s1 = _window_sum(lr, obs, K, 0)
        s2 = _window_sum(lr * lr, obs, K, 0)
        var = np.maximum(s2 / K - (s1 / K) ** 2, 0.0)
        return np.sqrt(var)
    if g["rK"] is not None:
        K = int(g["rK"])
        if K < 1:
            raise ValueError(f"{spec!r}: rev needs K >= 1")
        lr, obs = lr_obs
        return -_window_sum(lr, obs, K, 0)
    name, K = g["cname"], int(g["cK"])
    if name not in panel.feature_names:
        raise ValueError(
            f"{spec!r}: no feature column {name!r} "
            f"(have {list(panel.feature_names)})")
    if K < 1:
        raise ValueError(f"{spec!r}: chg needs K >= 1")
    j = list(panel.feature_names).index(name)
    col = panel.features[:, :, j].astype(np.float64)
    avail = panel.valid
    out = np.full(col.shape, np.nan)
    out[:, K:] = col[:, K:] - col[:, :-K]
    out[:, K:] = np.where(avail[:, K:] & avail[:, :-K], out[:, K:], np.nan)
    return out


def standardize_column(raw: np.ndarray, month_valid: np.ndarray,
                       winsor: Tuple[float, float] = (0.01, 0.99),
                       min_cross_section: int = MIN_CROSS_SECTION
                       ) -> np.ndarray:
    """Per-month :func:`winsorize_zscore` of one [N, T] column over its
    available cross-section; unavailable cells → 0 (the z-mean)."""
    avail = np.isfinite(raw) & month_valid
    out = np.zeros(raw.shape, np.float32)
    for j in range(raw.shape[1]):
        sel = avail[:, j]
        if sel.sum() < min_cross_section:
            continue
        out[sel, j] = winsorize_zscore(raw[sel, j], winsor)
    return out


def add_derived_features(panel: Panel, specs: Sequence[str],
                         winsor: Tuple[float, float] = (0.01, 0.99),
                         min_cross_section: int = MIN_CROSS_SECTION
                         ) -> Panel:
    """Append derived feature columns to a panel (new Panel; input is
    untouched). ``specs`` — see the module docstring. Months/firms keep
    their validity: a valid month with an unavailable derived value gets
    the zero-imputed (z-mean) cell, like the base features."""
    if not specs:
        return panel
    lr_obs = _trailing_log_returns(panel)
    cols = [standardize_column(_raw_column(panel, s, lr_obs), panel.valid,
                               winsor, min_cross_section)
            for s in specs]
    features = np.concatenate(
        [panel.features] + [c[..., None] for c in cols], axis=2)
    return dataclasses.replace(
        panel,
        features=features.astype(np.float32),
        feature_names=list(panel.feature_names) + list(specs),
    )
