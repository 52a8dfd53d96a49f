"""Panel store: aligned firm x month matrices + the synthetic generator.

A numpy copy of ``lfm_quant_tpu/data/panel.py`` (the port imports nothing
from the JAX package). ``synthetic_panel`` draws the same numbers in the
same order, so one seed gives the same arrays, byte for byte, in both
packages; ``tests/test_torch_panel.py`` holds the two to that.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

DEFAULT_FEATURES_5 = (
    "ebit_ev",  # earnings yield style value factor
    "book_to_market",
    "asset_growth",
    "momentum_12m",
    "accruals",
)

_EXTRA_FEATURES = (
    "gross_profitability",
    "roe",
    "roa",
    "leverage",
    "sales_growth",
    "capex_to_assets",
    "rnd_to_sales",
    "cash_to_assets",
    "dividend_yield",
    "short_term_reversal",
    "volatility_12m",
    "turnover",
    "size_log_mktcap",
    "earnings_variability",
    "net_share_issuance",
)

DEFAULT_FEATURES_20 = DEFAULT_FEATURES_5 + _EXTRA_FEATURES


@dataclasses.dataclass
class Panel:
    """A firm×month fundamentals panel in dense, mask-annotated form.

    Attributes:
      features: ``[N, T, F]`` float32 — standardized fundamental features.
        Invalid (firm, month) cells are zero-filled.
      targets:  ``[N, T]`` float32 — the supervised forecast target aligned to
        the *anchor* month: ``targets[i, t]`` is the future-fundamental value
        (e.g. EBIT/EV twelve months ahead) that a model predicting at month
        ``t`` is scored against.  Zero-filled where invalid.
      target_valid: ``[N, T]`` bool — target observable (anchor valid AND the
        lookahead month exists; False in the last ``horizon`` live months of
        a firm's history and after delisting).
      valid:    ``[N, T]`` bool — firm has data at month t (between first and
        last live month, minus missing rows).
      returns:  ``[N, T]`` float32 — forward 1-month total return from month
        t to t+1, used by the backtester. Zero-filled where invalid.
      ret_valid: ``[N, T]`` bool or None — forward return OBSERVED (firm
        still listed at t+1). None means "trust ``valid``". Distinct from
        ``valid`` to prevent delisting/survivorship bias: a firm with
        features at t but no t+1 observation must be excluded from the
        month-t tradeable universe, not credited a fabricated 0% return.
      dates:    ``[T]`` int32 — months as YYYYMM.
      firm_ids: ``[N]`` int32 — stable firm identifiers (gvkey-style).
      feature_names: length-F list of feature names.
      horizon:  months between anchor and target observation (default 12).
    """

    features: np.ndarray
    targets: np.ndarray
    target_valid: np.ndarray
    valid: np.ndarray
    returns: np.ndarray
    dates: np.ndarray
    firm_ids: np.ndarray
    feature_names: Sequence[str]
    horizon: int = 12
    ret_valid: Optional[np.ndarray] = None

    @property
    def n_firms(self) -> int:
        return int(self.features.shape[0])

    @property
    def n_months(self) -> int:
        return int(self.features.shape[1])

    @property
    def n_features(self) -> int:
        return int(self.features.shape[2])

    def validate(self) -> None:
        n, t, f = self.features.shape
        assert self.targets.shape == (n, t), self.targets.shape
        assert self.valid.shape == (n, t)
        assert self.target_valid.shape == (n, t)
        assert self.returns.shape == (n, t)
        assert self.dates.shape == (t,)
        assert self.firm_ids.shape == (n,)
        assert len(self.feature_names) == f
        assert self.features.dtype == np.float32
        assert self.valid.dtype == np.bool_
        assert not np.any(self.target_valid & ~self.valid), (
            "target_valid must imply valid"
        )
        assert np.all(np.isfinite(self.features))
        assert np.all(np.isfinite(self.targets))
        assert np.all(np.isfinite(self.returns))
        if self.ret_valid is not None:
            assert self.ret_valid.shape == (n, t)
            assert self.ret_valid.dtype == np.bool_

    def tradeable(self) -> np.ndarray:
        """``[N, T]`` bool: in-universe AND forward return observed."""
        if self.ret_valid is None:
            return self.valid
        return self.valid & self.ret_valid

    def date_slice(self, start: int, stop: int) -> "Panel":
        """Restrict the panel to months with start <= YYYYMM < stop."""
        sel = (self.dates >= start) & (self.dates < stop)
        (idx,) = np.nonzero(sel)
        if idx.size == 0:
            raise ValueError(f"empty date slice [{start}, {stop})")
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        return dataclasses.replace(
            self,
            features=self.features[:, lo:hi],
            targets=self.targets[:, lo:hi],
            target_valid=self.target_valid[:, lo:hi],
            valid=self.valid[:, lo:hi],
            returns=self.returns[:, lo:hi],
            dates=self.dates[lo:hi],
            ret_valid=(None if self.ret_valid is None
                       else self.ret_valid[:, lo:hi]),
        )

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        extra = {}
        if self.ret_valid is not None:
            extra["ret_valid"] = self.ret_valid
        np.savez_compressed(
            os.path.join(path, "panel.npz"),
            features=self.features,
            targets=self.targets,
            target_valid=self.target_valid,
            valid=self.valid,
            returns=self.returns,
            dates=self.dates,
            firm_ids=self.firm_ids,
            **extra,
        )
        with open(os.path.join(path, "panel_meta.json"), "w") as fh:
            json.dump(
                {"feature_names": list(self.feature_names), "horizon": self.horizon},
                fh,
            )


def load_panel(path: str) -> Panel:
    """Load a panel saved by :meth:`Panel.save`."""
    with np.load(os.path.join(path, "panel.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(path, "panel_meta.json")) as fh:
        meta = json.load(fh)
    p = Panel(
        features=arrays["features"],
        targets=arrays["targets"],
        target_valid=arrays["target_valid"],
        valid=arrays["valid"],
        returns=arrays["returns"],
        dates=arrays["dates"],
        firm_ids=arrays["firm_ids"],
        feature_names=meta["feature_names"],
        horizon=meta["horizon"],
        ret_valid=arrays.get("ret_valid"),
    )
    p.validate()
    return p


def _month_range(start_yyyymm: int, n_months: int) -> np.ndarray:
    y, m = divmod(start_yyyymm, 100)
    months = []
    for _ in range(n_months):
        months.append(y * 100 + m)
        m += 1
        if m > 12:
            m = 1
            y += 1
    return np.asarray(months, dtype=np.int32)


def synthetic_panel(
    n_firms: int = 1000,
    n_months: int = 240,
    n_features: int = 5,
    start_yyyymm: int = 197001,
    horizon: int = 12,
    signal_strength: float = 0.6,
    noise: float = 0.5,
    het_noise: float = 0.0,
    trend_weight: float = 0.5,
    phi_range: Tuple[float, float] = (0.94, 0.995),
    min_history: int = 72,
    seed: int = 0,
) -> Panel:
    """Generate a Compustat-like panel with a planted, recoverable signal.

    The generative story (chosen so every moving part of the framework is
    exercised, per SURVEY.md §5):

    * Features follow per-firm AR(1) dynamics with firm fixed effects, so
      lookback windows carry real information beyond the last month.
    * The forecast target at anchor ``t`` is a fixed linear combination of the
      current features plus a nonlinear interaction plus a *trend* term (the
      mean feature drift over the trailing year). CAVEAT, measured
      (2026-07-31, ledger ``derived_features`` rows): at DEFAULT
      parameters the anchor month proxies essentially all recoverable
      signal — the 0.94–0.995 AR(1) persistence makes ``x_t`` carry the
      trend's usable content, and anchor-only, windowed-MLP, windowed-
      LSTM, and derived-``chg_12`` models all tie within ±0.01 val IC.
      The generator separates window models from anchor models only when
      the trend weight is raised or persistence lowered — the
      ``trend_weight`` and ``phi_range`` parameters exist for exactly
      that (measured: ``trend_weight=2.0, phi_range=(0.5, 0.7)`` gives a
      windowed MLP +0.024 val IC over the anchor-only MLP at a 10-epoch
      budget; the separation is real but stays modest at small budgets).
      Tests that need it must set these knobs explicitly rather than
      rely on the defaults.
    * Forward returns = next-month target innovation × ``signal_strength`` +
      idiosyncratic noise, so a correct forecast ranks next-month winners and
      the backtest shows positive IC/alpha on the planted signal.
    * Ragged histories: each firm gets a random [first, last] live span of at
      least ``min_history`` months, with a small rate of missing months
      inside the span.
    * ``het_noise > 0`` makes the target noise HETEROSCEDASTIC and
      *learnable*: cell (i, t)'s noise scale is
      ``noise · exp(het_noise · feats[i, t, -1])`` — driven by the LAST
      feature, which sits in the model's own input window (anchor-last),
      so an NLL head can and must recover the profile, and
      ``mean_minus_total_std`` aggregation has real predicted-variance
      differences to act on. (A latent per-firm scale independent of the
      features would be unlearnable by construction — the first draft of
      this testbed made exactly that mistake.) The default 0.0 keeps
      every existing test's homoscedastic generator byte-identical.
    """
    if n_features < 2:
        raise ValueError("need >= 2 features for the planted interaction term")
    if n_months <= min_history:
        raise ValueError(
            f"n_months={n_months} must exceed min_history={min_history} "
            "(every firm needs a live span shorter than the panel)"
        )
    rng = np.random.default_rng(seed)
    names = list((DEFAULT_FEATURES_20 * ((n_features // 20) + 1))[:n_features])
    for i in range(20, n_features):
        names[i] = f"{names[i]}_{i // 20}"

    # AR(1) feature dynamics with firm fixed effects.
    # Fundamentals are sticky: high AR(1) persistence + sizeable firm fixed
    # effects make the 12-month-ahead target genuinely forecastable, which the
    # signal-recovery tests rely on.
    phi = rng.uniform(phi_range[0], phi_range[1],
                      size=(1, 1, n_features)).astype(np.float32)
    firm_mean = (0.6 * rng.standard_normal((n_firms, 1, n_features))).astype(np.float32)
    innov_scale = np.sqrt(1.0 - phi**2).astype(np.float32)  # unit stationary var
    feats = np.empty((n_firms, n_months, n_features), dtype=np.float32)
    x = rng.standard_normal((n_firms, n_features)).astype(np.float32)
    for t in range(n_months):
        eps = rng.standard_normal((n_firms, n_features)).astype(np.float32)
        x = phi[:, 0] * x + innov_scale[:, 0] * eps
        feats[:, t] = x + firm_mean[:, 0]

    # Planted signal: linear + one interaction + trailing-12m trend of feat 0.
    w = np.zeros((n_features,), dtype=np.float32)
    w[: min(5, n_features)] = np.asarray([0.8, -0.5, 0.4, 0.6, -0.3])[: min(5, n_features)]
    lin = feats @ w
    inter = 0.4 * feats[..., 0] * feats[..., 1]
    trend = np.zeros((n_firms, n_months), dtype=np.float32)
    trend[:, 12:] = feats[:, 12:, 0] - feats[:, :-12, 0]
    signal = lin + inter + trend_weight * trend

    if het_noise > 0.0:
        # Noise scale driven by the OBSERVABLE last feature AT THE ANCHOR
        # month (clipped so a tail draw can't explode the target range).
        # Targets built at raw month τ are later shifted to anchor
        # t = τ − horizon, so the driver must be indexed τ − horizon for
        # the anchor's own window — in the model's input — to carry the
        # noise information. No extra rng draw on either branch:
        # het_noise=0.0 keeps the legacy RNG stream — and every seeded
        # fixture — byte-identical.
        driver = np.zeros((n_firms, n_months), np.float32)
        if horizon < n_months:
            driver[:, horizon:] = feats[:, :-horizon, -1]
        cell_scale = np.exp(
            het_noise * np.clip(driver, -2.5, 2.5)).astype(np.float32)
    else:
        # Plain python 1.0: a float32 scalar would demote a python-float
        # `noise` under NEP 50 and break legacy byte-identity in the
        # last ulp for noise values not representable in float32.
        cell_scale = 1.0
    targets = (signal + noise * cell_scale
               * rng.standard_normal((n_firms, n_months))).astype(np.float32)

    # Forward 1-month returns: loaded on the *future* signal so that ranking
    # firms by a good forecast of `targets` earns positive forward returns.
    ret_noise = 0.06 * rng.standard_normal((n_firms, n_months)).astype(np.float32)
    fwd_sig = np.zeros((n_firms, n_months), dtype=np.float32)
    fwd_sig[:, :-1] = signal[:, 1:]
    returns = (0.01 * signal_strength * fwd_sig + ret_noise).astype(np.float32)

    # Ragged live spans.
    valid = np.zeros((n_firms, n_months), dtype=np.bool_)
    max_start = max(n_months - min_history, 1)
    starts = rng.integers(0, max_start, size=n_firms)
    for i in range(n_firms):
        lo = int(starts[i])
        span = int(rng.integers(min_history, n_months - lo + 1))
        valid[i, lo : lo + span] = True
    # Sparse missing months inside spans (data vendor gaps).
    gaps = rng.random((n_firms, n_months)) < 0.01
    valid &= ~gaps

    # Target observability: anchor valid AND t+horizon within the firm's span.
    target_valid = np.zeros_like(valid)
    if horizon < n_months:
        target_valid[:, :-horizon] = valid[:, :-horizon] & valid[:, horizon:]
    # Targets are the realized future signal: shift so targets[i,t] is the
    # fundamental observed at t+horizon.
    shifted = np.zeros_like(targets)
    if horizon < n_months:
        shifted[:, :-horizon] = targets[:, horizon:]
    targets = shifted

    feats = np.where(valid[..., None], feats, 0.0).astype(np.float32)
    targets = np.where(target_valid, targets, 0.0).astype(np.float32)
    returns = np.where(valid, returns, 0.0).astype(np.float32)

    # Forward return observable only while the firm is still listed at t+1.
    ret_valid = np.zeros_like(valid)
    ret_valid[:, :-1] = valid[:, :-1] & valid[:, 1:]

    panel = Panel(
        features=feats,
        targets=targets,
        target_valid=target_valid,
        valid=valid,
        returns=returns,
        dates=_month_range(start_yyyymm, n_months),
        firm_ids=np.arange(1, n_firms + 1, dtype=np.int32),
        feature_names=names,
        horizon=horizon,
        ret_valid=ret_valid,
    )
    panel.validate()
    return panel


@dataclasses.dataclass
class PanelSplits:
    """Date-based train/val/test split over ONE shared panel.

    The panel is NOT sliced: every split is an *anchor-month index range*
    over the same arrays. This is deliberate and load-bearing:

    * Lookback windows anchored early in the val/test range legitimately
      reach back into earlier months for history — slicing the panel would
      amputate that context (a 60-month window has no eligible anchors in
      a 24-month slice at all).
    * One panel ⇒ one HBM-resident copy serving train, eval and inference.
    * No leakage: what separates the splits is the *anchor* (and therefore
      target/trade) months, not feature visibility — same firms, separated
      in time, the standard protocol for this workload.  Training anchors
      are additionally embargoed ``horizon`` months before ``train_end`` so
      no training target is realized inside the validation period.
    """

    panel: Panel
    train_end_idx: int  # first month index NOT in train
    val_end_idx: int    # first month index NOT in val
    # First month index IN train: 0 = expanding window (train on all
    # history, the reference protocol); nonzero = rolling window (fixed-
    # length train periods — the walk-forward mode whose folds keep
    # identical batch shapes, which is what lets the cross-fold reuse
    # layer bind one set of compiled programs for the whole sweep).
    train_start_idx: int = 0

    @staticmethod
    def by_date(panel: Panel, train_end: int, val_end: int,
                train_start: Optional[int] = None) -> "PanelSplits":
        """Boundaries as YYYYMM: train = [train_start, train_end), val =
        [train_end, val_end), test = [val_end, end). ``train_start``
        None = panel start (expanding window). Each period must be
        longer than ``panel.horizon`` so the target-embargoed anchor ranges
        (see ``train_range``/``val_range``) stay non-empty."""
        dates = panel.dates
        t_idx = int(np.searchsorted(dates, train_end))
        v_idx = int(np.searchsorted(dates, val_end))
        s_idx = (int(np.searchsorted(dates, train_start))
                 if train_start is not None else 0)
        if not (0 < t_idx < v_idx < panel.n_months):
            raise ValueError(
                f"split boundaries ({train_end}, {val_end}) must fall "
                f"strictly inside the panel's date range "
                f"[{dates[0]}, {dates[-1]}] in order")
        h = panel.horizon
        if t_idx - s_idx <= h or v_idx - t_idx <= h:
            raise ValueError(
                f"train period ({t_idx - s_idx} months) and val period "
                f"({v_idx - t_idx} months) must each exceed the target "
                f"horizon ({h} months) for embargoed anchors to exist")
        return PanelSplits(panel=panel, train_end_idx=t_idx,
                           val_end_idx=v_idx, train_start_idx=s_idx)

    @property
    def train_range(self) -> tuple:
        """Anchor range for training, embargoed so targets (realized
        ``horizon`` months after the anchor) stay inside the train period."""
        return (self.train_start_idx, self.train_end_idx - self.panel.horizon)

    @property
    def val_range(self) -> tuple:
        """Anchor range for validation, embargoed at the far end so no val
        target is realized inside the test period (early stopping selects
        on val IC — without this embargo, checkpoint selection would be
        conditioned on test-period outcomes)."""
        return (self.train_end_idx, self.val_end_idx - self.panel.horizon)

    @property
    def test_range(self) -> tuple:
        return (self.val_end_idx, self.panel.n_months)

    def range_of(self, split: str) -> tuple:
        try:
            return {"train": self.train_range, "val": self.val_range,
                    "test": self.test_range}[split]
        except KeyError:
            raise ValueError(f"unknown split {split!r}") from None
