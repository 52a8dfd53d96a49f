"""Device-resident scoring: the fused predict → aggregate → backtest path.

The port of ``lfm_quant_tpu/backtest/jax_engine.py``. The numpy engine
(``backtest/engine.py``) walks the months one at a time on the host; here
every month of every aggregation mode is one pass of plain PyTorch on the
device, as the JAX engine's one jitted dispatch is. Months are independent
given the forecast panel, so the monthly loop becomes a leading ``[T]``
axis (and the modes a leading ``[G]`` axis); the turnover chain, the one
sequential piece, resolves each used month's predecessor with a cumulative
max over month indices and is one gather.

* :func:`run_backtest_torch` — drop-in twin of ``engine.run_backtest``:
  portfolio formation (stable masked argsort ranks and the exact
  ``k``-of-``n`` selection from a host k-table), the monthly rank ICs
  (``ops/metrics.hard_ranks`` / ``pearson_ic``), the equal-weight
  benchmark, the decile profile and the turnover/cost chain; the host
  fetches a few ``[G, T]`` series and hands them to the shared
  ``engine.assemble_report``.
* :func:`aggregate_scores_device` — every aggregation mode (mean,
  mean − λ·std, mean − λ·total_std, any λ grid) from one stacked
  ``[S, N, T]`` forecast tensor.
* :func:`run_scoring_pipeline` — aggregate and backtest a whole mode
  sweep in one core pass.

Parity with the numpy engine (``tests/test_torch_backtest.py``):

* The selection count ``k = max(1, int(round(n * quantile)))`` comes from
  a k-table built on the host in float64 with numpy's round-half-even; a
  float32 product on the device can land on the other side of .5.
* ``torch.argsort(..., stable=True)``: invalid slots go to +inf, so the
  universe keeps numpy's stable subset order and tied forecasts form the
  same portfolios. The ranks are scattered into a fresh tensor.
* Profile sums and the report statistics are accumulated on the host in
  float64 by ``assemble_report``.

No Pallas kernel backs this: the JAX core is XLA-compiled, and its port is
plain PyTorch.
"""

from __future__ import annotations

import functools
import threading
import weakref
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from lfm_quant_tpu_torch.backtest.engine import (
    BacktestReport,
    assemble_report,
    mode_label,
    normalize_modes,
)
from lfm_quant_tpu_torch.data.panel import Panel
from lfm_quant_tpu_torch.device import resolve_device
from lfm_quant_tpu_torch.ops.metrics import hard_ranks, pearson_ic

# Mode name → which uncertainty tensor the λ-penalty scales.
_MODE_KINDS = {"mean": 0, "mean_minus_std": 1, "mean_minus_total_std": 2}

ModeSpec = Union[str, Tuple[str, float]]


# ---- device residency ---------------------------------------------------
#
# The backtest's panel arrays (forward returns, targets, validity,
# tradeability) are not part of the training device panel. A panel is
# scored many times (every fold, every mode sweep), so they get their own
# residency cache: one transfer per (panel object, device), month-major
# ([T, N]). Keyed by identity and dropped when the panel is collected.

_SCORE_PANEL_LOCK = threading.Lock()
_SCORE_PANEL_CACHE: dict = {}


def _device_score_panel(panel: Panel, device: torch.device) -> dict:
    # Lock-guarded: a cold-panel race must pay one transfer, not two.
    key = (id(panel), str(device))
    with _SCORE_PANEL_LOCK:
        hit = _SCORE_PANEL_CACHE.get(key)
        if hit is not None:
            return hit

        def month_major(a):
            return torch.from_numpy(np.ascontiguousarray(a.T)).to(device)

        dev = {"returns": month_major(panel.returns),
               "targets": month_major(panel.targets),
               "target_valid": month_major(panel.target_valid),
               "tradeable": month_major(panel.tradeable())}
        _SCORE_PANEL_CACHE[key] = dev
        weakref.finalize(panel, _gc_pop_score, id(panel))
        return dev


def _gc_pop_score(panel_id: int) -> None:
    with _SCORE_PANEL_LOCK:
        for key in [k for k in _SCORE_PANEL_CACHE if k[0] == panel_id]:
            del _SCORE_PANEL_CACHE[key]


def clear_score_panel_cache() -> None:
    """Drop all device-resident scoring panels (tests / memory pressure)."""
    with _SCORE_PANEL_LOCK:
        _SCORE_PANEL_CACHE.clear()


def invalidate_score_panel(panel: Panel) -> int:
    """Drop this panel's device-resident scoring arrays, on every device:
    a panel mutated in place must never be scored against stale device
    returns or targets. Returns the entries dropped. (A pass in flight
    holds its own references, so dropping the entry cannot tear it.)"""
    with _SCORE_PANEL_LOCK:
        keys = [k for k in _SCORE_PANEL_CACHE if k[0] == id(panel)]
        for key in keys:
            del _SCORE_PANEL_CACHE[key]
        return len(keys)


@functools.lru_cache(maxsize=32)
def _k_table(n_firms: int, quantile: float, device: str) -> torch.Tensor:
    """Exact numpy portfolio sizes for every possible universe count:
    ``k_table[n] = max(1, int(round(n * quantile)))`` in host float64
    (round-half-even, like the numpy engine), then moved to the device.
    Cached per (universe size, quantile, device)."""
    n = np.arange(n_firms + 1, dtype=np.float64)
    k = np.maximum(1, np.round(n * quantile)).astype(np.int64)
    return torch.from_numpy(k).to(device)


# ---- the fused core -----------------------------------------------------


def _month_stats(f, u, r, rank_tgt, rank_r, tv_any, n, k, n_buckets):
    """Every mode's and month's portfolio, IC and profile statistics:
    ``f [G, T, N]`` scores over the shared universe ``u [T, N]``; one
    iteration of the numpy engine's month loop per (mode, month).
    ``rank_tgt`` / ``rank_r`` are the months' target and return ranks,
    shared by the modes; the one sort per (mode, month) is the portfolio
    argsort, whose inverse permutation is also the forecast rank."""
    n_slots = f.shape[-1]
    # Stable ascending sort with invalid slots past every real score:
    # slots 0..n-1 are the universe in forecast order, exactly numpy's
    # stable argsort over the subset (ties keep index order).
    order = torch.argsort(torch.where(u, f, torch.inf), dim=-1, stable=True)
    slot = torch.arange(n_slots, dtype=f.dtype, device=f.device)
    rank_f = torch.zeros_like(f).scatter(-1, order, slot.expand_as(f))
    ranki = rank_f.long()
    memb = u & (ranki >= (n - k)[:, None])  # long leg, firm order
    short_memb = u & (ranki < torch.minimum(k, n)[:, None])
    kf = k.clamp(min=1).to(r.dtype)
    long_ret = (r * memb).sum(dim=-1) / kf
    short_ret = (r * short_memb).sum(dim=-1) / kf
    # IC is defined 0 when no target in the month's universe is observable.
    ic = torch.where(tv_any, pearson_ic(rank_f, rank_tgt, u),
                     torch.zeros((), device=f.device))
    ret_ic = pearson_ic(rank_f, rank_r, u)
    # Decile profile: bucket = floor(rank·B/n) per firm; per-bucket sums
    # by a one-hot contraction, one mode at a time (a [T, N, B] one-hot).
    bucket = (ranki * n_buckets) // n.clamp(min=1)[:, None]
    buckets = torch.arange(n_buckets, device=f.device)
    bsum, bcnt = [], []
    for g in range(f.shape[0]):
        onehot = (bucket[g][..., None] == buckets) & u[..., None]
        bsum.append((r[..., None] * onehot).sum(dim=1))
        bcnt.append(onehot.sum(dim=1))
    bsum, bcnt = torch.stack(bsum), torch.stack(bcnt)
    bmean = torch.where(bcnt > 0, bsum / bcnt.clamp(min=1), 0.0)
    return {"long_ret": long_ret, "short_ret": short_ret, "ic": ic,
            "ret_ic": ret_ic, "bmean": bmean, "bhas": bcnt > 0,
            "memb": memb}


def _turnover_chain(memb, k, used):
    """Previous-portfolio overlap across USED months (a skipped month
    keeps the previous portfolio, like the numpy engine's ``prev_long``
    carry): each used month's predecessor is an exclusive cumulative max
    over used month indices, so the chain is one gather and one sum."""
    t_len = used.shape[0]
    idx = torch.where(used, torch.arange(t_len, device=used.device), -1)
    run = torch.cummax(idx, dim=0).values
    prev_idx = torch.cat([run.new_full((1,), -1), run[:-1]])
    prev_memb = memb[:, prev_idx.clamp(min=0)]        # [G, T, N]
    inter = (memb & prev_memb).sum(dim=-1)
    turn = 1.0 - inter / k.clamp(min=1).to(torch.float32)
    turn_has = used & (prev_idx >= 0)
    return (torch.where(turn_has, turn, 0.0),
            turn_has.expand_as(turn).contiguous())


@torch.inference_mode()
def _core(scores, u, dev, k_table, min_universe: int, costs_bps: float,
          long_short: bool, n_buckets: int) -> dict:
    """All months × all modes. ``scores [G, T, N]`` over the shared
    universe ``u [T, N]``; the mode-independent month quantities (universe
    count, portfolio size, benchmark, target and return ranks) once."""
    r, tgt, tv = dev["returns"], dev["targets"], dev["target_valid"]
    n = u.sum(dim=-1)                                  # [T]
    k = k_table[n]
    used = n >= min_universe
    bench = (r * u).sum(dim=-1) / n.clamp(min=1).to(r.dtype)
    rank_tgt = hard_ranks(tgt, u)                      # [T, N]
    rank_r = hard_ranks(r, u)
    tv_any = (tv & u).any(dim=-1)
    st = _month_stats(scores, u, r, rank_tgt, rank_r, tv_any, n, k,
                      n_buckets)
    port = st["long_ret"] - (st["short_ret"] if long_short else 0.0)
    turn, turn_has = _turnover_chain(st["memb"], k, used)
    port = port - costs_bps * 1e-4 * turn * turn_has
    out = {"used": used, "n": n, "k": k, "port": port, "bench": bench,
           "ic": st["ic"], "ret_ic": st["ret_ic"], "turn": turn,
           "turn_has": turn_has, "bmean": st["bmean"], "bhas": st["bhas"]}
    # One small device→host fetch of the per-month series.
    return {key: v.cpu().numpy() for key, v in out.items()}


def _as_tensor(a, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A numpy array or a tensor on any device → ``dtype`` on ``device``."""
    return torch.as_tensor(a).to(device=device, dtype=dtype)


def _dispatch_core(scores: torch.Tensor, valid, panel: Panel,
                   quantile: float, long_short: bool, min_universe: int,
                   costs_bps: float, profile_buckets: int,
                   device: torch.device) -> dict:
    """``scores [G, N, T]`` and ``valid [N, T]`` → the core on the
    month-major universe (forecastable and tradeable) → the host-fetched
    per-month series."""
    dev = _device_score_panel(panel, device)
    u = _as_tensor(valid, device, torch.bool).T & dev["tradeable"]
    return _core(scores.transpose(1, 2).contiguous(), u.contiguous(), dev,
                 _k_table(panel.n_firms, quantile, str(device)),
                 min_universe, costs_bps, bool(long_short), profile_buckets)


def _report_for_mode(out: dict, g: int, dates: np.ndarray, *,
                     min_universe: int, periods_per_year: int,
                     rf_monthly: float) -> BacktestReport:
    """Slice one mode's per-month series out of the core's output and hand
    them to the SHARED report assembly (float64, as the numpy engine)."""
    used = out["used"]
    turn_has = out["turn_has"][g]
    profile = np.where(out["bhas"][g], out["bmean"][g], 0.0)[used]
    return assemble_report(
        rets=out["port"][g][used],
        ics=out["ic"][g][used],
        ret_ics=out["ret_ic"][g][used],
        benches=out["bench"][used],
        turns=out["turn"][g][turn_has],
        dates=dates[used],
        skipped=int((~used).sum()),
        profile_sum=profile.astype(np.float64).sum(axis=0),
        profile_cnt=out["bhas"][g][used].sum(axis=0),
        min_universe=min_universe,
        periods_per_year=periods_per_year,
        rf_monthly=rf_monthly,
    )


def run_backtest_torch(
    forecast,
    fc_valid,
    panel: Panel,
    quantile: float = 0.1,
    long_short: bool = False,
    min_universe: int = 20,
    periods_per_year: int = 12,
    rf_monthly: float = 0.0,
    costs_bps: float = 0.0,
    profile_buckets: int = 10,
    device=None,
) -> BacktestReport:
    """Drop-in device twin of :func:`engine.run_backtest`: all T months in
    one pass on ``device`` (None means ``cuda``), the report math shared
    with the numpy engine. ``forecast`` and ``fc_valid`` are ``[N, T]``
    numpy arrays or tensors."""
    device = resolve_device(device)
    n, t_len = forecast.shape
    if panel.returns.shape != (n, t_len):
        raise ValueError("forecast and panel shapes disagree")
    scores = _as_tensor(forecast, device, torch.float32)[None]
    out = _dispatch_core(scores, fc_valid, panel, quantile, long_short,
                         min_universe, costs_bps, profile_buckets, device)
    return _report_for_mode(out, 0, panel.dates,
                            min_universe=min_universe,
                            periods_per_year=periods_per_year,
                            rf_monthly=rf_monthly)


# ---- device-resident multi-mode aggregation -----------------------------


@torch.inference_mode()
def _aggregate_modes(forecasts, valid, lams, aleatoric_var, kinds):
    """``[S, N, T]`` stacked forecasts → ``[G, N, T]`` scores for every
    mode; ``kinds`` selects each mode's penalty."""
    mean = forecasts.mean(dim=0)
    zeros = torch.zeros_like(mean)
    std = tstd = None
    if 1 in kinds:
        std = forecasts.std(dim=0, correction=0)
    if 2 in kinds:
        total_var = (forecasts.var(dim=0, correction=0)
                     + aleatoric_var.mean(dim=0))
        tstd = torch.sqrt(total_var.clamp(min=0.0))
    penalty = torch.stack([zeros if k == 0 else (std if k == 1 else tstd)
                           for k in kinds])
    scores = mean[None] - lams[:, None, None] * penalty
    return torch.where(valid[None], scores, 0.0).float()


def aggregate_scores_device(
    forecasts,
    fc_valid,
    modes: Sequence[ModeSpec],
    risk_lambda: float = 1.0,
    aleatoric_var=None,
    device=None,
):
    """Device twin of :func:`engine.aggregate_ensemble` that evaluates ALL
    aggregation modes from ONE stacked ``[S, N, T]`` forecast tensor.

    Returns ``(scores [G, N, T] tensor on device, valid [N, T] numpy,
    specs [(mode, λ)])``, with the numpy engine's validation rules and its
    float32 numerics."""
    device = resolve_device(device)
    forecasts = _as_tensor(forecasts, device, torch.float32)
    if forecasts.dim() != 3:
        raise ValueError(
            f"expected [S, N, T] forecasts, got {tuple(forecasts.shape)}")
    specs = normalize_modes(modes, risk_lambda)
    fc_valid = torch.as_tensor(fc_valid).cpu().numpy()
    valid = fc_valid.all(axis=0) if fc_valid.ndim == 3 else fc_valid
    kinds = tuple(_MODE_KINDS[m] for m, _ in specs)
    avar = None
    if 2 in kinds:
        if aleatoric_var is None:
            raise ValueError(
                "mean_minus_total_std needs aleatoric_var (predict with "
                "return_variance=True on a heteroscedastic model)")
        if tuple(aleatoric_var.shape) != tuple(forecasts.shape):
            raise ValueError(
                f"aleatoric_var {tuple(aleatoric_var.shape)} must match "
                f"forecasts {tuple(forecasts.shape)}")
        avar = _as_tensor(aleatoric_var, device, torch.float32)
    lams = torch.tensor([lam for _, lam in specs], dtype=torch.float32,
                        device=device)
    scores = _aggregate_modes(forecasts, torch.from_numpy(valid).to(device),
                              lams, avar, kinds)
    return scores, valid, specs


def run_scoring_pipeline(
    forecasts,
    fc_valid,
    panel: Panel,
    modes: Sequence[ModeSpec] = ("mean",),
    risk_lambda: float = 1.0,
    aleatoric_var=None,
    quantile: float = 0.1,
    long_short: bool = False,
    min_universe: int = 20,
    periods_per_year: int = 12,
    rf_monthly: float = 0.0,
    costs_bps: float = 0.0,
    profile_buckets: int = 10,
    device=None,
) -> Dict[str, BacktestReport]:
    """Fused aggregate → backtest for a whole mode sweep on ``device``:
    one aggregation builds every mode's score panel from the stacked
    ``[S, N, T]`` forecasts, one core pass backtests all modes × all
    months, one small fetch brings the per-month series to the host.
    Returns ``{label: report}`` in spec order (see :func:`mode_label`).

    ``forecasts`` may be ``[S, N, T]`` (ensemble seeds) or ``[N, T]`` (one
    already-aggregated panel, where ``mean_minus_std`` is rejected: its
    seed-axis std is identically 0, so every λ would relabel "mean")."""
    if forecasts.ndim == 2:
        bad = [m for m, _ in normalize_modes(modes, risk_lambda)
               if m == "mean_minus_std"]
        if bad:
            raise ValueError(
                "mean_minus_std needs stacked forecasts (ensemble seeds "
                "or MC-dropout samples); this is a single already-"
                "aggregated [N, T] panel — its seed-axis std is "
                "identically 0, so every λ would just relabel 'mean'")
        forecasts = forecasts[None]
        if aleatoric_var is not None and aleatoric_var.ndim == 2:
            aleatoric_var = aleatoric_var[None]
    device = resolve_device(device)
    scores, valid, specs = aggregate_scores_device(
        forecasts, fc_valid, modes, risk_lambda, aleatoric_var, device)
    out = _dispatch_core(scores, valid, panel, quantile, long_short,
                         min_universe, costs_bps, profile_buckets, device)
    return {
        mode_label(mode, lam): _report_for_mode(
            out, g, panel.dates, min_universe=min_universe,
            periods_per_year=periods_per_year, rf_monthly=rf_monthly)
        for g, (mode, lam) in enumerate(specs)
    }
