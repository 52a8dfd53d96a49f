"""The numpy backtest engine: a copy of ``lfm_quant_tpu/backtest/engine.py``
(the port imports nothing from the JAX package).

Forecasts → monthly cross-sectional ranks → top-quantile portfolio →
CAGR/Sharpe/IC report, one month at a time on the host. It is the golden
reference that ``backtest/torch_engine.py`` (all months and modes in one
pass on the device) is held to, in the tests and in ``chip_smoke.py``;
nothing on the card's path calls it. Below the docstring the module is
its original line for line, the ``Panel`` import aside
(``tests/test_torch_backtest.py`` holds it to that), so its comments speak
of the JAX package's fused engine, whose twin here is ``torch_engine``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from lfm_quant_tpu_torch.data.panel import Panel


@dataclasses.dataclass
class BacktestReport:
    """Monthly-rebalance portfolio simulation results.

    All rates are per-month unless suffixed _ann; months with no tradeable
    universe are skipped (recorded in ``n_skipped_months``).
    """

    cagr: float
    sharpe_ann: float
    mean_ic: float           # per-month Spearman(forecast, realized target)
    mean_ret_ic: float       # per-month Spearman(forecast, forward return)
    max_drawdown: float
    turnover: float          # mean fraction of portfolio replaced per month
    hit_rate: float          # fraction of months with positive return
    n_months: int
    n_skipped_months: int
    # Benchmark-relative block (benchmark = equal-weight tradeable
    # universe, the standard LFM-lineage comparison point):
    bench_cagr: float
    excess_cagr: float       # portfolio CAGR − benchmark CAGR
    ir_ann: float            # annualized IR of (portfolio − benchmark)
    t_stat: float            # t-stat of the mean monthly portfolio return
    monthly_returns: np.ndarray  # [T_used]
    monthly_ic: np.ndarray       # [T_used]
    monthly_bench: np.ndarray    # [T_used] universe EW forward return
    dates: np.ndarray            # [T_used] YYYYMM of formation months
    # Mean forward return per forecast-rank bucket, bottom → top — the
    # monotonicity evidence (a real signal shows increasing buckets).
    quantile_profile: np.ndarray  # [profile_buckets]

    def yearly(self) -> dict:
        """Calendar-year breakdown: {year: {"ret", "bench", "mean_ic",
        "n_months"}} with returns compounded within the year.

        Vectorized with ``np.ufunc.reduceat`` over year-boundary indices
        (dates are sorted formation months, so each year is one contiguous
        segment) — ``multiply.reduceat`` applies the SAME left-to-right
        reduction order as the old per-year ``np.prod`` loop, so the
        numbers are bit-identical while a 50-year report stops paying one
        Python iteration (plus boolean scans over the full series) per
        year."""
        years = np.asarray(self.dates) // 100
        starts = np.flatnonzero(np.r_[True, years[1:] != years[:-1]])
        counts = np.diff(np.r_[starts, years.size])
        # Same dtype promotion as the old per-year np.prod loop (multiply
        # .reduce is sequential, so each segment reduces in the identical
        # order) — ret/bench stay bit-compatible with prior reports;
        # mean_ic deliberately accumulates in float64 (≈1e-9 more
        # accurate than the old float32 .mean()).
        ret = np.multiply.reduceat(1.0 + np.asarray(self.monthly_returns), starts) - 1.0
        bench = np.multiply.reduceat(1.0 + np.asarray(self.monthly_bench), starts) - 1.0
        ic = np.add.reduceat(np.asarray(self.monthly_ic, np.float64), starts) / counts
        return {
            int(years[s]): {
                "ret": float(ret[i]),
                "bench": float(bench[i]),
                "mean_ic": float(ic[i]),
                "n_months": int(counts[i]),
            }
            for i, s in enumerate(starts)
        }

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        for k in ("monthly_returns", "monthly_ic", "monthly_bench", "dates",
                  "quantile_profile"):
            d[k] = np.asarray(d[k]).tolist()
        d["yearly"] = self.yearly()
        return json.dumps(d, indent=2)

    def summary(self) -> str:
        return (
            f"CAGR {self.cagr:+.2%} (bench {self.bench_cagr:+.2%}, excess "
            f"{self.excess_cagr:+.2%}, IR {self.ir_ann:.2f}) | "
            f"Sharpe {self.sharpe_ann:.2f} | t {self.t_stat:.1f} | "
            f"IC {self.mean_ic:+.3f} | retIC {self.mean_ret_ic:+.3f} | "
            f"maxDD {self.max_drawdown:.2%} | turnover {self.turnover:.2f} | "
            f"months {self.n_months}"
        )


#: Known aggregation modes (shared vocabulary of the numpy reference,
#: the device-resident jax_engine, and the CLIs).
ENSEMBLE_MODES = ("mean", "mean_minus_std", "mean_minus_total_std")


def normalize_modes(modes, risk_lambda: float = 1.0):
    """Mode specs → [(mode, λ)]: each entry is a mode name (taking the
    default ``risk_lambda``) or an explicit ``(mode, λ)`` pair — the λ
    grid of the uncertainty_aggregation sweep. Lives on the numpy side
    so mode vocabulary needs no jax import."""
    specs = []
    for m in modes:
        mode, lam = m if isinstance(m, tuple) else (m, risk_lambda)
        if mode not in ENSEMBLE_MODES:
            raise ValueError(f"unknown ensemble mode {mode!r}")
        specs.append((mode, float(lam)))
    return specs


def mode_label(mode: str, lam: float) -> str:
    """Stable dict key for a (mode, λ) spec; the plain mode name when λ
    is irrelevant (mean), matching the single-mode CLI vocabulary."""
    return mode if mode == "mean" else f"{mode}@{lam:g}"


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    # kind="stable": ties rank in index order — a DEFINED tie-break the
    # fused JAX engine (stable argsort by construction) reproduces
    # exactly; the default introsort's tie order is implementation-
    # arbitrary, which would make engine parity untestable on ties.
    ra = np.argsort(np.argsort(a, kind="stable"),
                    kind="stable").astype(np.float64)
    rb = np.argsort(np.argsort(b, kind="stable"),
                    kind="stable").astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else 0.0


def aggregate_ensemble(
    forecasts: np.ndarray,
    fc_valid: np.ndarray,
    mode: str = "mean",
    risk_lambda: float = 1.0,
    aleatoric_var: Optional[np.ndarray] = None,
):
    """Combine stacked per-seed forecasts [S, N, T] → ([N, T], [N, T] valid).

    ``mode``:
      * "mean"           — ensemble average (the reference's multi-seed
        aggregation, SURVEY.md §4.3).
      * "mean_minus_std" — uncertainty-penalized score ``mean − λ·std``
        over the seed axis (epistemic only; uncertainty-aware LFM
        lineage, SURVEY.md §1 [BACKGROUND]).
      * "mean_minus_total_std" — ``mean − λ·sqrt(Var_seeds(mean_s) +
        mean_s(var_s))``: the deep-ensemble mixture's total predictive
        std (law of total variance — epistemic seed spread + mean
        aleatoric head variance). Needs ``aleatoric_var`` [S, N, T] from
        ``predict(return_variance=True)`` on heteroscedastic members.
    ``fc_valid`` may be [N, T] (shared) or [S, N, T] (per-seed; a cell is
    valid if ALL seeds predicted it).
    """
    if forecasts.ndim != 3:
        raise ValueError(f"expected [S, N, T] forecasts, got {forecasts.shape}")
    valid = fc_valid.all(axis=0) if fc_valid.ndim == 3 else fc_valid
    mean = forecasts.mean(axis=0)
    if mode == "mean":
        score = mean
    elif mode == "mean_minus_std":
        score = mean - risk_lambda * forecasts.std(axis=0)
    elif mode == "mean_minus_total_std":
        if aleatoric_var is None:
            raise ValueError(
                "mean_minus_total_std needs aleatoric_var (predict with "
                "return_variance=True on a heteroscedastic model)")
        if aleatoric_var.shape != forecasts.shape:
            raise ValueError(
                f"aleatoric_var {aleatoric_var.shape} must match "
                f"forecasts {forecasts.shape}")
        total_var = forecasts.var(axis=0) + aleatoric_var.mean(axis=0)
        score = mean - risk_lambda * np.sqrt(np.maximum(total_var, 0.0))
    else:
        raise ValueError(f"unknown ensemble mode {mode!r}")
    return np.where(valid, score, 0.0).astype(np.float32), valid


def run_backtest(
    forecast: np.ndarray,
    fc_valid: np.ndarray,
    panel: Panel,
    quantile: float = 0.1,
    long_short: bool = False,
    min_universe: int = 20,
    periods_per_year: int = 12,
    rf_monthly: float = 0.0,
    costs_bps: float = 0.0,
    profile_buckets: int = 10,
) -> BacktestReport:
    """Monthly-rebalance quantile portfolio simulation.

    Each month t with ≥ ``min_universe`` forecastable firms: rank the
    cross-section by ``forecast[:, t]``, go long the top ``quantile``
    (equal-weight); with ``long_short`` also short the bottom quantile.
    The position earns the forward 1-month return ``panel.returns[:, t]``.
    ``costs_bps`` charges that many basis points on each month's turnover.
    The report also carries the equal-weight-universe benchmark
    (excess CAGR, annualized IR) and a ``profile_buckets``-bucket mean
    forward return profile over the forecast ranking.
    """
    n, t_len = forecast.shape
    if panel.returns.shape != (n, t_len):
        raise ValueError("forecast and panel shapes disagree")
    rets, ics, ret_ics, dates, turns, benches = [], [], [], [], [], []
    profile_sum = np.zeros(profile_buckets, np.float64)
    profile_cnt = np.zeros(profile_buckets, np.int64)
    prev_long: Optional[set] = None
    skipped = 0
    # tradeable() excludes firms whose forward return is unobserved (e.g.
    # delisting at t+1) — crediting them 0% would mask delisting losses.
    tradeable = panel.tradeable()
    for t in range(t_len):
        uni = np.nonzero(fc_valid[:, t] & tradeable[:, t])[0]
        if uni.size < min_universe:
            skipped += 1
            continue
        f = forecast[uni, t]
        k = max(1, int(round(uni.size * quantile)))
        # Stable sort: tied forecasts keep firm-index order, so the
        # portfolio boundary is well-defined and the fused JAX engine
        # (backtest/jax_engine.py) forms bit-identical portfolios.
        order = np.argsort(f, kind="stable")
        long_ix = uni[order[-k:]]
        port_ret = float(panel.returns[long_ix, t].mean())
        if long_short:
            short_ix = uni[order[:k]]
            port_ret -= float(panel.returns[short_ix, t].mean())
        cur = set(long_ix.tolist())
        if prev_long is not None:
            turn = 1.0 - len(cur & prev_long) / max(len(cur), 1)
            turns.append(turn)
            port_ret -= costs_bps * 1e-4 * turn
        prev_long = cur
        rets.append(port_ret)
        benches.append(float(panel.returns[uni, t].mean()))
        month_rets = panel.returns[uni[order], t]  # sorted by forecast
        # Map each sorted name to bucket floor(rank*B/n): in thin months
        # (n < profile_buckets) names keep their forecast-rank position —
        # the top-forecast name lands in the highest REACHABLE bucket,
        # floor((n-1)*B/n) (e.g. bucket 8 of 9 at n=6), rank order is
        # preserved, and only unreached buckets go empty, so the
        # monotonicity profile stays honest.
        bucket_of = (np.arange(uni.size) * profile_buckets) // uni.size
        for b in np.unique(bucket_of):
            profile_sum[b] += float(month_rets[bucket_of == b].mean())
            profile_cnt[b] += 1
        ics.append(_spearman(f, panel.targets[uni, t])
                   if panel.target_valid[uni, t].any() else 0.0)
        ret_ics.append(_spearman(f, panel.returns[uni, t]))
        dates.append(int(panel.dates[t]))

    return assemble_report(
        rets, ics, ret_ics, benches, turns, dates, skipped,
        profile_sum, profile_cnt, min_universe=min_universe,
        periods_per_year=periods_per_year, rf_monthly=rf_monthly,
    )


def assemble_report(rets, ics, ret_ics, benches, turns, dates, skipped,
                    profile_sum, profile_cnt, *, min_universe: int,
                    periods_per_year: int = 12, rf_monthly: float = 0.0,
                    ) -> BacktestReport:
    """Per-month series → :class:`BacktestReport` summary statistics.

    The ONE place the portfolio statistics (CAGR/Sharpe/IR/t-stat/max-DD)
    are computed: both the numpy reference engine and the fused JAX
    engine (backtest/jax_engine.py) hand their per-used-month series to
    this function, so the two paths can only diverge in the per-month
    numbers — which the parity suite pins — never in the report math.
    All inputs are sequences over USED months (thin months already
    dropped); ``turns`` has one fewer entry (no predecessor portfolio in
    the first used month).
    """
    rets = np.asarray(rets, np.float64)
    if rets.size == 0:
        raise ValueError(
            f"no month had a universe of >= {min_universe} forecastable firms"
        )
    r = rets
    b = np.asarray(benches, np.float64)
    turns = np.asarray(turns, np.float64)
    excess = r - rf_monthly
    growth = np.cumprod(1.0 + r)
    years = len(r) / periods_per_year
    cagr = float(growth[-1] ** (1.0 / years) - 1.0) if years > 0 else 0.0
    vol = float(excess.std(ddof=1)) if len(r) > 1 else 0.0
    sharpe = float(excess.mean() / vol * np.sqrt(periods_per_year)) if vol > 0 else 0.0
    peak = np.maximum.accumulate(growth)
    max_dd = float(((growth - peak) / peak).min())
    bench_growth = np.cumprod(1.0 + b)
    bench_cagr = (float(bench_growth[-1] ** (1.0 / years) - 1.0)
                  if years > 0 else 0.0)
    active = r - b
    a_vol = float(active.std(ddof=1)) if len(r) > 1 else 0.0
    ir = (float(active.mean() / a_vol * np.sqrt(periods_per_year))
          if a_vol > 0 else 0.0)
    t_stat = (float(r.mean() / r.std(ddof=1) * np.sqrt(len(r)))
              if len(r) > 1 and r.std(ddof=1) > 0 else 0.0)
    return BacktestReport(
        cagr=cagr,
        sharpe_ann=sharpe,
        mean_ic=float(np.mean(ics)),
        mean_ret_ic=float(np.mean(ret_ics)),
        max_drawdown=max_dd,
        turnover=float(turns.mean()) if turns.size else 0.0,
        hit_rate=float((r > 0).mean()),
        n_months=len(r),
        n_skipped_months=int(skipped),
        bench_cagr=bench_cagr,
        excess_cagr=cagr - bench_cagr,
        ir_ann=ir,
        t_stat=t_stat,
        monthly_returns=r.astype(np.float32),
        monthly_ic=np.asarray(ics, np.float32),
        monthly_bench=b.astype(np.float32),
        dates=np.asarray(dates, np.int32),
        quantile_profile=(np.asarray(profile_sum, np.float64)
                          / np.maximum(profile_cnt, 1)).astype(np.float32),
    )
