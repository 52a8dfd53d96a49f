"""Backtest a trained run: the port of the JAX package's ``backtest.py``.

    python -m lfm_quant_tpu_torch.backtest --run-dir runs/c2_lstm_single/seed0
    python -m lfm_quant_tpu_torch.backtest \\
        --run-dir runs/c5_lstm_ensemble64/ensemble \\
        --mode mean_minus_std --quantile 0.2 --long-short
    python -m lfm_quant_tpu_torch.backtest --forecast-npz runs/c2_lstm_single/wf

Trained checkpoint(s) (or a walk-forward's stitched ``walkforward.npz``)
→ forecasts for every eligible firm × month of the split → aggregation
over the seeds → monthly cross-sectional ranks → top-quantile portfolio →
CAGR/Sharpe/IC report. The forecast, the aggregation and the backtest run
on the card (``backtest/torch_engine.py``); ``--device cpu`` runs them on
the CPU. With no card and no ``--device cpu`` it raises before any work.
``--mc-samples K`` scores a single model with dropout by K MC-dropout
samples, aggregated like an ensemble's seeds (``--mode``); ``--mode
mean_minus_total_std`` scores a heteroscedastic run (``loss="nll"``) by
its mean less λ times its total predictive std (the seeds' spread and
the mean aleatoric variance), from the run dir's ``predict(
return_variance=True)`` or a stitched file's ``variance``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--run-dir",
                     help="run directory written by "
                          "python -m lfm_quant_tpu_torch.train")
    src.add_argument("--forecast-npz",
                     help="stitched forecast file of a walk-forward "
                          "(train --walk-forward): walkforward.npz or its "
                          "directory; the sibling config.json resolves "
                          "the panel")
    ap.add_argument("--split", default=None, choices=["test", "val", "train"],
                    help="which date split to simulate on (default: test; "
                         "not with --forecast-npz, whose months are fixed "
                         "by the stitched file)")
    ap.add_argument("--quantile", type=float, default=0.1)
    ap.add_argument("--long-short", action="store_true")
    ap.add_argument("--costs-bps", type=float, default=0.0)
    ap.add_argument("--mode", default="mean",
                    choices=["mean", "mean_minus_std",
                             "mean_minus_total_std"],
                    help="aggregation over the seeds of an ensemble run "
                         "dir or a stitched ensemble")
    ap.add_argument("--risk-lambda", type=float, default=1.0)
    ap.add_argument("--mc-samples", type=int, default=0,
                    help="MC-dropout samples for a single model with "
                         "dropout: score K stochastic forward passes "
                         "aggregated like an ensemble (--mode)")
    ap.add_argument("--json-out", default=None,
                    help="write the full report JSON here")
    ap.add_argument("--yearly", action="store_true",
                    help="also print the calendar-year breakdown")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from lfm_quant_tpu_torch.backtest import resolve_backtest
    from lfm_quant_tpu_torch.device import resolve_device
    from lfm_quant_tpu_torch.utils import telemetry

    device = resolve_device(args.device)  # no card: raise before any work
    run_backtest = resolve_backtest(device)
    # Telemetry into the run dir being graded (the stitched file's
    # directory for --forecast-npz), so scripts/trace_report.py covers
    # the backtest pass too; LFM_TELEMETRY=0 turns it off.
    tele_dir = args.run_dir
    if args.forecast_npz:
        tele_dir = (args.forecast_npz if os.path.isdir(args.forecast_npz)
                    else os.path.dirname(args.forecast_npz) or ".")
    with telemetry.run_scope(tele_dir, extra={
            "entry": "backtest",
            "cli": {"mode": args.mode, "quantile": args.quantile,
                    "long_short": args.long_short,
                    "costs_bps": args.costs_bps,
                    "mc_samples": args.mc_samples}}):
        if args.forecast_npz:
            import numpy as np

            from lfm_quant_tpu_torch.backtest.torch_engine import (
                aggregate_scores_device,
            )
            from lfm_quant_tpu_torch.config import RunConfig
            from lfm_quant_tpu_torch.train.loop import resolve_panel

            if args.mc_samples > 0:
                ap.error("--mc-samples needs a live model; a forecast file is "
                         "already sampled/stitched")
            if args.split is not None:
                ap.error("--split does not apply to --forecast-npz: the "
                         "simulated months are fixed by the stitched file")
            path = args.forecast_npz
            if os.path.isdir(path):
                path = os.path.join(path, "walkforward.npz")
            with open(os.path.join(os.path.dirname(path),
                                   "config.json")) as fh:
                cfg = RunConfig.from_json(fh.read())
            data = np.load(path)
            forecast, fc_valid = data["forecast"], data["valid"]
            panel = resolve_panel(cfg.data)
            if args.mode == "mean_minus_total_std":
                if "variance" not in data:
                    ap.error("--mode mean_minus_total_std needs stitched "
                             "aleatoric variances; this file has none "
                             "(train the walk-forward with a "
                             "heteroscedastic config — loss='nll')")
                avar = data["variance"]
                if forecast.ndim == 2:  # a single heteroscedastic model
                    forecast, avar = forecast[None], avar[None]
                scores, fc_valid, _ = aggregate_scores_device(
                    forecast, fc_valid, [args.mode], args.risk_lambda,
                    aleatoric_var=avar, device=device)
                forecast = scores[0]
            elif forecast.ndim == 3:  # a stitched ensemble
                scores, fc_valid, _ = aggregate_scores_device(
                    forecast, fc_valid, [args.mode], args.risk_lambda,
                    device=device)
                forecast = scores[0]
            elif args.mode != "mean":
                ap.error(f"--mode {args.mode} needs stacked forecasts; this "
                         "file holds a single model's (already-aggregated) "
                         "walk-forward forecasts")
        else:
            from lfm_quant_tpu_torch.train.forecast import (
                is_ensemble_run_dir,
                load_forecaster,
                run_forecast,
            )

            if is_ensemble_run_dir(args.run_dir) and args.mc_samples > 0:
                # Before load_forecaster restores every seed's checkpoint.
                ap.error("--mc-samples applies to single-model run dirs "
                         "only; this is a seed ensemble — its uncertainty "
                         "comes from the seeds (use --mode mean_minus_std "
                         "directly)")
            model, splits, is_ensemble = load_forecaster(args.run_dir,
                                                         device=device)
            with telemetry.span("predict", cat="predict"):
                forecast, fc_valid = run_forecast(
                    model, is_ensemble, mode=args.mode,
                    risk_lambda=args.risk_lambda,
                    mc_samples=args.mc_samples, error=ap.error,
                    split=args.split or "test")
            panel = splits.panel

        with telemetry.span("score", cat="score"):
            report = run_backtest(forecast, fc_valid, panel,
                                  quantile=args.quantile,
                                  long_short=args.long_short,
                                  costs_bps=args.costs_bps)
        print(report.summary())
        if args.yearly:
            for y, rec in sorted(report.yearly().items()):
                print(f"  {y}: ret {rec['ret']:+8.2%}  bench "
                      f"{rec['bench']:+8.2%}  IC {rec['mean_ic']:+.3f}  "
                      f"({rec['n_months']} mo)")
        if args.json_out:
            with open(args.json_out, "w") as fh:
                fh.write(report.to_json())
    return 0


if __name__ == "__main__":
    sys.exit(main())
