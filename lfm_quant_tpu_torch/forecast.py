"""Live forecasts of a trained run: the port of the JAX package's
``forecast.py``.

    python -m lfm_quant_tpu_torch.forecast --run-dir runs/c2_lstm_single/seed0
    python -m lfm_quant_tpu_torch.forecast \\
        --run-dir runs/c5_lstm_ensemble64/ensemble \\
        --mode mean_minus_std --csv live_ranks.csv
    python -m lfm_quant_tpu_torch.forecast --run-dir ... \\
        --from-date 202401 --to-date 202406
    python -m lfm_quant_tpu_torch.forecast --run-dir <a dropout model> \\
        --mc-samples 16 --mode mean_minus_std

Trained checkpoint(s) → rankings for months whose realized outcome is NOT
yet observable: the backtest scores anchors against realized targets, so
the last ``horizon`` months of the panel, the cross-sections a user
trades on, are out of its reach. This entry point predicts with
``require_target=False`` (window validity only). It defaults to the
panel's live block (its last ``horizon`` months), writes an npz
(forecast [N, T], valid [N, T], dates, firm_ids) and/or a long-format CSV
of per-month rankings, and prints the latest month's top names. A
walk-forward directory resolves to its last completed fold, the model
trained on the most recent data. Runs on the card; ``--device cpu`` on
the CPU; with no card it raises before any work.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List, Optional

import numpy as np


def _month_index(dates: np.ndarray, yyyymm: int, name: str) -> int:
    ix = np.nonzero(dates == yyyymm)[0]
    if ix.size == 0:
        raise SystemExit(
            f"{name} {yyyymm} not in the panel (spans "
            f"{int(dates[0])}..{int(dates[-1])})")
    return int(ix[0])


def _last_fold_dir(run_dir: str) -> str:
    """A walk-forward directory → its last completed fold's run dir (the
    walk-forward root has a config.json of its own but no checkpoint);
    any other directory → itself."""
    for progress in ("summary.json", "partial.json"):
        path = os.path.join(run_dir, progress)
        if not os.path.exists(path) or not glob.glob(
                os.path.join(run_dir, "fold_*")):
            continue
        with open(path) as fh:
            doc = json.load(fh)
        records = doc["folds"] if isinstance(doc, dict) else doc
        if not records:
            raise SystemExit(f"{run_dir} is a walk-forward dir with no "
                             "completed folds yet")
        rec = records[-1]  # appended in fold order
        fold_dir = os.path.join(run_dir, f"fold_{rec['fold']}")
        if not os.path.exists(os.path.join(fold_dir, "config.json")):
            raise SystemExit(
                f"walk-forward progress names fold {rec['fold']} but "
                f"{fold_dir} has no config.json")
        print(f"walk-forward dir: using fold {rec['fold']}'s model "
              f"(trained through {rec['train_end']})")
        return fold_dir
    return run_dir


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run-dir", required=True,
                    help="run directory written by "
                         "python -m lfm_quant_tpu_torch.train (single seed, "
                         "ensemble or walk-forward: told apart on disk)")
    ap.add_argument("--from-date", type=int, default=None,
                    help="first anchor month, YYYYMM inclusive (default: "
                         "start of the live block, the panel's last "
                         "`horizon` months)")
    ap.add_argument("--to-date", type=int, default=None,
                    help="last anchor month, YYYYMM inclusive (default: "
                         "panel end)")
    ap.add_argument("--mode", default="mean",
                    choices=("mean", "mean_minus_std",
                             "mean_minus_total_std"),
                    help="ensemble aggregation (as in the backtest)")
    ap.add_argument("--risk-lambda", type=float, default=1.0)
    ap.add_argument("--mc-samples", type=int, default=0,
                    help="MC-dropout samples (single model with dropout): "
                         "aggregate K stochastic forward passes with --mode")
    ap.add_argument("--out", help="write forecasts npz here")
    ap.add_argument("--csv", help="write long-format rankings CSV here "
                                  "(firm_id,yyyymm,forecast,rank)")
    ap.add_argument("--top", type=int, default=10,
                    help="names to print for the latest month")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from lfm_quant_tpu_torch.data.windows import anchor_index
    from lfm_quant_tpu_torch.device import resolve_device
    from lfm_quant_tpu_torch.train.forecast import (
        is_ensemble_run_dir,
        load_forecaster,
        run_forecast,
    )

    device = resolve_device(args.device)  # no card: raise before any work
    run_dir = _last_fold_dir(args.run_dir)
    if is_ensemble_run_dir(run_dir) and args.mc_samples > 0:
        # Before load_forecaster restores every seed's checkpoint.
        ap.error("--mc-samples applies to single-model run dirs only")
    model, splits, is_ensemble = load_forecaster(run_dir, device=device)
    panel = splits.panel

    # Default range: the live block, anchors past the last observable
    # target. End-exclusive month-index range for predict().
    lo = (_month_index(panel.dates, args.from_date, "--from-date")
          if args.from_date else max(0, panel.n_months - panel.horizon))
    hi = (_month_index(panel.dates, args.to_date, "--to-date") + 1
          if args.to_date else panel.n_months)
    if lo >= hi:
        ap.error(
            "empty forecast range: it runs "
            f"{int(panel.dates[min(lo, panel.n_months - 1)])}"
            f"..{int(panel.dates[hi - 1])} after resolution"
            + ("" if args.from_date else
               " (--from-date defaults to the live block, the panel's "
               f"last {panel.horizon} months — pass an explicit "
               "--from-date at or before --to-date for historical "
               "forecasts)"))
    # predict()'s sampler raises a bare ValueError on an empty range;
    # answer the common mistake with its cause.
    d = model.cfg.data
    elig = anchor_index(panel, d.window, d.min_valid_months,
                        require_target=False)
    if not elig[:, lo:hi].any():
        raise SystemExit(
            "no eligible anchors in the requested range (firms need "
            "enough lookback history even without a target)")

    forecast, valid = run_forecast(
        model, is_ensemble, mode=args.mode, risk_lambda=args.risk_lambda,
        mc_samples=args.mc_samples, error=ap.error, date_range=(lo, hi),
        require_target=False)
    months = [t for t in range(lo, hi) if valid[:, t].any()]

    if args.out:
        np.savez_compressed(args.out, forecast=forecast, valid=valid,
                            dates=panel.dates, firm_ids=panel.firm_ids)
        print(f"wrote {args.out}")
    if args.csv:
        with open(args.csv, "w") as fh:
            fh.write("firm_id,yyyymm,forecast,rank\n")
            for t in months:
                ix = np.nonzero(valid[:, t])[0]
                order = ix[np.argsort(-forecast[ix, t])]
                for rank, i in enumerate(order, 1):
                    fh.write(f"{int(panel.firm_ids[i])},"
                             f"{int(panel.dates[t])},"
                             f"{forecast[i, t]:.6f},{rank}\n")
        print(f"wrote {args.csv}")

    t = months[-1]
    ix = np.nonzero(valid[:, t])[0]
    order = ix[np.argsort(-forecast[ix, t])][:args.top]
    n_live = sum(1 for m in months if not panel.target_valid[:, m].any())
    print(f"{len(months)} forecast month(s) {int(panel.dates[months[0]])}"
          f"..{int(panel.dates[t])} ({n_live} live); latest month "
          f"{int(panel.dates[t])}: {ix.size} names")
    for rank, i in enumerate(order, 1):
        print(f"  #{rank:<3d} firm {int(panel.firm_ids[i]):>8d}  "
              f"forecast {forecast[i, t]:+.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
