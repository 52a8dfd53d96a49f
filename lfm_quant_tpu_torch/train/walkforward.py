"""Walk-forward retraining, the multi-decade out-of-sample protocol: the
port of ``lfm_quant_tpu/train/walkforward.py`` (its sequential path).

At each fold the model trains on everything up to ``train_end``,
early-stops on the next ``val_months``, and forecasts ONLY the following
``step_months``; then the schedule rolls forward and retrains. Stitching
the per-fold forecasts gives one out-of-sample forecast panel in which
every prediction comes from a model that saw strictly earlier data: the
input the backtest grades.

Each fold retrains over the same device-resident panel (``PanelSplits``
never slices, so fold boundaries are free), and one trainer is
``rebind``-ed from fold to fold. On the card a fold's steps run the window
gather, the fused recurrence forward and its backward; its forecast runs
the forward over the fold's window. Fold k's seed is ``cfg.seed + 1000 *
k``, as in the JAX package, and the run directory has its layout:
``fold_<k>/`` (a loadable run dir each), ``partial.npz`` and
``partial.json`` after every fold, ``walkforward.npz``, ``config.json``
and ``summary.json`` at the end.

In a process group every rank trains every fold (each fold's steps
date-sharded, see ``train/loop.py``) and rank 0 alone writes the run
directory, each write followed by a barrier.

A heteroscedastic config (``loss="nll"``) also stitches each fold's
aleatoric variances, key ``variance`` of ``partial.npz`` and
``walkforward.npz`` (forecast-shaped), for ``mean_minus_total_std``
downstream. ``foldstack`` (``--wf-foldstack``, ``LFM_FOLDSTACK``) trains
the rolling window's folds as one stack (``train/foldstack.py``). The
fold records carry no ``reuse`` key: the port has no compiled-program
cache whose traces it would count.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from lfm_quant_tpu_torch.config import RunConfig
from lfm_quant_tpu_torch.data.panel import Panel, PanelSplits
from lfm_quant_tpu_torch.train.checkpoint import CheckpointManager
from lfm_quant_tpu_torch.train.forecast import mark_ensemble_run_dir
from lfm_quant_tpu_torch.utils.distributed import barrier, is_main


def month_add(yyyymm: int, months: int) -> int:
    """Calendar-correct YYYYMM arithmetic (months may be negative)."""
    y, m = divmod(yyyymm, 100)
    t = y * 12 + (m - 1) + months
    return (t // 12) * 100 + t % 12 + 1


def walkforward_folds(panel: Panel, start: int, step_months: int,
                      val_months: int,
                      n_folds: Optional[int] = None
                      ) -> List[Tuple[int, int, Tuple[int, int]]]:
    """Fold schedule: ``[(train_end, val_end, (pred_lo, pred_hi))]``.

    Fold k trains on anchors before ``train_end`` (embargoed by the
    horizon, see ``PanelSplits``), validates on [train_end, val_end), and
    forecasts the month-INDEX range [pred_lo, pred_hi) of the
    ``step_months`` right after val_end. Folds advance by
    ``step_months``, so the prediction windows tile the out-of-sample
    period without overlap. The schedule stops once a fold's window would
    start inside the panel's final ``horizon`` months, whose anchors have
    no realized target yet."""
    if step_months < 1:
        raise ValueError(f"step_months must be >= 1, got {step_months}")
    if val_months < 1:
        raise ValueError(f"val_months must be >= 1, got {val_months}")
    dates = panel.dates
    usable = panel.n_months - panel.horizon  # last month with a target
    folds = []
    train_end = start
    while n_folds is None or len(folds) < n_folds:
        val_end = month_add(train_end, val_months)
        test_end = month_add(val_end, step_months)
        lo = int(np.searchsorted(dates, val_end))
        hi = int(np.searchsorted(dates, test_end))
        if lo >= usable or lo == hi:
            break  # no gradeable out-of-sample months left
        folds.append((train_end, val_end, (lo, hi)))
        train_end = month_add(train_end, step_months)
    if not folds:
        raise ValueError(
            f"no walk-forward folds fit: start={start} val={val_months}mo "
            f"step={step_months}mo vs panel [{dates[0]}, {dates[-1]}]")
    return folds


def _report_scalars(rep) -> Dict[str, Any]:
    """JSON-friendly digest of a BacktestReport: every scalar field plus
    the one-line summary (the monthly arrays stay out of summary.json;
    the stitched npz carries the panel they come from)."""
    digest = {
        k: v for k, v in dataclasses.asdict(rep).items()
        if isinstance(v, (int, float))
    }
    digest["summary"] = rep.summary()
    return digest


def score_stitched(forecast: np.ndarray, valid: np.ndarray, panel: Panel,
                   score_modes: Sequence, variance=None, device=None,
                   **backtest_kw) -> Dict[str, Any]:
    """Grade a stitched out-of-sample forecast panel over an aggregation-
    mode grid on ``device`` (None means ``cuda``): every mode aggregated
    from one stacked tensor and backtested in one pass
    (``backtest/torch_engine.run_scoring_pipeline``); ``variance``, the
    stitched aleatoric variances of a heteroscedastic sweep, feeds
    ``mean_minus_total_std``. Returns ``{mode label: report digest}``."""
    from lfm_quant_tpu_torch.backtest.engine import normalize_modes
    from lfm_quant_tpu_torch.backtest.torch_engine import (
        run_scoring_pipeline,
    )

    kw = dict(backtest_kw)
    specs = normalize_modes(score_modes, kw.pop("risk_lambda", 1.0))
    if forecast.ndim == 2 and any(m == "mean_minus_std" for m, _ in specs):
        # A single stitched model has a degenerate seed axis: every λ
        # would silently relabel "mean".
        raise ValueError(
            "mean_minus_std needs stacked forecasts (n_seeds > 1 walk-"
            "forward); this sweep stitched a single model's panel")
    stacked = forecast if forecast.ndim == 3 else forecast[None]
    avar = None
    if variance is not None:
        avar = variance if variance.ndim == 3 else variance[None]
    reports = run_scoring_pipeline(stacked, valid, panel, modes=specs,
                                   aleatoric_var=avar, device=device, **kw)
    return {label: _report_scalars(rep) for label, rep in reports.items()}


def write_fold_run_dir(fold_cfg: RunConfig, run_dir: str, train_end: int,
                       val_end: int, train_start: Optional[int],
                       ensemble: bool) -> None:
    """Make a fold dir a standalone loadable run dir (``load_trainer`` /
    ``load_ensemble``): its config.json pins the FOLD's split boundaries,
    so a reload rebuilds the exact training-time splits, and the ensemble
    marker routes ``load_forecaster`` (and is cleared when a reused dir
    flips trainer kind). Written before the fit, so a crashed fold can
    still be inspected; the forecast entry point uses the LAST fold.
    Rank 0 writes; every rank waits for it."""
    if is_main():
        os.makedirs(run_dir, exist_ok=True)
        save_cfg = dataclasses.replace(
            fold_cfg, data=dataclasses.replace(
                fold_cfg.data, train_end=train_end, val_end=val_end,
                train_start=train_start))
        with open(os.path.join(run_dir, "config.json"), "w") as fh:
            fh.write(save_cfg.to_json())
        mark_ensemble_run_dir(run_dir, ensemble)
    barrier()


def _load_fold_best_params(fold_dir: str):
    """Best params of a fold completed earlier, from its ``ckpt/best``
    line: the warm-start carry for a fold whose predecessor was skipped by
    ``resume`` in this process. None (a fresh init, with a warning) when
    the line is missing or unreadable: a degraded carry must not end a
    multi-fold resume."""
    best = os.path.join(fold_dir, "ckpt", "best")
    try:
        if not os.path.isdir(best):
            raise FileNotFoundError(best)
        saved = CheckpointManager(best, max_to_keep=1).restore()
        return {k: v.numpy() for k, v in saved["params"].items()}
    except FileNotFoundError:
        warnings.warn(f"warm_start: no best checkpoint under {fold_dir} — "
                      "fold falls back to a fresh init")
    except (OSError, EOFError, RuntimeError, ValueError, KeyError,
            pickle.UnpicklingError) as e:
        warnings.warn(
            f"warm_start: could not restore {fold_dir} best checkpoint "
            f"({type(e).__name__}: {e}) — fold falls back to a fresh init")
    return None


def _load_resume(partial_npz: str, partial_json: str, folds, shape,
                 het: bool):
    """The progress snapshot of an earlier run, held to this schedule:
    ``(forecast, valid, records, variance or None)``, or None when there
    is none. A heteroscedastic sweep needs the snapshot's variances."""
    if not os.path.exists(partial_npz):
        return None
    snap = np.load(partial_npz)
    forecast, valid = snap["forecast"], snap["valid"].astype(bool)
    variance = None
    if het:
        if "variance" not in snap:
            raise ValueError(
                "resume snapshot lacks variances but the config is "
                "heteroscedastic — snapshot from a different model "
                "config?")
        variance = snap["variance"]
    with open(partial_json) as fh:
        records = json.load(fh)
    if len(records) > len(folds):
        raise ValueError(
            f"resume fold schedule mismatch: snapshot has {len(records)} "
            f"folds, new schedule only {len(folds)} — same start/step/val "
            "arguments required")
    for rec, fold in zip(records, folds):
        if (rec["train_end"], rec["val_end"]) != fold[:2]:
            raise ValueError(
                f"resume fold schedule mismatch: snapshot fold "
                f"{rec['fold']} is (train_end={rec['train_end']}, "
                f"val_end={rec['val_end']}), schedule says {fold[:2]} — "
                "same start/step/val arguments required")
    if forecast.shape != shape:
        raise ValueError(f"resume snapshot shape mismatch {forecast.shape} "
                         "— n_seeds changed?")
    return forecast, valid, records, variance


def run_walkforward(cfg: RunConfig, panel: Panel, *, start: int,
                    step_months: int = 12, val_months: int = 24,
                    n_folds: Optional[int] = None,
                    out_dir: Optional[str] = None, echo: bool = False,
                    resume: bool = False, warm_start: bool = False,
                    train_months: Optional[int] = None,
                    score_modes: Optional[Sequence] = None,
                    score_kwargs: Optional[Dict[str, Any]] = None,
                    foldstack: Optional[bool] = None, device=None
                    ) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """Train a model (or a seed ensemble, ``cfg.n_seeds > 1``) per fold on
    ``device`` (None means ``cuda``) and stitch the out-of-sample
    forecasts.

    Returns ``(forecast, valid, summary)``: forecast ``[N, T]`` (single)
    or ``[S, N, T]`` (ensemble: aggregate downstream like
    ``EnsembleTrainer.predict``'s output), valid ``[N, T]`` and True only
    in the stitched out-of-sample months, and the summary with a record
    per fold. With ``out_dir``, each fold's run dir is
    ``<out_dir>/fold_<k>``, a progress snapshot (``partial.npz`` +
    ``partial.json``) is written after every fold, and ``walkforward.npz``
    + ``config.json`` + ``summary.json`` at the end.

    ``resume=True`` (needs ``out_dir``) skips the folds recorded in the
    snapshot and resumes the fold in flight from its own ``ckpt/latest``.

    ``warm_start=True`` starts each fold's weights from the previous
    fold's final state (the early-stop BEST state when fold run dirs
    exist, else the last epoch's) instead of a fresh draw; the optimizer
    restarts. No lookahead: fold k-1 trained on strictly earlier data.
    When ``resume`` skipped the predecessor in this process, its best
    params come from its run dir's ``ckpt/best``.

    ``train_months``: a rolling train window of that many months (None:
    expanding, every fold trains on all history).

    ``score_modes``: grade the stitched panel at the end of the sweep on
    the device (``score_stitched``), every listed aggregation mode (names
    or ``(mode, λ)`` pairs) from one stacked tensor; ``summary["backtest"]``
    maps each mode label to its report digest. Single-model sweeps accept
    "mean" (and, heteroscedastic, "mean_minus_total_std"); ``score_kwargs``
    forwards the backtest's knobs.

    A heteroscedastic config (``cfg.is_heteroscedastic``) also stitches
    each fold's aleatoric variances (``predict(return_variance=True)``)
    into ``walkforward.npz`` (key ``variance``).

    ``foldstack``: train all folds as ONE stack (``train/foldstack.py``)
    instead of fold after fold; None defers to ``LFM_FOLDSTACK``. It
    needs the rolling ``train_months`` window and refuses ``resume`` and
    ``warm_start`` (the stacked fit writes each fold's ``ckpt/best`` at
    its end, and the warm start is a serial carry); an unmet
    precondition degrades loudly to the sequential sweep. Its fold
    records carry ``"foldstack": True`` and the summary the stack's
    ``"foldstack"`` record."""
    from lfm_quant_tpu_torch.device import resolve_device
    from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
    from lfm_quant_tpu_torch.train.foldstack import (foldstack_enabled,
                                                     run_stacked_walkforward)
    from lfm_quant_tpu_torch.train.loop import Trainer

    use_stack = foldstack if foldstack is not None else foldstack_enabled()
    if use_stack and (resume or warm_start):
        raise ValueError(
            "foldstack is incompatible with resume/warm_start: the "
            "stacked fit writes fold checkpoints only at finalize "
            "(nothing per-epoch to resume from) and the warm-start "
            "carry is inherently serial — run those protocols with "
            "the sequential walk-forward")
    if resume and not out_dir:
        raise ValueError("resume=True needs out_dir (the progress snapshot "
                         "lives there)")
    device = resolve_device(device)
    folds = walkforward_folds(panel, start, step_months, val_months, n_folds)
    ensemble = cfg.n_seeds > 1
    lead = (cfg.n_seeds,) if ensemble else ()
    shape = lead + (panel.n_firms, panel.n_months)
    het = cfg.is_heteroscedastic
    forecast = np.zeros(shape, np.float32)
    variance = np.zeros_like(forecast) if het else None
    valid = np.zeros((panel.n_firms, panel.n_months), bool)
    records: List[Dict[str, Any]] = []
    partial_npz = os.path.join(out_dir, "partial.npz") if out_dir else None
    partial_json = os.path.join(out_dir, "partial.json") if out_dir else None
    if resume:
        snap = _load_resume(partial_npz, partial_json, folds, shape, het)
        if snap is not None:
            forecast, valid, records, variance = snap

    stacked_info = None
    if use_stack:
        stacked = run_stacked_walkforward(
            cfg, panel, folds, train_months=train_months, out_dir=out_dir,
            echo=echo, device=device)
        if stacked is not None:
            fold_sums, fold_preds, stacked_info = stacked
            for k, (fold, fs, pred) in enumerate(
                    zip(folds, fold_sums, fold_preds)):
                train_end, val_end, pred_range = fold
                if het:
                    fc, avar, v = pred
                    variance[..., v] = avar[..., v]
                else:
                    fc, v = pred
                if (valid & v).any():
                    raise RuntimeError("fold prediction windows overlap")
                forecast[..., v] = fc[..., v]
                valid |= v
                records.append({
                    "fold": k,
                    "train_end": train_end,
                    "val_end": val_end,
                    "pred_months": [int(panel.dates[pred_range[0]]),
                                    int(panel.dates[pred_range[1] - 1])],
                    "n_pred_cells": int(v.sum()),
                    "best_val_ic": fs["best_val_ic"],
                    "best_epoch": fs["best_epoch"],
                    "epochs_run": fs["epochs_run"],
                    "warm_started": False,
                    "foldstack": True,
                })

    prev_params = None
    trainer = None
    for k, (train_end, val_end, pred_range) in enumerate(
            folds if stacked_info is None else []):
        if k < len(records):
            continue  # fold completed in an earlier run
        train_start = (month_add(train_end, -train_months)
                       if train_months else None)
        splits = PanelSplits.by_date(panel, train_end, val_end,
                                     train_start=train_start)
        run_dir = os.path.join(out_dir, f"fold_{k}") if out_dir else None
        # A per-fold seed offset keeps fold models independent draws
        # while staying replayable.
        fold_cfg = dataclasses.replace(cfg, seed=cfg.seed + 1000 * k)
        if run_dir:
            write_fold_run_dir(fold_cfg, run_dir, train_end, val_end,
                               train_start, ensemble)
        # One trainer for the whole sweep, rebound per fold.
        if trainer is None:
            trainer = (EnsembleTrainer if ensemble else Trainer)(
                fold_cfg, splits, run_dir=run_dir, echo=echo, device=device)
        else:
            trainer.rebind(fold_cfg, splits, run_dir=run_dir)
        if warm_start and prev_params is None and k > 0 and out_dir:
            prev_params = _load_fold_best_params(
                os.path.join(out_dir, f"fold_{k - 1}"))
        used_warm = warm_start and prev_params is not None
        fit = trainer.fit(resume=resume and run_dir is not None,
                          init_params=prev_params if used_warm else None)
        if warm_start:
            # The best state when this fold had a run dir (the fit
            # restored ckpt/best), else the last epoch's.
            prev_params = trainer.state.params
        if het:
            fc, avar, v = trainer.predict(date_range=pred_range,
                                          return_variance=True)
            variance[..., v] = avar[..., v]
        else:
            fc, v = trainer.predict(date_range=pred_range)
        if (valid & v).any():
            raise RuntimeError("fold prediction windows overlap")
        forecast[..., v] = fc[..., v]
        valid |= v
        records.append({
            "fold": k,
            "train_end": train_end,
            "val_end": val_end,
            "pred_months": [int(panel.dates[pred_range[0]]),
                            int(panel.dates[pred_range[1] - 1])],
            "n_pred_cells": int(v.sum()),
            "best_val_ic": fit["best_val_ic"],
            "best_epoch": fit["best_epoch"],
            "epochs_run": fit["epochs_run"],
            "warm_started": used_warm,
        })
        extra = {"variance": variance} if het else {}
        if out_dir and is_main():
            np.savez_compressed(partial_npz, forecast=forecast, valid=valid,
                                **extra)
            with open(partial_json, "w") as fh:
                json.dump(records, fh)
        barrier()
    summary = {
        "n_folds": len(folds),
        "step_months": step_months,
        "val_months": val_months,
        "train_months": train_months,
        "n_seeds": cfg.n_seeds,
        "warm_start": warm_start,
        "oos_months": [int(panel.dates[folds[0][2][0]]),
                       int(panel.dates[folds[-1][2][1] - 1])],
        "folds": records,
    }
    if stacked_info is not None:
        summary["foldstack"] = stacked_info

    def save_summary():
        if out_dir and is_main():
            with open(os.path.join(out_dir, "summary.json"), "w") as fh:
                json.dump(summary, fh, indent=2)

    # The sweep's primary artifacts go to disk BEFORE the grading: a
    # scoring failure must never lose the trained folds' forecasts.
    if out_dir and is_main():
        os.makedirs(out_dir, exist_ok=True)
        np.savez_compressed(os.path.join(out_dir, "walkforward.npz"),
                            forecast=forecast, valid=valid,
                            **({"variance": variance} if het else {}))
        with open(os.path.join(out_dir, "config.json"), "w") as fh:
            fh.write(cfg.to_json())
        save_summary()
    barrier()
    if score_modes:
        summary["backtest"] = score_stitched(
            forecast, valid, panel, score_modes, variance=variance,
            device=device, **(score_kwargs or {}))
        save_summary()
    return forecast, valid, summary
