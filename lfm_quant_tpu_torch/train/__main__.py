"""Train a preset's model: the port of the JAX package's ``train.py``,
a single model or the seed ensemble.

    python -m lfm_quant_tpu_torch.train --preset c2 [--epochs N] [--out DIR]
    python -m lfm_quant_tpu_torch.train --preset c2 --scale 0.05 --device cpu
    python -m lfm_quant_tpu_torch.train --preset c5 [--n-seeds S]
    python -m lfm_quant_tpu_torch.train --preset c4   # or c1, lru, lru64, lc
    python -m lfm_quant_tpu_torch.train --preset c2 --walk-forward 12 \
        --wf-start 199001 [--wf-folds K] [--wf-score mean]
    python -m lfm_quant_tpu_torch.train --preset c2 --walk-forward 12 \
        --wf-train-months 120 --wf-foldstack
    python -m lfm_quant_tpu_torch.train --preset c2 \
        --sweep-grid "lr=1e-3,3e-4;weight_decay=1e-4,0"

config → panel (``synthetic_panel`` from the preset's seed and sizes, or
a saved panel) → splits → ``Trainer.fit`` with early stopping; writes
``metrics.jsonl``, ``ckpt/latest``, ``ckpt/best``, ``config.json`` and
``summary.json`` into ``<out>/<name>/seed<seed>`` and prints the summary
as JSON. With ``n_seeds > 1`` (c5: 64) the ensemble trains instead
(``train/ensemble.py``), into ``<out>/<name>/ensemble`` with its
``ensemble.flag``. Runs on the card; ``--device cpu`` trains through
the kernels' plain versions. Every preset runs, each model kind of the
JAX package (the MLP, LSTM, GRU, transformer and LRU, the factorized
recurrences among them); ``lc``'s ``n_seq_shards`` resolves to 1 in one
process (with a warning), as the JAX trainer's does on one device.
``--scale`` shrinks the synthetic panel
(firms and months, never the model's widths). ``--resume`` continues
from the run directory's latest checkpoint with the same history.

Parallelism: one process per card, each started by the launcher,

    torchrun --nproc-per-node N -m lfm_quant_tpu_torch.train --preset c3
    torchrun --nproc-per-node 2 -m lfm_quant_tpu_torch.train --preset c5
    torchrun --nproc-per-node 2 -m lfm_quant_tpu_torch.train --preset lc

or with ``LFM_COORDINATOR``, ``LFM_NUM_PROCESSES`` and ``LFM_PROCESS_ID``
set per process (``utils/distributed.py``). Each rank takes the card of
its local rank (NCCL between cards; ``--device cpu`` ranks use gloo). The
world is laid out as the JAX mesh (``parallel/mesh.py``): the seed axis
(the ensemble's members split over the ranks) takes the largest divisor
of both ``n_seeds`` and the world, the data axis (each batch's dates)
``n_data_shards`` of what is left, and the seq axis (each window split
over the ranks: the transformer and the LRU) ``n_seq_shards`` of the
rest, degrading with a warning; their product must be the world. Rank 0
writes the run directory and prints the summary.

``--walk-forward STEP_MONTHS`` retrains every STEP_MONTHS months and
stitches the strictly out-of-sample forecasts (``train/walkforward.py``;
with ``loss="nll"`` their aleatoric variances too) into
``<out>/<name>/wf``: ``fold_<k>/`` run dirs, ``walkforward.npz`` for
``python -m lfm_quant_tpu_torch.backtest --forecast-npz``, and
``summary.json`` (with ``--wf-score``, the stitched panel's backtest).
``--wf-foldstack`` (needs ``--wf-train-months``) trains the folds as ONE
stack (``train/foldstack.py``), the same per-fold results in one fit.

``--sweep-grid "lr=1e-3,3e-4;weight_decay=1e-4,0"`` trains the grid's
configs as ONE stack (``train/stacked.py``: each config a member of one
stacked tree, its lr and weight decay per-member operands), into
``<out>/<name>/sweep``: ``config_<i>/`` run dirs and
``sweep_summary.json``, which ranks them (``LFM_SWEEP_STACKED=0``: one
fit after another). With ``--walk-forward`` every (fold, config) pair is
one run of the stack, into ``<out>/<name>/wf_sweep``; the summary ranks
the configs by their mean best val IC over the folds.

The epoch loop is pipelined (``LFM_ASYNC``, ``LFM_ASYNC_CKPT``: both on
by default; ``train/pipeline.py``); ``LFM_BUCKETS=1`` trains on the
geometry-bucket ladder. A SIGTERM stops the run at the next epoch
boundary with its checkpoints durable (the checkpoint waits are bounded
by ``LFM_CKPT_WAIT_S``) and the process exits 75: re-run it with
``--resume`` to continue with the same history.

``--debug`` trains under the numerical sanitizer (``utils/debug.py``):
a NaN or Inf made by a train step raises.

Telemetry: the run dir also gets the run's manifest, ``spans.jsonl``,
``trace.json`` and run record (``LFM_TELEMETRY=0`` turns them off), with
the trainers' ``fit``, ``eval``, ``sample`` and ``h2d`` spans; ``python
scripts/trace_report.py <run dir>`` rolls them up.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--preset", help="ladder preset (c1, c2, c3, c4, c5, "
                                    "lru, lru64, lc, or a full name)")
    g.add_argument("--config", help="path to a RunConfig JSON file")
    ap.add_argument("--seed", type=int, default=None, help="override seed")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override epochs")
    ap.add_argument("--out", default=None, help="override output dir")
    ap.add_argument("--echo", action="store_true",
                    help="print metrics lines")
    ap.add_argument("--scale", type=float, default=None,
                    help="shrink the synthetic panel by this factor")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in the run dir")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--debug", action="store_true",
                    help="sanitizer mode (utils/debug.py): raise on any "
                         "NaN/Inf a train step makes")
    ap.add_argument("--n-seeds", type=int, default=None,
                    help="override n_seeds (>1 trains the seed ensemble)")
    ap.add_argument("--walk-forward", metavar="STEP_MONTHS", type=int,
                    default=None,
                    help="walk-forward mode: retrain every STEP_MONTHS "
                         "months and stitch the out-of-sample forecasts; "
                         "writes walkforward.npz for the backtest's "
                         "--forecast-npz")
    ap.add_argument("--wf-start", type=int, default=None,
                    help="first fold's train_end (YYYYMM; default: 60%% "
                         "through the panel)")
    ap.add_argument("--wf-val-months", type=int, default=24,
                    help="validation window per fold (months)")
    ap.add_argument("--wf-folds", type=int, default=None,
                    help="cap the number of folds (default: run to the "
                         "panel's end)")
    ap.add_argument("--wf-warm-start", action="store_true",
                    help="initialize each fold's weights from the previous "
                         "fold's best state (the optimizer restarts)")
    ap.add_argument("--wf-train-months", type=int, default=None,
                    help="rolling train window per fold (months; default: "
                         "expanding window)")
    ap.add_argument("--wf-foldstack", action="store_true",
                    help="train all the folds as ONE stack "
                         "(train/foldstack.py; needs --wf-train-months) "
                         "instead of one fit after another; the per-fold "
                         "results of the sequential sweep. LFM_FOLDSTACK=1 "
                         "is the env equivalent")
    ap.add_argument("--sweep-grid", metavar="SPEC", default=None,
                    help="hyperparameter config sweep: semicolon-separated "
                         "axes of comma-separated values (e.g. "
                         "'lr=1e-3,5e-4;weight_decay=1e-4,0'), "
                         "cartesian-expanded and trained as ONE stack "
                         "(train/stacked.py), each config's lr and weight "
                         "decay per-member operands; LFM_SWEEP_STACKED=0 "
                         "trains them one after another. Run dirs and "
                         "sweep_summary.json under <out>/<name>/sweep. "
                         "With --walk-forward the fold x config product "
                         "trains as one stack (use --wf-train-months so "
                         "the folds stay the same shape), ranked by the "
                         "mean best val IC over the folds, under "
                         "<out>/<name>/wf_sweep")
    ap.add_argument("--wf-score", metavar="MODES", default=None,
                    help="grade the stitched out-of-sample panel at the "
                         "end of the sweep on the device: comma-separated "
                         "aggregation modes, each optionally MODE@LAMBDA "
                         "(e.g. 'mean,mean_minus_std@0.5'); reports land "
                         "in summary.json under 'backtest'")
    args = ap.parse_args(argv)
    if args.walk_forward is None and (
            args.wf_start is not None or args.wf_folds is not None
            or args.wf_val_months != 24 or args.wf_warm_start
            or args.wf_train_months is not None or args.wf_score is not None
            or args.wf_foldstack):
        ap.error("--wf-start/--wf-val-months/--wf-folds/--wf-warm-start/"
                 "--wf-train-months/--wf-score/--wf-foldstack need "
                 "--walk-forward STEP_MONTHS")
    if args.wf_foldstack and args.wf_train_months is None:
        ap.error("--wf-foldstack needs --wf-train-months (fold-stacking "
                 "requires the rolling-window same-shape schedule)")
    if args.wf_foldstack and (args.wf_warm_start or args.resume):
        ap.error("--wf-foldstack is incompatible with --wf-warm-start/"
                 "--resume (the stacked fit checkpoints folds only at "
                 "finalize; the warm-start carry is serial)")
    sweep_grid = None
    if args.sweep_grid is not None:
        if args.walk_forward is not None and (
                args.wf_foldstack or args.wf_warm_start
                or args.wf_score is not None):
            ap.error("--sweep-grid × --walk-forward selects configs "
                     "(no stitching), so --wf-foldstack/--wf-warm-start/"
                     "--wf-score don't apply — pick the winning config "
                     "here, then run the plain walk-forward with it")
        if args.resume:
            ap.error("--sweep-grid is incompatible with --resume (the "
                     "stacked sweep writes config checkpoints only at "
                     "finalize — nothing per-epoch to resume from)")
        # Validate at parse time, before any panel or device work.
        from lfm_quant_tpu_torch.train.stacked import parse_sweep_grid

        try:
            sweep_grid = parse_sweep_grid(args.sweep_grid)
        except ValueError as e:
            ap.error(f"--sweep-grid: {e}")
    args.sweep_grid = sweep_grid
    wf_score_modes = None
    if args.wf_score:
        # Validate at parse time, not after hours of fold training.
        from lfm_quant_tpu_torch.backtest.engine import normalize_modes

        wf_score_modes = []
        try:
            for tok in args.wf_score.split(","):
                mode, _, lam = tok.strip().partition("@")
                wf_score_modes.append((mode, float(lam)) if lam else mode)
            normalize_modes(wf_score_modes)
        except ValueError as e:
            ap.error(f"--wf-score: {e}")

    import torch

    from lfm_quant_tpu_torch.device import resolve_device
    from lfm_quant_tpu_torch.utils import distributed as dist_utils

    from lfm_quant_tpu_torch.train.preempt import Preempted, grace_scope

    device = resolve_device(args.device)  # no card: raise before any work
    started = dist_utils.maybe_initialize(
        backend="gloo" if device.type == "cpu" else None)
    try:
        if device.type == "cuda" and dist_utils.world_size() > 1:
            device = torch.device("cuda", dist_utils.local_rank())
            torch.cuda.set_device(device)
        # SIGTERM grace (train/preempt.py): a clean stop at the next epoch
        # boundary with the checkpoint lines flushed, surfaced as exit
        # code 75 (EX_TEMPFAIL: re-run with --resume).
        with grace_scope():
            return _run(ap, args, device, wf_score_modes)
    except Preempted as e:
        if dist_utils.is_main():
            print(json.dumps({"preempted": True, "detail": str(e),
                              "resume_hint": "re-run with --resume"},
                             indent=2))
        return 75
    finally:
        if started:
            dist_utils.shutdown()


def _run(ap, args, device, wf_score_modes) -> int:
    """Config → run, on this process's device; rank 0 prints."""
    from lfm_quant_tpu_torch.config import RunConfig, get_preset
    from lfm_quant_tpu_torch.utils import distributed as dist_utils
    from lfm_quant_tpu_torch.utils import telemetry

    if args.preset:
        cfg = get_preset(args.preset)
    else:
        with open(args.config) as fh:
            cfg = RunConfig.from_json(fh.read())
    if args.n_seeds is not None:
        cfg = dataclasses.replace(cfg, n_seeds=args.n_seeds)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.epochs is not None:
        cfg = dataclasses.replace(
            cfg, optim=dataclasses.replace(cfg.optim, epochs=args.epochs))
    if args.out is not None:
        cfg = dataclasses.replace(cfg, out_dir=args.out)
    if wf_score_modes is not None:
        names = [m[0] if isinstance(m, tuple) else m for m in wf_score_modes]
        if cfg.n_seeds < 2 and "mean_minus_std" in names:
            ap.error("--wf-score mean_minus_std needs stacked forecasts "
                     "(n_seeds > 1); a single-seed sweep stitches one "
                     "model's panel, whose seed-axis std is identically 0")
        if "mean_minus_total_std" in names and not cfg.is_heteroscedastic:
            ap.error("--wf-score mean_minus_total_std needs stitched "
                     "aleatoric variances — train the walk-forward with a "
                     "heteroscedastic config (loss='nll')")
    if args.scale is not None:
        d = cfg.data
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            d,
            n_firms=max(64, int(d.n_firms * args.scale)),
            # Longer than the generator's min_history (72) with room for
            # the window and the splits.
            n_months=max(d.window + d.horizon + 96, 120,
                         int(d.n_months * args.scale)),
        ))
    # The run dir each branch writes, known up front: its telemetry (the
    # manifest, spans.jsonl, trace.json and the run record; the trainers'
    # fit/eval/sample/h2d spans) goes beside the checkpoints, rank 0's
    # alone. LFM_TELEMETRY=0 turns it off.
    if args.sweep_grid is not None:
        leaf = "wf_sweep" if args.walk_forward is not None else "sweep"
    else:
        leaf = ("wf" if args.walk_forward is not None
                else "ensemble" if cfg.n_seeds > 1 else f"seed{cfg.seed}")
    run_dir = os.path.join(cfg.out_dir, cfg.name, leaf)
    with contextlib.ExitStack() as ctx:
        if args.debug:
            from lfm_quant_tpu_torch.utils.debug import sanitized

            ctx.enter_context(sanitized())
        ctx.enter_context(telemetry.run_scope(
            run_dir if dist_utils.is_main() else None, cfg,
            extra={"entry": "train"}))
        return _run_in_scope(args, cfg, device, wf_score_modes, run_dir)


def _run_in_scope(args, cfg, device, wf_score_modes, run_dir) -> int:
    from lfm_quant_tpu_torch.train.ensemble import run_ensemble_experiment
    from lfm_quant_tpu_torch.train.loop import run_experiment
    from lfm_quant_tpu_torch.utils import distributed as dist_utils

    if args.sweep_grid is not None and args.walk_forward is not None:
        from lfm_quant_tpu_torch.train.loop import resolve_panel
        from lfm_quant_tpu_torch.train.stacked import run_walkforward_sweep

        panel = resolve_panel(cfg.data)
        start = args.wf_start or int(panel.dates[int(panel.n_months * 0.6)])
        summary = run_walkforward_sweep(
            cfg, args.sweep_grid, panel=panel, start=start,
            step_months=args.walk_forward, val_months=args.wf_val_months,
            n_folds=args.wf_folds, train_months=args.wf_train_months,
            out_dir=run_dir, echo=args.echo, device=device)
        summary["run_dir"] = run_dir
    elif args.sweep_grid is not None:
        from lfm_quant_tpu_torch.train.stacked import run_config_sweep

        summary = run_config_sweep(cfg, args.sweep_grid, out_dir=run_dir,
                                   echo=args.echo, device=device)
        summary["run_dir"] = run_dir
    elif args.walk_forward is not None:
        from lfm_quant_tpu_torch.train.loop import resolve_panel
        from lfm_quant_tpu_torch.train.walkforward import run_walkforward

        panel = resolve_panel(cfg.data)
        start = args.wf_start or int(panel.dates[int(panel.n_months * 0.6)])
        wf_dir = os.path.join(cfg.out_dir, cfg.name, "wf")
        _, _, summary = run_walkforward(
            cfg, panel, start=start, step_months=args.walk_forward,
            val_months=args.wf_val_months, n_folds=args.wf_folds,
            out_dir=wf_dir, echo=args.echo, resume=args.resume,
            warm_start=args.wf_warm_start,
            train_months=args.wf_train_months, score_modes=wf_score_modes,
            foldstack=True if args.wf_foldstack else None, device=device)
        summary["run_dir"] = wf_dir
    else:
        run = run_ensemble_experiment if cfg.n_seeds > 1 else run_experiment
        summary, _, _ = run(cfg, echo=args.echo, resume=args.resume,
                            device=device)
    if dist_utils.is_main():
        print(json.dumps({k: v for k, v in summary.items()
                          if k not in ("history", "step_losses")},
                         indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
