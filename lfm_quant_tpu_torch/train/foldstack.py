"""Fold-stacked walk-forward: the port of ``lfm_quant_tpu/train/foldstack.py``,
the walk-forward's adapter over the stacked-run engine
(``train/stacked.py``).

The folds of a rolling-window walk-forward train as ONE stack: fold k is
run k of a :class:`~lfm_quant_tpu_torch.train.stacked.StackedRuns` with
its own config (seed ``seed + 1000·k``, as the sequential sweep draws
it), its own splits and its own run dir, so each step runs every fold at
once (the seed-grid launches of the recurrence and the gather's seed
fold on the card). This module owns what is fold-shaped: the schedule
mapped onto the run axis, each fold's prediction window and the degrade
to the sequential sweep; the engine owns the stacked execution (masked
per-fold early stopping on the device, one host sync per stacked epoch,
each fold's own streams, ``ckpt/best`` unstacked at the end).

Only same-shape folds stack: the rolling ``train_months`` window. A
stacked fit writes no per-epoch checkpoint lines, so ``resume`` and
``warm_start`` (a serial carry) are refused by ``run_walkforward``.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

from lfm_quant_tpu_torch.config import RunConfig
from lfm_quant_tpu_torch.data.panel import Panel, PanelSplits
from lfm_quant_tpu_torch.train.stacked import StackedRuns, StackUnavailable
from lfm_quant_tpu_torch.utils import telemetry


def foldstack_enabled() -> bool:
    """``LFM_FOLDSTACK=1`` makes ``run_walkforward`` train the folds as
    one stack; off by default (the stack trades per-epoch resume for
    throughput and needs the rolling window). ``--wf-foldstack`` and
    ``run_walkforward(foldstack=True)`` ask for it explicitly."""
    return os.environ.get("LFM_FOLDSTACK", "0") not in ("0", "")


class FoldstackUnavailable(StackUnavailable):
    """A fold-specific precondition is unmet (no rolling window, fewer
    than two folds). The walk-forward catches the shared
    :class:`StackUnavailable` and degrades to the sequential sweep."""


class StackedWalkforward(StackedRuns):
    """One fold-stacked walk-forward: the fold schedule mapped onto the
    engine's run axis (per-fold configs, rolling-window splits, run
    dirs); :meth:`run` trains the stack and predicts each fold's window
    from its state."""

    def __init__(self, cfg: RunConfig, panel: Panel,
                 folds: Sequence[Tuple[int, int, Tuple[int, int]]], *,
                 train_months: Optional[int], out_dir: Optional[str] = None,
                 echo: bool = False, device=None, init_params=None):
        from lfm_quant_tpu_torch.train.walkforward import (month_add,
                                                           write_fold_run_dir)

        if len(folds) < 2:
            raise FoldstackUnavailable(
                f"fold-stacking needs >= 2 folds, schedule has "
                f"{len(folds)}")
        if train_months is None:
            raise FoldstackUnavailable(
                "fold-stacking needs the rolling train_months window "
                "(same-shape folds); expanding-window folds have "
                "fold-varying shapes")
        self.folds = list(folds)
        self.out_dir = out_dir
        ensemble = cfg.n_seeds > 1
        fold_cfgs = [dataclasses.replace(cfg, seed=cfg.seed + 1000 * k)
                     for k in range(len(folds))]
        starts = [month_add(te, -train_months) for te, _, _ in folds]
        splits = [PanelSplits.by_date(panel, te, ve, train_start=ts)
                  for (te, ve, _), ts in zip(folds, starts)]
        run_dirs = [os.path.join(out_dir, f"fold_{k}") if out_dir else None
                    for k in range(len(folds))]
        for k, run_dir in enumerate(run_dirs):
            if run_dir:
                write_fold_run_dir(fold_cfgs[k], run_dir, folds[k][0],
                                   folds[k][1], starts[k], ensemble)
        super().__init__(fold_cfgs, splits, panel, kind="fold",
                         run_dirs=run_dirs, echo=echo, device=device,
                         init_params=init_params)

    def run(self) -> Tuple[List[Dict[str, Any]], List[Tuple],
                           Dict[str, Any]]:
        """Train the stack and predict each fold's window from its state
        (the best-tracked params when the fold has a run dir, as its
        sequential fit restores ``ckpt/best``) by the member stack's
        forward (:meth:`StackedRuns.predict`). Returns
        ``(fold_summaries, fold_predictions, stack_summary)``; the
        walk-forward stitches the predictions."""
        preds: List[Tuple] = []

        def per_fold(k: int) -> None:
            with telemetry.span("predict", cat="predict", fold=k):
                preds.append(self.predict(k, self.folds[k][2]))

        summaries, stack_summary = self.fit(per_run=per_fold)
        return summaries, preds, stack_summary


def run_stacked_walkforward(cfg: RunConfig, panel: Panel, folds, *,
                            train_months: Optional[int],
                            out_dir: Optional[str] = None,
                            echo: bool = False, device=None,
                            init_params=None):
    """The fold-stacked sweep for ``run_walkforward``: ``(fold_summaries,
    fold_predictions, stack_summary)``, or None after a loud degrade (a
    warning, the ``stack_degraded`` instant and the ``stack_degrades``
    counter) when a precondition is unmet: the caller then runs the
    sequential sweep. ``init_params``: a JAX fold-stacked param tree in
    place of the folds' seeded inits."""
    try:
        sw = StackedWalkforward(cfg, panel, folds, train_months=train_months,
                                out_dir=out_dir, echo=echo, device=device,
                                init_params=init_params)
    except StackUnavailable as e:
        warnings.warn(f"fold-stacking unavailable ({e}); running the "
                      "sequential walk-forward", stacklevel=3)
        telemetry.instant("stack_degraded", kind="fold", reason=str(e))
        telemetry.COUNTERS.bump("stack_degrades")
        return None
    return sw.run()
