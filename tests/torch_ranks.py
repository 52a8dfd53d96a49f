"""Rank-side jobs of the port's multi-process tests.

Each function runs inside one rank of a job started by
``lfm_quant_tpu_torch.parallel.launch.run_ranks`` (the process group is
already up) and returns plain data for the parent to compare. This module
imports nothing of JAX: the ranks are port processes; the parent holds
the JAX reference. Inside a rank torch runs on one thread, so a few
ranks share the test machine's cores without oversubscribing them; the
parent calls the same functions for its one-process reference.
"""

from __future__ import annotations

import builtins
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.utils import distributed as D


def _splits(panel_kw: Dict[str, Any], cut: tuple) -> PanelSplits:
    panel = synthetic_panel(**panel_kw)
    return PanelSplits.by_date(panel, int(panel.dates[cut[0]]),
                               int(panel.dates[cut[1]]))


def _one_thread() -> None:
    if D.initialized():
        torch.set_num_threads(1)


def _host(params) -> Dict[str, np.ndarray]:
    return {k: p.detach().to("cpu", torch.float32).numpy().copy()
            for k, p in params.items()}


def epoch_steps(cfg, panel_kw, cut, init, device: str = "cpu",
                n_steps: Optional[int] = None) -> Dict[str, Any]:
    """Epoch 0's steps (or its first ``n_steps``) of a ``Trainer`` from
    ``init``: per-step loss and grad_norm, the final params, and the
    validation sweep on them."""
    from lfm_quant_tpu_torch.ops import _build
    from lfm_quant_tpu_torch.train.loop import Trainer

    _one_thread()
    trainer = Trainer(cfg, _splits(panel_kw, cut), device=device)
    state = trainer.init_state(init)
    fi, ti, w = trainer._batch(trainer.train_sampler.stacked_epoch(0))
    _build.reset_launch_counts()
    losses, gnorms = [], []
    for k in range(fi.shape[0] if n_steps is None else n_steps):
        state, ms = trainer.step(state, fi[k], ti[k], w[k])
        losses.append(float(ms["loss"]))
        gnorms.append(float(ms["grad_norm"]))
    ev = trainer.evaluate()
    return {"rank": D.rank(), "world": D.world_size(),
            "n_data": trainer.mesh.n_data, "losses": losses,
            "grad_norms": gnorms, "params": _host(state.params), "eval": ev,
            "launches": _build.launch_counts()}


def sweeps(cfg, panel_kw, cut, init) -> Dict[str, Any]:
    """The month-sharded sweeps from ``init``: ``_eval_dispatch`` on the
    validation months, ``evaluate``, ``predict`` of the test split and of
    a short month range; and the bind errors of this world."""
    import dataclasses

    from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
    from lfm_quant_tpu_torch.train.loop import Trainer

    _one_thread()
    splits = _splits(panel_kw, cut)
    trainer = Trainer(cfg, splits, device="cpu")
    trainer.state = trainer.init_state(init)
    ic, mse = trainer._eval_dispatch(*trainer._batch(
        trainer.val_sampler.stacked_cross_sections()))
    test_fc, test_valid = trainer.predict("test")
    lo = splits.val_range[0]
    short_fc, short_valid = trainer.predict(date_range=(lo, lo + 3))
    errors = {}
    bad = {"shards": dataclasses.replace(cfg, n_data_shards=1),
           "divisible": dataclasses.replace(cfg, data=dataclasses.replace(
               cfg.data, dates_per_batch=3)),
           "seeds": dataclasses.replace(cfg, n_seeds=2)}
    for name, bad_cfg in bad.items():
        cls = EnsembleTrainer if name == "seeds" else Trainer
        try:
            cls(bad_cfg, splits, device="cpu")
        except (ValueError, NotImplementedError) as e:
            errors[name] = f"{type(e).__name__}: {e}"
    return {"rank": D.rank(), "ic": ic.numpy(), "mse": float(mse),
            "eval": trainer.evaluate(), "test": (test_fc, test_valid),
            "short": (short_fc, short_valid), "errors": errors}


class Crash(Exception):
    pass


def train_cli(argv, crash_after_epoch: Optional[int] = None
              ) -> Dict[str, Any]:
    """``python -m lfm_quant_tpu_torch.train ARGV`` on this rank (the
    process group is the launcher's), recording every file the rank
    opened for writing; ``crash_after_epoch`` kills the run at the end of
    that epoch, after its checkpoints. Returns the fit's summary (or
    ``crashed``) and the written paths."""
    from lfm_quant_tpu_torch.train import loop
    from lfm_quant_tpu_torch.train.__main__ import main

    _one_thread()
    written = []
    real_open, real_save = builtins.open, torch.save
    real_makedirs = os.makedirs

    def rec_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            written.append(str(file))
        return real_open(file, mode, *a, **k)

    def rec_save(obj, f, *a, **k):
        written.append(str(f))
        return real_save(obj, f, *a, **k)

    def rec_makedirs(name, *a, **k):
        if not os.path.isdir(name):
            written.append(str(name))
        return real_makedirs(name, *a, **k)

    got = {}
    real_run, real_end = loop.run_experiment, loop.FitHarness.end_epoch

    def run(*a, **k):
        got["summary"], trainer, splits = real_run(*a, **k)
        return got["summary"], trainer, splits

    def end_epoch(self, epoch, *a):
        stop = real_end(self, epoch, *a)
        if epoch == crash_after_epoch:
            raise Crash
        return stop

    builtins.open, torch.save, os.makedirs = rec_open, rec_save, rec_makedirs
    loop.run_experiment, loop.FitHarness.end_epoch = run, end_epoch
    try:
        main(list(argv))
    except Crash:
        got["crashed"] = True
    finally:
        builtins.open, torch.save, os.makedirs = (real_open, real_save,
                                                  real_makedirs)
        loop.run_experiment, loop.FitHarness.end_epoch = real_run, real_end
    got.update(rank=D.rank(), written=written)
    return got
