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
           "seeds": dataclasses.replace(cfg, n_seeds=3, n_data_shards=1)}
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


# ---------------------------------------------------------------------------
# the seq axis (tests/test_torch_ring.py)
# ---------------------------------------------------------------------------


def _flat_grads(model) -> Dict[str, np.ndarray]:
    from lfm_quant_tpu_torch.weights import flax_param_map

    return {k: p.grad.detach().numpy().copy()
            for k, p in flax_param_map(model).items()}


def seq_checks(attn: Dict[str, np.ndarray], models) -> Dict[str, Any]:
    """On a seq axis of the whole world: ``ring_attention`` on this rank's
    blocks of ``attn``'s ``q, k, v [B, H, W, Dh]`` and key masks ``[B, W]``
    (its output blocks, and the gradients of ``sum(out * r)`` w.r.t. its
    q, k and v blocks), then each ``(kind, kwargs, params, x, m, r)`` of
    ``models`` through ``sequence_parallel_apply``: the output and this
    rank's parameter gradients of ``sum(out * r)``."""
    from lfm_quant_tpu_torch.models import build_model
    from lfm_quant_tpu_torch.parallel.mesh import data_mesh
    from lfm_quant_tpu_torch.parallel.ring import (
        ring_attention,
        sequence_parallel_apply,
        window_block,
    )
    from lfm_quant_tpu_torch.weights import load_flax_params

    _one_thread()
    mesh = data_mesh(1, n_seq_shards=D.world_size())
    out: Dict[str, Any] = {"rank": D.rank(), "n_seq": mesh.n_seq}
    q, k, v = (window_block(torch.from_numpy(attn[n]), mesh).clone()
               .requires_grad_(True) for n in "qkv")
    m, r = (window_block(torch.from_numpy(attn[n]), mesh, axis=-1)
            for n in ("m", "m_empty"))
    o = ring_attention(q, k, v, m, mesh)
    (o * window_block(torch.from_numpy(attn["r"]), mesh)).sum().backward()
    out["attn"] = [t.detach().numpy().copy()
                   for t in (o, q.grad, k.grad, v.grad)]
    with torch.no_grad():
        out["empty"] = ring_attention(q, k, v, r, mesh).numpy()
    out["models"] = []
    for kind, kw, params, x, mm, rr in models:
        model = build_model(kind, n_features=x.shape[-1],
                            window=x.shape[-2], seq_axis="seq", **kw)
        load_flax_params(model, params)
        y = sequence_parallel_apply(model, torch.from_numpy(x),
                                    torch.from_numpy(mm), mesh)
        (y * torch.from_numpy(rr)).sum().backward()
        out["models"].append((y.detach().numpy(), _flat_grads(model)))
    return out


def seq_bind_errors(cfg, panel_kw, cut, bad) -> Dict[str, str]:
    """The bind errors (and warnings) of each config in ``bad`` on this
    world, for the ``Trainer`` or (with ``n_seeds > 1``) the ensemble;
    an ensemble that binds reports its mesh fingerprint."""
    import warnings

    from lfm_quant_tpu_torch.parallel.mesh import mesh_fingerprint
    from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
    from lfm_quant_tpu_torch.train.loop import Trainer

    _one_thread()
    splits = _splits(panel_kw, cut)
    got = {}
    for name, c in bad.items():
        cls = EnsembleTrainer if c.n_seeds > 1 else Trainer
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            try:
                t = cls(c, splits, device="cpu")
                got[name] = f"ok {mesh_fingerprint(t.mesh)}"
            except (ValueError, NotImplementedError) as e:
                got[name] = f"{type(e).__name__}: {e}"
        got[name] += "".join(f" | warning: {w.message}" for w in rec)
    return got


def seq_train_checks(cfg, panel_kw, cut, init, bad) -> Dict[str, Any]:
    """:func:`epoch_steps` and then :func:`seq_bind_errors` in one job."""
    out = epoch_steps(cfg, panel_kw, cut, init)
    out["mesh"] = _fingerprint(cfg, panel_kw, cut)
    out["errors"] = seq_bind_errors(cfg, panel_kw, cut, bad)
    return out


def _fingerprint(cfg, panel_kw, cut):
    from lfm_quant_tpu_torch.parallel.mesh import data_mesh, mesh_fingerprint

    return mesh_fingerprint(data_mesh(cfg.n_data_shards,
                                      n_seq_shards=cfg.n_seq_shards))


# ---------------------------------------------------------------------------
# the seed axis (tests/test_torch_seed_ranks.py)
# ---------------------------------------------------------------------------


def ensemble_fit(cfg, panel_kw, cut, init=None, resume: bool = False,
                 bad=None, crash_after_epoch: Optional[int] = None
                 ) -> Dict[str, Any]:
    """An ``EnsembleTrainer`` fit with its run dir (``<out_dir>/<name>/
    ensemble``, written as ``run_ensemble_experiment`` writes it) from
    ``init`` (None: the seeded init; ``resume``: from the run dir's latest
    checkpoint), then ``predict`` of the test split and the bind errors
    of ``bad``; ``crash_after_epoch`` kills the fit at the end of that
    epoch, after its checkpoints (returns ``crashed``)."""
    from lfm_quant_tpu_torch.parallel.mesh import mesh_fingerprint
    from lfm_quant_tpu_torch.train import ensemble as E
    from lfm_quant_tpu_torch.train import loop

    _one_thread()
    splits = _splits(panel_kw, cut)
    run_dir = os.path.join(cfg.out_dir, cfg.name, "ensemble")
    trainer = E.EnsembleTrainer(cfg, splits, run_dir=run_dir, device="cpu")
    real_end = loop.FitHarness.end_epoch

    def end_epoch(self, epoch, *a):
        stop = real_end(self, epoch, *a)
        if epoch == crash_after_epoch:
            raise Crash
        return stop

    loop.FitHarness.end_epoch = end_epoch
    try:
        summary = trainer.fit(resume=resume, init_params=init)
    except Crash:
        return {"rank": D.rank(), "crashed": True}
    finally:
        loop.FitHarness.end_epoch = real_end
    E.write_ensemble_run_dir(run_dir, trainer, summary)
    pred, valid = trainer.predict("test")
    return {"rank": D.rank(), "seeds": list(trainer.seeds),
            "mesh": mesh_fingerprint(trainer.mesh), "summary": summary,
            "params": _host(trainer.state.params), "predict": (pred, valid),
            "errors": seq_bind_errors(cfg, panel_kw, cut, bad or {})}
