"""Stacked runs: the port of ``lfm_quant_tpu/train/stacked.py``.

R independent same-shape runs of one model (the configs of a learning
rate × weight decay grid, ``--sweep-grid``; the folds of a walk-forward,
``train/foldstack.py``; or their product) train as the members of ONE
stacked tree: the seed ensemble's member axis (``train/ensemble.py``)
one level up. Run r of S seeds is members ``r·S … r·S + S - 1`` of an
``EnsembleTrainer`` with R·S members, so each step runs every run at
once: one launch of the window gather folds every member's dates (the
gather's seed fold), and the fused recurrence forward and backward run
every member in one seed-grid launch. The JAX package writes the run
axis as a ``vmap`` inside one jitted epoch program, sharded over a mesh
axis; here it is the member axis written out, in one process
(``parallel/mesh.py resolve_run_shards``).

* Each run keeps its sequential fit's streams: its init (member s of
  run r from the generator ``seed_r + s``, or a JAX run-stacked tree
  through ``weights.member_params``), its samplers (seed and train
  range; ``data/windows.py stack_fold_epochs``), its dropout stream and
  its validation months.
* Per-run hyperparameters (:data:`HYPER_KEYS`) are ``[R·S]`` operands of
  the one member optimizer (``train/optim.py``), broadcast over each
  member's leading axis: member s's step size at count c is the
  ``AdamW.lr_at(c)`` of its sequential run.
* Early stopping is masked and on the device (:class:`RunCtrl`): after
  an epoch's steps ``torch.where`` on the ``[R]`` live mask puts a
  stopped run's params and Adam moments back to the epoch's start and
  keeps its step count, so its dropout stream (drawn from the step)
  stays too: the run is bit-frozen while the others train. The best val
  IC, its epoch and the best params are tracked on the device. The
  epoch loop runs through ``train/pipeline.py run_fit_epochs``: ONE
  counted host sync per stacked epoch; the lookahead epoch reads the
  previous epoch's control on the device, so it waits for no host
  decision, and an epoch queued after every run stopped changes nothing.
* ``LFM_STACK_BLOCK``: each step runs the stack in blocks of that many
  runs (:func:`scan_in_blocks`, the ensemble's ``seed_block`` one axis
  up): activation memory drops to a block's, the per-run math is the
  same. A block that does not divide the run count runs unblocked, with
  a warning.
* A precondition the stack cannot meet raises :class:`StackUnavailable`
  and its callers (:func:`run_config_sweep`, :func:`run_walkforward_sweep`,
  ``foldstack.run_stacked_walkforward``) degrade LOUDLY to the
  sequential fits: a warning, the ``stack_degrades`` counter and a
  ``stack_degraded`` instant, which ``scripts/trace_report.py`` reads.

Each run's dir (``config_<i>``, ``fold_<k>``) is loadable like its
sequential fit's: ``config.json``, ``metrics.jsonl`` and ``ckpt/best``
(the device-tracked best params, written at the end of the stacked fit;
no per-epoch lines, so a stacked fit does not resume).

Numerics against the sequential fits: the member stack runs each run's
math with the same operands, but as batched products and per-member
reductions (the clip's norm, LAMB's trust ratios), and the sequential
single-model fit takes its global norm in another order; the card's
bf16 launcher also picks its row tile from the total rows
(``ops/rnn.py``). So a stacked run equals its sequential fit within the
training tolerance, with every decision (epochs run, best epoch,
early-stop epoch) exact; bitwise only where the device's kernels reduce
in the same order.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from lfm_quant_tpu_torch.buckets import buckets_enabled
from lfm_quant_tpu_torch.config import RunConfig, model_kwargs
from lfm_quant_tpu_torch.data.panel import Panel, PanelSplits
from lfm_quant_tpu_torch.data.windows import (
    DateBatchSampler,
    gather_targets,
    stack_fold_epochs,
)
from lfm_quant_tpu_torch.models import build_model
from lfm_quant_tpu_torch.ops.metrics import spearman_ic
from lfm_quant_tpu_torch.parallel.mesh import (
    FOLD_AXIS,
    STACK_AXIS,
    resolve_run_shards,
)
from lfm_quant_tpu_torch.train import pipeline
from lfm_quant_tpu_torch.train.checkpoint import CheckpointManager
from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
from lfm_quant_tpu_torch.train.loop import (
    Trainer,
    TrainState,
    _point_forecast,
    default_split_dates,
    predict_sampler,
    resolve_panel,
    scatter_forecasts,
    stage,
)
from lfm_quant_tpu_torch.train.optim import make_optimizer
from lfm_quant_tpu_torch.utils import distributed as dist_utils
from lfm_quant_tpu_torch.utils import telemetry
from lfm_quant_tpu_torch.utils.logging import MetricsLogger, StepTimer
from lfm_quant_tpu_torch.weights import (
    flatten_params,
    flax_param_map,
    member_params,
)
from lfm_quant_tpu_torch.weights import init_params as seeded_init

#: Hyperparameters a config grid may vary: each is a per-member operand
#: of the member optimizer. Anything else that differs across run configs
#: changes the model or its data and must stay uniform within one stack.
HYPER_KEYS = ("lr", "weight_decay")


class StackUnavailable(RuntimeError):
    """A precondition for run-stacking is unmet (fewer than two runs,
    ragged run shapes, a config field varying that no per-run operand
    carries, geometry buckets, a process group). The sweeps catch this
    and degrade to sequential fits with a warning, a counter and a
    telemetry instant: a data-dependent mismatch must not kill a sweep
    the sequential path handles."""


class RunCtrl(NamedTuple):
    """The per-run early-stopping state on the device: the
    ``FitHarness`` counters over the run axis, so the control decision
    needs no host sync: a run that stops at epoch e is frozen in epoch
    e+1, whose dispatch reads e's control directly."""

    live: torch.Tensor        # [R] bool: the run still trains
    best_ic: torch.Tensor     # [R] f64: running best val IC (-inf start)
    best_epoch: torch.Tensor  # [R] i64: epoch of best_ic (-1 start)
    bad_epochs: torch.Tensor  # [R] i64: epochs since the last improvement
    step: torch.Tensor        # [R] i64: optimizer steps taken


class StackCarry(NamedTuple):
    """What one stacked epoch carries to the next (a named tuple, so the
    pipeline's rollback clone copies every tensor of it)."""

    state: TrainState
    best_params: Dict[str, torch.Tensor]
    ctrl: RunCtrl


def scan_in_blocks(fn: Callable[[slice], Any], block: int, lead: int
                   ) -> List[Any]:
    """``fn(members)`` over the ``lead`` members in blocks of ``block``,
    in order (the JAX ``lax.scan`` over run blocks, written as a loop):
    activation memory drops from every member's to a block's while the
    per-member math is untouched. ``block`` of 0, at or above ``lead``,
    or not dividing it runs one call over all members (callers that want
    a loud non-divisor warn when they bind the block)."""
    if not block or block >= lead or lead % block:
        return [fn(slice(0, lead))]
    return [fn(slice(s, s + block)) for s in range(0, lead, block)]


def stack_block() -> int:
    """``LFM_STACK_BLOCK``: runs per block of the stacked step (the
    run-axis ``seed_block``); 0 or unset runs every run at once."""
    v = os.environ.get("LFM_STACK_BLOCK")
    return max(0, int(v)) if v not in (None, "") else 0


def sweep_stacked_enabled() -> bool:
    """``LFM_SWEEP_STACKED=0`` sends a config sweep down the sequential
    per-config path (the reference); on by default."""
    return os.environ.get("LFM_SWEEP_STACKED", "1") != "0"


class _StackHarness:
    """The ``FitHarness`` face ``run_fit_epochs`` drives: epoch accounting
    only. Early stopping lives on the device (:class:`RunCtrl`); the
    fit's ``finish`` sets ``all_dead`` from the fetched live mask, and
    ``end_epoch`` reports it (no checkpoint lines: the runs' ``ckpt/best``
    are written at the end)."""

    def __init__(self, epochs: int):
        self.epochs = epochs
        self.all_dead = False
        self._epoch = -1

    def next_epoch(self) -> Optional[int]:
        nxt = self._epoch + 1
        if nxt >= self.epochs or self.all_dead:
            return None
        self._epoch = nxt
        return nxt

    def end_epoch(self, epoch, step, state_dict, val_ic) -> bool:
        return self.all_dead

    @property
    def last_epoch(self) -> int:
        return self._epoch


def _normalized_cfg(cfg: RunConfig) -> RunConfig:
    """A run config with every field that may vary within a stack set to
    one value: the seed, the per-run hyperparameters and the name. Two
    configs share a stack iff they normalize equal."""
    return dataclasses.replace(
        cfg, seed=0, name="",
        optim=dataclasses.replace(cfg.optim, lr=0.0, weight_decay=0.0))


class _Members(EnsembleTrainer):
    """The stack's member trainer: an ``EnsembleTrainer`` over the R·S
    members whose samplers, init generators, dropout seeds, optimizer
    operands and step blocks are the runs'."""

    def __init__(self, stack: "StackedRuns", device):
        self._stack = stack
        super().__init__(stack.member_cfg, stack.splits[0], device=device)

    def _bind(self, cfg, splits, run_dir, echo) -> None:
        super()._bind(cfg, splits, run_dir, echo)
        st = self._stack
        self.samplers = [s for per in st.run_samplers for s in per]
        self._steps_per_epoch = st.steps
        self.opt = make_optimizer(
            cfg.optim, st.steps * cfg.optim.epochs, per_seed=True,
            lr=st.member_lr, weight_decay=st.member_wd)

    def _blocks(self, fn) -> List[Any]:
        st = self._stack
        if not st.stack_block:
            return super()._blocks(fn)
        return scan_in_blocks(fn, st.stack_block * st.n_seeds, self.n_local)

    def _fresh_params(self) -> Dict[str, np.ndarray]:
        kind, kw = model_kwargs(self.cfg)
        fresh = build_model(kind, n_features=self.splits.panel.n_features,
                            n_seeds=self.n_local, **kw)
        seeded_init(fresh, [torch.Generator().manual_seed(s)
                            for s in self._stack.member_seeds])
        return {k: p.detach().numpy() for k, p in flax_param_map(fresh).items()}

    def init_state(self, params=None) -> TrainState:
        state = super().init_state(params)
        return state._replace(rng=torch.tensor(self._stack.member_seeds))


class StackedRuns:
    """One stacked fit over R independent same-shape runs.

    Construction checks every stacking precondition (raising
    :class:`StackUnavailable`), builds the per-run samplers and stacked
    validation batches and binds the member trainer. :meth:`fit` trains
    the stack through the epoch pipeline and unstacks each run's results
    (histories, ``ckpt/best``); ``per_run(k)`` runs each run's own tail
    after its unstack (the walk-forward's predictions).

    ``kind`` labels the run axis: "fold" keeps the walk-forward's names
    (``foldstack_fit`` span, ``fold_stopped`` instants), any other kind
    the generic ones (``stack_fit``, ``run_stopped``). ``init_params``: a
    JAX run-stacked param tree (``[R, ...]`` leaves, ``[R, S, ...]`` for
    ensembles) in place of the seeded init. ``device``: None means
    ``cuda``."""

    def __init__(self, run_cfgs: Sequence[RunConfig],
                 run_splits: Sequence[PanelSplits], panel: Panel, *,
                 kind: str = "config",
                 run_dirs: Optional[Sequence[Optional[str]]] = None,
                 echo: bool = False, device=None,
                 init_params: Optional[Mapping[str, Any]] = None):
        if len(run_cfgs) < 2:
            raise StackUnavailable(
                f"run-stacking needs >= 2 runs, got {len(run_cfgs)}")
        if buckets_enabled():
            raise StackUnavailable(
                "geometry-bucketed batching (LFM_BUCKETS=1) does not "
                "compose with the stacked-run engines yet — runs degrade "
                "to the sequential bucketed path")
        if len(run_splits) != len(run_cfgs):
            raise ValueError("run_cfgs and run_splits length mismatch")
        cfg = run_cfgs[0]
        ref = _normalized_cfg(cfg)
        for k, c in enumerate(run_cfgs[1:], 1):
            if _normalized_cfg(c) != ref:
                raise StackUnavailable(
                    f"run {k}'s config differs beyond the per-run axes "
                    f"(seed, {', '.join(HYPER_KEYS)}) — a field that "
                    "reaches the model or its data cannot vary within "
                    "one stack")
        self.kind = kind
        self.fold_kind = kind == "fold"
        resolve_run_shards(FOLD_AXIS if self.fold_kind else STACK_AXIS)
        if dist_utils.world_size() > 1:
            raise StackUnavailable(
                "the run axis over ranks is not ported (ROADMAP.md Queue A "
                "item 10): in a process group the runs train sequentially")
        self.cfg = cfg
        self.panel = panel
        self.run_cfgs = list(run_cfgs)
        self.splits = list(run_splits)
        self.run_count = R = len(run_cfgs)
        self.n_seeds = S = cfg.n_seeds
        self.run_dirs = (list(run_dirs) if run_dirs is not None
                         else [None] * R)
        self.ensemble = S > 1
        self.het = cfg.is_heteroscedastic
        self.window = cfg.data.window
        self.echo = echo
        d = cfg.data

        lrs = [c.optim.lr for c in run_cfgs]
        wds = [c.optim.weight_decay for c in run_cfgs]
        self.hyper = len(set(lrs)) > 1 or len(set(wds)) > 1
        self.hyper_keys = HYPER_KEYS if self.hyper else ()
        if self.hyper:
            if self.ensemble:
                raise StackUnavailable(
                    "per-run hyperparameter operands are single-seed "
                    "only for now (n_seeds > 1 configs stack uniformly "
                    "or run sequentially)")
            if cfg.optim.optimizer not in ("adamw", "lamb"):
                raise StackUnavailable(
                    f"per-run-operand sweep supports adamw|lamb, got "
                    f"{cfg.optim.optimizer!r}")
        #: The member optimizer's operands (None: the config's, shared).
        self.member_lr = [v for v in lrs for _ in range(S)] \
            if self.hyper else None
        self.member_wd = [v for v in wds for _ in range(S)] \
            if self.hyper else None
        self.member_seeds = [rc.seed + s for rc in run_cfgs
                             for s in range(S)]

        # Per-run samplers with the run's own seeds and anchor range: the
        # streams its sequential fit consumes.
        self.run_samplers = [
            [DateBatchSampler(
                panel, d.window, d.dates_per_batch, d.firms_per_date,
                seed=rc.seed + s, min_valid_months=d.min_valid_months,
                date_range=sp.train_range, engine=d.sampler_engine)
             for s in range(S)]
            for rc, sp in zip(run_cfgs, self.splits)]
        steps = [min(s.batches_per_epoch() for s in per)
                 for per in self.run_samplers]
        if len(set(steps)) != 1:
            raise StackUnavailable(
                f"runs disagree on steps-per-epoch {steps} — stacking "
                "requires the same-shape schedule")
        self.steps = steps[0]

        # Per-run validation sweeps, stacked: the eval width is
        # panel-wide, so only the month count can differ.
        val_samplers = [
            DateBatchSampler(panel, d.window, 1, d.firms_per_date,
                             seed=rc.seed,
                             min_valid_months=d.min_valid_months,
                             min_cross_section=1, date_range=sp.val_range)
            for rc, sp in zip(run_cfgs, self.splits)]
        months = [vs.stacked_eval_months() for vs in val_samplers]
        if len(set(months)) != 1:
            raise StackUnavailable(
                f"runs disagree on eligible val months {months} — "
                "cannot stack the validation sweeps")
        vbs = [vs.stacked_cross_sections() for vs in val_samplers]
        self.counts = np.stack([b.weight.sum(axis=1) for b in vbs])

        blk = stack_block()
        if blk >= R:
            blk = 0
        elif blk and R % blk:
            warnings.warn(
                f"LFM_STACK_BLOCK={blk} does not divide the run count "
                f"{R}; running unblocked", stacklevel=3)
            blk = 0
        self.stack_block = blk

        # An ensemble's seed_block divides R·S too; a single model's has
        # no members to block.
        self.member_cfg = dataclasses.replace(
            cfg, n_seeds=R * S, seed_block=cfg.seed_block if S > 1 else 0)
        self.trainer = _Members(self, device)
        self.device = self.trainer.device
        shared = all(np.array_equal(getattr(b, f), getattr(vbs[0], f))
                     for b in vbs[1:]
                     for f in ("firm_idx", "time_idx", "weight"))
        if shared:
            self._vargs = self.trainer._batch(vbs[0])
        else:
            self._vargs = tuple(
                torch.as_tensor(np.repeat(np.stack([getattr(b, f)
                                                    for b in vbs]), S,
                                          axis=0)).to(self.device)
                for f in ("firm_idx", "time_idx", "weight"))
        self._counts = torch.as_tensor(self.counts, dtype=torch.float64,
                                       device=self.device)
        self._init = (None if init_params is None
                      else member_params(init_params, R, S))

    # ---- the carry -------------------------------------------------------

    def init_carry(self) -> StackCarry:
        """The fresh stacked carry: every run's own init (or the JAX
        tree), the best params' copy and the all-live control."""
        state = self.trainer.init_state(self._init)
        best = {k: p.detach().clone() for k, p in state.params.items()}
        R, dev = self.run_count, self.device
        ctrl = RunCtrl(
            live=torch.ones(R, dtype=torch.bool, device=dev),
            best_ic=torch.full((R,), -torch.inf, dtype=torch.float64,
                               device=dev),
            best_epoch=torch.full((R,), -1, dtype=torch.int64, device=dev),
            bad_epochs=torch.zeros(R, dtype=torch.int64, device=dev),
            step=torch.zeros(R, dtype=torch.int64, device=dev))
        return StackCarry(state, best, ctrl)

    # ---- epoch callbacks (the run_fit_epochs contract) ---------------------

    def build_epoch(self, epoch: int):
        """Host sampling and the copy to the device of one stacked epoch:
        ``[K, R·S, D, Bf]`` index stacks (step-major, as the ensemble's),
        run r's members exactly its sequential fit's batches. A pure read
        per (seed, epoch): safe on the prefetch thread."""
        with telemetry.span("sample", epoch=epoch, runs=self.run_count):
            if self.ensemble:
                per_member = [s.stacked_epoch(epoch)
                              for per in self.run_samplers for s in per]
                # The sequential ensemble truncates to its shortest
                # member; only down to the bound schedule is legal.
                if min(b.firm_idx.shape[0] for b in per_member) < self.steps:
                    raise ValueError(
                        "stacked ensemble epoch shorter than the "
                        f"{self.steps}-step schedule — member samplers "
                        "drifted out of shape")
                fi, ti, w = (np.stack([getattr(b, f)[:self.steps]
                                       for b in per_member], axis=1)
                             for f in ("firm_idx", "time_idx", "weight"))
            else:
                b = stack_fold_epochs([per[0] for per in self.run_samplers],
                                      epoch)
                fi, ti, w = (np.ascontiguousarray(np.swapaxes(a, 0, 1))
                             for a in (b.firm_idx, b.time_idx, b.weight))
            fm = float(w.sum()) * self.window
        with telemetry.span("h2d", epoch=epoch):
            staged = stage(self.device, fi, ti, w)
        return staged + (epoch,), fm

    def _frozen(self, state: TrainState) -> List[torch.Tensor]:
        """The tensors a stopped run keeps: params and both moments."""
        o = state.opt_state
        return (list(state.params.values()) + list(o.mu.values())
                + list(o.nu.values()))

    def dispatch_epoch(self, carry: StackCarry, args):
        """Queue one stacked epoch: every member's K steps, the stopped
        runs put back (``torch.where`` on the live mask), the per-run
        validation sweep and the control update, all on the device."""
        state, best, ctrl = carry
        fi, ti, w, epoch = args
        S = self.n_seeds
        tensors = self._frozen(state)
        start = [t.detach().clone() for t in tensors]
        losses, gnorms = [], []
        for k in range(fi.shape[0]):
            state, ms = self.trainer.step(state, fi[k], ti[k], w[k])
            losses.append(ms["loss"])
            gnorms.append(ms["grad_norm"])

        def lead(mask, t):
            return mask.view(-1, *(1,) * (t.dim() - 1))

        live_m = ctrl.live.repeat_interleave(S)
        with torch.no_grad():
            for t, t0 in zip(tensors, start):
                t.copy_(torch.where(lead(live_m, t), t, t0))
        ic, mse = self._sweep(state.params)
        R, Mv = self.run_count, ic.shape[1]
        if self.ensemble:
            per_seed = ((ic.double().view(R, S, Mv) * self._counts[:, None])
                        .sum(-1) / self._counts.sum(-1)[:, None])
            val_ic = per_seed.mean(dim=1)
        else:
            val_ic = ((ic.double() * self._counts).sum(-1)
                      / self._counts.sum(-1))
        # The FitHarness's comparisons, per run: a strict improvement
        # (-inf start: epoch 0 always improves), else the patience count
        # advances; a run whose count reaches patience leaves the live
        # set for every later epoch.
        live = ctrl.live
        improved = live & (val_ic > ctrl.best_ic)
        bad = torch.where(improved, 0, torch.where(
            live, ctrl.bad_epochs + 1, ctrl.bad_epochs))
        imp_m = improved.repeat_interleave(S)
        with torch.no_grad():
            for key, p in state.params.items():
                best[key].copy_(torch.where(lead(imp_m, p), p, best[key]))
        ctrl = RunCtrl(
            live=live & (bad < self.cfg.optim.early_stop_patience),
            best_ic=torch.where(improved, val_ic, ctrl.best_ic),
            best_epoch=torch.where(improved, epoch, ctrl.best_epoch),
            bad_epochs=bad,
            step=torch.where(live, ctrl.step + fi.shape[0], ctrl.step))
        vals = {"loss": torch.stack(losses), "grad_norm": torch.stack(gnorms),
                "ic": ic, "mse": mse, "step": ctrl.step, "live": ctrl.live}
        return StackCarry(state, best, ctrl), vals

    @torch.inference_mode()
    def _sweep(self, params: Mapping[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every member's per-month validation IC ``[R·S, M]`` (f32) and
        MSE ``[R·S]``, as each run's sequential sweep computes them:
        months in chunks of ``dates_per_batch`` (the last padded by
        repeats at weight 0), members in chunks of the ensemble's
        ``EVAL_STATE_BYTES``. A shared validation batch (a config sweep)
        is gathered once per month chunk; per-run batches (folds) fold
        every member's months into one gather."""
        with telemetry.span("eval", cat="eval"):
            tr = self.trainer
            tr.model.eval()
            fi, ti, w = self._vargs
            shared = fi.dim() == 2
            Mv = fi.shape[-2]
            C = min(self.cfg.data.dates_per_batch, Mv)
            pad = (-Mv) % C
            if pad:
                fi = torch.cat([fi, fi[..., :pad, :]], dim=-2)
                ti = torch.cat([ti, ti[..., :pad]], dim=-1)
                w = torch.cat([w, torch.zeros_like(w[..., :pad, :])], dim=-2)
            M = tr.n_local
            ic = torch.empty((M, Mv + pad), dtype=torch.float32,
                             device=self.device)
            se = torch.empty_like(ic)
            sc = tr._seed_chunk(C * fi.shape[-1])
            for k in range(0, Mv + pad, C):
                mo = slice(k, k + C)
                if shared:
                    x, m = tr._gather(fi[mo], ti[mo], tr.eval_gather_impl)
                for s0 in range(0, M, sc):
                    sl = slice(s0, min(s0 + sc, M))
                    if shared:
                        f, t, ww = fi[mo], ti[mo], w[mo]
                    else:
                        f, t, ww = fi[sl, mo], ti[sl, mo], w[sl, mo]
                        x, m = tr._gather(f, t, tr.eval_gather_impl)
                    pred = _point_forecast(tr._apply(
                        {key: p[sl] for key, p in params.items()}, x, m))
                    y = gather_targets(tr.dev["targets"], f, t)
                    ic[sl, mo] = spearman_ic(pred, y.expand_as(pred),
                                             ww.expand_as(pred)).float()
                    se[sl, mo] = (ww * (pred.float() - y) ** 2).sum(dim=-1)
            ws = w[..., :Mv, :].sum(dim=-1).sum(dim=-1)
            mse = se[:, :Mv].sum(dim=-1) / torch.clamp(ws, min=1e-12)
            return ic[:, :Mv], mse

    # ---- the fit ---------------------------------------------------------

    def run_state(self, k: int, best: Optional[bool] = None
                  ) -> Dict[str, Any]:
        """Run ``k``'s final state as the tree its sequential fit's
        checkpoint holds (``Trainer.load_state`` /
        ``EnsembleTrainer.load_state`` read it), on the device: the
        best-tracked params when the run checkpoints (its sequential fit
        restores ``ckpt/best``), the last recorded params otherwise (a
        fit without a run dir ends on its last epoch's state); the final
        Adam moments, step and dropout seeds."""
        state, best_p, ctrl = self._final
        S = self.n_seeds
        use_best = bool(self.run_dirs[k]) if best is None else best
        src = best_p if use_best else state.params
        sl = slice(k * S, (k + 1) * S)
        step = int(self._host_ctrl.step[k])
        o = state.opt_state

        def rows(tree):
            return {key: (v[k] if S == 1 else v[sl]) for key, v in tree.items()}

        seeds = self.member_seeds[sl]
        return {"params": rows(src),
                "opt_state": {"count": step, "mu": rows(o.mu),
                              "nu": rows(o.nu)},
                "step": step if S == 1 else torch.full((S,), step),
                "rng": seeds[0] if S == 1 else torch.tensor(seeds)}

    def fit(self, per_run: Optional[Callable[[int], None]] = None
            ) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
        """Train the stack and unstack each run's results. Returns
        ``(run_summaries, stack_summary)``; ``per_run(k)`` runs after run
        k's ``ckpt/best`` is written."""
        R, S = self.run_count, self.n_seeds
        histories: List[List[Dict[str, Any]]] = [[] for _ in range(R)]
        loggers = [MetricsLogger(rd, echo=self.echo) for rd in self.run_dirs]
        live_mask = np.ones(R, bool)
        harness = _StackHarness(self.cfg.optim.epochs)
        timer = StepTimer()
        stop_name = "fold_stopped" if self.fold_kind else "run_stopped"
        stop_key = "fold" if self.fold_kind else "run"

        def col(a, r):
            # Run r's columns of a [K, R·S] array, contiguous, so its
            # mean sums in the order of the sequential fit's.
            return np.ascontiguousarray(a[:, r * S:(r + 1) * S] if S > 1
                                        else a[:, r])

        def finish(epoch, host, fm):
            nonlocal live_mask
            live_in = live_mask
            ic = host["ic"].numpy()
            loss = host["loss"].numpy()
            steps = host["step"].numpy()
            live_ics = []
            for r in range(R):
                if not live_in[r]:
                    continue
                if self.ensemble:
                    per_seed = ((ic[r * S:(r + 1) * S] * self.counts[r])
                                .sum(axis=1) / self.counts[r].sum())
                    val_ic = float(per_seed.mean())
                    rec = loggers[r].log(
                        int(steps[r]), epoch=epoch,
                        train_loss=float(col(loss, r).mean()),
                        val_ic=val_ic, val_ic_std=float(per_seed.std()),
                        firm_months_per_sec=timer.throughput())
                else:
                    val_ic = float(np.average(ic[r], weights=self.counts[r]))
                    rec = loggers[r].log(
                        int(steps[r]), epoch=epoch,
                        train_loss=float(col(loss, r).mean()),
                        grad_norm=float(col(host["grad_norm"].numpy(),
                                            r).mean()),
                        val_ic=val_ic, val_mse=float(host["mse"][r]),
                        firm_months_per_sec=timer.throughput())
                histories[r].append(rec)
                live_ics.append(val_ic)
            new_live = host["live"].numpy()
            for r in range(R):
                if live_in[r] and not new_live[r]:
                    telemetry.instant(stop_name, epoch=epoch,
                                      **{stop_key: r})
            live_mask = new_live
            harness.all_dead = not bool(new_live.any())
            return (int(steps.max()),
                    float(np.mean(live_ics)) if live_ics else 0.0)

        if self.fold_kind:
            span_name, span_kw = "foldstack_fit", dict(fold_count=R,
                                                       fold_mesh=None)
        else:
            span_name, span_kw = "stack_fit", dict(
                kind=self.kind, run_count=R, stack_mesh=None,
                hyper=list(self.hyper_keys), stack_block=self.stack_block)
        try:
            with telemetry.span(span_name, cat="fit", **span_kw) as sp:
                carry, overrun = pipeline.run_fit_epochs(
                    harness, self.init_carry(), build=self.build_epoch,
                    dispatch=self.dispatch_epoch, finish=finish,
                    timer=timer, checkpointing=False)
                host_ctrl = pipeline.tree_map(lambda t: t.cpu(), carry.ctrl)
                sp.set(epochs_run=[len(h) for h in histories],
                       best_epochs=[int(e) for e in host_ctrl.best_epoch],
                       overrun=overrun is not None)
        finally:
            for lg in loggers:
                lg.close()
        self._final, self._host_ctrl = carry, host_ctrl

        run_summaries: List[Dict[str, Any]] = []
        for r in range(R):
            best_epoch = int(host_ctrl.best_epoch[r])
            best_val_ic = (histories[r][best_epoch]["val_ic"]
                           if 0 <= best_epoch < len(histories[r])
                           else float(host_ctrl.best_ic[r]))
            if self.run_dirs[r]:
                # The run's ckpt/best line, loadable like its sequential
                # fit's: the device-tracked best params, the final
                # moments, the best epoch's step.
                best_step = (best_epoch + 1) * self.steps
                tree = self.run_state(r, best=True)
                tree["step"] = (best_step if S == 1
                                else torch.full((S,), best_step))
                CheckpointManager(
                    os.path.join(self.run_dirs[r], "ckpt", "best"),
                    max_to_keep=1).save(
                    best_step, pipeline.tree_map(
                        lambda t: t.detach().to("cpu", copy=True), tree),
                    wait=True)
            if per_run is not None:
                per_run(r)
            run_summaries.append({
                "best_val_ic": best_val_ic,
                "best_epoch": best_epoch,
                "epochs_run": len(histories[r]),
                "history": histories[r],
            })
        stack_summary: Dict[str, Any] = {"enabled": True}
        stack_summary.update(span_kw)
        stack_summary.update(steps_per_epoch=self.steps,
                             lookahead_overrun=overrun is not None)
        return run_summaries, stack_summary

    @torch.inference_mode()
    def predict(self, k: int, date_range: Tuple[int, int]
                ) -> Tuple[np.ndarray, ...]:
        """Run ``k``'s forecasts over the month range ``date_range``, as
        its sequential fit's ``predict(date_range=...)`` gives them: the
        member stack's one forward over the range (the best-tracked params
        when the run checkpoints, as its fit restores ``ckpt/best``), run
        k's members scattered into the panel: ``(forecast [N, T], or [S,
        N, T] for an ensemble; with a heteroscedastic head the variances
        alike; valid [N, T])``."""
        state, best_p, _ = self._final
        tr = self.trainer
        tr.state = state._replace(
            params=best_p if self.run_dirs[k] else state.params)
        b = predict_sampler(self.run_cfgs[k], self.splits[k], "test",
                            date_range, True).stacked_cross_sections()
        S, sl = self.n_seeds, slice(k * self.n_seeds, (k + 1) * self.n_seeds)
        out = tr._stacked_forward(b, variance=self.het)
        rows = [o[sl] if S > 1 else o[k] for o in
                (out if self.het else (out,))]
        if self.het:
            (fc, var), valid = scatter_forecasts(
                b, torch.stack(rows).cpu().numpy(), self.panel)
            return fc, var, valid
        return scatter_forecasts(b, rows[0].cpu().numpy(), self.panel)


# ---- the config-sweep workload ---------------------------------------------


def parse_sweep_grid(spec: str) -> List[Dict[str, float]]:
    """``"lr=1e-3,5e-4;weight_decay=1e-4,0"`` → the cartesian grid as a
    list of per-config override dicts (the ``--sweep-grid`` format:
    semicolon-separated axes, comma-separated values). Only the per-run
    operands (:data:`HYPER_KEYS`) are legal axes."""
    axes: List[Tuple[str, List[float]]] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, eq, vals = part.partition("=")
        name = name.strip()
        if not eq or name not in HYPER_KEYS:
            raise ValueError(
                f"sweep axis {name!r} is not sweepable as a per-run "
                f"operand; supported: {', '.join(HYPER_KEYS)}")
        if any(name == n for n, _ in axes):
            raise ValueError(f"duplicate sweep axis {name!r}")
        values = [float(v) for v in vals.split(",") if v.strip()]
        if not values:
            raise ValueError(f"sweep axis {name!r} has no values")
        axes.append((name, values))
    if not axes:
        raise ValueError("empty sweep grid spec")
    grid: List[Dict[str, float]] = [{}]
    for name, values in axes:
        grid = [dict(g, **{name: v}) for g in grid for v in values]
    return grid


def _check_grid(grid) -> List[Dict[str, float]]:
    grid = [dict(g) for g in grid]
    if not grid:
        raise ValueError("empty sweep grid")
    bad = sorted(set().union(*(set(g) for g in grid)) - set(HYPER_KEYS))
    if bad:
        raise ValueError(
            f"unsupported sweep axes {bad}; per-run operands cover "
            f"{', '.join(HYPER_KEYS)}")
    return grid


def _degrade(kind: str, e: StackUnavailable, what: str) -> None:
    """The loud degrade: a warning, a ``stack_degraded`` instant and the
    ``stack_degrades`` counter."""
    warnings.warn(f"{what} unavailable ({e}); running the runs "
                  "sequentially", stacklevel=3)
    telemetry.instant("stack_degraded", kind=kind, reason=str(e))
    telemetry.COUNTERS.bump("stack_degrades")


def _sequential(run_cfgs, run_splits, run_dirs, ensemble: bool, echo: bool,
                device, init_params=None) -> List[Dict[str, Any]]:
    """Each run's own fit, one trainer rebound run after run (run r from
    row r of a run-stacked ``init_params``)."""
    out, trainer = [], None
    cls = EnsembleTrainer if ensemble else Trainer
    for r, (rc, sp, rd) in enumerate(zip(run_cfgs, run_splits, run_dirs)):
        if trainer is None:
            trainer = cls(rc, sp, run_dir=rd, echo=echo, device=device)
        else:
            trainer.rebind(rc, sp, run_dir=rd)
        fit = trainer.fit(init_params=None if init_params is None else {
            k: v[r] for k, v in flatten_params(init_params).items()})
        out.append({k: fit[k] for k in ("best_val_ic", "best_epoch",
                                        "epochs_run", "history")})
    return out


def run_config_sweep(cfg: RunConfig, grid: Sequence[Dict[str, float]],
                     panel: Optional[Panel] = None,
                     out_dir: Optional[str] = None, echo: bool = False,
                     stacked: Optional[bool] = None, device=None,
                     init_params: Optional[Mapping[str, Any]] = None
                     ) -> Dict[str, Any]:
    """Train every config of an LR × weight-decay ``grid`` on the run
    config's train/val split: as ONE stack (:class:`StackedRuns`, the
    hyperparameters as per-member operands) when the preconditions hold,
    else as sequential per-config fits (also the reference, with
    ``stacked=False`` / ``LFM_SWEEP_STACKED=0``). A
    :class:`StackUnavailable` degrades loudly.

    Per-config run dirs land under ``out_dir/config_<i>`` (config.json,
    metrics.jsonl, ckpt/best: loadable by ``load_trainer``), and
    ``sweep_summary.json`` ranks the grid. ``init_params``: a JAX
    run-stacked param tree (``[R, ...]`` leaves) in place of each
    config's seeded init, on either path. Returns the summary (per-config
    best val ICs, best epochs, ``best_index`` / ``best_config``)."""
    from lfm_quant_tpu_torch.train.walkforward import write_fold_run_dir

    grid = _check_grid(grid)
    if stacked is None:
        stacked = sweep_stacked_enabled()
    run_cfgs = [
        dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, **g))
        for g in grid]
    if panel is None:
        panel = resolve_panel(cfg.data)
    train_end, val_end = default_split_dates(panel, cfg.data)
    splits = PanelSplits.by_date(panel, train_end, val_end,
                                 train_start=cfg.data.train_start)
    R = len(grid)
    ensemble = cfg.n_seeds > 1
    run_dirs: List[Optional[str]] = [
        os.path.join(out_dir, f"config_{i:03d}") if out_dir else None
        for i in range(R)]
    for i, rd in enumerate(run_dirs):
        if rd:
            write_fold_run_dir(run_cfgs[i], rd, train_end, val_end,
                               cfg.data.train_start, ensemble)
    run_sums = stack_info = None
    with telemetry.span("config_sweep", cat="fit", n_configs=R):
        if stacked and R >= 2:
            try:
                eng = StackedRuns(run_cfgs, [splits] * R, panel,
                                  kind="config", run_dirs=run_dirs,
                                  echo=echo, device=device,
                                  init_params=init_params)
                run_sums, stack_info = eng.fit()
            except StackUnavailable as e:
                _degrade("config", e, "stacked config sweep")
        if run_sums is None:
            run_sums = _sequential(run_cfgs, [splits] * R, run_dirs,
                                   ensemble, echo, device, init_params)
    runs = [{"config": grid[i], "run_dir": run_dirs[i],
             "best_val_ic": run_sums[i]["best_val_ic"],
             "best_epoch": run_sums[i]["best_epoch"],
             "epochs_run": run_sums[i]["epochs_run"]} for i in range(R)]
    best_index = int(max(range(R), key=lambda i: runs[i]["best_val_ic"]))
    summary = {
        "n_configs": R,
        "grid": grid,
        "train_end": train_end,
        "val_end": val_end,
        "runs": runs,
        "stacked": stack_info,
        "best_index": best_index,
        "best_config": grid[best_index],
        "best_val_ic": runs[best_index]["best_val_ic"],
    }
    if out_dir and dist_utils.is_main():
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "sweep_summary.json"), "w") as fh:
            json.dump(summary, fh, indent=2)
    return summary


def run_walkforward_sweep(cfg: RunConfig, grid: Sequence[Dict[str, float]],
                          panel: Optional[Panel] = None, *, start: int,
                          step_months: int = 12, val_months: int = 24,
                          n_folds: Optional[int] = None,
                          train_months: Optional[int] = None,
                          out_dir: Optional[str] = None, echo: bool = False,
                          stacked: Optional[bool] = None, device=None
                          ) -> Dict[str, Any]:
    """The fold × config product (``--sweep-grid`` with
    ``--walk-forward``): every (fold, config) pair one run of a single
    stack, each with its own (config, splits); fold k's seed is ``seed +
    1000·k`` as in the walk-forward. A rolling ``train_months`` window
    keeps the folds the same shape; expanding folds usually differ in
    steps per epoch and degrade loudly to sequential fits. Run dirs land
    under ``<out_dir>/fold_<k>/config_<j>``; ``sweep_summary.json`` ranks
    the configs by their mean best val IC over the folds (``by_config``)
    and each fold's own ranking (``folds``). No forecast stitching: pick
    the winner here, then run the plain walk-forward with it."""
    from lfm_quant_tpu_torch.train.walkforward import (month_add,
                                                       walkforward_folds,
                                                       write_fold_run_dir)

    grid = _check_grid(grid)
    if stacked is None:
        stacked = sweep_stacked_enabled()
    if panel is None:
        panel = resolve_panel(cfg.data)
    folds = walkforward_folds(panel, start, step_months, val_months,
                              n_folds)
    F, C = len(folds), len(grid)
    ensemble = cfg.n_seeds > 1
    run_cfgs: List[RunConfig] = []
    run_splits: List[PanelSplits] = []
    run_dirs: List[Optional[str]] = []
    for k, (train_end, val_end, _pred) in enumerate(folds):
        train_start = (month_add(train_end, -train_months)
                       if train_months else None)
        splits = PanelSplits.by_date(panel, train_end, val_end,
                                     train_start=train_start)
        for j, g in enumerate(grid):
            rc = dataclasses.replace(
                cfg, seed=cfg.seed + 1000 * k,
                optim=dataclasses.replace(cfg.optim, **g))
            rd = (os.path.join(out_dir, f"fold_{k}", f"config_{j:03d}")
                  if out_dir else None)
            if rd:
                write_fold_run_dir(rc, rd, train_end, val_end, train_start,
                                   ensemble)
            run_cfgs.append(rc)
            run_splits.append(splits)
            run_dirs.append(rd)
    run_sums = stack_info = None
    with telemetry.span("wf_config_sweep", cat="fit", n_folds=F,
                        n_configs=C):
        if stacked and F * C >= 2:
            try:
                eng = StackedRuns(run_cfgs, run_splits, panel, kind="grid",
                                  run_dirs=run_dirs, echo=echo,
                                  device=device)
                run_sums, stack_info = eng.fit()
            except StackUnavailable as e:
                _degrade("grid", e, "stacked fold×config sweep")
        if run_sums is None:
            run_sums = _sequential(run_cfgs, run_splits, run_dirs, ensemble,
                                   echo, device)
    fold_recs = []
    for k, (train_end, val_end, _pred) in enumerate(folds):
        runs = [{"config": grid[j], "run_dir": run_dirs[k * C + j],
                 "best_val_ic": run_sums[k * C + j]["best_val_ic"],
                 "best_epoch": run_sums[k * C + j]["best_epoch"],
                 "epochs_run": run_sums[k * C + j]["epochs_run"]}
                for j in range(C)]
        fold_recs.append({
            "fold": k, "train_end": train_end, "val_end": val_end,
            "runs": runs,
            "best_index": int(max(range(C),
                                  key=lambda j: runs[j]["best_val_ic"])),
        })
    by_config = []
    for j in range(C):
        ics = [run_sums[k * C + j]["best_val_ic"] for k in range(F)]
        by_config.append({
            "config": grid[j],
            "mean_best_val_ic": float(np.mean(ics)),
            "min_best_val_ic": float(np.min(ics)),
            "per_fold": [float(v) for v in ics],
        })
    best_index = int(max(range(C),
                         key=lambda j: by_config[j]["mean_best_val_ic"]))
    summary = {
        "n_folds": F,
        "n_configs": C,
        "grid": grid,
        "step_months": step_months,
        "val_months": val_months,
        "train_months": train_months,
        "folds": fold_recs,
        "by_config": by_config,
        "best_index": best_index,
        "best_config": grid[best_index],
        "stacked": stack_info,
    }
    if out_dir and dist_utils.is_main():
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "sweep_summary.json"), "w") as fh:
            json.dump(summary, fh, indent=2)
    return summary
