"""The seed ensemble: the port of ``lfm_quant_tpu/train/ensemble.py``
(``EnsembleTrainer``), on one device or over a (seed × data × seq) mesh
of processes.

``cfg.n_seeds`` independent members of one model train as ONE stacked
state: every param and both Adam moments carry a leading seed axis
(``RNNModel(..., n_seeds=S)``), and each step runs all members at once.
The JAX package writes the seed axis as a ``vmap``; here it is a batch
dimension written out, so one launch of each kernel (the window gather,
the fused recurrence forward and its backward) serves every seed of a
step, and the per-seed products around them are batched matrix
products.

* Diversity: member s draws its init from its own generator (``cfg.seed
  + s``), its data order from its own ``DateBatchSampler`` (``seed =
  cfg.seed + s``) and, for a model with dropout, its masks from its own
  stream (base seed ``cfg.seed + s``; each step's generator derived from
  it and the member's step, as the single-model ``Trainer`` derives its
  one); an epoch is truncated to the shortest member's.
* The loss is the SUM of the per-seed losses, so each member gets
  exactly its own gradient; the optimizer (AdamW or LAMB) clips by each
  member's own global norm, and LAMB takes each member's trust ratios
  (``per_seed=True``).
* ``cfg.seed_block`` runs the stack in blocks of that many seeds (the
  JAX ``scan_in_blocks``): activation memory drops to one block's, the
  per-seed math is untouched. 0, or a block at or above the seed count,
  runs all seeds at once; a negative or non-dividing block raises. Each
  member's dropout masks come from its own generator, so blocking
  changes no draw either.
* Early stopping on the ENSEMBLE-MEAN validation IC; members advance in
  lock-step. One stacked checkpoint (``ckpt/latest``, ``ckpt/best``)
  through :class:`~lfm_quant_tpu_torch.train.loop.FitHarness`.
* The validation sweep and :meth:`EnsembleTrainer.predict` run over
  month chunks (``dates_per_batch``) and, within each, over seed chunks
  sized so that one chunk's recurrence states stay within
  :data:`EVAL_STATE_BYTES`: on the card one seed-grid launch of the fused
  forward per chunk. ``predict`` takes a split or a month range, live
  months included, for the backtest, forecast and walk-forward paths;
  ``fit(init_params=)`` and ``rebind`` give the walk-forward its warm
  start and its folds.

* Across processes (``parallel/mesh.py``, the JAX ``train/ensemble.py:
  295-340`` mesh): the seed axis takes the largest divisor of both the
  seed count and the world, and rank r trains only its block of members
  (each keeps its one-process init, sampler seed, dropout stream and
  optimizer rows), so the steps exchange nothing over it; the data and
  seq axes compose as in the single-model ``Trainer`` (the members'
  loss parts summed over the date shards, the gradients over the date and
  seq shards). ``seed_block`` applies to the rank's own members. The
  per-seed validation ICs and the epoch's losses are gathered over the
  seeds, so every rank takes the same early-stop and best-epoch
  decisions; ``predict`` gathers the ``[S, N, T]`` forecasts; rank 0
  writes the whole stacked state once, a checkpoint that one process
  loads (``load_ensemble``) and a seed-sharded run resumes from.

The epoch loop runs through the async pipeline (``train/pipeline.py``;
``LFM_ASYNC``, ``LFM_ASYNC_CKPT``, SIGTERM preemption) with the JAX
ensemble's callbacks; ``LFM_BUCKETS=1`` trains on the (lookback × width)
bucket ladder, every member drawing its own shuffle of the shared,
seed-invariant geometry (the JAX ``_build_bucketed_epoch``), and sweeps
and predicts on it; ``predict(return_variance=True)`` gives the
heteroscedastic members' ``[S, N, T]`` aleatoric variances.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
from torch.func import functional_call, vmap

from lfm_quant_tpu_torch.config import RunConfig, compute_dtype, model_kwargs
from lfm_quant_tpu_torch.data.panel import Panel, PanelSplits
from lfm_quant_tpu_torch.data.windows import (
    DateBatchSampler,
    WindowIndex,
    device_panel,
    gather_targets,
    gather_windows_packed,
    resolve_gather_impl,
)
from lfm_quant_tpu_torch.ops.losses import finalize_loss, make_loss_parts
from lfm_quant_tpu_torch.device import resolve_device
from lfm_quant_tpu_torch.models import build_model
from lfm_quant_tpu_torch.ops.gather import fold_seeds, gather_windows
from lfm_quant_tpu_torch.ops.metrics import spearman_ic
from lfm_quant_tpu_torch.train.checkpoint import CheckpointManager
from lfm_quant_tpu_torch.train.forecast import mark_ensemble_run_dir
from lfm_quant_tpu_torch.parallel import ring
from lfm_quant_tpu_torch.parallel.mesh import (
    BATCH,
    SEED_AXIS,
    all_gather_cat,
    all_reduce_flat,
    all_reduce_sum,
    data_mesh,
    mesh_fingerprint,
    month_block,
    shard_dates,
)
from lfm_quant_tpu_torch.train.loop import (
    _KEEP,
    DROPOUT_STREAM,
    FitHarness,
    TrainState,
    _point_forecast,
    check_seq,
    count_bucket_cells,
    derive_seed,
    generator,
    graft_params,
    has_dropout,
    predict_sampler,
    resolve_buckets,
    scatter_bucketed,
    scatter_forecasts,
    seq_model,
    splits_for,
    stage,
    sub_window,
)
from lfm_quant_tpu_torch.train import pipeline
from lfm_quant_tpu_torch.train.optim import AdamWState, make_optimizer
from lfm_quant_tpu_torch.utils import distributed as dist_utils
from lfm_quant_tpu_torch.utils import debug, telemetry
from lfm_quant_tpu_torch.utils.logging import MetricsLogger, StepTimer
from lfm_quant_tpu_torch.weights import flax_param_map, load_flax_params
from lfm_quant_tpu_torch.weights import init_params as seeded_init

#: Budget of one seed chunk of the validation sweep and ``predict``: the
#: bytes of one recurrence state tensor ``[seeds, rows, W, H]`` in the
#: compute dtype. At c5 (8 months x a 3325-firm pool, W 60, H 128, bf16)
#: one seed is 409 MB, so a chunk holds 10 seeds; all 64 would be 26 GB.
EVAL_STATE_BYTES = 4 << 30


class EnsembleTrainer:
    """Trains ``cfg.n_seeds`` members as one stacked state on one device
    (in a process group: this rank's block of them, ``seeds``).

    ``device``: None means ``cuda`` (the kernels); ``"cpu"`` runs every
    kernel's plain version. ``run_dir`` None trains without checkpoints
    or a metrics file. After :meth:`fit` (or :func:`load_ensemble`),
    ``state`` holds the best stacked state."""

    def __init__(self, cfg: RunConfig, splits: PanelSplits,
                 run_dir: Optional[str] = None, echo: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self._build(cfg, splits.panel)
        self._bind(cfg, splits, run_dir, echo)

    @staticmethod
    def _key(cfg: RunConfig):
        """What the stacked model and the device panel are built from
        (besides the panel itself)."""
        return (cfg.model, cfg.n_seeds, cfg.n_data_shards, cfg.n_seq_shards,
                compute_dtype(cfg), cfg.data.window, cfg.data.gather_impl)

    def _build(self, cfg: RunConfig, panel: Panel) -> None:
        """The mesh, this rank's members, the stacked model (and, under a
        live seq axis, its window-sharded twin) and the device-resident
        panel."""
        if cfg.n_seeds < 2:
            raise ValueError("EnsembleTrainer needs n_seeds >= 2")
        d = cfg.data
        self.mesh = data_mesh(cfg.n_data_shards, n_seeds=cfg.n_seeds,
                              n_seq_shards=check_seq(cfg))
        local = cfg.n_seeds // self.mesh.n_seed
        #: This rank's members (global seed indices).
        self.seeds = range(self.mesh.seed_rank * local,
                           (self.mesh.seed_rank + 1) * local)
        self.panel = panel
        self.window = d.window
        self.fp = panel.n_features + 1  # logical packed width
        self.gather_impl = resolve_gather_impl(d.gather_impl)
        kind, kwargs = model_kwargs(cfg)
        self.model = build_model(kind, n_features=panel.n_features,
                                 n_seeds=local, **kwargs).to(self.device)
        self.train_model = seq_model(cfg, self.mesh, panel.n_features,
                                     self.device, n_seeds=local)
        # Flax path → the module's own name, for functional_call.
        names = {id(p): n for n, p in self.model.named_parameters()}
        self._names = {k: names[id(p)]
                       for k, p in flax_param_map(self.model).items()}
        self.dev = device_panel(panel, self.device, compute_dtype(cfg))

    def rebind(self, cfg: Optional[RunConfig] = None,
               splits: Optional[PanelSplits] = None, run_dir: Any = _KEEP,
               echo: Optional[bool] = None) -> "EnsembleTrainer":
        """Re-initialize for the next walk-forward fold: new split
        boundaries, per-seed samplers seeded from the new config, a new
        run dir, the stacked state dropped. An omitted argument keeps the
        previous value; ``run_dir=None`` drops the run dir. The stacked
        model and the device panel are kept while the panel and the
        model's config are unchanged, else rebuilt. (The JAX trainer's
        rebind also keeps its compiled programs; the port has no program
        cache.) Returns self."""
        cfg = self.cfg if cfg is None else cfg
        splits = self.splits if splits is None else splits
        if splits.panel is not self.panel or self._key(cfg) != self._key(
                self.cfg):
            self._build(cfg, splits.panel)
        self._bind(cfg, splits, self.run_dir if run_dir is _KEEP else run_dir,
                   self.echo if echo is None else echo)
        return self

    def _bind(self, cfg: RunConfig, splits: PanelSplits,
              run_dir: Optional[str], echo: bool) -> None:
        """The fit's splits, per-seed samplers, loss and optimizer."""
        self.n_seeds = cfg.n_seeds
        local = len(self.seeds)
        self.seed_block = int(cfg.seed_block or 0)
        if self.seed_block < 0:
            raise ValueError(f"seed_block must be >= 0, got {self.seed_block}")
        # A block at or above the rank's seed count is a no-op, not an
        # error (a config tuned for one card stays loadable on a wider
        # seed mesh).
        if 0 < self.seed_block < local and local % self.seed_block:
            raise ValueError(
                f"seed_block={self.seed_block} must divide the per-shard "
                f"seed count {local} (n_seeds={cfg.n_seeds} over a "
                f"{self.mesh.n_seed}-wide seed mesh)")
        if cfg.data.dates_per_batch % self.mesh.n_data:
            raise ValueError(
                f"dates_per_batch={cfg.data.dates_per_batch} must be "
                f"divisible by n_data_shards={self.mesh.n_data}")
        self.cfg = cfg
        self.splits = splits
        self.run_dir = run_dir
        self.echo = echo
        self.state: Optional[TrainState] = None
        panel = splits.panel
        d = cfg.data
        # The eval sweep takes the kernel only when asked by name, as the
        # single-model Trainer's does.
        self.eval_gather_impl = ("kernel" if d.gather_impl == "pallas"
                                 else "plain")
        # The members' samplers differ only in their seed: one is built.
        base = DateBatchSampler(
            panel, d.window, d.dates_per_batch, d.firms_per_date,
            seed=cfg.seed + self.seeds[0],
            min_valid_months=d.min_valid_months,
            date_range=splits.train_range, engine=d.sampler_engine)
        self.samplers = [base.reseeded(cfg.seed + s) for s in self.seeds]
        self.val_sampler = DateBatchSampler(
            panel, d.window, 1, d.firms_per_date, seed=cfg.seed,
            min_valid_months=d.min_valid_months, min_cross_section=1,
            date_range=splits.val_range)
        self.loss_parts = make_loss_parts(cfg.optim.loss)
        self._needs_rng = has_dropout(cfg)
        # The geometry is eligibility-derived, so every member's sampler
        # has the same buckets and bucketed step count: computed once and
        # shared.
        self._bucketed = resolve_buckets(self.mesh)
        if self._bucketed:
            geo = self.samplers[0].bucket_geometry()
            for s in self.samplers[1:]:
                s._bucket_geo = geo
        self._steps_per_epoch = (
            self.samplers[0].bucketed_batches_per_epoch() if self._bucketed
            else min(s.batches_per_epoch() for s in self.samplers))
        self.opt = make_optimizer(cfg.optim,
                                  self._steps_per_epoch * cfg.optim.epochs,
                                  per_seed=True)

    # ---- state -----------------------------------------------------------

    @property
    def n_local(self) -> int:
        """This rank's member count."""
        return len(self.seeds)

    def _local(self, t):
        """This rank's rows of an all-seed stacked leaf (leading axis S);
        a leaf already at the rank's count passes."""
        if self.mesh.n_seed == 1 or t.shape[0] != self.n_seeds:
            return t
        return t[self.seeds.start:self.seeds.stop]

    def _fresh_params(self) -> Dict[str, np.ndarray]:
        """A seeded stacked init of this rank's members as a Flax tree:
        member s from ``torch.Generator().manual_seed(cfg.seed + s)``."""
        kind, kw = model_kwargs(self.cfg)
        fresh = build_model(kind, n_features=self.splits.panel.n_features,
                            n_seeds=self.n_local, **kw)
        seeded_init(fresh, [torch.Generator().manual_seed(self.cfg.seed + s)
                            for s in self.seeds])
        return {k: p.detach().numpy() for k, p in flax_param_map(fresh).items()}

    def init_state(self, params: Optional[Mapping[str, Any]] = None
                   ) -> TrainState:
        """Fresh stacked params (the seeded init, or a seed-stacked Flax
        tree of this rank's members, such as the JAX ensemble's; ``fit``
        takes this rank's block of an all-seed tree), fresh optimizer
        state, every member at step 0 (``step`` is ``[s]`` int64), member
        s's dropout base seed ``cfg.seed + s`` (``rng``, ``[s]`` int64)."""
        load_flax_params(self.model, self._fresh_params() if params is None
                         else params)
        live = flax_param_map(self.model)
        return TrainState(live, self.opt.init(
            {k: p.detach() for k, p in live.items()}),
            torch.zeros(self.n_local, dtype=torch.int64),
            self.cfg.seed + torch.tensor(list(self.seeds)))

    def _gather_seeds(self, tensors: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
        """This rank's ``[s, ...]`` tensors (one dtype) → every member's
        ``[S, ...]``, through one gather over the seed axis."""
        if self.mesh.n_seed == 1:
            return list(tensors)
        s = self.n_local
        flat = torch.cat([t.reshape(s, -1) for t in tensors], dim=1)
        full = all_gather_cat(flat, self.mesh, SEED_AXIS)
        out = full.split([t[0].numel() for t in tensors], dim=1)
        return [o.reshape((self.n_seeds,) + t.shape[1:])
                for o, t in zip(out, tensors)]

    def _snapshot(self, state: TrainState) -> Dict[str, Any]:
        """Every member's stacked state as a tree of tensors (on the
        device, but ``step`` and ``rng``): in a seed-sharded group
        gathered from every rank (all of them call it; rank 0 writes
        it)."""
        o = state.opt_state
        keys = list(state.params)
        f32 = self._gather_seeds(
            [state.params[k] for k in keys] + [o.mu[k] for k in keys]
            + [o.nu[k] for k in keys])
        n = len(keys)
        step, rng = state.step, state.rng
        if self.mesh.n_seed > 1:
            step, rng = (t.cpu() for t in self._gather_seeds(
                [step.to(self.device), rng.to(self.device)]))
        return {"params": dict(zip(keys, f32[:n])),
                "opt_state": {"count": o.count,
                              "mu": dict(zip(keys, f32[n:2 * n])),
                              "nu": dict(zip(keys, f32[2 * n:]))},
                "step": step, "rng": rng}

    def state_dict(self, state: TrainState) -> Dict[str, Any]:
        """A host copy of every member's stacked state for a checkpoint
        (:meth:`_snapshot` copied to the CPU)."""
        return pipeline.tree_map(lambda t: t.detach().to("cpu", copy=True),
                                 self._snapshot(state))

    def load_state(self, saved: Mapping[str, Any]) -> TrainState:
        """Copy a checkpointed stacked state (every member's; this rank
        takes its block) into the model and the device."""
        params = flax_param_map(self.model)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(self._local(saved["params"][k]))
        o = saved["opt_state"]
        to = (lambda d: {k: self._local(v).to(self.device)
                         for k, v in d.items()})
        rng = saved.get("rng")
        return TrainState(params, AdamWState(int(o["count"]), to(o["mu"]),
                                             to(o["nu"])),
                          self._local(saved["step"]).clone(),
                          self.cfg.seed + torch.tensor(list(self.seeds))
                          if rng is None else self._local(rng).clone())

    # ---- the forward -----------------------------------------------------

    def _gather(self, fi: torch.Tensor, ti: torch.Tensor,
                impl: Optional[str] = None, window: Optional[int] = None):
        """Windows of an index batch: ``[M, Bf]`` shared by every seed, or
        ``[s, D, Bf]`` per seed, whose seeds fold into one call
        (``window`` overrides the lookback: a seq rank's sub-window)."""
        gather = (gather_windows if (impl or self.gather_impl) == "kernel"
                  else gather_windows_packed)
        window = window or self.window
        if fi.dim() == 3:
            return fold_seeds(gather, self.dev["xm"], fi, ti, window,
                              self.fp)
        return gather(self.dev["xm"], fi, ti, window, fp=self.fp)

    def _apply(self, params: Mapping[str, torch.Tensor], x: torch.Tensor,
               m: torch.Tensor, rng=None, model=None):
        """The stacked model (or ``model``, the window-sharded twin) on
        ``params`` (this rank's seeds or a block): ``x [s, D, Bf, W, F]``
        and ``m [s, D, Bf, W]`` (or without the seed axis: shared) →
        ``[s, D, Bf]`` outputs; ``rng``, one generator per seed of the
        block, turns dropout on."""
        seeded = x.dim() == 5
        db = x.shape[-4:-2]  # [D, Bf]
        flat = (x.shape[0], -1) if seeded else (-1,)
        out = functional_call(
            model or self.model,
            {self._names[k]: p for k, p in params.items()},
            (x.reshape(flat + x.shape[-2:]), m.reshape(flat + m.shape[-1:])),
            {"rng": rng})
        shape = (next(iter(params.values())).shape[0],) + db
        if isinstance(out, tuple):
            return tuple(o.reshape(shape) for o in out)
        return out.reshape(shape)

    def _seed_parts(self, params: Mapping[str, torch.Tensor],
                    fi: torch.Tensor, ti: torch.Tensor,
                    w: torch.Tensor, rng=None, window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-seed loss parts ``(num [s], den [s])`` of an ``[s, D, Bf]``
        index batch: one gather over all its seeds (under a seq axis, of
        this seq rank's sub-window), the stacked model (dropout on under
        ``rng``, a generator per seed; the window-sharded twin under a seq
        axis), and the loss parts vmapped over the seed axis (each seed's
        its own loss, as in JAX; ``window``: a geometry bucket's
        lookback)."""
        y = gather_targets(self.dev["targets"], fi, ti)
        if self.train_model is None:
            x, m = self._gather(fi, ti, window=window)
            out = self._apply(params, x, m, rng)
        else:
            wl, shift = sub_window(self.window, self.mesh)
            x, m = self._gather(fi, ti - shift, window=wl)
            with ring.bind_seq_axis(self.mesh):
                out = self._apply(params, x, m, rng, self.train_model)
        return vmap(self.loss_parts)(out, y, w)

    def step_generators(self, state: TrainState, seeds: slice):
        """The step's dropout generators of a block of this rank's
        members, each derived from the member's base seed and step (and
        the date shard under a data axis), or None for a model without
        dropout."""
        if not self._needs_rng:
            return None
        shard = [self.mesh.rank] if self.mesh.n_data > 1 else []
        return [generator(derive_seed(DROPOUT_STREAM, int(state.rng[s]),
                                      int(state.step[s]), *shard),
                          self.device)
                for s in range(self.n_local)[seeds]]

    # ---- the step --------------------------------------------------------

    def step(self, state: TrainState, fi: torch.Tensor, ti: torch.Tensor,
             w: torch.Tensor, window: Optional[int] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One lock-step update of this rank's members on their ``[s, D,
        Bf]`` index batch (the global dates; this rank takes its block) on
        the device (``window``: a geometry bucket's lookback). Returns the
        new state and ``{"loss", "grad_norm"}``, each ``[s]`` on the
        device (no host sync)."""
        self.model.train()
        keys = list(state.params)
        fi, ti, w = (shard_dates(a, self.mesh, axis=1) for a in (fi, ti, w))
        grads = [torch.empty_like(state.params[k]) for k in keys]

        def block(sl):
            sub = {k: state.params[k][sl].detach().requires_grad_(True)
                   for k in keys}
            num, den = self._seed_parts(sub, fi[sl], ti[sl], w[sl],
                                        self.step_generators(state, sl),
                                        window)
            num_g, den_g = all_reduce_sum(
                torch.stack([num.detach(), den.detach()]), self.mesh)
            loss = num / torch.clamp(den_g, min=1e-12)
            for g, gb in zip(grads, torch.autograd.grad(
                    loss.sum(), [sub[k] for k in keys])):
                g[sl] = gb
            return finalize_loss(num_g, den_g)

        losses = torch.cat(self._blocks(block))
        grads = all_reduce_flat(grads, self.mesh, BATCH)
        grads = dict(zip(keys, grads))
        gnorm = self.opt.step(state.params, grads, state.opt_state)
        debug.check_step({"loss": losses, "grads": grads,
                          "params": state.params})
        return (state._replace(step=state.step + 1),
                {"loss": losses.detach(), "grad_norm": gnorm})

    def _blocks(self, fn) -> List[Any]:
        """``fn(members)`` over this rank's members in blocks of
        ``seed_block`` (all at once for 0 or a block at or above the
        count), in order."""
        S = self.n_local
        block = self.seed_block if 0 < self.seed_block < S else S
        return [fn(slice(s0, s0 + block)) for s0 in range(0, S, block)]

    # ---- evaluation ------------------------------------------------------

    def _seed_chunk(self, rows: int) -> int:
        """Seeds per chunk of the sweep: one chunk's largest activation
        (the recurrence states ``[seeds, rows, W, H]``, the LRU's complex
        state, the attention scores; the model's ``row_state_bytes``)
        within :data:`EVAL_STATE_BYTES`."""
        per_seed = rows * self.model.row_state_bytes(self.window)
        return max(1, min(self.n_local, EVAL_STATE_BYTES // per_seed))

    def _forward_chunks(self, params: Mapping[str, torch.Tensor],
                        fi: torch.Tensor, ti: torch.Tensor,
                        impl: Optional[str] = None,
                        window: Optional[int] = None
                        ) -> Iterator[Tuple[slice, slice, Any]]:
        """The stacked forward over an ``[M, Bf]`` index batch that every
        seed shares, chunked over months by ``dates_per_batch`` (the last
        chunk padded by repeating months, as the single-model sweep does)
        and over seeds by :meth:`_seed_chunk`. The windows are gathered
        once per month chunk (``window``: a geometry bucket's lookback).
        Yields ``(months of the padded batch, seeds, output [seeds, C,
        Bf])``."""
        M = fi.shape[0]
        C = min(self.cfg.data.dates_per_batch, M)
        pad = (-M) % C
        if pad:
            fi = torch.cat([fi, fi[:pad]], dim=0)
            ti = torch.cat([ti, ti[:pad]], dim=0)
        sc = self._seed_chunk(C * fi.shape[1])
        for k in range(0, fi.shape[0], C):
            x, m = self._gather(fi[k:k + C], ti[k:k + C], impl, window)
            for s0 in range(0, self.n_local, sc):
                seeds = slice(s0, min(s0 + sc, self.n_local))
                sub = {key: p[seeds] for key, p in params.items()}
                yield slice(k, k + C), seeds, self._apply(sub, x, m)

    def _month_rows(self, M: int):
        """This rank's rows of an ``M``-month sweep (``month_block`` over
        the date and seq shards of its seed block), on the device."""
        rows, _ = month_block(M, self.cfg.data.dates_per_batch, self.mesh)
        return rows.to(self.device, non_blocking=True)

    def _gather_sweep(self, out: torch.Tensor, M: int) -> torch.Tensor:
        """This rank's ``[s, Mr, ...]`` sweep rows → every member's ``[S,
        M, ...]``: gathered over the batch group's months, then the
        seeds."""
        out = all_gather_cat(out, self.mesh, BATCH, dim=1)[:, :M]
        return all_gather_cat(out.contiguous(), self.mesh, SEED_AXIS)

    @torch.inference_mode()
    def _eval_ic(self, params: Mapping[str, torch.Tensor], fi: torch.Tensor,
                 ti: torch.Tensor, w: torch.Tensor,
                 window: Optional[int] = None) -> torch.Tensor:
        """Per-seed, per-month Spearman IC ``[S, M]`` over a stacked ``[M,
        bf]`` val batch, on the device (the JAX vmapped ``_forward_impl``;
        ``window``: a geometry bucket's lookback): this rank's members
        over its block of months, gathered. Traced as an ``eval`` span."""
        with telemetry.span("eval", cat="eval"):
            return self._eval_ic_sweep(params, fi, ti, w, window)

    def _eval_ic_sweep(self, params, fi, ti, w, window):
        self.model.eval()
        M = fi.shape[0]
        rows = self._month_rows(M)
        fi, ti, w = fi[rows], ti[rows], w[rows]
        Mr = fi.shape[0]
        pad = (-Mr) % min(self.cfg.data.dates_per_batch, Mr)
        fi_p = torch.cat([fi, fi[:pad]]) if pad else fi
        ti_p = torch.cat([ti, ti[:pad]]) if pad else ti
        w_p = torch.cat([w, torch.zeros_like(w[:pad])]) if pad else w
        ic = torch.empty((self.n_local, fi_p.shape[0]), dtype=torch.float32,
                         device=fi.device)
        for months, seeds, out in self._forward_chunks(
                params, fi, ti, self.eval_gather_impl, window):
            pred = _point_forecast(out)
            f, t, ww = fi_p[months], ti_p[months], w_p[months]
            y = gather_targets(self.dev["targets"], f, t)
            ic[seeds, months] = spearman_ic(pred, y.expand_as(pred),
                                            ww.expand_as(pred)).float()
        return self._gather_sweep(ic[:, :Mr], M)

    def _batch(self, b):
        return (torch.as_tensor(b.firm_idx).to(self.device),
                torch.as_tensor(b.time_idx).to(self.device),
                torch.as_tensor(b.weight).to(self.device))

    def evaluate(self, params: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> Dict[str, Any]:
        """Per-member validation IC (each month's IC weighted by its pool
        size) and their mean and standard deviation, from ``params``
        (default the trained state's)."""
        params = self.state.params if params is None else params
        b = self.val_sampler.stacked_cross_sections()
        ics = self._eval_ic(params, *self._batch(b)).cpu().numpy()
        counts = b.weight.sum(axis=1)
        per_seed = (ics * counts).sum(axis=1) / counts.sum()
        return {"ic_per_seed": per_seed, "ic_mean": float(per_seed.mean()),
                "ic_std": float(per_seed.std())}

    # ---- fit -------------------------------------------------------------

    def _build_epoch(self, epoch: int):
        """One epoch for all seeds: ``[K, S, D, Bf]`` index stacks on the
        device (K the shortest member's steps) and its firm-month count.
        Thread-safe for an explicit epoch (the pipeline's prefetch thread
        builds here)."""
        with telemetry.span("sample", epoch=epoch):
            per_seed = [s.stacked_epoch(epoch) for s in self.samplers]
            k = min(b.firm_idx.shape[0] for b in per_seed)
            fi, ti, w = (np.stack([getattr(b, f)[:k] for b in per_seed],
                                  axis=1)
                         for f in ("firm_idx", "time_idx", "weight"))
        with telemetry.span("h2d", epoch=epoch):
            staged = stage(self.device, fi, ti, w)
        return staged, float(w.sum()) * self.window

    def _epoch_parts(self, epoch: int):
        """The pipeline's epoch: ``[(lookback, (fi, ti, w))]``, one part
        per geometry bucket (the one max-shape part without buckets), and
        its firm-month count."""
        if self._bucketed:
            return self._build_bucketed_epoch(epoch)
        arrays, fm = self._build_epoch(epoch)
        return [(self.window, arrays)], fm

    def _build_bucketed_epoch(self, epoch: int):
        """The bucketed twin of :meth:`_build_epoch` (``LFM_BUCKETS``):
        per (lookback × width) bucket a ``[K_b, S, D, width]`` stack from
        the per-seed samplers. The geometry is seed-invariant, so every
        member has the same buckets; only the shuffles differ."""
        with telemetry.span("sample", epoch=epoch):
            per_seed = [s.bucketed_epoch(epoch) for s in self.samplers]
            keys = [k for k, _ in per_seed[0]]
            if any([k for k, _ in ps] != keys for ps in per_seed):
                raise RuntimeError("per-seed bucket geometry diverged")
            parts = [((lb, w), WindowIndex(*(
                np.stack([getattr(ps[i][1], f) for ps in per_seed], axis=1)
                for f in ("firm_idx", "time_idx", "weight"))))
                for i, (lb, w) in enumerate(keys)]
            fm = count_bucket_cells(parts, self.samplers[0].firms_per_date,
                                    self.window)
        with telemetry.span("h2d", epoch=epoch):
            staged = [(lb, stage(self.device, b.firm_idx, b.time_idx,
                                 b.weight)) for (lb, _), b in parts]
        return staged, fm

    def _val_sweep(self):
        """The epoch's per-seed validation ICs ``[S, M]`` as a callable of
        the params, its batches hoisted onto the device once, and the
        months' pool sizes. Under ``LFM_BUCKETS`` one sweep per bucket,
        the ICs scattered back to the stacked month order."""
        if not self._bucketed:
            vb = self.val_sampler.stacked_cross_sections()
            vargs = self._batch(vb)
            return (lambda params: self._eval_ic(params, *vargs),
                    vb.weight.sum(axis=1))
        parts = self.val_sampler.bucketed_cross_sections()
        n_val = sum(pos.size for _, _, pos in parts)
        counts = np.zeros(n_val, np.float32)
        hoist = []
        for (lb, _), b, pos in parts:
            counts[pos] = b.weight.sum(axis=1)
            hoist.append((lb, self._batch(b),
                          torch.as_tensor(pos).to(self.device)))

        def sweep(params):
            ic = torch.zeros((self.n_seeds, n_val), dtype=torch.float32,
                             device=self.device)
            for lb, vargs, pos in hoist:
                ic[:, pos] = self._eval_ic(params, *vargs, window=lb)
            return ic

        return sweep, counts

    def _adopt(self, state: TrainState) -> TrainState:
        """A state cloned off the live one (the pipeline's rollback
        target) copied back into the stacked model's parameters."""
        live = flax_param_map(self.model)
        with torch.no_grad():
            for k, p in live.items():
                p.copy_(state.params[k])
        return state._replace(params=live)

    def fit(self, resume: bool = False,
            init_params: Optional[Mapping[str, Any]] = None
            ) -> Dict[str, Any]:
        """Ensemble training with early stopping on the ensemble-mean
        validation IC, through the epoch pipeline of the JAX
        ``_fit_impl`` (``train/pipeline.py``). ``resume=True`` continues
        from ``ckpt/latest``; ``init_params`` (a seed-stacked Flax tree,
        or another ensemble's ``state.params``: the walk-forward warm
        start) replaces the seeded init through ``graft_params``, the
        optimizer starting fresh. Restores the best state at the end; a
        SIGTERM raises ``Preempted`` with the recorded epochs durable.
        Returns the summary and ``step_losses`` (``[K]`` lists of the
        per-seed losses, in order). Traced as the ``fit`` span, with the
        epochs' ``sample``, ``h2d`` and ``eval`` spans in it."""
        with telemetry.span("fit", cat="fit", kind="ensemble",
                            n_seeds=self.n_seeds) as sp:
            out = self._fit_impl(resume, init_params)
            sp.set(epochs_run=out["epochs_run"],
                   best_epoch=out["best_epoch"])
            return out

    def _fit_impl(self, resume: bool,
                  init_params: Optional[Mapping[str, Any]]
                  ) -> Dict[str, Any]:
        cfg = self.cfg
        if cfg.optim.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {cfg.optim.epochs}")
        state = self.init_state(None if init_params is None else graft_params(
            flax_param_map(self.model), init_params, rows=self._local))
        harness = FitHarness(self.run_dir, cfg.optim.epochs,
                             cfg.optim.early_stop_patience,
                             self._steps_per_epoch)
        if resume:
            restored = harness.resume()
            if restored is not None:
                state = self.load_state(restored)
        logger = MetricsLogger(self.run_dir, echo=self.echo)
        # Host clock: the epoch's fetch is what waits for the device.
        timer = StepTimer()
        history, step_losses = [], []
        val_sweep, counts = self._val_sweep()

        def dispatch(state, parts):
            losses = []
            for lb, (fi, ti, w) in parts:
                for k in range(fi.shape[0]):
                    state, ms = self.step(state, fi[k], ti[k], w[k], lb)
                    losses.append(ms["loss"])
            ic = val_sweep(state.params)
            loss = all_gather_cat(torch.stack(losses), self.mesh,
                                  SEED_AXIS, dim=1)
            return state, {"loss": loss, "ic": ic,
                           "step": int(state.step[0])}

        def finish(epoch, host, fm):
            loss_h, ic_h = host["loss"].numpy(), host["ic"].numpy()
            per_seed = (ic_h * counts).sum(axis=1) / counts.sum()
            val_ic = float(per_seed.mean())
            rec = logger.log(
                host["step"], epoch=epoch, train_loss=float(loss_h.mean()),
                val_ic=val_ic, val_ic_std=float(per_seed.std()),
                firm_months_per_sec=timer.throughput())
            history.append(rec)
            step_losses.extend(v.tolist() for v in loss_h)
            return host["step"], val_ic

        try:
            state, overrun = pipeline.run_fit_epochs(
                harness, state,
                build=self._epoch_parts,
                dispatch=dispatch, finish=finish, timer=timer,
                checkpointing=self.run_dir is not None,
                snapshot=self._snapshot)
            if overrun is not None:
                state = self._adopt(state)
            best = harness.finalize()
        finally:
            logger.close()
        if best is not None:
            state = self.load_state(best)
        self.state = state
        return {
            "best_val_ic": harness.best_ic,
            "best_epoch": harness.best_epoch,
            "epochs_run": harness.last_epoch + 1,
            "n_seeds": self.n_seeds,
            "steps": (harness.last_epoch + 1) * harness.steps_per_epoch,
            "firm_months_per_sec": timer.throughput(),
            "lookahead_overrun": overrun is not None,
            "history": history,
            "step_losses": step_losses,
        }

    # ---- inference -------------------------------------------------------

    def _stacked_forward(self, b: WindowIndex, variance: bool = False,
                         window: Optional[int] = None):
        """Every member's forecasts ``[S, M, bf]`` (f32, on the device)
        of an ``[M, bf]`` batch (``window``: a geometry bucket's
        lookback), this rank's members over its block of months,
        gathered; ``variance``: ``(means, exp(log_var))``, each ``[S, M,
        bf]``, of heteroscedastic members (a point head raises
        ``ValueError``)."""
        fi, ti, _ = self._batch(b)
        M = fi.shape[0]
        rows = self._month_rows(M)
        fi, ti = fi[rows], ti[rows]
        Mr = fi.shape[0]
        C = min(self.cfg.data.dates_per_batch, Mr)
        shape = (self.n_local, Mr + (-Mr) % C, fi.shape[1])
        pred = torch.empty(shape, dtype=torch.float32, device=self.device)
        var = torch.empty_like(pred) if variance else None
        for months, seeds, o in self._forward_chunks(
                self.state.params, fi, ti, window=window):
            if variance:
                if not isinstance(o, tuple):
                    raise ValueError(
                        "variance=True needs a heteroscedastic head "
                        "(ModelConfig.heteroscedastic / loss='nll')")
                var[seeds, months] = torch.exp(o[1].float())
            pred[seeds, months] = _point_forecast(o).float()
        pred = self._gather_sweep(pred[:, :Mr], M)
        if variance:
            return pred, self._gather_sweep(var[:, :Mr], M)
        return pred

    @torch.inference_mode()
    def predict(self, split: str = "test",
                date_range: Optional[Tuple[int, int]] = None,
                return_variance: bool = False, require_target: bool = True
                ) -> Tuple[np.ndarray, ...]:
        """Stacked forecasts ``[S, N, T]`` and their shared validity ``[N,
        T]`` over the split's anchor range (or an explicit month-index
        ``date_range``: a walk-forward fold's window), on the host, for the
        backtest's ensemble aggregation: the max-shape sweep (under
        ``LFM_BUCKETS`` one sweep per bucket, the same forecasts), chunked
        as the validation sweep is, on the model's gather (the kernel on
        the card). ``require_target=False`` includes LIVE anchors (no
        observable outcome yet: the forecast entry point).
        ``return_variance=True`` (heteroscedastic members) returns
        ``(forecasts, aleatoric variances [S, N, T], valid)``, the input
        of ``mean_minus_total_std``, from the max-shape sweep."""
        sampler = predict_sampler(self.cfg, self.splits, split, date_range,
                                  require_target)
        self.model.eval()
        if self._bucketed and not return_variance:
            return scatter_bucketed(
                [(b, self._stacked_forward(b, window=lb).cpu().numpy())
                 for (lb, _), b, _ in sampler.bucketed_cross_sections()],
                self.panel)
        b = sampler.stacked_cross_sections()
        if return_variance:
            pred, var = self._stacked_forward(b, variance=True)
            (fc, avar), valid = scatter_forecasts(
                b, torch.stack([pred, var]).cpu().numpy(), self.panel)
            return fc, avar, valid
        return scatter_forecasts(b, self._stacked_forward(b).cpu().numpy(),
                                 self.panel)


def run_ensemble_experiment(cfg: RunConfig, panel: Optional[Panel] = None,
                            echo: bool = False, resume: bool = False,
                            device: Optional[Union[str, torch.device]] = None
                            ) -> Tuple[Dict[str, Any], EnsembleTrainer,
                                       PanelSplits]:
    """Config → panel → splits → ensemble training; writes
    ``config.json``, ``ensemble.flag`` and ``summary.json`` into
    ``<out_dir>/<name>/ensemble``. Returns (summary, trainer, splits)."""
    splits = splits_for(cfg, panel)
    run_dir = os.path.join(cfg.out_dir, cfg.name, "ensemble")
    trainer = EnsembleTrainer(cfg, splits, run_dir=run_dir, echo=echo,
                              device=device)
    summary = trainer.fit(resume=resume)
    summary["run_dir"] = run_dir
    summary["config"] = dataclasses.asdict(cfg)
    summary["mesh"] = mesh_fingerprint(trainer.mesh)
    write_ensemble_run_dir(run_dir, trainer, summary)
    return summary, trainer, splits


def write_ensemble_run_dir(run_dir: str, trainer: EnsembleTrainer,
                           summary: Optional[Mapping[str, Any]] = None
                           ) -> None:
    """The run dir that :func:`load_ensemble` and ``load_forecaster`` read:
    ``config.json``, ``ensemble.flag`` and ``summary.json`` (when given)
    beside the fit's checkpoints. A trainer fit without this run dir gets
    its trained state written as ``ckpt/best``. In a process group every
    rank calls it (the state is gathered) and rank 0 writes."""
    if dist_utils.is_main():
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.json"), "w") as fh:
            fh.write(trainer.cfg.to_json())
        mark_ensemble_run_dir(run_dir, True)
        if summary is not None:
            with open(os.path.join(run_dir, "summary.json"), "w") as fh:
                json.dump({k: v for k, v in summary.items()
                           if k not in ("history", "step_losses")}, fh,
                          indent=2, default=str)
    if trainer.run_dir != run_dir:
        CheckpointManager(os.path.join(run_dir, "ckpt", "best"),
                          max_to_keep=1).save(
            int(trainer.state.step[0]), trainer.state_dict(trainer.state),
            wait=True)
    dist_utils.barrier()


def load_ensemble(run_dir: str, panel: Optional[Panel] = None,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Tuple[EnsembleTrainer, PanelSplits]:
    """An :class:`EnsembleTrainer` rebuilt from a run dir, its best stacked
    checkpoint restored."""
    with open(os.path.join(run_dir, "config.json")) as fh:
        cfg = RunConfig.from_json(fh.read())
    splits = splits_for(cfg, panel)
    trainer = EnsembleTrainer(cfg, splits, run_dir=run_dir, device=device)
    trainer.init_state()
    restored = CheckpointManager(os.path.join(run_dir, "ckpt",
                                              "best")).restore()
    trainer.state = trainer.load_state(restored)
    return trainer, splits
