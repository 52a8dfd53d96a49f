"""Training loop and scoring forward: the port of
``lfm_quant_tpu/train/loop.py`` for one model, on one device or
date-sharded over one process per device.

* :class:`Predictor` holds what the forward reads: the model and its
  params, the device-resident packed panel, the window gather and the
  date chunking by ``dates_per_batch``. Serving and the trainer's
  validation sweep both run through it.
* :class:`Trainer` adds the samplers, the loss, the optimizer
  (``train/optim.py``) and the epoch loop: each step gathers its windows
  on the device, runs the model on ``[D*Bf, W, F]``, takes the loss in the
  ``[D, Bf]`` month layout and applies one optimizer update; each epoch
  ends with a validation sweep (per-month Spearman IC and the MSE), early
  stopping on the IC, and the ``ckpt/latest`` and ``ckpt/best`` lines
  (:class:`FitHarness`). :meth:`Trainer.predict` forecasts a split (or a
  month range, live months included) over the whole panel, and
  :func:`load_trainer` rebuilds a trainer from its run dir for the
  backtest and forecast entry points.

Data and sequence parallelism (``parallel/mesh.py``): in a process group
the trainer binds a mesh of ``n_data_shards`` date shards and
``n_seq_shards`` window shards (resolved against the world size, seq
innermost, one rank per shard). Every rank draws the same global batch
and takes its block of dates; under a seq axis each seq rank gathers only
its sub-window (``time_idx - (W - (s+1)·Wl)`` at window ``Wl = W /
n_seq``) and runs the window-sharded train model (``seq_axis``: ring
attention, the distributed LRU scan) inside ``bind_seq_axis``. The loss
numerator and denominator are summed over the date shards (every seq rank
of a date shard holds the same loss), the gradients over the date and
seq shards together, so the loss, the gradients and ``grad_norm`` equal
the one-process values (the JAX trainer's sharded gradients are a
multiple of those: ROADMAP.md Queue C). The validation sweep and
``predict`` run the full-window model, give each rank (date and seq
shards alike) a block of months and gather the results, so every rank
takes the same early-stop decisions. Rank 0 alone writes the run dir,
followed by a barrier; every rank reads it on resume.

Dropout (the MLP's and the transformer's ``dropout`` kwarg) is live in
the train step only. The state carries a constant base seed (``cfg.seed``);
each step's generator is derived from (base seed, step), and from the
rank too when the dates are sharded, so a resume from ``ckpt/latest``
replays the stream. The sweep, ``predict`` and serving run without it;
``predict(mc_samples=K)`` is MC-dropout sampling, the forward under K
seeded draws (:meth:`Predictor.mc_scores`).

The loop is lock-step, the JAX package's ``LFM_ASYNC=0`` path: no geometry
buckets, no async prefetch or checkpointing (ROADMAP.md Queue A). The
train step and ``predict`` take ``gather_impl`` (the kernel for "auto" and
"pallas"); the validation sweep resolves as the JAX trainer's does, the
plain gather unless ``gather_impl="pallas"`` is set explicitly
(``loop.py:1045-1047``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import (Any, Callable, Dict, Iterator, Mapping, NamedTuple,
                    Optional, Tuple, Union)

import numpy as np
import torch
from torch.func import functional_call

from lfm_quant_tpu_torch.config import RunConfig, compute_dtype, model_kwargs
from lfm_quant_tpu_torch.data.panel import (
    Panel,
    PanelSplits,
    load_panel,
    synthetic_panel,
)
from lfm_quant_tpu_torch.data.windows import (
    DateBatchSampler,
    WindowIndex,
    device_panel,
    gather_targets,
    gather_windows_packed,
    resolve_gather_impl,
)
from lfm_quant_tpu_torch.device import resolve_device
from lfm_quant_tpu_torch.models import build_model
from lfm_quant_tpu_torch.ops.gather import gather_windows
from lfm_quant_tpu_torch.ops.losses import finalize_loss, make_loss_parts
from lfm_quant_tpu_torch.ops.metrics import spearman_ic
from lfm_quant_tpu_torch.parallel import ring
from lfm_quant_tpu_torch.parallel.mesh import (
    BATCH,
    DataMesh,
    all_gather_dates,
    all_reduce_flat,
    all_reduce_sum,
    data_mesh,
    mesh_fingerprint,
    month_block,
    shard_dates,
)
from lfm_quant_tpu_torch.train.checkpoint import CheckpointManager
from lfm_quant_tpu_torch.train.forecast import mark_ensemble_run_dir
from lfm_quant_tpu_torch.train.optim import AdamWState, make_optimizer
from lfm_quant_tpu_torch.utils import distributed as dist_utils
from lfm_quant_tpu_torch.utils import faults
from lfm_quant_tpu_torch.utils.logging import MetricsLogger, StepTimer
from lfm_quant_tpu_torch.weights import (
    flatten_params,
    flax_param_map,
    load_flax_params,
)
from lfm_quant_tpu_torch.weights import init_params as seeded_init

#: ``rebind`` sentinel: "keep the previous run_dir" (an explicit None
#: drops it: a fold that must not checkpoint).
_KEEP = object()

#: Domain tags of the derived generator seeds: a train step's dropout and
#: an MC-dropout sample never share a stream.
DROPOUT_STREAM, MC_STREAM = 0x4C464D44, 0x4C464D43


def derive_seed(*words: int) -> int:
    """A 63-bit seed mixed from integers (``numpy.random.SeedSequence``,
    led by their count: it ignores trailing zeros): (stream tag, base
    seed, step[, rank]) for a train step's dropout, (tag, mc_seed,
    sample, chunk) for an MC-dropout sample."""
    state = np.random.SeedSequence(
        [len(words)] + [int(w) for w in words]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def has_dropout(cfg: RunConfig) -> bool:
    """Whether the config's model draws dropout masks in training."""
    return float(cfg.model.kwargs.get("dropout") or 0.0) > 0.0


def _point_forecast(out):
    """Point forecast from either head type (mean for heteroscedastic)."""
    return out[0] if isinstance(out, tuple) else out


def graft_params(params: Mapping[str, torch.Tensor], init_params,
                 rows: Optional[Callable] = None) -> Dict[str, np.ndarray]:
    """``init_params`` (a Flax tree, nested or flat, of arrays or tensors
    on any device) held to a trainer's ``params`` (Flax path → tensor)
    and copied to the host: the walk-forward warm start's weights. Only
    the weights carry over; the optimizer restarts from zero moments
    (``init_state``). ``rows`` maps each leaf first (a seed-sharded
    ensemble's block of an all-seed tree). A tree of other paths or
    shapes raises a ``ValueError`` that says so, instead of failing deep
    in a copy."""

    def host(tree):
        if isinstance(tree, Mapping):
            return {k: host(v) for k, v in tree.items()}
        if torch.is_tensor(tree):
            return tree.detach().to("cpu", torch.float32).numpy().copy()
        return np.array(tree, np.float32)

    flat = flatten_params(host(init_params))
    if "params" in {k.split("/")[0] for k in flat}:
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    if rows is not None:
        flat = {k: rows(v) for k, v in flat.items()}
    want = {k: tuple(p.shape) for k, p in params.items()}
    got = {k: tuple(v.shape) for k, v in flat.items()}
    if want != got:
        raise ValueError(
            "init_params does not match this trainer's parameter tree/"
            "shapes — warm starts require the same model config across "
            f"folds (expected {want}, got {got})")
    return flat


def resolve_panel(d) -> Panel:
    """DataConfig → Panel: a panel saved by ``Panel.save`` or the
    synthetic generator. CSV panels and derived features come with a
    later slice (ROADMAP.md Queue A)."""
    if d.derived_features:
        raise NotImplementedError(
            "derived_features are not ported yet (ROADMAP.md Queue A)")
    if d.panel_path:
        if d.panel_path.endswith((".csv", ".parquet", ".pq")):
            raise NotImplementedError(
                "Compustat CSV/parquet panels are not ported yet "
                "(ROADMAP.md Queue A)")
        return load_panel(d.panel_path)
    return synthetic_panel(
        n_firms=d.n_firms, n_months=d.n_months, n_features=d.n_features,
        start_yyyymm=d.start_yyyymm, horizon=d.horizon, seed=d.panel_seed,
        het_noise=d.het_noise)


class Predictor:
    """A model with its params over one device-resident panel.

    ``params``: a Flax param tree (numpy arrays; see ``weights.py``), or
    None for a fresh seeded init from ``cfg.seed``. ``device``: None means
    ``cuda``; ``"cpu"`` runs every kernel's plain version.
    """

    def __init__(self, cfg: RunConfig, panel: Panel,
                 params: Optional[Mapping[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.panel = panel
        self.device = resolve_device(device)
        self.window = cfg.data.window
        self.fp = panel.n_features + 1  # logical packed width
        self.gather_impl = resolve_gather_impl(cfg.data.gather_impl)
        kind, kwargs = model_kwargs(cfg)
        model = build_model(kind, n_features=panel.n_features, **kwargs)
        if params is None:
            seeded_init(model, torch.Generator().manual_seed(cfg.seed))
        else:
            load_flax_params(model, params)
        self.model = model.to(self.device).eval()
        faults.check("panel_h2d", n_firms=panel.n_firms,
                     n_months=panel.n_months)
        self.dev = device_panel(panel, self.device, compute_dtype(cfg))
        #: The data mesh the sweeps shard months over (a trainer binds
        #: its own; serving runs on one device).
        self.mesh = DataMesh()

    def _gather(self, firm_idx: torch.Tensor, time_idx: torch.Tensor,
                impl: Optional[str] = None, window: Optional[int] = None):
        """The windows of an index batch (``window`` overrides the
        lookback: a seq rank's sub-window)."""
        gather = (gather_windows if (impl or self.gather_impl) == "kernel"
                  else gather_windows_packed)
        return gather(self.dev["xm"], firm_idx, time_idx,
                      window or self.window, fp=self.fp)

    @staticmethod
    def _key(cfg: RunConfig):
        """What the model and the device panel are built from (besides
        the panel itself)."""
        return (cfg.model, compute_dtype(cfg), cfg.data.window,
                cfg.data.gather_impl)

    def _apply(self, x: torch.Tensor, m: torch.Tensor,
               rng: Optional[torch.Generator] = None,
               model: Optional[torch.nn.Module] = None):
        """Flatten the [D, Bf] batch dims → one model batch, reapply;
        ``rng`` turns dropout on; ``model`` (the window-sharded train
        model) runs on this model's params."""
        lead = x.shape[:-2]
        args = (x.reshape((-1,) + x.shape[-2:]),
                m.reshape((-1,) + m.shape[-1:]))
        if model is None:
            out = self.model(*args, rng=rng)
        else:
            out = functional_call(model, dict(self.model.named_parameters()),
                                  args, {"rng": rng})
        if isinstance(out, tuple):
            return tuple(o.reshape(lead) for o in out)
        return out.reshape(lead)

    def _chunk_windows(self, fi: torch.Tensor, ti: torch.Tensor,
                       impl: Optional[str] = None
                       ) -> Iterator[Tuple[slice, torch.Tensor,
                                           torch.Tensor]]:
        """The windows of an ``[M, Bf]`` index batch on the device,
        chunked over months by ``dates_per_batch`` with the last chunk
        padded by repeating months, as the JAX eval forward does. Yields
        ``(rows of the padded batch, x, m)`` per chunk."""
        M = fi.shape[0]
        C = min(self.cfg.data.dates_per_batch, M)
        pad = (-M) % C
        if pad:
            fi = torch.cat([fi, fi[:pad]], dim=0)
            ti = torch.cat([ti, ti[:pad]], dim=0)
        for k in range(0, fi.shape[0], C):
            yield (slice(k, k + C),) + self._gather(fi[k:k + C],
                                                    ti[k:k + C], impl)

    def _forward_chunks(self, fi: torch.Tensor, ti: torch.Tensor,
                        impl: Optional[str] = None
                        ) -> Iterator[Tuple[slice, Any]]:
        """The forward over :meth:`_chunk_windows`: ``(rows of the padded
        batch, model output)`` per chunk."""
        for rows, x, m in self._chunk_windows(fi, ti, impl):
            yield rows, self._apply(x, m)

    def _month_rows(self, M: int) -> Tuple[torch.Tensor, int]:
        """This rank's rows of an ``M``-month sweep (``month_block``), on
        the device, and how many of them are real months."""
        rows, n_real = month_block(M, self.cfg.data.dates_per_batch,
                                   self.mesh)
        return rows.to(self.device), n_real

    @torch.inference_mode()
    def predict_scores(self, firm_idx: np.ndarray, time_idx: np.ndarray
                       ) -> torch.Tensor:
        """Point forecasts ``[M, Bf]`` (f32, on the device) for an
        ``[M, Bf]`` index batch (the scores-only forward); under a data
        mesh each rank forecasts its block of months and every rank
        returns all of them (the months are split over the date and seq
        shards alike)."""
        fi = torch.as_tensor(np.asarray(firm_idx, np.int32)).to(self.device)
        ti = torch.as_tensor(np.asarray(time_idx, np.int32)).to(self.device)
        M = fi.shape[0]
        if self.mesh.n_batch > 1:
            rows, _ = self._month_rows(M)
            fi, ti = fi[rows], ti[rows]
        preds = [_point_forecast(out)
                 for _, out in self._forward_chunks(fi, ti)]
        return all_gather_dates(torch.cat(preds, dim=0), self.mesh)[:M]

    @torch.inference_mode()
    def mc_scores(self, firm_idx: np.ndarray, time_idx: np.ndarray,
                  samples: int, seed: int = 0, batched: bool = True
                  ) -> torch.Tensor:
        """MC-dropout forecasts ``[K, M, Bf]`` (f32, on the device) for an
        ``[M, Bf]`` index batch: the forward with dropout live, sample k of
        month chunk c drawing from the generator of (``seed``, k, c).
        ``batched`` gathers each chunk once for all K samples; the loop
        (``batched=False``) runs the whole sweep per sample and draws the
        same samples. Every rank forecasts every month."""
        fi = torch.as_tensor(np.asarray(firm_idx, np.int32)).to(self.device)
        ti = torch.as_tensor(np.asarray(time_idx, np.int32)).to(self.device)

        def sample(k, c, x, m):
            g = generator(derive_seed(MC_STREAM, seed, k, c), self.device)
            return _point_forecast(self._apply(x, m, g)).float()

        if batched:
            per = [[] for _ in range(samples)]
            for c, (_, x, m) in enumerate(self._chunk_windows(fi, ti)):
                for k in range(samples):
                    per[k].append(sample(k, c, x, m))
        else:
            per = [[sample(k, c, x, m) for c, (_, x, m) in
                    enumerate(self._chunk_windows(fi, ti))]
                   for k in range(samples)]
        return torch.stack([torch.cat(p) for p in per])[:, :fi.shape[0]]

    def score_device(self, firm_idx: np.ndarray, time_idx: np.ndarray,
                     weight: np.ndarray) -> torch.Tensor:
        """Served scores: forecasts as f32 with weight-0 slots zeroed
        (the JAX package's ``ServePrograms.score``), on the device; the
        caller takes the one device→host copy."""
        pred = self.predict_scores(firm_idx, time_idx).float()
        w = torch.as_tensor(np.asarray(weight, np.float32)).to(pred.device)
        return torch.where(w > 0, pred, torch.zeros_like(pred))

    def score(self, firm_idx: np.ndarray, time_idx: np.ndarray,
              weight: np.ndarray) -> np.ndarray:
        """:meth:`score_device`, on the host."""
        return self.score_device(firm_idx, time_idx, weight).cpu().numpy()


# ---------------------------------------------------------------------------
# Fit scaffolding
# ---------------------------------------------------------------------------


class TrainState(NamedTuple):
    """``params``: the model's parameters by Flax path (live tensors, the
    optimizer updates them in place); ``opt_state``: Adam's moments and
    count; ``step``: optimizer steps taken; ``rng``: the dropout base
    seed, constant through training (the JAX state's raw key): each
    step's generator is derived from it and the step, so a resume replays
    the stream. The seed ensemble keeps ``[S]`` of each of the last two."""

    params: Dict[str, torch.Tensor]
    opt_state: AdamWState
    step: Any
    rng: Any


def load_progress(run_dir: str) -> Dict[str, Any]:
    """Read the fit-progress sidecar used for crash resume."""
    with open(os.path.join(run_dir, "fit_progress.json")) as fh:
        return json.load(fh)


def save_progress(run_dir: Optional[str], **kw) -> None:
    """Atomic write of the progress sidecar (by rank 0 alone)."""
    if run_dir and dist_utils.is_main():
        path = os.path.join(run_dir, "fit_progress.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(kw, fh)
        os.replace(tmp, path)


class FitHarness:
    """Fit scaffolding: the two checkpoint lines (``ckpt/latest`` every
    epoch for resume, ``ckpt/best`` on val-IC improvement for the final
    model), the progress sidecar, early stopping and resume. Saves are
    synchronous, so both lines are durable before the sidecar names
    them."""

    def __init__(self, run_dir: Optional[str], epochs: int, patience: int,
                 steps_per_epoch: int):
        self.run_dir = run_dir
        self.epochs = epochs
        self.patience = patience
        self.steps_per_epoch = max(1, steps_per_epoch)
        self.latest_mgr = self.best_mgr = None
        if run_dir:
            self.latest_mgr = CheckpointManager(
                os.path.join(run_dir, "ckpt", "latest"), max_to_keep=2)
            self.best_mgr = CheckpointManager(
                os.path.join(run_dir, "ckpt", "best"), max_to_keep=1)
        self.best_ic, self.best_epoch, self.bad_epochs = -np.inf, -1, 0
        self.start_epoch = 0
        self._epoch = -1

    def resume(self) -> Optional[Dict[str, Any]]:
        """Restore the latest checkpoint and the loop counters; None when
        nothing is checkpointed. A sidecar out of step with the committed
        lines falls back to counters derived from the latest step and the
        committed best (see the JAX ``FitHarness.resume``)."""
        if not self.latest_mgr:
            return None
        step = self.latest_mgr.latest_step()
        if step is None:
            return None
        restored = self.latest_mgr.restore(step)
        try:
            prog = load_progress(self.run_dir)
            if (prog["epoch"] + 1) * self.steps_per_epoch != int(step):
                raise KeyError("progress sidecar out of step with latest")
            self.start_epoch = prog["epoch"] + 1
            claimed = ((prog["best_epoch"] + 1) * self.steps_per_epoch
                       if prog["best_epoch"] >= 0 else None)
            durable = self.best_mgr.latest_step()
            if claimed is not None and (durable is None or durable < claimed):
                raise KeyError("progress sidecar ahead of best line")
            self.best_ic = prog["best_ic"]
            self.best_epoch = prog["best_epoch"]
            self.bad_epochs = prog["bad_epochs"]
        except (FileNotFoundError, json.JSONDecodeError, KeyError,
                TypeError):
            self.start_epoch = int(step) // self.steps_per_epoch
            self._recover_best()
        self._epoch = self.start_epoch - 1
        return restored

    def _recover_best(self) -> None:
        """Best-line counters from durable evidence only: the committed
        best step and its val IC in ``metrics.jsonl``."""
        self.best_ic, self.best_epoch, self.bad_epochs = -np.inf, -1, 0
        durable = self.best_mgr.latest_step() if self.best_mgr else None
        if durable is None:
            return
        best_epoch = int(durable) // self.steps_per_epoch - 1
        best_ic = -np.inf
        try:
            with open(os.path.join(self.run_dir, "metrics.jsonl")) as fh:
                for line in fh:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if rec.get("epoch") == best_epoch and "val_ic" in rec:
                        best_ic = float(rec["val_ic"])
        except (OSError, ValueError):
            pass
        self.best_ic, self.best_epoch = best_ic, best_epoch
        self.bad_epochs = max(0, self.start_epoch - 1 - best_epoch)

    def next_epoch(self) -> Optional[int]:
        """The next epoch to train, or None when done (a resumed run that
        had already stopped early does not restart)."""
        nxt = (self._epoch + 1 if self._epoch >= self.start_epoch - 1
               else self.start_epoch)
        if nxt >= self.epochs or self.bad_epochs >= self.patience:
            return None
        self._epoch = nxt
        return nxt

    @property
    def last_epoch(self) -> int:
        return max(self._epoch, self.start_epoch - 1)

    def end_epoch(self, epoch: int, step: int,
                  state_dict: Optional[Dict[str, Any]],
                  val_ic: float) -> bool:
        """Record an epoch: update the best, save both lines, then the
        sidecar. Returns True when early stopping triggers."""
        if val_ic > self.best_ic:
            self.best_ic, self.best_epoch, self.bad_epochs = val_ic, epoch, 0
            if self.best_mgr:
                self.best_mgr.save(step, state_dict)
        else:
            self.bad_epochs += 1
        if self.latest_mgr:
            self.latest_mgr.save(step, state_dict)
            save_progress(self.run_dir, epoch=epoch,
                          best_ic=float(self.best_ic),
                          best_epoch=self.best_epoch,
                          bad_epochs=self.bad_epochs)
            # Rank 0 wrote both lines; the others may read them next.
            dist_utils.barrier()
        return self.bad_epochs >= self.patience

    def finalize(self) -> Optional[Dict[str, Any]]:
        """The best checkpoint's state, if one was committed."""
        if (self.best_mgr and self.best_epoch >= 0
                and self.best_mgr.latest_step() is not None):
            return self.best_mgr.restore()
        return None


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


class Trainer(Predictor):
    """Single-model trainer: fit on ``splits`` train, early-stop on val.

    ``device``: None means ``cuda`` (the kernels); ``"cpu"`` runs every
    kernel's plain version. ``run_dir`` None trains without checkpoints
    or a metrics file. In a process group every rank constructs its own
    trainer on its own device (see the module docstring).
    """

    def __init__(self, cfg: RunConfig, splits: PanelSplits,
                 run_dir: Optional[str] = None, echo: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(cfg, splits.panel, device=device)
        self._bind(cfg, splits, run_dir, echo)

    def rebind(self, cfg: Optional[RunConfig] = None,
               splits: Optional[PanelSplits] = None, run_dir: Any = _KEEP,
               echo: Optional[bool] = None) -> "Trainer":
        """Re-initialize for the next walk-forward fold: new split
        boundaries, samplers seeded from the new config, a new run dir,
        the state dropped. An omitted argument keeps the previous value;
        ``run_dir=None`` drops the run dir. The model and the device panel
        are kept while the panel and the model's config are unchanged,
        else rebuilt as a fresh construction would. (The JAX trainer's
        rebind also keeps its compiled programs; the port has no program
        cache, so there is nothing more to keep.) Returns self."""
        cfg = self.cfg if cfg is None else cfg
        splits = self.splits if splits is None else splits
        if splits.panel is not self.panel or self._key(cfg) != self._key(
                self.cfg):
            Predictor.__init__(self, cfg, splits.panel, device=self.device)
        self._bind(cfg, splits, self.run_dir if run_dir is _KEEP else run_dir,
                   self.echo if echo is None else echo)
        return self

    def _bind(self, cfg: RunConfig, splits: PanelSplits,
              run_dir: Optional[str], echo: bool) -> None:
        """The fit's mesh, splits, samplers, loss and optimizer; under a
        live seq axis, the window-sharded train model."""
        d = cfg.data
        self.mesh = data_mesh(cfg.n_data_shards,
                              n_seq_shards=check_seq(cfg))
        if d.dates_per_batch % self.mesh.n_data:
            raise ValueError(
                f"dates_per_batch={d.dates_per_batch} must be divisible by "
                f"n_data_shards={self.mesh.n_data}")
        self.train_model = seq_model(cfg, self.mesh, self.panel.n_features,
                                     self.device)
        self.cfg = cfg
        self.splits = splits
        self.run_dir = run_dir
        self.echo = echo
        self.state: Optional[TrainState] = None
        self.train_sampler = DateBatchSampler(
            splits.panel, d.window, d.dates_per_batch, d.firms_per_date,
            seed=cfg.seed, min_valid_months=d.min_valid_months,
            date_range=splits.train_range, engine=d.sampler_engine)
        self.val_sampler = DateBatchSampler(
            splits.panel, d.window, 1, d.firms_per_date, seed=cfg.seed,
            min_valid_months=d.min_valid_months, min_cross_section=1,
            date_range=splits.val_range)
        # The eval sweep takes the kernel only when asked by name.
        self.eval_gather_impl = ("kernel" if d.gather_impl == "pallas"
                                 else "plain")
        self.loss_parts = make_loss_parts(cfg.optim.loss)
        self._needs_rng = has_dropout(cfg)
        self._steps_per_epoch = self.train_sampler.batches_per_epoch()
        self.opt = make_optimizer(cfg.optim,
                                  self._steps_per_epoch * cfg.optim.epochs)

    # ---- state -----------------------------------------------------------

    def init_state(self, params: Optional[Mapping[str, Any]] = None
                   ) -> TrainState:
        """Fresh params (the seeded init drawn on the CPU, or a Flax
        tree), fresh optimizer state, step 0, the dropout base seed
        ``cfg.seed``."""
        if params is None:
            kind, kw = model_kwargs(self.cfg)
            fresh = build_model(kind, n_features=self.panel.n_features, **kw)
            seeded_init(fresh, torch.Generator().manual_seed(self.cfg.seed))
            params = {k: p.detach().numpy()
                      for k, p in flax_param_map(fresh).items()}
        load_flax_params(self.model, params)
        live = flax_param_map(self.model)
        return TrainState(live, self.opt.init(
            {k: p.detach() for k, p in live.items()}), 0, self.cfg.seed)

    @staticmethod
    def state_dict(state: TrainState) -> Dict[str, Any]:
        """A host copy of the state for a checkpoint."""
        cpu = (lambda t: t.detach().to("cpu", copy=True))
        o = state.opt_state
        return {"params": {k: cpu(p) for k, p in state.params.items()},
                "opt_state": {"count": o.count,
                              "mu": {k: cpu(v) for k, v in o.mu.items()},
                              "nu": {k: cpu(v) for k, v in o.nu.items()}},
                "step": state.step, "rng": state.rng}

    def load_state(self, saved: Mapping[str, Any]) -> TrainState:
        """Copy a checkpointed state into the model and the device."""
        params = flax_param_map(self.model)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved["params"][k])
        o = saved["opt_state"]
        to = (lambda d: {k: v.to(self.device) for k, v in d.items()})
        return TrainState(params, AdamWState(int(o["count"]), to(o["mu"]),
                                             to(o["nu"])),
                          int(saved["step"]), int(saved.get("rng",
                                                            self.cfg.seed)))

    # ---- the step --------------------------------------------------------

    def _loss_parts(self, fi: torch.Tensor, ti: torch.Tensor,
                    w: torch.Tensor, rng: Optional[torch.Generator] = None):
        """The loss's ``(num, den)`` on a ``[D, Bf]`` index batch
        (dropout on under ``rng``); under a seq axis on this seq rank's
        sub-window, through the window-sharded model."""
        y = gather_targets(self.dev["targets"], fi, ti)
        if self.train_model is None:
            x, m = self._gather(fi, ti)
            return self.loss_parts(self._apply(x, m, rng), y, w)
        wl, shift = sub_window(self.window, self.mesh)
        x, m = self._gather(fi, ti - shift, window=wl)
        with ring.bind_seq_axis(self.mesh):
            out = self._apply(x, m, rng, model=self.train_model)
        return self.loss_parts(out, y, w)

    def step_generator(self, state: TrainState
                       ) -> Optional[torch.Generator]:
        """The step's dropout generator, derived from the state's base
        seed and step (and this rank's shard when the dates are sharded),
        or None for a model without dropout."""
        if not self._needs_rng:
            return None
        words = [DROPOUT_STREAM, state.rng, state.step]
        if self.mesh.n_data > 1:
            words.append(self.mesh.rank)
        return generator(derive_seed(*words), self.device)

    def _grads(self, state: TrainState, fi: torch.Tensor, ti: torch.Tensor,
               w: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss and its gradients on a global ``[D, Bf]`` index batch:
        this rank's block of dates, ``num`` and ``den`` summed over the
        date shards in one collective, the backward of ``num_local /
        den_global`` (``den`` depends on no parameter), the gradients
        summed over the date and seq shards in one flat buffer. On one
        process: the plain loss and its gradients."""
        fi, ti, w = (shard_dates(a, self.mesh) for a in (fi, ti, w))
        num, den = self._loss_parts(fi, ti, w, self.step_generator(state))
        num_g, den_g = all_reduce_sum(
            torch.stack([num.detach(), den.detach()]), self.mesh)
        keys = list(state.params)
        grads = torch.autograd.grad(num / torch.clamp(den_g, min=1e-12),
                                    [state.params[k] for k in keys])
        grads = all_reduce_flat(grads, self.mesh, BATCH)
        return finalize_loss(num_g, den_g), dict(zip(keys, grads))

    def step(self, state: TrainState, fi: torch.Tensor, ti: torch.Tensor,
             w: torch.Tensor) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One train step on a global ``[D, Bf]`` index batch on the
        device: loss, gradients, one optimizer update. Returns the new
        state and ``{"loss", "grad_norm"}`` as device scalars (no host
        sync), equal on every rank."""
        self.model.train()
        loss, grads = self._grads(state, fi, ti, w)
        gnorm = self.opt.step(state.params, grads, state.opt_state)
        return (state._replace(step=state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    # ---- evaluation ------------------------------------------------------

    @torch.inference_mode()
    def _eval_dispatch(self, fi: torch.Tensor, ti: torch.Tensor,
                       w: torch.Tensor):
        """Per-month Spearman IC ``[M]`` and the MSE over a stacked
        ``[M, bf]`` batch, on the device (the JAX ``_forward_impl``):
        months padded with weight-0 repeats into whole chunks and, under a
        data mesh, one block of them per rank (the JAX ``_forward_eval``);
        the ICs are gathered and the error and weight sums summed across
        the ranks."""
        self.model.eval()
        M = fi.shape[0]
        rows, n_real = self._month_rows(M)
        fi_p, ti_p, w_p = fi[rows], ti[rows], w[rows]
        w_p[n_real:] = 0
        ics, ses, wss = [], [], []
        for sl, out in self._forward_chunks(fi_p, ti_p,
                                            self.eval_gather_impl):
            pred = _point_forecast(out)
            f, t, ww = fi_p[sl], ti_p[sl], w_p[sl]
            y = gather_targets(self.dev["targets"], f, t)
            ics.append(spearman_ic(pred, y, ww))
            ses.append((ww * (pred.float() - y) ** 2).sum(dim=-1))
            wss.append(ww.sum(dim=-1))
        ic = all_gather_dates(torch.cat(ics), self.mesh)[:M]
        se, ws = all_reduce_sum(torch.stack(
            [torch.cat(ses)[:n_real].sum(), torch.cat(wss)[:n_real].sum()]),
            self.mesh, BATCH)
        return ic, se / torch.clamp(ws, min=1e-12)

    def evaluate(self, sampler: Optional[DateBatchSampler] = None
                 ) -> Dict[str, float]:
        """Validation sweep over every eligible month of ``sampler``
        (default the val split) → ``{ic, mse, n_months}``; the IC is the
        per-month IC averaged with weights by pool size."""
        b = (sampler or self.val_sampler).stacked_cross_sections()
        ic, mse = self._eval_dispatch(*self._batch(b))
        counts = b.weight.sum(axis=1)
        return {"ic": float(np.average(ic.cpu().numpy(), weights=counts)),
                "mse": float(mse), "n_months": int(counts.size)}

    def _batch(self, b: WindowIndex):
        return (torch.as_tensor(b.firm_idx).to(self.device),
                torch.as_tensor(b.time_idx).to(self.device),
                torch.as_tensor(b.weight).to(self.device))

    # ---- fit -------------------------------------------------------------

    def fit(self, resume: bool = False,
            init_params: Optional[Mapping[str, Any]] = None
            ) -> Dict[str, Any]:
        """Train with early stopping, in the lock-step form of the JAX
        ``_fit_impl``. ``resume=True`` continues from ``ckpt/latest``;
        ``init_params`` (a Flax tree, or another trainer's
        ``state.params``: the walk-forward warm start) replaces the seeded
        init through :func:`graft_params`, the optimizer starting fresh; a
        crash resume takes precedence. Restores the best state at the end.

        Returns the summary (best val IC and epoch, epochs run, steps,
        firm-months per second, the per-epoch ``history``) and
        ``step_losses``, every step's loss in order."""
        cfg = self.cfg
        if cfg.optim.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {cfg.optim.epochs}")
        state = self.init_state(None if init_params is None else graft_params(
            flax_param_map(self.model), init_params))
        harness = FitHarness(self.run_dir, cfg.optim.epochs,
                             cfg.optim.early_stop_patience,
                             self._steps_per_epoch)
        if resume:
            restored = harness.resume()
            if restored is not None:
                state = self.load_state(restored)
        logger = MetricsLogger(self.run_dir, echo=self.echo)
        timer = StepTimer(self.device)
        history, step_losses = [], []
        vb = self.val_sampler.stacked_cross_sections()
        counts = vb.weight.sum(axis=1)
        vargs = self._batch(vb)
        K = self._steps_per_epoch
        try:
            timer.start()
            epoch = harness.next_epoch()
            while epoch is not None:
                b = self.train_sampler.stacked_epoch(epoch)
                fm = float(b.weight.sum()) * self.window
                fi, ti, w = self._batch(b)
                losses, gnorms = [], []
                for k in range(K):
                    state, ms = self.step(state, fi[k], ti[k], w[k])
                    losses.append(ms["loss"])
                    gnorms.append(ms["grad_norm"])
                ic, mse = self._eval_dispatch(*vargs)
                # One device→host fetch per epoch.
                loss_h, gn_h, ic_h, mse_h = (
                    t.cpu().numpy() for t in (torch.stack(losses),
                                              torch.stack(gnorms), ic, mse))
                timer.stop(firm_months=fm)
                timer.start()
                val_ic = float(np.average(ic_h, weights=counts))
                rec = logger.log(
                    state.step, epoch=epoch,
                    train_loss=float(loss_h.mean()),
                    grad_norm=float(gn_h.mean()), val_ic=val_ic,
                    val_mse=float(mse_h),
                    firm_months_per_sec=timer.throughput())
                history.append(rec)
                step_losses.extend(float(v) for v in loss_h)
                snap = (self.state_dict(state)
                        if self.run_dir and dist_utils.is_main() else None)
                if harness.end_epoch(epoch, state.step, snap, val_ic):
                    break
                epoch = harness.next_epoch()
        finally:
            logger.close()
        best = harness.finalize()
        if best is not None:
            state = self.load_state(best)
        self.state = state
        return {
            "best_val_ic": harness.best_ic,
            "best_epoch": harness.best_epoch,
            "epochs_run": harness.last_epoch + 1,
            "steps": (harness.last_epoch + 1) * harness.steps_per_epoch,
            "firm_months_per_sec": timer.throughput(),
            "history": history,
            "step_losses": step_losses,
        }

    # ---- inference -------------------------------------------------------

    def predict(self, split: str = "test", mc_samples: int = 0,
                mc_seed: int = 0,
                date_range: Optional[Tuple[int, int]] = None,
                return_variance: bool = False, require_target: bool = True,
                mc_batched: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Forecasts for every eligible anchor of a split's months:
        ``(forecast [N, T] float32, valid [N, T] bool)`` over the WHOLE
        panel, valid only inside the range, on the host (the backtest's
        input). The forward is the trained model's on the device (the
        gather and the fused recurrence kernels on the card), chunked over
        months as the validation sweep is.

        ``date_range`` (month indices, end-exclusive) replaces the split's
        range: the walk-forward predicts each fold's window with it.
        ``require_target=False`` also forecasts LIVE anchors, whose
        outcome is not observable yet (the forecast entry point).

        ``mc_samples=K > 0``: MC-dropout sampling (:meth:`mc_scores`),
        ``K`` stacked forecasts ``[K, N, T]`` under the seed ``mc_seed``,
        shaped like ``EnsembleTrainer.predict``'s for the aggregation, and
        the same validity; a model without dropout raises ``ValueError``
        (every sample would be the same). ``mc_batched=False`` runs the
        per-sample loop, which draws the same samples. ``return_variance``
        raises: the heteroscedastic variance forward is not ported
        (ROADMAP.md Queue A item 4)."""
        if mc_samples > 0 and not self._needs_rng:
            raise ValueError(
                "mc_samples > 0 needs a model with dropout > 0 "
                "(ModelConfig.kwargs['dropout']); this run has none, so "
                "every sample would be identical")
        check_predict_options(return_variance)
        b = predict_batch(self.cfg, self.splits, split, date_range,
                          require_target)
        self.model.eval()
        if mc_samples > 0:
            pred = self.mc_scores(b.firm_idx, b.time_idx, mc_samples,
                                  mc_seed, batched=mc_batched)
        else:
            pred = self.predict_scores(b.firm_idx, b.time_idx)
        return scatter_forecasts(b, pred.float().cpu().numpy(),
                                 self.panel)


def check_seq(cfg: RunConfig) -> int:
    """``cfg.n_seq_shards``, after the JAX trainer's check
    (``train/loop.py:962-967``): dropout under a seq axis raises."""
    if cfg.n_seq_shards > 1 and has_dropout(cfg):
        raise ValueError(
            "dropout is unsupported under sequence parallelism (shard-local "
            "masks would decorrelate; see models/transformer.py)")
    return cfg.n_seq_shards


def seq_model(cfg: RunConfig, mesh: DataMesh, n_features: int,
              device: torch.device, n_seeds: Optional[int] = None
              ) -> Optional[torch.nn.Module]:
    """The window-sharded train model of a live seq axis (None without
    one): ``model_kwargs(cfg, seq_axis=True)``, which raises for a model
    that cannot shard its window; the window must divide by the axis.
    Its own params stay unused: it runs on the eval model's."""
    if mesh.n_seq == 1:
        return None
    if cfg.data.window % mesh.n_seq:
        raise ValueError(f"window={cfg.data.window} must divide by "
                         f"n_seq_shards={mesh.n_seq}")
    kind, kw = model_kwargs(cfg, seq_axis=True)
    return build_model(kind, n_features=n_features, n_seeds=n_seeds,
                       **kw).to(device)


def sub_window(window: int, mesh: DataMesh) -> Tuple[int, int]:
    """A seq rank's sub-window ``Wl = W / n_seq`` and the shift of its
    anchor: absolute window positions ``[s·Wl, (s+1)·Wl)`` end at ``t -
    (W - (s+1)·Wl)``. Young anchors degrade as in the full gather (months
    before the panel are masked)."""
    wl = window // mesh.n_seq
    return wl, window - (mesh.seq_rank + 1) * wl


def check_predict_options(return_variance: bool) -> None:
    """The prediction option the port does not have yet."""
    if return_variance:
        raise NotImplementedError(
            "return_variance needs the heteroscedastic variance forward, "
            "which is not ported yet (ROADMAP.md Queue A item 4)")


def predict_batch(cfg: RunConfig, splits: PanelSplits, split: str,
                  date_range: Optional[Tuple[int, int]],
                  require_target: bool) -> WindowIndex:
    """Every eligible cross-section of ``date_range`` (default the split's
    range) as one ``[M, bf]`` index batch: the input of ``predict``."""
    d = cfg.data
    sampler = DateBatchSampler(
        splits.panel, d.window, 1, d.firms_per_date, seed=0,
        min_valid_months=d.min_valid_months, min_cross_section=1,
        date_range=date_range or splits.range_of(split),
        require_target=require_target)
    return sampler.stacked_cross_sections()


def scatter_forecasts(b: WindowIndex, pred: np.ndarray, panel: Panel
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """``pred [..., M, bf]`` of the batch ``b`` → ``([..., N, T] forecasts,
    [N, T] validity)`` over the whole panel (zero and False elsewhere)."""
    real = b.weight > 0
    rows = b.firm_idx[real]
    cols = np.broadcast_to(b.time_idx[:, None], b.firm_idx.shape)[real]
    out = np.zeros(pred.shape[:-2] + (panel.n_firms, panel.n_months),
                   np.float32)
    out[..., rows, cols] = pred[..., real]
    valid = np.zeros((panel.n_firms, panel.n_months), bool)
    valid[rows, cols] = True
    return out, valid


def default_split_dates(panel: Panel, d) -> Tuple[int, int]:
    """The default (train_end, val_end): the configured dates when set,
    else the 70% / 85% panel quantiles."""
    dates = panel.dates
    train_end = d.train_end or int(dates[int(len(dates) * 0.7)])
    val_end = d.val_end or int(dates[int(len(dates) * 0.85)])
    return train_end, val_end


def splits_for(cfg: RunConfig, panel: Optional[Panel] = None
               ) -> PanelSplits:
    """The config's panel (built when not given) split at its default
    dates."""
    d = cfg.data
    if panel is None:
        panel = resolve_panel(d)
    train_end, val_end = default_split_dates(panel, d)
    return PanelSplits.by_date(panel, train_end, val_end,
                               train_start=d.train_start)


def run_experiment(cfg: RunConfig, panel: Optional[Panel] = None,
                   echo: bool = False, resume: bool = False,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Tuple[Dict[str, Any], Trainer, PanelSplits]:
    """Config → panel → splits → train; writes ``config.json`` and
    ``summary.json`` into ``<out_dir>/<name>/seed<seed>`` (rank 0). Returns
    (summary, trainer, splits)."""
    splits = splits_for(cfg, panel)
    run_dir = os.path.join(cfg.out_dir, cfg.name, f"seed{cfg.seed}")
    trainer = Trainer(cfg, splits, run_dir=run_dir, echo=echo, device=device)
    summary = trainer.fit(resume=resume)
    summary["run_dir"] = run_dir
    summary["config"] = dataclasses.asdict(cfg)
    summary["mesh"] = mesh_fingerprint(trainer.mesh)
    if dist_utils.is_main():
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.json"), "w") as fh:
            fh.write(cfg.to_json())
        # Clears a stale marker of a seed ensemble once written here.
        mark_ensemble_run_dir(run_dir, False)
        with open(os.path.join(run_dir, "summary.json"), "w") as fh:
            json.dump({k: v for k, v in summary.items()
                       if k not in ("history", "step_losses")}, fh,
                      indent=2, default=str)
    dist_utils.barrier()
    return summary, trainer, splits


def load_trainer(run_dir: str, panel: Optional[Panel] = None,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Tuple[Trainer, PanelSplits]:
    """A :class:`Trainer` rebuilt from a run dir (its ``config.json``, the
    panel it resolves to unless ``panel`` is given, the default splits),
    its best checkpoint restored: the backtest and forecast entry points'
    model."""
    with open(os.path.join(run_dir, "config.json")) as fh:
        cfg = RunConfig.from_json(fh.read())
    splits = splits_for(cfg, panel)
    trainer = Trainer(cfg, splits, run_dir=run_dir, device=device)
    best = CheckpointManager(os.path.join(run_dir, "ckpt", "best"))
    trainer.state = trainer.load_state(best.restore())
    return trainer, splits
