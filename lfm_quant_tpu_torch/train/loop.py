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

The epoch loop runs through the async pipeline (``train/pipeline.py``,
``LFM_ASYNC`` and ``LFM_ASYNC_CKPT``, both on by default): an epoch's
steps and its validation sweep queued on the device, ONE counted fetch of
its scalars (and of the state, for the checkpoint), the next epoch
sampled on a thread and queued before that fetch, the checkpoints written
in the background; a SIGTERM stops the fit at the next epoch boundary
with both lines durable (``train/preempt.py``). ``LFM_BUCKETS=1`` trains,
sweeps and predicts on the sampler's (lookback × width) bucket ladder
(``data/windows.py bucket_geometry``): each bucket a batch shape of its
own, a bucketed batch's results those of the same batch padded to the
max shape. ``predict(return_variance=True)`` returns a heteroscedastic
model's aleatoric variance beside its mean. The train step and
``predict`` take ``gather_impl`` (the kernel for "auto" and "pallas");
the validation sweep resolves as the JAX trainer's does, the plain gather
unless ``gather_impl="pallas"`` is set explicitly (``loop.py:1045-1047``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import (Any, Callable, Dict, Iterator, Mapping, NamedTuple,
                    Optional, Tuple, Union)

import numpy as np
import torch
from torch.func import functional_call

from lfm_quant_tpu_torch.buckets import buckets_enabled
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
from lfm_quant_tpu_torch.train import pipeline
from lfm_quant_tpu_torch.train.checkpoint import CheckpointManager
from lfm_quant_tpu_torch.train.forecast import mark_ensemble_run_dir
from lfm_quant_tpu_torch.train.optim import AdamWState, make_optimizer
from lfm_quant_tpu_torch.utils import distributed as dist_utils
from lfm_quant_tpu_torch.utils import debug, faults, telemetry
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
    """DataConfig → Panel: a panel saved by ``Panel.save``, a
    Compustat-style CSV or parquet file (``data/compustat.py``; a
    ``.csv`` through the native parser when it builds), or the synthetic
    generator; then any configured derived feature columns
    (``data/features.py``)."""
    if d.panel_path:
        if d.panel_path.endswith((".csv", ".parquet", ".pq")):
            from lfm_quant_tpu_torch.data.compustat import load_compustat_csv

            panel = load_compustat_csv(d.panel_path, horizon=d.horizon,
                                       target_col=d.target_col)
        else:
            panel = load_panel(d.panel_path)
    else:
        panel = synthetic_panel(
            n_firms=d.n_firms, n_months=d.n_months, n_features=d.n_features,
            start_yyyymm=d.start_yyyymm, horizon=d.horizon,
            seed=d.panel_seed, het_noise=d.het_noise)
    if d.derived_features:
        from lfm_quant_tpu_torch.data.features import add_derived_features

        panel = add_derived_features(panel, d.derived_features)
    return panel


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
        telemetry.COUNTERS.bump("panel_transfers")
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
                       impl: Optional[str] = None,
                       window: Optional[int] = None
                       ) -> Iterator[Tuple[slice, torch.Tensor,
                                           torch.Tensor]]:
        """The windows of an ``[M, Bf]`` index batch on the device,
        chunked over months by ``dates_per_batch`` with the last chunk
        padded by repeating months, as the JAX eval forward does
        (``window``: a geometry bucket's lookback). Yields ``(rows of the
        padded batch, x, m)`` per chunk."""
        M = fi.shape[0]
        C = min(self.cfg.data.dates_per_batch, M)
        pad = (-M) % C
        if pad:
            fi = torch.cat([fi, fi[:pad]], dim=0)
            ti = torch.cat([ti, ti[:pad]], dim=0)
        for k in range(0, fi.shape[0], C):
            yield (slice(k, k + C),) + self._gather(
                fi[k:k + C], ti[k:k + C], impl, window)

    def _forward_chunks(self, fi: torch.Tensor, ti: torch.Tensor,
                        impl: Optional[str] = None,
                        window: Optional[int] = None
                        ) -> Iterator[Tuple[slice, Any]]:
        """The forward over :meth:`_chunk_windows`: ``(rows of the padded
        batch, model output)`` per chunk."""
        for rows, x, m in self._chunk_windows(fi, ti, impl, window):
            yield rows, self._apply(x, m)

    def _month_rows(self, M: int) -> Tuple[torch.Tensor, int]:
        """This rank's rows of an ``M``-month sweep (``month_block``), on
        the device (a copy that does not wait for it), and how many of
        them are real months."""
        rows, n_real = month_block(M, self.cfg.data.dates_per_batch,
                                   self.mesh)
        return rows.to(self.device, non_blocking=True), n_real

    def _index_batch(self, firm_idx: np.ndarray, time_idx: np.ndarray):
        """An ``[M, Bf]`` index batch on the device and, under a data
        mesh, this rank's block of its months."""
        fi = torch.as_tensor(np.asarray(firm_idx, np.int32)).to(self.device)
        ti = torch.as_tensor(np.asarray(time_idx, np.int32)).to(self.device)
        if self.mesh.n_batch > 1:
            rows, _ = self._month_rows(fi.shape[0])
            fi, ti = fi[rows], ti[rows]
        return fi, ti

    @torch.inference_mode()
    def predict_scores(self, firm_idx: np.ndarray, time_idx: np.ndarray,
                       window: Optional[int] = None) -> torch.Tensor:
        """Point forecasts ``[M, Bf]`` (f32, on the device) for an
        ``[M, Bf]`` index batch (the scores-only forward; ``window``: a
        geometry bucket's lookback); under a data mesh each rank
        forecasts its block of months and every rank returns all of them
        (the months are split over the date and seq shards alike)."""
        M = len(time_idx)
        fi, ti = self._index_batch(firm_idx, time_idx)
        preds = [_point_forecast(out) for _, out in
                 self._forward_chunks(fi, ti, window=window)]
        return all_gather_dates(torch.cat(preds, dim=0), self.mesh)[:M]

    @torch.inference_mode()
    def predict_variance(self, firm_idx: np.ndarray, time_idx: np.ndarray
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A heteroscedastic model's ``(mean, exp(log_var))``, each ``[M,
        Bf]`` on the device, for an ``[M, Bf]`` index batch (the JAX
        ``_forward_impl(variance=True)``): the mean in the compute dtype,
        the aleatoric variance in f32. A point head raises
        ``ValueError``."""
        M = len(time_idx)
        fi, ti = self._index_batch(firm_idx, time_idx)
        means, variances = [], []
        for _, out in self._forward_chunks(fi, ti):
            if not isinstance(out, tuple):
                raise ValueError(
                    "variance=True needs a heteroscedastic head "
                    "(ModelConfig.heteroscedastic / loss='nll')")
            mean, log_var = out
            means.append(mean)
            variances.append(torch.exp(log_var.float()))
        return tuple(all_gather_dates(torch.cat(t, dim=0), self.mesh)[:M]
                     for t in (means, variances))

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
    model), the progress sidecar, early stopping and resume. Both saves
    start in the background (``LFM_ASYNC_CKPT``, ``train/pipeline.py``);
    ``resume`` reconciles a sidecar that ran ahead of a save that never
    committed."""

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
        """Record an epoch: update the best, start both saves (from the
        host copy ``state_dict``), then write the sidecar. With
        ``LFM_ASYNC_CKPT=0`` both lines are durable before the sidecar
        names them; with it on they drain behind the next epoch, flushed
        at :meth:`finalize`. Returns True when early stopping triggers."""
        saved_best = False
        if val_ic > self.best_ic:
            self.best_ic, self.best_epoch, self.bad_epochs = val_ic, epoch, 0
            if self.best_mgr:
                self.best_mgr.save(step, state_dict, wait=False)
                saved_best = True
        else:
            self.bad_epochs += 1
        if self.latest_mgr:
            self.latest_mgr.save(step, state_dict, wait=False)
            if not pipeline.async_ckpt_enabled():
                # "Durable before proceeding": an unbounded wait.
                if saved_best:
                    self.best_mgr.wait(timeout_s=0)
                self.latest_mgr.wait(timeout_s=0)
            save_progress(self.run_dir, epoch=epoch,
                          best_ic=float(self.best_ic),
                          best_epoch=self.best_epoch,
                          bad_epochs=self.bad_epochs)
            dist_utils.barrier()
        return self.bad_epochs >= self.patience

    def preempt_flush(self) -> None:
        """SIGTERM grace flush: both lines flushed and closed with BOUNDED
        waits (``LFM_CKPT_WAIT_S``), so a wedged writer cannot eat the
        grace window. The sidecar was written by :meth:`end_epoch`; a
        wait that times out leaves it ahead of its line, which
        :meth:`resume` reconciles."""
        if not self.latest_mgr:
            return
        self.best_mgr.close()
        self.latest_mgr.close()
        dist_utils.barrier()

    def finalize(self) -> Optional[Dict[str, Any]]:
        """Flush the saves in flight (bounded), then the best checkpoint's
        state, if one was committed. The wait comes first: the best line
        being read may still be committing."""
        best_durable = True
        if self.latest_mgr:
            best_durable = self.best_mgr.wait()
            self.latest_mgr.wait()
            # Rank 0 wrote both lines; the others read them next.
            dist_utils.barrier()
        best = None
        if (self.best_mgr and self.best_epoch >= 0
                and self.best_mgr.latest_step() is not None):
            if not best_durable:
                warnings.warn(
                    f"best checkpoint line still uncommitted after the "
                    f"bounded wait (epoch {self.best_epoch} recorded) — "
                    "restoring the newest COMMITTED best instead, which "
                    "may be older", RuntimeWarning, stacklevel=2)
            best = self.best_mgr.restore()
        if self.latest_mgr:
            self.latest_mgr.close()
            self.best_mgr.close()
        return best


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
        self._bucketed = resolve_buckets(self.mesh)
        # A bucketed sweep under a data mesh would pad each bucket's
        # months to the batch group again: the sweeps and predict keep the
        # max shape there while the train batches still bucket.
        self._bucketed_eval = self._bucketed and self.mesh.n_batch == 1
        # A bucketed epoch floors leftover dates per bucket: the schedule
        # takes its step count.
        self._steps_per_epoch = (
            self.train_sampler.bucketed_batches_per_epoch() if self._bucketed
            else self.train_sampler.batches_per_epoch())
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
                    w: torch.Tensor, rng: Optional[torch.Generator] = None,
                    window: Optional[int] = None):
        """The loss's ``(num, den)`` on a ``[D, Bf]`` index batch
        (dropout on under ``rng``; ``window``: a geometry bucket's
        lookback); under a seq axis on this seq rank's sub-window, through
        the window-sharded model."""
        y = gather_targets(self.dev["targets"], fi, ti)
        if self.train_model is None:
            x, m = self._gather(fi, ti, window=window)
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
               w: torch.Tensor, window: Optional[int] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss and its gradients on a global ``[D, Bf]`` index batch:
        this rank's block of dates, ``num`` and ``den`` summed over the
        date shards in one collective, the backward of ``num_local /
        den_global`` (``den`` depends on no parameter), the gradients
        summed over the date and seq shards in one flat buffer. On one
        process: the plain loss and its gradients."""
        fi, ti, w = (shard_dates(a, self.mesh) for a in (fi, ti, w))
        num, den = self._loss_parts(fi, ti, w, self.step_generator(state),
                                    window)
        num_g, den_g = all_reduce_sum(
            torch.stack([num.detach(), den.detach()]), self.mesh)
        keys = list(state.params)
        grads = torch.autograd.grad(num / torch.clamp(den_g, min=1e-12),
                                    [state.params[k] for k in keys])
        grads = all_reduce_flat(grads, self.mesh, BATCH)
        return finalize_loss(num_g, den_g), dict(zip(keys, grads))

    def step(self, state: TrainState, fi: torch.Tensor, ti: torch.Tensor,
             w: torch.Tensor, window: Optional[int] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One train step on a global ``[D, Bf]`` index batch on the
        device (``window``: a geometry bucket's lookback): loss,
        gradients, one optimizer update. Returns the new state and
        ``{"loss", "grad_norm"}`` as device scalars (no host sync), equal
        on every rank."""
        self.model.train()
        loss, grads = self._grads(state, fi, ti, w, window)
        gnorm = self.opt.step(state.params, grads, state.opt_state)
        debug.check_step({"loss": loss, "grads": grads,
                          "params": state.params})
        return (state._replace(step=state.step + 1),
                {"loss": loss, "grad_norm": gnorm})

    # ---- evaluation ------------------------------------------------------

    @torch.inference_mode()
    def _eval_dispatch(self, fi: torch.Tensor, ti: torch.Tensor,
                       w: torch.Tensor, window: Optional[int] = None):
        """Per-month Spearman IC ``[M]`` and the MSE over a stacked
        ``[M, bf]`` batch, on the device (the JAX ``_forward_impl``;
        ``window``: a geometry bucket's lookback): months padded with
        weight-0 repeats into whole chunks and, under a data mesh, one
        block of them per rank (the JAX ``_forward_eval``); the ICs are
        gathered and the error and weight sums summed across the ranks.
        Traced as an ``eval`` span (the dispatch's host time: the sweep
        runs on, asynchronously)."""
        with telemetry.span("eval", cat="eval"):
            return self._eval_sweep(fi, ti, w, window)

    def _eval_sweep(self, fi: torch.Tensor, ti: torch.Tensor,
                    w: torch.Tensor, window: Optional[int]):
        self.model.eval()
        M = fi.shape[0]
        rows, n_real = self._month_rows(M)
        fi_p, ti_p, w_p = fi[rows], ti[rows], w[rows]
        w_p[n_real:] = 0
        ics, ses, wss = [], [], []
        for sl, out in self._forward_chunks(fi_p, ti_p,
                                            self.eval_gather_impl, window):
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

    def _val_sweep(self) -> Tuple[Callable[[], Tuple[torch.Tensor,
                                                      torch.Tensor]],
                                  np.ndarray]:
        """The epoch's validation sweep, its batches hoisted onto the
        device once, and the months' pool sizes (the IC weights). Under
        ``LFM_BUCKETS`` one dispatch per (lookback × width) bucket, the
        per-month ICs scattered back to the stacked month order and the
        MSE recombined by each bucket's weight share (the JAX
        ``train/loop.py:1338-1360``)."""
        if not self._bucketed_eval:
            vb = self.val_sampler.stacked_cross_sections()
            vargs = self._batch(vb)
            return (lambda: self._eval_dispatch(*vargs),
                    vb.weight.sum(axis=1))
        parts = self.val_sampler.bucketed_cross_sections()
        n_val = sum(pos.size for _, _, pos in parts)
        counts = np.zeros(n_val, np.float32)
        hoist = []
        for (lb, _), b, pos in parts:
            counts[pos] = b.weight.sum(axis=1)
            hoist.append((lb, self._batch(b),
                          torch.as_tensor(pos).to(self.device),
                          float(b.weight.sum())))
        w_total = max(sum(h[3] for h in hoist), 1e-12)

        def sweep():
            ic = torch.zeros(n_val, dtype=torch.float32, device=self.device)
            mse = torch.zeros((), dtype=torch.float32, device=self.device)
            for lb, vargs, pos, wsum in hoist:
                ic_b, mse_b = self._eval_dispatch(*vargs, window=lb)
                ic[pos] = ic_b.float()
                mse = mse + mse_b.float() * (wsum / w_total)
            return ic, mse

        return sweep, counts

    def _adopt(self, state: TrainState) -> TrainState:
        """A state cloned off the live one (the pipeline's rollback
        target) copied back into the model's parameters."""
        live = flax_param_map(self.model)
        with torch.no_grad():
            for k, p in live.items():
                p.copy_(state.params[k])
        return state._replace(params=live)

    def _snapshot(self, state: TrainState) -> Optional[Dict[str, Any]]:
        """The checkpoint's tree of device tensors (rank 0 writes; None
        elsewhere)."""
        if not dist_utils.is_main():
            return None
        o = state.opt_state
        return {"params": dict(state.params),
                "opt_state": {"count": o.count, "mu": dict(o.mu),
                              "nu": dict(o.nu)},
                "step": state.step, "rng": state.rng}

    # ---- fit -------------------------------------------------------------

    def fit(self, resume: bool = False,
            init_params: Optional[Mapping[str, Any]] = None
            ) -> Dict[str, Any]:
        """Train with early stopping, through the epoch pipeline of the
        JAX ``_fit_impl`` (``train/pipeline.py``). ``resume=True``
        continues from ``ckpt/latest``; ``init_params`` (a Flax tree, or
        another trainer's ``state.params``: the walk-forward warm start)
        replaces the seeded init through :func:`graft_params`, the
        optimizer starting fresh; a crash resume takes precedence.
        Restores the best state at the end; a SIGTERM raises
        :class:`~lfm_quant_tpu_torch.train.preempt.Preempted` after the
        epoch in flight is recorded and both lines are durable.

        Returns the summary (best val IC and epoch, epochs run, steps,
        firm-months per second, whether the lookahead ran over an early
        stop, the per-epoch ``history``) and ``step_losses``, every
        step's loss in order. Traced as the ``fit`` span; each epoch's
        ``sample`` (host sampling) and ``h2d`` (its index batch onto the
        device) spans and the validation sweep's ``eval`` spans nest in
        it, as in the JAX trainer."""
        with telemetry.span("fit", cat="fit", kind="trainer") as sp:
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
            flax_param_map(self.model), init_params))
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

        if self._bucketed:
            build = self._bucketed_build
        else:
            def build(epoch):
                with telemetry.span("sample", epoch=epoch):
                    b = self.train_sampler.stacked_epoch(epoch)
                with telemetry.span("h2d", epoch=epoch):
                    staged = stage(self.device, b.firm_idx, b.time_idx,
                                   b.weight)
                return ([(self.window, staged)],
                        float(b.weight.sum()) * self.window)

        def dispatch(state, parts):
            losses, gnorms = [], []
            for lb, (fi, ti, w) in parts:
                for k in range(fi.shape[0]):
                    state, ms = self.step(state, fi[k], ti[k], w[k], lb)
                    losses.append(ms["loss"])
                    gnorms.append(ms["grad_norm"])
            ic, mse = val_sweep()
            return state, {"loss": torch.stack(losses),
                           "grad_norm": torch.stack(gnorms), "ic": ic,
                           "mse": mse, "step": state.step}

        def finish(epoch, host, fm):
            loss_h = host["loss"].numpy()
            val_ic = float(np.average(host["ic"].numpy(), weights=counts))
            rec = logger.log(
                host["step"], epoch=epoch, train_loss=float(loss_h.mean()),
                grad_norm=float(host["grad_norm"].numpy().mean()),
                val_ic=val_ic, val_mse=float(host["mse"]),
                firm_months_per_sec=timer.throughput())
            history.append(rec)
            step_losses.extend(float(v) for v in loss_h)
            return host["step"], val_ic

        try:
            state, overrun = pipeline.run_fit_epochs(
                harness, state, build=build, dispatch=dispatch,
                finish=finish, timer=timer,
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
            "steps": (harness.last_epoch + 1) * harness.steps_per_epoch,
            "firm_months_per_sec": timer.throughput(),
            "lookahead_overrun": overrun is not None,
            "history": history,
            "step_losses": step_losses,
        }

    def _bucketed_build(self, epoch: int):
        """A bucketed epoch (``LFM_BUCKETS``): per (lookback × width)
        bucket a ``[K_b, D, width]`` index stack on the device, and the
        epoch's firm-month count; counts the padded cells
        (``bucket_cells_*``) against the max shape's."""
        with telemetry.span("sample", epoch=epoch):
            parts = self.train_sampler.bucketed_epoch(epoch)
            cells = count_bucket_cells(parts,
                                       self.train_sampler.firms_per_date,
                                       self.window)
        with telemetry.span("h2d", epoch=epoch):
            staged = [(lb, stage(self.device, b.firm_idx, b.time_idx,
                                 b.weight)) for (lb, _), b in parts]
        return staged, cells

    # ---- inference -------------------------------------------------------

    def predict(self, split: str = "test", mc_samples: int = 0,
                mc_seed: int = 0,
                date_range: Optional[Tuple[int, int]] = None,
                return_variance: bool = False, require_target: bool = True,
                mc_batched: bool = True) -> Tuple[np.ndarray, ...]:
        """Forecasts for every eligible anchor of a split's months:
        ``(forecast [N, T] float32, valid [N, T] bool)`` over the WHOLE
        panel, valid only inside the range, on the host (the backtest's
        input). The forward is the trained model's on the device (the
        gather and the fused recurrence kernels on the card), chunked over
        months as the validation sweep is; under ``LFM_BUCKETS`` one
        forward per (lookback × width) bucket, each scattered into the
        panel (the same forecasts as the max-shape sweep).

        ``date_range`` (month indices, end-exclusive) replaces the split's
        range: the walk-forward predicts each fold's window with it.
        ``require_target=False`` also forecasts LIVE anchors, whose
        outcome is not observable yet (the forecast entry point).

        ``return_variance=True`` (a heteroscedastic model: ``loss="nll"``
        or ``ModelConfig.heteroscedastic``; a point head raises
        ``ValueError``) returns ``(forecast, aleatoric variance [N, T],
        valid)``, the input of ``mean_minus_total_std``; it takes the
        max-shape sweep, as the JAX trainer's does.

        ``mc_samples=K > 0``: MC-dropout sampling (:meth:`mc_scores`),
        ``K`` stacked forecasts ``[K, N, T]`` under the seed ``mc_seed``,
        shaped like ``EnsembleTrainer.predict``'s for the aggregation, and
        the same validity; a model without dropout raises ``ValueError``
        (every sample would be the same), as does ``return_variance``
        with it. ``mc_batched=False`` runs the per-sample loop, which
        draws the same samples."""
        if mc_samples > 0 and not self._needs_rng:
            raise ValueError(
                "mc_samples > 0 needs a model with dropout > 0 "
                "(ModelConfig.kwargs['dropout']); this run has none, so "
                "every sample would be identical")
        sampler = predict_sampler(self.cfg, self.splits, split, date_range,
                                  require_target)
        self.model.eval()
        if self._bucketed_eval and mc_samples == 0 and not return_variance:
            parts = [(b, self.predict_scores(b.firm_idx, b.time_idx,
                                             window=lb).cpu().numpy())
                     for (lb, _), b, _ in sampler.bucketed_cross_sections()]
            return scatter_bucketed(parts, self.panel)
        b = sampler.stacked_cross_sections()
        if mc_samples > 0:
            if return_variance:
                raise ValueError(
                    "return_variance is not combinable with mc_samples — "
                    "MC sampling already carries the uncertainty")
            pred = self.mc_scores(b.firm_idx, b.time_idx, mc_samples,
                                  mc_seed, batched=mc_batched)
        elif return_variance:
            mean, var = self.predict_variance(b.firm_idx, b.time_idx)
            both = torch.stack([mean.float(), var])
            (fc, avar), valid = scatter_forecasts(b, both.cpu().numpy(),
                                                  self.panel)
            return fc, avar, valid
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


def resolve_buckets(mesh: DataMesh) -> bool:
    """``LFM_BUCKETS`` for a trainer on ``mesh``: off, with a warning,
    under a live seq axis (a seq rank's sub-window assumes the full
    lookback), as the JAX trainer's ``_setup``."""
    if not buckets_enabled():
        return False
    if mesh.n_seq > 1:
        warnings.warn(
            "LFM_BUCKETS is unsupported under sequence parallelism "
            "(per-shard sub-windows assume the full lookback); training "
            "with max-shape padding", stacklevel=3)
        return False
    return True


def stage(device: torch.device, *arrays: np.ndarray
          ) -> Tuple[torch.Tensor, ...]:
    """Host index arrays on ``device``: on the card through pinned memory,
    copies that do not wait for the device."""
    if device.type != "cuda":
        return tuple(torch.as_tensor(a).to(device) for a in arrays)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                 .to(device, non_blocking=True) for a in arrays)


def count_bucket_cells(parts, width_cap: int, window: int) -> float:
    """A bucketed epoch's padded-cell accounting (``bucket_dispatches``,
    ``bucket_cells_dispatched`` / ``_real`` / ``_max_shape`` in
    ``utils/telemetry.py COUNTERS``; a cell is one firm-month position of
    a dispatch) for ``parts``, ``((lookback, width), WindowIndex)`` pairs
    whose weights are ``[..., width]``. Returns the epoch's firm-month
    count."""
    fm = disp = mx = 0.0
    for (lb, _), b in parts:
        w = np.asarray(b.weight)
        fm += float(w.sum()) * lb
        disp += w.size * lb
        mx += w.size // w.shape[-1] * width_cap * window
    telemetry.COUNTERS.bump("bucket_dispatches", len(parts))
    telemetry.COUNTERS.bump("bucket_cells_dispatched", int(disp))
    telemetry.COUNTERS.bump("bucket_cells_real", int(fm))
    telemetry.COUNTERS.bump("bucket_cells_max_shape", int(mx))
    return fm


def predict_sampler(cfg: RunConfig, splits: PanelSplits, split: str,
                    date_range: Optional[Tuple[int, int]],
                    require_target: bool) -> DateBatchSampler:
    """The sampler of every eligible cross-section of ``date_range``
    (default the split's range): the input of ``predict``."""
    d = cfg.data
    return DateBatchSampler(
        splits.panel, d.window, 1, d.firms_per_date, seed=0,
        min_valid_months=d.min_valid_months, min_cross_section=1,
        date_range=date_range or splits.range_of(split),
        require_target=require_target)


def predict_batch(cfg: RunConfig, splits: PanelSplits, split: str,
                  date_range: Optional[Tuple[int, int]],
                  require_target: bool) -> WindowIndex:
    """:func:`predict_sampler`'s cross-sections as one ``[M, bf]`` index
    batch: the max-shape input of ``predict``."""
    return predict_sampler(cfg, splits, split, date_range,
                           require_target).stacked_cross_sections()


def scatter_bucketed(parts, panel: Panel) -> Tuple[np.ndarray, np.ndarray]:
    """``(WindowIndex, pred [..., M_b, w])`` pairs (a bucketed predict's,
    or the one max-shape batch) → ``([..., N, T] forecasts, [N, T]
    validity)`` over the whole panel, zero and False elsewhere."""
    lead = parts[0][1].shape[:-2]
    out = np.zeros(lead + (panel.n_firms, panel.n_months), np.float32)
    valid = np.zeros((panel.n_firms, panel.n_months), bool)
    for b, pred in parts:
        real = b.weight > 0
        rows = b.firm_idx[real]
        cols = np.broadcast_to(b.time_idx[:, None], b.firm_idx.shape)[real]
        out[..., rows, cols] = pred[..., real]
        valid[rows, cols] = True
    return out, valid


def scatter_forecasts(b: WindowIndex, pred: np.ndarray, panel: Panel
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """``pred [..., M, bf]`` of the batch ``b`` → ``([..., N, T] forecasts,
    [N, T] validity)`` over the whole panel (zero and False elsewhere)."""
    return scatter_bucketed([(b, pred)], panel)


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
