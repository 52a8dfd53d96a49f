"""Training loop and scoring forward: the port of
``lfm_quant_tpu/train/loop.py`` for one model on one device.

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
  (:class:`FitHarness`).

The loop is lock-step, the JAX package's ``LFM_ASYNC=0`` path: no meshes,
no geometry buckets, no async prefetch or checkpointing (ROADMAP.md
Queue A). The gathers resolve as the JAX trainer's do: the train step
takes ``gather_impl`` (the kernel for "auto" and "pallas"), the
validation sweep the plain gather unless ``gather_impl="pallas"`` is set
explicitly (``loop.py:1045-1047``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import (Any, Callable, Dict, Iterator, Mapping, NamedTuple,
                    Optional, Tuple, Union)

import numpy as np
import torch

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
from lfm_quant_tpu_torch.train.checkpoint import CheckpointManager
from lfm_quant_tpu_torch.train.optim import AdamW, AdamWState
from lfm_quant_tpu_torch.utils.logging import MetricsLogger, StepTimer
from lfm_quant_tpu_torch.weights import flax_param_map, load_flax_params
from lfm_quant_tpu_torch.weights import init_params as seeded_init


def _point_forecast(out):
    """Point forecast from either head type (mean for heteroscedastic)."""
    return out[0] if isinstance(out, tuple) else out


def make_loss_fn(name: str) -> Callable:
    """Loss name → fn(outputs, targets, weights) → scalar, derived from
    ``make_loss_parts`` so the two cannot drift."""
    parts = make_loss_parts(name)
    return lambda out, y, w: finalize_loss(*parts(out, y, w))


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
        self.dev = device_panel(panel, self.device, compute_dtype(cfg))

    def _gather(self, firm_idx: torch.Tensor, time_idx: torch.Tensor,
                impl: Optional[str] = None):
        gather = (gather_windows if (impl or self.gather_impl) == "kernel"
                  else gather_windows_packed)
        return gather(self.dev["xm"], firm_idx, time_idx, self.window,
                      fp=self.fp)

    def _apply(self, x: torch.Tensor, m: torch.Tensor):
        """Flatten the [D, Bf] batch dims → one model batch, reapply."""
        lead = x.shape[:-2]
        out = self.model(x.reshape((-1,) + x.shape[-2:]),
                         m.reshape((-1,) + m.shape[-1:]))
        if isinstance(out, tuple):
            return tuple(o.reshape(lead) for o in out)
        return out.reshape(lead)

    def _forward_chunks(self, fi: torch.Tensor, ti: torch.Tensor,
                        impl: Optional[str] = None
                        ) -> Iterator[Tuple[slice, Any]]:
        """The forward over an ``[M, Bf]`` index batch on the device,
        chunked over months by ``dates_per_batch`` with the last chunk
        padded by repeating months, as the JAX eval forward does. Yields
        ``(rows of the padded batch, model output)`` per chunk."""
        M = fi.shape[0]
        C = min(self.cfg.data.dates_per_batch, M)
        pad = (-M) % C
        if pad:
            fi = torch.cat([fi, fi[:pad]], dim=0)
            ti = torch.cat([ti, ti[:pad]], dim=0)
        for k in range(0, fi.shape[0], C):
            x, m = self._gather(fi[k:k + C], ti[k:k + C], impl)
            yield slice(k, k + C), self._apply(x, m)

    @torch.inference_mode()
    def predict_scores(self, firm_idx: np.ndarray, time_idx: np.ndarray
                       ) -> torch.Tensor:
        """Point forecasts ``[M, Bf]`` (f32, on the device) for an
        ``[M, Bf]`` index batch (the scores-only forward)."""
        fi = torch.as_tensor(np.asarray(firm_idx, np.int32)).to(self.device)
        ti = torch.as_tensor(np.asarray(time_idx, np.int32)).to(self.device)
        preds = [_point_forecast(out)
                 for _, out in self._forward_chunks(fi, ti)]
        return torch.cat(preds, dim=0)[:fi.shape[0]]

    def score(self, firm_idx: np.ndarray, time_idx: np.ndarray,
              weight: np.ndarray) -> np.ndarray:
        """Served scores: forecasts as f32 with weight-0 slots zeroed
        (the JAX package's ``ServePrograms.score``), on the host."""
        pred = self.predict_scores(firm_idx, time_idx).float()
        w = torch.as_tensor(np.asarray(weight, np.float32)).to(pred.device)
        return torch.where(w > 0, pred, torch.zeros_like(pred)).cpu().numpy()


# ---------------------------------------------------------------------------
# Fit scaffolding
# ---------------------------------------------------------------------------


class TrainState(NamedTuple):
    """``params``: the model's parameters by Flax path (live tensors, the
    optimizer updates them in place); ``opt_state``: Adam's moments and
    count; ``step``: optimizer steps taken. The JAX state's dropout key
    has no counterpart: the recurrent models have no dropout."""

    params: Dict[str, torch.Tensor]
    opt_state: AdamWState
    step: int


def load_progress(run_dir: str) -> Dict[str, Any]:
    """Read the fit-progress sidecar used for crash resume."""
    with open(os.path.join(run_dir, "fit_progress.json")) as fh:
        return json.load(fh)


def save_progress(run_dir: Optional[str], **kw) -> None:
    """Atomic write of the progress sidecar."""
    if run_dir:
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
    or a metrics file.
    """

    def __init__(self, cfg: RunConfig, splits: PanelSplits,
                 run_dir: Optional[str] = None, echo: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        if cfg.optim.optimizer != "adamw":
            raise NotImplementedError(
                f"optimizer {cfg.optim.optimizer!r} is not ported (lamb: "
                "ROADMAP.md Queue A); use adamw")
        super().__init__(cfg, splits.panel, device=device)
        self.splits = splits
        self.run_dir = run_dir
        self.echo = echo
        self.state: Optional[TrainState] = None
        d = cfg.data
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
        self.loss_fn = make_loss_fn(cfg.optim.loss)
        self._steps_per_epoch = self.train_sampler.batches_per_epoch()
        o = cfg.optim
        self.opt = AdamW(o.lr, o.weight_decay, o.grad_clip, o.warmup_steps,
                         self._steps_per_epoch * o.epochs)

    # ---- state -----------------------------------------------------------

    def init_state(self, params: Optional[Mapping[str, Any]] = None
                   ) -> TrainState:
        """Fresh params (the seeded init drawn on the CPU, or a Flax
        tree), fresh optimizer state, step 0."""
        if params is None:
            kind, kw = model_kwargs(self.cfg)
            fresh = build_model(kind, n_features=self.panel.n_features, **kw)
            seeded_init(fresh, torch.Generator().manual_seed(self.cfg.seed))
            params = {k: p.detach().numpy()
                      for k, p in flax_param_map(fresh).items()}
        load_flax_params(self.model, params)
        live = flax_param_map(self.model)
        return TrainState(live, self.opt.init(
            {k: p.detach() for k, p in live.items()}), 0)

    @staticmethod
    def state_dict(state: TrainState) -> Dict[str, Any]:
        """A host copy of the state for a checkpoint."""
        cpu = (lambda t: t.detach().to("cpu", copy=True))
        o = state.opt_state
        return {"params": {k: cpu(p) for k, p in state.params.items()},
                "opt_state": {"count": o.count,
                              "mu": {k: cpu(v) for k, v in o.mu.items()},
                              "nu": {k: cpu(v) for k, v in o.nu.items()}},
                "step": state.step}

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
                          int(saved["step"]))

    # ---- the step --------------------------------------------------------

    def _loss(self, fi: torch.Tensor, ti: torch.Tensor, w: torch.Tensor):
        x, m = self._gather(fi, ti)
        y = gather_targets(self.dev["targets"], fi, ti)
        return self.loss_fn(self._apply(x, m), y, w)

    def step(self, state: TrainState, fi: torch.Tensor, ti: torch.Tensor,
             w: torch.Tensor) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One train step on a ``[D, Bf]`` index batch on the device:
        loss, gradients, one optimizer update. Returns the new state and
        ``{"loss", "grad_norm"}`` as device scalars (no host sync)."""
        self.model.train()
        keys = list(state.params)
        loss = self._loss(fi, ti, w)
        grads = torch.autograd.grad(loss, [state.params[k] for k in keys])
        gnorm = self.opt.step(state.params, dict(zip(keys, grads)),
                              state.opt_state)
        return (TrainState(state.params, state.opt_state, state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm})

    # ---- evaluation ------------------------------------------------------

    @torch.inference_mode()
    def _eval_dispatch(self, fi: torch.Tensor, ti: torch.Tensor,
                       w: torch.Tensor):
        """Per-month Spearman IC ``[M]`` and the MSE over a stacked
        ``[M, bf]`` batch, on the device (the JAX ``_forward_impl``)."""
        self.model.eval()
        M = fi.shape[0]
        pad = (-M) % min(self.cfg.data.dates_per_batch, M)
        fi_p = torch.cat([fi, fi[:pad]]) if pad else fi
        ti_p = torch.cat([ti, ti[:pad]]) if pad else ti
        w_p = torch.cat([w, torch.zeros_like(w[:pad])]) if pad else w
        ics, ses, wss = [], [], []
        for rows, out in self._forward_chunks(fi, ti, self.eval_gather_impl):
            pred = _point_forecast(out)
            f, t, ww = fi_p[rows], ti_p[rows], w_p[rows]
            y = gather_targets(self.dev["targets"], f, t)
            ics.append(spearman_ic(pred, y, ww))
            ses.append((ww * (pred.float() - y) ** 2).sum(dim=-1))
            wss.append(ww.sum(dim=-1))
        ic = torch.cat(ics)[:M]
        se, ws = torch.cat(ses)[:M], torch.cat(wss)[:M]
        return ic, se.sum() / torch.clamp(ws.sum(), min=1e-12)

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
        ``init_params`` (a Flax tree) replaces the seeded init, the
        optimizer starting fresh. Restores the best state at the end.

        Returns the summary (best val IC and epoch, epochs run, steps,
        firm-months per second, the per-epoch ``history``) and
        ``step_losses``, every step's loss in order."""
        cfg = self.cfg
        if cfg.optim.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {cfg.optim.epochs}")
        state = self.init_state(init_params)
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
                snap = self.state_dict(state) if self.run_dir else None
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


def default_split_dates(panel: Panel, d) -> Tuple[int, int]:
    """The default (train_end, val_end): the configured dates when set,
    else the 70% / 85% panel quantiles."""
    dates = panel.dates
    train_end = d.train_end or int(dates[int(len(dates) * 0.7)])
    val_end = d.val_end or int(dates[int(len(dates) * 0.85)])
    return train_end, val_end


def run_experiment(cfg: RunConfig, panel: Optional[Panel] = None,
                   echo: bool = False, resume: bool = False,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Tuple[Dict[str, Any], Trainer, PanelSplits]:
    """Config → panel → splits → train; writes ``config.json`` and
    ``summary.json`` into ``<out_dir>/<name>/seed<seed>``. Returns
    (summary, trainer, splits)."""
    d = cfg.data
    if panel is None:
        panel = resolve_panel(d)
    train_end, val_end = default_split_dates(panel, d)
    splits = PanelSplits.by_date(panel, train_end, val_end,
                                 train_start=d.train_start)
    run_dir = os.path.join(cfg.out_dir, cfg.name, f"seed{cfg.seed}")
    trainer = Trainer(cfg, splits, run_dir=run_dir, echo=echo, device=device)
    summary = trainer.fit(resume=resume)
    summary["run_dir"] = run_dir
    summary["config"] = dataclasses.asdict(cfg)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as fh:
        fh.write(cfg.to_json())
    with open(os.path.join(run_dir, "summary.json"), "w") as fh:
        json.dump({k: v for k, v in summary.items()
                   if k not in ("history", "step_losses")}, fh, indent=2,
                  default=str)
    return summary, trainer, splits
