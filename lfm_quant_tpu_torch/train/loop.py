"""Scoring forward: the scores-only eval path of the JAX package's
``TrainerPrograms._forward_impl`` (``lfm_quant_tpu/train/loop.py``).

A :class:`Predictor` holds what that path reads: the model and its
params, the device-resident packed panel, the resolved window gather and
the date chunking by ``dates_per_batch``. The training half of the loop
comes with the port's training slice.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from lfm_quant_tpu_torch.config import RunConfig, compute_dtype, model_kwargs
from lfm_quant_tpu_torch.data.panel import Panel, load_panel, synthetic_panel
from lfm_quant_tpu_torch.data.windows import (
    device_panel,
    gather_windows_packed,
    resolve_gather_impl,
)
from lfm_quant_tpu_torch.device import resolve_device
from lfm_quant_tpu_torch.models import build_model
from lfm_quant_tpu_torch.ops.gather import gather_windows
from lfm_quant_tpu_torch.weights import init_params, load_flax_params


def _point_forecast(out):
    """Point forecast from either head type (mean for heteroscedastic)."""
    return out[0] if isinstance(out, tuple) else out


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
            init_params(model, torch.Generator().manual_seed(cfg.seed))
        else:
            load_flax_params(model, params)
        self.model = model.to(self.device).eval()
        self.dev = device_panel(panel, self.device, compute_dtype(cfg))

    def _gather(self, firm_idx: torch.Tensor, time_idx: torch.Tensor):
        gather = (gather_windows if self.gather_impl == "kernel"
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

    @torch.inference_mode()
    def predict_scores(self, firm_idx: np.ndarray, time_idx: np.ndarray
                       ) -> torch.Tensor:
        """Point forecasts ``[M, Bf]`` (f32, on the device) for an
        ``[M, Bf]`` index batch, chunked over months by
        ``dates_per_batch`` with the last chunk padded by repeating
        months (sliced off again), as the JAX scores-only forward does."""
        dev = self.device
        fi = torch.as_tensor(np.asarray(firm_idx, np.int32)).to(dev)
        ti = torch.as_tensor(np.asarray(time_idx, np.int32)).to(dev)
        M = fi.shape[0]
        C = min(self.cfg.data.dates_per_batch, M)
        pad = (-M) % C
        if pad:
            fi = torch.cat([fi, fi[:pad]], dim=0)
            ti = torch.cat([ti, ti[:pad]], dim=0)
        preds = []
        for k in range(0, fi.shape[0], C):
            x, m = self._gather(fi[k:k + C], ti[k:k + C])
            preds.append(_point_forecast(self._apply(x, m)))
        return torch.cat(preds, dim=0)[:M]

    def score(self, firm_idx: np.ndarray, time_idx: np.ndarray,
              weight: np.ndarray) -> np.ndarray:
        """Served scores: forecasts as f32 with weight-0 slots zeroed
        (the JAX package's ``ServePrograms.score``), on the host."""
        pred = self.predict_scores(firm_idx, time_idx).float()
        w = torch.as_tensor(np.asarray(weight, np.float32)).to(pred.device)
        return torch.where(w > 0, pred, torch.zeros_like(pred)).cpu().numpy()
