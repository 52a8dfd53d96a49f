"""Dense layers in Flax's layout and the shared forecast head, each with
an optional leading seed axis (the seed ensemble: S independent members
whose per-seed products are batched matrix products)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with Flax's ``[in, out]`` kernel, f32
    params, and Flax ``nn.Dense``'s dtype rule: inputs and params are
    cast to ``dtype`` (default: the promotion of the input's and the
    params' types) before the product and before the bias add.

    ``n_seeds``: a seed-stacked layer, ``kernel [S, in, out]`` and ``bias
    [S, out]``; its input carries a leading seed axis of extent S, or 1
    for an input every seed shares, and seed s is ``x[s] @ kernel[s] +
    bias[s]``. The seed count is read from the kernel, so a block of
    seeds' params serves as well."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, n_seeds: Optional[int] = None):
        super().__init__()
        lead = () if n_seeds is None else (n_seeds,)
        self.kernel = nn.Parameter(torch.zeros(*lead, in_features, features))
        self.bias = (nn.Parameter(torch.zeros(*lead, features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dt = dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        if self.kernel.dim() == 3:
            # [S or 1, N, in] @ [S, in, out]: one batched product.
            flat = x.reshape(x.shape[0], -1, x.shape[-1]).to(dt)
            y = flat @ self.kernel.to(dt)
            if self.bias is not None:
                y = y + self.bias.to(dt)[:, None]
            return y.reshape(y.shape[:1] + x.shape[1:-1] + y.shape[-1:])
        y = x.to(dt) @ self.kernel.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class ForecastHead(nn.Module):
    """MLP head over pooled features (``lfm_quant_tpu/models/heads.py``).

    Hidden layers run in the compute dtype with tanh-approximate GELU (the
    default of Flax's ``nn.gelu``); the ``out`` layer and the result are
    f32. A heteroscedastic head returns ``(mean, log_var)`` with
    ``log_var`` soft-clamped to ``8 tanh(v / 8)``. ``n_seeds``: every
    layer seed-stacked (see :class:`Dense`), the input ``[S, ..., in]``.
    """

    def __init__(self, in_features: int, hidden: Sequence[int] = (),
                 heteroscedastic: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 n_seeds: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        self.heteroscedastic = heteroscedastic
        dims = [in_features, *hidden]
        self.hidden = nn.ModuleList(
            Dense(dims[i], dims[i + 1], n_seeds=n_seeds)
            for i in range(len(hidden)))
        self.out = Dense(dims[-1], 2 if heteroscedastic else 1,
                         n_seeds=n_seeds)

    def forward(self, z: torch.Tensor):
        for layer in self.hidden:
            z = F.gelu(layer(z, dtype=self.dtype), approximate="tanh")
        y = self.out(z, dtype=torch.float32)
        if self.heteroscedastic:
            return y[..., 0], 8.0 * torch.tanh(y[..., 1] / 8.0)
        return y[..., 0]
