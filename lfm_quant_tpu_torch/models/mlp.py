"""Feed-forward factor model: the port of ``lfm_quant_tpu/models/mlp.py``
``MLPModel``.

The masked window flattened to ``W*F`` inputs (masked steps contribute
zeros) plus the window's valid fraction, so the net can tell a zero
feature from a missing month; ``window_input=False`` reads the anchor
month's features alone. Hidden layers in the compute dtype with tanh
GELU, each followed by dropout; the forecast head's ``out`` layer in f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from lfm_quant_tpu_torch.models.heads import (
    Dense,
    ForecastHead,
    Rng,
    dropout,
    gelu,
)


class MLPModel(nn.Module):
    """``forward(x [B, W, F], m [B, W], rng=None)`` → ``[B]`` f32
    forecasts, or ``(mean, log_var)`` for a heteroscedastic head; ``rng``
    (a generator, or one per seed) turns dropout on. Unlike Flax, the
    first layer's width is fixed up front, so the window length is an
    argument. ``n_seeds=S``: every param seed-stacked, the input ``[S, B,
    W, F]`` (or shared ``[B, W, F]``), the output ``[S, B]``."""

    def __init__(self, n_features: int, window: int,
                 hidden: Sequence[int] = (64, 32), window_input: bool = True,
                 heteroscedastic: bool = False, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None,
                 n_seeds: Optional[int] = None):
        super().__init__()
        self.window = window
        self.window_input = window_input
        self.dropout = float(dropout)
        self.dtype = dtype
        dims = [window * n_features + 1 if window_input else n_features,
                *hidden]
        self.in_dim = dims[0]
        self.dense = nn.ModuleList(
            Dense(dims[i], dims[i + 1], n_seeds=n_seeds)
            for i in range(len(hidden)))
        self.head = ForecastHead(dims[-1], heteroscedastic=heteroscedastic,
                                 dtype=dtype, n_seeds=n_seeds)

    def row_state_bytes(self, window: int) -> int:
        """Bytes of one window row's largest activation (the sweep's seed
        chunking): the flattened input, in f32."""
        return 4 * self.in_dim

    def forward(self, x: torch.Tensor, m: torch.Tensor, rng: Rng = None):
        if self.head.out.kernel.dim() == 3:
            x = x[None] if x.dim() == 3 else x
            m = m[None] if m.dim() == 2 else m
        x = x.to(self.dtype) if self.dtype is not None else x
        mf = m.to(x.dtype)
        if self.window_input:
            z = (x * mf[..., None]).reshape(*x.shape[:-2], -1)
            frac = mf.mean(dim=-1, keepdim=True)
            z = torch.cat([z, frac], dim=-1)
        else:
            z = x[..., -1, :] * mf[..., -1:]
        for layer in self.dense:
            z = dropout(gelu(layer(z, dtype=self.dtype)), self.dropout, rng)
        return self.head(z)
