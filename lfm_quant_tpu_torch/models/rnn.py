"""Recurrent factor model: the port of ``lfm_quant_tpu/models/rnn.py``
``RNNModel`` on its fused branch (``scan_impl="pallas_fused"``).

embed (F → H) → per layer the fused masked recurrence → the last step →
the forecast head. Params are f32 in Flax's layout; compute runs in
``dtype`` (bf16 for the c2 preset) with the rounding points of the JAX
model: the embed output, the recurrence's weights and bias and its
stored states are in the compute dtype, the head's ``out`` layer in f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from lfm_quant_tpu_torch.models.heads import Dense, ForecastHead
from lfm_quant_tpu_torch.ops.rnn import (
    _GATES,
    rnn_scan_fused,
    rnn_scan_fused_reference,
)


class RNNModel(nn.Module):
    """Stacked masked LSTM/GRU over the lookback window → forecast head.

    ``scan_impl``: "fused" runs ``ops/rnn.py rnn_scan_fused`` (the kernel
    on the card); "plain" runs its plain version on any device.
    ``forward`` takes ``x [B, W, F]`` and ``m [B, W]`` and returns
    ``[B]`` f32 forecasts, or ``(mean, log_var)`` for a heteroscedastic
    head. It is inference only: call it under ``torch.no_grad()``.
    """

    def __init__(self, n_features: int, cell: str = "lstm",
                 hidden: int = 128, layers: int = 1,
                 head_hidden: Sequence[int] = (),
                 heteroscedastic: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 scan_impl: str = "fused",
                 factor_rank: Optional[int] = None, n_groups: int = 1):
        super().__init__()
        if cell not in _GATES:
            raise ValueError(f"cell must be one of {sorted(_GATES)}")
        if scan_impl not in ("fused", "plain"):
            raise ValueError(
                f"scan_impl must be 'fused' or 'plain', got {scan_impl!r}")
        if factor_rank or n_groups > 1:
            raise NotImplementedError(
                "factor_rank / n_groups (the factorized recurrences) are not "
                "ported yet: ROADMAP.md Queue A, training-side layers")
        self.cell = cell
        self.hidden = hidden
        self.layers = layers
        self.dtype = dtype
        self.scan_impl = scan_impl
        gh = _GATES[cell] * hidden
        self.embed = Dense(n_features, hidden)
        self.xproj = nn.ModuleList(Dense(hidden, gh) for _ in range(layers))
        self.h_proj = nn.ParameterList(
            nn.Parameter(torch.zeros(hidden, gh)) for _ in range(layers))
        self.head = ForecastHead(hidden, head_hidden,
                                 heteroscedastic=heteroscedastic,
                                 dtype=dtype)

    def forward(self, x: torch.Tensor, m: torch.Tensor):
        cd = self.dtype or torch.float32
        h = self.embed(x.to(cd), dtype=self.dtype)
        scan = (rnn_scan_fused if self.scan_impl == "fused"
                else rnn_scan_fused_reference)
        for layer in range(self.layers):
            h = scan(self.cell, h, self.xproj[layer].kernel.to(cd),
                     self.xproj[layer].bias.to(cd),
                     self.h_proj[layer].to(cd), m)
        # Masked steps held state, so the last step is the state at the
        # last valid month.
        return self.head(h[:, -1, :])
