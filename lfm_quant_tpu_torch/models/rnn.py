"""Recurrent factor model: the port of ``lfm_quant_tpu/models/rnn.py``
``RNNModel`` on its Pallas branches (``scan_impl="pallas_fused"`` and
``"pallas"``).

embed (F → H) → per layer the masked recurrence → the last step → the
forecast head. Params are f32 in Flax's layout, one tree for every
branch; compute runs in ``dtype`` (bf16 for the c2 preset) with the
rounding points of the JAX model: the embed output, the recurrence's
weights and bias (or its hoisted projection) and its stored states are in
the compute dtype, the head's ``out`` layer in f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from lfm_quant_tpu_torch.models.heads import Dense, ForecastHead
from lfm_quant_tpu_torch.ops.rnn import (
    _GATES,
    rnn_scan,
    rnn_scan_fused,
    rnn_scan_fused_reference,
)

SCAN_IMPLS = ("fused", "hoisted", "plain")


class RNNModel(nn.Module):
    """Stacked masked LSTM/GRU over the lookback window → forecast head.

    ``scan_impl``: "fused" runs ``ops/rnn.py rnn_scan_fused`` (the
    kernels on the card); "hoisted" computes the gate input projection
    ``xproj`` over all steps as one product and runs ``rnn_scan`` on it
    (the JAX ``scan_impl="pallas"`` branch); "plain" runs the fused op's
    plain version on any device, differentiated by autograd.
    ``forward`` takes ``x [B, W, F]`` and ``m [B, W]`` and returns
    ``[B]`` f32 forecasts, or ``(mean, log_var)`` for a heteroscedastic
    head.
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
        if scan_impl not in SCAN_IMPLS:
            raise ValueError(
                f"scan_impl must be one of {SCAN_IMPLS}, got {scan_impl!r}")
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
            wh = self.h_proj[layer].to(cd)
            if self.scan_impl == "hoisted":
                xw = self.xproj[layer](h, dtype=self.dtype)
                h = rnn_scan(self.cell, xw, wh, m)
                continue
            h = scan(self.cell, h, self.xproj[layer].kernel.to(cd),
                     self.xproj[layer].bias.to(cd), wh, m)
        # Masked steps held state, so the last step is the state at the
        # last valid month.
        return self.head(h[:, -1, :])
