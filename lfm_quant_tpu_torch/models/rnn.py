"""Recurrent factor model: the port of ``lfm_quant_tpu/models/rnn.py``
``RNNModel`` on its Pallas branches (``scan_impl="pallas_fused"`` and
``"pallas"``) and its XLA scan, with the factorized recurrences
(``LowRankDense``, ``GroupedDense``).

embed (F → H) → per layer the masked recurrence → the last step → the
forecast head. Params are f32 in Flax's layout, one tree for every
branch; compute runs in ``dtype`` (bf16 for the c2 preset) with the
rounding points of the JAX model: the embed output, the recurrence's
weights and bias (or its hoisted projection) and its stored states are in
the compute dtype, the head's ``out`` layer in f32.

``factor_rank`` (F-LSTM: ``W ≈ U V``) and ``n_groups`` (G-LSTM:
block-diagonal, gates in GROUP-MAJOR order) factor both the hoisted input
projection and the recurrent one. JAX runs them on the XLA scan only; so
does the port: ``scan_impl="loop"``, a loop over the window that carries
h (and c) in the compute dtype as the XLA scan does (the kernels carry
f32), chosen for factored models by ``config.model_kwargs``. No kernel is
launched for the recurrence; the gather still runs on its kernel.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
from torch import nn

from lfm_quant_tpu_torch.models.heads import Dense, ForecastHead
from lfm_quant_tpu_torch.ops.rnn import (
    _GATES,
    _mma_route,
    _padded_width,
    rnn_scan,
    rnn_scan_fused,
    rnn_scan_fused_reference,
)

SCAN_IMPLS = ("fused", "hoisted", "plain", "loop")
FORGET_BIAS = 1.0  # the JAX LSTMRecurrence's default


class LowRankDense(nn.Module):
    """``W ≈ U V`` (JAX ``LowRankDense``, ``models/rnn.py:35``): ``u``
    (``in → rank``, no bias) then ``v`` (``rank → features``), params
    ``u/kernel``, ``v/kernel`` and ``v/bias``."""

    def __init__(self, in_features: int, features: int, rank: int,
                 use_bias: bool = True, n_seeds: Optional[int] = None):
        super().__init__()
        self.u = Dense(in_features, rank, use_bias=False, n_seeds=n_seeds)
        self.v = Dense(rank, features, use_bias=use_bias, n_seeds=n_seeds)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return self.v(self.u(x, dtype=dtype), dtype=dtype)


class GroupedDense(nn.Module):
    """Block-diagonal projection (JAX ``GroupedDense``,
    ``models/rnn.py:54``): the feature axis splits into ``n_groups``
    slices, each with its own kernel: ``kernel [g, in/g, out/g]`` and
    ``bias [g, out/g]`` (a leading seed axis under ``n_seeds``); the
    output stays group-major. Computed in ``dtype``, default the input's
    (Flax's rule here, unlike :class:`Dense`'s promotion)."""

    def __init__(self, in_features: int, features: int, n_groups: int,
                 use_bias: bool = True, n_seeds: Optional[int] = None):
        super().__init__()
        lead = () if n_seeds is None else (n_seeds,)
        g = self.n_groups = n_groups
        self.features = features
        self.kernel = nn.Parameter(torch.zeros(*lead, g, in_features // g,
                                               features // g))
        self.bias = (nn.Parameter(torch.zeros(*lead, g, features // g))
                     if use_bias else None)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        g = self.n_groups
        dt = dtype or x.dtype
        xg = x.reshape(x.shape[:-1] + (g, x.shape[-1] // g)).to(dt)
        k = self.kernel.to(dt)
        if k.dim() == 4:
            # Seed-stacked: [S or 1, ..., g, i] against [S, g, i, o].
            flat = xg.reshape(xg.shape[0], -1, *xg.shape[-2:]).expand(
                k.shape[0], -1, -1, -1)
            y = torch.einsum("sngi,sgio->sngo", flat, k)
            if self.bias is not None:
                y = y + self.bias.to(dt)[:, None]
            y = y.reshape(y.shape[:1] + x.shape[1:-1] + (self.features,))
            return y
        y = torch.einsum("...gi,gio->...go", xg, k)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y.reshape(x.shape[:-1] + (self.features,))


def _proj(in_features: int, features: int, factor_rank: Optional[int],
          n_groups: int, use_bias: bool, n_seeds: Optional[int]):
    """A factored projection (JAX ``_proj``): low-rank or grouped."""
    if factor_rank:
        return LowRankDense(in_features, features, factor_rank,
                            use_bias=use_bias, n_seeds=n_seeds)
    return GroupedDense(in_features, features, n_groups, use_bias=use_bias,
                        n_seeds=n_seeds)


def _split_gates(gates: torch.Tensor, n_gates: int, n_groups: int):
    """Gate slices of a projection's output (JAX ``_split_gates``):
    grouped layouts are group-major, ``[..., g, n_gates, H/g]``."""
    if n_groups == 1:
        return gates.chunk(n_gates, dim=-1)
    lead = gates.shape[:-1]
    gg = gates.reshape(lead + (n_groups, n_gates, -1))
    return [gg[..., i, :].reshape(lead + (-1,)) for i in range(n_gates)]


class RNNModel(nn.Module):
    """Stacked masked LSTM/GRU over the lookback window → forecast head.

    ``scan_impl``: "fused" runs ``ops/rnn.py rnn_scan_fused`` (the
    kernels on the card); "hoisted" computes the gate input projection
    ``xproj`` over all steps as one product and runs ``rnn_scan`` on it
    (the JAX ``scan_impl="pallas"`` branch); "plain" runs the fused op's
    plain version on any device, differentiated by autograd; "loop" is
    the JAX XLA scan (h carried in the compute dtype), the one route of a
    factored model (``factor_rank`` or ``n_groups``: see the module
    docstring).
    ``forward`` takes ``x [B, W, F]`` and ``m [B, W]`` and returns
    ``[B]`` f32 forecasts, or ``(mean, log_var)`` for a heteroscedastic
    head.

    ``n_seeds=S``: S members stacked on a leading seed axis of every
    param (the JAX ensemble's ``vmap``, written out). ``forward`` then
    takes ``x [S, B, W, F]`` (or ``[B, W, F]`` that every seed shares) and
    ``m [S, B, W]`` or ``[B, W]``, and returns ``[S, B]``; the recurrence
    runs every seed in one kernel launch. The seed count is read from the
    params, so a block of seeds' params serves as well.
    """

    def __init__(self, n_features: int, cell: str = "lstm",
                 hidden: int = 128, layers: int = 1,
                 head_hidden: Sequence[int] = (),
                 heteroscedastic: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 scan_impl: str = "fused",
                 factor_rank: Optional[int] = None, n_groups: int = 1,
                 n_seeds: Optional[int] = None):
        super().__init__()
        if cell not in _GATES:
            raise ValueError(f"cell must be one of {sorted(_GATES)}")
        if scan_impl not in SCAN_IMPLS:
            raise ValueError(
                f"scan_impl must be one of {SCAN_IMPLS}, got {scan_impl!r}")
        factored = bool(factor_rank) or n_groups > 1
        if n_groups < 1:
            raise ValueError(f"n_groups must be >= 1, got {n_groups}")
        if factor_rank is not None and factor_rank < 1:
            raise ValueError(f"factor_rank must be >= 1, got {factor_rank}")
        if factor_rank and n_groups > 1:
            raise ValueError(
                "factor_rank and n_groups are alternative factorizations "
                "— set at most one")
        if n_groups > 1 and hidden % n_groups:
            raise ValueError(f"hidden={hidden} must divide evenly into "
                             f"n_groups={n_groups}")
        if factored != (scan_impl == "loop"):
            if not factored:
                raise ValueError(
                    "scan_impl='loop' is the factorized recurrences' route "
                    "(factor_rank or n_groups); a dense model takes "
                    "'fused', 'hoisted' or 'plain'")
            raise ValueError(
                "factor_rank/n_groups need scan_impl='xla': the recurrence "
                "kernels assume dense gate weights (config auto-resolution "
                "routes factorized models to the XLA scan, here 'loop'; "
                "don't force a kernel impl on one)")
        self.factored = factored
        self.n_groups = n_groups
        self.cell = cell
        self.hidden = hidden
        self.layers = layers
        self.dtype = dtype
        self.scan_impl = scan_impl
        gh = _GATES[cell] * hidden
        lead = () if n_seeds is None else (n_seeds,)
        self.embed = Dense(n_features, hidden, n_seeds=n_seeds)
        if factored:
            self.xproj = nn.ModuleList(
                _proj(hidden, gh, factor_rank, n_groups, True, n_seeds)
                for _ in range(layers))
            self.h_proj = nn.ModuleList(
                _proj(hidden, gh, factor_rank, n_groups, False, n_seeds)
                for _ in range(layers))
        else:
            self.xproj = nn.ModuleList(Dense(hidden, gh, n_seeds=n_seeds)
                                       for _ in range(layers))
            self.h_proj = nn.ParameterList(
                nn.Parameter(torch.zeros(*lead, hidden, gh))
                for _ in range(layers))
        self.head = ForecastHead(hidden, head_hidden,
                                 heteroscedastic=heteroscedastic,
                                 dtype=dtype, n_seeds=n_seeds)

    def row_state_bytes(self, window: int) -> int:
        """Bytes of one window row's recurrence states in the compute
        dtype (the sweep's seed chunking), and, where the fused forward
        keeps an f32 xw scratch ``[W, G Hp]`` per row (the float32 forwards
        on the 3xTF32 and grid kernels, Hp <= 1024; the bf16 ones on the
        cluster and grid kernels, Hp 144-1520), that scratch."""
        cd = self.dtype or torch.float32
        nbytes = window * self.hidden * (torch.finfo(cd).bits // 8)
        if (self.scan_impl == "fused" and _mma_route(cd, self.hidden)
                in ("tf32", "cluster", "grid")):
            nbytes += window * _GATES[self.cell] * _padded_width(
                self.hidden) * 4
        return nbytes

    def forward(self, x: torch.Tensor, m: torch.Tensor, rng=None):
        # ``rng``: the shared model signature; the recurrent models have
        # no dropout.
        cd = self.dtype or torch.float32
        if self.embed.kernel.dim() == 3:
            # Seed-stacked: an input without the seed axis is shared.
            x = x[None] if x.dim() == 3 else x
            m = m[None] if m.dim() == 2 else m
        h = self.embed(x.to(cd), dtype=self.dtype)
        scan = (rnn_scan_fused if self.scan_impl == "fused"
                else rnn_scan_fused_reference)
        for layer in range(self.layers):
            if self.scan_impl == "loop":
                h = self._loop(layer, h, m)
                continue
            wh = self.h_proj[layer].to(cd)
            if self.scan_impl == "hoisted":
                xw = self.xproj[layer](h, dtype=self.dtype)
                h = rnn_scan(self.cell, xw, wh, m)
                continue
            h = scan(self.cell, h, self.xproj[layer].kernel.to(cd),
                     self.xproj[layer].bias.to(cd), wh, m)
        # Masked steps held state, so the last step is the state at the
        # last valid month.
        return self.head(h[..., -1, :])

    def _loop(self, layer: int, h: torch.Tensor, m: torch.Tensor
              ) -> torch.Tensor:
        """One layer as the JAX XLA scan runs it (``LSTMRecurrence`` /
        ``GRURecurrence`` under ``nn.scan``): the hoisted input projection
        over all steps, then per step the recurrent projection and the
        gates in the compute dtype; an invalid month holds h (and c)."""
        cd = self.dtype or torch.float32
        xw = self.xproj[layer](h, dtype=self.dtype)
        rec = functools.partial(self.h_proj[layer], dtype=self.dtype)
        g = self.n_groups
        state = torch.zeros(h.shape[:-2] + (self.hidden,), dtype=cd,
                            device=h.device)
        c = state
        keep_all = m.to(cd)[..., None]
        outs = []
        for xw_t, keep in zip(xw.unbind(-2), keep_all.unbind(-2)):
            if self.cell == "lstm":
                i, f, gg, o = _split_gates(xw_t.to(cd) + rec(state), 4, g)
                c_new = (torch.sigmoid(f + FORGET_BIAS) * c
                         + torch.sigmoid(i) * torch.tanh(gg))
                h_new = torch.sigmoid(o) * torch.tanh(c_new)
                c = keep * c_new + (1.0 - keep) * c
            else:
                xz, xr, xn = _split_gates(xw_t.to(cd), 3, g)
                hz, hr, hn = _split_gates(rec(state), 3, g)
                z = torch.sigmoid(xz + hz)
                r = torch.sigmoid(xr + hr)
                n = torch.tanh(xn + r * hn)
                h_new = (1.0 - z) * n + z * state
            state = keep * h_new + (1.0 - keep) * state
            outs.append(state)
        return torch.stack(outs, dim=-2)
