"""Transformer-encoder factor model: the port of
``lfm_quant_tpu/models/transformer.py`` (``EncoderBlock``,
``TransformerModel``) in its plain, one-device mode.

Each month of the lookback window is a token: ``embed`` → ``+ pos_emb``
→ ``depth`` pre-norm blocks (LayerNorm → masked self-attention →
residual; LayerNorm → GELU MLP → residual) → ``ln_f`` → the mean over the
valid months → the forecast head. Attention is written out as Flax's
``MultiHeadDotProductAttention`` computes it (``flax/linen/attention.py``):
the query divided by ``sqrt(head_dim)`` in the compute dtype before the
product, invalid keys filled with ``finfo(dtype).min`` (so a window with
no valid month attends uniformly instead of giving NaN, and the pooling
zeroes it), the softmax in the compute dtype, and attention dropout with
one mask ``[1, 1, Wq, Wk]`` shared over the batch and the heads.
``scaled_dot_product_attention`` is not used: its all-masked rows give
NaN and its rounding points are not Flax's.

Long-context mode (``seq_axis="seq"``, the JAX ``RingSelfAttention`` and
the ``seq_axis`` branches of ``EncoderBlock`` and ``TransformerModel``):
the model runs on this seq rank's block of the window inside
``parallel/ring.py bind_seq_axis``. Attention is ``ring_attention`` (K/V
blocks rotating over the seq group, an online softmax in f32, unlike the
plain mode's softmax in the compute dtype), the position table stays
``[window, dim]`` (the params equal the plain model's, so a checkpoint of
either mode loads into the other) and each rank adds its slice from
``rank·Wl``, and the pooling sums ``num`` and ``den`` over the group.
Dropout under a seq axis raises, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from lfm_quant_tpu_torch.models.heads import (
    Dense,
    ForecastHead,
    LayerNorm,
    Rng,
    dense_apply,
    gelu,
    keep_mask,
    masked_mean_pool,
    seed_view,
)
from lfm_quant_tpu_torch.parallel import ring


class DenseGeneral(nn.Module):
    """Flax ``nn.DenseGeneral`` from the trailing ``in_axes`` of the input
    to ``out_axes``: ``kernel [*in_axes, *out_axes]`` and ``bias
    [*out_axes]``, each with a leading seed axis under ``n_seeds``; the
    product is :class:`Dense`'s over the flattened axes."""

    def __init__(self, in_axes: Sequence[int], out_axes: Sequence[int],
                 n_seeds: Optional[int] = None):
        super().__init__()
        lead = () if n_seeds is None else (n_seeds,)
        self.in_axes, self.out_axes = tuple(in_axes), tuple(out_axes)
        self.kernel = nn.Parameter(torch.zeros(*lead, *in_axes, *out_axes))
        self.bias = nn.Parameter(torch.zeros(*lead, *out_axes))

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        lead = self.kernel.shape[:self.kernel.dim() - len(self.in_axes)
                                 - len(self.out_axes)]
        n_in, n_out = math.prod(self.in_axes), math.prod(self.out_axes)
        flat = x.reshape(x.shape[:x.dim() - len(self.in_axes)] + (n_in,))
        y = dense_apply(flat, self.kernel.reshape(lead + (n_in, n_out)),
                        self.bias.reshape(lead + (n_out,)), dtype)
        return y.reshape(y.shape[:-1] + self.out_axes)


class SelfAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` over one sequence, with a
    key-padding mask: params ``query``/``key``/``value`` (``[dim, heads,
    head_dim]`` kernels) and ``out`` (``[heads, head_dim, dim]``)."""

    def __init__(self, dim: int, heads: int, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None,
                 n_seeds: Optional[int] = None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by {heads} heads")
        self.heads, self.head_dim = heads, dim // heads
        self.dropout = float(dropout)
        self.dtype = dtype
        qkv = (dim,), (heads, self.head_dim)
        self.query = DenseGeneral(*qkv, n_seeds=n_seeds)
        self.key = DenseGeneral(*qkv, n_seeds=n_seeds)
        self.value = DenseGeneral(*qkv, n_seeds=n_seeds)
        self.out = DenseGeneral((heads, self.head_dim), (dim,),
                                n_seeds=n_seeds)

    def forward(self, y: torch.Tensor, m: torch.Tensor,
                rng: Rng = None, mesh=None) -> torch.Tensor:
        """``y [..., W, dim]``, ``m [..., W]`` (True: a valid key) →
        ``[..., W, dim]``. ``mesh``: the seq rank's block of the window,
        attended by ``ring_attention`` over its seq group (JAX
        ``RingSelfAttention``)."""
        q, k, v = (p(y, dtype=self.dtype)
                   for p in (self.query, self.key, self.value))
        if mesh is not None:
            # [..., Wl, H, Dh] → [..., H, Wl, Dh] and back.
            o = ring.ring_attention(*(t.transpose(-3, -2) for t in (q, k, v)),
                                    m, mesh)
            return self.out(o.transpose(-3, -2), dtype=self.dtype)
        dt = q.dtype
        q = q / torch.tensor(math.sqrt(self.head_dim), dtype=dt)
        scores = torch.einsum("...qhd,...khd->...hqk", q, k)
        scores = scores.masked_fill(~m[..., None, None, :],
                                    torch.finfo(dt).min)
        w = torch.softmax(scores, dim=-1)
        if rng is not None and self.dropout > 0.0:
            # One mask over (query, key), shared by the batch and heads.
            seeded = self.query.kernel.dim() == 4
            shape = ((q.shape[0],) if seeded else ()) + (1, 1) + \
                w.shape[-2:]
            keep = keep_mask(rng, self.dropout, shape, w.device)
            w = w * (keep.to(dt) / torch.tensor(1.0 - self.dropout,
                                                dtype=dt))
        o = torch.einsum("...hqk,...khd->...qhd", w, v)
        return self.out(o, dtype=self.dtype)


class EncoderBlock(nn.Module):
    """Pre-norm encoder block: ``z + attn(ln1(z))``, then ``z +
    mlp_out(gelu(mlp_in(ln2(z))))``."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None,
                 n_seeds: Optional[int] = None):
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(dim, dtype=dtype, n_seeds=n_seeds)
        self.attn = SelfAttention(dim, heads, dropout=dropout, dtype=dtype,
                                  n_seeds=n_seeds)
        self.ln2 = LayerNorm(dim, dtype=dtype, n_seeds=n_seeds)
        self.mlp_in = Dense(dim, dim * mlp_ratio, n_seeds=n_seeds)
        self.mlp_out = Dense(dim * mlp_ratio, dim, n_seeds=n_seeds)

    def forward(self, z: torch.Tensor, m: torch.Tensor,
                rng: Rng = None, mesh=None) -> torch.Tensor:
        z = z + self.attn(self.ln1(z), m, rng, mesh)
        y = gelu(self.mlp_in(self.ln2(z), dtype=self.dtype))
        return z + self.mlp_out(y, dtype=self.dtype)


class TransformerModel(nn.Module):
    """Pre-norm encoder over month tokens with masked mean pooling.

    ``forward(x [B, W, F], m [B, W], rng=None)`` → ``[B]`` f32 forecasts,
    or ``(mean, log_var)``; ``rng`` (a generator, or one per seed) turns
    attention dropout on. The position table is ``[window, dim]``, so the
    window length is an argument. ``n_seeds=S``: every param
    seed-stacked, the input ``[S, B, W, F]`` (or shared), the output
    ``[S, B]``. ``seq_axis``: the long-context mode (see the module
    docstring): ``x [..., Wl, F]`` is the seq rank's block of a window of
    ``window = n_seq · Wl`` months, and every rank of the group returns
    the same forecasts."""

    def __init__(self, n_features: int, window: int, dim: int = 64,
                 depth: int = 2, heads: int = 4, mlp_ratio: int = 4,
                 head_hidden: Sequence[int] = (),
                 heteroscedastic: bool = False, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None,
                 seq_axis: Optional[str] = None,
                 n_seeds: Optional[int] = None):
        super().__init__()
        if seq_axis is not None and dropout > 0.0:
            raise ValueError(
                "dropout is not implemented for the sequence-parallel "
                "encoder (RingSelfAttention) — it would silently train "
                "differently from the plain mode; set dropout=0.0 with "
                "seq_axis")
        lead = () if n_seeds is None else (n_seeds,)
        self.seq_axis = seq_axis
        self.dtype = dtype
        self.heads = heads
        self.dim, self.mlp_ratio = dim, mlp_ratio
        self.embed = Dense(n_features, dim, n_seeds=n_seeds)
        self.pos_emb = nn.Parameter(torch.zeros(*lead, window, dim))
        self.blocks = nn.ModuleList(
            EncoderBlock(dim, heads, mlp_ratio, dropout, dtype, n_seeds)
            for _ in range(depth))
        self.ln_f = LayerNorm(dim, dtype=dtype, n_seeds=n_seeds)
        self.head = ForecastHead(dim, head_hidden,
                                 heteroscedastic=heteroscedastic,
                                 dtype=dtype, n_seeds=n_seeds)

    def row_state_bytes(self, window: int) -> int:
        """Bytes of one window row's largest activation (the sweep's seed
        chunking): the attention scores or the MLP's hidden layer."""
        size = torch.finfo(self.dtype or torch.float32).bits // 8
        return size * max(self.heads * window * window,
                          window * self.dim * self.mlp_ratio)

    def forward(self, x: torch.Tensor, m: torch.Tensor, rng: Rng = None):
        if self.pos_emb.dim() == 3:
            x = x[None] if x.dim() == 3 else x
            m = m[None] if m.dim() == 2 else m
        mesh = None if self.seq_axis is None else ring.seq_axis(self.seq_axis)
        z = self.embed(x.to(self.dtype or torch.float32), dtype=self.dtype)
        pos = self.pos_emb
        if mesh is not None:
            w = x.shape[-2]  # the local window
            if w * mesh.n_seq != pos.shape[-2]:
                raise ValueError(
                    f"{mesh.n_seq} seq ranks of {w} months do not make the "
                    f"model's window of {pos.shape[-2]}")
            pos = pos.narrow(-2, mesh.seq_rank * w, w)
        z = z + seed_view(pos, z.dim(), 2).to(z.dtype)
        for block in self.blocks:
            z = block(z, m, rng, mesh)
        z = self.ln_f(z)
        if mesh is None:
            return self.head(masked_mean_pool(z, m))
        mf = m.to(z.dtype)[..., None]
        num = ring.seq_sum((z * mf).sum(dim=-2), mesh)
        den = ring.seq_sum(mf.sum(dim=-2), mesh)
        return ring.replicated(self.head(num / torch.clamp(den, min=1.0)),
                               mesh)
