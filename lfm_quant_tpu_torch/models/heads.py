"""Dense layers in Flax's layout, the shared forecast head, and the
pieces the MLP, transformer and LRU share (masked mean pooling, Flax's
LayerNorm, tanh GELU, dropout on an explicit generator), each with an
optional leading seed axis (the seed ensemble: S independent members
whose per-seed products are batched matrix products)."""

from __future__ import annotations

from typing import Optional, Sequence, Union

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
        return dense_apply(x, self.kernel, self.bias, dtype)


def ordered_dense(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``x [..., K] @ kernel [K, N] + bias`` in f32, each output summed
    over K in one fixed order (pairwise halving, then the odd remainder)
    by elementwise ops, so a row's result is the same bits whatever the
    other rows of the call: a matrix product's algorithm, and with it its
    summation order, may change with the row count."""
    p = x.float()[..., :, None] * kernel.float()  # [..., K, N] products
    while p.shape[-2] > 1:
        k = p.shape[-2]
        h = k // 2
        s = p[..., :h, :] + p[..., h:2 * h, :]
        p = torch.cat([s, p[..., 2 * h:, :]], dim=-2) if k % 2 else s
    y = p[..., 0, :]
    return y if bias is None else y + bias.float()


def dense_apply(x: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor],
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:class:`Dense`'s product: ``kernel [in, out]`` or seed-stacked
    ``[S, in, out]`` (then ``x [S or 1, ..., in]``), ``bias [(S,) out]``
    or None, in ``dtype`` (default: the promotion of ``x``'s type and
    the kernel's)."""
    dt = dtype or torch.promote_types(x.dtype, kernel.dtype)
    if kernel.dim() == 3:
        # [S or 1, N, in] @ [S, in, out]: one batched product.
        flat = x.reshape(x.shape[0], -1, x.shape[-1]).to(dt)
        y = flat @ kernel.to(dt)
        if bias is not None:
            y = y + bias.to(dt)[:, None]
        return y.reshape(y.shape[:1] + x.shape[1:-1] + y.shape[-1:])
    y = x.to(dt) @ kernel.to(dt)
    if bias is not None:
        y = y + bias.to(dt)
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
            z = gelu(layer(z, dtype=self.dtype))
        if torch.is_grad_enabled() or self.out.kernel.dim() == 3:
            y = self.out(z, dtype=torch.float32)
        else:
            # Inference (served scores, their publish-time probe, sweeps,
            # predicts): each row's output must not depend on how many
            # rows share the call, and cuBLAS's f32 product picks its
            # algorithm by the row count (ROADMAP.md Queue C).
            y = ordered_dense(z, self.out.kernel, self.out.bias)
        if self.heteroscedastic:
            return y[..., 0], 8.0 * torch.tanh(y[..., 1] / 8.0)
        return y[..., 0]


# ---------------------------------------------------------------------------
# Pieces the MLP, the transformer and the LRU share
# ---------------------------------------------------------------------------


def seed_view(p: torch.Tensor, ndim: int, n_feature: int = 1) -> torch.Tensor:
    """A param with ``n_feature`` trailing feature axes, seed-stacked
    (``[S, *feature]``) or not, viewed for broadcasting against an
    ``ndim``-dimensional input whose seed axis (if any) leads: the batch
    axes between become 1."""
    lead = p.dim() - n_feature  # 0, or 1 for the seed axis
    if lead == 0:
        return p
    return p.reshape(p.shape[:1] + (1,) * (ndim - 1 - n_feature)
                     + p.shape[1:])


def masked_mean_pool(z: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Mean over the valid steps (``models/heads.py masked_mean_pool``):
    ``z [..., W, D]``, ``m [..., W]`` → ``[..., D]`` in ``z``'s dtype; the
    denominator is at least 1, so a window with no valid step pools to
    zeros."""
    mf = m.to(z.dtype)[..., None]
    denom = torch.clamp(mf.sum(dim=-2), min=1.0)
    return (z * mf).sum(dim=-2) / denom


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6; the
    statistics in f32 with the fast variance ``E[x²] − E[x]²`` (clipped at
    0); ``(x − mean) · rsqrt(var + eps) · scale + bias`` in f32, cast to
    ``dtype`` (default: f32, the promotion of the f32 params). Params
    ``scale`` (ones) and ``bias`` (zeros), seed-stacked with ``n_seeds``
    (the input's seed axis leads)."""

    EPS = 1e-6

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None,
                 n_seeds: Optional[int] = None):
        super().__init__()
        lead = () if n_seeds is None else (n_seeds,)
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(*lead, features))
        self.bias = nn.Parameter(torch.zeros(*lead, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.EPS) * seed_view(self.scale, x.dim())
        y = (xf - mean) * mul + seed_view(self.bias, x.dim())
        return y.to(self.dtype or torch.float32)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Flax's ``nn.gelu``: the tanh approximation (``F.gelu``'s default
    is the erf form)."""
    return F.gelu(x, approximate="tanh")


#: What a model's ``rng`` argument may be: None (dropout off), one
#: generator (a one-seed model), or one per seed of a seed-stacked model.
Rng = Union[None, torch.Generator, Sequence[torch.Generator]]


def keep_mask(rng: Rng, rate: float, shape: Sequence[int],
              device: torch.device) -> torch.Tensor:
    """Dropout's keep mask, True with probability ``1 - rate``, drawn as
    ``torch.rand(shape, generator=g) < 1 - rate``. With one generator per
    seed (a sequence), each seed's ``shape[1:]`` mask comes from its own
    generator and the masks stack on the leading axis, so a seed's draws
    do not depend on which other seeds run beside it."""
    keep = 1.0 - rate
    if isinstance(rng, torch.Generator):
        return torch.rand(tuple(shape), generator=rng, device=device) < keep
    return torch.stack([torch.rand(tuple(shape[1:]), generator=g,
                                   device=device) < keep for g in rng])


def dropout(x: torch.Tensor, rate: float, rng: Rng) -> torch.Tensor:
    """Flax ``nn.Dropout``: ``x / keep`` where the mask keeps, else 0;
    the identity when ``rng`` is None or ``rate`` is 0 (deterministic).
    A seed-stacked ``x`` (leading seed axis) takes one generator per
    seed."""
    if rng is None or rate <= 0.0:
        return x
    keep = keep_mask(rng, rate, x.shape, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
