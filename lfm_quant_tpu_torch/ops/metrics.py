"""Evaluation metrics: exact per-month information coefficients, the port
of ``lfm_quant_tpu/ops/metrics.py``. Inputs below f32 are promoted before
any reduction: ICs and ranks drive early-stopping decisions."""

from __future__ import annotations

import torch

from lfm_quant_tpu_torch.ops.losses import _acc


def _masked_pearson(a, b, w):
    a, b = _acc(a), _acc(b)
    w = w.to(a.dtype)
    denom = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-12)
    ma = (a * w).sum(dim=-1, keepdim=True) / denom
    mb = (b * w).sum(dim=-1, keepdim=True) / denom
    ac, bc = (a - ma) * w, (b - mb) * w
    cov = (ac * bc).sum(dim=-1)
    va = (ac * ac).sum(dim=-1)
    vb = (bc * bc).sum(dim=-1)
    return cov / torch.clamp(torch.sqrt(va * vb), min=1e-8)


def pearson_ic(pred, target, w):
    """Per-month Pearson IC along the last axis → [...] correlations."""
    return _masked_pearson(pred, target, w)


def hard_ranks(x, w):
    """Exact ranks of the real entries along the last axis. Padded entries
    (w = 0) are pushed to the type's largest value so they take the top
    slots and never move a real entry's rank; their own ranks mean
    nothing. Ties get distinct ranks in first-index order (a stable
    sort)."""
    x = _acc(x)
    big = torch.full((), torch.finfo(x.dtype).max, dtype=x.dtype,
                     device=x.device)
    xs = torch.where(w > 0, x, big)
    order = torch.argsort(xs, dim=-1, stable=True)
    arange = torch.arange(x.shape[-1], dtype=x.dtype,
                          device=x.device).expand_as(xs)
    return torch.zeros_like(xs).scatter(-1, order, arange)


def spearman_ic(pred, target, w):
    """Exact per-month Spearman rank correlation along the last axis."""
    return _masked_pearson(hard_ranks(pred, w), hard_ranks(target, w), w)
