"""Training losses: the port of ``lfm_quant_tpu/ops/losses.py``.

All cross-sectional losses take ``[D, Bf]`` tensors — D months per batch,
Bf firms per month — and rank along the last axis only. ``w`` is the
sampler's padding weight: entries with ``w = 0`` are absent. Every
reduction runs in at least f32 (``_acc``), whatever the inputs' type.

``make_loss_parts`` splits each loss into a numerator and a denominator
so a data-parallel step can sum each across shards before dividing;
``finalize_loss(*parts(out, y, w))`` equals the plain loss.
"""

from __future__ import annotations

import torch


def _acc(x: torch.Tensor) -> torch.Tensor:
    """Promote sub-f32 values (bf16/f16) to f32 before a reduction;
    f32/f64 pass through."""
    dt = torch.promote_types(x.dtype, torch.float32)
    return x.to(dt) if x.dtype != dt else x


def _weighted_mean(x, w, axis=None):
    x = _acc(x)
    w = w.to(x.dtype)
    if axis is None:
        return (x * w).sum() / torch.clamp(w.sum(), min=1e-12)
    return (x * w).sum(dim=axis) / torch.clamp(w.sum(dim=axis), min=1e-12)


def masked_mse(pred, target, w):
    """Weighted mean squared error over real (w>0) samples → scalar."""
    return _weighted_mean((pred - target) ** 2, w)


def masked_huber(pred, target, w, delta: float = 1.0):
    """Weighted Huber loss → scalar."""
    err = torch.abs(pred - target)
    quad = torch.clamp(err, max=delta)
    lin = err - quad
    return _weighted_mean(0.5 * quad ** 2 + delta * lin, w)


def gaussian_nll(mean, log_var, target, w):
    """Heteroscedastic Gaussian NLL for the uncertainty head → scalar."""
    nll = 0.5 * (log_var + (target - mean) ** 2 * torch.exp(-log_var))
    return _weighted_mean(nll, w)


def soft_rank(x, w, temperature: float = 1.0):
    """Differentiable ranks along the last axis:
    ``soft_rank[i] = sum_j w_j>0 * sigmoid((x_i - x_j) / temperature)``.
    Materializes one ``[..., Bf, Bf]`` pairwise array."""
    diff = (x[..., :, None] - x[..., None, :]) / temperature
    p = torch.where(w[..., None, :] > 0, 1.0 / (1.0 + torch.exp(-diff)),
                    torch.zeros((), dtype=x.dtype, device=x.device))
    return p.sum(dim=-1)


def _center_corr(a, b, w):
    """Weighted Pearson correlation along the last axis → [...]."""
    wa = _weighted_mean(a, w, axis=-1)[..., None]
    wb = _weighted_mean(b, w, axis=-1)[..., None]
    ac, bc = (a - wa) * w, (b - wb) * w
    cov = (ac * bc).sum(dim=-1)
    va = (ac * ac).sum(dim=-1)
    vb = (bc * bc).sum(dim=-1)
    return cov / torch.clamp(torch.sqrt(va * vb), min=1e-8)


def rank_ic_loss(pred, target, w, temperature: float = 0.5):
    """Negative mean per-month soft Spearman correlation → scalar. Ranks
    in f32: bf16 quantizes ranks past n ≈ 256."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    pr = soft_rank(pred, w, temperature)
    tr = soft_rank(target, w, temperature=1e-3)
    ic = _center_corr(pr, tr, w.to(pred.dtype))
    return -ic.mean()


def finalize_loss(num, den):
    """num/den with ``_weighted_mean``'s zero-protection."""
    return num / torch.clamp(den, min=1e-12)


def _sum_parts(errs, w):
    errs = _acc(errs)
    w = w.to(errs.dtype)
    return (errs * w).sum(), w.sum()


def make_loss_parts(name: str):
    """Loss name → fn(out, y, w) -> (num, den) with
    ``finalize_loss(num, den)`` the loss."""
    if name == "mse":
        return lambda out, y, w: _sum_parts((out - y) ** 2, w)
    if name == "huber":
        def huber_parts(out, y, w, delta=1.0):
            err = torch.abs(out - y)
            quad = torch.clamp(err, max=delta)
            return _sum_parts(0.5 * quad ** 2 + delta * (err - quad), w)
        return huber_parts
    if name == "nll":
        def nll_parts(out, y, w):
            mean, log_var = out
            nll = 0.5 * (log_var + (y - mean) ** 2 * torch.exp(-log_var))
            return _sum_parts(nll, w)
        return nll_parts
    if name == "rank_ic":
        def rank_ic_parts(out, y, w, temperature=0.5):
            out = out.to(torch.float32)
            y = y.to(torch.float32)
            pr = soft_rank(out, w, temperature)
            tr = soft_rank(y, w, temperature=1e-3)
            ic = _center_corr(pr, tr, w.to(out.dtype))
            return (-ic).sum(), torch.tensor(float(ic.numel()),
                                             dtype=ic.dtype,
                                             device=ic.device)
        return rank_ic_parts
    raise ValueError(f"unknown loss {name!r}; use mse|huber|rank_ic|nll")
