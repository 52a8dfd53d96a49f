"""The optimizer: an explicit step that mirrors the JAX package's

    optax.chain(clip_by_global_norm(grad_clip),
                adamw(warmup_cosine_decay_schedule(0, lr, warmup, total,
                                                   end_value=0.1 * lr),
                      weight_decay))

(``lfm_quant_tpu/train/loop.py`` ``TrainerPrograms``). It is not
``torch.optim.AdamW`` with ``clip_grad_norm_``, whose numbers differ:
optax scales by ``max / ||g||`` only when ``||g|| >= max`` (torch divides
by ``||g|| + 1e-6``), its schedule starts at lr 0 (so the first update is
zero), the warmup is ``min(warmup_steps, total // 2)``, the decay is
decoupled and applies to every parameter, and the step size is read
before the count moves. All arithmetic is f32, in optax's order.

The state is an explicit structure of tensors (:class:`AdamWState`), so a
checkpoint carries it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass
class AdamWState:
    """Adam's moments per parameter name and the update count."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def warmup_cosine_lr(count: int, lr: float, warmup: int, total: int,
                     end_value: float) -> torch.Tensor:
    """optax ``warmup_cosine_decay_schedule(0, lr, warmup, total,
    end_value)`` at ``count``, as an f32 scalar."""
    f32 = torch.float32
    if count < warmup:
        # linear_schedule(0, lr, warmup): (0 - lr) * (1 - c / W) + lr
        frac = 1.0 - torch.tensor(min(max(count, 0), warmup), dtype=f32) \
            / warmup
        return (0.0 - torch.tensor(lr, dtype=f32)) * frac + lr
    decay_steps = total - warmup
    if decay_steps <= 0:
        raise ValueError(f"the schedule needs total > warmup, got {total} "
                         f"<= {warmup}")
    alpha = 0.0 if lr == 0.0 else end_value / lr
    c = torch.tensor(float(min(count - warmup, decay_steps)), dtype=f32)
    cosine = 0.5 * (1 + torch.cos(math.pi * c / float(decay_steps)))
    return torch.tensor(lr, dtype=f32) * ((1 - alpha) * cosine + alpha)


class AdamW:
    """clip_by_global_norm → adamw(schedule, weight_decay), optax's chain.

    ``total_steps`` and ``warmup_steps`` fix the schedule as the JAX
    trainer does: ``total = max(1, steps_per_epoch * epochs)``,
    ``warmup = min(warmup_steps, total // 2)``."""

    def __init__(self, lr: float, weight_decay: float, grad_clip: float,
                 warmup_steps: int, total_steps: int):
        self.lr = lr
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.total = max(1, total_steps)
        self.warmup = min(warmup_steps, self.total // 2)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(
            0, {k: torch.zeros_like(p) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()})

    def lr_at(self, count: int) -> torch.Tensor:
        return warmup_cosine_lr(count, self.lr, self.warmup, self.total,
                                0.1 * self.lr)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: AdamWState
             ) -> torch.Tensor:
        """Update ``params`` and ``state`` in place; return the global
        gradient norm before clipping (the trainer's logged grad_norm).
        Every parameter goes through one ``torch._foreach_*`` call per
        operation; nothing waits for the device."""
        keys = list(params)
        ps = [params[k] for k in keys]
        gs = [grads[k].float() for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
        # Clip only when ||g|| >= max (a device-side select): the factor is
        # exactly 1 below the threshold.
        coef = torch.where(g_norm < self.grad_clip, torch.ones_like(g_norm),
                           self.grad_clip / g_norm)
        gs = torch._foreach_mul(gs, coef)
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, gs, alpha=1 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, gs, gs, value=1 - B2)
        count_inc = state.count + 1
        f32 = torch.float32
        bc1 = float(1 - torch.tensor(B1, dtype=f32) ** count_inc)
        bc2 = float(1 - torch.tensor(B2, dtype=f32) ** count_inc)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, den)
        torch._foreach_add_(u, ps, alpha=self.weight_decay)
        torch._foreach_mul_(u, -float(self.lr_at(state.count)))
        torch._foreach_add_(ps, u)
        state.count = count_inc
        return g_norm
