"""The optimizers: explicit steps that mirror the JAX package's

    optax.chain(clip_by_global_norm(grad_clip),
                adamw(warmup_cosine_decay_schedule(0, lr, warmup, total,
                                                   end_value=0.1 * lr),
                      weight_decay))

and the same chain with ``optax.lamb`` in place of ``adamw``
(``lfm_quant_tpu/train/loop.py`` ``TrainerPrograms``; ``OptimConfig.
optimizer`` picks one through :func:`make_optimizer`). :class:`AdamW` is
not
``torch.optim.AdamW`` with ``clip_grad_norm_``, whose numbers differ:
optax scales by ``max / ||g||`` only when ``||g|| >= max`` (torch divides
by ``||g|| + 1e-6``), its schedule starts at lr 0 (so the first update is
zero), the warmup is ``min(warmup_steps, total // 2)``, the decay is
decoupled and applies to every parameter, and the step size is read
before the count moves. All arithmetic is f32, in optax's order.

:class:`Lamb` is optax's ``lamb``: ``scale_by_adam`` (b1 0.9, b2 0.999,
eps 1e-6, not AdamW's 1e-8; eps_root 0) → ``add_decayed_weights`` →
``scale_by_trust_ratio`` (each parameter's update scaled by ``||p|| /
||u||``, 1 where either norm is 0) → the schedule's step size.

The state is an explicit structure of tensors (:class:`AdamWState`, the
same for both), so a checkpoint carries it.

``per_seed=True`` is the seed ensemble's optimizer, the JAX ``vmap`` of
the chain over stacked members: the leading axis of every parameter is
the seed, and the global norm, the clip factor and LAMB's trust ratios
are taken per seed. The members step in lock-step, so they share the
update count.

Per-member hyperparameters (``per_seed`` with ``lr`` and ``weight_decay``
given as one value per member): the stacked runs' ``[S]`` operands
(``train/stacked.py``, the JAX ``stacked.py _hyper_update``), each
broadcast over its member's leading axis. Member s's step size at count
c is the value ``lr_at(c)`` of a one-member optimizer with ``lr[s]``
(a table of those values, made on the host once and kept on the
parameters' device), and its decay is ``u + wd[s] * p`` rounded as the
shared value's is, so a member steps as its sequential run would.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import torch

B1, B2 = 0.9, 0.999


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

    eps = 1e-8

    def __init__(self, lr: Union[float, Sequence[float]],
                 weight_decay: Union[float, Sequence[float]],
                 grad_clip: float, warmup_steps: int, total_steps: int,
                 per_seed: bool = False):
        self.per_seed = per_seed
        self.grad_clip = grad_clip
        self.total = max(1, total_steps)
        self.warmup = min(warmup_steps, self.total // 2)
        self.lr = lr
        self.weight_decay = weight_decay
        #: Per-member operands: the step-size table ``[total + 1, S]`` and
        #: the decays ``[S]``, on the parameters' device after ``init``.
        self._lr_table: Optional[torch.Tensor] = None
        self._wd: Optional[torch.Tensor] = None
        if not isinstance(lr, (int, float)):
            if not per_seed or isinstance(weight_decay, (int, float)) \
                    or len(weight_decay) != len(lr):
                raise ValueError("per-member lr and weight_decay need "
                                 "per_seed and one value each per member")
            self.lr = [float(v) for v in lr]
            self.weight_decay = [float(v) for v in weight_decay]
            # count >= total reads the last row: the schedule is flat
            # past its end.
            rows = {v: torch.stack([self._schedule(c, v)
                                    for c in range(self.total + 1)])
                    for v in set(self.lr)}
            self._lr_table = torch.stack([rows[v] for v in self.lr], dim=1)
            self._wd = torch.tensor(self.weight_decay, dtype=torch.float32)

    def _schedule(self, count: int, lr: float) -> torch.Tensor:
        return warmup_cosine_lr(count, lr, self.warmup, self.total,
                                0.1 * lr)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        if self._lr_table is not None:
            dev = next(iter(params.values())).device
            self._lr_table = self._lr_table.to(dev)
            self._wd = self._wd.to(dev)
        return AdamWState(
            0, {k: torch.zeros_like(p) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()})

    def lr_at(self, count: int) -> torch.Tensor:
        """The step size at ``count``: an f32 scalar, or with per-member
        operands the ``[S]`` row of every member's."""
        if self._lr_table is not None:
            return self._lr_table[min(count, self.total)]
        return self._schedule(count, self.lr)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: AdamWState
             ) -> torch.Tensor:
        """Update ``params`` and ``state`` in place; return the global
        gradient norm before clipping (the trainer's logged grad_norm;
        ``[S]``, one per seed, with ``per_seed``). Every parameter goes
        through one ``torch._foreach_*`` call per operation; nothing waits
        for the device."""
        keys = list(params)
        ps = [params[k] for k in keys]
        gs = [grads[k].float() for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        if self.per_seed:
            g_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g, dim=tuple(range(1, g.dim())))
                 for g in gs]), dim=0)
        else:
            g_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(gs)))
        # Clip only when ||g|| >= max (a device-side select): the factor is
        # exactly 1 below the threshold.
        coef = torch.where(g_norm < self.grad_clip, torch.ones_like(g_norm),
                           self.grad_clip / g_norm)
        if self.per_seed:
            gs = [g * coef.view(-1, *(1,) * (g.dim() - 1)) for g in gs]
        else:
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
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, den)
        if self._wd is None:
            torch._foreach_add_(u, ps, alpha=self.weight_decay)
        else:
            for ui, p in zip(u, ps):
                ui.addcmul_(p, self._wd.view(-1, *(1,) * (p.dim() - 1)))
        u = self._scale(u, ps)
        if self._lr_table is None:
            torch._foreach_mul_(u, -float(self.lr_at(state.count)))
        else:
            step = -self.lr_at(state.count)
            u = [ui * step.view(-1, *(1,) * (ui.dim() - 1)) for ui in u]
        torch._foreach_add_(ps, u)
        state.count = count_inc
        return g_norm

    def _scale(self, u: List[torch.Tensor], ps: List[torch.Tensor]
               ) -> List[torch.Tensor]:
        """The step between the decayed update and the step size: none
        for AdamW."""
        return u


class Lamb(AdamW):
    """clip_by_global_norm → lamb(schedule, weight_decay), optax's chain:
    AdamW's update with eps 1e-6, each parameter's (each seed's, with
    ``per_seed``) scaled by its trust ratio ``||p|| / ||u||``."""

    eps = 1e-6

    def _scale(self, u, ps):
        def norms(ts):
            if self.per_seed:
                return [torch.linalg.vector_norm(t, dim=tuple(
                    range(1, t.dim()))).view(-1, *(1,) * (t.dim() - 1))
                    for t in ts]
            return torch._foreach_norm(ts)

        out = []
        for ui, p_norm, u_norm in zip(u, norms(ps), norms(u)):
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(p_norm), p_norm / u_norm)
            out.append(ui * ratio)
        return out


def make_optimizer(o, total_steps: int, per_seed: bool = False,
                   lr: Optional[Sequence[float]] = None,
                   weight_decay: Optional[Sequence[float]] = None) -> AdamW:
    """``OptimConfig`` → its optimizer (``optimizer`` "adamw" or
    "lamb"), the schedule fixed by ``total_steps``; ``lr`` and
    ``weight_decay`` (one value per member, with ``per_seed``) replace
    the config's."""
    classes = {"adamw": AdamW, "lamb": Lamb}
    if o.optimizer not in classes:
        raise ValueError(
            f"optimizer must be adamw|lamb, got {o.optimizer!r}")
    return classes[o.optimizer](
        o.lr if lr is None else lr,
        o.weight_decay if weight_decay is None else weight_decay,
        o.grad_clip, o.warmup_steps, total_steps, per_seed=per_seed)
