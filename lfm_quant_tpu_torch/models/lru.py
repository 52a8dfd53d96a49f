"""Linear Recurrent Unit factor model: the port of
``lfm_quant_tpu/models/lru.py`` (``LRULayer``, ``LRUModel``) in its
plain, one-device mode.

Per layer a complex diagonal state ``h_t = λ ⊙ h_{t-1} + γ ⊙ (B x_t)``
with ``λ = exp(-exp(ν) + i·exp(θ))`` (|λ| < 1 by construction), ``γ =
sqrt(max(1 - |λ|², 1e-6))`` and the readout ``y_t = C [Re h_t, Im h_t] +
d ⊙ x_t``; an invalid month holds the state (``a_t = m_t λ + (1 - m_t)``,
``b_t = m_t γ ⊙ B x_t``), so the last step carries the state at the last
valid month, and the model reads it out there (``h[..., -1, :]``), as the
recurrent models do. The B and C products and the head run in the compute
dtype; the coefficients and the scan in f32.

The JAX model folds the recurrence with ``lax.associative_scan``; here
:func:`linear_scan` is plain PyTorch on complex64, a loop over the window
(a log2(T)-round doubling scan was slower at every shape measured and kept
log2(T) full-size copies for autograd: PERF.md §6). The sequence-parallel
scan over ranks (``seq_axis``) is not ported (ROADMAP.md Queue A item 9).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from lfm_quant_tpu_torch.models.heads import (
    Dense,
    ForecastHead,
    LayerNorm,
    Rng,
    gelu,
    seed_view,
)

def linear_scan(a_re: torch.Tensor, a_im: torch.Tensor, b_re: torch.Tensor,
                b_im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t h_{t-1} + b_t`` (complex, ``h_{-1} = 0``) over the
    time axis ``-2`` of ``[..., T, N]`` f32 inputs → ``(h_re, h_im)``: one
    fused multiply-add per step (autograd keeps one state per step; the
    steps' gradients are stacked once)."""
    a, b = torch.complex(a_re, a_im), torch.complex(b_re, b_im)
    # unbind, not an index per step: its backward stacks the steps'
    # gradients once, where each index's would write a full-size one.
    a_t, b_t = a.unbind(-2), b.unbind(-2)
    h = b_t[0]
    hs = [h]
    for t in range(1, b.shape[-2]):
        h = torch.addcmul(b_t[t], a_t[t], h)
        hs.append(h)
    h = torch.stack(hs, dim=-2)
    return h.real, h.imag


class LRULayer(nn.Module):
    """One LRU mixing layer, ``x [..., T, H]`` → ``[..., T, H]``. Params:
    ``nu_log``, ``theta_log`` ``[N]``, ``b`` (``H → 2N``, no bias), ``c``
    (``2N → H``), ``d_skip`` ``[H]``; each with a leading seed axis under
    ``n_seeds``."""

    #: The initial ring of |λ| and the range of the initial phase (the
    #: JAX layer's defaults, for 60-step windows).
    R_MIN, R_MAX, MAX_PHASE = 0.9, 0.999, math.pi / 2

    def __init__(self, hidden: int, state_dim: int = 128,
                 dtype: Optional[torch.dtype] = None,
                 n_seeds: Optional[int] = None):
        super().__init__()
        lead = () if n_seeds is None else (n_seeds,)
        self.dtype = dtype
        self.nu_log = nn.Parameter(torch.zeros(*lead, state_dim))
        self.theta_log = nn.Parameter(torch.zeros(*lead, state_dim))
        self.b = Dense(hidden, 2 * state_dim, use_bias=False,
                       n_seeds=n_seeds)
        self.c = Dense(2 * state_dim, hidden, n_seeds=n_seeds)
        self.d_skip = nn.Parameter(torch.ones(*lead, hidden))

    def forward(self, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        compute = self.dtype or torch.float32
        nd = x.dim()
        mag = torch.exp(-torch.exp(seed_view(self.nu_log, nd)))
        phase = torch.exp(seed_view(self.theta_log, nd))
        lam_re, lam_im = mag * torch.cos(phase), mag * torch.sin(phase)
        gamma = torch.sqrt(torch.clamp(1.0 - mag ** 2, min=1e-6))
        bx_re, bx_im = self.b(x, dtype=compute).chunk(2, dim=-1)
        keep = m[..., None].float()
        h_re, h_im = linear_scan(
            keep * lam_re + (1.0 - keep), keep * lam_im,
            keep * gamma * bx_re.float(), keep * gamma * bx_im.float())
        y = self.c(torch.cat([h_re.to(compute), h_im.to(compute)], dim=-1),
                   dtype=compute)
        return y + seed_view(self.d_skip, nd).to(compute) * x


class LRUModel(nn.Module):
    """Stacked pre-norm LRU blocks (``h + gelu(lru(norm(h)))``) over the
    lookback window → the last step → the forecast head.

    ``forward(x [B, W, F], m [B, W], rng=None)`` → ``[B]`` f32 forecasts,
    or ``(mean, log_var)``; the trunk has no dropout, so ``rng`` is
    ignored. ``n_seeds=S``: every param seed-stacked, the input ``[S, B,
    W, F]`` (or shared), the output ``[S, B]``."""

    def __init__(self, n_features: int, hidden: int = 128,
                 state_dim: int = 128, layers: int = 2,
                 head_hidden: Sequence[int] = (),
                 heteroscedastic: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 seq_axis: Optional[str] = None,
                 n_seeds: Optional[int] = None):
        super().__init__()
        if seq_axis is not None:
            raise NotImplementedError(
                "the sequence-parallel LRU (seq_axis: the distributed "
                "linear scan over ranks) is not ported yet: ROADMAP.md "
                "Queue A item 9")
        self.dtype = dtype
        self.state_dim = state_dim
        self.embed = Dense(n_features, hidden, n_seeds=n_seeds)
        self.norm = nn.ModuleList(LayerNorm(hidden, dtype=dtype,
                                            n_seeds=n_seeds)
                                  for _ in range(layers))
        self.lru = nn.ModuleList(LRULayer(hidden, state_dim, dtype=dtype,
                                          n_seeds=n_seeds)
                                 for _ in range(layers))
        self.head = ForecastHead(hidden, head_hidden,
                                 heteroscedastic=heteroscedastic,
                                 dtype=dtype, n_seeds=n_seeds)

    def row_state_bytes(self, window: int) -> int:
        """Bytes of one window row's largest activation (the sweep's seed
        chunking): the complex64 state."""
        return 8 * window * self.state_dim

    def forward(self, x: torch.Tensor, m: torch.Tensor, rng: Rng = None):
        if self.embed.kernel.dim() == 3:
            x = x[None] if x.dim() == 3 else x
            m = m[None] if m.dim() == 2 else m
        # Masked-step features are zeroed: the residual stream is
        # position-wise and the readout reads the last step, so an invalid
        # anchor month must not leak its features into the forecast.
        x = x * m[..., None].to(x.dtype)
        h = self.embed(x.to(self.dtype or torch.float32), dtype=self.dtype)
        for norm, lru in zip(self.norm, self.lru):
            h = h + gelu(lru(norm(h), m))
        return self.head(h[..., -1, :])
