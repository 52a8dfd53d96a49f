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
log2(T) full-size copies for autograd: PERF.md §6).

Long-context mode (``seq_axis="seq"``, JAX ``_distributed_linear_scan``):
the model runs on this seq rank's block of the window inside
``parallel/ring.py bind_seq_axis``. Each layer scans its block, carrying
the running product of ``a``; one all-gather of every rank's aggregate
``(A, B)``; each rank folds the exclusive prefix of the earlier ranks'
aggregates into the state entering its block and corrects its states
elementwise. The last position lives on the last rank, whose readout the
group sums (the others add zeros), so every rank returns the same
forecast. No param depends on the position: checkpoints interchange with
the plain mode.
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
from lfm_quant_tpu_torch.parallel import ring

def _scan(a: torch.Tensor, b: torch.Tensor, with_prod: bool = False):
    """``h_t = a_t h_{t-1} + b_t`` (complex, ``h_{-1} = 0``) over axis
    ``-2``: one fused multiply-add per step (autograd keeps one state per
    step; the steps' gradients are stacked once). ``with_prod`` also
    returns the running product ``A_t = a_t ... a_0``."""
    # unbind, not an index per step: its backward stacks the steps'
    # gradients once, where each index's would write a full-size one.
    a_t, b_t = a.unbind(-2), b.unbind(-2)
    h, p = b_t[0], a_t[0]
    hs, ps = [h], [p]
    for t in range(1, b.shape[-2]):
        h = torch.addcmul(b_t[t], a_t[t], h)
        hs.append(h)
        if with_prod:
            p = a_t[t] * p
            ps.append(p)
    h = torch.stack(hs, dim=-2)
    return (h, torch.stack(ps, dim=-2)) if with_prod else h


def linear_scan(a_re: torch.Tensor, a_im: torch.Tensor, b_re: torch.Tensor,
                b_im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t h_{t-1} + b_t`` (complex, ``h_{-1} = 0``) over the
    time axis ``-2`` of ``[..., T, N]`` f32 inputs → ``(h_re, h_im)``."""
    h = _scan(torch.complex(a_re, a_im), torch.complex(b_re, b_im))
    return h.real, h.imag


def distributed_linear_scan(a_re: torch.Tensor, a_im: torch.Tensor,
                            b_re: torch.Tensor, b_im: torch.Tensor,
                            mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`linear_scan` with the time axis split over the seq group
    (JAX ``_distributed_linear_scan``, ``models/lru.py:72``): the local
    scan with the running product of ``a``; ONE all-gather of each rank's
    aggregate transform ``(A, B)`` (``h ↦ A h + B`` over its block); the
    fold of the earlier ranks' aggregates (``h_in ← A_s h_in + B_s``, from
    0) gives the state entering this block, ``h_in``; then ``h_t += A_t
    h_in``."""
    h, cum = _scan(torch.complex(a_re, a_im), torch.complex(b_re, b_im),
                   with_prod=True)
    if mesh.n_seq == 1:
        return h.real, h.imag
    agg = torch.stack([cum[..., -1, :], h[..., -1, :]])  # [2, ..., N]
    got = torch.view_as_complex(ring.seq_all_gather(
        torch.view_as_real(agg), mesh))  # [n_seq, 2, ..., N]
    # Every rank folds every prefix and takes its own, as JAX does: the
    # gather's gradient then has the same graph on every rank.
    B = torch.zeros_like(agg[1])
    prefixes = [B]
    for s in range(mesh.n_seq - 1):
        B = got[s, 0] * B + got[s, 1]
        prefixes.append(B)
    h_in = torch.stack(prefixes)[mesh.seq_rank]
    h = h + cum * h_in[..., None, :]
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

    def forward(self, x: torch.Tensor, m: torch.Tensor,
                mesh=None) -> torch.Tensor:
        """``mesh``: ``x`` is the seq rank's block of the window, scanned
        by :func:`distributed_linear_scan` over its seq group."""
        compute = self.dtype or torch.float32
        nd = x.dim()
        mag = torch.exp(-torch.exp(seed_view(self.nu_log, nd)))
        phase = torch.exp(seed_view(self.theta_log, nd))
        lam_re, lam_im = mag * torch.cos(phase), mag * torch.sin(phase)
        gamma = torch.sqrt(torch.clamp(1.0 - mag ** 2, min=1e-6))
        bx_re, bx_im = self.b(x, dtype=compute).chunk(2, dim=-1)
        keep = m[..., None].float()
        coeffs = (keep * lam_re + (1.0 - keep), keep * lam_im,
                  keep * gamma * bx_re.float(), keep * gamma * bx_im.float())
        h_re, h_im = (linear_scan(*coeffs) if mesh is None
                      else distributed_linear_scan(*coeffs, mesh))
        y = self.c(torch.cat([h_re.to(compute), h_im.to(compute)], dim=-1),
                   dtype=compute)
        return y + seed_view(self.d_skip, nd).to(compute) * x


class LRUModel(nn.Module):
    """Stacked pre-norm LRU blocks (``h + gelu(lru(norm(h)))``) over the
    lookback window → the last step → the forecast head.

    ``forward(x [B, W, F], m [B, W], rng=None)`` → ``[B]`` f32 forecasts,
    or ``(mean, log_var)``; the trunk has no dropout, so ``rng`` is
    ignored. ``n_seeds=S``: every param seed-stacked, the input ``[S, B,
    W, F]`` (or shared), the output ``[S, B]``. ``seq_axis``: the
    long-context mode (see the module docstring)."""

    def __init__(self, n_features: int, hidden: int = 128,
                 state_dim: int = 128, layers: int = 2,
                 head_hidden: Sequence[int] = (),
                 heteroscedastic: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 seq_axis: Optional[str] = None,
                 n_seeds: Optional[int] = None):
        super().__init__()
        self.seq_axis = seq_axis
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
        mesh = None if self.seq_axis is None else ring.seq_axis(self.seq_axis)
        h = self.embed(x.to(self.dtype or torch.float32), dtype=self.dtype)
        for norm, lru in zip(self.norm, self.lru):
            h = h + gelu(lru(norm(h), m, mesh))
        z = h[..., -1, :]
        if mesh is None:
            return self.head(z)
        # The window's last position lives on the last rank: the others
        # add zeros (multiplied, so every rank's graph is the same).
        last = float(mesh.seq_rank == mesh.n_seq - 1)
        return ring.replicated(self.head(ring.seq_sum(z * last, mesh)), mesh)
