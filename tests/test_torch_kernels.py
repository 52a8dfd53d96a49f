"""The port's kernel wrappers: dispatch, checks and launch counts, and — on
the card — each CUDA kernel against its plain PyTorch version.

This file imports nothing of JAX, so it also runs where only PyTorch is
installed. On the card (the repository's ``tests/conftest.py`` imports
jax, so leave it out there)::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Tests marked ``cuda`` decide in a fixture whether there is a card and
skip without one. Tolerances: gathers exact; the recurrence f32 atol 1e-5
(the 3xTF32 ``csrc/rnn_fwd_tf32.cu`` at H <= 128, a width off a multiple
of 16 zero-padded to the next, and the CUDA-core kernels above), bf16
atol/rtol 0.05 — the JAX package's own bounds; the backward's gradients
scaled by their largest magnitude, f32 atol 1e-5 (``tests/
test_pallas_rnn.py``'s rule; ``csrc/rnn_bwd_tf32.cu`` up to Hp 384,
``csrc/rnn_bwd_tf32_grid.cu`` to 1024, the CUDA-core kernels past it) and
bf16 atol 0.05 (the bf16 tensor-core
backward's f32 weight gradients 1e-4, as ``tests/test_torch_mma_bwd.py``
holds them).
"""

import numpy as np
import pytest
import torch

from lfm_quant_tpu_torch.config import get_preset
from lfm_quant_tpu_torch.data.panel import synthetic_panel
from lfm_quant_tpu_torch.data.windows import gather_windows_packed
from lfm_quant_tpu_torch.ops import _build
from lfm_quant_tpu_torch.ops import rnn as R
from lfm_quant_tpu_torch.ops.gather import gather_windows
from lfm_quant_tpu_torch.ops.rnn import (
    rnn_scan,
    rnn_scan_bwd,
    rnn_scan_bwd_reference,
    rnn_scan_fused,
    rnn_scan_fused_bwd,
    rnn_scan_fused_bwd_reference,
    rnn_scan_fused_reference,
    rnn_scan_reference,
    rnn_scan_states,
)
from lfm_quant_tpu_torch.serve import ScoringService

GATES = {"lstm": 4, "gru": 3}
TOL = {torch.float32: dict(atol=1e-5, rtol=0.0),
       torch.bfloat16: dict(atol=0.05, rtol=0.05)}


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card for the port's CUDA kernels "
                    "(python3 chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _rnn_inputs(cell, B, T, H, seed, dtype, device):
    rng = np.random.default_rng(seed)
    G = GATES[cell] * H
    arrays = [rng.standard_normal((B, T, H)),
              0.3 * rng.standard_normal((H, G)),
              0.1 * rng.standard_normal((G,)),
              0.3 * rng.standard_normal((H, G))]
    t = [torch.from_numpy(a.astype(np.float32)).to(dtype).to(device)
         for a in arrays]
    m = rng.random((B, T)) < 0.75
    m[0] = False  # an all-invalid row
    return t, torch.from_numpy(m).to(device)


def _gather_inputs(N, T, fp, W, D, Bf, seed, dtype, device, lane_pad=0):
    rng = np.random.default_rng(seed)
    xm = rng.standard_normal((N, T, fp + lane_pad)).astype(np.float32)
    xm[..., fp - 1] = rng.random((N, T)) < 0.8
    xm[..., fp:] = 0.0
    fi = rng.integers(0, N, (D, Bf)).astype(np.int32)
    ti = rng.integers(0, T, (D,)).astype(np.int32)
    ti[0], ti[-1] = 0, T - 1  # the youngest and the newest anchor
    return (torch.from_numpy(xm).to(dtype).to(device),
            torch.from_numpy(fi).to(device), torch.from_numpy(ti).to(device))


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers ARE the plain versions, and launch nothing."""
    _build.reset_launch_counts()
    (hin, wx, b, wh), m = _rnn_inputs("gru", 5, 4, 8, 0, torch.float32,
                                      "cpu")
    with torch.no_grad():
        assert torch.equal(rnn_scan_fused("gru", hin, wx, b, wh, m),
                           rnn_scan_fused_reference("gru", hin, wx, b, wh, m))
        xw = hin @ wx + b
        assert torch.equal(rnn_scan("gru", xw, wh, m),
                           rnn_scan_reference("gru", xw, wh, m))
    h = rnn_scan_fused_reference("gru", hin, wx, b, wh, m)
    dh = torch.ones_like(h)
    for got, want in zip(
            rnn_scan_fused_bwd("gru", hin, wx, b, wh, m, h, None, dh),
            rnn_scan_fused_bwd_reference("gru", hin, wx, b, wh, m, h, None,
                                         dh)):
        assert torch.equal(got, want)
    for got, want in zip(rnn_scan_bwd("gru", xw, wh, m, h, None, dh),
                         rnn_scan_bwd_reference("gru", xw, wh, m, h, None,
                                                dh)):
        assert torch.equal(got, want)
    xm, fi, ti = _gather_inputs(6, 20, 4, 9, 3, 7, 1, torch.float32, "cpu")
    for got, want in zip(gather_windows(xm, fi, ti, 9, fp=4),
                         gather_windows_packed(xm, fi, ti, 9, fp=4)):
        assert torch.equal(got, want)
    assert set(_build.launch_counts().values()) == {0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("B,T,H", [(37, 9, 12), (16, 5, 16), (3, 7, 8),
                                   (5, 4, 136)])
def test_rnn_kernel_matches_plain(cuda, cell, dtype, B, T, H):
    """Odd batch (not a multiple of the block's 16 rows), H not a
    multiple of 4 (padded onto the tensor cores), H 136 (the CUDA-core
    kernel), an all-invalid row that must stay at zero."""
    (hin, wx, b, wh), m = _rnn_inputs(cell, B, T, H, B + H, dtype, cuda)
    with torch.no_grad():
        got = rnn_scan_fused(cell, hin, wx, b, wh, m)
        want = rnn_scan_fused_reference(cell, hin, wx, b, wh, m)
    assert got.dtype == dtype and got.shape == (B, T, H)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    assert not got[0].any()


def _scaled_close(got, want, dtype):
    """Gradients held as the JAX tests hold them: scaled by the reference's
    largest magnitude, atol 1e-5 in f32, 0.05 in bf16."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = float(want.abs().max()) + 1e-9
    atol = 1e-5 if dtype == torch.float32 else 0.05
    np.testing.assert_allclose(got.numpy() / scale, want.numpy() / scale,
                               atol=atol, rtol=0.0)


def _bwd_inputs(cell, B, T, H, seed, dtype, device, hoisted):
    """Saved states from the plain forward and an upstream gradient."""
    (hin, wx, b, wh), m = _rnn_inputs(cell, B, T, H, seed, dtype, device)
    rng = np.random.default_rng(seed + 1)
    dh = torch.from_numpy(rng.standard_normal((B, T, H)).astype(
        np.float32)).to(dtype).to(device)
    xw = (hin.float() @ wx.float() + b.float()).to(dtype)
    h, c = rnn_scan_states(cell, xw if hoisted else hin.float() @ wx.float()
                        + b.float(), wh, m, 1.0, True)
    h = h.to(dtype)
    c = None if c is None else c.to(dtype)
    return hin, wx, b, wh, m, xw, h, c, dh


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("B,T,H", [(37, 9, 12), (16, 1, 16), (3, 7, 8),
                                   (5, 4, 136)])
def test_rnn_scan_kernel_matches_plain(cuda, cell, dtype, B, T, H):
    """The hoisted forward (row 1) against its plain version."""
    (hin, wx, b, wh), m = _rnn_inputs(cell, B, T, H, B + T, dtype, cuda)
    xw = (hin.float() @ wx.float() + b.float()).to(dtype)
    with torch.no_grad():
        got = rnn_scan(cell, xw, wh, m)
        want = rnn_scan_reference(cell, xw, wh, m)
    assert got.dtype == dtype and got.shape == (B, T, H)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("B,T,H", [(37, 9, 12), (16, 1, 24), (21, 5, 8),
                                   (7, 3, 136)])
def test_rnn_bwd_kernels_match_plain(cuda, cell, dtype, B, T, H):
    """The fused backward (row 4) and hoisted backward (row 2) against
    their plain formulas: B not a multiple of the block's 16 rows, T = 1,
    H not a multiple of 4, an all-invalid row. The widths under 128 run
    zero-padded on the tensor cores (``_mma_route``); H 136 zero-padded to
    144 on the cluster backwards (float32 3xTF32, bf16), in both
    dtypes."""
    hin, wx, b, wh, m, xw, h, c, dh = _bwd_inputs(cell, B, T, H, B + H,
                                                  dtype, cuda, False)
    got = rnn_scan_fused_bwd(cell, hin, wx, b, wh, m, h, c, dh)
    want = rnn_scan_fused_bwd_reference(cell, hin, wx, b, wh, m, h, c, dh)
    assert got[0].dtype == dtype and got[0].shape == hin.shape
    for g, w in zip(got, want):
        _scaled_close(g, w, dtype)
    assert not got[0][0].any()  # an all-invalid row passes no gradient
    hin, wx, b, wh, m, xw, h, c, dh = _bwd_inputs(cell, B, T, H, B + H,
                                                  dtype, cuda, True)
    got = rnn_scan_bwd(cell, xw, wh, m, h, c, dh)
    want = rnn_scan_bwd_reference(cell, xw, wh, m, h, c, dh)
    assert got[0].dtype == dtype and got[0].shape == xw.shape
    for g, w in zip(got, want):
        _scaled_close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_bwd_weight_gradients_bitwise_repeatable(cuda, cell):
    """The weight gradients are reduced in a fixed order (no atomics): two
    launches on the same inputs agree bit for bit."""
    hin, wx, b, wh, m, xw, h, c, dh = _bwd_inputs(cell, 300, 12, 32, 5,
                                                  torch.bfloat16, cuda,
                                                  False)
    one = rnn_scan_fused_bwd(cell, hin, wx, b, wh, m, h, c, dh)
    two = rnn_scan_fused_bwd(cell, hin, wx, b, wh, m, h, c, dh)
    for a, z in zip(one, two):
        assert torch.equal(a, z)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("hoisted", [False, True])
def test_autograd_on_card_matches_cpu(cuda, cell, hoisted):
    """A loss's gradients through the op on the card (kernels) and on the
    CPU (plain formulas), f32."""
    (hin, wx, b, wh), m = _rnn_inputs(cell, 19, 6, 8, 3, torch.float32,
                                      "cpu")
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.detach().clone().to(dev).requires_grad_(True)
                  for t in (hin, wx, b, wh)]
        hi, x, bb, w = leaves
        if hoisted:
            out = rnn_scan(cell, hi @ x + bb, w, m.to(dev))
        else:
            out = rnn_scan_fused(cell, hi, x, bb, w, m.to(dev))
        (out.float() ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for g_card, g_cpu in zip(grads[1], grads[0]):
        _scaled_close(g_card, g_cpu, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T,fp,W,D,Bf,lane_pad", [
    (7, 23, 4, 9, 5, 13, 0),     # young, mid and tail anchors
    (7, 5, 4, 9, 3, 6, 0),       # panel shorter than the window
    (11, 64, 6, 60, 4, 33, 3),   # c2's window, a lane-padded panel
    (7, 30, 8, 9, 3, 10, 0),     # F = 7: W F itemsize % 16 != 0
    (9, 80, 21, 60, 6, 37, 0),   # c2's window and width: span copies
    (9, 80, 21, 60, 6, 37, 11),  # the same, lane-padded to Fp = 32
])
def test_gather_kernel_matches_plain(cuda, dtype, N, T, fp, W, D, Bf,
                                     lane_pad):
    """Bitwise, at shapes that take the span copies (16-byte stores: c2's
    width in both types, fp = 6 in f32) and the narrow stores (the rest,
    and every young anchor); ``tests/test_torch_gather_span.py`` says
    which."""
    xm, fi, ti = _gather_inputs(N, T, fp, W, D, Bf, N + T, dtype, cuda,
                                lane_pad)
    x, m = gather_windows(xm, fi, ti, W, fp=fp)
    xr, mr = gather_windows_packed(xm, fi, ti, W, fp=fp)
    assert torch.equal(x.view(torch.uint8), xr.view(torch.uint8))
    assert torch.equal(m, mr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_kernel_clamps_indices_outside_the_panel(cuda, dtype):
    """Months past the panel's end clamp to its last month and months
    before its start are masked, as the plain gather does; firm indices
    clamp to [0, N - 1] (XLA's gather rule), held against the plain gather
    of the clamped indices."""
    N, T, fp, W = 9, 80, 21, 60
    xm, fi, _ = _gather_inputs(N, T, fp, W, 4, 37, 2, dtype, cuda)
    ti = torch.tensor([T + 5, T - 1, -3, 70], dtype=torch.int32,
                      device=cuda)
    fi[1, :3] = torch.tensor([-4, N, N + 7], dtype=torch.int32, device=cuda)
    x, m = gather_windows(xm, fi, ti, W, fp=fp)
    xr, mr = gather_windows_packed(xm, fi.clamp(0, N - 1), ti, W, fp=fp)
    assert torch.equal(x.view(torch.uint8), xr.view(torch.uint8))
    assert torch.equal(m, mr)


@pytest.mark.cuda
@pytest.mark.parametrize("fp,W,T", [(4, 9, 23), (21, 60, 80)])
def test_seed_stacked_gather_is_one_launch(cuda, fp, W, T):
    """Index batches [S, D, Bf] over the shared panel fold into one launch
    over S * D date rows (the JAX ``_call_vmap``); each seed's windows are
    exactly its own one-seed gather's (narrow stores at fp 4, span copies
    at c2's fp 21 and W 60)."""
    S, D, Bf = 3, 4, 13
    xm, _, _ = _gather_inputs(7, T, fp, W, 1, 1, 5, torch.bfloat16, cuda)
    rng = np.random.default_rng(6)
    fi = torch.from_numpy(rng.integers(0, 7, (S, D, Bf)).astype(np.int32))
    ti = torch.from_numpy(rng.integers(0, T, (S, D)).astype(np.int32))
    fi, ti = fi.to(cuda), ti.to(cuda)
    _build.reset_launch_counts()
    x, m = gather_windows(xm, fi, ti, W)
    assert _build.launch_counts()["window_gather"] == 1
    assert x.shape == (S, D, Bf, W, fp - 1) and m.shape == (S, D, Bf, W)
    for s in range(S):
        xr, mr = gather_windows_packed(xm, fi[s], ti[s], W)
        assert torch.equal(x[s], xr) and torch.equal(m[s], mr)


@pytest.mark.cuda
@pytest.mark.parametrize("W,n_seq", [(240, 2), (60, 2), (240, 4)])
def test_gather_at_a_seq_ranks_sub_window(cuda, W, n_seq):
    """A seq rank's gather (``train/loop.py sub_window``): window ``Wl = W
    / n_seq`` at the anchor shifted by ``W - (s+1) Wl`` (lc's 240 and
    lru's 60 over 2 ranks, lc over 4), bitwise its plain version and
    bitwise block s of the full window's gather, young anchors (shifted
    below month 0) among them."""
    from lfm_quant_tpu_torch.parallel.mesh import DataMesh
    from lfm_quant_tpu_torch.train.loop import sub_window

    xm, fi, ti = _gather_inputs(9, W + 40, 21, W, 6, 37, W, torch.bfloat16,
                                cuda)
    ti[1] = 3  # a young anchor: every rank but the last shifts below 0
    x_full, m_full = gather_windows(xm, fi, ti, W)
    for s in range(n_seq):
        wl, shift = sub_window(W, DataMesh(n_seq=n_seq, seq_rank=s))
        _build.reset_launch_counts()
        x, m = gather_windows(xm, fi, ti - shift, wl)
        assert _build.launch_counts()["window_gather"] == 1
        xr, mr = gather_windows_packed(xm, fi, ti - shift, wl)
        assert torch.equal(x.view(torch.uint8), xr.view(torch.uint8))
        assert torch.equal(m, mr)
        blk = slice(s * wl, (s + 1) * wl)
        assert torch.equal(x, x_full[:, :, blk]) and torch.equal(
            m, m_full[:, :, blk])


@pytest.mark.cuda
def test_seed_grid_at_a_32_seed_block(cuda):
    """A seed rank's block of c5 (32 of its 64 members on 2 ranks: S 32 of
    B 2048, T 60, H 128, the LSTM in bf16): the fused forward and its
    backward each one counted launch, the first, a middle and the last
    seed bitwise those of one-seed calls."""
    S, B, T, H = 32, 2048, 60, 128
    gen = torch.Generator(device=cuda).manual_seed(2)

    def bf(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=cuda)).to(
            torch.bfloat16)

    hin, dh = bf(S, B, T, H), bf(S, B, T, H, scale=0.1)
    wx, wh = bf(S, H, 4 * H, scale=H ** -0.5), bf(S, H, 4 * H,
                                                  scale=H ** -0.5)
    b = bf(S, 4 * H, scale=0.1)
    m = torch.rand(S, B, T, generator=gen, device=cuda) < 0.8
    rows = R._mma_rows(
        B, torch.cuda.get_device_properties(cuda).multi_processor_count, S)
    _build.reset_launch_counts()
    h, c = R._fused_states("lstm", hin, wx, b, wh, m, 1.0, True)
    args = (hin, wx, b, wh, m, h, c, dh)
    got = R.rnn_scan_fused_bwd("lstm", *args)
    counts = _build.launch_counts()
    assert counts["rnn_fused_fwd_mma_lstm"] == 1
    assert counts["rnn_fused_bwd_mma_lstm"] == 1
    for s in (0, S // 2, S - 1):
        h1, c1 = R._launch_fwd_mma("lstm", hin[s], wx[s], b[s], wh[s], m[s],
                                   1.0, True, rows)
        assert torch.equal(h[s], h1) and torch.equal(c[s], c1)
        one = R.rnn_scan_fused_bwd("lstm", *(t[s] for t in args))
        for g, o in zip(got, one):
            assert torch.equal(g[s], o)
    for g in (h, *got):
        assert torch.isfinite(g).all()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cuda_core_route_launches_once_per_seed(cuda, cell):
    """float32 on the CUDA-core kernels (their seed grid) with seed-stacked
    operands: one counted launch for all seeds, forward and backward, and
    each seed's result bitwise that seed's one-seed call's; the hoisted
    form too, forward and backward (one ``_Scan`` node for every seed)."""
    S, B, T, H = 3, 21, 5, 1040  # past the grid backward's 1024 too
    per = [_rnn_inputs(cell, B, T, H, s, torch.float32, cuda)
           for s in range(S)]
    hin, wx, b, wh = (torch.stack([p[0][i] for p in per]) for i in range(4))
    m = torch.stack([p[1] for p in per])
    leaves = [t.clone().requires_grad_(True) for t in (hin, wx, b, wh)]
    _build.reset_launch_counts()
    out = rnn_scan_fused(cell, *leaves, m)
    (out ** 2).sum().backward()
    counts = _build.launch_counts()
    assert counts[f"rnn_fused_fwd_{cell}"] == 1
    assert counts[f"rnn_fused_bwd_{cell}"] == 1
    for s in range(S):
        one = [t[s].clone().requires_grad_(True) for t in (hin, wx, b, wh)]
        o = rnn_scan_fused(cell, *one, m[s])
        (o ** 2).sum().backward()
        assert torch.equal(out[s], o)
        for g, r in zip(leaves, one):
            assert torch.equal(g.grad[s], r.grad)
    xw = hin @ wx[:, None] + b[:, None, None]
    _build.reset_launch_counts()
    with torch.no_grad():
        h = rnn_scan(cell, xw, wh, m)
    assert _build.launch_counts()[f"rnn_fwd_{cell}"] == 1
    for s in range(S):
        with torch.no_grad():
            assert torch.equal(h[s], rnn_scan(cell, xw[s], wh[s], m[s]))
    leaves = [t.clone().requires_grad_(True) for t in (xw, wh)]
    _build.reset_launch_counts()
    (rnn_scan(cell, *leaves, m) ** 2).sum().backward()
    counts = _build.launch_counts()
    assert counts[f"rnn_fwd_{cell}"] == 1 and counts[f"rnn_bwd_{cell}"] == 1
    assert counts[f"rnn_bwd_mma_{cell}"] == 0
    for s in range(S):
        one = [t[s].clone().requires_grad_(True) for t in (xw, wh)]
        (rnn_scan(cell, *one, m[s]) ** 2).sum().backward()
        for g, r in zip(leaves, one):
            assert torch.equal(g.grad[s], r.grad)


def _wide_inputs(cell, B, T, H, seed, dtype, device, S=None):
    """Recurrence operands at a wide H, the weights at scale H^-1/2 (gates
    of order one at any width); ``S``: seed-stacked ``[S, ...]``."""
    rng = np.random.default_rng(seed)
    G = GATES[cell] * H
    lead = () if S is None else (S,)
    arrays = [rng.standard_normal(lead + (B, T, H)),
              H ** -0.5 * rng.standard_normal(lead + (H, G)),
              0.1 * rng.standard_normal(lead + (G,)),
              H ** -0.5 * rng.standard_normal(lead + (H, G)),
              0.3 * rng.standard_normal(lead + (B, T, H))]
    hin, wx, b, wh, dh = (torch.from_numpy(a.astype(np.float32)).to(
        dtype).to(device) for a in arrays)
    m = rng.random(lead + (B, T)) < 0.75
    return hin, wx, b, wh, torch.from_numpy(m).to(device), dh


@pytest.mark.cuda
@pytest.mark.parametrize("H", [256, 320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cuda_core_kernels_at_every_width(cuda, cell, dtype, H):
    """Rows 1-4 on the CUDA-core kernels at hidden widths past the 16-row
    blocks' shared memory (the fused LSTM backward took at most H 227,
    the fused forward 302), fused and hoisted, forward and backward,
    against their plain versions: each launch takes the most rows per
    block that fit (``_simt_rows``), counted once. Every kernel is
    launched directly (``_launch_fwd``, ``_launch_bwd``): they are the
    float32 route and the bf16 route past the cluster kernels' widths,
    while bf16 at these widths routes to ``rnn_fwd_cluster.cu`` and
    ``rnn_bwd_cluster.cu``."""
    B, T = 37, 5
    hin, wx, b, wh, m, dh = _wide_inputs(cell, B, T, H, H, dtype, cuda)
    xw = (hin.float() @ wx.float() + b.float()).to(dtype)
    forms = {"fused_fwd": f"rnn_fused_fwd_{cell}", "fwd": f"rnn_fwd_{cell}",
             "fused_bwd": f"rnn_fused_bwd_{cell}", "bwd": f"rnn_bwd_{cell}"}
    rows = {f: R._simt_rows(cell, f, H, cuda) for f in forms}
    assert all(r in R.SIMT_ROWS for r in rows.values())
    _build.reset_launch_counts()
    with torch.no_grad():
        h_f, c_f = R._launch_fwd(cell, False, hin, wx, b, wh, m, 1.0, True)
        h_x, c_x = R._launch_fwd(cell, True, xw, None, None, wh, m, 1.0,
                                 True)
    want_f = rnn_scan_states(cell, hin.float() @ wx.float() + b.float(), wh,
                             m, 1.0, True)
    want_x = rnn_scan_states(cell, xw, wh, m, 1.0, True)
    for got, want in ((h_f, want_f[0]), (c_f, want_f[1]), (h_x, want_x[0]),
                      (c_x, want_x[1])):
        if want is None:
            assert got is None
            continue
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **TOL[dtype])
    h, c = (t if t is None else t.to(dtype) for t in want_f)
    got = R._launch_bwd(cell, True, hin, wx, b, wh, m, h, c, dh, 1.0)
    want = rnn_scan_fused_bwd_reference(cell, hin, wx, b, wh, m, h, c, dh)
    for g, w in zip(got, want):
        _scaled_close(g, w, dtype)
    h, c = (t if t is None else t.to(dtype) for t in want_x)
    got = R._launch_bwd(cell, False, xw, None, None, wh, m, h, c, dh, 1.0)
    want = rnn_scan_bwd_reference(cell, xw, wh, m, h, c, dh)
    for g, w in zip(got, want):
        _scaled_close(g, w, dtype)
    counts = _build.launch_counts()
    assert all(counts[k] == 1 for k in forms.values()), (counts, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cuda_core_rows_per_block_do_not_change_bits(cuda, cell):
    """A row's sums do not depend on the rows per block: the forward and
    the backward at 16 and at 1 row per block give the same bits; a width
    that one row cannot hold raises and names the card's limit."""
    B, T, H = 19, 4, 256
    hin, wx, b, wh, m, dh = _wide_inputs(cell, B, T, H, 3, torch.float32,
                                         cuda)
    xw = hin @ wx + b
    one = R._launch_fwd(cell, True, xw, None, None, wh, m, 1.0, True, 1)
    many = R._launch_fwd(cell, True, xw, None, None, wh, m, 1.0, True, 16)
    for a, z in zip(one, many):
        assert (a is None and z is None) or torch.equal(a, z)
    h, c = one
    one = R._launch_bwd(cell, False, xw, None, None, wh, m, h, c, dh, 1.0, 1)
    many = R._launch_bwd(cell, False, xw, None, None, wh, m, h, c, dh, 1.0,
                         16)
    for a, z in zip(one, many):
        assert torch.equal(a, z)
    limit = torch.cuda.get_device_properties(
        cuda).shared_memory_per_block_optin
    with pytest.raises(ValueError, match=str(limit)):
        R._simt_rows(cell, "fused_bwd", 8192, cuda)


#: The bf16 widths above 128 the cluster forward is held at: its cluster
#: sizes 2, 4, 16 (LSTM) and 2, 4, 8 (GRU), and 200 zero-padded to 208.
CLUSTER_WIDTHS = (144, 200, 256, 320, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("H", CLUSTER_WIDTHS)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cluster_forwards_match_plain(cuda, cell, H):
    """Rows 3 and 1 in bf16 above 128 on ``csrc/rnn_fwd_cluster.cu`` (W_h
    split across a cluster of CTAs; the fused form's xw by the source's
    GEMM in f32), against their plain versions at the JAX bf16 bound: one
    counted launch each, and no CUDA-core forward."""
    B, T = 37, 5
    hin, wx, b, wh, m, _ = _wide_inputs(cell, B, T, H, H, torch.bfloat16,
                                        cuda)
    m[0] = False  # an all-invalid row stays at the zero state
    xw = (hin.float() @ wx.float() + b.float()).to(torch.bfloat16)
    _build.reset_launch_counts()
    with torch.no_grad():
        got_f = R._fused_states(cell, hin, wx, b, wh, m, 1.0, True)
        got_x = R._scan_states_any(cell, xw, wh, m, 1.0, True)
    counts = _build.launch_counts()
    assert counts[f"rnn_fused_fwd_cluster_{cell}"] == 1, counts
    assert counts[f"rnn_fwd_cluster_{cell}"] == 1, counts
    assert sum(counts.values()) == 2, counts
    want_f = rnn_scan_states(cell, hin.float() @ wx.float() + b.float(), wh,
                             m, 1.0, True)
    want_x = rnn_scan_states(cell, xw, wh, m, 1.0, True)
    for got, want in zip((*got_f, *got_x), (*want_f, *want_x)):
        if want is None:
            assert got is None
            continue
        assert got.dtype == torch.bfloat16 and got.shape == (B, T, H)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **TOL[torch.bfloat16])
        assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cluster_seed_grid_bitwise_equals_single_seed_launches(cuda, cell,
                                                               hoisted):
    """The seed rules (``_fwd_vmap`` :920, ``_make_scan._fwd_vmap`` :504)
    on the cluster forward: S 3 seeds with m shared in one counted launch,
    each seed's h_all and c_all bitwise its one-seed launch's."""
    S, B, T, H = 3, 37, 5, 256
    hin, wx, b, wh, m, _ = _wide_inputs(cell, B, T, H, 21, torch.bfloat16,
                                        cuda, S=S)
    m1 = m[:1].contiguous()
    if hoisted:
        xin = (hin.float() @ wx.float()[:, None]
               + b.float()[:, None, None]).to(torch.bfloat16)
        wx = b = None
    else:
        xin = hin
    _build.reset_launch_counts()
    got = R._launch_fwd_cluster(cell, not hoisted, xin, wx, b, wh, m1, 1.0,
                                True)
    name = f"rnn_{'' if hoisted else 'fused_'}fwd_cluster_{cell}"
    assert _build.launch_counts()[name] == 1
    for s in range(S):
        one = R._launch_fwd_cluster(
            cell, not hoisted, xin[s], None if wx is None else wx[s],
            None if b is None else b[s], wh[s], m[0], 1.0, True)
        for g, o in zip(got, one):
            assert (g is None and o is None) or torch.equal(g[s], o)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cluster_rows_and_size_do_not_change_bits(cuda, cell, hoisted):
    """A row's gate sums do not depend on the rows per cluster or on the
    cluster size (the same k order from the same start): H 256 at 16 and
    32 rows on 4 CTAs, and on 8 and 16 CTAs, gives the same bits."""
    B, T, H = 70, 4, 256
    hin, wx, b, wh, m, _ = _wide_inputs(cell, B, T, H, 9, torch.bfloat16,
                                        cuda)
    if hoisted:
        hin = (hin.float() @ wx.float() + b.float()).to(torch.bfloat16)
        wx = b = None
    runs = [R._launch_fwd_cluster(cell, not hoisted, hin, wx, b, wh, m, 1.0,
                                  True, cluster=C, rows=rows)
            for C, rows in ((4, 16), (4, 32), (8, 16), (8, 32), (16, 32))]
    for run in runs[1:]:
        for a, z in zip(runs[0], run):
            assert (a is None and z is None) or torch.equal(a, z)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cluster_autograd_matches_plain(cuda, cell):
    """Through the autograd Function at H 200 (Hp 208): W_h packed once
    per call at the padded width for the cluster forward, whose states and
    f32 xw scratch the cluster backward takes; one launch each way, the
    output and gradients against autograd of the plain version on the
    CPU."""
    B, T, H = 37, 5, 200
    hin, wx, b, wh, m, dh = _wide_inputs(cell, B, T, H, 33, torch.bfloat16,
                                         "cpu")
    outs, grads = [], []
    for dev in ("cpu", cuda):
        leaves = [t.clone().to(dev).requires_grad_(True)
                  for t in (hin, wx, b, wh)]
        _build.reset_launch_counts()
        out = rnn_scan_fused(cell, *leaves, m.to(dev))
        out.float().mul(dh.to(dev).float()).sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    counts = _build.launch_counts()
    assert counts[f"rnn_fused_fwd_cluster_{cell}"] == 1, counts
    assert counts[f"rnn_fused_bwd_cluster_{cell}"] == 1, counts
    assert sum(counts.values()) == 2, counts
    np.testing.assert_allclose(outs[1].float().cpu().numpy(),
                               outs[0].float().numpy(), **TOL[torch.bfloat16])
    for g_card, g_cpu in zip(grads[1], grads[0]):
        assert g_card.shape == g_cpu.shape
        _scaled_close(g_card, g_cpu, torch.bfloat16)


@pytest.mark.cuda
def test_cluster_launch_refused_raises(cuda):
    """No fallback: a cluster the kernel or the card cannot take raises,
    naming the width and the cluster size (LSTM H 256 on 2 CTAs: its W_h
    share is 256 KB; H 512 on 2 CTAs: 32 warps a CTA)."""
    hin, wx, b, wh, m, _ = _wide_inputs("lstm", 5, 3, 256, 1, torch.bfloat16,
                                        cuda)
    with pytest.raises(ValueError, match="hidden=256 on a cluster of 2"):
        R._launch_fwd_cluster("lstm", True, hin, wx, b, wh, m, 1.0, True,
                              cluster=2, rows=16)
    hin, wx, b, wh, m, _ = _wide_inputs("lstm", 5, 3, 512, 1, torch.bfloat16,
                                        cuda)
    with pytest.raises(ValueError, match="hidden=512 with a cluster of 2"):
        R._launch_fwd_cluster("lstm", True, hin, wx, b, wh, m, 1.0, True,
                              cluster=2, rows=16)


def _cluster_bwd_args(cell, B, T, H, seed, device, hoisted, S=None):
    """The backward's operands at a cluster width, bf16: the states of the
    plain forward and an upstream gradient; hoisted, xw in place of hin
    (``wx``, ``b`` None)."""
    hin, wx, b, wh, m, dh = _wide_inputs(cell, B, T, H, seed, torch.bfloat16,
                                         device, S=S)
    if S is None:
        m[0] = False  # an all-invalid row
    mw = m if S is None else m[0]
    if S is not None:
        m = m[:1].contiguous()  # m shared by every seed
    bc = (lambda t: t) if S is None else (lambda t: t[:, None, None])
    xw32 = hin.float() @ (wx.float() if S is None else wx.float()[:, None])
    xw32 = xw32 + bc(b.float())
    states = [rnn_scan_states(cell, xw32[s] if S else xw32, wh[s] if S else
                              wh, mw, 1.0, True) for s in range(S or 1)]
    h = torch.stack([st[0] for st in states])
    c = None if cell == "gru" else torch.stack([st[1] for st in states])
    if S is None:
        h, c = h[0], None if c is None else c[0]
    h, c = h.to(torch.bfloat16), None if c is None else c.to(torch.bfloat16)
    if hoisted:
        return (xw32.to(torch.bfloat16), None, None, wh, m, h, c, dh)
    return (hin, wx, b, wh, m, h, c, dh)


def _cluster_bwd(cell, hoisted, args, **kw):
    return R._launch_bwd_cluster(cell, not hoisted, *args, 1.0, **kw)


def _cluster_bwd_plain(cell, hoisted, args):
    if hoisted:
        xw, _, _, wh, m, h, c, dh = args
        return rnn_scan_bwd_reference(cell, xw, wh, m, h, c, dh)
    return rnn_scan_fused_bwd_reference(cell, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("H", CLUSTER_WIDTHS)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cluster_bwd_matches_plain(cuda, cell, H, hoisted):
    """Rows 4 and 2 in bf16 above 128 on ``csrc/rnn_bwd_cluster.cu`` (W_h
    split across a cluster, the carry's product reduce-scattered through
    distributed shared memory), through the public backward, against the
    plain versions at the scaled bf16 bound: one counted call, no
    CUDA-core backward, dhin/dxw in bf16 and the weight gradients in f32,
    an all-invalid row's dhin/dxw exactly zero. The fused form handed the
    cluster forward's xw scratch gives bitwise the call that recomputes
    it."""
    B, T = 37, 5
    args = _cluster_bwd_args(cell, B, T, H, H + 1, cuda, hoisted)
    _build.reset_launch_counts()
    if hoisted:
        xw, _, _, wh, m, h, c, dh = args
        got = rnn_scan_bwd(cell, xw, wh, m, h, c, dh)
    else:
        got = rnn_scan_fused_bwd(cell, *args)
    counts = _build.launch_counts()
    name = f"rnn_{'' if hoisted else 'fused_'}bwd_cluster_{cell}"
    assert counts[name] == 1 and sum(counts.values()) == 1, counts
    want = _cluster_bwd_plain(cell, hoisted, args)
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        _scaled_close(g, w, torch.bfloat16)
    assert not got[0][0].any()
    if hoisted:
        return
    hin, wx, b, wh, m, _, _, dh = args
    h, c, xw = R._fused_states(cell, hin, wx, b, wh, m, 1.0, True,
                               keep_xw=True)
    assert xw is not None and xw.dtype == torch.float32
    again = rnn_scan_fused_bwd(cell, hin, wx, b, wh, m, h, c, dh)
    reused = rnn_scan_fused_bwd(cell, hin, wx, b, wh, m, h, c, dh, xw=xw)
    for a, z in zip(again, reused):
        assert torch.equal(a, z)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cluster_bwd_seed_grid_bitwise_equals_single_seed_launches(
        cuda, cell, hoisted):
    """The seed rules (``_bwd_vmap`` :952, ``_make_scan._bwd_vmap`` :541)
    on the cluster backward: S 3 seeds with m shared in one counted call,
    each seed's outputs bitwise its one-seed call's."""
    S, B, T, H = 3, 37, 5, 256
    args = _cluster_bwd_args(cell, B, T, H, 23, cuda, hoisted, S=S)
    _build.reset_launch_counts()
    got = _cluster_bwd(cell, hoisted, args)
    name = f"rnn_{'' if hoisted else 'fused_'}bwd_cluster_{cell}"
    assert _build.launch_counts()[name] == 1
    for s in range(S):
        one = _cluster_bwd(cell, hoisted, [
            None if t is None else t[s if t.shape[0] == S else 0]
            for t in args])
        for g, o in zip(got, one):
            assert torch.equal(g[s], o)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("cell,H", [("lstm", 240), ("gru", 256),
                                    ("gru", 336)])
def test_cluster_bwd_rows_and_repeats_do_not_change_bits(cuda, cell, H,
                                                         hoisted):
    """A row's sums do not depend on the rows per cluster: 16 and 32 rows
    (both fit at these widths) give the same bits; and a launch repeated
    gives the same bits (the reduce-scatter adds in rank order, the weight
    gradients' slices in a fixed order, no atomics)."""
    B, T = 70, 4
    args = _cluster_bwd_args(cell, B, T, H, 9, cuda, hoisted)
    C = R._cluster_bwd_size(cell, H, torch.cuda.get_device_properties(
        cuda).shared_memory_per_block_optin)
    assert R._cluster_bwd_takes(H, C, 32)
    runs = [_cluster_bwd(cell, hoisted, args, cluster=C, rows=rows)
            for rows in (16, 32, 16)]
    for run in runs[1:]:
        for a, z in zip(runs[0], run):
            assert torch.equal(a, z)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cluster_bwd_through_autograd(cuda, cell, hoisted):
    """``_FusedScan`` and ``_Scan`` at H 320: one cluster launch each way
    (the fused backward on the forward's xw scratch), the output and
    gradients against autograd of the plain version on the CPU."""
    B, T, H = 37, 5, 320
    hin, wx, b, wh, m, dh = _wide_inputs(cell, B, T, H, 41, torch.bfloat16,
                                         "cpu")
    xw = (hin.float() @ wx.float() + b.float()).to(torch.bfloat16)
    ops = (xw, wh) if hoisted else (hin, wx, b, wh)
    fn = rnn_scan if hoisted else rnn_scan_fused
    outs, grads = [], []
    for dev in ("cpu", cuda):
        leaves = [t.clone().to(dev).requires_grad_(True) for t in ops]
        _build.reset_launch_counts()
        out = fn(cell, *leaves, m.to(dev))
        out.float().mul(dh.to(dev).float()).sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    counts = _build.launch_counts()
    form = "" if hoisted else "fused_"
    assert counts[f"rnn_{form}fwd_cluster_{cell}"] == 1, counts
    assert counts[f"rnn_{form}bwd_cluster_{cell}"] == 1, counts
    assert sum(counts.values()) == 2, counts
    np.testing.assert_allclose(outs[1].float().cpu().numpy(),
                               outs[0].float().numpy(), **TOL[torch.bfloat16])
    for g_card, g_cpu in zip(grads[1], grads[0]):
        assert g_card.shape == g_cpu.shape
        _scaled_close(g_card, g_cpu, torch.bfloat16)


@pytest.mark.cuda
def test_cluster_bwd_launch_refused_raises(cuda):
    """No fallback: a cluster the backward or the card cannot take raises,
    naming the width and the cluster size (LSTM H 512 on 8 CTAs: its share
    is past the card's shared memory; on 2 CTAs: 32 warps a CTA)."""
    args = _cluster_bwd_args("lstm", 5, 3, 512, 1, cuda, False)
    with pytest.raises(ValueError, match="hidden=512 on a cluster of 8"):
        _cluster_bwd("lstm", False, args, cluster=8, rows=16)
    with pytest.raises(ValueError, match="hidden=512 with a cluster of 2"):
        _cluster_bwd("lstm", False, args, cluster=2, rows=16)


#: A hoisted route, its dtype and a width it serves (the CUDA cores take
#: float32 backwards only past the grid kernel's widths, bf16 past the
#: bf16 grid kernel's).
HOISTED_ROUTES = {"mma": (torch.bfloat16, 64), "tf32": (torch.float32, 64),
                  "simt": (torch.float32, 1040), "simt_bf16": (
                      torch.bfloat16, 1536),
                  "cluster": (torch.bfloat16, 256),
                  "tf32_cluster": (torch.float32, 160),
                  "grid": (torch.float32, 400),
                  "grid_bf16": (torch.bfloat16, 528)}
#: The launch counters' tag of each hoisted route, forward and backward
#: (float32 above 128: the float32 grid forward, the 3xTF32 cluster or
#: the grid backward; float32 past 1024 the CUDA cores; bf16 past 512: the
#: bf16 grids both ways).
FWD_TAG = {"mma": "mma_", "tf32": "tf32_", "cluster": "cluster_",
           "tf32_cluster": "grid_", "grid": "grid_",
           "grid_bf16": "grid_bf16_"}
BWD_TAG = dict(FWD_TAG, tf32_cluster="tf32_", grid="grid_",
               grid_bf16="grid_bf16_")


@pytest.mark.cuda
@pytest.mark.parametrize("shared", ["none", "m", "wh", "xw"])
@pytest.mark.parametrize("route", sorted(HOISTED_ROUTES))
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_hoisted_seed_grid_bitwise_equals_single_seed_launches(
        cuda, cell, route, shared):
    """Rows 1 and 2 under the seed rules (``_make_scan._fwd_vmap`` and
    ``_bwd_vmap``): a seed-stacked ``rnn_scan`` is one autograd node, one
    counted forward launch and one backward call on each route, and each
    seed's output and gradients are bitwise a one-seed call's; an operand
    of seed extent 1 is shared, and its gradient is the seeds' sum."""
    dtype, H = HOISTED_ROUTES[route]
    S, B, T = 3, 21, 6
    hin, wx, b, wh, m, dh = _wide_inputs(cell, B, T, H, 11, dtype, cuda,
                                         S=S)
    xw = (hin.float() @ wx.float()[:, None] + b.float()[:, None, None]).to(
        dtype)
    ops = {"xw": xw, "wh": wh, "m": m}
    if shared != "none":
        ops[shared] = ops[shared][:1].contiguous()
    leaves = [ops[k].clone().requires_grad_(True) for k in ("xw", "wh")]
    _build.reset_launch_counts()
    out = rnn_scan(cell, *leaves, ops["m"])
    assert out.grad_fn is not None and out.shape == (S, B, T, H)
    out.float().mul(dh.float()).sum().backward()
    counts = _build.launch_counts()
    assert counts[f"rnn_fwd_{FWD_TAG.get(route, '')}{cell}"] == 1, counts
    assert counts[f"rnn_bwd_{BWD_TAG.get(route, '')}{cell}"] == 1, counts
    grads = []
    for s in range(S):
        one = [(t[s] if t.shape[0] > 1 else t[0]).clone().requires_grad_(True)
               for t in (ops["xw"], ops["wh"])]
        o = rnn_scan(cell, *one, ops["m"][s if shared != "m" else 0])
        o.float().mul(dh[s].float()).sum().backward()
        assert torch.equal(out[s], o)
        grads.append([t.grad for t in one])
    for i, leaf in enumerate(leaves):
        each = torch.stack([g[i] for g in grads])
        if leaf.shape[0] > 1:
            assert torch.equal(leaf.grad, each)
        elif dtype == torch.float32 or i == 0:
            assert torch.equal(leaf.grad[0], each.sum(dim=0))
        else:
            # bf16 W_h: the f32 sum of the seeds' f32 dW_h, rounded once,
            # against the sum of the one-seed calls' rounded ones.
            _scaled_close(leaf.grad[0], each.float().sum(dim=0), dtype)


def _tf32_names(cell, hoisted):
    form = "" if hoisted else "fused_"
    return f"rnn_{form}bwd_tf32_{cell}", f"rnn_{form}bwd_{cell}"


@pytest.mark.cuda
@pytest.mark.parametrize("B", [37, 2048 + 5])
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("H", [16, 64, 128])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_tf32_bwd_matches_plain(cuda, cell, H, hoisted, B):
    """The float32 backward on the tensor cores (``csrc/rnn_bwd_tf32.cu``,
    3xTF32; a 2-CTA cluster at H = 128) against its plain formulas at the
    JAX f32 bound (gradients scaled by their largest magnitude, atol
    1e-5): fused and hoisted forms, B leaving the last block part-filled,
    an all-invalid row passing no gradient; two launches bitwise equal."""
    T = 9
    hin, wx, b, wh, m, xw, h, c, dh = _bwd_inputs(cell, B, T, H, B + H,
                                                  torch.float32, cuda,
                                                  hoisted)
    if hoisted:
        args = (cell, xw, wh, m, h, c, dh)
        run, plain = rnn_scan_bwd, rnn_scan_bwd_reference
    else:
        args = (cell, hin, wx, b, wh, m, h, c, dh)
        run, plain = rnn_scan_fused_bwd, rnn_scan_fused_bwd_reference
    tf32, simt = _tf32_names(cell, hoisted)
    _build.reset_launch_counts()
    got = run(*args)
    counts = _build.launch_counts()
    assert counts[tf32] == 1 and counts[simt] == 0
    want = plain(*args)
    assert got[0].dtype == torch.float32
    assert got[0].shape == (xw if hoisted else hin).shape
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _scaled_close(g, w, torch.float32)
    assert not got[0][0].any()  # an all-invalid row passes no gradient
    again = run(*args)
    for a, z in zip(got, again):
        assert torch.equal(a, z)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_tf32_bwd_seed_grid_bitwise_equals_single_seed_launches(cuda, cell,
                                                               H):
    """S = 3 seeds of the float32 fused backward in one call (counted once)
    against 3 one-seed calls: every output bitwise equal; m of seed extent
    1 bitwise equal to its broadcast copy; each seed within the f32 bound
    of the plain version."""
    S, B, T = 3, 517, 7
    per = [_bwd_inputs(cell, B, T, H, 40 + s, torch.float32, cuda, False)
           for s in range(S)]
    keep = (0, 1, 2, 3, 4, 6, 7, 8)  # hin, wx, b, wh, m, h, c, dh
    args = [None if per[0][i] is None else torch.stack([p[i] for p in per])
            for i in keep]
    _build.reset_launch_counts()
    got = rnn_scan_fused_bwd(cell, *args)
    counts = _build.launch_counts()
    assert counts[f"rnn_fused_bwd_tf32_{cell}"] == 1
    assert counts[f"rnn_fused_bwd_{cell}"] == 0
    for s in range(S):
        one = rnn_scan_fused_bwd(cell, *(None if t is None else t[s]
                                         for t in args))
        want = rnn_scan_fused_bwd_reference(cell, *(None if t is None
                                                     else t[s] for t in args))
        for g, o, w in zip(got, one, want):
            assert torch.equal(g[s], o)
            _scaled_close(o, w, torch.float32)
    shared, full = list(args), list(args)
    shared[4] = args[4][:1]
    full[4] = args[4][:1].expand(S, B, T).contiguous()
    for g, r in zip(rnn_scan_fused_bwd(cell, *shared),
                    rnn_scan_fused_bwd(cell, *full)):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [37, 2048 + 5])
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("H", [16, 64, 128])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_tf32_fwd_matches_plain(cuda, cell, H, hoisted, B):
    """The float32 forward on the tensor cores (``csrc/rnn_fwd_tf32.cu``,
    3xTF32; a 2-CTA cluster at H = 128) against its plain version at the
    JAX f32 bound (atol 1e-5), h_all and the LSTM's c_all: fused and
    hoisted forms, B leaving the last cluster's rows part-filled, an
    all-invalid row that stays at zero; counted once, no CUDA-core
    forward."""
    T = 9
    (hin, wx, b, wh), m = _rnn_inputs(cell, B, T, H, B + H,
                                      torch.float32, cuda)
    xw = hin @ wx + b
    name = f"rnn_{'' if hoisted else 'fused_'}fwd_tf32_{cell}"
    _build.reset_launch_counts()
    with torch.no_grad():
        if hoisted:
            h, c = R._scan_states_any(cell, xw, wh, m, 1.0, True)
        else:
            h, c = R._fused_states(cell, hin, wx, b, wh, m, 1.0, True)
    counts = _build.launch_counts()
    assert counts[name] == 1 and sum(counts.values()) == 1
    want_h, want_c = rnn_scan_states(cell, xw, wh, m, 1.0, True)
    assert h.dtype == torch.float32 and h.shape == (B, T, H)
    pairs = [(h, want_h)] + ([(c, want_c)] if cell == "lstm" else [])
    for got, want in pairs:
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-5, rtol=0.0)
        assert not got[0].any()  # an all-invalid row stays at zero
    assert (c is None) == (cell == "gru")


@pytest.mark.cuda
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_tf32_fwd_seed_grid_bitwise_equals_single_seed_launches(cuda, cell,
                                                               H):
    """S = 3 seeds of the float32 fused forward in one call (counted once)
    against 3 one-seed calls: h and c bitwise equal; b of seed extent 1
    bitwise equal to its broadcast copy; each seed within the f32 bound of
    the plain version."""
    S, B, T = 3, 517, 7
    per = [_rnn_inputs(cell, B, T, H, 60 + s, torch.float32, cuda)
           for s in range(S)]
    hin, wx, b, wh = (torch.stack([p[0][i] for p in per]) for i in range(4))
    m = torch.stack([p[1] for p in per])
    b = b[:1]  # shared by every seed
    _build.reset_launch_counts()
    h, c = R._fused_states(cell, hin, wx, b, wh, m, 1.0, True)
    counts = _build.launch_counts()
    assert counts[f"rnn_fused_fwd_tf32_{cell}"] == 1
    assert counts[f"rnn_fused_fwd_{cell}"] == 0
    assert h.shape == (S, B, T, H)
    for s in range(S):
        h1, c1 = R._fused_states(cell, hin[s], wx[s], b[0], wh[s], m[s],
                                 1.0, True)
        assert torch.equal(h[s], h1)
        if cell == "lstm":
            assert torch.equal(c[s], c1)
        want = rnn_scan_fused_reference(cell, hin[s], wx[s], b[0], wh[s],
                                        m[s])
        np.testing.assert_allclose(h1.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-5, rtol=0.0)
    full, _ = R._fused_states(cell, hin, wx, b.expand(S, -1).contiguous(),
                              wh, m, 1.0, False)
    shared, _ = R._fused_states(cell, hin, wx, b, wh, m, 1.0, False)
    assert torch.equal(shared, full)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_tf32_fused_backward_takes_the_forward_xw(cuda, cell):
    """Under autograd the float32 fused forward's xw scratch is the
    backward's d_gates buffer: the gradients (one forward and one backward
    launch) equal, bitwise, the backward handed the same xw directly, and
    lie within the scaled f32 bound of the backward that forms its own."""
    B, T, H = 37, 6, 64
    (hin, wx, b, wh), m = _rnn_inputs(cell, B, T, H, 71, torch.float32,
                                      cuda)
    dh = torch.randn(B, T, H, generator=torch.Generator().manual_seed(72)
                     ).to(cuda)
    ops = [t.clone().requires_grad_() for t in (hin, wx, b, wh)]
    _build.reset_launch_counts()
    rnn_scan_fused(cell, *ops, m).backward(dh)
    counts = _build.launch_counts()
    assert counts[f"rnn_fused_fwd_tf32_{cell}"] == 1
    assert counts[f"rnn_fused_bwd_tf32_{cell}"] == 1
    got = [t.grad for t in ops]
    with torch.no_grad():
        h, c, xw = R._fused_states(cell, hin, wx, b, wh, m, 1.0, True,
                                   keep_xw=True)
        same = R.rnn_scan_fused_bwd(cell, hin, wx, b, wh, m, h, c, dh, 1.0,
                                    xw=xw)
        own = R.rnn_scan_fused_bwd(cell, hin, wx, b, wh, m, h, c, dh, 1.0)
    for g, s, o in zip(got, same, own):
        assert torch.equal(g, s)
        assert (g - o).abs().max() <= 1e-5 * o.abs().max()


#: The float32 widths above 128 the 3xTF32 cluster backward is held at:
#: its cluster sizes 2 (LSTM 144, GRU 144 and 160), 4, 8 and 16, 16 and 32
#: rows, 200 zero-padded to 208, and the cap, 384.
TF32_WIDE = (144, 160, 176)


def _tf32_wide_args(cell, B, T, H, seed, device, hoisted, S=None):
    """The float32 backward's operands at a width above 128: the states
    of the plain forward and an upstream gradient; hoisted, xw in place
    of hin (``wx``, ``b`` None); seed-stacked with W_h shared (seed
    extent 1)."""
    hin, wx, b, wh, m, dh = _wide_inputs(cell, B, T, H, seed, torch.float32,
                                         device, S=S)
    if S is None:
        m[0] = False  # an all-invalid row
        xw = hin @ wx + b
        h, c = rnn_scan_states(cell, xw, wh, m, 1.0, True)
    else:
        wh = wh[:1].contiguous()
        xw = hin @ wx[:, None] + b[:, None, None]
        states = [rnn_scan_states(cell, xw[s], wh[0], m[s], 1.0, True)
                  for s in range(S)]
        h = torch.stack([st[0] for st in states])
        c = None if cell == "gru" else torch.stack([st[1] for st in states])
    if hoisted:
        return (xw, None, None, wh, m, h, c, dh)
    return (hin, wx, b, wh, m, h, c, dh)


def _tf32_wide(cell, hoisted, args, **kw):
    return R._launch_bwd_tf32(cell, not hoisted, *args, 1.0, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("H", TF32_WIDE)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_tf32_cluster_bwd_matches_plain(cuda, cell, H, hoisted):
    """Rows 4 and 2 in float32 above 128 on ``csrc/rnn_bwd_tf32.cu`` (W_h
    split across a cluster of 2 or 4 CTAs, the carry's product
    reduce-scattered), through the public backward at every width the
    route gives it (to ``TF32_MAX_WIDTH``), against the plain versions at
    the JAX f32 bound (gradients scaled, atol 1e-5): one counted call, no
    CUDA-core backward, an all-invalid row's dhin/dxw exactly zero, and a
    second call bitwise equal."""
    B, T = 37, 5
    args = _tf32_wide_args(cell, B, T, H, H + 3, cuda, hoisted)
    assert R._mma_route(torch.float32, H, "bwd") == "tf32"
    if hoisted:
        xw, _, _, wh, m, h, c, dh = args
        run = (lambda: rnn_scan_bwd(cell, xw, wh, m, h, c, dh))
        want = rnn_scan_bwd_reference(cell, xw, wh, m, h, c, dh)
    else:
        run = (lambda: rnn_scan_fused_bwd(cell, *args))
        want = rnn_scan_fused_bwd_reference(cell, *args)
    _build.reset_launch_counts()
    got = run()
    counts = _build.launch_counts()
    tc, core = _tf32_names(cell, hoisted)
    assert counts[tc] == 1 and sum(counts.values()) == 1, counts
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        _scaled_close(g, w, torch.float32)
    assert not got[0][0].any()
    for a, z in zip(got, run()):
        assert torch.equal(a, z)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_tf32_cluster_bwd_seed_grid_bitwise_equals_single_seed_launches(
        cuda, cell, hoisted):
    """The seed rules (``_bwd_vmap`` :951, ``_make_scan._bwd_vmap`` :541)
    on the float32 cluster backward at H 176: S 3 seeds with W_h shared in
    one counted call, each seed's outputs bitwise its one-seed call's."""
    S, B, T, H = 3, 37, 5, 176
    args = _tf32_wide_args(cell, B, T, H, 29, cuda, hoisted, S=S)
    _build.reset_launch_counts()
    got = _tf32_wide(cell, hoisted, args)
    assert _build.launch_counts()[_tf32_names(cell, hoisted)[0]] == 1
    for s in range(S):
        one = _tf32_wide(cell, hoisted, [
            None if t is None else t[s if t.shape[0] == S else 0]
            for t in args])
        for g, o in zip(got, one):
            assert torch.equal(g[s], o)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("cell,H", [("lstm", 160), ("gru", 176)])
def test_tf32_cluster_bwd_rows_do_not_change_bits(cuda, cell, H, hoisted):
    """A row's sums do not depend on the rows per cluster: 16 and 32 rows
    on 4 CTAs (both taken and fitting at these widths; the GRU's picked 2
    CTAs take 16 rows alone) give the same bits."""
    B, T = 70, 4
    args = _tf32_wide_args(cell, B, T, H, 13, cuda, hoisted)
    C = 4
    assert R._tf32_takes(H, C, 32)
    runs = [_tf32_wide(cell, hoisted, args, cluster=C, rows=rows)
            for rows in (16, 32)]
    for a, z in zip(*runs):
        assert torch.equal(a, z)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_tf32_cluster_bwd_through_autograd(cuda, cell, hoisted):
    """``_FusedScan`` and ``_Scan`` in float32 at H 160: the forward on the
    float32 grid (``rnn_fwd_tf32_grid.cu``), the backward on the 3xTF32
    cluster (the fused form on the forward's xw scratch), one launch each;
    the output and gradients against autograd of the plain version on the
    CPU."""
    B, T, H = 37, 5, 160
    hin, wx, b, wh, m, dh = _wide_inputs(cell, B, T, H, 43, torch.float32,
                                         "cpu")
    xw = hin @ wx + b
    ops = (xw, wh) if hoisted else (hin, wx, b, wh)
    fn = rnn_scan if hoisted else rnn_scan_fused
    outs, grads = [], []
    for dev in ("cpu", cuda):
        leaves = [t.clone().to(dev).requires_grad_(True) for t in ops]
        _build.reset_launch_counts()
        out = fn(cell, *leaves, m.to(dev))
        out.mul(dh.to(dev)).sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    counts = _build.launch_counts()
    form = "" if hoisted else "fused_"
    assert counts[f"rnn_{form}fwd_grid_{cell}"] == 1, counts
    assert counts[f"rnn_{form}bwd_tf32_{cell}"] == 1, counts
    assert sum(counts.values()) == 2, counts
    np.testing.assert_allclose(outs[1].cpu().numpy(), outs[0].numpy(),
                               **TOL[torch.float32])
    for g_card, g_cpu in zip(grads[1], grads[0]):
        assert g_card.shape == g_cpu.shape
        _scaled_close(g_card, g_cpu, torch.float32)


@pytest.mark.cuda
def test_tf32_cluster_bwd_launch_refused_raises(cuda):
    """No fallback: a cluster the float32 backward or the card cannot take
    raises, naming the width and the cluster size (the LSTM at H 176 on 2
    CTAs: its share is past the card's shared memory; on 8 CTAs: no such
    cluster size)."""
    args = _tf32_wide_args("lstm", 5, 3, 176, 1, cuda, False)
    with pytest.raises(ValueError, match="hidden=176 on a cluster of 2"):
        _tf32_wide("lstm", False, args, cluster=2, rows=16)
    with pytest.raises(ValueError, match="hidden=176 with a cluster of 8"):
        _tf32_wide("lstm", False, args, cluster=8, rows=16)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_widths_past_the_caps_keep_rnn_bwd(cuda, cell, hoisted):
    """float32 past the grid backward's 1024 (H 1040) and bf16 past the
    bf16 grid backward's 1520 (H 1530, Hp 1536) stay on ``csrc/rnn_bwd.cu``
    through the public backward, one counted call each, within the JAX
    bounds of the plain version: in float32 the plain version run on
    float64 copies of the same inputs (the exact value; the float32 plain
    version is itself 1.1e-5 of it, scaled, at H 1040), in bf16 as it
    is."""
    for dtype, H in ((torch.float32, 1040), (torch.bfloat16, 1530)):
        hin, wx, b, wh, m, xw, h, c, dh = _bwd_inputs(cell, 21, 4, H, H,
                                                      dtype, cuda, hoisted)
        ref = ((lambda t: t) if dtype == torch.bfloat16 else
               (lambda t: None if t is None else t.double()))
        _build.reset_launch_counts()
        if hoisted:
            got = rnn_scan_bwd(cell, xw, wh, m, h, c, dh)
            counts = _build.launch_counts()
            want = rnn_scan_bwd_reference(cell, *map(ref, (xw, wh)), m,
                                          *map(ref, (h, c, dh)))
        else:
            got = rnn_scan_fused_bwd(cell, hin, wx, b, wh, m, h, c, dh)
            counts = _build.launch_counts()
            want = rnn_scan_fused_bwd_reference(
                cell, *map(ref, (hin, wx, b, wh)), m, *map(ref, (h, c, dh)))
        core = _tf32_names(cell, hoisted)[1]
        assert counts[core] == 1 and sum(counts.values()) == 1, counts
        for g, w in zip(got, want):
            _scaled_close(g, w, dtype)


#: The float32 widths past 384 the grid backward is held at: its first
#: (400: the LSTM's 17 CTAs a group of 64 rows), 420 zero-padded to 432,
#: 640 (the LSTM's 40 CTAs) and its widest, 1024 (the LSTM's 128 CTAs of
#: 128 rows).
GRID_WIDTHS = (400, 420, 640, 1024)


def _grid_names(cell, hoisted):
    form = "" if hoisted else "fused_"
    return f"rnn_{form}bwd_grid_{cell}", f"rnn_{form}bwd_{cell}"


def _grid(cell, hoisted, args, **kw):
    return R._launch_bwd_grid(cell, not hoisted, *args, 1.0, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("H", GRID_WIDTHS)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_grid_bwd_matches_plain(cuda, cell, H, hoisted):
    """Rows 4 and 2 in float32 past 384 on ``csrc/rnn_bwd_tf32_grid.cu``
    (the gates by one GEMM, the carry's product over a cooperative grid
    holding W_h), through the public backward, against the plain versions
    at the JAX f32 bound (gradients scaled, atol 1e-5): one counted call,
    no CUDA-core backward, an all-invalid row's dhin/dxw exactly zero, a
    second call bitwise equal. B 200 is several work items a group."""
    B, T = 200, 5
    args = _tf32_wide_args(cell, B, T, H, H + 5, cuda, hoisted)
    if hoisted:
        xw, _, _, wh, m, h, c, dh = args
        run = lambda: rnn_scan_bwd(cell, xw, wh, m, h, c, dh)  # noqa: E731
        want = rnn_scan_bwd_reference(cell, xw, wh, m, h, c, dh)
    else:
        run = lambda: rnn_scan_fused_bwd(cell, *args)  # noqa: E731
        want = rnn_scan_fused_bwd_reference(cell, *args)
    _build.reset_launch_counts()
    got = run()
    counts = _build.launch_counts()
    assert counts[_grid_names(cell, hoisted)[0]] == 1, counts
    assert sum(counts.values()) == 1, counts
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        _scaled_close(g, w, torch.float32)
    assert not got[0][0].any()
    for a, z in zip(got, run()):
        assert torch.equal(a, z)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_grid_bwd_seed_grid_bitwise_equals_single_seed_launches(
        cuda, cell, hoisted):
    """The seed rules (``_bwd_vmap`` :952, ``_make_scan._bwd_vmap`` :541)
    on the grid backward at H 400: S 3 seeds with W_h shared in one
    counted call, each seed's outputs bitwise its one-seed call's."""
    S, B, T, H = 3, 150, 5, 400
    args = _tf32_wide_args(cell, B, T, H, 31, cuda, hoisted, S=S)
    _build.reset_launch_counts()
    got = _grid(cell, hoisted, args)
    assert _build.launch_counts()[_grid_names(cell, hoisted)[0]] == 1
    for s in range(S):
        one = _grid(cell, hoisted, [
            None if t is None else t[s if t.shape[0] == S else 0]
            for t in args])
        for g, o in zip(got, one):
            assert torch.equal(g[s], o)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("cell,H", [("lstm", 400), ("gru", 640)])
def test_grid_bwd_group_and_rows_do_not_change_bits(cuda, cell, H, hoisted):
    """A (row, unit)'s sums run over every gate column in one k order
    whatever CTA forms them: the picked group, a larger one (fewer chunks
    a CTA), 64 and 128 rows a work item, and fewer groups than the card
    holds all give the same bits."""
    B, T = 300, 4
    args = _tf32_wide_args(cell, B, T, H, 17, cuda, hoisted)
    props = torch.cuda.get_device_properties(cuda)
    n = R._grid_size(cell, H, props.shared_memory_per_block_optin,
                     props.multi_processor_count)
    runs = [_grid(cell, hoisted, args, group=n, rows=64),
            _grid(cell, hoisted, args, group=n, rows=64, groups=1),
            _grid(cell, hoisted, args, group=2 * n, rows=128),
            _grid(cell, hoisted, args, group=H // 8, rows=64)]
    for other in runs[1:]:
        for a, z in zip(runs[0], other):
            assert torch.equal(a, z)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_grid_fused_backward_takes_the_forward_xw(cuda, cell):
    """Handed the forward's xw (here ``hin @ W_x + b`` in f32, as a
    forward's scratch holds it), the fused grid backward skips its own xw
    GEMM and overwrites the scratch with d_xw: one counted call, within the
    scaled f32 bound of the plain version and of the call that forms its
    own xw, the scratch then d_xw within that bound."""
    B, T, H = 120, 5, 400
    args = _tf32_wide_args(cell, B, T, H, 37, cuda, False)
    hin, wx, b, wh, m, h, c, dh = args
    xw = hin @ wx + b
    d_xw = R._scan_bwd_core(cell, xw.clone(), wh, m, h, c, dh, 1.0)[0]
    want = rnn_scan_fused_bwd_reference(cell, *args)
    own = rnn_scan_fused_bwd(cell, *args)
    _build.reset_launch_counts()
    got = rnn_scan_fused_bwd(cell, *args, 1.0, xw=xw)
    counts = _build.launch_counts()
    assert counts[f"rnn_fused_bwd_grid_{cell}"] == 1
    assert sum(counts.values()) == 1, counts
    for g, w, o in zip(got, want, own):
        _scaled_close(g, w, torch.float32)
        _scaled_close(g, o, torch.float32)
    _scaled_close(xw, d_xw, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_grid_bwd_through_autograd(cuda, cell):
    """``_FusedScan`` in float32 at H 400: the forward on the float32 grid
    (``rnn_fwd_tf32_grid.cu``), the backward on the grid on the forward's
    xw scratch, one launch each; the gradients against autograd of the
    plain version on the CPU."""
    B, T, H = 37, 5, 400
    hin, wx, b, wh, m, dh = _wide_inputs(cell, B, T, H, 47, torch.float32,
                                         "cpu")
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.clone().to(dev).requires_grad_(True)
                  for t in (hin, wx, b, wh)]
        _build.reset_launch_counts()
        out = rnn_scan_fused(cell, *leaves, m.to(dev))
        out.mul(dh.to(dev)).sum().backward()
        grads.append([t.grad for t in leaves])
    counts = _build.launch_counts()
    assert counts[f"rnn_fused_fwd_grid_{cell}"] == 1, counts
    assert counts[f"rnn_fused_bwd_grid_{cell}"] == 1, counts
    assert sum(counts.values()) == 2, counts
    for g_card, g_cpu in zip(grads[1], grads[0]):
        _scaled_close(g_card, g_cpu, torch.float32)


@pytest.mark.cuda
def test_grid_bwd_launch_refused_raises(cuda):
    """No fallback: a grid the card cannot hold at once (one group more
    than its SMs take) is refused by the cooperative launch before any
    kernel runs, naming the width and the groups; a group the kernel does
    not take raises, naming the width."""
    args = _tf32_wide_args("lstm", 37, 3, 400, 1, cuda, False)
    props = torch.cuda.get_device_properties(cuda)
    n = R._grid_size("lstm", 400, props.shared_memory_per_block_optin,
                     props.multi_processor_count)
    ctas = R._grid_check("lstm", 400, n, 64, cuda)
    _build.reset_launch_counts()
    with pytest.raises(RuntimeError, match="hidden=400"):
        _grid("lstm", False, args, group=n, rows=64, groups=ctas // n + 1)
    with pytest.raises(ValueError, match="hidden=400 with a group of 2"):
        _grid("lstm", False, args, group=2, rows=64)
    assert not any(_build.launch_counts().values())


#: The bf16 widths past 512 the bf16 grid backward is held at: H 520
#: zero-padded to 528, 528 (17 CTAs a group), 640, 1024 and its widest,
#: 1520 (the LSTM's one group of 95 CTAs).
BF16_GRID_WIDTHS = (520, 528, 640, 1024, 1520)


def _bf16_grid(cell, hoisted, args, **kw):
    """The bf16 grid backward on ``args`` at any H, zero-padded to Hp as
    the public backward pads it (``padded_launch``)."""
    form = "bwd" if hoisted else "fused_bwd"
    ops = [a for i, a in enumerate(args) if not (hoisted and i in (1, 2))]
    return R.padded_launch(R._tensor_core_launcher("grid", form), form)(
        cell, *ops, 1.0, **kw)


def _bf16_grid_name(cell, hoisted):
    return f"rnn_{'' if hoisted else 'fused_'}bwd_grid_bf16_{cell}"


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("H", BF16_GRID_WIDTHS)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_grid_bwd_matches_plain(cuda, cell, H, hoisted):
    """Rows 4 and 2 in bf16 past 512 on ``csrc/rnn_bwd_grid.cu`` (the gates
    by one bf16 GEMM, the carry's product over a cooperative grid holding
    W_h in bf16), through the public backward, against the plain versions
    at the JAX bf16 bound (gradients scaled, atol 0.05): one counted call,
    no other backward, dhin/dxw in bf16 and the weight gradients in f32,
    an all-invalid row's dhin/dxw exactly zero, a second call bitwise
    equal; and the same bits from a larger group, 128 rows a work item
    where the kernel takes them, and one group. B 150 is several work
    items a group."""
    B, T = 150, 4
    args = _cluster_bwd_args(cell, B, T, H, H + 3, cuda, hoisted)
    if hoisted:
        xw, _, _, wh, m, h, c, dh = args
        run = lambda: rnn_scan_bwd(cell, xw, wh, m, h, c, dh)  # noqa: E731
        want = rnn_scan_bwd_reference(cell, xw, wh, m, h, c, dh)
    else:
        run = lambda: rnn_scan_fused_bwd(cell, *args)  # noqa: E731
        want = rnn_scan_fused_bwd_reference(cell, *args)
    _build.reset_launch_counts()
    got = run()
    counts = _build.launch_counts()
    assert counts[_bf16_grid_name(cell, hoisted)] == 1, counts
    assert sum(counts.values()) == 1, counts
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g.float()).all()
        _scaled_close(g, w, torch.bfloat16)
    assert not got[0][0].float().any()
    for a, z in zip(got, run()):
        assert torch.equal(a, z)
    Hp = R._padded_width(H)
    props = torch.cuda.get_device_properties(cuda)
    limit = props.shared_memory_per_block_optin
    n = R._grid_size(cell, Hp, limit, props.multi_processor_count,
                     torch.bfloat16)
    pairs = [dict(group=n, rows=64, groups=1)]
    for more, rows in ((n + 3, 64), (n, 128), (Hp // 8, 64)):
        if (more <= props.multi_processor_count
                and R._grid_takes(Hp, more, rows, torch.bfloat16)
                and R._grid_smem(cell, Hp, more, rows,
                                 torch.bfloat16) <= limit):
            pairs.append(dict(group=more, rows=rows))
    for kw in pairs:
        for a, z in zip(got, _bf16_grid(cell, hoisted, args, **kw)):
            assert torch.equal(a, z), kw


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("H", BF16_GRID_WIDTHS)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_grid_bwd_seed_grid_bitwise_equals_single_seed_launches(
        cuda, cell, H, hoisted):
    """The seed rules (``_bwd_vmap`` :952, ``_make_scan._bwd_vmap`` :541)
    on the bf16 grid backward: S 3 seeds (W_h per seed, m shared) in one
    counted call, each seed's outputs bitwise its one-seed call's."""
    S, B, T = 3, 70, 3
    args = _cluster_bwd_args(cell, B, T, H, 41, cuda, hoisted, S=S)
    _build.reset_launch_counts()
    got = _bf16_grid(cell, hoisted, args)
    assert _build.launch_counts()[_bf16_grid_name(cell, hoisted)] == 1
    for s in range(S):
        one = _bf16_grid(cell, hoisted, [
            None if t is None else t[s if t.shape[0] == S else 0]
            for t in args])
        for g, o in zip(got, one):
            assert torch.equal(g[s], o)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("H", BF16_GRID_WIDTHS)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_grid_bwd_launch_refused_raises(cuda, cell, H, hoisted):
    """No fallback: a grid of one group more than the card holds at once is
    refused by the cooperative launch before any kernel runs, naming the
    width and the groups."""
    args = _cluster_bwd_args(cell, 37, 3, H, 5, cuda, hoisted)
    Hp = R._padded_width(H)
    props = torch.cuda.get_device_properties(cuda)
    n = R._grid_size(cell, Hp, props.shared_memory_per_block_optin,
                     props.multi_processor_count, torch.bfloat16)
    ctas = R._grid_check(cell, Hp, n, 64, cuda, torch.bfloat16)
    _build.reset_launch_counts()
    with pytest.raises(RuntimeError, match=f"hidden={Hp}, {ctas // n + 1} "
                                           f"groups of {n} CTAs"):
        _bf16_grid(cell, hoisted, args, group=n, rows=64,
                   groups=ctas // n + 1)
    assert not any(_build.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bf16_grid_bwd_through_autograd(cuda, cell):
    """``_FusedScan`` in bf16 at H 528: the forward on the bf16 grid
    (``rnn_fwd_grid.cu``), whose f32 xw scratch the backward on the bf16
    grid takes, one launch each; the gradients against autograd of the
    plain version on the CPU at the bf16 bound."""
    B, T, H = 37, 5, 528
    hin, wx, b, wh, m, dh = _wide_inputs(cell, B, T, H, 53, torch.bfloat16,
                                         "cpu")
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.clone().to(dev).requires_grad_(True)
                  for t in (hin, wx, b, wh)]
        _build.reset_launch_counts()
        out = rnn_scan_fused(cell, *leaves, m.to(dev))
        out.float().mul(dh.float().to(dev)).sum().backward()
        grads.append([t.grad for t in leaves])
    counts = _build.launch_counts()
    assert counts[f"rnn_fused_fwd_grid_bf16_{cell}"] == 1, counts
    assert counts[f"rnn_fused_bwd_grid_bf16_{cell}"] == 1, counts
    assert sum(counts.values()) == 2, counts
    for g_card, g_cpu in zip(grads[1], grads[0]):
        _scaled_close(g_card, g_cpu, torch.bfloat16)


#: The bf16 widths past 512 the grid forward is held at: 528 (17 CTAs a
#: group), 530 zero-padded to 544, 1024 and its widest, 1520 (one group of
#: 95 CTAs of 128 rows).
FWD_GRID_WIDTHS = (528, 530, 1024, 1520)


def _fwd_grid(cell, hoisted, xin, wx, b, wh, m, **kw):
    """The grid forward on ``xin`` (hin, or xw hoisted) at any H,
    zero-padded to Hp as the public forwards pad it, c_all saved."""
    form = "fwd" if hoisted else "fused_fwd"
    ops = (xin, wh, m) if hoisted else (xin, wx, b, wh, m)
    return R.padded_launch(R._tensor_core_launcher("grid", form), form)(
        cell, *ops, 1.0, True, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("H", FWD_GRID_WIDTHS)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_fwd_grid_matches_plain(cuda, cell, H, hoisted):
    """Rows 3 and 1 in bf16 past 512 on ``csrc/rnn_fwd_grid.cu`` (W_h's
    columns held in bf16 across a cooperative grid), through the public
    forward, against the plain version within atol and rtol 0.05: one
    counted launch and nothing else, h_all and c_all in bf16, an
    all-invalid row exactly zero, a second call bitwise equal; and the
    same bits from a larger group, 128 rows a work item where the kernel
    takes them, and one group. B 150 is several work items a group."""
    B, T = 150, 4
    hin, wx, b, wh, m, _ = _wide_inputs(cell, B, T, H, H + 7,
                                        torch.bfloat16, cuda)
    m[0] = False
    xw32 = hin.float() @ wx.float() + b.float()
    xw = xw32.to(torch.bfloat16)
    if hoisted:
        run = lambda: R._scan_states_any(cell, xw, wh, m, 1.0, True)  # noqa
        want = rnn_scan_states(cell, xw, wh, m, 1.0, True)
        args = (xw, None, None, wh, m)
    else:
        run = lambda: R._fused_states(cell, hin, wx, b, wh, m, 1.0,  # noqa
                                      True)
        want = rnn_scan_states(cell, xw32, wh, m, 1.0, True)
        args = (hin, wx, b, wh, m)
    name = f"rnn_{'' if hoisted else 'fused_'}fwd_grid_bf16_{cell}"
    _build.reset_launch_counts()
    with torch.no_grad():
        got = run()
    counts = _build.launch_counts()
    assert counts[name] == 1 and sum(counts.values()) == 1, counts
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == torch.bfloat16 and g.shape == (B, T, H)
        assert torch.isfinite(g.float()).all()
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(),
                                   **TOL[torch.bfloat16])
        assert not g[0].float().any()
    for a, z in zip(got, run()):
        assert (a is None and z is None) or torch.equal(a, z)
    Hp = R._padded_width(H)
    props = torch.cuda.get_device_properties(cuda)
    limit = props.shared_memory_per_block_optin
    bf = torch.bfloat16
    n = R._fwd_grid_size(cell, Hp, limit, props.multi_processor_count, bf)
    pairs = [dict(group=n, rows=64, groups=1)]
    for more, rows in ((n + 3, 64), (n, 128), (Hp // 8, 64)):
        if (more <= props.multi_processor_count
                and R._grid_takes(Hp, more, rows, bf)
                and R._fwd_grid_smem(cell, Hp, more, rows, bf) <= limit):
            pairs.append(dict(group=more, rows=rows))
    for kw in pairs:
        for a, z in zip(got, _fwd_grid(cell, hoisted, *args, **kw)):
            assert (a is None and z is None) or torch.equal(a, z), kw


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_fwd_grid_seed_grid_bitwise_equals_single_seed_launches(cuda, cell,
                                                                hoisted):
    """The seed rules (``_fwd_vmap`` :920, ``_make_scan._fwd_vmap`` :504)
    on the grid forward at H 528: S 3 seeds with m shared in one counted
    launch, each seed's h_all and c_all bitwise its one-seed launch's."""
    S, B, T, H = 3, 70, 4, 528
    hin, wx, b, wh, m, _ = _wide_inputs(cell, B, T, H, 23, torch.bfloat16,
                                        cuda, S=S)
    m1 = m[:1].contiguous()
    if hoisted:
        xin = (hin.float() @ wx.float()[:, None]
               + b.float()[:, None, None]).to(torch.bfloat16)
        wx = b = None
    else:
        xin = hin
    _build.reset_launch_counts()
    got = _fwd_grid(cell, hoisted, xin, wx, b, wh, m1)
    name = f"rnn_{'' if hoisted else 'fused_'}fwd_grid_bf16_{cell}"
    assert _build.launch_counts()[name] == 1
    for s in range(S):
        one = _fwd_grid(cell, hoisted, xin[s], None if wx is None else wx[s],
                        None if b is None else b[s], wh[s], m[0])
        for g, o in zip(got, one):
            assert (g is None and o is None) or torch.equal(g[s], o)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_fwd_grid_launch_refused_raises(cuda, cell):
    """No fallback: a grid of one group more than the card holds at once is
    refused before any kernel runs (the xw GEMM included), naming the
    width and the groups; a group the kernel does not take raises."""
    hin, wx, b, wh, m, _ = _wide_inputs(cell, 37, 3, 528, 5, torch.bfloat16,
                                        cuda)
    props = torch.cuda.get_device_properties(cuda)
    n = R._fwd_grid_size(cell, 528, props.shared_memory_per_block_optin,
                         props.multi_processor_count, torch.bfloat16)
    ctas = R._fwd_grid_check(cell, True, 528, n, 64, cuda, torch.bfloat16)
    _build.reset_launch_counts()
    with pytest.raises(RuntimeError, match=f"hidden=528, {ctas // n + 1} "
                                           f"groups of {n} CTAs"):
        R._launch_fwd_grid(cell, True, hin, wx, b, wh, m, 1.0, True,
                           group=n, rows=64, groups=ctas // n + 1)
    with pytest.raises(ValueError, match="hidden=528 with a group of 2"):
        R._launch_fwd_grid(cell, True, hin, wx, b, wh, m, 1.0, True,
                           group=2, rows=64)
    assert not any(_build.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_fwd_grid_hands_its_xw_to_the_backward(cuda, cell):
    """The fused grid forward's f32 xw scratch (two kernels: the GEMM, the
    recurrence) handed to the fused bf16 grid backward: five kernels in
    place of six, and every gradient bitwise that of the backward that
    forms its own xw (both xw GEMMs are the same call)."""
    B, T, H = 150, 4, 528
    hin, wx, b, wh, m, dh = _wide_inputs(cell, B, T, H, 61, torch.bfloat16,
                                         cuda)
    fwd = {}
    with torch.no_grad():
        h, c, xw = R._launch_fwd_grid(cell, True, hin, wx, b, wh, m, 1.0,
                                      True, keep_xw=True, stats=fwd)
    assert fwd["kernels"] == 2 and xw.dtype == torch.float32
    own, given = {}, {}
    want = R._launch_bwd_grid(cell, True, hin, wx, b, wh, m, h, c, dh, 1.0,
                              stats=own)
    _build.reset_launch_counts()
    got = R._launch_bwd_grid(cell, True, hin, wx, b, wh, m, h, c, dh, 1.0,
                             xw=xw, stats=given)
    assert _build.launch_counts()[f"rnn_fused_bwd_grid_bf16_{cell}"] == 1
    assert (own["kernels"], given["kernels"]) == (6, 5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


#: The float32 widths above 128 the grid forward is held at: 400 (the
#: LSTM's 17 CTAs of 3 chunks), 402 zero-padded to 416, 640 and its
#: widest, 1024 (one group of 128 CTAs of 128 rows).
TF32_FWD_GRID_WIDTHS = (400, 402, 640, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("H", TF32_FWD_GRID_WIDTHS)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_tf32_fwd_grid_matches_plain(cuda, cell, H, hoisted):
    """Rows 3 and 1 in float32 above 128 on ``csrc/rnn_fwd_tf32_grid.cu``
    (W_h's columns held in f32 across a cooperative grid, 3xTF32
    products), through the public forward, against the plain version
    within atol 1e-5: one counted launch and nothing else, h_all and c_all
    in f32, an all-invalid row exactly zero, a second call bitwise equal;
    and the same bits from another group size, 128 rows a work item where
    the kernel takes them, and one group. B 150 is several work items a
    group."""
    B, T = 150, 4
    f32 = torch.float32
    hin, wx, b, wh, m, _ = _wide_inputs(cell, B, T, H, H + 11, f32, cuda)
    m[0] = False
    xw = hin @ wx + b
    if hoisted:
        run = lambda: R._scan_states_any(cell, xw, wh, m, 1.0, True)  # noqa
        args = (xw, None, None, wh, m)
    else:
        run = lambda: R._fused_states(cell, hin, wx, b, wh, m, 1.0,  # noqa
                                      True)
        args = (hin, wx, b, wh, m)
    want = rnn_scan_states(cell, xw, wh, m, 1.0, True)
    name = f"rnn_{'' if hoisted else 'fused_'}fwd_grid_{cell}"
    _build.reset_launch_counts()
    with torch.no_grad():
        got = run()
    counts = _build.launch_counts()
    assert counts[name] == 1 and sum(counts.values()) == 1, counts
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == f32 and g.shape == (B, T, H)
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   **TOL[f32])
        assert not g[0].any()
    for a, z in zip(got, run()):
        assert (a is None and z is None) or torch.equal(a, z)
    Hp = R._padded_width(H)
    props = torch.cuda.get_device_properties(cuda)
    limit, sms = (props.shared_memory_per_block_optin,
                  props.multi_processor_count)
    n = R._fwd_grid_size(cell, Hp, limit, sms, f32)
    pairs = [dict(group=n, rows=64, groups=1)]
    for other, rows in ((n + 3, 64), (n, 128), (Hp // 8, 64),
                        (Hp // 16, 128)):
        if (other <= sms and R._grid_takes(Hp, other, rows, f32)
                and R._fwd_grid_smem(cell, Hp, other, rows, f32) <= limit):
            pairs.append(dict(group=other, rows=rows))
    assert len(pairs) > 1
    for kw in pairs:
        for a, z in zip(got, _fwd_grid(cell, hoisted, *args, **kw)):
            assert (a is None and z is None) or torch.equal(a, z), kw


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_tf32_fwd_grid_seed_grid_bitwise_equals_single_seed_launches(
        cuda, cell, hoisted):
    """The seed rules (``_fwd_vmap`` :920, ``_make_scan._fwd_vmap`` :504)
    on the float32 grid forward at H 400: S 3 seeds with m shared in one
    counted launch, each seed's h_all and c_all bitwise its one-seed
    launch's."""
    S, B, T, H = 3, 70, 4, 400
    hin, wx, b, wh, m, _ = _wide_inputs(cell, B, T, H, 29, torch.float32,
                                        cuda, S=S)
    m1 = m[:1].contiguous()
    if hoisted:
        xin = hin @ wx[:, None] + b[:, None, None]
        wx = b = None
    else:
        xin = hin
    _build.reset_launch_counts()
    got = _fwd_grid(cell, hoisted, xin, wx, b, wh, m1)
    name = f"rnn_{'' if hoisted else 'fused_'}fwd_grid_{cell}"
    assert _build.launch_counts()[name] == 1
    for s in range(S):
        one = _fwd_grid(cell, hoisted, xin[s], None if wx is None else wx[s],
                        None if b is None else b[s], wh[s], m[0])
        for g, o in zip(got, one):
            assert (g is None and o is None) or torch.equal(g[s], o)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_tf32_fwd_grid_launch_refused_raises(cuda, cell):
    """No fallback: a float32 grid of one group more than the card holds
    at once is refused before any kernel runs (the xw GEMM included),
    naming the width and the groups; a group the kernel does not take
    raises."""
    f32 = torch.float32
    hin, wx, b, wh, m, _ = _wide_inputs(cell, 37, 3, 400, 5, f32, cuda)
    props = torch.cuda.get_device_properties(cuda)
    n = R._fwd_grid_size(cell, 400, props.shared_memory_per_block_optin,
                         props.multi_processor_count, f32)
    ctas = R._fwd_grid_check(cell, True, 400, n, 64, cuda, f32)
    _build.reset_launch_counts()
    with pytest.raises(RuntimeError, match=f"hidden=400, {ctas // n + 1} "
                                           f"groups of {n} CTAs"):
        R._launch_fwd_grid(cell, True, hin, wx, b, wh, m, 1.0, True,
                           group=n, rows=64, groups=ctas // n + 1)
    with pytest.raises(ValueError, match="float32 forward on the grid does "
                                         "not take hidden=400 with a group "
                                         "of 2"):
        R._launch_fwd_grid(cell, True, hin, wx, b, wh, m, 1.0, True,
                           group=2, rows=64)
    assert not any(_build.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("H", [400, 150])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_tf32_fwd_grid_hands_its_xw_to_the_backward(cuda, cell, H):
    """The float32 grid forward's f32 xw scratch (two kernels: the CUDA-core
    GEMM, the recurrence) handed to the fused float32 backward of its
    width, as ``_FusedScan`` hands it over: the grid backward runs five
    kernels in place of six; every gradient within the scaled f32 bound of
    the plain version and of the backward that forms its own xw (a 3xTF32
    GEMM, so not bitwise). Through autograd: one forward and one backward
    launch, the gradients bitwise those of the backward handed the xw
    directly."""
    B, T = 150, 4
    f32 = torch.float32
    hin, wx, b, wh, m, dh = _wide_inputs(cell, B, T, H, 61, f32, cuda)
    grid = R._mma_route(f32, H, "bwd") == "grid"
    fwd = {}
    with torch.no_grad():
        h, c, xw = R._launch_fwd_grid(cell, True, *R._pad_operands(
            "fused_fwd", cell, (hin, wx, b, wh, m)), 1.0, True,
            keep_xw=True, stats=fwd)
        h, c = (None if t is None else t[..., :H].contiguous()
                for t in (h, c))
    assert fwd["kernels"] == 2 and xw.dtype == f32
    assert xw.shape == (B, T, GATES[cell] * R._padded_width(H))
    saved = xw.clone()
    own, given = {}, {}
    kw = (lambda st: dict(stats=st)) if grid else (lambda st: {})
    launch = (R._tensor_core_launcher("grid" if grid else "tf32",
                                      "fused_bwd"))
    want = R.padded_launch(launch, "fused_bwd")(
        cell, hin, wx, b, wh, m, h, c, dh, 1.0, **kw(own))
    _build.reset_launch_counts()
    got = R.padded_launch(launch, "fused_bwd")(
        cell, hin, wx, b, wh, m, h, c, dh, 1.0, xw=xw, **kw(given))
    name = f"rnn_fused_bwd_{'grid' if grid else 'tf32'}_{cell}"
    assert _build.launch_counts()[name] == 1
    if grid:
        assert (own["kernels"], given["kernels"]) == (6, 5)
    plain = rnn_scan_fused_bwd_reference(
        cell, *(t.double() for t in (hin, wx, b, wh)), m,
        *(None if t is None else t.double() for t in (h, c, dh)))
    for g, w, p in zip(got, want, plain):
        _scaled_close(g, w, f32)
        _scaled_close(g, p, f32)
    xw.copy_(saved)
    ops = [t.clone().requires_grad_() for t in (hin, wx, b, wh)]
    _build.reset_launch_counts()
    rnn_scan_fused(cell, *ops, m).backward(dh)
    counts = _build.launch_counts()
    assert counts[f"rnn_fused_fwd_grid_{cell}"] == 1
    assert counts[name] == 1 and sum(counts.values()) == 2, counts
    for g, s in zip((t.grad for t in ops), got):
        assert torch.equal(g, s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cuda_core_bwd_still_serves_hidden_120(cuda, cell, dtype):
    """Above 128 (H = 160: hidden 120 now runs zero-padded on the tensor
    cores) both backwards run on a cluster: float32 on the 3xTF32 kernels
    (``csrc/rnn_bwd_tf32.cu``), bf16 on ``csrc/rnn_bwd_cluster.cu``,
    within the JAX bounds; neither on the CUDA cores (``rnn_bwd.cu``)."""
    B, T, H = 37, 5, 160
    for hoisted in (False, True):
        hin, wx, b, wh, m, xw, h, c, dh = _bwd_inputs(cell, B, T, H, 7,
                                                      dtype, cuda, hoisted)
        tc, core = _tf32_names(cell, hoisted)
        if dtype == torch.bfloat16:
            tc = core.replace(f"bwd_{cell}", f"bwd_cluster_{cell}")
        _build.reset_launch_counts()
        if hoisted:
            got = rnn_scan_bwd(cell, xw, wh, m, h, c, dh)
            want = rnn_scan_bwd_reference(cell, xw, wh, m, h, c, dh)
        else:
            got = rnn_scan_fused_bwd(cell, hin, wx, b, wh, m, h, c, dh)
            want = rnn_scan_fused_bwd_reference(cell, hin, wx, b, wh, m, h,
                                                c, dh)
        counts = _build.launch_counts()
        assert counts[tc] == 1 and counts[core] == 0
        assert sum(counts.values()) == 1, counts
        for g, w in zip(got, want):
            _scaled_close(g, w, dtype)


def _tensor_core_names(cell, dtype, hoisted):
    """The counters of the tensor-core forward and backward of a form."""
    tag = "mma_" if dtype == torch.bfloat16 else "tf32_"
    form = "" if hoisted else "fused_"
    return f"rnn_{form}fwd_{tag}{cell}", f"rnn_{form}bwd_{tag}{cell}"


CUDA_CORE = [f"rnn_{form}_{cell}" for form in ("fused_fwd", "fwd",
                                               "fused_bwd", "bwd")
             for cell in ("lstm", "gru")]


@pytest.mark.cuda
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("B,T,H", [(37, 7, 40), (2048 + 5, 5, 120)])
def test_padded_route_matches_plain(cuda, cell, dtype, hoisted, B, T, H):
    """A width off a multiple of 16 runs zero-padded per gate block on the
    tensor cores (``ops/rnn.py padded_launch``), forward and backward, and
    no CUDA-core kernel launches: h_all (and c_all) at the JAX bounds of
    the unpadded plain version, an all-invalid row exactly zero; every
    gradient at the scaled bound (the bf16 weight gradients at 1e-4, the
    tensor-core backward's), each at the real width and contiguous."""
    fwd, bwd = _tensor_core_names(cell, dtype, hoisted)
    hin, wx, b, wh, m, xw, h, c, dh = _bwd_inputs(cell, B, T, H, B + H,
                                                  dtype, cuda, hoisted)
    _build.reset_launch_counts()
    with torch.no_grad():
        if hoisted:
            got_h, got_c = R._scan_states_any(cell, xw, wh, m, 1.0, True)
            want_h, want_c = rnn_scan_states(cell, xw, wh, m, 1.0, True)
        else:
            got_h, got_c = R._fused_states(cell, hin, wx, b, wh, m, 1.0, True)
            want_h, want_c = rnn_scan_states(
                cell, hin.float() @ wx.float() + b.float(), wh, m, 1.0, True)
    assert (got_c is None) == (cell == "gru")
    for got, want in ((got_h, want_h), (got_c, want_c)):
        if got is None:
            continue
        assert got.shape == (B, T, H) and got.is_contiguous()
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **TOL[dtype])
        assert not got[0].any()
    if hoisted:
        args = (cell, xw, wh, m, h, c, dh)
        got = rnn_scan_bwd(*args)
        want = rnn_scan_bwd_reference(*args)
    else:
        args = (cell, hin, wx, b, wh, m, h, c, dh)
        got = rnn_scan_fused_bwd(*args)
        want = rnn_scan_fused_bwd_reference(*args)
    counts = _build.launch_counts()
    assert counts[fwd] == 1 and counts[bwd] == 1
    assert sum(counts.values()) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.is_contiguous()
        assert torch.isfinite(g).all()
        if i > 0 and dtype == torch.bfloat16:
            g = g.float().cpu()
            w = w.float().cpu()
            scale = float(w.abs().max()) + 1e-9
            np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale,
                                       atol=1e-4, rtol=0.0)
        else:
            _scaled_close(g, w, dtype)
    assert not got[0][0].any()  # an all-invalid row passes no gradient


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_padded_autograd_matches_plain(cuda, cell, dtype):
    """Through the autograd Function at H 40: the forward's W_x packed at
    the padded width (bf16) or its xw scratch (float32) goes to the padded
    backward; one tensor-core launch each way, the gradients against
    autograd of the plain version on the CPU."""
    B, T, H = 37, 6, 40
    (hin, wx, b, wh), m = _rnn_inputs(cell, B, T, H, 81, torch.float32,
                                      "cpu")
    grads = []
    for dev in ("cpu", cuda):
        leaves = [t.clone().to(dtype).to(dev).requires_grad_(True)
                  for t in (hin, wx, b, wh)]
        _build.reset_launch_counts()
        out = rnn_scan_fused(cell, *leaves, m.to(dev))
        (out.float() ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    fwd, bwd = _tensor_core_names(cell, dtype, False)
    counts = _build.launch_counts()
    assert counts[fwd] == 1 and counts[bwd] == 1
    for g_card, g_cpu in zip(grads[1], grads[0]):
        assert g_card.shape == g_cpu.shape
        _scaled_close(g_card, g_cpu, dtype)


@pytest.mark.cuda
def test_kernels_count_each_launch(cuda):
    _build.reset_launch_counts()
    (hin, wx, b, wh), m = _rnn_inputs("lstm", 4, 3, 8, 0, torch.bfloat16,
                                      cuda)
    with torch.no_grad():
        rnn_scan_fused("lstm", hin, wx, b, wh, m)
        rnn_scan_fused_reference("lstm", hin, wx, b, wh, m)
    gather_windows(*_gather_inputs(5, 12, 4, 6, 2, 3, 0, torch.bfloat16,
                                   cuda), 6)
    want = dict.fromkeys(_build.LAUNCHES, 0)
    want.update(rnn_fused_fwd_mma_lstm=1, window_gather=1)
    assert _build.launch_counts() == want


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """No fallback: a CUDA tensor the kernel cannot take raises."""
    (hin, wx, b, wh), m = _rnn_inputs("lstm", 4, 3, 8, 0, torch.float32,
                                      cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            rnn_scan_fused("lstm", hin, wx.to(torch.bfloat16), b, wh, m)
        with pytest.raises(ValueError, match="contiguous"):
            rnn_scan_fused("lstm", hin.transpose(0, 1).contiguous()
                           .transpose(0, 1), wx, b, wh, m)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            rnn_scan_fused("lstm", *(t.double() for t in (hin, wx, b, wh)),
                           m)
    xm, fi, ti = _gather_inputs(5, 12, 4, 6, 2, 3, 0, torch.float32, cuda)
    with pytest.raises(ValueError, match="int32"):
        gather_windows(xm, fi.long(), ti, 6)


@pytest.mark.cuda
def test_service_on_card_matches_cpu_service(cuda):
    """The served path on the card (kernels) against the same service on
    the CPU (plain versions), same seeded params, small panel."""
    cfg = get_preset("c2")
    panel = synthetic_panel(n_firms=40, n_months=90, n_features=20, seed=0)
    _build.reset_launch_counts()
    with ScoringService(device="cuda", max_rows=4) as on_card, \
            ScoringService(device="cpu", max_rows=4) as on_cpu:
        on_card.register("c2", cfg, panel)
        on_cpu.register("c2", cfg, panel)
        for month in on_card.serveable_months("c2")[::7]:
            a, b = on_card.score("c2", month), on_cpu.score("c2", month)
            np.testing.assert_array_equal(a.firm_idx, b.firm_idx)
            np.testing.assert_allclose(a.scores, b.scores, atol=0.05,
                                       rtol=0.05)
    counts = _build.launch_counts()
    # c2 is bf16 at H = 128: the tensor-core forward.
    assert counts["rnn_fused_fwd_mma_lstm"] > 0
    assert counts["window_gather"] > 0


def test_launch_counter_is_exact_under_threads():
    """The counters are bumped from the batcher thread and read from
    others: no increment may be lost."""
    import sys
    import threading

    _build.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch("window_gather") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _build.launch_counts()["window_gather"] == 16 * 2000
    _build.reset_launch_counts()


@pytest.mark.cuda
def test_two_ranks_share_the_card(cuda, tmp_path):
    """Two gloo ranks on the one card (NCCL refuses two ranks on one
    device) train 3 date-sharded steps of a bf16 GRU with the rank-IC loss
    on the kernels: each rank's losses and grad norms within the training
    gate (atol and rtol 0.05) of one process on the card, and each rank's
    gather, fused forward and backward launched once per step."""
    import dataclasses
    import os

    from lfm_quant_tpu_torch import config
    from lfm_quant_tpu_torch.parallel.launch import run_ranks

    import torch_ranks

    c3 = config.get_preset("c3")
    cfg = dataclasses.replace(
        c3, data=dataclasses.replace(c3.data, n_firms=300, n_months=120),
        model=dataclasses.replace(c3.model, kwargs={"hidden": 32}),
        n_data_shards=2)
    panel = dict(n_firms=300, n_months=120, n_features=20, seed=0)
    cut = (84, 102)
    one = torch_ranks.epoch_steps(cfg, panel, cut, None, device="cuda:0",
                                  n_steps=3)
    ranks = run_ranks(2, "torch_ranks:epoch_steps",
                      dict(cfg=cfg, panel_kw=panel, cut=cut, init=None,
                           device="cuda:0", n_steps=3),
                      str(tmp_path / "job"), 300,
                      python_path=[os.path.dirname(__file__)])
    for got in ranks:
        assert got["n_data"] == 2
        for key in ("losses", "grad_norms"):
            np.testing.assert_allclose(got[key], one[key], atol=0.05,
                                       rtol=0.05, err_msg=key)
        for k in ("window_gather", "rnn_fused_fwd_mma_gru",
                  "rnn_fused_bwd_mma_gru"):
            assert got["launches"][k] >= 3, (k, got["launches"])


@pytest.mark.cuda
@pytest.mark.parametrize("preset,dropout", [("c1", 0.0), ("c4", 0.0),
                                            ("c4", 0.1), ("lru", 0.0)])
def test_new_models_train_on_the_card(cuda, preset, dropout):
    """The MLP, transformer and LRU (small panel, the preset's widths,
    depth cut to 1): 3 train steps on the gather kernel against the plain
    gather on the card from the same seeded init, within the training
    gate (atol and rtol 0.05), the kernel launched once a step and no
    recurrence kernel; with dropout, the same seed replays the losses
    bitwise."""
    import dataclasses

    from lfm_quant_tpu_torch.data.panel import PanelSplits
    from lfm_quant_tpu_torch.train.loop import Trainer

    cfg = get_preset(preset)
    kw = dict(cfg.model.kwargs)
    kw.update({"depth": 1} if cfg.model.kind == "transformer"
              else {"layers": 1} if cfg.model.kind == "lru" else {})
    if dropout:
        kw["dropout"] = dropout
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, n_firms=300, n_months=120,
                                      window=min(cfg.data.window, 24)),
        model=dataclasses.replace(cfg.model, kwargs=kw))
    panel = synthetic_panel(n_firms=300, n_months=120,
                            n_features=cfg.data.n_features, seed=0)
    splits = PanelSplits.by_date(panel, int(panel.dates[84]),
                                 int(panel.dates[102]))

    def losses(c):
        t = Trainer(c, splits, device="cuda")
        state = t.init_state()
        fi, ti, w = t._batch(t.train_sampler.stacked_epoch(0))
        out = []
        for k in range(3):
            state, ms = t.step(state, fi[k], ti[k], w[k])
            out.append(ms["loss"])
        return [float(v) for v in torch.stack(out).cpu()]

    _build.reset_launch_counts()
    got = losses(cfg)
    counts = _build.launch_counts()
    assert counts["window_gather"] == 3, counts
    assert sum(counts.values()) == 3, counts
    _build.reset_launch_counts()
    want = losses(dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, gather_impl="xla")))
    assert not any(_build.launch_counts().values())
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)
    if dropout:
        assert losses(cfg) == got
