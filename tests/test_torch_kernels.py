"""The port's kernel wrappers: dispatch, checks and launch counts, and — on
the card — each CUDA kernel against its plain PyTorch version.

This file imports nothing of JAX, so it also runs where only PyTorch is
installed. On the card (the repository's ``tests/conftest.py`` imports
jax, so leave it out there)::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Tests marked ``cuda`` decide in a fixture whether there is a card and
skip without one. Tolerances: gathers exact; the recurrence f32 atol 1e-5
(at H <= 16), bf16 atol/rtol 0.05 — the JAX package's own bounds; the
backward's gradients scaled by their largest magnitude, f32 atol 1e-5
(``tests/test_pallas_rnn.py``'s rule) and bf16 atol 0.05.
"""

import numpy as np
import pytest
import torch

from lfm_quant_tpu_torch.config import get_preset
from lfm_quant_tpu_torch.data.panel import synthetic_panel
from lfm_quant_tpu_torch.data.windows import gather_windows_packed
from lfm_quant_tpu_torch.ops import _build
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
@pytest.mark.parametrize("B,T,H", [(37, 9, 12), (16, 5, 16), (3, 7, 8)])
def test_rnn_kernel_matches_plain(cuda, cell, dtype, B, T, H):
    """Odd batch (not a multiple of the block's 16 rows), H not a
    multiple of 4, an all-invalid row that must stay at zero."""
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
@pytest.mark.parametrize("B,T,H", [(37, 9, 12), (16, 1, 16), (3, 7, 8)])
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
@pytest.mark.parametrize("B,T,H", [(37, 9, 12), (16, 1, 24), (21, 5, 8)])
def test_rnn_bwd_kernels_match_plain(cuda, cell, dtype, B, T, H):
    """The CUDA-core fused backward (row 4) and hoisted backward (row 2)
    against their plain formulas: B not a multiple of the block's 16 rows,
    T = 1, H not a multiple of 4, an all-invalid row. Every width here is
    one the tensor cores do not take (``_mma_route``), so bf16 runs the
    CUDA-core kernels too (``tests/test_torch_mma_bwd.py`` holds the
    tensor-core ones)."""
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
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cuda_core_route_launches_once_per_seed(cuda, cell):
    """float32 (the CUDA-core kernels, no seed grid) with seed-stacked
    operands: one counted launch per seed, forward and backward, each
    seed's result that seed's one-seed call's; the hoisted form too,
    forward and backward."""
    S, B, T, H = 3, 21, 5, 16
    per = [_rnn_inputs(cell, B, T, H, s, torch.float32, cuda)
           for s in range(S)]
    hin, wx, b, wh = (torch.stack([p[0][i] for p in per]) for i in range(4))
    m = torch.stack([p[1] for p in per])
    leaves = [t.clone().requires_grad_(True) for t in (hin, wx, b, wh)]
    _build.reset_launch_counts()
    out = rnn_scan_fused(cell, *leaves, m)
    (out ** 2).sum().backward()
    counts = _build.launch_counts()
    assert counts[f"rnn_fused_fwd_{cell}"] == S
    assert counts[f"rnn_fused_bwd_{cell}"] == S
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
    assert _build.launch_counts()[f"rnn_fwd_{cell}"] == S
    for s in range(S):
        with torch.no_grad():
            assert torch.equal(h[s], rnn_scan(cell, xw[s], wh[s], m[s]))
    leaves = [t.clone().requires_grad_(True) for t in (xw, wh)]
    _build.reset_launch_counts()
    (rnn_scan(cell, *leaves, m) ** 2).sum().backward()
    counts = _build.launch_counts()
    assert counts[f"rnn_fwd_{cell}"] == S and counts[f"rnn_bwd_{cell}"] == S
    assert counts[f"rnn_bwd_mma_{cell}"] == 0
    for s in range(S):
        one = [t[s].clone().requires_grad_(True) for t in (xw, wh)]
        (rnn_scan(cell, *one, m[s]) ** 2).sum().backward()
        for g, r in zip(leaves, one):
            assert torch.equal(g.grad[s], r.grad)


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
    want.update(rnn_fused_fwd_lstm=1, window_gather=1)
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
