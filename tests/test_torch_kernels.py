"""The port's kernel wrappers: dispatch, checks and launch counts, and — on
the card — each CUDA kernel against its plain PyTorch version.

This file imports nothing of JAX, so it also runs where only PyTorch is
installed. On the card (the repository's ``tests/conftest.py`` imports
jax, so leave it out there)::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Tests marked ``cuda`` decide in a fixture whether there is a card and
skip without one. Tolerances: gathers exact; the recurrence f32 atol 1e-5
(at H <= 16), bf16 atol/rtol 0.05 — the JAX package's own bounds.
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
    rnn_scan_fused,
    rnn_scan_fused_reference,
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T,fp,W,D,Bf,lane_pad", [
    (7, 23, 4, 9, 5, 13, 0),     # young, mid and tail anchors
    (7, 5, 4, 9, 3, 6, 0),       # panel shorter than the window
    (11, 64, 6, 60, 4, 33, 3),   # c2's window, a lane-padded panel
])
def test_gather_kernel_matches_plain(cuda, dtype, N, T, fp, W, D, Bf,
                                     lane_pad):
    xm, fi, ti = _gather_inputs(N, T, fp, W, D, Bf, N + T, dtype, cuda,
                                lane_pad)
    x, m = gather_windows(xm, fi, ti, W, fp=fp)
    xr, mr = gather_windows_packed(xm, fi, ti, W, fp=fp)
    assert torch.equal(x, xr) and torch.equal(m, mr)


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
    assert _build.launch_counts() == {
        "rnn_fused_fwd_lstm": 1, "rnn_fused_fwd_gru": 0, "window_gather": 1}


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
    assert counts["rnn_fused_fwd_lstm"] > 0 and counts["window_gather"] > 0


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
