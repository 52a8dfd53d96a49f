"""The tensor-core fused forward (``csrc/rnn_fused_fwd_mma.cu``): its route,
its weight packing, and — on the card — the kernel against its plain
version.

This file imports nothing of JAX. On the card::

    python -m pytest --noconftest -m cuda tests/test_torch_mma.py -q

The route and the packing are plain Python and run everywhere. The kernel
is held to ``rnn_scan_fused_reference`` in bf16 at atol/rtol 0.05, the
JAX package's bf16 bound (``tests/test_torch_rnn.py`` holds the plain
version to the Pallas kernel on the CPU).
"""

import numpy as np
import pytest
import torch

from lfm_quant_tpu_torch.ops import _build
from lfm_quant_tpu_torch.ops import rnn as R

GATES = {"lstm": 4, "gru": 3}


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card for the port's CUDA kernels "
                    "(python3 chip_smoke.py runs them on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,H,route", [
    (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 128, "mma"),
    (torch.float32, 128, "simt"),
    (torch.bfloat16, 12, "simt"),
    (torch.bfloat16, 144, "simt"),
    (torch.bfloat16, 8, "simt"),
])
def test_route_is_decided_by_dtype_and_width(dtype, H, route):
    assert R._mma_route(dtype, H) == route


@pytest.mark.parametrize("H,gates", [
    (16, 4), (64, 3), (64, 4), (128, 4), (128, 3), (48, 4),
])
def test_packing_round_trips(H, gates):
    """Packing is a permutation: unpacking gives W back exactly."""
    w = torch.from_numpy(np.random.default_rng(H + gates).standard_normal(
        (H, gates * H)).astype(np.float32)).to(torch.bfloat16)
    packed = R.pack_fragments(w)
    assert packed.shape == (w.numel(),) and packed.dtype == w.dtype
    assert torch.equal(R.unpack_fragments(packed, H, gates * H), w)
    idx = R._fragment_index(H, gates * H)
    assert torch.equal(idx.sort().values, torch.arange(w.numel()))


def test_packing_follows_the_m16n8k16_b_layout():
    """Sample entries against the PTX ISA's B fragment: lane l holds
    B[2 (l % 4) + {0, 1}][l // 4] in b0 and B[2 (l % 4) + 8 + {0, 1}]
    [l // 4] in b1, for the k-step's 16 rows and the tile's 8 columns."""
    H = 64                     # LSTM: G*H = 256 columns, 8 warps
    w = torch.arange(H * 4 * H, dtype=torch.float64).view(H, 4 * H)
    p = R.pack_fragments(w).view(H // 16, H // 8, 4, 32, 4)
    # k-step 0, warp 0, tile 0 (gate i, units 0-7), lane 0.
    assert p[0, 0, 0, 0].tolist() == [w[0, 0], w[1, 0], w[8, 0], w[9, 0]]
    # k-step 1, warp 0, tile 0, lane 5: k = 16 + 2, column 1.
    assert p[1, 0, 0, 5].tolist() == [w[18, 1], w[19, 1], w[26, 1],
                                      w[27, 1]]
    # k-step 2, warp 7 (units 56-63), tile 1 (gate f), lane 31: k = 32 +
    # 6, column H + 56 + 7.
    c = H + 56 + 7
    assert p[2, 7, 1, 31].tolist() == [w[38, c], w[39, c], w[46, c],
                                       w[47, c]]
    # The GRU's candidate gate (tile 2): warp 5 owns units 40-47, lane 9
    # → k = 2, column 2 H + 40 + 2.
    gw = torch.arange(H * 3 * H, dtype=torch.float64).view(H, 3 * H)
    gp = R.pack_fragments(gw).view(H // 16, H // 8, 3, 32, 4)
    c = 2 * H + 40 + 2
    assert gp[0, 5, 2, 9].tolist() == [gw[2, c], gw[3, c], gw[10, c],
                                       gw[11, c]]


@pytest.mark.parametrize("B,sms,rows", [
    (16384, 132, 64), (32768, 132, 64), (8192, 132, 64), (4096, 132, 32),
    (2048, 132, 16), (2053, 132, 16), (37, 132, 16), (1, 132, 16),
])
def test_rows_per_block_follow_the_batch(B, sms, rows):
    """64 rows per block while that still gives half the SMs a block,
    then 32, then 16."""
    assert R._mma_rows(B, sms) == rows


def _inputs(cell, B, T, H, seed, device):
    rng = np.random.default_rng(seed)
    G = GATES[cell] * H
    arrays = [rng.standard_normal((B, T, H)),
              rng.standard_normal((H, G)) / np.sqrt(H),
              0.1 * rng.standard_normal((G,)),
              rng.standard_normal((H, G)) / np.sqrt(H)]
    t = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
         .to(device) for a in arrays]
    m = rng.random((B, T)) < 0.75
    m[0] = False  # an all-invalid row
    return t, torch.from_numpy(m).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("save_c", [False, True])
@pytest.mark.parametrize("T", [1, 9])
@pytest.mark.parametrize("B", [1, 37, 2048 + 5])
@pytest.mark.parametrize("H", [16, 64, 128])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_mma_kernel_matches_plain(cuda, cell, H, B, T, save_c):
    """B = 37 is no multiple of any block's rows; row 0 is all-invalid and
    must stay exactly 0; with ``save_c`` the LSTM's c_t too."""
    (hin, wx, b, wh), m = _inputs(cell, B, T, H, B * T + H, cuda)
    _build.reset_launch_counts()
    h, c = R._fused_states(cell, hin, wx, b, wh, m, 1.0, save_c)
    assert _build.launch_counts()[f"rnn_fused_fwd_mma_{cell}"] == 1
    xw = hin.float() @ wx.float() + b.float()
    want_h, want_c = R.rnn_scan_states(cell, xw, wh, m, 1.0, save_c)
    assert h.dtype == torch.bfloat16 and h.shape == (B, T, H)
    np.testing.assert_allclose(h.float().cpu().numpy(),
                               want_h.float().cpu().numpy(), atol=0.05,
                               rtol=0.05)
    assert not h[0].any()
    if cell == "lstm" and save_c:
        np.testing.assert_allclose(c.float().cpu().numpy(),
                                   want_c.float().cpu().numpy(), atol=0.05,
                                   rtol=0.05)
        assert not c[0].any()
    else:
        assert c is None


@pytest.mark.cuda
@pytest.mark.parametrize("rows", R.MMA_ROWS)
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_every_block_size_matches_plain(cuda, cell, rows):
    """Each block size the wrapper can pick, on a batch that leaves the
    last block part-filled."""
    (hin, wx, b, wh), m = _inputs(cell, 300, 7, 128, rows, cuda)
    h, c = R._launch_fwd_mma(cell, hin, wx, b, wh, m, 1.0, True, rows)
    xw = hin.float() @ wx.float() + b.float()
    want_h, want_c = R.rnn_scan_states(cell, xw, wh, m, 1.0, True)
    np.testing.assert_allclose(h.float().cpu().numpy(),
                               want_h.float().cpu().numpy(), atol=0.05,
                               rtol=0.05)
    if cell == "lstm":
        np.testing.assert_allclose(c.float().cpu().numpy(),
                                   want_c.float().cpu().numpy(), atol=0.05,
                                   rtol=0.05)


@pytest.mark.cuda
def test_float32_and_odd_widths_keep_the_cuda_core_kernel(cuda):
    _build.reset_launch_counts()
    for dtype, H in ((torch.float32, 64), (torch.bfloat16, 12)):
        (hin, wx, b, wh), m = _inputs("lstm", 5, 3, H, H, cuda)
        with torch.no_grad():
            R.rnn_scan_fused("lstm", *(t.to(dtype) for t in (hin, wx, b, wh)),
                             m)
    counts = _build.launch_counts()
    assert counts["rnn_fused_fwd_lstm"] == 2
    assert counts["rnn_fused_fwd_mma_lstm"] == 0
