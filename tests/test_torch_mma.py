"""The tensor-core forward (``csrc/rnn_fused_fwd_mma.cu``, fused and hoisted
modes): its route, its weight packing, and — on the card — the kernel
against its plain version.

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
    (torch.float32, 128, "tf32"),
    (torch.bfloat16, 12, "mma"),
    (torch.bfloat16, 144, "cluster"),
    (torch.bfloat16, 8, "mma"),
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


@pytest.mark.parametrize("B,sms,S,rows", [
    (2048, 132, 1, 16), (2048, 132, 2, 32), (2048, 132, 3, 64),
    (2048, 132, 64, 64), (26600, 132, 10, 64), (37, 132, 64, 32),
])
def test_rows_per_block_follow_the_seed_count(B, sms, S, rows):
    """Seed-stacked launches pick rows from the block count of all seeds:
    the c5 train step (64 seeds of B 2048) takes 64 rows, as a wide serving
    dispatch does."""
    assert R._mma_rows(B, sms, S) == rows


@pytest.mark.parametrize("B,sms,S,rows", [
    (16384, 132, 1, 32), (4096, 132, 1, 32), (2048, 132, 1, 16),
    (2048, 132, 3, 32), (37, 132, 1, 16),
])
def test_hoisted_rows_per_block_stop_at_32(B, sms, S, rows):
    """The hoisted mode's xw_t waits in registers: it takes 32 rows per
    block where the fused mode would take 64, and the c2 train step's 16."""
    assert R._mma_rows(B, sms, S, hoisted=True) == rows


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("H,gates", [(12, 4), (40, 3), (120, 4), (1, 3)])
def test_padded_packing_is_the_packing_of_the_padded_weight(H, gates,
                                                           transpose):
    """``pack_fragments(w, width=Hp)`` (the pad folded into the gather) is
    the packing of ``w`` zero-padded per gate block, seed by seed too."""
    Hp = R._padded_width(H)
    w = torch.from_numpy(np.random.default_rng(H).standard_normal(
        (2, H, gates * H)).astype(np.float32)).to(torch.bfloat16)
    padded = R._pad_one(w, "w", gates, H, Hp)
    assert padded.shape == (2, Hp, gates * Hp)
    assert torch.equal(R.pack_fragments(w, transpose, width=Hp),
                       R.pack_fragments(padded, transpose))
    assert torch.equal(R.pack_fragments(w[0], transpose, width=Hp),
                       R.pack_fragments(padded[0], transpose))


def test_stacked_packing_is_per_seed():
    """``[S, H, G*H]`` packs seed by seed, never across the flat S*H*G*H."""
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 32, 128)).astype(np.float32)).to(torch.bfloat16)
    packed = R.pack_fragments(w)
    assert packed.shape == (3, 32 * 128)
    for s in range(3):
        assert torch.equal(packed[s], R.pack_fragments(w[s]))


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
    """Widths the tensor cores do not take (float32 past the float32 grid
    forward's 1024, H 1040; bf16 past the grid forward's 1520, H 1530:
    every narrower one is padded onto them) keep the CUDA-core forward in
    both dtypes; float32 at a tensor-core width (H 64) takes the 3xTF32
    forward instead."""
    _build.reset_launch_counts()
    for dtype, H in ((torch.float32, 1040), (torch.bfloat16, 1530)):
        (hin, wx, b, wh), m = _inputs("lstm", 5, 3, H, H, cuda)
        with torch.no_grad():
            R.rnn_scan_fused("lstm", *(t.to(dtype) for t in (hin, wx, b, wh)),
                             m)
    counts = _build.launch_counts()
    assert counts["rnn_fused_fwd_lstm"] == 2
    assert counts["rnn_fused_fwd_mma_lstm"] == 0
    assert counts["rnn_fused_fwd_tf32_lstm"] == 0
    _build.reset_launch_counts()
    (hin, wx, b, wh), m = _inputs("lstm", 5, 3, 64, 64, cuda)
    with torch.no_grad():
        R.rnn_scan_fused("lstm", *(t.float() for t in (hin, wx, b, wh)), m)
    counts = _build.launch_counts()
    assert counts["rnn_fused_fwd_tf32_lstm"] == 1
    assert counts["rnn_fused_fwd_lstm"] == 0


def _stacked(cell, S, B, T, H, device):
    per = [_inputs(cell, B, T, H, 100 + s, device) for s in range(S)]
    hin, wx, b, wh = (torch.stack([p[0][i] for p in per]) for i in range(4))
    return hin, wx, b, wh, torch.stack([p[1] for p in per])


@pytest.mark.cuda
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_seed_batched_launch_bitwise_equals_single_seed_launches(cuda, cell,
                                                                 H):
    """S seeds in one launch (counted once) against S one-seed launches
    with the same rows per block: h and c bitwise equal; an operand of
    seed extent 1 (m, then the weights) equals its broadcast copy
    bitwise; and the stacked result against the plain version."""
    S, B, T = 3, 300, 7
    hin, wx, b, wh, m = _stacked(cell, S, B, T, H, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rows = R._mma_rows(B, sms, S)
    _build.reset_launch_counts()
    h, c = R._fused_states(cell, hin, wx, b, wh, m, 1.0, True)
    assert _build.launch_counts()[f"rnn_fused_fwd_mma_{cell}"] == 1
    assert h.shape == (S, B, T, H)
    for s in range(S):
        h1, c1 = R._launch_fwd_mma(cell, hin[s], wx[s], b[s], wh[s], m[s],
                                   1.0, True, rows)
        assert torch.equal(h[s], h1)
        if cell == "lstm":
            assert torch.equal(c[s], c1)
    want = R.rnn_scan_fused_reference(cell, hin, wx, b, wh, m)
    np.testing.assert_allclose(h.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=0.05,
                               rtol=0.05)
    shared = [(hin, wx, b, wh, m[:1]),
              (hin, wx[:1], b[:1], wh[:1], m)]
    for ops in shared:
        full = [t.expand(S, *t.shape[1:]).contiguous() for t in ops]
        got, _ = R._fused_states(cell, *ops, 1.0, False)
        ref, _ = R._fused_states(cell, *full, 1.0, False)
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_seed_batched_forward_at_the_c5_train_step(cuda):
    """The c5 train step's shape (64 seeds of B 2048, T 60, H 128, LSTM):
    h and c of the first, a middle and the last seed bitwise those of
    one-seed launches; every per-seed offset past 2^31 elements of c."""
    S, B, T, H = 64, 2048, 60, 128
    gen = torch.Generator(device=cuda).manual_seed(0)
    hin = torch.randn(S, B, T, H, generator=gen, device=cuda).to(
        torch.bfloat16)
    wx, wh = ((torch.randn(S, H, 4 * H, generator=gen, device=cuda) /
               H ** 0.5).to(torch.bfloat16) for _ in range(2))
    b = (0.1 * torch.randn(S, 4 * H, generator=gen, device=cuda)).to(
        torch.bfloat16)
    m = torch.rand(S, B, T, generator=gen, device=cuda) < 0.8
    h, c = R._fused_states("lstm", hin, wx, b, wh, m, 1.0, True)
    rows = R._mma_rows(
        B, torch.cuda.get_device_properties(cuda).multi_processor_count, S)
    assert rows == 64
    for s in (0, S // 2, S - 1):
        h1, c1 = R._launch_fwd_mma("lstm", hin[s], wx[s], b[s], wh[s], m[s],
                                   1.0, True, rows)
        assert torch.equal(h[s], h1) and torch.equal(c[s], c1)
    assert torch.isfinite(h).all()


def _hoisted(cell, B, T, H, seed, device):
    (hin, wx, b, wh), m = _inputs(cell, B, T, H, seed, device)
    xw = (hin.float() @ wx.float() + b.float()).to(torch.bfloat16)
    return xw, wh, m


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 9])
@pytest.mark.parametrize("B", [1, 37, 2048 + 5])
@pytest.mark.parametrize("H", [16, 64, 128])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_mma_hoisted_fwd_matches_plain(cuda, cell, H, B, T):
    """The hoisted mode (row 1 in bf16, ``rnn_scan``'s forward): h_all and
    the LSTM's c_all against the plain version at atol/rtol 0.05, one
    counted launch and nothing else; B = 37 and 2053 leave the last block
    part-filled; row 0 is all-invalid and stays exactly 0."""
    xw, wh, m = _hoisted(cell, B, T, H, B * T + H + 2, cuda)
    _build.reset_launch_counts()
    h, c = R._scan_states_any(cell, xw, wh, m, 1.0, True)
    counts = _build.launch_counts()
    assert counts[f"rnn_fwd_mma_{cell}"] == 1 and sum(counts.values()) == 1
    want_h, want_c = R.rnn_scan_states(cell, xw, wh, m, 1.0, True)
    assert h.dtype == torch.bfloat16 and h.shape == (B, T, H)
    pairs = [(h, want_h)] + ([(c, want_c)] if cell == "lstm" else [])
    for got, want in pairs:
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=0.05,
                                   rtol=0.05)
        assert not got[0].any()
    assert (c is None) == (cell == "gru")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 32])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_mma_hoisted_fwd_every_block_size(cuda, cell, rows):
    """Each block size of the hoisted mode on a batch that leaves the last
    block part-filled; 64 rows are refused, not run."""
    xw, wh, m = _hoisted(cell, 300, 7, 128, rows, cuda)
    h, c = R._launch_scan_fwd_mma(cell, xw, wh, m, 1.0, True, rows)
    want_h, want_c = R.rnn_scan_states(cell, xw, wh, m, 1.0, True)
    for got, want in ((h, want_h), (c, want_c)):
        if want is not None:
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       atol=0.05, rtol=0.05)
    with pytest.raises(ValueError, match="rows per block"):
        R._launch_scan_fwd_mma(cell, xw, wh, m, 1.0, True, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [64, 128])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_mma_hoisted_fwd_seed_grid_bitwise_equals_single_seed_launches(
        cuda, cell, H):
    """S = 3 seeds of the hoisted mode in one launch (counted once), W_h
    shared by every seed: h and c bitwise those of 3 one-seed launches
    with the same rows per block; m of seed extent 1 bitwise equal to its
    broadcast copy; each seed within the plain version's bound."""
    S, B, T = 3, 300, 7
    per = [_hoisted(cell, B, T, H, 120 + s, cuda) for s in range(S)]
    xw = torch.stack([p[0] for p in per])
    wh = per[0][1][None]
    m = torch.stack([p[2] for p in per])
    rows = R._mma_rows(
        B, torch.cuda.get_device_properties(cuda).multi_processor_count, S,
        hoisted=True)
    _build.reset_launch_counts()
    h, c = R._launch_scan_fwd_mma(cell, xw, wh, m, 1.0, True)
    assert _build.launch_counts()[f"rnn_fwd_mma_{cell}"] == 1
    assert h.shape == (S, B, T, H)
    for s in range(S):
        h1, c1 = R._launch_scan_fwd_mma(cell, xw[s], wh[0], m[s], 1.0, True,
                                        rows)
        assert torch.equal(h[s], h1)
        if cell == "lstm":
            assert torch.equal(c[s], c1)
        want = R.rnn_scan_reference(cell, xw[s], wh[0], m[s])
        np.testing.assert_allclose(h1.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=0.05,
                                   rtol=0.05)
    got, _ = R._launch_scan_fwd_mma(cell, xw, wh, m[:1], 1.0, False)
    ref, _ = R._launch_scan_fwd_mma(cell, xw, wh,
                                    m[:1].expand(S, B, T).contiguous(), 1.0,
                                    False)
    assert torch.equal(got, ref)
