"""The float32 backward above hidden 128 on the 3xTF32 tensor cores
(``csrc/rnn_bwd_tf32.cu``, W_h split across a cluster of 2-16 CTAs): its
route, cluster size and rows, shared memory, weight-gradient tiles and the
reduce-scatter of the carry's product, on the CPU; and the plain versions
it is held to on the card against the Pallas backwards at H 256 and 384.

* The route: float32 backwards at 128 < Hp <= 384 take ``"tf32"``, past
  it the CUDA cores; the forwards and every bf16 route as before.
* The picker (``ops/rnn.py _tf32_cluster``, ``_tf32_rows``) and the
  shared-memory mirror (``_tf32_smem``) against the source's constants
  and count, every (cell, Hp) from 144 to 384 fitting an H100's 232,448
  bytes, Hp 400 refused; the weight gradients' row tiles and slices.
* The cluster kernel at its lane addresses, CTA by CTA (shared-memory
  images laid out as the source lays them out, integer operands so every
  sum is exact): the recompute over the CTA's share, the carry's product
  by output chunks (warp w makes chunks w, w + NW, ..) over its own
  columns, each chunk stored once at the owner's slot of this rank, the
  owner adding its slots in rank order; equal to the plain products, the
  fragment loads free of bank conflicts.
* The same reduce-scatter in 3xTF32 arithmetic (``split`` and ``mma_f32``
  of ``tests/test_torch_tf32.py``: per 8-step, chains of at most 64 of k
  per gate, f32 sums) on the d_hw of ``_scan_bwd_core``, held to the
  carry's product at C 4, 8 and 16 (an uneven split: H 160 over 16 CTAs)
  and at H 384.
* Rows 4 and 2's plain versions in float32 against ``jax.vjp`` of the
  Pallas ``rnn_scan_fused`` and ``rnn_scan`` (interpret mode) at H 256
  and 384, B 4, T 3, an all-invalid row included: gradients scaled by the
  reference's largest magnitude, atol 1e-5 (the JAX f32 bound).

The kernels themselves are held to the plain versions on the card in
``tests/test_torch_kernels.py`` (``test_tf32_cluster_bwd_*``).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfm_quant_tpu.ops.pallas_rnn import rnn_scan as jax_scan
from lfm_quant_tpu.ops.pallas_rnn import rnn_scan_fused as jax_scan_fused
from lfm_quant_tpu_torch.ops import rnn as R
from test_torch_tf32 import (
    _ints,
    conflict_free,
    conflict_free_pairs,
    mma_f32,
    mma_frag,
)

GATES = {"lstm": 4, "gru": 3}
SRC = (Path(__file__).resolve().parents[1] / "lfm_quant_tpu_torch" / "csrc"
       / "rnn_bwd_tf32.cu")
H100_SMEM = 232_448  # shared memory a block can use on an H100
H100_SMS = 132
WIDTHS = tuple(range(144, 385, 16))

#: (cell, Hp) → the backward's cluster size on an H100.
WANT_C = {("lstm", 144): 2, ("lstm", 160): 4, ("lstm", 208): 4,
          ("lstm", 224): 8, ("lstm", 272): 8, ("lstm", 288): 16,
          ("lstm", 384): 16, ("gru", 144): 2, ("gru", 176): 2,
          ("gru", 192): 4, ("gru", 224): 4, ("gru", 240): 8,
          ("gru", 320): 8, ("gru", 336): 16, ("gru", 384): 16}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# The route, the picker and the counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H", [129, 136, 144, 200, 256, 320, 384, 385, 400,
                               512, 1024])
def test_float32_backward_route(H):
    """float32 backwards above 128 run on the 3xTF32 kernels up to Hp 384
    and past it on the grid kernel (``csrc/rnn_bwd_tf32_grid.cu``, to Hp
    1024); the float32 forward stays on the CUDA cores and bf16 as its
    route table says (the cluster to 512, the bf16 grids, forward and
    backward, past it)."""
    Hp = R._padded_width(H)
    f32, bf = torch.float32, torch.bfloat16
    assert R._mma_route(f32, H, "bwd") == ("tf32" if Hp <= 384 else "grid")
    assert R._mma_route(f32, H) == "simt"
    small = Hp <= R.CLUSTER_MAX_WIDTH
    assert R._mma_route(bf, H) == ("cluster" if small else "grid")
    assert R._mma_route(bf, H, "bwd") == ("cluster" if small else "grid")


def test_source_constants_agree():
    """The wrapper's cap, cluster sizes, rows, thread limits, units, slice
    tiles and shared-memory count are the source's (the weight-gradient
    kernel's tiles in the header it shares with the grid backward)."""
    header = SRC.parent / "tf32_common.cuh"
    text = SRC.read_text() + header.read_text()
    assert f"constexpr int kMaxWidth = {R.TF32_MAX_WIDTH};" in text
    assert f"constexpr int kMaxCluster = {max(R.TF32_CLUSTERS['bwd'])};" \
        in text
    assert f"constexpr int kUnits = {R.MMA_UNITS};" in text
    assert f"constexpr int kRowTiles = {R.TF32_ROWS // 16};" in text
    assert "constexpr int kWgOut = 128;" in text
    m = re.search(r"return rt == 1 \? (\d+) : (\d+);", text)
    assert m and tuple(map(int, m.groups())) == tuple(
        R.TF32_MAX_THREADS[r] for r in R.TF32_CLUSTER_ROWS)
    sizes = re.search(r"if \(C != (\d+) && C != (\d+) && C != (\d+) && "
                      r"C != kMaxCluster\)", text)
    assert sizes and tuple(map(int, sizes.groups())) == \
        R.TF32_CLUSTERS["bwd"][1:-1]
    assert "return kUnits * (warps_per_cta(H, C) | 1);" in text
    assert ("  const size_t LW = (size_t)G * kUnits * warps_per_cta(H, C) "
            "+ 4;\n  return 4 * ((size_t)H * LW + (size_t)rows * (H + 8) + "
            "(size_t)rows * LW +\n              (size_t)C * rows * "
            "recv_ld(H, C));") in text
    # Chains: the header's kChainK of k at most per accumulator.
    assert "constexpr int kChainK = 64;" in header.read_text()


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_every_width_fits_an_h100(cell):
    """Every (cell, Hp) from 144 to 384: the picker's C is the fewest the
    kernel takes whose count fits 232,448 bytes at 16 rows, rows 32 only
    where they are taken and fit too, and the count is the one written
    out below."""
    for Hp in WIDTHS:
        C = R._tf32_cluster(cell, Hp, H100_SMEM)
        assert C in R.TF32_CLUSTERS["bwd"][1:]
        assert R._tf32_takes(Hp, C, 16)
        assert R._tf32_smem(cell, Hp, C, "bwd", 16) <= H100_SMEM
        sizes = R.TF32_CLUSTERS["bwd"]
        for fewer in sizes[1:sizes.index(C)]:
            assert (not R._tf32_takes(Hp, fewer, 16)
                    or R._tf32_smem(cell, Hp, fewer, "bwd", 16) > H100_SMEM)
        rows = R._tf32_rows(cell, Hp, C, 2048, 1, H100_SMEM, H100_SMS)
        assert R._tf32_takes(Hp, C, rows)
        assert R._tf32_smem(cell, Hp, C, "bwd", rows) <= H100_SMEM
        if (cell, Hp) in WANT_C:
            assert C == WANT_C[cell, Hp], (cell, Hp, C)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_the_first_width_past_the_cap_is_refused(cell):
    """Hp 400 is past ``kMaxWidth`` (the LSTM's f32 W_h does not fit 16
    CTAs beside the tiles): the route is the grid kernel's, no cluster
    shape is taken and the cluster picker raises naming the width; a card
    whose shared memory holds no cluster's share at 384 raises too."""
    assert R._mma_route(torch.float32, 400, "bwd") == "grid"
    assert R._mma_route(torch.float32, 392, "bwd") == "grid"  # Hp 400
    assert not any(R._tf32_takes(400, C, r) for C in R.TF32_CLUSTERS["bwd"]
                   for r in R.TF32_CLUSTER_ROWS)
    with pytest.raises(ValueError, match="hidden=400"):
        R._tf32_cluster(cell, 400, H100_SMEM)
    with pytest.raises(ValueError, match="hidden=384"):
        R._tf32_cluster(cell, 384, 150_000)
    # Even 16 CTAs of 16 rows leave the LSTM at 400 past the card.
    if cell == "lstm":
        NW = -(-400 // 8 // 16)
        LW = 4 * 8 * NW + 4
        assert 4 * (400 * LW + 16 * 408 + 16 * LW) > H100_SMEM


@pytest.mark.parametrize("cell,Hp,B,S,rows", [
    ("lstm", 160, 2048, 1, 32), ("lstm", 144, 2048, 1, 16),
    ("lstm", 208, 2048, 1, 16), ("lstm", 320, 2048, 1, 32),
    ("lstm", 320, 37, 1, 16), ("lstm", 384, 2048, 1, 16),
    ("gru", 160, 2048, 1, 16), ("gru", 256, 2048, 3, 32),
    ("gru", 256, 100, 1, 16), ("gru", 384, 2048, 1, 32),
    ("lstm", 128, 5, 1, 32),
])
def test_rows_follow_the_fit_and_the_block_count(cell, Hp, B, S, rows):
    """32 rows above 128 where the kernel takes them (256 threads), they
    fit, and the launch still gives half the SMs a CTA; else 16; at H <=
    128 always :data:`TF32_ROWS`."""
    C = R._tf32_cluster(cell, Hp, H100_SMEM)
    assert R._tf32_rows(cell, Hp, C, B, S, H100_SMEM, H100_SMS) == rows


@pytest.mark.parametrize("cell,Hp,C,rows", [
    ("lstm", 160, 4, 32), ("lstm", 384, 16, 16), ("gru", 144, 2, 16),
    ("gru", 320, 8, 16), ("lstm", 208, 4, 16), ("gru", 384, 16, 32),
    ("lstm", 128, 2, 32), ("gru", 64, 1, 32)])
def test_smem_count_by_hand(cell, Hp, C, rows):
    """The count, written out. Above 128: the share [Hp, G U + 4] with U =
    8 ceil(Hp / 8 / C), one h tile [rows, Hp + 8], the d_hw tile [rows, G
    U + 4] and the receive buffer [C][rows][8 (NW | 1)], f32. At H <= 128
    as before (its literal values in ``tests/test_torch_tf32.py``)."""
    G = GATES[cell]
    if Hp > 128:
        NW = -(-(Hp // 8) // C)
        LW = G * 8 * NW + 4
        want = 4 * (Hp * LW + rows * (Hp + 8) + rows * LW
                    + C * rows * 8 * (NW | 1))
    else:
        Hc = Hp // C
        want = 4 * (Hp * (G * Hc + 4) + 2 * rows * (Hp + 8)
                    + rows * (G * Hc + 4)
                    + (2 * rows * (Hc + 8) if C > 1 else 0))
    assert R._tf32_smem(cell, Hp, C, "bwd", rows) == want
    # The widest: the LSTM at Hp 384 on 16 CTAs of 16 rows.
    assert R._tf32_smem("lstm", 384, 16, "bwd", 16) == 209_664


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_weight_gradient_slices_and_row_tiles(cell):
    """Kernel 2's per-seed partial sums stay within 128 MiB at every width
    (605 MB at 128 slices of the fused LSTM at H 384), the slices are a
    function of the shape alone (the sums' order, any seed count) and
    equal the H <= 128 count where that fits; its row tiles of 128 and
    its warps of 16 rows cover every output row of H exactly once."""
    G = GATES[cell]
    rows = 2048 * 60
    for H in (16, 128, 144, 256, 384):
        for fused in (True, False):
            total = 2 * H * G * H + G * H if fused else H * G * H
            n = R._tf32_slices(rows, total)
            assert 1 <= n <= R._slices(rows)
            assert 4 * n * total <= R.TF32_PARTIAL_BYTES
            if 128 * 4 * total <= R.TF32_PARTIAL_BYTES:
                assert n == R._slices(rows)
    assert R._tf32_slices(rows, 2 * 384 * 4 * 384 + 4 * 384) == 28
    for H in (144, 256, 384):
        seen = np.zeros(H, int)
        for tile in range(-(-H // 128)):
            for warp in range(8):
                ko = tile * 128 + warp * 16
                if ko < H:
                    seen[ko:ko + 16] += 1
        assert (seen == 1).all()


# ---------------------------------------------------------------------------
# The cluster kernel at its lane addresses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell,H,C,RT", [("lstm", 160, 4, 2),
                                         ("gru", 144, 2, 1),
                                         ("lstm", 160, 16, 1)])
def test_cluster_products_and_reduce_scatter_at_lane_addresses(cell, H, C,
                                                               RT):
    """Kernel 1 above 128 at its lane addresses, in each CTA j of a
    cluster of C: the share holds its units' columns (gate q's at q U), an
    idle warp's d tile columns are never written (NaN here) and never
    read; the recompute ``h_{t-1} @ W_h[:, own]`` per active warp (lane c
    taking k0 + 2c, k0 + 2c + 1); the carry's partial over the own
    columns by output chunks c = w + NW i, each stored once into its
    owner's receive buffer at slot j; each owner's rank-ordered sum is
    ``d_hw @ W_h^T``. Conflict-free fragment loads. (H 160 over 16 CTAs:
    20 warps of units, 4 CTAs own two, 12 one.)"""
    G = GATES[cell]
    rng = np.random.default_rng(H + C + G)
    BB = 16 * RT
    NW = R._cluster_warps(H, C)
    U, W = 8 * NW, H // 8
    LW, LD = G * U + 4, H + 8
    Wm = _ints(rng, H, G * H)
    h = _ints(rng, BB, H)
    dhw = _ints(rng, BB, G * H)
    h_s = np.full(BB * LD, np.nan)
    for r in range(BB):
        h_s[r * LD:r * LD + H] = h[r]
    recv = np.full((C, C, BB, U), np.nan)
    for j in range(C):
        units = list(R._cluster_units(H, C, j))
        own = len(units)
        assert own in (U, U - 8)
        wh_s = np.full(H * LW, np.nan)
        dg_s = np.full(BB * LW, np.nan)
        for k in range(H):
            for q in range(G):
                wh_s[k * LW + q * U:k * LW + q * U + U] = 0.0
                wh_s[k * LW + q * U:k * LW + q * U + own] = \
                    Wm[k, q * H + units[0]:q * H + units[0] + own]
        for r in range(BB):
            for q in range(G):
                dg_s[r * LW + q * U:r * LW + q * U + own] = \
                    dhw[r, q * H + units[0]:q * H + units[0] + own]
        # The recompute of the active warps.
        for warp in range(own // 8):
            for rt in range(RT):
                for q in range(G):
                    acc = [np.zeros(4) for _ in range(32)]
                    for k0 in range(0, H, 8):
                        wp = [(k0 + 2 * (l % 4)) * LW + warp * 8 + l // 4
                              + q * U for l in range(32)]
                        hp = [(rt * 16 + l // 4) * LD + k0 + 2 * (l % 4)
                              for l in range(32)]
                        assert conflict_free(wp) and conflict_free_pairs(hp)
                        b = [(wh_s[p], wh_s[p + LW]) for p in wp]
                        a = [(h_s[p], h_s[p + 8 * LD], h_s[p + 1],
                              h_s[p + 8 * LD + 1]) for p in hp]
                        for lane, d in enumerate(mma_frag(a, b)):
                            acc[lane] += d
                    for lane in range(32):
                        g, c = lane // 4, lane % 4
                        u = units[0] + warp * 8 + 2 * c
                        for i in range(4):
                            r = rt * 16 + g + 8 * (i >> 1)
                            assert acc[lane][i] == \
                                h[r] @ Wm[:, q * H + u + (i & 1)]
        # The carry's product by output chunks, over the own columns.
        for warp in range(NW):
            for c in range(warp, W, NW):
                part = np.zeros((BB, 8))
                for rt in range(RT):
                    acc = [np.zeros(4) for _ in range(32)]
                    for q in range(G):
                        for j0 in range(q * U, q * U + own, 8):
                            ap = [(rt * 16 + l // 4) * LW + j0 + l % 4
                                  for l in range(32)]
                            bp = [(8 * c + l // 4) * LW + j0 + l % 4
                                  for l in range(32)]
                            assert conflict_free(ap) and conflict_free(bp)
                            a = [(dg_s[p], dg_s[p + 8 * LW], dg_s[p + 4],
                                  dg_s[p + 8 * LW + 4]) for p in ap]
                            b = [(wh_s[p], wh_s[p + 4]) for p in bp]
                            for lane, d in enumerate(mma_frag(a, b)):
                                acc[lane] += d
                    for lane in range(32):
                        g, cc = lane // 4, lane % 4
                        for i in range(4):
                            part[rt * 16 + g + 8 * (i >> 1),
                                 2 * cc + (i & 1)] = acc[lane][i]
                p = ((c + 1) * C - 1) // W
                assert 8 * c in R._cluster_units(H, C, p)
                lu = (c - p * W // C) * 8
                assert np.isnan(recv[p, j, :, lu:lu + 8]).all()  # once
                recv[p, j, :, lu:lu + 8] = part
    dh = np.full((BB, H), np.nan)
    for p in range(C):
        units = list(R._cluster_units(H, C, p))
        acc = recv[p, 0, :, :len(units)].copy()
        for j in range(1, C):
            acc = acc + recv[p, j, :, :len(units)]
        dh[:, units] = acc
    np.testing.assert_array_equal(dh, dhw @ Wm.T)


# ---------------------------------------------------------------------------
# The reduce-scatter in 3xTF32 arithmetic
# ---------------------------------------------------------------------------


def _tf32_carry(d_hw, wh, cell, C):
    """The carry's product ``d_hw @ W_h^T`` as the cluster forms it in
    3xTF32: per CTA j, each gate's own columns in chains of at most 64 of
    k (each chain per 8-step, ``mma_f32``), the chains added in f32 into
    the CTA's partial over every unit; each owner adds the C partials of
    its units in rank order in f32."""
    G = GATES[cell]
    rows, H = d_hw.shape[0], wh.shape[0]
    d = d_hw.reshape(rows, G, H)
    w = wh.reshape(H, G, H)
    partials = []
    for j in range(C):
        units = list(R._cluster_units(H, C, j))
        part = np.zeros((rows, H), np.float32)
        for q in range(G):
            for jc in range(0, len(units), 64):
                cols = units[jc:jc + 64]
                chain = mma_f32(d[:, q, cols], w[:, q, cols].T.copy())
                part = (part + chain).astype(np.float32)
        partials.append(part)
    out = np.empty((rows, H), np.float32)
    for p in range(C):
        units = list(R._cluster_units(H, C, p))
        acc = partials[0][:, units]
        for j in range(1, C):
            acc = (acc + partials[j][:, units]).astype(np.float32)
        out[:, units] = acc
    return out


@pytest.mark.parametrize("cell,H,C", [("lstm", 160, 4), ("gru", 160, 16),
                                      ("lstm", 160, 16), ("gru", 256, 8),
                                      ("lstm", 384, 16), ("gru", 384, 4)])
def test_reduce_scatter_in_3xtf32_holds_the_carry_product(cell, H, C):
    """The reduce-scatter in 3xTF32 on the d_hw of ``_scan_bwd_core``
    (float32, B 16, T 2, weights at H^-1/2) against the carry's f32
    product that the plain backward adds into the dh carry and against
    float64: within scaled 1e-6 (the JAX f32 bound is 1e-5); a dropped
    term (one TF32 product) is not, at the same sizes."""
    G = GATES[cell]
    B, T = 16, 2
    rng = np.random.default_rng(H + C + G)
    xw = torch.from_numpy(rng.standard_normal((B, T, G * H))).float()
    wh = torch.from_numpy(H ** -0.5 * rng.standard_normal((H, G * H))).float()
    m = torch.from_numpy(rng.random((B, T)) < 0.75)
    m[3] = False
    h, c = R.rnn_scan_states(cell, xw, wh, m, 1.0, True)
    dh = (0.1 * torch.from_numpy(rng.standard_normal((B, T, H)))).float()
    _, d_hw, _ = R._scan_bwd_core(cell, xw, wh, m, h, c, dh, 1.0)
    whn = wh.numpy()
    for t in range(T):
        d = d_hw[:, t].numpy()
        want = d.astype(np.float64) @ whn.T.astype(np.float64)
        scale = np.abs(want).max()
        got = _tf32_carry(d, whn, cell, C)
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-6 * scale
        f32 = (d_hw[:, t] @ wh.T).numpy()
        assert np.abs(got - f32).max() <= 1e-6 * scale
    one = mma_f32(d, whn.T.copy(), terms=1)
    assert np.abs(one - want).max() > 1e-5 * scale


# ---------------------------------------------------------------------------
# The plain versions against the Pallas backwards
# ---------------------------------------------------------------------------


def _scaled_close(got, want, atol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


def _pallas_vjps(cell, hin, wx, b, wh, xw, m, ct):
    """``jax.vjp`` of the Pallas ``rnn_scan_fused`` (row 4) and ``rnn_scan``
    (row 2, on ``xw``) with the cotangent ``ct``, in one jitted call (the
    eager values, in a third of the time)."""

    @jax.jit
    def both(hin, wx, b, wh, xw, m, ct):
        row4 = jax.vjp(lambda *a: jax_scan_fused(cell, *a, m),
                       hin, wx, b, wh)[1](ct)
        row2 = jax.vjp(lambda x, w: jax_scan(cell, x, w, m), xw, wh)[1](ct)
        return row4, row2

    return ([np.asarray(g) for g in r]
            for r in both(hin, wx, b, wh, xw, m, ct))


@pytest.mark.parametrize("cell,H", [("lstm", 256), ("gru", 256),
                                    ("lstm", 384), ("gru", 384)])
def test_plain_rows_match_the_pallas_backwards_in_float32(cell, H):
    """Rows 4 and 2's plain versions in float32, on the states of the
    plain forwards, against ``jax.vjp`` of the Pallas ops (interpret mode,
    jitted) with the same cotangent, at B 4, T 3, an all-invalid row
    included: dhin, dW_x, db, dW_h and dxw, dW_h, scaled atol 1e-5."""
    B, T = 4, 3
    G = GATES[cell] * H
    rng = np.random.default_rng(H + 11 * len(cell))
    sd = H ** -0.5
    hin = rng.standard_normal((B, T, H)).astype(np.float32)
    wx = (sd * rng.standard_normal((H, G))).astype(np.float32)
    b = (0.1 * rng.standard_normal((G,))).astype(np.float32)
    wh = (sd * rng.standard_normal((H, G))).astype(np.float32)
    m = rng.random((B, T)) < 0.75
    m[1] = False
    dh = (0.1 * rng.standard_normal((B, T, H))).astype(np.float32)
    j = [jnp.asarray(a) for a in (hin, wx, b, wh)]
    jm, jdh = jnp.asarray(m), jnp.asarray(dh)
    t = [torch.from_numpy(a) for a in (hin, wx, b, wh)]
    tm, tdh = torch.from_numpy(m), torch.from_numpy(dh)

    xw = t[0] @ t[1] + t[2]
    want4, want2 = _pallas_vjps(cell, *j, jnp.asarray(xw.numpy()), jm, jdh)

    # Row 4.
    hs, cs = R.rnn_scan_states(cell, xw, t[3], tm, 1.0, True)
    got = R.rnn_scan_fused_bwd_reference(cell, *t, tm, hs, cs, tdh)
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, want4):
        assert torch.isfinite(g).all()
        _scaled_close(g.numpy(), w)
    assert not got[0][1].any()  # the all-invalid row

    # Row 2, on the same xw.
    got = R.rnn_scan_bwd_reference(cell, xw, t[3], tm, hs, cs, tdh)
    for g, w in zip(got, want2):
        assert torch.isfinite(g).all()
        _scaled_close(g.numpy(), w)
    assert not got[0][1].any()
