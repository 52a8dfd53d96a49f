"""The bfloat16 backward above hidden 128 (``csrc/rnn_bwd_cluster.cu``):
its route, cluster size and rows, its per-CTA packing of W_h and the
reduce-scatter of the carry's product, on the CPU; and the plain versions
it is held to on the card against the Pallas backwards at H 320 and 512.

* The route: bf16 backwards at 128 < Hp <= 512 take ``"cluster"``,
  bf16 past 512 the bf16 grid, float32 above 128 the 3xTF32 cluster up
  to Hp 384 and the grid past it, every H <= 128 as before.
* The picker (``ops/rnn.py _cluster_bwd_size``, ``_cluster_bwd_rows``)
  and the shared-memory mirror (``_cluster_bwd_smem``) against the
  source's constants and count, with every (cell, Hp) from 144 to 512
  fitting an H100's 232,448 bytes, and Hp 528 refused.
* The packing (``pack_cluster_bwd``): each CTA's row-major slice holds
  exactly its units' G gate columns, every other place zero.
* The reduce-scatter, modelled CTA by CTA as the source runs it: each
  CTA's share from the packing, its d_hw tile split into bf16 hi and lo,
  the partial product over its own columns by output chunks (warp w
  makes chunks w, w + NW, ..), each chunk stored at the owner's slot of
  this rank, the owner adding its slots in rank order; held to the
  carry's f32 product of ``_scan_bwd_core`` at H 320 and 512 for every
  cluster size the kernel takes there.
* Rows 4 and 2's plain versions (``rnn_scan_fused_bwd_reference``,
  ``rnn_scan_bwd_reference``) in bf16 against ``jax.vjp`` of
  ``lfm_quant_tpu.ops.pallas_rnn rnn_scan_fused`` and ``rnn_scan``
  (Pallas, interpret mode, jitted: the same values as eager, in a third
  of the time) at H 320 and 512, B 4, T 3, an all-invalid row included;
  gradients scaled by the reference's largest magnitude, atol 0.05 (the
  bf16 bound of ``tests/test_torch_rnn_grad.py``).

The kernels themselves are held to the plain versions on the card in
``tests/test_torch_kernels.py`` (``test_cluster_bwd_*``).
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

GATES = {"lstm": 4, "gru": 3}
SRC = (Path(__file__).resolve().parents[1] / "lfm_quant_tpu_torch" / "csrc"
       / "rnn_bwd_cluster.cu")
H100_SMEM = 232_448  # shared memory a block can use on an H100
H100_SMS = 132
WIDTHS = tuple(range(144, 513, 16))

#: (cell, Hp) → the backward's cluster size on an H100.
WANT_C = {("lstm", 144): 2, ("lstm", 192): 2, ("lstm", 208): 4,
          ("lstm", 256): 4, ("lstm", 288): 4, ("lstm", 320): 8,
          ("lstm", 384): 8, ("lstm", 400): 16, ("lstm", 512): 16,
          ("gru", 144): 2, ("gru", 192): 2, ("gru", 256): 4,
          ("gru", 320): 4, ("gru", 336): 8, ("gru", 432): 8,
          ("gru", 448): 16, ("gru", 512): 16}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# The route and the picker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H", [8, 120, 128, 129, 144, 200, 256, 320, 500,
                               512, 513, 528, 1024, 1530])
def test_backward_route_table(H):
    """bf16 above 128 up to Hp 512 runs the backward on the cluster; bf16
    past 512 on the bf16 grid (``"grid"``, to Hp 1520); float32 above 128
    on the 3xTF32 kernels on a cluster up to Hp 384 (``"tf32"``) and on the
    grid past it, to Hp 1024 (``"grid"``); H <= 128 as before (bf16
    ``"mma"``, float32 ``"tf32"``). The bf16 forward's route is the
    backward's at every width: the cluster to 512, the grid to 1520 and
    the CUDA cores past it (H 1530)."""
    Hp = R._padded_width(H)
    bf, f32 = torch.bfloat16, torch.float32
    if Hp <= 128:
        want_bf, want_f32 = "mma", "tf32"
    elif Hp <= R.CLUSTER_MAX_WIDTH:
        want_bf = "cluster"
        want_f32 = "tf32" if Hp <= R.TF32_MAX_WIDTH else "grid"
    else:
        want_bf = "grid" if Hp <= R.BF16_GRID_MAX_WIDTH else "simt"
        want_f32 = "grid" if Hp <= R.GRID_MAX_WIDTH else "simt"
    assert R._mma_route(bf, H, "bwd") == want_bf
    assert R._mma_route(bf, H) == want_bf
    assert R._mma_route(f32, H, "bwd") == want_f32


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_every_width_fits_an_h100(cell):
    """Every (cell, Hp) from 144 to 512: the picker's C is the fewest the
    kernel takes whose count fits 232,448 bytes, and rows 32 come only
    where they fit too."""
    for Hp in WIDTHS:
        C = R._cluster_bwd_size(cell, Hp, H100_SMEM)
        assert R._cluster_bwd_takes(Hp, C, 16)
        assert R._cluster_bwd_smem(cell, Hp, C, 16) <= H100_SMEM
        for fewer in R.CLUSTER_SIZES[:R.CLUSTER_SIZES.index(C)]:
            assert (not R._cluster_bwd_takes(Hp, fewer, 16)
                    or R._cluster_bwd_smem(cell, Hp, fewer, 16) > H100_SMEM)
        rows = R._cluster_bwd_rows(cell, Hp, C, 2048, 1, H100_SMEM,
                                   H100_SMS)
        assert R._cluster_bwd_takes(Hp, C, rows)
        assert R._cluster_bwd_smem(cell, Hp, C, rows) <= H100_SMEM
        if (cell, Hp) in WANT_C:
            assert C == WANT_C[cell, Hp], (cell, Hp, C)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_a_width_past_the_kernel_is_refused(cell):
    """Hp 528 is past ``kMaxWidth``: the bf16 backward's route is the bf16
    grid, no shape is taken here, and the picker raises naming the width;
    a card whose shared memory holds no cluster's share raises too."""
    assert R._mma_route(torch.bfloat16, 520, "bwd") == "grid"  # Hp 528
    assert not any(R._cluster_bwd_takes(528, C, r) for C in R.CLUSTER_SIZES
                   for r in R.CLUSTER_ROWS)
    with pytest.raises(ValueError, match="hidden=528"):
        R._cluster_bwd_size(cell, 528, H100_SMEM)
    with pytest.raises(ValueError, match="hidden=512"):
        R._cluster_bwd_size(cell, 512, 96 * 1024)


@pytest.mark.parametrize("cell,Hp,B,S,rows", [
    ("lstm", 256, 2048, 1, 16), ("lstm", 240, 2048, 1, 32),
    ("lstm", 240, 37, 1, 16), ("lstm", 320, 2048, 1, 32),
    ("lstm", 512, 2048, 1, 16), ("gru", 256, 2048, 1, 32),
    ("gru", 256, 2048, 3, 32), ("gru", 256, 200, 1, 16),
    ("gru", 320, 2048, 1, 16), ("gru", 336, 2048, 1, 32),
    ("gru", 144, 2048, 1, 16),
])
def test_rows_follow_the_fit_and_the_block_count(cell, Hp, B, S, rows):
    """32 rows where the kernel takes them (256 threads), they fit, and
    the launch still gives half the SMs a CTA; else 16."""
    C = R._cluster_bwd_size(cell, Hp, H100_SMEM)
    assert R._cluster_bwd_rows(cell, Hp, C, B, S, H100_SMEM,
                               H100_SMS) == rows


def test_source_constants_agree():
    """The wrapper's widths, units, sizes, thread limits and shared-memory
    count are the source's (its weight-gradient and dhin kernels, with the
    split's term count, in ``bf16_wgrad.cuh``, shared with the grid
    backward past 512)."""
    text = SRC.read_text() + (SRC.parent / "bf16_wgrad.cuh").read_text()
    assert f"constexpr int kMaxWidth = {R.CLUSTER_MAX_WIDTH};" in text
    assert f"constexpr int kUnits = {R.MMA_UNITS};" in text
    assert f"constexpr int kMaxCluster = {max(R.CLUSTER_SIZES)};" in text
    m = re.search(r"return rt == 1 \? (\d+) : (\d+);", text)
    assert m and tuple(map(int, m.groups())) == tuple(
        R.CLUSTER_BWD_MAX_THREADS[r] for r in R.CLUSTER_ROWS)
    assert "return (gu + 15) / 16 * 16;" in text
    assert "return kUnits * (warps_per_cta(H, C) | 1);" in text
    assert ("return (size_t)H * LW * 2 + 2 * (size_t)rows * (H + 8) * 2 +\n"
            "         (size_t)kSplit * rows * LW * 2 + (size_t)C * rows * "
            "recv_ld(H, C) * 4;") in text
    assert "constexpr int kSplit = 2;" in text
    sizes = re.search(r"if \(C != (\d+) && C != (\d+) && C != (\d+) && "
                      r"C != kMaxCluster\)", text)
    assert sizes and tuple(map(int, sizes.groups())) == R.CLUSTER_SIZES[:-1]


@pytest.mark.parametrize("cell,Hp,C,rows", [
    ("lstm", 512, 16, 16), ("lstm", 256, 4, 16), ("gru", 320, 4, 16),
    ("gru", 256, 4, 32), ("lstm", 144, 2, 16), ("gru", 432, 8, 16)])
def test_smem_count_by_hand(cell, Hp, C, rows):
    """The count, written out: share [Hp, GUP + 8] and two d tiles [rows,
    GUP + 8] bf16, two h tiles [rows, Hp + 8] bf16, the receive buffer
    [C][rows][8 (NW | 1)] f32."""
    NW = -(-(Hp // 8) // C)
    GUP = -(-GATES[cell] * 8 * NW // 16) * 16
    want = (Hp * (GUP + 8) * 2 + 2 * rows * (Hp + 8) * 2
            + 2 * rows * (GUP + 8) * 2 + C * rows * 8 * (NW | 1) * 4)
    assert R._cluster_bwd_smem(cell, Hp, C, rows) == want
    assert R._cluster_share_cols(cell, Hp, C) == GUP


# ---------------------------------------------------------------------------
# The packing and the reduce-scatter
# ---------------------------------------------------------------------------


def _share(packed, C, Hp, GUP, j):
    return packed.reshape(C, Hp, GUP)[j]


@pytest.mark.parametrize("cell,H,C", [("lstm", 144, 2), ("gru", 200, 4),
                                      ("lstm", 256, 4), ("gru", 336, 8),
                                      ("lstm", 500, 16), ("gru", 512, 16)])
def test_backward_packing_round_trips_per_cta(cell, H, C):
    """The packing's real places are a permutation of W_h's entries; CTA
    j's slice [Hp, GUP] holds at row k, column q U + i the entry W_h[k,
    q H + u] of its i-th unit u (every k < H), and zero at every other
    place (padding, an idle warp, past G U)."""
    G = GATES[cell]
    Hp = R._padded_width(H)
    w = torch.arange(1, H * G * H + 1, dtype=torch.float64).view(H, G * H)
    packed = R.pack_cluster_bwd(w, C, width=Hp)
    GUP = R._cluster_share_cols(cell, Hp, C)
    U = 8 * R._cluster_warps(Hp, C)
    assert packed.numel() == C * Hp * GUP
    nz = packed[packed != 0]
    assert torch.equal(nz.sort().values, w.reshape(-1))
    for j in range(C):
        sh = _share(packed, C, Hp, GUP, j)
        units = list(R._cluster_units(Hp, C, j))
        want = torch.zeros(Hp, GUP, dtype=w.dtype)
        for q in range(G):
            for i, u in enumerate(units):
                if u < H:
                    want[:H, q * U + i] = w[:, q * H + u]
        assert torch.equal(sh, want)
    # A seed stack packs per seed.
    ws = torch.stack([w, -w])
    assert torch.equal(R.pack_cluster_bwd(ws, C, width=Hp),
                       torch.stack([packed, -packed]))


def _split(d):
    """d = hi + lo in bf16, as the source splits it."""
    hi = d.to(torch.bfloat16)
    lo = (d - hi.float()).to(torch.bfloat16)
    return hi.double(), lo.double()


def _reduce_scatter(d_hw, wh, cell, Hp, C):
    """The carry's product d_hw @ W_h^T [rows, Hp], as the cluster forms
    it: per CTA j, its share from the packing and its d tile (d_hw's
    columns of its units, hi and lo, column q U + i); its partial over its
    own columns by output chunks c = w + NW i of warp w; each chunk stored
    at slot j of the owner ((c + 1) C - 1) // W, local unit (c - p W // C)
    8; each owner adds its slots in rank order."""
    G = GATES[cell]
    rows, H = d_hw.shape[0], wh.shape[0]
    NW = R._cluster_warps(Hp, C)
    U, W = 8 * NW, Hp // 8
    GUP = R._cluster_share_cols(cell, Hp, C)
    packed = R.pack_cluster_bwd(wh.double(), C, width=Hp)
    dpad = torch.zeros(rows, G, Hp, dtype=torch.float64)
    dpad[:, :, :H] = d_hw.double().view(rows, G, H)
    recv = torch.full((C, C, rows, U), float("nan"), dtype=torch.float64)
    for j in range(C):
        units = list(R._cluster_units(Hp, C, j))
        tile = torch.zeros(rows, GUP, dtype=torch.float64)
        for q in range(G):
            tile[:, q * U:q * U + len(units)] = dpad[:, q, units]
        hi, lo = _split(tile.float())
        sh = _share(packed, C, Hp, GUP, j)
        for warp in range(NW):
            for c in range(warp, W, NW):
                v = slice(8 * c, 8 * c + 8)
                part = hi @ sh[v].T + lo @ sh[v].T  # [rows, 8]
                p = ((c + 1) * C - 1) // W
                assert 8 * c in R._cluster_units(Hp, C, p)
                lu = (c - p * W // C) * 8
                assert torch.isnan(recv[p, j, :, lu:lu + 8]).all()  # once
                recv[p, j, :, lu:lu + 8] = part
    out = torch.empty(rows, Hp, dtype=torch.float64)
    for p in range(C):
        units = list(R._cluster_units(Hp, C, p))
        acc = recv[p, 0, :, :len(units)].clone()
        for j in range(1, C):
            acc = acc + recv[p, j, :, :len(units)]
        out[:, units] = acc
    return out[:, :H]


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("H", [320, 512])
def test_reduce_scatter_holds_the_carry_product(cell, H):
    """The modelled reduce-scatter of every cluster size the kernel takes
    at H, on the d_hw of ``_scan_bwd_core`` (bf16 operands, B 16, T 3), is
    the f32 product ``d_hw @ W_h^T`` that the plain backward adds into the
    dh carry: every chunk lands once in its owner's slot (none left
    unwritten), and the split keeps it within 2^-15 of the sum of
    magnitudes."""
    G = GATES[cell]
    B, T = 16, 3
    rng = np.random.default_rng(H + G)
    sd = H ** -0.5
    xw = torch.from_numpy(rng.standard_normal((B, T, G * H))).float()
    wh = torch.from_numpy(sd * rng.standard_normal((H, G * H))).to(
        torch.bfloat16)
    m = torch.from_numpy(rng.random((B, T)) < 0.75)
    m[3] = False
    h, c = R.rnn_scan_states(cell, xw, wh, m, 1.0, True)
    dh = (0.1 * torch.from_numpy(rng.standard_normal((B, T, H)))).to(
        torch.bfloat16)
    _, d_hw, _ = R._scan_bwd_core(cell, xw, wh, m, h.to(torch.bfloat16),
                                  None if c is None else c.to(torch.bfloat16),
                                  dh, 1.0)
    Hp = R._padded_width(H)
    sizes = [C for C in R.CLUSTER_SIZES if R._cluster_bwd_takes(Hp, C, 16)
             and R._cluster_bwd_smem(cell, Hp, C, 16) <= H100_SMEM]
    assert R._cluster_bwd_size(cell, Hp, H100_SMEM) == sizes[0]
    whf = wh.float()
    for t in range(T):
        want = d_hw[:, t] @ whf.T
        mag = d_hw[:, t].abs().double() @ whf.abs().double().T
        for C in sizes:
            got = _reduce_scatter(d_hw[:, t], wh, cell, Hp, C)
            assert torch.isfinite(got).all()
            assert ((got - want.double()).abs()
                    <= 2.0 ** -15 * mag + 1e-7).all(), (t, C)


# ---------------------------------------------------------------------------
# The plain versions against the Pallas backwards
# ---------------------------------------------------------------------------


def _scaled_close(got, want, atol=0.05):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


def _pallas_vjps(cell, hin, wx, b, wh, xw, m, ct):
    """``jax.vjp`` of the Pallas ``rnn_scan_fused`` (row 4) and ``rnn_scan``
    (row 2, on ``xw``) with the cotangent ``ct``, in one jitted call."""

    @jax.jit
    def both(hin, wx, b, wh, xw, m, ct):
        row4 = jax.vjp(lambda *a: jax_scan_fused(cell, *a, m),
                       hin, wx, b, wh)[1](ct)
        row2 = jax.vjp(lambda x, w: jax_scan(cell, x, w, m), xw, wh)[1](ct)
        return row4, row2

    return ([np.asarray(g.astype(jnp.float32)) for g in r]
            for r in both(hin, wx, b, wh, xw, m, ct))


@pytest.mark.parametrize("cell,H", [("lstm", 320), ("gru", 320),
                                    ("lstm", 512), ("gru", 512)])
def test_plain_rows_match_the_pallas_backwards_at_cluster_widths(cell, H):
    """Rows 4 and 2's plain versions in bf16, on the states of the plain
    forwards, against ``jax.vjp`` of the Pallas ops (interpret mode) with
    the same cotangent, at B 4, T 3, an all-invalid row included: dhin,
    dW_x, db, dW_h and dxw, dW_h, scaled atol 0.05."""
    B, T = 4, 3
    G = GATES[cell] * H
    rng = np.random.default_rng(H + 7 * len(cell))
    sd = H ** -0.5
    hin = rng.standard_normal((B, T, H)).astype(np.float32)
    wx = (sd * rng.standard_normal((H, G))).astype(np.float32)
    b = (0.1 * rng.standard_normal((G,))).astype(np.float32)
    wh = (sd * rng.standard_normal((H, G))).astype(np.float32)
    m = rng.random((B, T)) < 0.75
    m[1] = False
    dh = (0.1 * rng.standard_normal((B, T, H))).astype(np.float32)
    bf = jnp.bfloat16
    j = [jnp.asarray(a).astype(bf) for a in (hin, wx, b, wh)]
    jm, jdh = jnp.asarray(m), jnp.asarray(dh).astype(bf)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (hin, wx, b, wh)]
    tm, tdh = torch.from_numpy(m), torch.from_numpy(dh).to(torch.bfloat16)

    xw32 = t[0].float() @ t[1].float() + t[2].float()
    xw = xw32.to(torch.bfloat16)
    jxw = jnp.asarray(xw.float().numpy()).astype(bf)
    want4, want2 = _pallas_vjps(cell, *j, jxw, jm, jdh)

    # Row 4.
    hs, cs = R.rnn_scan_states(cell, xw32, t[3], tm, 1.0, True)
    hs = hs.to(torch.bfloat16)
    cs = None if cs is None else cs.to(torch.bfloat16)
    got = R.rnn_scan_fused_bwd_reference(cell, *t, tm, hs, cs, tdh)
    assert got[0].dtype == torch.bfloat16
    for g, w in zip(got, want4):
        assert torch.isfinite(g.float()).all()
        _scaled_close(g.float().numpy(), w)

    # Row 2, on the bf16 xw.
    hs, cs = R.rnn_scan_states(cell, xw, t[3], tm, 1.0, True)
    got = R.rnn_scan_bwd_reference(cell, xw, t[3], tm, hs, cs, tdh)
    assert got[0].dtype == torch.bfloat16
    for g, w in zip(got, want2):
        assert torch.isfinite(g.float()).all()
        _scaled_close(g.float().numpy(), w)
    assert not got[0][1].float().any()  # the all-invalid row
