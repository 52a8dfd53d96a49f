"""The bfloat16 forward above hidden 128 (``csrc/rnn_fwd_cluster.cu``):
its cluster size and rows, its per-CTA packing of W_h and the products
at the source's lane addresses, on the CPU; and the plain versions it is
held to on the card against the Pallas forwards at H 320 and 512.

* The picker (``ops/rnn.py _cluster_size``, ``_cluster_rows``) against
  the shared-memory count at H 144, 200, 256, 320, 512 and one width past
  the kernel (528: the CUDA-core route, and the picker raises).
* The packing (``pack_cluster``): the real entries a permutation of W_h,
  each CTA's slice exactly its units' G gate columns, and the m16n8k16
  products of every warp's slice, modelled lane by lane as the source
  forms them (ldmatrix A rows, the B fragment, the accumulator's
  (row, unit) places), equal to ``h @ W_h`` on integer-valued operands.
* ``RNNModel.row_state_bytes`` counts the fused cluster forward's f32 xw
  scratch.
* Rows 1 and 3's plain versions (``rnn_scan_states`` fed ``xw`` and ``hin
  @ W_x + b``) against ``lfm_quant_tpu.ops.pallas_rnn rnn_scan`` and
  ``rnn_scan_fused`` (Pallas, interpret mode) at H 320 and 512, bf16 at
  the JAX package's bound, atol/rtol 0.05 (``tests/
  test_torch_hoisted_seeds.py`` holds hidden 256 through the model).

The kernels themselves are held to the plain versions on the card in
``tests/test_torch_kernels.py`` (``test_cluster_*``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfm_quant_tpu.ops.pallas_rnn import rnn_scan as jax_scan
from lfm_quant_tpu.ops.pallas_rnn import rnn_scan_fused as jax_scan_fused
from lfm_quant_tpu_torch.models import RNNModel
from lfm_quant_tpu_torch.ops import rnn as R

GATES = {"lstm": 4, "gru": 3}
SRC = (Path(__file__).resolve().parents[1] / "lfm_quant_tpu_torch" / "csrc"
       / "rnn_fwd_cluster.cu")
H100_SMEM = 232_448  # shared memory a block can use on an H100
H100_SMS = 132
BF16 = dict(atol=0.05, rtol=0.05)

#: (cell, H) → the cluster size the picker takes on an H100 (H padded to
#: the next multiple of 16: 200 runs at 208).
WANT_C = {("lstm", 144): 2, ("lstm", 200): 2, ("lstm", 256): 4,
          ("lstm", 320): 4, ("lstm", 512): 16, ("gru", 144): 2,
          ("gru", 200): 2, ("gru", 256): 2, ("gru", 320): 4,
          ("gru", 512): 8}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# The picker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell,H", sorted(WANT_C))
def test_cluster_size_is_the_fewest_ctas_that_fit(cell, H):
    """The bf16 forward at H takes the cluster route; the picker's C is the
    fewest CTAs whose W_h share fits beside two 16-row h tiles in the
    card's shared memory, as the source counts it; every fewer C that the
    kernel takes is over the limit."""
    Hp = R._padded_width(H)
    assert R._mma_route(torch.bfloat16, H) == "cluster"
    assert R._mma_route(torch.bfloat16, H, "bwd") == "cluster"
    assert R._mma_route(torch.float32, H) == "simt"
    C = R._cluster_size(cell, Hp, H100_SMEM)
    assert C == WANT_C[cell, H]
    assert R._cluster_takes(Hp, C, 16)
    assert R._cluster_smem(cell, Hp, C, 16) <= H100_SMEM
    for fewer in R.CLUSTER_SIZES[:R.CLUSTER_SIZES.index(C)]:
        assert (not R._cluster_takes(Hp, fewer, 16)
                or R._cluster_smem(cell, Hp, fewer, 16) > H100_SMEM)
    # The count: the W_h share [Hp, G U] and two h tiles [16, Hp + 8].
    U = 8 * R._cluster_warps(Hp, C)
    assert R._cluster_smem(cell, Hp, C, 16) == (
        Hp * GATES[cell] * U * 2 + 2 * 16 * (Hp + 8) * 2)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_a_width_past_the_kernel_routes_to_the_cuda_cores(cell):
    """Hp 528 is past ``kMaxWidth``: the bf16 forward's route is the grid
    (``csrc/rnn_fwd_grid.cu``) up to Hp 1520 and the CUDA cores past it (H
    1530), and the cluster picker raises naming the width; a card whose
    shared memory holds no cluster's share raises too."""
    assert R._mma_route(torch.bfloat16, 528) == "grid"
    assert R._mma_route(torch.bfloat16, 520) == "grid"  # Hp 528
    assert R._mma_route(torch.bfloat16, 1530) == "simt"  # Hp 1536
    assert R._mma_route(torch.bfloat16, 512) == "cluster"
    with pytest.raises(ValueError, match="hidden=528"):
        R._cluster_size(cell, 528, H100_SMEM)
    assert not any(R._cluster_takes(528, C, r) for C in R.CLUSTER_SIZES
                   for r in R.CLUSTER_ROWS)
    with pytest.raises(ValueError, match="hidden=512"):
        R._cluster_size(cell, 512, 48 * 1024)


@pytest.mark.parametrize("cell,H,B,S,rows", [
    ("lstm", 256, 2048, 1, 32), ("lstm", 320, 2048, 1, 16),
    ("lstm", 512, 2048, 1, 32), ("lstm", 256, 37, 1, 16),
    ("lstm", 256, 2048, 3, 32), ("gru", 256, 2048, 1, 16),
    ("gru", 512, 2048, 1, 16), ("lstm", 144, 2048, 1, 32),
    ("lstm", 512, 16384, 1, 32), ("gru", 320, 200, 1, 16),
    ("gru", 320, 2048, 1, 32), ("lstm", 144, 37, 3, 16),
])
def test_rows_follow_the_block_count(cell, H, B, S, rows):
    """32 rows where their tiles fit beside the W_h share, within the
    CTA's thread limit, while they still give half the SMs a CTA; else
    16."""
    C = R._cluster_size(cell, H, H100_SMEM)
    got = R._cluster_rows(cell, H, C, B, S, H100_SMEM, H100_SMS)
    assert got == rows
    assert R._cluster_takes(H, C, got)
    assert R._cluster_smem(cell, H, C, got) <= H100_SMEM
    assert R._cluster_warps(H, C) * 32 <= R.CLUSTER_MAX_THREADS[got]


def test_source_constants_agree():
    """The wrapper's widths, units and thread limits are the source's."""
    text = SRC.read_text()
    assert f"constexpr int kMaxWidth = {R.CLUSTER_MAX_WIDTH};" in text
    assert f"constexpr int kUnits = {R.MMA_UNITS};" in text
    m = re.search(r"return rt == 1 \? (\d+) : (\d+);", text)
    assert m and tuple(map(int, m.groups())) == tuple(
        R.CLUSTER_MAX_THREADS[r] for r in R.CLUSTER_ROWS)
    assert "(size_t)H * G * U * 2 + 2 * (size_t)rows * (H + 8) * 2" in text


@pytest.mark.parametrize("Hp,C", [(144, 2), (208, 2), (256, 4), (336, 8),
                                  (512, 16), (464, 16)])
def test_units_are_dealt_out_evenly(Hp, C):
    """CTA j owns warps [j W / C, (j + 1) W / C): the CTAs' units cover
    [0, Hp) once, each at most 8 ceil(W / C), one warp apart at most."""
    owned = [R._cluster_units(Hp, C, j) for j in range(C)]
    assert [u for r in owned for u in r] == list(range(Hp))
    sizes = {len(r) for r in owned}
    assert max(sizes) == 8 * R._cluster_warps(Hp, C)
    assert max(sizes) - min(sizes) <= 8


# ---------------------------------------------------------------------------
# The packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell,H,C", [("lstm", 144, 2), ("gru", 200, 2),
                                      ("lstm", 256, 4), ("gru", 336, 8),
                                      ("lstm", 512, 16)])
def test_packing_round_trips_per_cta(cell, H, C):
    """The packing's real places are a permutation of W_h's entries; CTA
    j's slice holds exactly the G gate columns of its units (every k), and
    its other places (padding, an idle warp) are zero."""
    G = GATES[cell]
    Hp = R._padded_width(H)
    w = torch.arange(1, H * G * H + 1, dtype=torch.float64).view(H, G * H)
    packed = R.pack_cluster(w, C, width=Hp)
    idx = R._cluster_fragment_index(H, G, Hp, C)
    assert packed.shape == idx.shape
    real = idx < H * G * H
    assert torch.equal(idx[real].sort().values, torch.arange(H * G * H))
    assert torch.equal(packed[~real], torch.zeros(int((~real).sum()),
                                                  dtype=w.dtype))
    back = torch.zeros(H * G * H + 1, dtype=w.dtype)
    back[idx] = packed
    assert torch.equal(back[:-1].view(H, G * H), w)
    per = idx.numel() // C
    for j, units in enumerate(R._cluster_units(Hp, C, j) for j in range(C)):
        sl = idx[j * per:(j + 1) * per]
        sl = sl[sl < H * G * H]
        cols = set((sl % (G * H)).tolist())
        want = {q * H + u for q in range(G) for u in units if u < H}
        assert cols == want
        assert len(sl) == H * len(want)


def _ldmatrix_a(tile, kk):
    """The m16n8k16 A fragment each lane gets from ``ldmatrix_x4`` at the
    source's addresses (row ``(l & 7) + ((l >> 3) & 1) 8``, column ``(l >>
    4) 8``): a0 (g, 2c..), a1 (g + 8, ..), a2 (g, 8 + ..), a3 (g + 8, 8 +
    ..), each two bf16 values → [32, 4, 2]."""
    lane = np.arange(32)
    g, c = lane // 4, lane % 4
    k = kk * 16 + 2 * c
    frag = np.empty((32, 4, 2), np.float64)
    for i, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for e in range(2):
            frag[:, i, e] = tile[g + dr, k + dk + e]
    return frag


def _mma(a, b):
    """mma.sync m16n8k16 from lane fragments: a [32, 4, 2], b [32, 4] (b0
    = B[2c + {0, 1}][g], b1 = B[8 + 2c + {0, 1}][g]) → the accumulator
    [32, 4]: d0, d1 (g, 2c + {0, 1}), d2, d3 (g + 8, ..)."""
    A = np.zeros((16, 16))
    Bm = np.zeros((16, 8))
    for lane in range(32):
        g, c = lane // 4, lane % 4
        for i, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            A[g + dr, 2 * c + dk:2 * c + dk + 2] = a[lane, i]
        Bm[2 * c:2 * c + 2, g] = b[lane, :2]
        Bm[8 + 2 * c:8 + 2 * c + 2, g] = b[lane, 2:]
    D = A @ Bm
    lane = np.arange(32)
    g, c = lane // 4, lane % 4
    return np.stack([D[g, 2 * c], D[g, 2 * c + 1], D[g + 8, 2 * c],
                     D[g + 8, 2 * c + 1]], axis=1)


@pytest.mark.parametrize("cell,H,C", [("lstm", 144, 2), ("gru", 200, 2),
                                      ("gru", 336, 8)])
def test_products_at_the_lane_addresses(cell, H, C):
    """Every warp of every CTA, modelled as the source runs it: its slice
    of the packing read at ``wh_s[(kk NW + warp) G 32 + q 32 + lane]``,
    the A fragments by ldmatrix from the h tile, one mma per (k-step,
    gate), the accumulator's (row, unit) places ``(g [+ 8], u0 + 2c [+
    1])`` of gate q. On integer-valued operands every sum is exact, so
    each CTA's gate sums must equal ``h @ W_h`` at its units' columns
    (padded to Hp, as the wrapper pads)."""
    G = GATES[cell]
    Hp = R._padded_width(H)
    rng = np.random.default_rng(H)
    w = rng.integers(-3, 4, (H, G * H)).astype(np.float64)
    h = np.zeros((16, Hp))
    h[:, :H] = rng.integers(-3, 4, (16, H))
    packed = R.pack_cluster(torch.from_numpy(w), C, width=Hp).numpy()
    NW, KT = R._cluster_warps(Hp, C), Hp // 16
    slices = packed.reshape(C, KT, NW, G, 32, 4)
    want = h[:, :H] @ w  # [16, G H]
    for j in range(C):
        units = R._cluster_units(Hp, C, j)
        for warp in range(NW):
            if warp * 8 >= len(units):
                assert not slices[j, :, warp].any()  # an idle warp
                continue
            u0 = units[warp * 8]
            for q in range(G):
                acc = np.zeros((32, 4))
                for kk in range(KT):
                    acc += _mma(_ldmatrix_a(h, kk), slices[j, kk, warp, q])
                lane = np.arange(32)
                g, c = lane // 4, lane % 4
                for i in range(4):
                    r = g + 8 * (i // 2)
                    u = u0 + 2 * c + (i % 2)
                    real = u < H
                    np.testing.assert_array_equal(
                        acc[real, i], want[r[real], q * H + u[real]])
                    assert not acc[~real, i].any()


# ---------------------------------------------------------------------------
# The chunking and the plain versions against the Pallas forwards
# ---------------------------------------------------------------------------


def test_row_state_bytes_counts_the_cluster_scratch():
    """The seed chunking counts the fused cluster forward's f32 xw scratch
    [W, G Hp] per row: bf16 fused at hidden 200 (Hp 208), not hoisted, not
    at hidden 128 or in float32."""
    W = 60

    def model(hidden, impl="fused", dtype=torch.bfloat16, cell="lstm"):
        return RNNModel(5, cell=cell, hidden=hidden, layers=1,
                        head_hidden=(), scan_impl=impl, dtype=dtype)

    assert model(200).row_state_bytes(W) == W * 200 * 2 + W * 4 * 208 * 4
    assert model(200, cell="gru").row_state_bytes(W) == (
        W * 200 * 2 + W * 3 * 208 * 4)
    assert model(200, "hoisted").row_state_bytes(W) == W * 200 * 2
    assert model(128).row_state_bytes(W) == W * 128 * 2
    assert model(200, dtype=torch.float32).row_state_bytes(W) == W * 200 * 4


@pytest.mark.parametrize("cell,H", [("lstm", 320), ("gru", 320),
                                    ("lstm", 512), ("gru", 512)])
def test_plain_rows_match_the_pallas_forwards_at_cluster_widths(cell, H):
    """Rows 3 and 1's plain versions in bf16 against the Pallas kernels
    (interpret mode) at B 4, T 3, an all-invalid row included."""
    B, T = 4, 3
    G = GATES[cell] * H
    rng = np.random.default_rng(H + len(cell))
    sd = H ** -0.5
    hin = rng.standard_normal((B, T, H)).astype(np.float32)
    wx = (sd * rng.standard_normal((H, G))).astype(np.float32)
    b = (0.1 * rng.standard_normal((G,))).astype(np.float32)
    wh = (sd * rng.standard_normal((H, G))).astype(np.float32)
    m = rng.random((B, T)) < 0.75
    m[1] = False
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in (hin, wx, b, wh)]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (hin, wx, b, wh)]
    tm = torch.from_numpy(m)
    want = np.asarray(jax_scan_fused(cell, *j, jnp.asarray(m)).astype(
        jnp.float32))
    got = R.rnn_scan_fused_reference(cell, *t, tm)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)
    assert not got[1].float().any()
    xw = (t[0].float() @ t[1].float() + t[2].float()).to(torch.bfloat16)
    want = np.asarray(jax_scan(cell, jnp.asarray(xw.float().numpy()).astype(
        jnp.bfloat16), j[3], jnp.asarray(m)).astype(jnp.float32))
    got = R.rnn_scan_states(cell, xw, t[3], tm, 1.0, False)[0]
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)
