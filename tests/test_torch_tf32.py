"""The float32 recurrence on the tensor cores (``csrc/rnn_bwd_tf32.cu``,
``csrc/rnn_fwd_tf32.cu`` and their shared ``csrc/tf32_common.cuh``): the
route, the numerics and the operand layouts, on the CPU.

``tests/test_torch_rnn_grad.py`` holds the plain version to ``jax.grad``
through the Pallas kernels in float32; ``tests/test_torch_kernels.py``
holds the kernels to the plain version on the card (the forward at atol
1e-5, the backward at scaled atol 1e-5). Here JAX is used only by the
seven-step model of the forward, against the Pallas forwards in interpret
mode.

* The route table of ``ops/rnn.py _mma_route`` for both directions.
* A numpy model of 3xTF32: hi as ``cvt.rna.tf32.f32`` rounds (10
  mantissa bits, ties away from zero), lo = x - hi truncated to TF32, as
  the kernels split an operand, and the three products a_lo b_hi + a_hi
  b_lo + a_hi b_hi accumulated in f32 per 8-step of k, as
  ``mma.sync.m16n8k8`` does. At c2-like magnitudes it holds the carry's
  product and the weight gradient to scaled 1e-6 of float64; one TF32 term
  does not hold 1e-5.
* A model of the m16n8k8 ``.tf32`` fragments (PTX ISA: a0 (g, c), a1 (g +
  8, c), a2 (g, c + 4), a3 (g + 8, c + 4); b0 (c, g), b1 (c + 4, g); the
  accumulator (g, 2c), (g, 2c + 1), (g + 8, ..)) run at the lane addresses
  of the CUDA source over shared-memory images laid out as the kernels lay
  them out: the recurrence's two products in each CTA of a 2-CTA cluster
  and the fixed-order reduce-scatter of the carry's product, the weight
  gradients' A^T D and the GEMM in both B layouts. Integer-valued
  operands make every sum exact, so each must equal the plain product;
  every 32-bit fragment load is free of bank conflicts.
* The forward's recurrence at its lane addresses in each CTA of a cluster
  (the product h_{t-1} @ W_h[:, own] from the h tile of the step's parity,
  and the all-gather of every rank's h_t into both CTAs' double-buffered
  tiles), and a numpy model of its arithmetic (3xTF32 GEMM for the fused
  form's xw, the recurrence's chains of ``kChainK``, the f32 cell) run
  for seven steps against the JAX ``rnn_scan_fused`` and ``rnn_scan``.
* The wrappers' cluster sizes against their shared-memory arithmetic and
  the sources' constants.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfm_quant_tpu.ops.pallas_rnn import rnn_scan as jax_scan
from lfm_quant_tpu.ops.pallas_rnn import rnn_scan_fused as jax_scan_fused
from lfm_quant_tpu_torch.ops import rnn as R

GATES = {"lstm": 4, "gru": 3}
CSRC = Path(__file__).resolve().parents[1] / "lfm_quant_tpu_torch" / "csrc"
SRC = CSRC / "rnn_bwd_tf32.cu"
FWD_SRC = CSRC / "rnn_fwd_tf32.cu"
H100_SMEM = 232_448  # shared memory a block can use on an H100


def source_constant(path, name):
    m = re.search(rf"constexpr int {name} = (\d+);", path.read_text())
    assert m, f"{name} not in {path.name}"
    return int(m.group(1))


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [8, 16, 120, 128, 144, 384, 400])
def test_route_table(direction, dtype, H):
    """(direction, dtype, H) → kernel: every H <= 128 runs on the tensor
    cores (a width off a multiple of 16, 8 and 120 here, zero-padded to
    the next: ``ops/rnn.py padded_launch``); there bf16 takes the bf16
    tensor cores both ways and float32 the 3xTF32 kernels both ways; H >
    128 the CUDA cores, but for bf16, which runs on the tensor cores with
    W_h split across a cluster both ways, and the float32 backward, which
    runs on the 3xTF32 kernels on a cluster up to 384."""
    tc = H <= 128
    if not tc:
        want = "cluster" if dtype == torch.bfloat16 else "simt"
        if (dtype == torch.float32 and direction == "bwd"
                and H <= R.TF32_MAX_WIDTH):
            want = "tf32"
    elif dtype == torch.bfloat16:
        want = "mma"
    else:
        want = "tf32"
    assert R._mma_route(dtype, H, direction) == want
    if direction == "fwd":
        assert R._mma_route(dtype, H) == want


def test_route_rejects_an_unknown_direction():
    with pytest.raises(ValueError, match="direction"):
        R._mma_route(torch.float32, 128, "up")


# ---------------------------------------------------------------------------
# 3xTF32 numerics
# ---------------------------------------------------------------------------


def tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, ties away from
    zero (half an ulp added to the magnitude, then truncated), in f32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_truncated(x):
    """x truncated to 10 mantissa bits (the low 13 bits cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split(x, round_lo=False):
    """The kernels' split (``split_tf32``): hi = tf32(x), lo = x - hi
    (exact in f32) truncated to TF32 (the backward) or rounded as hi is
    (``round_lo``, the forward)."""
    hi = tf32(x)
    lo = np.asarray(x, np.float32) - hi
    return hi, (tf32(lo) if round_lo else tf32_truncated(lo))


def mma_f32(a, b, terms=3, round_lo=False):
    """``a @ b`` as the kernels form it: per 8-step of k, the products of
    the split operands (``terms`` 3: a_lo b_hi, a_hi b_lo, a_hi b_hi in that
    order; 1: a_hi b_hi alone), each exact in f32 and added into an f32
    accumulator."""
    a_hi, a_lo = split(a, round_lo)
    b_hi, b_lo = split(b, round_lo)
    pairs = ([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if terms == 3
             else [(a_hi, b_hi)])
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in pairs:
            part = x[:, k0:k0 + 8].astype(np.float64) @ y[k0:k0 + 8]
            acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


def test_tf32_rounding_keeps_ten_bits_and_rounds_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    assert tf32(one + ulp) == one + ulp              # representable
    assert tf32(one + ulp / 2) == one + ulp          # tie: away from zero
    assert tf32(-(one + ulp / 2)) == -(one + ulp)
    assert tf32(one + ulp / 4) == one                # below the tie
    x = np.random.default_rng(0).standard_normal(10_000).astype(np.float32)
    hi, lo = split(x)
    assert (hi.view(np.uint32) & 0x1FFF == 0).all()
    assert (lo.view(np.uint32) & 0x1FFF == 0).all()
    rel1 = np.abs(hi.astype(np.float64) - x) / np.abs(x)
    rel2 = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)
    assert rel1.max() <= 2.0 ** -11 and rel2.max() <= 2.0 ** -21
    # The forward's split rounds lo too.
    hi_r, lo_r = split(x, round_lo=True)
    assert np.array_equal(hi_r, hi) and (lo_r != lo).any()
    rel3 = np.abs(hi_r.astype(np.float64) + lo_r - x) / np.abs(x)
    assert rel3.max() <= 2.0 ** -22 and rel3.mean() <= rel2.mean()


def _c2_operands(rng, rows=4096, H=128, G=4):
    """c2-like magnitudes: h in (-1, 1) (tanh of the cell), W_h ~ N(0,
    1/H), d_gates small and spread over decades (the upstream gradient
    times sigmoid and tanh derivatives)."""
    h = np.tanh(rng.standard_normal((rows, H))).astype(np.float32)
    w = (rng.standard_normal((H, G * H)) / np.sqrt(H)).astype(np.float32)
    d = (rng.standard_normal((rows, G * H))
         * np.exp(rng.uniform(-6, 0, (rows, G * H)))
         * 1e-2).astype(np.float32)
    return h, w, d


def _scaled(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def sliced_wgrad(h, d, terms=3):
    """h^T d as kernels 2 and 3 sum it: ``R._slices`` row slices, each
    accumulated by :func:`mma_f32`, then the slices added in order in
    f32."""
    rows = h.shape[0]
    n = R._slices(rows)
    per = -(-rows // n)
    out = np.zeros((h.shape[1], d.shape[1]), np.float32)
    for s in range(n):
        part = mma_f32(h[s * per:(s + 1) * per].T.copy(),
                       d[s * per:(s + 1) * per], terms)
        out = (out + part).astype(np.float32)
    return out


def test_3xtf32_holds_the_carry_product_and_the_weight_gradient():
    """d_hw @ W_h^T (K = G H) and h^T d_hw (K = rows, summed in row slices
    as the kernels sum it) at c2-like magnitudes: 3xTF32 within scaled
    1e-6 of float64; a dropped term — one TF32 product — over 1e-5, the
    JAX package's f32 bound."""
    h, w, d = _c2_operands(np.random.default_rng(1))
    carry = d[:256].astype(np.float64) @ w.T.astype(np.float64)
    assert _scaled(mma_f32(d[:256], w.T.copy()), carry) <= 1e-6
    assert _scaled(mma_f32(d[:256], w.T.copy(), terms=1), carry) > 1e-5
    wgrad = h.T.astype(np.float64) @ d.astype(np.float64)
    assert _scaled(sliced_wgrad(h, d), wgrad) <= 1e-6
    assert _scaled(sliced_wgrad(h, d, terms=1), wgrad) > 1e-5


# ---------------------------------------------------------------------------
# Fragments at the kernels' lane addresses
# ---------------------------------------------------------------------------


def mma_frag(a, b):
    """One ``mma.m16n8k8`` on per-lane fragments: ``a[lane]`` (a0..a3),
    ``b[lane]`` (b0, b1) → the per-lane accumulator (d0..d3), in float64."""
    A = np.zeros((16, 8))
    Bm = np.zeros((8, 8))
    for lane in range(32):
        g, c = lane // 4, lane % 4
        A[g, c], A[g + 8, c], A[g, c + 4], A[g + 8, c + 4] = a[lane]
        Bm[c, g], Bm[c + 4, g] = b[lane]
    D = A @ Bm
    return [(D[lane // 4, 2 * (lane % 4)], D[lane // 4, 2 * (lane % 4) + 1],
             D[lane // 4 + 8, 2 * (lane % 4)],
             D[lane // 4 + 8, 2 * (lane % 4) + 1]) for lane in range(32)]


def conflict_free(addrs):
    """32-bit loads of one warp: distinct words fall in distinct banks."""
    words = {a for a in addrs}
    return len({a % 32 for a in words}) == len(words)


def conflict_free_pairs(addrs):
    """64-bit loads (two words from ``addr``): each half-warp's 32 words
    fall in distinct banks."""
    for half in (addrs[:16], addrs[16:]):
        words = {a + e for a in half for e in (0, 1)}
        if len({w % 32 for w in words}) != len(words):
            return False
    return True


def _ints(rng, *shape):
    return rng.integers(-4, 5, shape).astype(np.float64)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("H,C", [(32, 2), (16, 1), (48, 1)])
def test_recurrence_products_and_reduce_scatter(cell, H, C):
    """Kernel 1 at its lane addresses, in each CTA j of a cluster of C: the
    recompute ``h_{t-1} @ W_h[:, own]`` (lane c taking k0 + 2c, k0 + 2c + 1,
    h read as float2) and the carry's partial ``d_hw[:, own] @ W_h[:,
    own]^T`` for every rank's units, then the peer's units stored into the
    peer's receive buffer and added rank 0 first. Equal to the plain
    products; conflict-free loads."""
    G = GATES[cell]
    rng = np.random.default_rng(H + C + G)
    BB, RT = 32, 2
    Hc, GHc = H // C, G * H // C
    LW, LD, LG, LR = GHc + 4, H + 8, GHc + 4, Hc + 8
    W = _ints(rng, H, G * H)
    h = _ints(rng, BB, H)
    dhw = _ints(rng, BB, G * H)
    own = [np.concatenate([np.arange(q * H + j * Hc, q * H + (j + 1) * Hc)
                           for q in range(G)]) for j in range(C)]
    h_s = np.full(BB * LD, np.nan)
    for r in range(BB):
        h_s[r * LD:r * LD + H] = h[r]
    partials = []  # [j][rr] → [BB, Hc] of rank rr's units
    for j in range(C):
        wh_s = np.full(H * LW, np.nan)
        dg_s = np.full(BB * LG, np.nan)
        for k in range(H):
            wh_s[k * LW:k * LW + GHc] = W[k, own[j]]
        for r in range(BB):
            dg_s[r * LG:r * LG + GHc] = dhw[r, own[j]]
        gates = np.zeros((BB, GHc))
        part = np.zeros((C, BB, Hc))
        for warp in range(Hc // 8):
            for rt in range(RT):
                for q in range(G):
                    acc = [np.zeros(4) for _ in range(32)]
                    for k0 in range(0, H, 8):
                        b = [(wh_s[(k0 + 2 * (l % 4)) * LW + warp * 8
                                   + l // 4 + q * Hc],
                              wh_s[(k0 + 2 * (l % 4)) * LW + warp * 8
                                   + l // 4 + q * Hc + LW]) for l in range(32)]
                        hp = [(rt * 16 + l // 4) * LD + k0 + 2 * (l % 4)
                              for l in range(32)]
                        assert conflict_free_pairs(hp)
                        assert conflict_free(
                            [(k0 + 2 * (l % 4)) * LW + warp * 8 + l // 4
                             + q * Hc for l in range(32)])
                        a = [(h_s[p], h_s[p + 8 * LD], h_s[p + 1],
                              h_s[p + 8 * LD + 1]) for p in hp]
                        for lane, d in enumerate(mma_frag(a, b)):
                            acc[lane] += d
                    for lane in range(32):
                        g, c = lane // 4, lane % 4
                        for i in range(4):
                            r = rt * 16 + g + 8 * (i >> 1)
                            gates[r, q * Hc + warp * 8 + 2 * c + (i & 1)] = \
                                acc[lane][i]
                for rr in range(C):
                    acc = [np.zeros(4) for _ in range(32)]
                    for j0 in range(0, GHc, 8):
                        bp = [(rr * Hc + warp * 8 + l // 4) * LW + j0 + l % 4
                              for l in range(32)]
                        ap = [(rt * 16 + l // 4) * LG + j0 + l % 4
                              for l in range(32)]
                        assert conflict_free(bp) and conflict_free(ap)
                        b = [(wh_s[p], wh_s[p + 4]) for p in bp]
                        a = [(dg_s[p], dg_s[p + 8 * LG], dg_s[p + 4],
                              dg_s[p + 8 * LG + 4]) for p in ap]
                        for lane, d in enumerate(mma_frag(a, b)):
                            acc[lane] += d
                    for lane in range(32):
                        g, c = lane // 4, lane % 4
                        for i in range(4):
                            r = rt * 16 + g + 8 * (i >> 1)
                            part[rr, r, warp * 8 + 2 * c + (i & 1)] = \
                                acc[lane][i]
        np.testing.assert_array_equal(gates, h @ W[:, own[j]])
        partials.append(part)
    # The reduce-scatter: CTA j stores its partial of the peer's units into
    # the peer's receive buffer [BB, Hc + 8] and adds rank 0's first.
    dh = np.zeros((BB, H))
    for j in range(C):
        mine = partials[j][j]
        if C == 1:
            dh[:, :Hc] = mine
            continue
        peer = j ^ 1
        recv = np.full(BB * LR, np.nan)
        for r in range(BB):
            for u in range(Hc):
                recv[r * LR + u] = partials[peer][j][r, u]
        got = np.array([[recv[r * LR + u] for u in range(Hc)]
                        for r in range(BB)])
        dh[:, j * Hc:(j + 1) * Hc] = mine + got if j == 0 else got + mine
    np.testing.assert_array_equal(dh, dhw @ W.T)


@pytest.mark.parametrize("H", [16, 48, 128])
def test_weight_gradient_fragments(H):
    """Kernel 2: a stage's rows stored as they come (A [32, H + 8], D [32,
    64 + 8]) give A^T D through the A^T fragment (a0 at A[kk + c][16 w +
    g]) and the D fragment (b0 at D[kk + c][8 nt + g]); warp w owns output
    rows 16 w .. 16 w + 15, and warps past H idle."""
    rng = np.random.default_rng(H)
    LA, LDD = H + 8, 72
    A = _ints(rng, 32, H)
    D = _ints(rng, 32, 64)
    amem = np.full(32 * LA, np.nan)
    dmem = np.full(32 * LDD, np.nan)
    for r in range(32):
        amem[r * LA:r * LA + H] = A[r]
        dmem[r * LDD:r * LDD + 64] = D[r]
    out = np.full((H, 64), np.nan)
    for warp in range(8):
        ko = warp * 16
        if ko >= H:
            continue
        for nt in range(8):
            acc = [np.zeros(4) for _ in range(32)]
            for kk in range(0, 32, 8):
                ap = [(kk + l % 4) * LA + ko + l // 4 for l in range(32)]
                dp = [(kk + l % 4) * LDD + nt * 8 + l // 4 for l in range(32)]
                assert conflict_free(ap) and conflict_free(dp)
                a = [(amem[p], amem[p + 8], amem[p + 4 * LA],
                      amem[p + 4 * LA + 8]) for p in ap]
                b = [(dmem[p], dmem[p + 4 * LDD]) for p in dp]
                for lane, d in enumerate(mma_frag(a, b)):
                    acc[lane] += d
            for lane in range(32):
                g, c = lane // 4, lane % 4
                for i in range(4):
                    out[ko + g + 8 * (i >> 1), nt * 8 + 2 * c + (i & 1)] = \
                        acc[lane][i]
    np.testing.assert_array_equal(out, A.T @ D)


@pytest.mark.parametrize("trans_b", [False, True])
def test_gemm_fragments(trans_b):
    """The GEMM's stage (A [128, 32 + 4]; B [32, 64 + 8] row-major, or
    transposed [64, 32 + 4]) at its lane addresses gives A @ B, 8 warps of
    32 x 32: xw = hin @ W_x and dhin = d_xw @ W_x^T."""
    rng = np.random.default_rng(int(trans_b))
    LA = 36
    LB = 36 if trans_b else 72
    A = _ints(rng, 128, 32)
    Bm = _ints(rng, 32, 64)
    amem = np.full(128 * LA, np.nan)
    for r in range(128):
        amem[r * LA:r * LA + 32] = A[r]
    if trans_b:
        bmem = np.full(64 * LB, np.nan)
        for n in range(64):
            bmem[n * LB:n * LB + 32] = Bm[:, n]
    else:
        bmem = np.full(32 * LB, np.nan)
        for k in range(32):
            bmem[k * LB:k * LB + 64] = Bm[k]
    out = np.full((128, 64), np.nan)
    for warp in range(8):
        wm, wn = (warp & 3) * 32, (warp >> 2) * 32
        for mt in range(2):
            for nt in range(4):
                acc = [np.zeros(4) for _ in range(32)]
                for kk in range(0, 32, 8):
                    ap = [(wm + mt * 16 + l // 4) * LA + kk + l % 4
                          for l in range(32)]
                    if trans_b:
                        bp = [(wn + nt * 8 + l // 4) * LB + kk + l % 4
                              for l in range(32)]
                        b = [(bmem[p], bmem[p + 4]) for p in bp]
                    else:
                        bp = [(kk + l % 4) * LB + wn + nt * 8 + l // 4
                              for l in range(32)]
                        b = [(bmem[p], bmem[p + 4 * LB]) for p in bp]
                    assert conflict_free(ap) and conflict_free(bp)
                    a = [(amem[p], amem[p + 8 * LA], amem[p + 4],
                          amem[p + 8 * LA + 4]) for p in ap]
                    for lane, d in enumerate(mma_frag(a, b)):
                        acc[lane] += d
                for lane in range(32):
                    g, c = lane // 4, lane % 4
                    for i in range(4):
                        out[wm + mt * 16 + g + 8 * (i >> 1),
                            wn + nt * 8 + 2 * c + (i & 1)] = acc[lane][i]
    np.testing.assert_array_equal(out, A @ Bm)


# ---------------------------------------------------------------------------
# The forward (csrc/rnn_fwd_tf32.cu)
# ---------------------------------------------------------------------------


def _fwd_products(tile, wh_s, H, C, G, LW, LD):
    """Kernel 1's product at its lane addresses in one CTA: ``h @ W_h[:,
    own]`` from the h tile ``tile`` (lane c taking k0 + 2c and k0 + 2c + 1,
    h read as float2) → the gate sums [32, G H/C], every fragment load
    checked free of bank conflicts."""
    Hc = H // C
    gates = np.zeros((32, G * Hc))
    for warp in range(Hc // 8):
        for rt in range(2):
            for q in range(G):
                acc = [np.zeros(4) for _ in range(32)]
                for k0 in range(0, H, 8):
                    wp = [(k0 + 2 * (l % 4)) * LW + warp * 8 + l // 4
                          + q * Hc for l in range(32)]
                    hp = [(rt * 16 + l // 4) * LD + k0 + 2 * (l % 4)
                          for l in range(32)]
                    assert conflict_free(wp) and conflict_free_pairs(hp)
                    b = [(wh_s[p], wh_s[p + LW]) for p in wp]
                    a = [(tile[p], tile[p + 8 * LD], tile[p + 1],
                          tile[p + 8 * LD + 1]) for p in hp]
                    for lane, d in enumerate(mma_frag(a, b)):
                        acc[lane] += d
                for lane in range(32):
                    g, c = lane // 4, lane % 4
                    for i in range(4):
                        gates[rt * 16 + g + 8 * (i >> 1),
                              q * Hc + warp * 8 + 2 * c + (i & 1)] = \
                            acc[lane][i]
    return gates


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("H,C", [(32, 2), (16, 2), (48, 2)])
def test_forward_products_and_all_gather(cell, H, C):
    """Kernel 1 of the forward at its lane addresses, in each CTA j of its
    cluster of C = 2 (``kCluster``; at H 16 one warp a CTA), for two
    steps: the product ``h_{t-1} @ W_h[:, own]`` read from the tile of the
    step's parity, then the all-gather — each thread
    stores its float2 of h_t (rows rt 16 + g + 8 half, units j H/C + 8 w +
    2c) into the peer's tile of the other parity first, then its own. Both
    CTAs' tiles then hold h_t of every unit, and the next step's product
    reads it; equal to the plain products; conflict-free loads and
    stores."""
    G = GATES[cell]
    assert C == source_constant(FWD_SRC, "kCluster")
    rng = np.random.default_rng(10 * H + C + G)
    BB = 32
    Hc, GHc = H // C, G * H // C
    LW, LD = GHc + 4, H + 8
    W = _ints(rng, H, G * H)
    h = [_ints(rng, BB, H) for _ in range(2)]  # h_{-1} (given), h_0
    own = [np.concatenate([np.arange(q * H + j * Hc, q * H + (j + 1) * Hc)
                           for q in range(G)]) for j in range(C)]
    wh_s = []
    for j in range(C):
        img = np.full(H * LW, np.nan)
        for k in range(H):
            img[k * LW:k * LW + GHc] = W[k, own[j]]
        wh_s.append(img)
    tiles = [np.full((2, BB * LD), np.nan) for _ in range(C)]
    for j in range(C):
        for r in range(BB):
            tiles[j][0, r * LD:r * LD + H] = h[0][r]
    for t in range(2):
        cur = t & 1
        for j in range(C):
            got = _fwd_products(tiles[j][cur], wh_s[j], H, C, G, LW, LD)
            np.testing.assert_array_equal(got, h[t] @ W[:, own[j]])
        if t == 1:
            break
        # The all-gather of h_0 into the tiles of parity cur ^ 1: the
        # peer's stores first, then each CTA's own.
        for targets in (lambda j: j ^ 1, lambda j: j):
            for j in range(C):
                for warp in range(Hc // 8):
                    for rt in range(2):
                        for half in range(2):
                            addr = [(rt * 16 + l // 4 + 8 * half) * LD
                                    + j * Hc + warp * 8 + 2 * (l % 4)
                                    for l in range(32)]
                            assert conflict_free_pairs(addr)
                            for l, p in enumerate(addr):
                                r = rt * 16 + l // 4 + 8 * half
                                u = j * Hc + warp * 8 + 2 * (l % 4)
                                tiles[targets(j)][cur ^ 1, p:p + 2] = \
                                    h[1][r, u:u + 2]
        for j in range(C):
            for r in range(BB):
                np.testing.assert_array_equal(
                    tiles[j][1, r * LD:r * LD + H], h[1][r])


def sigmoid32(v):
    one = np.float32(1.0)
    return (one / (one + np.exp(-v))).astype(np.float32)


def forward_rounds_lo():
    m = re.search(r"constexpr bool kRoundLo = (true|false);",
                  FWD_SRC.read_text())
    assert m, "kRoundLo not in rnn_fwd_tf32.cu"
    return m.group(1) == "true"


def gemm_model(a, w, b):
    """Kernel 0, the GEMM ``a @ w + b`` on the CUDA cores: an f32 FMA sum
    over k in order from zero (each product exact in float64, each sum
    rounded to f32), then the bias."""
    assert "fmaf(a[i], w[j], acc[i][j])" in FWD_SRC.read_text()
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k in range(a.shape[1]):
        acc = (acc + np.outer(a[:, k].astype(np.float64),
                              w[k].astype(np.float64))).astype(np.float32)
    return (acc + b).astype(np.float32)


def forward_model(cell, xw, wh, m, forget_bias=1.0):
    """Kernel 1's arithmetic: h_{t-1} @ W_h summed from zero, each chain of
    ``kRecurChainK`` of k (3xTF32 from zero, the forward's split) added in
    f32, then xw_t added (the GRU's candidate x side apart); the cell in
    f32, each operation rounded; h and c held on a masked step → h_all [B,
    T, H]."""
    assert re.search(r"constexpr bool kXwLast = true;", FWD_SRC.read_text())
    chain = source_constant(FWD_SRC, "kRecurChainK")
    B, T, _ = xw.shape
    H = wh.shape[0]
    fb = np.float32(forget_bias)
    h = np.zeros((B, H), np.float32)
    c = np.zeros((B, H), np.float32)
    hs = []
    for t in range(T):
        acc = np.zeros((B, wh.shape[1]), np.float32)
        for kc in range(0, H, chain):
            acc = (acc + mma_f32(h[:, kc:kc + chain], wh[kc:kc + chain],
                                 round_lo=forward_rounds_lo())).astype(
                np.float32)
        x = xw[:, t].astype(np.float32)
        xn = x[:, 2 * H:]
        if cell == "gru":
            acc[:, :2 * H] += x[:, :2 * H]
        else:
            acc += x
        keep = m[:, t, None] != 0
        if cell == "lstm":
            i, f = sigmoid32(acc[:, :H]), sigmoid32(acc[:, H:2 * H] + fb)
            g = np.tanh(acc[:, 2 * H:3 * H])
            o = sigmoid32(acc[:, 3 * H:])
            c_new = f * c + i * g
            h_new = o * np.tanh(c_new)
            c = np.where(keep, c_new, c)
        else:
            z, r = sigmoid32(acc[:, :H]), sigmoid32(acc[:, H:2 * H])
            n = np.tanh(xn + r * acc[:, 2 * H:])
            h_new = (np.float32(1.0) - z) * n + z * h
        h = np.where(keep, h_new, h).astype(np.float32)
        hs.append(h)
    return np.stack(hs, axis=1)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_forward_model_matches_jax_over_seven_steps(cell, fused):
    """The forward's arithmetic (the GEMM for the fused form's xw, the
    recurrence's chains, the f32 cell), at H 80 (chains of k, the last one
    short), seven steps, an all-invalid row: within the JAX f32 bound
    (atol 1e-5) of the Pallas forwards in interpret mode."""
    B, T, H = 9, 7, 80
    G = GATES[cell] * H
    rng = np.random.default_rng(7 + int(fused))
    hin = rng.standard_normal((B, T, H)).astype(np.float32)
    wx = (0.3 * rng.standard_normal((H, G))).astype(np.float32)
    b = (0.1 * rng.standard_normal((G,))).astype(np.float32)
    wh = (0.3 * rng.standard_normal((H, G))).astype(np.float32)
    m = rng.random((B, T)) < 0.75
    m[3] = False
    if fused:
        xw = gemm_model(hin.reshape(B * T, H), wx, b).reshape(B, T, G)
        want = jax_scan_fused(cell, *(jnp.asarray(a) for a in (hin, wx, b,
                                                               wh, m)))
    else:
        xw = (hin @ wx + b).astype(np.float32)
        want = jax_scan(cell, jnp.asarray(xw), jnp.asarray(wh),
                        jnp.asarray(m))
    got = forward_model(cell, xw, wh, m)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0.0)
    assert not got[3].any()


# ---------------------------------------------------------------------------
# Cluster size and shared memory
# ---------------------------------------------------------------------------


def test_rows_per_cta_match_the_source():
    assert 16 * source_constant(SRC, "kRowTiles") == R.TF32_ROWS


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("H", list(range(16, 129, 16)))
def test_cluster_size_follows_the_shared_memory_arithmetic(cell, H):
    """The wrapper takes the fewest CTAs per cluster whose W_h share, the
    two h tiles, the d_hw tile and the receive buffers fit an H100 block:
    one where all of W_h fits, two at H = 128 in both cells."""
    G = GATES[cell]
    rows = R.TF32_ROWS

    def smem(C):
        Hc = H // C
        return 4 * (H * (G * Hc + 4) + 2 * rows * (H + 8)
                    + rows * (G * Hc + 4) + (2 * rows * (Hc + 8) if C > 1
                                             else 0))

    C = R._tf32_cluster(cell, H, H100_SMEM)
    assert R._tf32_smem(cell, H, C) == smem(C) <= H100_SMEM
    assert C == (1 if smem(1) <= H100_SMEM else 2)
    if H == 128:
        assert C == 2
    if H <= 96:
        assert C == 1


def test_cluster_size_at_c2_and_a_short_card():
    assert R._tf32_smem("lstm", 128, 2) == 219_648
    assert R._tf32_smem("gru", 128, 2) == 178_688
    with pytest.raises(ValueError, match="shared memory"):
        R._tf32_cluster("lstm", 128, 200_000)


def test_forward_constants_match_the_sources():
    """The forward's rows per CTA and units per warp are the backward's
    (``TF32_ROWS``); its recurrence's chains are no longer than the
    backward's (64 of k); its GEMM's stage divides every width it takes
    (H % 16 == 0); both sources take the shared code from the header, the
    3xTF32 GEMM only the backward."""
    assert 16 * source_constant(FWD_SRC, "kRowTiles") == R.TF32_ROWS
    assert source_constant(FWD_SRC, "kUnits") == 8
    header = CSRC / "tf32_common.cuh"
    recur = source_constant(FWD_SRC, "kRecurChainK")
    assert recur % 8 == 0 and recur <= source_constant(header, "kChainK")
    assert 16 % source_constant(FWD_SRC, "kSgK") == 0
    for src in (SRC, FWD_SRC):
        text = src.read_text()
        assert '#include "tf32_common.cuh"' in text
        assert "constexpr int kChainK" not in text
        assert "tf32_gemm_kernel" not in text
    assert "launch_gemm" in SRC.read_text()
    assert "launch_gemm" not in FWD_SRC.read_text()


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("H", list(range(16, 129, 16)))
def test_forward_cluster_size_follows_the_shared_memory_arithmetic(cell, H):
    """The forward runs a cluster of two CTAs at every width (the source's
    ``kCluster``), their W_h shares and two h tiles each within an H100
    block, at most 256 threads (the source's launch bound ``kMaxThreads``),
    and less shared memory than the backward's at the same cluster
    size."""
    G = GATES[cell]
    rows = R.TF32_ROWS

    def smem(C):
        return 4 * (H * (G * H // C + 4) + 2 * rows * (H + 8))

    C = R._tf32_cluster(cell, H, H100_SMEM, "fwd")
    assert C == 2 == source_constant(FWD_SRC, "kCluster")
    assert R.TF32_CLUSTERS["fwd"] == (C,)
    assert R._tf32_smem(cell, H, C, "fwd") == smem(C) <= H100_SMEM
    assert H // C * 4 <= 128 // C * 4 == 256
    assert R._tf32_smem(cell, H, C, "fwd") < R._tf32_smem(cell, H, C)


def test_forward_cluster_size_at_c2_and_a_short_card():
    assert R._tf32_smem("lstm", 128, 2, "fwd") == 167_936
    assert R._tf32_smem("gru", 128, 2, "fwd") == 135_168
    assert R._tf32_smem("gru", 128, 1, "fwd") == 233_472  # just over
    with pytest.raises(ValueError, match="forward"):
        R._tf32_cluster("lstm", 128, 150_000, "fwd")
