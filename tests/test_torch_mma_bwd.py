"""The tensor-core backward (``csrc/rnn_fused_bwd_mma.cu``, fused and
hoisted modes): its route, its operand layouts and numerics, and — on the
card — the kernels against their plain versions.

This file imports nothing of JAX (``tests/test_torch_rnn_grad.py`` holds
the plain version to the Pallas kernels at these widths). On the card::

    python -m pytest --noconftest -m cuda tests/test_torch_mma_bwd.py -q

The CPU tests hold the index arithmetic the kernels rely on to the PTX
ISA's m16n8k16 ``.row.col`` fragment layouts: the packing of W_x^T built
in Python, and the ldmatrix addresses of the CUDA source (mirrored here
as the lane formulas of ``rnn_fused_bwd_mma.cu``) run through a model of
``ldmatrix`` and ``ldmatrix.trans``. The kernels themselves are held to
``rnn_scan_fused_bwd_reference`` in bf16 with gradients scaled by their
largest magnitude: dhin (the hoisted mode's dxw) at atol 0.05 (the JAX
package's bf16 bound), the f32 weight gradients at 1e-4, which d_gates
rounded once to bf16 fails.
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
    (torch.bfloat16, 48, "mma"),
    (torch.bfloat16, 128, "mma"),
    (torch.float32, 128, "tf32"),
    (torch.float32, 16, "tf32"),
    (torch.bfloat16, 40, "mma"),
    (torch.bfloat16, 144, "cluster"),
    (torch.bfloat16, 528, "grid"),
    (torch.bfloat16, 1536, "simt"),
    (torch.float32, 144, "tf32"),
    (torch.float32, 176, "tf32"),
    (torch.float32, 384, "grid"),
    (torch.float32, 400, "grid"),
    (torch.bfloat16, 8, "mma"),
])
def test_bwd_route_is_decided_by_dtype_and_width(dtype, H, route):
    """In bf16 the backward takes the forward's rule (it reuses the
    forward's packing of W_x); in float32 at the same widths it runs on
    the 3xTF32 kernels (``csrc/rnn_bwd_tf32.cu``); a width off a multiple
    of 16 (40, 8) is padded to the next. Above 128 bf16 runs on the
    cluster backward (``csrc/rnn_bwd_cluster.cu``) up to 512 and on the
    bf16 grid (``csrc/rnn_bwd_grid.cu``) past it, float32 on the 3xTF32 one
    on a cluster up to 176 and on the grid (``csrc/rnn_bwd_tf32_grid.cu``)
    past it; float32 past 1024 and bf16 past 1520 stay on the CUDA
    cores."""
    assert R._mma_route(dtype, H, "bwd") == route


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("dtype,H,route", [
    (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 48, "mma"),
    (torch.bfloat16, 128, "mma"),
    (torch.bfloat16, 12, "mma"),
    (torch.bfloat16, 136, "cluster"),
    (torch.bfloat16, 520, "grid"),
    (torch.bfloat16, 1530, "simt"),
    (torch.float32, 136, "tf32"),
    (torch.float32, 400, "grid"),
    (torch.float32, 128, "tf32"),
    (torch.float32, 16, "tf32"),
    (torch.float32, 120, "tf32"),
])
def test_hoisted_bwd_route_is_decided_by_dtype_and_width(monkeypatch, cell,
                                                        dtype, H, route):
    """``rnn_scan_bwd`` on the card picks its kernels by ``_mma_route``
    alone, before any launch: the hoisted mode of the bf16 tensor-core
    source, the 3xTF32 kernels in float32 (on a cluster above 128, up to
    176; on the grid past it), the cluster backward in bf16 above 128 (on
    the bf16 grid past 512), or the CUDA-core hoisted kernel
    (shape-only tensors on the meta device stand for the card's; the
    launchers are recorded, not run, and the tensor-core ones hand back
    their padded xw and W_h as dxw and dW_h, which the padding slices
    back to H)."""
    calls = []
    G = GATES[cell] * H
    monkeypatch.setattr(R, "_check_card", lambda *a, **k: None)
    monkeypatch.setattr(R, "_launch_scan_bwd_mma",
                        lambda c, xw, wh, *a: calls.append("mma") or (xw, wh))
    monkeypatch.setattr(R, "_launch_bwd_tf32", lambda c, fused, xw, wx, b,
                        wh, *a: calls.append("tf32" if not fused else
                                             "fused") or (xw, wh))
    monkeypatch.setattr(R, "_launch_bwd_cluster", lambda c, fused, xw, wx,
                        b, wh, *a: calls.append("cluster" if not fused else
                                                "fused") or (xw, wh))
    monkeypatch.setattr(R, "_launch_bwd_grid", lambda c, fused, xw, wx, b,
                        wh, *a: calls.append("grid" if not fused else
                                             "fused") or (xw, wh))
    monkeypatch.setattr(R, "_launch_bwd", lambda c, fused, *a:
                        calls.append("simt" if not fused else "fused"))
    B, T = 5, 3
    xw = torch.empty(B, T, G, dtype=dtype, device="meta")
    wh = torch.empty(H, G, dtype=dtype, device="meta")
    m = torch.empty(B, T, dtype=torch.bool, device="meta")
    h = torch.empty(B, T, H, dtype=dtype, device="meta")
    c = h if cell == "lstm" else None
    out = R.rnn_scan_bwd(cell, xw, wh, m, h, c, h)
    assert calls == [route]
    if route != "simt":
        assert out[0].shape == xw.shape and out[1].shape == wh.shape


# ---------------------------------------------------------------------------
# Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16, and ldmatrix)
# ---------------------------------------------------------------------------


def _a_fragment(A):
    """Lane l's four registers of the 16 x 16 A operand, each a pair of
    (row, column) elements: a0 (g, 2c), a1 (g + 8, 2c), a2 (g, 2c + 8),
    a3 (g + 8, 2c + 8), with g = l // 4, c = l % 4."""
    out = []
    for lane in range(32):
        g, c = lane // 4, lane % 4
        out.append([(A[g + 8 * (i & 1)][2 * c + 8 * (i >> 1)],
                     A[g + 8 * (i & 1)][2 * c + 1 + 8 * (i >> 1)])
                    for i in range(4)])
    return out


def _b_fragment(Bm):
    """Lane l's two registers of the 16 x 8 B operand (.col): b0 =
    B[2c, 2c + 1][g], b1 = B[2c + 8, 2c + 9][g]."""
    out = []
    for lane in range(32):
        g, c = lane // 4, lane % 4
        out.append([(Bm[2 * c][g], Bm[2 * c + 1][g]),
                    (Bm[2 * c + 8][g], Bm[2 * c + 9][g])])
    return out


def _ldmatrix(mem, addr, n, trans):
    """``ldmatrix.m8n8.x{n}[.trans].b16``: lane 8i + r gives the address
    (an element index into ``mem``) of row r of matrix i, a row being 8
    consecutive elements. Lane l receives, of each matrix, elements
    (l // 4, 2 (l % 4) + e), or with ``.trans`` (2 (l % 4) + e, l // 4)."""
    regs = [[None] * n for _ in range(32)]
    for i in range(n):
        rows = [mem[addr(8 * i + r):addr(8 * i + r) + 8] for r in range(8)]
        for lane in range(32):
            g, c = lane // 4, lane % 4
            regs[lane][i] = ((rows[2 * c][g], rows[2 * c + 1][g]) if trans
                             else (rows[g][2 * c], rows[g][2 * c + 1]))
    return regs


def _bank_groups_distinct(addr, n, itemsize=2):
    """Each matrix's 8 row addresses fall in distinct 16-byte bank groups
    of a 128-byte line: ldmatrix reads them without bank conflicts."""
    for i in range(n):
        groups = {(addr(8 * i + r) * itemsize // 16) % 8 for r in range(8)}
        if len(groups) != 8:
            return False
    return True


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("H", [16, 48, 128])
def test_resident_wh_serves_both_products(cell, H):
    """Kernel 1 keeps W_h once, row-major [H, G H + 8] in shared memory.
    ldmatrix.trans at its lane addresses gives the B fragments of
    ``h @ W_h`` (K = H, N = G H; a warp's tiles q at columns q H + 8 w),
    plain ldmatrix the B fragments of ``d @ W_h^T`` (K = G H, N = H; the
    warp's units 8 w ..), each free of bank conflicts."""
    G = GATES[cell]
    GH = G * H
    LW = GH + 8
    W = np.arange(H * GH).reshape(H, GH)  # distinct ids stand for values
    mem = np.full(H * LW, -1)
    for k in range(H):
        mem[k * LW:k * LW + GH] = W[k]
    for warp in range(H // 8):
        u0 = 8 * warp
        for kk in range(H // 16):
            # rnn_fused_bwd_mma.cu: whf_l + kk * 16 * LW, then
            # + (q + (lane >> 4)) * H for a pair of tiles (x4.trans) or
            # + 2 * H for the GRU's third tile (x2.trans).
            def fwd_addr(lane, q):
                row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8
                return row * LW + (q + (lane >> 4)) * H + u0
            for q in range(0, G - 1, 2):
                regs = _ldmatrix(mem, lambda l: fwd_addr(l, q), 4, True)
                assert _bank_groups_distinct(lambda l: fwd_addr(l, q), 4)
                for t in (q, q + 1):
                    want = _b_fragment(
                        W[kk * 16:kk * 16 + 16, t * H + u0:t * H + u0 + 8])
                    got = [r[2 * (t - q):2 * (t - q) + 2] for r in regs]
                    assert got == want
            if G == 3:
                addr = (lambda l: (kk * 16 + (l & 7) + ((l >> 3) & 1) * 8)
                        * LW + 2 * H + u0)
                regs = _ldmatrix(mem, addr, 2, True)
                assert regs == _b_fragment(
                    W[kk * 16:kk * 16 + 16, 2 * H + u0:2 * H + u0 + 8])
        for ks in range(GH // 16):
            # whb_l + k0: rows u0 + (lane & 7), k-offset ((lane >> 3) & 1) 8.
            def bwd_addr(lane):
                return ((u0 + (lane & 7)) * LW + ((lane >> 3) & 1) * 8
                        + ks * 16)
            regs = _ldmatrix(mem, bwd_addr, 2, False)
            assert _bank_groups_distinct(bwd_addr, 2)
            WT = W.T  # B[k][n] = W_h[u0 + n][k]
            assert regs == _b_fragment(WT[ks * 16:ks * 16 + 16, u0:u0 + 8])


@pytest.mark.parametrize("H", [16, 48, 128])
def test_dgates_tiles_give_a_fragments(H):
    """Kernel 1's d_gates tiles [rows, 4 H + 8]: plain ldmatrix at the
    forward's A addresses gives the A fragment of each k-step; the GRU's
    h side reads its n slice (dn r) H columns further on."""
    LG = 4 * H + 8
    D = np.arange(16 * 4 * H).reshape(16, 4 * H)
    mem = np.full(16 * LG, -1)
    for r in range(16):
        mem[r * LG:r * LG + 4 * H] = D[r]
    for ks in range(4 * H // 16):
        def addr(lane):
            arow = (lane & 7) + ((lane >> 3) & 1) * 8
            return arow * LG + (lane >> 4) * 8 + ks * 16
        regs = _ldmatrix(mem, addr, 4, False)
        assert _bank_groups_distinct(addr, 4)
        assert regs == _a_fragment(D[:, ks * 16:ks * 16 + 16])


@pytest.mark.parametrize("H", [16, 48, 128])
def test_weight_gradient_operands_by_ldmatrix_trans(H):
    """Kernel 2 stores a stage's rows as they come (A [32, HP + 8], D
    [32, 64 + 8]) and computes A^T D: ldmatrix.trans at its lane addresses
    gives the A fragment of A^T (output rows ko + 16 mt .., stage rows) and
    the B fragments of D for two n8 column tiles per load."""
    HP = (H + 31) // 32 * 32
    LA, LDD = HP + 8, 72
    A = np.arange(32 * HP).reshape(32, HP)
    D = 10 ** 6 + np.arange(32 * 64).reshape(32, 64)
    amem = np.full(32 * LA, -1)
    dmem = np.full(32 * LDD, -1)
    for r in range(32):
        amem[r * LA:r * LA + HP] = A[r]
        dmem[r * LDD:r * LDD + 64] = D[r]
    for ko in range(0, H, 32):
        for kk in range(2):
            for mt in range(2):
                def a_addr(lane):
                    row = (lane & 7) + (lane >> 4) * 8
                    col = ((lane >> 3) & 1) * 8
                    return (kk * 16 + row) * LA + ko + mt * 16 + col
                regs = _ldmatrix(amem, a_addr, 4, True)
                assert _bank_groups_distinct(a_addr, 4)
                c0 = ko + mt * 16
                assert regs == _a_fragment(A[kk * 16:kk * 16 + 16,
                                             c0:c0 + 16].T)
            for n2 in range(4):
                def d_addr(lane):
                    row = (lane & 7) + ((lane >> 3) & 1) * 8
                    return (kk * 16 + row) * LDD + n2 * 16 + (lane >> 4) * 8
                regs = _ldmatrix(dmem, d_addr, 4, True)
                assert _bank_groups_distinct(d_addr, 4)
                for t in range(2):
                    c0 = n2 * 16 + 8 * t
                    want = _b_fragment(D[kk * 16:kk * 16 + 16, c0:c0 + 8])
                    assert [r[2 * t:2 * t + 2] for r in regs] == want


@pytest.mark.parametrize("H,gates", [
    (16, 4), (16, 3), (48, 3), (64, 4), (128, 4), (128, 3),
])
def test_transposed_packing_round_trips(H, gates):
    """The W_x^T packing is a permutation: unpacking gives W back."""
    w = torch.from_numpy(np.random.default_rng(H + gates).standard_normal(
        (H, gates * H)).astype(np.float32)).to(torch.bfloat16)
    packed = R.pack_fragments(w, transpose=True)
    assert packed.shape == (w.numel(),) and packed.dtype == w.dtype
    assert torch.equal(
        R.unpack_fragments(packed, H, gates * H, transpose=True), w)
    idx = R._fragment_index(H, gates * H, None, True)
    assert torch.equal(idx.sort().values, torch.arange(w.numel()))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_transposed_packing_follows_the_m16n8k16_b_layout(cell):
    """Every k-step, warp and lane of the packed W_x^T holds the B
    fragment of ``d_xw @ W_x^T`` (K = G H, N = H): warp w's n8 tile is
    the output units 8 w .. 8 w + 7, b0 then b1 in one 8-byte load."""
    H = 32
    GH = GATES[cell] * H
    w = torch.arange(H * GH, dtype=torch.float64).view(H, GH)
    p = R.pack_fragments(w, transpose=True).view(GH // 16, H // 8, 32, 4)
    WT = w.T.numpy()
    for ks in range(GH // 16):
        for warp in range(H // 8):
            want = _b_fragment(WT[ks * 16:ks * 16 + 16,
                                  8 * warp:8 * warp + 8])
            got = [[tuple(p[ks, warp, lane, :2].tolist()),
                    tuple(p[ks, warp, lane, 2:].tolist())]
                   for lane in range(32)]
            assert got == want


# ---------------------------------------------------------------------------
# Numerics of the split operand
# ---------------------------------------------------------------------------


def _split(d: torch.Tensor):
    """The kernels' split of an f32 operand: hi = bf16(d), lo = bf16(d -
    hi), each rounded to nearest even as ``__float2bfloat16_rn``."""
    hi = d.to(torch.bfloat16)
    lo = (d - hi.float()).to(torch.bfloat16)
    return hi, lo


def test_split_reconstructs_f32_within_2_to_the_minus_16():
    rng = np.random.default_rng(0)
    d = torch.from_numpy((rng.standard_normal(100_000)
                          * np.exp(rng.uniform(-20, 20, 100_000)))
                         .astype(np.float32))
    hi, lo = _split(d)
    rel = ((hi.double() + lo.double() - d.double()).abs()
           / d.double().abs()).max().item()
    assert rel <= 2.0 ** -16
    # One bf16 rounding alone keeps 8 significant bits: 2^-8 relative.
    one = ((hi.double() - d.double()).abs() / d.double().abs()).max().item()
    assert 2.0 ** -9 < one <= 2.0 ** -8


def test_split_products_stay_near_the_f32_products():
    """``d @ W^T`` as the kernels form it (hi @ W^T + lo @ W^T, bf16
    operands, exact products summed in f32) against the plain version's
    f32 product: far inside the bf16 bound, and far closer than one
    rounding of d to bf16."""
    rng = np.random.default_rng(1)
    d = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((128, 512)) / 16).astype(
        np.float32)).to(torch.bfloat16)
    want = d.double() @ w.double().T
    hi, lo = _split(d)
    split = (hi.float() @ w.float().T + lo.float() @ w.float().T).double()
    once = (hi.float() @ w.float().T).double()
    scale = want.abs().max().item()
    err_split = (split - want).abs().max().item() / scale
    err_once = (once - want).abs().max().item() / scale
    assert err_split < 1e-4
    assert err_split < err_once / 20


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _bwd_inputs(cell, B, T, H, seed, device, dtype=torch.bfloat16):
    """Saved states from the plain forward and an upstream gradient."""
    rng = np.random.default_rng(seed)
    G = GATES[cell] * H
    arrays = [rng.standard_normal((B, T, H)),
              rng.standard_normal((H, G)) / np.sqrt(H),
              0.1 * rng.standard_normal((G,)),
              rng.standard_normal((H, G)) / np.sqrt(H),
              rng.standard_normal((B, T, H))]
    hin, wx, b, wh, dh = [torch.from_numpy(a.astype(np.float32)).to(dtype)
                          .to(device) for a in arrays]
    m = rng.random((B, T)) < 0.75
    m[0] = False  # an all-invalid row
    m = torch.from_numpy(m).to(device)
    h, c = R.rnn_scan_states(cell, hin.float() @ wx.float() + b.float(), wh,
                             m, 1.0, True)
    return (hin, wx, b, wh, m, h.to(dtype),
            None if c is None else c.to(dtype), dh)


#: Scaled atol of the tensor-core route's f32 weight gradients (dW_x, db,
#: dW_h). The split of d_gates reads near 4e-6 at the c2 train step;
#: rounding d_gates once to bf16 reads near 2e-3 and fails it.
WGRAD_TOL = 1e-4


def _scaled_close(got, want, atol=0.05):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    scale = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 9])
@pytest.mark.parametrize("B", [1, 37, 2048 + 5])
@pytest.mark.parametrize("H", [16, 64, 128])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_mma_bwd_matches_plain(cuda, cell, H, B, T):
    """dhin (bf16, scaled atol 0.05) and dW_x, db and dW_h (f32, scaled
    atol :data:`WGRAD_TOL`) against the plain formulas; B = 37 and 2053
    leave the last block part-filled; row 0 is all-invalid and passes no
    gradient to hin."""
    args = _bwd_inputs(cell, B, T, H, B * T + H, cuda)
    _build.reset_launch_counts()
    got = R.rnn_scan_fused_bwd(cell, *args)
    counts = _build.launch_counts()
    assert counts[f"rnn_fused_bwd_mma_{cell}"] == 1
    assert counts[f"rnn_fused_bwd_{cell}"] == 0
    want = R.rnn_scan_fused_bwd_reference(cell, *args)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (B, T, H)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.isfinite(g).all()
        _scaled_close(g, w, 0.05 if i == 0 else WGRAD_TOL)
    assert not got[0][0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_mma_bwd_weight_gradients_bitwise_repeatable(cuda, cell):
    """A fixed-order reduction with no atomics: two launches on the same
    inputs give the same bits, at a shape with many row slices."""
    args = _bwd_inputs(cell, 2048 + 5, 9, 128, 3, cuda)
    one = R.rnn_scan_fused_bwd(cell, *args)
    two = R.rnn_scan_fused_bwd(cell, *args)
    for a, z in zip(one, two):
        assert torch.equal(a, z)


@pytest.mark.cuda
def test_autograd_reuses_the_forward_packing(cuda):
    """Through ``rnn_scan_fused``'s autograd Function on the card the
    forward and the backward both take the tensor cores, and the
    gradients agree with the plain version's."""
    hin, wx, b, wh, m, _, _, _ = _bwd_inputs("lstm", 37, 6, 64, 11, cuda)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (hin, wx, b, wh)]
    _build.reset_launch_counts()
    out = R.rnn_scan_fused("lstm", *leaves, m)
    (out.float() ** 2).sum().backward()
    counts = _build.launch_counts()
    assert counts["rnn_fused_fwd_mma_lstm"] == 1
    assert counts["rnn_fused_bwd_mma_lstm"] == 1
    ref = [t.detach().clone().float().requires_grad_(True)
           for t in (hin, wx, b, wh)]
    out_ref = R.rnn_scan_fused_reference("lstm", *ref, m)
    (out_ref.float() ** 2).sum().backward()
    for g, r in zip(leaves, ref):
        _scaled_close(g.grad, r.grad)


def _hoisted_inputs(cell, B, T, H, seed, device, dtype=torch.bfloat16):
    """The hoisted backward's operands: xw = hin @ W_x + b in ``dtype``
    and the saved states of the plain forward over it."""
    hin, wx, b, wh, m, _, _, dh = _bwd_inputs(cell, B, T, H, seed, device,
                                              dtype)
    xw = (hin.float() @ wx.float() + b.float()).to(dtype)
    h, c = R.rnn_scan_states(cell, xw, wh, m, 1.0, True)
    return (xw, wh, m, h.to(dtype), None if c is None else c.to(dtype), dh)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 9])
@pytest.mark.parametrize("B", [1, 37, 2048 + 5])
@pytest.mark.parametrize("H", [16, 48, 128])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_mma_hoisted_bwd_matches_plain(cuda, cell, H, B, T):
    """The hoisted mode (``rnn_scan_bwd`` in bf16): dxw (bf16, scaled atol
    0.05) and dW_h (f32, scaled atol :data:`WGRAD_TOL`) against the plain
    formulas; B = 37 and 2053 leave the last block part-filled; row 0 is
    all-invalid and passes no gradient to xw."""
    args = _hoisted_inputs(cell, B, T, H, B * T + H + 1, cuda)
    _build.reset_launch_counts()
    got = R.rnn_scan_bwd(cell, *args)
    counts = _build.launch_counts()
    assert counts[f"rnn_bwd_mma_{cell}"] == 1
    assert counts[f"rnn_bwd_{cell}"] == 0
    want = R.rnn_scan_bwd_reference(cell, *args)
    G = GATES[cell] * H
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (B, T, G)
    assert got[1].dtype == torch.float32 and got[1].shape == (H, G)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.isfinite(g).all()
        _scaled_close(g, w, 0.05 if i == 0 else WGRAD_TOL)
    assert not got[0][0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_mma_hoisted_bwd_bitwise_repeatable(cuda, cell):
    """The hoisted mode's dW_h sums its row slices in a fixed order: two
    launches on the same inputs give the same bits."""
    args = _hoisted_inputs(cell, 2048 + 5, 9, 128, 4, cuda)
    one = R.rnn_scan_bwd(cell, *args)
    two = R.rnn_scan_bwd(cell, *args)
    for a, z in zip(one, two):
        assert torch.equal(a, z)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_hoisted_autograd_routes_by_dtype(cuda, cell):
    """Through ``rnn_scan``'s autograd Function: bf16 at H = 64 moves the
    bf16 tensor-core backward's counter and the hoisted mode of the
    tensor-core forward's, float32 the 3xTF32 backward's and forward's,
    and both gradients agree with the plain version's."""
    for dtype, name, fwd in (
            (torch.bfloat16, f"rnn_bwd_mma_{cell}", f"rnn_fwd_mma_{cell}"),
            (torch.float32, f"rnn_bwd_tf32_{cell}", f"rnn_fwd_tf32_{cell}")):
        xw, wh, m, _, _, _ = _hoisted_inputs(cell, 37, 6, 64, 12, cuda,
                                             dtype)
        leaves = [t.detach().clone().requires_grad_(True) for t in (xw, wh)]
        _build.reset_launch_counts()
        out = R.rnn_scan(cell, *leaves, m)
        (out.float() ** 2).sum().backward()
        counts = _build.launch_counts()
        assert counts[name] == 1 and counts[fwd] == 1
        assert sum(counts.values()) == 2
        ref = [t.detach().clone().float().requires_grad_(True)
               for t in (xw, wh)]
        (R.rnn_scan_reference(cell, *ref, m).float() ** 2).sum().backward()
        atol = 0.05 if dtype == torch.bfloat16 else 1e-5
        for g, r in zip(leaves, ref):
            _scaled_close(g.grad, r.grad, atol)


@pytest.mark.cuda
def test_float32_and_odd_widths_keep_the_cuda_core_backward(cuda):
    """Widths the tensor cores do not take keep the CUDA-core backward:
    float32 past the grid kernel's 1024 and bf16 past the bf16 grid
    kernel's 1520 (every narrower width, odd or not, is padded onto the
    tensor cores)."""
    _build.reset_launch_counts()
    for cell in ("lstm", "gru"):
        for dtype, H in ((torch.float32, 1032), (torch.bfloat16, 1530)):
            args = _bwd_inputs(cell, 5, 3, H, H, cuda, dtype)
            R.rnn_scan_fused_bwd(cell, *args)
    counts = _build.launch_counts()
    for cell in ("lstm", "gru"):
        assert counts[f"rnn_fused_bwd_{cell}"] == 2
        assert counts[f"rnn_fused_bwd_mma_{cell}"] == 0


def _stacked_bwd(cell, S, B, T, H, device):
    per = [_bwd_inputs(cell, B, T, H, 200 + s, device) for s in range(S)]
    return [None if per[0][i] is None else torch.stack([p[i] for p in per])
            for i in range(len(per[0]))]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_seed_batched_backward_bitwise_equals_single_seed_launches(cuda,
                                                                   cell):
    """S seeds in one call (counted once) against S one-seed calls: dhin,
    dW_x, db and dW_h bitwise equal, the slices per seed summed in the same
    order; m of seed extent 1 equals its broadcast copy bitwise; and the
    stacked gradients against the plain version."""
    S = 3
    args = _stacked_bwd(cell, S, 2048 + 5, 9, 128, cuda)
    _build.reset_launch_counts()
    got = R.rnn_scan_fused_bwd(cell, *args)
    counts = _build.launch_counts()
    assert counts[f"rnn_fused_bwd_mma_{cell}"] == 1
    assert counts[f"rnn_fused_bwd_{cell}"] == 0
    assert got[0].shape == args[0].shape and got[1].shape == args[1].shape
    for s in range(S):
        one = R.rnn_scan_fused_bwd(cell, *(None if t is None else t[s]
                                           for t in args))
        for g, o in zip(got, one):
            assert torch.equal(g[s], o)
    want = R.rnn_scan_fused_bwd_reference(cell, *args)
    for i, (g, w) in enumerate(zip(got, want)):
        for s in range(S):
            _scaled_close(g[s], w[s], 0.05 if i == 0 else WGRAD_TOL)
    shared = list(args)
    shared[4] = args[4][:1]
    full = list(args)
    full[4] = args[4][:1].expand(S, *args[4].shape[1:]).contiguous()
    for g, r in zip(R.rnn_scan_fused_bwd(cell, *shared),
                    R.rnn_scan_fused_bwd(cell, *full)):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_seed_batched_backward_at_the_c5_train_step(cuda):
    """The c5 train step's shape (64 seeds of B 2048, T 60, H 128, LSTM):
    d_gates over all seeds is 64 * 2048 * 60 * 512 = 4.0e9 f32 values, past
    2^31, so the per-seed offsets must be 64-bit. The first, a middle and
    the last seed bitwise those of one-seed calls."""
    S, B, T, H = 64, 2048, 60, 128
    gen = torch.Generator(device=cuda).manual_seed(1)

    def bf(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=cuda)).to(
            torch.bfloat16)

    hin, h_all, c_all = bf(S, B, T, H), bf(S, B, T, H), bf(S, B, T, H)
    dh = bf(S, B, T, H, scale=0.1)
    wx, wh = bf(S, H, 4 * H, scale=H ** -0.5), bf(S, H, 4 * H,
                                                  scale=H ** -0.5)
    b = bf(S, 4 * H, scale=0.1)
    m = torch.rand(S, B, T, generator=gen, device=cuda) < 0.8
    assert S * B * T * 4 * H > 2 ** 31
    args = (hin, wx, b, wh, m, h_all, c_all, dh)
    _build.reset_launch_counts()
    got = R.rnn_scan_fused_bwd("lstm", *args)
    assert _build.launch_counts()["rnn_fused_bwd_mma_lstm"] == 1
    for s in (0, S // 2, S - 1):
        one = R.rnn_scan_fused_bwd("lstm", *(t[s] for t in args))
        for g, o in zip(got, one):
            assert torch.equal(g[s], o)
    for g in got:
        assert torch.isfinite(g).all()
