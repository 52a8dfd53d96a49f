"""The bfloat16 forward past hidden 512 (``csrc/rnn_fwd_grid.cu``: the fused
form's xw by the bf16 GEMM into an f32 scratch, the recurrence on a
cooperative grid whose CTAs hold W_h's columns in bf16) on the CPU, and the
plain backwards' float64 rule.

* The route: bf16 forwards at 512 < Hp <= 1520 take ``"grid"``, as the
  backwards do, past it the CUDA cores; float32 is as before.
* The picker (``ops/rnn.py _fwd_grid_size``, ``_fwd_grid_rows``) and the
  shared-memory mirror (``_fwd_grid_smem``) against the source's
  constants and count, and against a hand count at an H100's 232,448 bytes
  and 132 SMs, from Hp 528 to the widest, 1520; the chunk dealing over a
  group's CTAs and warps.
* The plumbing: the fused forward on the grid route hands its f32 xw
  scratch back, and the fused backward passes it to the grid backward.
* A CPU model of the kernel's order: h_{t-1} rounded to bf16, the product
  of each (row, unit) one f32 chain over k in steps of 16 from zero, xw
  added after it, the cell and the mask per (row, unit); its bits do not
  depend on the group or the rows. The model's rows 3 and 1 and the plain
  rows are held to the Pallas ``rnn_scan_fused`` and ``rnn_scan``
  (interpret mode, jitted) at Hp 528, reached as H 528 and as H 530
  zero-padded to 544, B 4, T 3, an all-invalid row included: atol and
  rtol 0.05 (the JAX bf16 bound).
* ``RNNModel.row_state_bytes`` counts the grid forward's f32 xw scratch.
* The plain backwards on float64 operands sum in float64 and give float64
  outputs, within float32's precision of the float32 plain backwards.

The kernel itself is held to the plain versions on the card in
``tests/test_torch_kernels.py`` (``test_fwd_grid_*``).
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfm_quant_tpu.ops.pallas_rnn import rnn_scan as jax_scan
from lfm_quant_tpu.ops.pallas_rnn import rnn_scan_fused as jax_scan_fused
from lfm_quant_tpu_torch.models import RNNModel
from lfm_quant_tpu_torch.ops import rnn as R

GATES = {"lstm": 4, "gru": 3}
CSRC = Path(__file__).resolve().parents[1] / "lfm_quant_tpu_torch" / "csrc"
H100_SMEM = 232_448  # shared memory a block can use on an H100
H100_SMS = 132
BF = torch.bfloat16
BF16 = dict(atol=0.05, rtol=0.05)
WIDTHS = tuple(range(528, 1521, 16))
#: (cell, Hp) → (CTAs a group, rows a work item) at B 2048, one seed, by
#: hand: the fewest CTAs whose W_h columns (2 G 8 NC (Hp + 8) bytes, NC =
#: ceil(Hp / 8 / n)) fit beside the two 64-row stages (2 * 2 * 64 * 72
#: bytes) within 512 threads (NC <= 4 at 64 rows), 128 rows where NC <= 2,
#: they fit and 16 items fill the groups.
WANT = {("lstm", 528): (17, 64), ("gru", 528): (17, 64),
        ("lstm", 544): (17, 64), ("gru", 544): (17, 64),
        ("lstm", 640): (20, 64), ("gru", 640): (20, 64),
        ("lstm", 1024): (43, 64), ("gru", 1024): (32, 64),
        ("lstm", 1520): (95, 128), ("gru", 1520): (95, 128)}
KSTEP = 16  # k of one mma.sync m16n8k16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# The route, the source, the picker and the dealing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H,want", [(512, "cluster"), (513, "grid"),
                                    (528, "grid"), (530, "grid"),
                                    (1024, "grid"), (1520, "grid"),
                                    (1521, "simt"), (1530, "simt")])
def test_bf16_forward_route_past_512(H, want):
    """bf16 forwards at 512 < Hp <= 1520 run on the grid (H 513 at Hp 528
    and 530 at 544, zero-padded), the CUDA cores past it: the backward's
    route, so a width has one route both ways; float32 forwards above 128
    stay on the CUDA cores."""
    assert R._mma_route(BF, H) == want
    assert R._mma_route(BF, H, "bwd") == want
    assert R._mma_route(torch.float32, H) == "simt"


def test_source_constants_agree():
    """The wrapper's widest width, rows, threads, stages and units are the
    source's and the shared grid header's, its count the source's
    formula; the source takes the barrier and the launch from
    ``grid_common.cuh`` and kernel 0 is the grid backward's own call of
    ``cluster_gemm.cuh``'s GEMM (the same bits either way)."""
    src = (CSRC / "rnn_fwd_grid.cu").read_text()
    bwd = (CSRC / "rnn_bwd_grid.cu").read_text()
    common = (CSRC / "grid_common.cuh").read_text()
    assert f"constexpr int kMaxWidth = {R.BF16_GRID_MAX_WIDTH};" in src
    assert f"constexpr int kStageK = {R.GRID_STAGE_K};" in src
    assert f"constexpr int kStages = {R.GRID_STAGES};" in src
    assert f"constexpr int kMaxThreads = {R.GRID_MAX_THREADS};" in src
    assert f"constexpr int kUnits = {R.MMA_UNITS};" in common
    rows = re.search(r"if \(rows != (\d+) && rows != (\d+)\)", src)
    assert rows and tuple(map(int, rows.groups())) == R.GRID_ROWS
    assert ("  return 2 * ((size_t)G * kUnits * chunks_per_cta(H, n) * (H + "
            "8) +\n              (size_t)kStages * rows * (kStageK + 8));"
            in src)
    assert "using lfm_grid::group_barrier;" in src
    assert "lfm_grid::check_fits(kern, groups, n, threads, smem)" in src
    flat = (lambda text: " ".join(text.split()))
    gemm = ("lfm_cluster::launch_gemm(xin, wx, b, {}, M, GH, H, seeds, "
            "s_xin, s_wx, s_b, s_gates, stream)")
    assert gemm.format("xw_scratch") in flat(src)
    assert gemm.format("dgx") in flat(bwd)
    # One chain over k from zero a gate, then xw added (the plain order).
    assert "mma_bf16(acc[q], a, make_uint2(b2[0], b2[1]));" in src
    assert "sigmoid(x[0] + acc[0][i])" in src


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_group_picker_on_an_h100(cell):
    """Every (cell, Hp) from 528 to 1520: the group is the fewest CTAs (at
    most 132) whose bf16 columns of W_h fit 232,448 bytes beside the two
    64-row stages within 512 threads; rows 128 only where they are taken,
    fit and leave no group the card holds idle; the sizes of
    :data:`WANT`."""
    for Hp in WIDTHS:
        n = R._fwd_grid_size(cell, Hp, H100_SMEM, H100_SMS)
        assert 1 <= n <= H100_SMS and R._grid_takes(Hp, n, 64, BF)
        assert R._fwd_grid_smem(cell, Hp, n, 64) <= H100_SMEM
        for fewer in range(1, n):
            assert (not R._grid_takes(Hp, fewer, 64, BF)
                    or R._fwd_grid_smem(cell, Hp, fewer, 64) > H100_SMEM)
        rows = R._fwd_grid_rows(cell, Hp, n, 2048, 1, H100_SMEM, H100_SMS)
        assert R._grid_takes(Hp, n, rows, BF)
        assert R._fwd_grid_smem(cell, Hp, n, rows) <= H100_SMEM
        if rows == 128:
            assert -(-2048 // 128) >= H100_SMS // n
        if (cell, Hp) in WANT:
            assert (n, rows) == WANT[cell, Hp], (cell, Hp, n, rows)


@pytest.mark.parametrize("cell,Hp,n,rows,want", [
    ("lstm", 528, 17, 64, 155_648), ("gru", 528, 17, 64, 121_344),
    ("lstm", 1024, 43, 64, 216_576), ("gru", 1024, 32, 64, 216_576),
    ("lstm", 1520, 95, 128, 232_448), ("gru", 1520, 95, 128, 183_552)])
def test_smem_count_by_hand(cell, Hp, n, rows, want):
    """The count, written out: the W_h columns of 8 ceil(Hp / 8 / n) units
    of each of the G gates, Hp + 8 k-values each, and two stages of the h
    tile [rows][64 + 8], bf16; the LSTM's widest at 128 rows fills an
    H100's limit to the byte. Past 1520 no group fits."""
    G = GATES[cell]
    NC = -(-(Hp // 8) // n)
    assert R._fwd_grid_smem(cell, Hp, n, rows) == 2 * (
        G * 8 * NC * (Hp + 8) + 2 * rows * 72) == want
    with pytest.raises(ValueError, match="bfloat16 .* hidden=1536"):
        R._fwd_grid_size(cell, 1536, H100_SMEM, H100_SMS)
    with pytest.raises(ValueError, match="hidden=1520"):
        R._fwd_grid_size(cell, 1520, 150_000, H100_SMS)


@pytest.mark.parametrize("Hp,n,rows", [(528, 17, 64), (544, 17, 64),
                                       (1024, 43, 64), (1520, 95, 128)])
def test_every_unit_and_row_is_owned_once(Hp, n, rows):
    """The chunk dealing of ``grid_common.cuh`` at the forward's shapes: CTA
    j owns chunks [j W / n, (j + 1) W / n) (NC or NC - 1, never none), warp
    w chunk w % NC and rows 16 (w / NC) ..; lane (g, c) the rows g, g + 8
    and units 2c, 2c + 1 of its chunk, and lanes c = 0, 1 of a quad store
    its 8 units of rows g and g + 8: every (row, unit) of an item is one
    active thread's, and one lane stores it, within 512 threads."""
    W = Hp // 8
    NC = R._grid_chunks(Hp, n)
    nwarps = NC * rows // 16
    assert 32 * nwarps <= R.GRID_MAX_THREADS
    seen = np.zeros((rows, Hp), int)
    stored = np.zeros((rows, Hp), int)
    lane = np.arange(32)
    g, c = lane // 4, lane % 4
    for j in range(n):
        w0 = j * W // n
        own = (j + 1) * W // n - w0
        assert own in (NC, NC - 1) and own >= 1
        for warp in range(nwarps):
            chunk, ra0 = warp % NC, (warp // NC) * 16
            if chunk >= own:
                continue
            u = (w0 + chunk) * 8 + 2 * c
            for r in (ra0 + g, ra0 + g + 8):
                np.add.at(seen, (r, u), 1)
                np.add.at(seen, (r, u + 1), 1)
            for q in range(2):  # lane c = q stores row g + 8 q
                for e in range(8):
                    np.add.at(stored, (ra0 + g[c == q] + 8 * q,
                                       (w0 + chunk) * 8 + e), 1)
    assert (seen == 1).all() and (stored == 1).all()


def test_fused_forward_hands_its_xw_to_the_grid_backward(monkeypatch):
    """On the grid route (bf16, H 530 at Hp 544) ``_fused_states`` launches
    the grid forward once and hands back its f32 xw scratch at Hp, and the
    fused backward passes that scratch to the grid backward (the recorded
    launchers stand in for the kernels; shape-only tensors on the meta
    device for the card's)."""
    calls = []
    H, Hp, B, T = 530, 544, 5, 3
    G = 4 * H

    def fwd(cell, fused, hin, wx, b, wh, m, fb, save_c, keep_xw=False):
        calls.append(("fwd", fused, tuple(hin.shape), keep_xw))
        h = hin.new_empty(hin.shape)
        xw = hin.new_empty((B, T, 4 * Hp), dtype=torch.float32)
        return (h, h, xw) if keep_xw else (h, h)

    def bwd(cell, fused, hin, wx, b, wh, m, h, c, dh, fb, xw=None):
        calls.append(("bwd", fused, tuple(hin.shape), xw))
        return hin, wx, b, wh

    monkeypatch.setattr(R, "_check_card", lambda *a, **k: None)
    monkeypatch.setattr(R, "_launch_fwd_grid", fwd)
    monkeypatch.setattr(R, "_launch_bwd_grid", bwd)
    meta = dict(dtype=BF, device="meta")
    hin = torch.empty(B, T, H, **meta)
    wx, wh = torch.empty(H, G, **meta), torch.empty(H, G, **meta)
    b = torch.empty(G, **meta)
    m = torch.empty(B, T, dtype=torch.bool, device="meta")
    h, c, xw = R._fused_states("lstm", hin, wx, b, wh, m, 1.0, True,
                               keep_xw=True)
    assert calls == [("fwd", True, (B, T, Hp), True)]
    assert h.shape == (B, T, H) and xw.shape == (B, T, 4 * Hp)
    assert xw.dtype == torch.float32
    R.rnn_scan_fused_bwd("lstm", hin, wx, b, wh, m, h, c, h, 1.0, xw=xw)
    assert calls[1][:3] == ("bwd", True, (B, T, Hp)) and calls[1][3] is xw


# ---------------------------------------------------------------------------
# A CPU model of the kernel's order, against the Pallas forwards
# ---------------------------------------------------------------------------


def _bf16(a):
    """Rounded to bf16 (to nearest even, as ``__floats2bfloat162_rn``),
    as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        BF).float().numpy()


def _product(hb, w):
    """The own units' product h_{t-1} @ W_h[:, units] as the kernel forms
    it: ``hb [R, Hp]`` and ``w [Hp, U]`` hold bf16 values; one f32
    accumulator a (row, unit) from zero, each k-step of 16 added to it in k
    order (a step's 16 products summed exactly, in float64: bf16 products
    are exact and 16 of them at these magnitudes fit float64 exactly, in
    any order)."""
    acc = np.zeros((hb.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, hb.shape[1], KSTEP):
        k = slice(k0, k0 + KSTEP)
        part = (hb[:, None, k].astype(np.float64)
                * w.T[None, :, k]).sum(axis=-1)
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


def _sigmoid(v):
    return (np.float32(1.0) / (np.float32(1.0) + np.exp(-v))).astype(
        np.float32)


def grid_fwd_model(cell, x, wh, m, fb=1.0):
    """The kernel's order on f32 numpy arrays holding bf16 values (x the f32
    x side [B, T, G H] with the bias) → (h_all, c_all or None) as bf16
    values: per step the product :func:`_product` of bf16(h_{t-1}) (none at
    t = 0), xw added after it, the cell per (row, unit), the mask holding h
    and c."""
    f = np.float32
    B, T, GH = x.shape
    H = GH // GATES[cell]
    hb = np.zeros((B, H), f)     # bf16(h_{t-1}): the product's operand
    carry = np.zeros((B, H), f)  # c (LSTM) or h (GRU)
    hs, cs = [], []
    for t in range(T):
        acc = (_product(hb, wh) if t > 0 else np.zeros((B, GH), f))
        kp = m[:, t, None]
        a = np.split(acc, GATES[cell], axis=-1)
        xs = np.split(x[:, t], GATES[cell], axis=-1)
        if cell == "lstm":
            ig = _sigmoid((xs[0] + a[0]).astype(f))
            fg = _sigmoid(((xs[1] + a[1]).astype(f) + f(fb)).astype(f))
            gg = np.tanh((xs[2] + a[2]).astype(f))
            og = _sigmoid((xs[3] + a[3]).astype(f))
            c = (fg * carry + ig * gg).astype(f)
            h = (og * np.tanh(c)).astype(f)
            carry = np.where(kp, c, carry)
            hb = np.where(kp, _bf16(h), hb)
            cs.append(_bf16(carry))
        else:
            z = _sigmoid((xs[0] + a[0]).astype(f))
            rg = _sigmoid((xs[1] + a[1]).astype(f))
            n = np.tanh((xs[2] + rg * a[2]).astype(f))
            h = ((f(1) - z) * n + z * carry).astype(f)
            carry = np.where(kp, h, carry)
            hb = _bf16(carry)
        hs.append(hb)
    return (np.stack(hs, axis=1),
            np.stack(cs, axis=1) if cell == "lstm" else None)


def model_rows(cell, ops, Hp):
    """Rows 3 and 1 by :func:`grid_fwd_model` at padded width ``Hp``: the
    operands padded per gate block (``padded_launch``'s rule, exact), h_all
    sliced back. ``ops``: torch tensors at H."""
    G = GATES[cell]
    H = ops["wh"].shape[0]
    pad = (lambda t, k: R._pad_one(t, k, G, H, Hp).float().numpy())
    hin, wx, b, wh = (pad(ops[k], kind) for k, kind in
                      (("hin", "u"), ("wx", "w"), ("b", "g"), ("wh", "w")))
    m = ops["m"].numpy()
    out = {}
    for row, x in ((3, (hin.astype(np.float64) @ wx + b).astype(np.float32)),
                   (1, pad(ops["xw"], "g"))):
        h, _ = grid_fwd_model(cell, x, wh, m)
        out[row] = h[..., :H]
    return out


@functools.lru_cache(maxsize=None)
def _pallas(cell, H):
    """Seeded bf16 operands at B 4, T 3 (row 1 all invalid) and the Pallas
    ``rnn_scan_fused`` (row 3) and ``rnn_scan`` (row 1, on the bf16 xw) in
    interpret mode, both in one jitted call."""
    B, T = 4, 3
    G = GATES[cell] * H
    rng = np.random.default_rng(H + 7 * len(cell))
    sd = H ** -0.5
    arrays = (rng.standard_normal((B, T, H)), sd * rng.standard_normal((H, G)),
              0.1 * rng.standard_normal((G,)), sd * rng.standard_normal((H, G)))
    m = rng.random((B, T)) < 0.75
    m[1] = False
    t = [torch.from_numpy(a.astype(np.float32)).to(BF) for a in arrays]
    xw = (t[0].float() @ t[1].float() + t[2].float()).to(BF)
    ops = dict(hin=t[0], wx=t[1], b=t[2], wh=t[3], m=torch.from_numpy(m),
               xw=xw)
    j = lambda v: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)  # noqa

    @jax.jit
    def both(hin, wx, b, wh, xw, jm):
        return (jax_scan_fused(cell, hin, wx, b, wh, jm),
                jax_scan(cell, xw, wh, jm))

    row3, row1 = both(*(j(v) for v in t), j(xw), jnp.asarray(m))
    f32 = (lambda v: np.asarray(v.astype(jnp.float32)))
    return ops, f32(row3), f32(row1)


@pytest.mark.parametrize("cell,H", [("lstm", 528), ("gru", 528),
                                    ("lstm", 530), ("gru", 530)])
def test_grid_model_and_plain_rows_match_the_pallas_forwards(cell, H):
    """At H 528 (Hp 528) and H 530 (zero-padded to Hp 544): the kernel's
    order (:func:`model_rows`) and the plain rows 3 and 1 in bf16 against
    the Pallas ops and against each other, atol and rtol 0.05; the
    all-invalid row's h_all is exactly 0."""
    ops, row3, row1 = _pallas(cell, H)
    model = model_rows(cell, ops, R._padded_width(H))
    plain3 = R.rnn_scan_fused_reference(cell, ops["hin"], ops["wx"],
                                        ops["b"], ops["wh"], ops["m"])
    plain1 = R.rnn_scan_states(cell, ops["xw"], ops["wh"], ops["m"], 1.0,
                               False)[0]
    for got, plain, want in ((model[3], plain3, row3),
                             (model[1], plain1, row1)):
        plain = plain.float().numpy()
        assert got.shape == want.shape == plain.shape
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **BF16)
        np.testing.assert_allclose(plain, want, **BF16)
        np.testing.assert_allclose(got, plain, **BF16)
        assert not got[1].any() and not plain[1].any()


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_product_bits_depend_on_neither_group_nor_rows(cell):
    """Each (row, unit)'s product is one chain over the whole bf16 h_{t-1}
    row block in one fixed k order, so a CTA's units (any group's dealing)
    and a work item's rows (64 or 128, or the tail of B) give the bits of
    the whole product; and the h_t the cell makes from them is what the
    exchange carries: bf16(h_t), read back as the next product's operand
    without another rounding."""
    rng = np.random.default_rng(11)
    Hp, G = 528, GATES[cell]
    hb = _bf16(rng.standard_normal((40, Hp)))
    w = _bf16(rng.standard_normal((Hp, G * Hp)) * Hp ** -0.5)
    whole = _product(hb, w)
    W = Hp // 8
    for n in (17, 33):
        for j in (0, n // 2, n - 1):
            cols = np.concatenate([
                q * Hp + np.arange(8 * (j * W // n), 8 * ((j + 1) * W // n))
                for q in range(G)])
            for rows in (slice(0, 16), slice(16, 40)):
                part = _product(hb[rows], w[:, cols])
                assert np.array_equal(part, whole[rows][:, cols])
    assert np.array_equal(_bf16(hb), hb)


def test_row_state_bytes_counts_the_grid_scratch():
    """The seed chunking counts the fused grid forward's f32 xw scratch
    [W, G Hp] per row, as it does the cluster's: bf16 fused at hidden 528
    and 530 (Hp 544), not hoisted, not past 1520 or in float32."""
    W = 60

    def model(hidden, impl="fused", dtype=torch.bfloat16, cell="lstm"):
        return RNNModel(5, cell=cell, hidden=hidden, layers=1,
                        head_hidden=(), scan_impl=impl, dtype=dtype)

    assert model(528).row_state_bytes(W) == W * 528 * 2 + W * 4 * 528 * 4
    assert model(530, cell="gru").row_state_bytes(W) == (
        W * 530 * 2 + W * 3 * 544 * 4)
    assert model(528, "hoisted").row_state_bytes(W) == W * 528 * 2
    assert model(1530).row_state_bytes(W) == W * 1530 * 2
    assert model(528, dtype=torch.float32).row_state_bytes(W) == W * 528 * 4


# ---------------------------------------------------------------------------
# The plain backwards' float64 rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_float64_plain_backwards_agree_with_float32(cell):
    """Rows 4 and 2's plain versions on float64 copies of float32 operands
    (B 3, T 4, H 8, an all-invalid row) run in float64 and give float64
    outputs, within float32's precision of the float32 plain versions
    (scaled by each gradient's largest magnitude, 1e-5); float32 operands
    give float32 outputs as before."""
    rng = np.random.default_rng(5)
    B, T, H = 3, 4, 8
    G = GATES[cell] * H

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))

    hin, wx, b, wh = t(B, T, H), t(H, G, scale=0.3), t(G, scale=0.1), t(
        H, G, scale=0.3)
    m = torch.from_numpy(rng.random((B, T)) < 0.75)
    m[0] = False
    dh = t(B, T, H)
    xw = hin @ wx + b
    h, c = R.rnn_scan_states(cell, xw, wh, m, 1.0, True)
    d = (lambda v: None if v is None else v.double())
    for f32, f64 in (
            (R.rnn_scan_fused_bwd_reference(cell, hin, wx, b, wh, m, h, c,
                                            dh),
             R.rnn_scan_fused_bwd_reference(cell, *map(d, (hin, wx, b, wh)),
                                            m, *map(d, (h, c, dh)))),
            (R.rnn_scan_bwd_reference(cell, xw, wh, m, h, c, dh),
             R.rnn_scan_bwd_reference(cell, d(xw), d(wh), m,
                                      *map(d, (h, c, dh))))):
        assert len(f32) == len(f64)
        for a, z in zip(f32, f64):
            assert a.dtype == torch.float32 and z.dtype == torch.float64
            assert a.shape == z.shape
            scale = float(z.abs().max()) + 1e-12
            assert float((a.double() - z).abs().max()) / scale < 1e-5
