"""The float32 forward above hidden 128 (``csrc/rnn_fwd_tf32_grid.cu``: the
fused form's xw by an f32 FMA GEMM on the CUDA cores into an f32 scratch,
the 3xTF32 recurrence on a cooperative grid whose CTAs hold W_h's columns
in f32) on the CPU.

* The route: float32 forwards at 128 < Hp <= 1024 take ``"grid"``, past
  it the CUDA cores; bf16 and the backwards as their route table says.
* The source's constants against ``ops/rnn.py``; the picker
  (``_fwd_grid_size``, ``_fwd_grid_rows``) and the shared-memory mirror
  (``_fwd_grid_smem``) against a hand count at an H100's 232,448 bytes and
  132 SMs; the chunk and row dealing over a group's CTAs and warps.
* The plumbing: the fused forward on the grid route hands its f32 xw
  scratch back, and the fused backward passes it to the float32 grid
  backward past ``TF32_MAX_WIDTH`` and to the 3xTF32 cluster below it.
* ``RNNModel.row_state_bytes`` on the float32 routes.
* A CPU model of the kernel's order (``scripts/tf32_fwd_grid_order.py``:
  the hi/lo TF32 split by masking mantissa bits, the fixed k chains, xw
  last): its bits do not depend on the group or the rows, and its rows 3
  and 1 and the plain rows are held to the Pallas ``rnn_scan_fused`` and
  ``rnn_scan`` (interpret mode, jitted) in float32 at H 400 and at H 402
  zero-padded to 416, B 4, T 3, an all-invalid row included: atol 1e-5
  (the JAX f32 bound).

The kernel itself is held to the plain versions on the card in
``tests/test_torch_kernels.py`` (``test_tf32_fwd_grid_*``); the model's
error at H 400, T 60 is ``scripts/tf32_fwd_grid_order.py``'s.
"""

import functools
import importlib.util
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

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "lfm_quant_tpu_torch" / "csrc"
GATES = {"lstm": 4, "gru": 3}
H100_SMEM = 232_448  # shared memory a block can use on an H100
H100_SMS = 132
F32 = torch.float32
F32_TOL = dict(atol=1e-5, rtol=0)
#: (cell, Hp) → (CTAs a group, rows a work item) on an H100, by
#: hand: the fewest CTAs whose f32 W_h columns (4 G 8 NC (Hp + 8) bytes,
#: NC = ceil(Hp / 8 / n) <= 4, the thread limit at 64 rows) fit beside the
#: two 64-row stages (4 * 2 * 64 * 72 bytes); 128 rows where that group is
#: the card's only one (sms // n < 2) and they fit.
WANT = {("lstm", 160): (5, 64), ("gru", 160): (5, 64),
        ("lstm", 400): (17, 64), ("gru", 400): (13, 64),
        ("lstm", 528): (33, 64), ("gru", 528): (22, 64),
        ("lstm", 640): (40, 64), ("gru", 640): (27, 64),
        ("lstm", 1024): (128, 128), ("gru", 1024): (128, 128)}


def _order_model():
    spec = importlib.util.spec_from_file_location(
        "tf32_fwd_grid_order", ROOT / "scripts" / "tf32_fwd_grid_order.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


M = _order_model()


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


def test_float32_forward_route_above_128():
    """Every float32 forward width above 128 up to Hp 1024 runs on the grid
    (any H at its Hp, zero-padded), the CUDA cores past it: the
    ``rnn_fused_fwd.cu`` kernel kept no width the grid loses (the card's
    crossover at Hp 160, 256 and 384, ``PERF.md``); the float32 backward
    takes the 3xTF32 cluster up to ``TF32_MAX_WIDTH`` and the grid past
    it; bf16 is as before."""
    for H in range(129, 1041):
        Hp = R._padded_width(H)
        assert R._mma_route(F32, H) == ("grid" if Hp <= 1024 else "simt"), H
        assert R._mma_route(F32, H, "bwd") == (
            "tf32" if Hp <= R.TF32_MAX_WIDTH
            else "grid" if Hp <= 1024 else "simt"), H
        bf = ("cluster" if Hp <= R.CLUSTER_MAX_WIDTH else "grid")
        assert R._mma_route(torch.bfloat16, H) == bf
    for H in (16, 120, 128):
        assert R._mma_route(F32, H) == "tf32"


def _constant(text, name):
    m = re.search(rf"constexpr (?:int|bool) {name} = (\w+);", text)
    assert m, name
    return m.group(1)


def test_source_constants_agree():
    """The wrapper's widest width, rows, threads, stages and units are the
    source's and the shared headers', its count the forward header's
    formula in f32; the recurrence is ``grid_fwd.cuh``'s kernel, the one
    the bf16 grid forward runs (the source defines none, only its f32
    operands), which takes the barrier and the launch from
    ``grid_common.cuh``; kernel 0 is ``tf32_common.cuh``'s f32 FMA GEMM,
    the one ``rnn_fwd_tf32.cu`` runs (neither source defines it); the
    products keep ``rnn_fwd_tf32.cu``'s numerics (lo rounded, k-steps of
    8, xw after the h side)."""
    src = (CSRC / "rnn_fwd_tf32_grid.cu").read_text()
    fwd = (CSRC / "grid_fwd.cuh").read_text()
    tf32 = (CSRC / "rnn_fwd_tf32.cu").read_text()
    header = (CSRC / "tf32_common.cuh").read_text()
    common = (CSRC / "grid_common.cuh").read_text()
    assert int(_constant(src, "kMaxWidth")) == R.GRID_MAX_WIDTH
    assert int(_constant(fwd, "kStageK")) == R.GRID_STAGE_K
    assert int(_constant(fwd, "kStages")) == R.GRID_STAGES
    assert int(_constant(fwd, "kMaxThreads")) == R.GRID_MAX_THREADS
    assert int(_constant(common, "kUnits")) == R.MMA_UNITS
    rows = re.search(r"if \(rows != (\d+) && rows != (\d+)\)", fwd)
    assert rows and tuple(map(int, rows.groups())) == R.GRID_ROWS
    assert ("  return sizeof(T) * ((size_t)G * kUnits * chunks_per_cta(H, n) "
            "* (H + 8) +\n                      (size_t)kStages * rows * "
            "(kStageK + 8));" in fwd)
    assert "fwd_grid_smem_bytes<float>(" in src
    assert "using lfm_grid::group_barrier;" in fwd
    assert "lfm_grid::check_fits(kern, groups, n, threads, smem)" in fwd
    assert '#include "grid_fwd.cuh"' in src and "__global__" not in src
    assert "lfm_grid_fwd::launch<CELL, Tf32Ops, float>(" in src
    for text in (src, tf32):
        assert "using lfm_tf32::launch_sgemm;" in text
        assert "fwd_sgemm_kernel(" not in text
    assert "fwd_sgemm_kernel(const float* __restrict__ A" in header
    for name, value in (("kRecurChainK", "8"), ("kRoundLo", "true")):
        assert _constant(src, name) == _constant(tf32, name) == value
    assert "frag_a<kRoundLo>(a, x0.x, x1.x, x0.y, x1.y);" in src
    assert "sigmoid(x[0] + acc[0][i])" in fwd


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_group_picker_on_an_h100(cell):
    """Every (cell, Hp) from 144 to 1024: the group is the fewest CTAs (at
    most 132) whose f32 columns of W_h fit 232,448 bytes beside the two
    64-row stages within 512 threads (no cap on the chunks a CTA, as the
    bf16 picker has); rows 128 only where that group is the card's only
    one; the sizes of :data:`WANT`."""
    for Hp in range(144, 1025, 16):
        n = R._fwd_grid_size(cell, Hp, H100_SMEM, H100_SMS, F32)
        assert R._grid_takes(Hp, n, 64, F32)
        assert R._fwd_grid_smem(cell, Hp, n, 64, F32) <= H100_SMEM
        fit = [k for k in range(1, min(Hp // 8, H100_SMS) + 1)
               if R._grid_takes(Hp, k, 64, F32)
               and R._fwd_grid_smem(cell, Hp, k, 64, F32) <= H100_SMEM]
        assert n == fit[0]
        rows = R._fwd_grid_rows(cell, Hp, n, H100_SMEM, H100_SMS, F32)
        assert R._grid_takes(Hp, n, rows, F32)
        assert R._fwd_grid_smem(cell, Hp, n, rows, F32) <= H100_SMEM
        assert (rows == 128) == (
            H100_SMS // n < 2 and R._grid_takes(Hp, n, 128, F32)
            and R._fwd_grid_smem(cell, Hp, n, 128, F32) <= H100_SMEM)
        if (cell, Hp) in WANT:
            assert (n, rows) == WANT[cell, Hp], (cell, Hp, n, rows)


@pytest.mark.parametrize("cell,Hp,n,rows,want", [
    ("lstm", 160, 5, 64, 122_880), ("gru", 160, 5, 64, 101_376),
    ("lstm", 400, 17, 64, 193_536), ("gru", 400, 13, 64, 193_536),
    ("lstm", 640, 40, 64, 202_752), ("gru", 640, 27, 64, 223_488),
    ("lstm", 1024, 128, 128, 205_824), ("gru", 1024, 128, 128, 172_800)])
def test_smem_count_by_hand(cell, Hp, n, rows, want):
    """The count, written out: the f32 W_h columns of 8 ceil(Hp / 8 / n)
    units of each of the G gates, Hp + 8 k-values each, and two stages of
    the h tile [rows][64 + 8], f32 (twice the bf16 forward's count at the
    same shape). One CTA fewer does not fit (a chunk more, or past the
    thread limit); at 1024 two chunks a CTA do not fit (the LSTM's 301,056
    bytes, the GRU's 235,008); past 1024 no group is taken."""
    G = GATES[cell]
    NC = -(-(Hp // 8) // n)
    assert R._fwd_grid_smem(cell, Hp, n, rows, F32) == 4 * (
        G * 8 * NC * (Hp + 8) + 2 * rows * 72) == want
    assert R._fwd_grid_smem(cell, Hp, n, rows, F32) == 2 * R._fwd_grid_smem(
        cell, Hp, n, rows, torch.bfloat16)
    assert (not R._grid_takes(Hp, n - 1, 64, F32)
            or R._fwd_grid_smem(cell, Hp, n - 1, 64, F32) > H100_SMEM)
    assert R._fwd_grid_smem(cell, 1024, 64, 64, F32) == {
        "lstm": 301_056, "gru": 235_008}[cell]
    with pytest.raises(ValueError, match="float32 .* hidden=1040"):
        R._fwd_grid_size(cell, 1040, H100_SMEM, H100_SMS, F32)
    with pytest.raises(ValueError, match="hidden=1024"):
        R._fwd_grid_size(cell, 1024, 120_000, H100_SMS, F32)


@pytest.mark.parametrize("Hp,n,rows", [(160, 5, 64), (400, 17, 64),
                                       (400, 13, 64), (1024, 128, 128)])
def test_every_unit_and_row_is_owned_once(Hp, n, rows):
    """The chunk dealing of ``grid_common.cuh`` at the float32 forward's
    shapes: CTA j owns chunks [j W / n, (j + 1) W / n) (NC or NC - 1, never
    none), warp w chunk w % NC and rows 16 (w / NC) ..; lane (g, c) the
    rows g, g + 8 and units 2c, 2c + 1 of its chunk, and stores them (one
    float2 a row): every (row, unit) of an item is one active thread's,
    within 512 threads."""
    W = Hp // 8
    NC = R._grid_chunks(Hp, n)
    nwarps = NC * rows // 16
    assert 32 * nwarps <= R.GRID_MAX_THREADS
    seen = np.zeros((rows, Hp), int)
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
    assert (seen == 1).all()


@pytest.mark.parametrize("H,Hp,bwd", [(402, 416, "_launch_bwd_grid"),
                                      (150, 160, "_launch_bwd_tf32")])
def test_fused_forward_hands_its_xw_to_the_float32_backward(
        monkeypatch, H, Hp, bwd):
    """On the float32 grid route (H 402 at Hp 416; H 150 at Hp 160)
    ``_fused_states`` launches the grid forward once and hands back its f32
    xw scratch at Hp, and the fused backward passes that scratch to the
    float32 backward of its width: the grid past ``TF32_MAX_WIDTH``, the
    3xTF32 cluster below it (the recorded launchers stand in for the
    kernels; shape-only tensors on the meta device for the card's)."""
    calls = []
    B, T = 5, 3
    G = 4 * H

    def fwd(cell, fused, hin, wx, b, wh, m, fb, save_c, keep_xw=False):
        calls.append(("fwd", fused, tuple(hin.shape), keep_xw, hin.dtype))
        h = hin.new_empty(hin.shape)
        xw = hin.new_empty((B, T, 4 * Hp))
        return (h, h, xw) if keep_xw else (h, h)

    def back(cell, fused, hin, wx, b, wh, m, h, c, dh, fb, xw=None):
        calls.append(("bwd", fused, tuple(hin.shape), xw))
        return hin, wx, b, wh

    monkeypatch.setattr(R, "_check_card", lambda *a, **k: None)
    monkeypatch.setattr(R, "_launch_fwd_grid", fwd)
    monkeypatch.setattr(R, bwd, back)
    assert (R._mma_route(F32, H, "bwd") == "grid") == (
        bwd == "_launch_bwd_grid")
    meta = dict(dtype=F32, device="meta")
    hin = torch.empty(B, T, H, **meta)
    wx, wh = torch.empty(H, G, **meta), torch.empty(H, G, **meta)
    b = torch.empty(G, **meta)
    m = torch.empty(B, T, dtype=torch.bool, device="meta")
    h, c, xw = R._fused_states("lstm", hin, wx, b, wh, m, 1.0, True,
                               keep_xw=True)
    assert calls == [("fwd", True, (B, T, Hp), True, F32)]
    assert h.shape == (B, T, H) and xw.shape == (B, T, 4 * Hp)
    R.rnn_scan_fused_bwd("lstm", hin, wx, b, wh, m, h, c, h, 1.0, xw=xw)
    assert calls[1][:3] == ("bwd", True, (B, T, Hp)) and calls[1][3] is xw


def test_row_state_bytes_counts_the_float32_scratch():
    """The seed chunking counts the fused float32 forward's f32 xw scratch
    [W, G Hp] per row wherever that forward keeps one: on the grid above
    128 (hidden 400; 402 at Hp 416) and on the 3xTF32 kernels at and below
    128 (hidden 128; 120 at Hp 128), not hoisted and not past 1024 (the
    CUDA cores keep none)."""
    W = 60

    def model(hidden, impl="fused", cell="lstm"):
        return RNNModel(5, cell=cell, hidden=hidden, layers=1,
                        head_hidden=(), scan_impl=impl, dtype=F32)

    assert model(400).row_state_bytes(W) == W * 400 * 4 + W * 4 * 400 * 4
    assert model(402, cell="gru").row_state_bytes(W) == (
        W * 402 * 4 + W * 3 * 416 * 4)
    assert model(128).row_state_bytes(W) == W * 128 * 4 + W * 4 * 128 * 4
    assert model(120).row_state_bytes(W) == W * 120 * 4 + W * 4 * 128 * 4
    assert model(400, "hoisted").row_state_bytes(W) == W * 400 * 4
    assert model(1040).row_state_bytes(W) == W * 1040 * 4


# ---------------------------------------------------------------------------
# A CPU model of the kernel's order, against the Pallas forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_product_bits_depend_on_neither_group_nor_rows(cell):
    """Each (row, unit)'s product is one fixed sequence of k-steps over the
    whole f32 h_{t-1} row block, so a CTA's units (any group's dealing)
    and a work item's rows (64 or 128, or the tail of B) give the bits of
    the whole product; the split is exact (hi + lo == v wherever lo needs
    no rounding) and hi, lo are TF32 values (13 low bits clear)."""
    rng = np.random.default_rng(13)
    Hp, G = 400, GATES[cell]
    h = rng.standard_normal((40, Hp)).astype(np.float32)
    w = (rng.standard_normal((Hp, G * Hp)) * Hp ** -0.5).astype(np.float32)
    whole = M.product_3xtf32(h, w)
    W = Hp // 8
    for n in (17, 25):
        for j in (0, n // 2, n - 1):
            cols = np.concatenate([
                q * Hp + np.arange(8 * (j * W // n), 8 * ((j + 1) * W // n))
                for q in range(G)])
            for rows in (slice(0, 16), slice(16, 40)):
                part = M.product_3xtf32(h[rows], w[:, cols])
                assert np.array_equal(part, whole[rows][:, cols])
    hi, lo = M.split_tf32(h)
    for v in (hi, lo):
        assert not (v.view(np.uint32) & np.uint32(0x1FFF)).any()
    np.testing.assert_allclose(hi.astype(np.float64) + lo, h, rtol=2 ** -21)
    assert np.abs(whole - h.astype(np.float64) @ w).max() < 1e-5


def model_rows(cell, ops, Hp):
    """Rows 3 and 1 by the kernel's order at padded width ``Hp``: the
    operands padded per gate block (``padded_launch``'s rule, exact), the
    fused form's xw by the CUDA-core GEMM's FMA chains, h_all and c_all
    sliced back. ``ops``: torch tensors at H."""
    G = GATES[cell]
    H = ops["wh"].shape[0]
    pad = (lambda t, k: R._pad_one(t, k, G, H, Hp).numpy())
    hin, wx, b, wh = (pad(ops[k], kind) for k, kind in
                      (("hin", "u"), ("wx", "w"), ("b", "g"), ("wh", "w")))
    m = ops["m"].numpy()
    B, T = m.shape
    out = {}
    for row, x in ((3, M.fma_gemm(hin.reshape(B * T, Hp), wx, b).reshape(
            B, T, -1)), (1, pad(ops["xw"], "g"))):
        h, c = M.grid_fwd_model(cell, x, wh, m)
        out[row] = (h[..., :H], None if c is None else c[..., :H])
    return out


@functools.lru_cache(maxsize=None)
def _pallas(cell, H):
    """Seeded float32 operands at B 4, T 3 (row 1 all invalid) and the
    Pallas ``rnn_scan_fused`` (row 3) and ``rnn_scan`` (row 1, on the f32
    xw) in interpret mode, both in one jitted call."""
    B, T = 4, 3
    G = GATES[cell] * H
    rng = np.random.default_rng(H + 11 * len(cell))
    sd = H ** -0.5
    arrays = (rng.standard_normal((B, T, H)), sd * rng.standard_normal((H, G)),
              0.1 * rng.standard_normal((G,)), sd * rng.standard_normal((H, G)))
    m = rng.random((B, T)) < 0.75
    m[1] = False
    t = [torch.from_numpy(a.astype(np.float32)) for a in arrays]
    xw = t[0] @ t[1] + t[2]
    ops = dict(hin=t[0], wx=t[1], b=t[2], wh=t[3], m=torch.from_numpy(m),
               xw=xw)

    @jax.jit
    def both(hin, wx, b, wh, xw, jm):
        return (jax_scan_fused(cell, hin, wx, b, wh, jm),
                jax_scan(cell, xw, wh, jm))

    row3, row1 = both(*(jnp.asarray(v.numpy()) for v in t),
                      jnp.asarray(xw.numpy()), jnp.asarray(m))
    return ops, np.asarray(row3), np.asarray(row1)


@pytest.mark.parametrize("cell,H", [("lstm", 400), ("gru", 400),
                                    ("lstm", 402), ("gru", 402)])
def test_grid_model_and_plain_rows_match_the_pallas_forwards(cell, H):
    """At H 400 (Hp 400) and H 402 (zero-padded to Hp 416): the kernel's
    order (:func:`model_rows`) and the plain rows 3 and 1 in float32
    against the Pallas ops and against each other, atol 1e-5 (c_all, which
    the Pallas forwards do not return, model against plain); the
    all-invalid row's h_all and c_all exactly 0."""
    ops, row3, row1 = _pallas(cell, H)
    model = model_rows(cell, ops, R._padded_width(H))
    plain3 = R.rnn_scan_states(cell, ops["hin"] @ ops["wx"] + ops["b"],
                               ops["wh"], ops["m"], 1.0, True)
    plain1 = R.rnn_scan_states(cell, ops["xw"], ops["wh"], ops["m"], 1.0,
                               True)
    for (got, got_c), plain, want in ((model[3], plain3, row3),
                                      (model[1], plain1, row1)):
        ph, pc = (None if v is None else v.numpy() for v in plain)
        assert got.shape == want.shape == ph.shape
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **F32_TOL)
        np.testing.assert_allclose(ph, want, **F32_TOL)
        np.testing.assert_allclose(got, ph, **F32_TOL)
        assert not got[1].any() and not ph[1].any()
        if cell == "lstm":
            np.testing.assert_allclose(got_c, pc, **F32_TOL)
            assert not got_c[1].any()
