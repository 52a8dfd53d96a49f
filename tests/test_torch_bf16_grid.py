"""The bfloat16 backward past hidden 512 (``csrc/rnn_bwd_grid.cu``: the gates
recomputed by one bf16 GEMM, the carry's product spread over a cooperative
grid that holds W_h in bf16) on the CPU.

* The route: bf16 backwards at 512 < Hp <= 1520 take ``"grid"``, past it
  the CUDA cores; the bf16 forwards take the same route and float32 is as
  before.
* The picker (``ops/rnn.py _grid_size``, ``_grid_rows`` with the dtype)
  and the shared-memory mirror (``_grid_smem``) against the source's
  constants and count, and against a hand count at an H100's 232,448
  bytes and 132 SMs, from Hp 528 to the widest, 1520; the chunk dealing
  over a group's CTAs and warps.
* A CPU model of the kernel's order: the gates GEMM (xw + hw), the cell's
  backward per (row, unit), d_hw split into a bf16 hi and lo, and the
  carry's product over the all-gathered block in stages of 64 columns
  added in k order; its bits do not depend on the group or the rows. The
  model's rows 4 and 2 and the plain rows are held to ``jax.vjp`` of the
  Pallas ``rnn_scan_fused`` and ``rnn_scan`` (interpret mode, jitted) at
  Hp 528, reached as H 528 and as H 520 zero-padded, B 4, T 3, an
  all-invalid row included: gradients scaled by the reference's largest
  magnitude, atol 0.05 (the JAX bf16 bound).

The kernel itself is held to the plain versions on the card in
``tests/test_torch_kernels.py`` (``test_bf16_grid_*``).
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
from lfm_quant_tpu_torch.ops import rnn as R

GATES = {"lstm": 4, "gru": 3}
CSRC = Path(__file__).resolve().parents[1] / "lfm_quant_tpu_torch" / "csrc"
H100_SMEM = 232_448  # shared memory a block can use on an H100
H100_SMS = 132
BF = torch.bfloat16
WIDTHS = tuple(range(528, 1521, 16))
#: (cell, Hp) → (CTAs a group, rows a work item) at B 2048, one seed, by
#: hand: the fewest CTAs whose W_h rows (2 (8 NC (G Hp + 8)) bytes, NC =
#: ceil(Hp / 8 / n)) fit beside the two 64-row stages (2 * 2 * 2 * 64 *
#: 72 bytes) within 512 threads (NC <= 4 at 64 rows), 128 rows where NC <=
#: 2, they fit and 16 items fill the groups.
WANT = {("lstm", 528): (17, 64), ("gru", 528): (17, 64),
        ("lstm", 640): (20, 64), ("gru", 640): (20, 64),
        ("lstm", 1024): (64, 128), ("gru", 1024): (43, 64),
        ("lstm", 1520): (95, 64), ("gru", 1520): (95, 128)}
STAGE = 64  # d_hw columns a stage of the carry


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
                                    (520, "grid"), (528, "grid"),
                                    (1024, "grid"), (1520, "grid"),
                                    (1521, "simt"), (1536, "simt")])
def test_bf16_backward_route_past_512(H, want):
    """bf16 backwards at 512 < Hp <= 1520 run on the grid (H 513 and 520
    at Hp 528, zero-padded), the CUDA cores past it; the bf16 forwards
    take the same route (the grid forward, ``csrc/rnn_fwd_grid.cu``, to
    1520); float32 as before."""
    f32 = torch.float32
    assert R._mma_route(BF, H, "bwd") == want
    assert R._mma_route(BF, H) == want
    Hp = R._padded_width(H)
    assert R._mma_route(f32, H, "bwd") == (
        "tf32" if Hp <= R.TF32_MAX_WIDTH else "grid" if Hp <= 1024
        else "simt")


def test_source_constants_agree():
    """The wrapper's widest width, rows, threads, stages and units are the
    source's and the shared grid header's, its count the source's
    formula; the source takes the barrier and the launch from
    ``grid_common.cuh``, the GEMMs from ``cluster_gemm.cuh`` and the
    weight gradients and dhin from ``bf16_wgrad.cuh``."""
    src = (CSRC / "rnn_bwd_grid.cu").read_text()
    common = (CSRC / "grid_common.cuh").read_text()
    assert R.BF16_GRID_MAX_WIDTH == 1520
    assert f"constexpr int kMaxWidth = {R.BF16_GRID_MAX_WIDTH};" in src
    assert f"constexpr int kStageK = {R.GRID_STAGE_K};" in src
    assert f"constexpr int kStages = {R.GRID_STAGES};" in src
    assert f"constexpr int kMaxThreads = {R.GRID_MAX_THREADS};" in src
    assert f"constexpr int kUnits = {R.MMA_UNITS};" in common
    rows = re.search(r"if \(rows != (\d+) && rows != (\d+)\)", src)
    assert rows and tuple(map(int, rows.groups())) == R.GRID_ROWS
    assert ("  return 2 * ((size_t)kUnits * chunks_per_cta(H, n) * (G * H "
            "+ 8) +\n              (size_t)kStages * 2 * rows * (kStageK + "
            "8));") in src
    assert "return 32 * chunks_per_cta(H, n) * (rows / 16);" in common
    assert "cudaLaunchCooperativeKernel" in common
    assert "constexpr long long kSpinLimit = 1ll << 32;" in common
    for use in ("using lfm_grid::group_barrier;", "using lfm_bf16::split_bf16;",
                "lfm_cluster::launch_gemm<true>(h_all, wh",
                "lfm_bf16::launch_wgrad<CELL, HOIST>",
                "lfm_bf16::launch_dhin(dgx, wx, dx"):
        assert use in src
    # Two mma a k-step, hi then lo, into one accumulator; a stage's sum
    # added in k order.
    assert ("          mma_bf16(cacc, ahi, b);\n"
            "          mma_bf16(cacc, alo, b);") in src
    assert "for (int i = 0; i < 4; ++i) acc[i] += cacc[i];" in src


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_group_picker_on_an_h100(cell):
    """Every (cell, Hp) from 528 to 1520: the group is the fewest CTAs (at
    most 132) whose bf16 share of W_h fits 232,448 bytes beside the two
    64-row stages within 512 threads; rows 128 only where they are taken,
    fit and leave no group the card holds idle; the sizes of
    :data:`WANT`."""
    for Hp in WIDTHS:
        n = R._grid_size(cell, Hp, H100_SMEM, H100_SMS, BF)
        assert 1 <= n <= H100_SMS and R._grid_takes(Hp, n, 64, BF)
        assert R._grid_smem(cell, Hp, n, 64, BF) <= H100_SMEM
        for fewer in range(1, n):
            assert (not R._grid_takes(Hp, fewer, 64, BF)
                    or R._grid_smem(cell, Hp, fewer, 64, BF) > H100_SMEM)
        rows = R._grid_rows(cell, Hp, n, 2048, 1, H100_SMEM, H100_SMS, BF)
        assert R._grid_takes(Hp, n, rows, BF)
        assert R._grid_smem(cell, Hp, n, rows, BF) <= H100_SMEM
        if rows == 128:
            assert -(-2048 // 128) >= H100_SMS // n
        if (cell, Hp) in WANT:
            assert (n, rows) == WANT[cell, Hp], (cell, Hp, n, rows)


@pytest.mark.parametrize("cell,Hp,n,rows,want", [
    ("lstm", 528, 17, 64, 172_544), ("gru", 528, 17, 64, 138_752),
    ("lstm", 1024, 64, 128, 205_056), ("gru", 1024, 43, 64, 184_704),
    ("lstm", 1520, 95, 64, 231_680), ("gru", 1520, 95, 128, 219_904)])
def test_smem_count_by_hand(cell, Hp, n, rows, want):
    """The count, written out: the W_h rows of 8 ceil(Hp / 8 / n) units
    across G Hp + 8 columns and two stages of the hi and lo tiles [rows][64
    + 8], bf16; the LSTM's widest sits 768 bytes under an H100's limit."""
    G = GATES[cell]
    NC = -(-(Hp // 8) // n)
    assert R._grid_smem(cell, Hp, n, rows, BF) == 2 * (
        8 * NC * (G * Hp + 8) + 2 * 2 * rows * 72) == want
    assert R._grid_smem(cell, Hp, n, rows) != want  # float32's count


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_past_the_widest_is_refused(cell):
    """Past 1520 (Hp 1536) no shape is taken, the route is the CUDA cores
    and the picker raises naming the width: the LSTM's two chunks a CTA
    would take 233,728 bytes (its 192 chunks need two a CTA on 132). A
    card with too little shared memory raises too."""
    assert R._mma_route(BF, 1530, "bwd") == "simt"
    assert not any(R._grid_takes(1536, n, r, BF) for n in (64, 96, 132)
                   for r in R.GRID_ROWS)
    with pytest.raises(ValueError, match="hidden=1536"):
        R._grid_size(cell, 1536, H100_SMEM, H100_SMS, BF)
    with pytest.raises(ValueError, match="bfloat16 .* hidden=1520"):
        R._grid_size(cell, 1520, 150_000, H100_SMS, BF)
    assert 2 * (8 * 2 * (4 * 1536 + 8) + 2 * 2 * 64 * 72) > H100_SMEM


@pytest.mark.parametrize("Hp,n,rows", [(528, 17, 64), (640, 20, 64),
                                       (1024, 43, 64), (1520, 95, 128)])
def test_every_unit_and_row_is_owned_once(Hp, n, rows):
    """The chunk dealing of ``grid_common.cuh`` at the bf16 shapes: CTA j
    owns chunks [j W / n, (j + 1) W / n) (NC or NC - 1, never none), warp
    w chunk w % NC and rows 16 (w / NC) ..; lane (g, c) the rows g, g + 8
    and units 2c, 2c + 1 of its chunk: every (row, unit) of an item is one
    active thread's, within 512 threads."""
    W = Hp // 8
    NC = R._grid_chunks(Hp, n)
    nwarps = NC * rows // 16
    assert 32 * nwarps <= R.GRID_MAX_THREADS
    seen = np.zeros((rows, Hp), int)
    for j in range(n):
        w0 = j * W // n
        own = (j + 1) * W // n - w0
        assert own in (NC, NC - 1) and own >= 1
        for warp in range(nwarps):
            chunk, ra0 = warp % NC, (warp // NC) * 16
            if chunk >= own:
                continue
            g = np.arange(32) // 4
            u = (w0 + chunk) * 8 + 2 * (np.arange(32) % 4)
            for r in (ra0 + g, ra0 + g + 8):
                np.add.at(seen, (r, u), 1)
                np.add.at(seen, (r, u + 1), 1)
    assert (seen == 1).all()


# ---------------------------------------------------------------------------
# A CPU model of the kernel's order, against the Pallas backwards
# ---------------------------------------------------------------------------


def _bf16(a):
    """Rounded to bf16 (to nearest even, as ``__floats2bfloat162_rn``),
    as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        BF).float().numpy()


def _split(d):
    """d = hi + lo in bf16, as ``split_bf16`` splits it."""
    hi = _bf16(d)
    return hi, _bf16(d - hi)


def _carry(d_hw, w):
    """The carry's product for units with W_h rows ``w [U, G H]`` from the
    all-gathered ``d_hw [R, G H]``: d_hw split into hi and lo; per stage of
    64 columns one f32 accumulator (modelled: the exact products summed in
    float64, in k order, then rounded), each stage's sum added to the
    total in k order."""
    hi, lo = _split(d_hw)
    GH = d_hw.shape[1]
    acc = np.zeros((d_hw.shape[0], w.shape[0]), np.float32)
    for j0 in range(0, GH, STAGE):
        k = slice(j0, min(GH, j0 + STAGE))
        prod = (hi[:, k, None].astype(np.float64)
                + lo[:, k, None]) * w.T[None, k, :]
        acc = (acc + prod.sum(axis=1).astype(np.float32)).astype(np.float32)
    return acc


def _sigmoid(v):
    return (np.float32(1.0) / (np.float32(1.0) + np.exp(-v))).astype(
        np.float32)


def _cell_bwd(cell, a, dup, kp, c_t, c_prev, h_prev, dhc, dcc, fb=1.0):
    """``cell_bwd`` of csrc/tf32_common.cuh on f32 vectors → (dg, dhc,
    dcc): dg the G gate gradients (d_xw) and, for the GRU, dn r last."""
    f = np.float32
    dh_t = (dup + dhc).astype(f)
    dh_new = (kp * dh_t).astype(f)
    if cell == "lstm":
        ig, fg = _sigmoid(a[0]), _sigmoid((a[1] + f(fb)).astype(f))
        gg, og = np.tanh(a[2]), _sigmoid(a[3])
        tc = np.tanh(c_t)
        dc_tot = (kp * dcc + dh_new * og * (f(1) - tc * tc)).astype(f)
        dg = [dc_tot * gg * ig * (f(1) - ig),
              dc_tot * c_prev * fg * (f(1) - fg),
              dc_tot * ig * (f(1) - gg * gg),
              dh_new * tc * og * (f(1) - og)]
        return ([d.astype(f) for d in dg], ((f(1) - kp) * dh_t).astype(f),
                ((f(1) - kp) * dcc + dc_tot * fg).astype(f))
    z, rg, hn = _sigmoid(a[0]), _sigmoid(a[1]), a[3]
    n = np.tanh((a[2] + rg * hn).astype(f))
    dn_raw = (dh_new * (f(1) - z) * (f(1) - n * n)).astype(f)
    dg = [dh_new * (h_prev - n) * z * (f(1) - z),
          dn_raw * hn * rg * (f(1) - rg), dn_raw, dn_raw * rg]
    return ([d.astype(f) for d in dg],
            ((f(1) - kp) * dh_t + dh_new * z).astype(f), dcc)


def grid_model(cell, x, wh, m, h_all, c_all, dh):
    """The kernel's order on f32 numpy arrays holding bf16 values (x the
    f32 x side [B, T, G H]) → (d_xw, d_hw, h_prev): kernel 1 (every
    h_{t-1} @ W_h with f32 accumulation, added to x; the GRU's n slice
    apart), then kernel 2 in reverse time: the cell's backward per (row,
    unit) and (t > 0) the carry :func:`_carry` over all G H columns."""
    B, T, GH = x.shape
    G = GATES[cell]
    H = GH // G
    f = np.float32
    h_prev = np.concatenate([np.zeros((B, 1, H), f), h_all[:, :-1]], axis=1)
    hw = (h_prev.reshape(-1, H).astype(np.float64) @ wh).astype(f).reshape(
        B, T, GH)
    pre = (x + hw).astype(f)
    d_xw = np.zeros((B, T, GH), f)
    d_hw = np.zeros((B, T, GH), f)
    dhc = np.zeros((B, H), f)
    dcc = np.zeros((B, H), f)
    for t in reversed(range(T)):
        kp = m[:, t, None].astype(f)
        if cell == "lstm":
            a = np.split(pre[:, t], 4, axis=-1)
            c_prev = c_all[:, t - 1] if t > 0 else np.zeros((B, H), f)
            dg, dhc, dcc = _cell_bwd(cell, a, dh[:, t], kp, c_all[:, t],
                                     c_prev, None, dhc, dcc)
            d_xw[:, t] = d_hw[:, t] = np.concatenate(dg, axis=-1)
        else:
            a = np.split(pre[:, t], 3, axis=-1)
            a = a[:2] + [x[:, t, 2 * H:], hw[:, t, 2 * H:]]
            dg, dhc, dcc = _cell_bwd(cell, a, dh[:, t], kp, None, None,
                                     h_prev[:, t], dhc, dcc)
            d_xw[:, t] = np.concatenate(dg[:3], axis=-1)
            d_hw[:, t] = np.concatenate(dg[:2] + dg[3:], axis=-1)
        if t > 0:
            dhc = (dhc + _carry(d_hw[:, t], wh)).astype(f)
    return d_xw, d_hw, h_prev


def _wgrad(a, d):
    """A weight gradient as the kernels form it: d split into hi and lo,
    f32 sums (modelled in float64)."""
    hi, lo = _split(d.reshape(-1, d.shape[-1]))
    return (a.reshape(-1, a.shape[-1]).T.astype(np.float64)
            @ (hi.astype(np.float64) + lo)).astype(np.float32)


def model_rows(cell, ops, Hp):
    """Rows 4 and 2 by :func:`grid_model` at padded width ``Hp``: the
    operands padded per gate block (``padded_launch``'s rule, exact), the
    outputs sliced back. ``ops``: torch tensors at H (hin, wx, b, wh, m,
    dh, xw and the plain forwards' states)."""
    f = torch.float32
    G = GATES[cell]
    H = ops["wh"].shape[0]
    pad = (lambda t, k: R._pad_one(t, k, G, H, Hp).float().numpy())
    hin, wx, b, wh = (pad(ops[k], kind) for k, kind in
                      (("hin", "u"), ("wx", "w"), ("b", "g"), ("wh", "w")))
    m, dh = ops["m"].numpy(), pad(ops["dh"], "u")
    out = {}
    for row, x, (h, c) in (
            (4, (hin.astype(np.float64) @ wx + b).astype(np.float32),
             ops["fused_states"]),
            (2, pad(ops["xw"], "g"), ops["scan_states"])):
        h = pad(h, "u")
        c = None if c is None else pad(c, "u")
        d_xw, d_hw, h_prev = grid_model(cell, x, wh, m, h, c, dh)
        if row == 4:
            hi, lo = _split(d_xw)
            dhin = _bf16(((hi.astype(np.float64) + lo) @ wx.T).astype(
                np.float32))
            got = (dhin, _wgrad(hin, d_xw), d_xw.sum(axis=(0, 1)),
                   _wgrad(h_prev, d_hw))
            kinds = "uwgw"
        else:
            got, kinds = (_bf16(d_xw), _wgrad(h_prev, d_hw)), "gw"
        out[row] = [R._unpad_one(torch.from_numpy(np.ascontiguousarray(g)),
                                 k, G, H, Hp).to(f).numpy()
                    for g, k in zip(got, kinds)]
    return out


def _scaled_close(got, want, atol=0.05):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


@functools.lru_cache(maxsize=None)
def _pallas(cell, H):
    """Seeded bf16 operands at B 4, T 3 (row 1 all invalid), the plain
    forwards' states, and ``jax.vjp`` of the Pallas ``rnn_scan_fused``
    (row 4) and ``rnn_scan`` (row 2, on the bf16 xw) in interpret mode,
    both in one jitted call."""
    B, T = 4, 3
    G = GATES[cell] * H
    rng = np.random.default_rng(H + 5 * len(cell))
    sd = H ** -0.5
    arrays = (rng.standard_normal((B, T, H)), sd * rng.standard_normal((H, G)),
              0.1 * rng.standard_normal((G,)), sd * rng.standard_normal((H, G)))
    m = rng.random((B, T)) < 0.75
    m[1] = False
    dh = 0.1 * rng.standard_normal((B, T, H))
    t = [torch.from_numpy(a.astype(np.float32)).to(BF) for a in arrays]
    tm, tdh = torch.from_numpy(m), torch.from_numpy(dh.astype(np.float32)).to(BF)
    xw32 = t[0].float() @ t[1].float() + t[2].float()
    xw = xw32.to(BF)
    bf = lambda s: tuple(None if v is None else v.to(BF) for v in s)  # noqa
    ops = dict(hin=t[0], wx=t[1], b=t[2], wh=t[3], m=tm, dh=tdh, xw=xw,
               fused_states=bf(R.rnn_scan_states(cell, xw32, t[3], tm, 1.0,
                                                 True)),
               scan_states=bf(R.rnn_scan_states(cell, xw, t[3], tm, 1.0,
                                                True)))
    j = lambda v: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)  # noqa

    @jax.jit
    def both(hin, wx, b, wh, xw, jm, ct):
        row4 = jax.vjp(lambda *a: jax_scan_fused(cell, *a, jm),
                       hin, wx, b, wh)[1](ct)
        row2 = jax.vjp(lambda x, w: jax_scan(cell, x, w, jm), xw, wh)[1](ct)
        return row4, row2

    row4, row2 = both(*(j(v) for v in t), j(xw), jnp.asarray(m), j(tdh))
    f32 = (lambda gs: [np.asarray(g.astype(jnp.float32)) for g in gs])
    return ops, f32(row4), f32(row2)


@pytest.mark.parametrize("cell,H", [("lstm", 528), ("gru", 528),
                                    ("lstm", 520), ("gru", 520)])
def test_grid_model_and_plain_rows_match_the_pallas_backwards(cell, H):
    """At Hp 528 (H 528, and H 520 zero-padded to it): the kernel's order
    (:func:`model_rows`) and the plain rows 4 (dhin, dW_x, db, dW_h) and 2
    (dxw, dW_h) in bf16, against ``jax.vjp`` of the Pallas ops and against
    each other, scaled atol 0.05; the all-invalid row's dhin and dxw are
    0."""
    ops, row4, row2 = _pallas(cell, H)
    model = model_rows(cell, ops, 528)
    plain4 = R.rnn_scan_fused_bwd_reference(
        cell, ops["hin"], ops["wx"], ops["b"], ops["wh"], ops["m"],
        *ops["fused_states"], ops["dh"])
    plain2 = R.rnn_scan_bwd_reference(cell, ops["xw"], ops["wh"], ops["m"],
                                      *ops["scan_states"], ops["dh"])
    for got, plain, want in ((model[4], plain4, row4),
                             (model[2], plain2, row2)):
        assert len(got) == len(plain) == len(want)
        for g, p, w in zip(got, plain, want):
            p = p.float().numpy()
            assert np.isfinite(g).all() and g.shape == w.shape == p.shape
            _scaled_close(g, w)
            _scaled_close(p, w)
            _scaled_close(g, p)
        assert not got[0][1].any() and not plain[0][1].float().any()


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_carry_bits_depend_on_neither_group_nor_rows(cell):
    """Each (row, unit)'s carry is formed from the whole all-gathered row
    block in one fixed k order, so a CTA's units (any group's dealing) and
    a work item's rows (64 or 128, or the tail of B) give the bits of the
    whole product; the split is exact to bf16's 16 bits (hi + lo within
    2^-16 of d)."""
    rng = np.random.default_rng(7)
    Hp, G = 528, GATES[cell]
    d = rng.standard_normal((40, G * Hp)).astype(np.float32)
    w = _bf16(rng.standard_normal((Hp, G * Hp)) * Hp ** -0.5)
    hi, lo = _split(d)
    assert (np.abs(hi + lo - d) <= 2.0 ** -16 * np.abs(d)).all()
    whole = _carry(d, w)
    W = Hp // 8
    for n in (17, 33):
        for j in (0, n // 2, n - 1):
            units = slice(8 * (j * W // n), 8 * ((j + 1) * W // n))
            for rows in (slice(0, 16), slice(16, 40)):
                part = _carry(d[rows], w[units])
                assert np.array_equal(part, whole[rows, units])
