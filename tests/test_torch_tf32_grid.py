"""The float32 backward past hidden 384 (``csrc/rnn_bwd_tf32_grid.cu``: the
gates recomputed by one 3xTF32 GEMM, the carry's product spread over a
cooperative grid that holds W_h) on the CPU, and the plain versions it is
held to on the card against the Pallas backwards at H 400.

* The route: float32 backwards at 384 < Hp <= 1024 take ``"grid"``, past
  it the CUDA cores; the forwards and every bf16 route as before.
* The picker (``ops/rnn.py _grid_size``, ``_grid_rows``) and the
  shared-memory mirror (``_grid_smem``) against the source's constants and
  count, every (cell, Hp) from 400 to 1024 fitting an H100's 232,448 bytes
  and 132 SMs; the dealing of units and rows over a group's CTAs and
  warps.
* A numpy model of the kernel's order in 3xTF32 arithmetic (``mma_f32`` of
  ``tests/test_torch_tf32.py``): the gates GEMM (chains of 32 of k, xw +
  hw), then per reverse step the cell's backward and the all-gathered
  carry's product in its fixed k order (chains of 64), held to
  ``jax.vjp`` of the Pallas ``rnn_scan_fused`` and ``rnn_scan``
  (interpret mode) at H 400, B 4, T 3, an all-invalid row included:
  gradients scaled by the reference's largest magnitude, atol 1e-5 (the
  JAX f32 bound); the plain rows 4 and 2 held to the same references.

The kernel itself is held to the plain versions on the card in
``tests/test_torch_kernels.py`` (``test_grid_bwd_*``).
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
from test_torch_tf32 import mma_f32

GATES = {"lstm": 4, "gru": 3}
SRC = (Path(__file__).resolve().parents[1] / "lfm_quant_tpu_torch" / "csrc"
       / "rnn_bwd_tf32_grid.cu")
H100_SMEM = 232_448  # shared memory a block can use on an H100
H100_SMS = 132
WIDTHS = tuple(range(400, 1025, 16))
#: (cell, Hp) → (CTAs a group, rows a work item) at B 2048, one seed.
WANT = {("lstm", 400): (17, 64), ("lstm", 432): (18, 64),
        ("lstm", 640): (40, 64), ("lstm", 768): (48, 64),
        ("lstm", 1024): (128, 128), ("gru", 400): (13, 64),
        ("gru", 640): (27, 64), ("gru", 768): (48, 128),
        ("gru", 1024): (64, 64)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# The route, the picker and the dealing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H,want", [(176, "tf32"), (177, "grid"),
                                    (192, "grid"), (384, "grid"),
                                    (385, "grid"),
                                    (400, "grid"), (420, "grid"),
                                    (432, "grid"), (640, "grid"),
                                    (1024, "grid"), (1025, "simt"),
                                    (1040, "simt")])
def test_float32_backward_route_past_384(H, want):
    """float32 backwards at 176 < Hp <= 1024 run on the grid kernel (H 420
    at Hp 432, zero-padded; from 192 to 384 too since the card timed it
    faster than the 3xTF32 cluster there), the cluster up to 176, the
    CUDA cores past 1024; the float32 forwards run on the float32 grid forward to
    1024 (``csrc/rnn_fwd_tf32_grid.cu``) and on the CUDA cores past it;
    bf16 runs on the cluster to 512 both ways and past it on the bf16
    grids, forward and backward."""
    f32, bf = torch.float32, torch.bfloat16
    assert R._mma_route(f32, H, "bwd") == want
    assert R._mma_route(f32, H) == ("simt" if want == "simt" else "grid")
    small = R._padded_width(H) <= R.CLUSTER_MAX_WIDTH
    assert R._mma_route(bf, H) == ("cluster" if small else "grid")
    assert R._mma_route(bf, H, "bwd") == ("cluster" if small else "grid")


def test_source_constants_agree():
    """The wrapper's widths, rows, thread limit, stages and units are the
    source's (the units and threads a CTA in ``grid_common.cuh``, shared
    with the bf16 grid backward), its shared-memory count is the source's
    formula, and the source takes the gates GEMM, the cell and the weight
    gradients from the shared header."""
    text = SRC.read_text() + (SRC.parent / "grid_common.cuh").read_text()
    assert f"constexpr int kMaxWidth = {R.GRID_MAX_WIDTH};" in text
    assert f"constexpr int kStageK = {R.GRID_STAGE_K};" in text
    assert f"constexpr int kStages = {R.GRID_STAGES};" in text
    assert f"constexpr int kMaxThreads = {R.GRID_MAX_THREADS};" in text
    assert f"constexpr int kUnits = {R.MMA_UNITS};" in text
    assert "if (H <= 128 || H > kMaxWidth" in text
    rows = re.search(r"if \(rows != (\d+) && rows != (\d+)\)", text)
    assert rows and tuple(map(int, rows.groups())) == R.GRID_ROWS
    assert ("  return 4 * ((size_t)kUnits * chunks_per_cta(H, n) * (G * H "
            "+ 4) +\n              (size_t)kStages * rows * (kStageK + 4));") \
        in text
    assert "return 32 * chunks_per_cta(H, n) * (rows / 16);" in text
    for name in ("cell_bwd", "rnn_bwd_tf32_wgrad_kernel",
                 "rnn_bwd_tf32_slices_kernel", "launch_gemm"):
        assert f"using lfm_tf32::{name};" in text
    assert "launch_gemm<false, true>(h_all, wh" in text
    assert "cudaLaunchCooperativeKernel" in text


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_group_picker_on_an_h100(cell):
    """Every (cell, Hp) from 400 to 1024: the group is the fewest CTAs (at
    most 132) whose share of W_h fits 232,448 bytes beside the two 64-row
    stages within 512 threads, rows 128 only where they are taken, fit and
    leave no group the card holds idle, and the sizes written out above."""
    for Hp in WIDTHS:
        n = R._grid_size(cell, Hp, H100_SMEM, H100_SMS)
        assert 1 <= n <= H100_SMS and R._grid_takes(Hp, n, 64)
        assert R._grid_smem(cell, Hp, n, 64) <= H100_SMEM
        for fewer in range(1, n):
            assert (not R._grid_takes(Hp, fewer, 64)
                    or R._grid_smem(cell, Hp, fewer, 64) > H100_SMEM)
        rows = R._grid_rows(cell, Hp, n, 2048, 1, H100_SMEM, H100_SMS)
        assert R._grid_takes(Hp, n, rows)
        assert R._grid_smem(cell, Hp, n, rows) <= H100_SMEM
        if rows == 128:
            assert -(-2048 // 128) >= H100_SMS // n
        if (cell, Hp) in WANT:
            assert (n, rows) == WANT[cell, Hp], (cell, Hp, n, rows)
    # Few rows: 64 where 128 would leave groups idle.
    assert R._grid_rows("lstm", 1024, 128, 2048, 1, H100_SMEM, 132) == 128
    assert R._grid_rows("gru", 768, 48, 100, 1, H100_SMEM, H100_SMS) == 64


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_a_width_or_card_past_the_kernel_is_refused(cell):
    """Past kMaxWidth and at 128 no shape is taken and the picker raises
    naming the width; so does a card whose shared memory or SMs hold no
    group at 1024 (the LSTM's 8 units take 131,200 bytes; a group is 128
    CTAs). Hp 384 is taken (timed beside the cluster form) but not
    routed."""
    assert R._grid_takes(384, R._grid_size(cell, 384, H100_SMEM, H100_SMS),
                         64)
    for Hp in (128, 1040):
        assert not any(R._grid_takes(Hp, n, r) for n in (1, 13, 64)
                       for r in R.GRID_ROWS)
        with pytest.raises(ValueError, match=f"hidden={Hp}"):
            R._grid_size(cell, Hp, H100_SMEM, H100_SMS)
    with pytest.raises(ValueError, match="hidden=1024"):
        R._grid_size(cell, 1024, 100_000, H100_SMS)
    if cell == "lstm":
        with pytest.raises(ValueError, match="hidden=1024"):
            R._grid_size(cell, 1024, H100_SMEM, 114)


@pytest.mark.parametrize("cell,Hp,n,rows", [
    ("lstm", 400, 17, 64), ("gru", 400, 13, 64), ("lstm", 432, 18, 64),
    ("lstm", 640, 40, 64), ("gru", 1024, 64, 64), ("lstm", 1024, 128, 128)])
def test_smem_count_by_hand(cell, Hp, n, rows):
    """The count, written out: the W_h rows of 8 ceil(Hp / 8 / n) units
    across G Hp + 4 columns and two stages of [rows][64 + 4], f32."""
    G = GATES[cell]
    NC = -(-(Hp // 8) // n)
    assert R._grid_smem(cell, Hp, n, rows) == 4 * (
        8 * NC * (G * Hp + 4) + 2 * rows * 68)
    assert R._grid_smem("lstm", 400, 17, 64) == 188_800
    assert R._grid_smem("lstm", 400, 13, 64) > H100_SMEM  # 4 chunks


@pytest.mark.parametrize("Hp,n,rows", [(400, 13, 64), (432, 18, 64),
                                       (640, 40, 128), (1024, 128, 128),
                                       (1024, 64, 64), (400, 50, 64)])
def test_every_unit_and_row_is_owned_once(Hp, n, rows):
    """The kernel's dealing, by its index arithmetic: CTA j of a group owns
    chunks [j W / n, (j + 1) W / n) (NC or NC - 1 of them, never none),
    warp w chunk w % NC and rows 16 (w / NC) ..; lane (g, c) of an active
    warp the rows g, g + 8 and units 2c, 2c + 1 of its chunk. Over the
    group every (row, unit) of an item is one active thread's, and the
    threads are the source's count."""
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
            for lane in range(32):
                g, c = lane // 4, lane % 4
                u = (w0 + chunk) * 8 + 2 * c
                for r in (ra0 + g, ra0 + g + 8):
                    seen[r, u:u + 2] += 1
    assert (seen == 1).all()


def test_every_ctas_barriers_are_the_groups():
    """Each CTA of a group walks the same items (item = group + k groups
    over S ceil(B / rows)) and meets T - 1 barriers an item (none after
    t = 0), so the counter reaches n per barrier in every CTA's order;
    the seed of an item is item // ceil(B / rows), whatever the group."""
    S, B, T, rows, groups = 3, 2048, 60, 128, 3
    nblk = -(-B // rows)
    items = S * nblk
    walked = [list(range(g, items, groups)) for g in range(groups)]
    assert sorted(i for w in walked for i in w) == list(range(items))
    barriers = [len(w) * (T - 1) for w in walked]
    assert max(barriers) - min(barriers) <= T - 1
    assert {i // nblk for i in walked[0]} == set(range(S))


# ---------------------------------------------------------------------------
# A numpy model of the kernel's order, against the Pallas backwards
# ---------------------------------------------------------------------------


def _sigmoid(v):
    return (np.float32(1.0) / (np.float32(1.0) + np.exp(-v))).astype(
        np.float32)


def _cell_bwd(cell, a, dup, kp, c_t, c_prev, h_prev, dhc, dcc, fb=1.0):
    """``cell_bwd`` of csrc/tf32_common.cuh on f32 vectors → (dg, dhc,
    dcc): dg the G gate gradients (d_xw) and, for the GRU, dn r (d_hw's n
    slice) last; the carries but for the carry's product."""
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


def _chained(a, b, chain):
    """``a @ b`` in 3xTF32 as a kernel forms it: chains of ``chain`` of k,
    each by ``mma_f32``, added in f32 in k order."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], chain):
        acc = (acc + mma_f32(a[:, k0:k0 + chain],
                             b[k0:k0 + chain].copy())).astype(np.float32)
    return acc


def grid_model(cell, xw, wh, m, h_all, c_all, dh):
    """The kernel's order on float32 ``[B, T, .]`` numpy arrays → (d_xw,
    d_hw, h_prev): kernel 1 (every h_{t-1} @ W_h in chains of 32, the
    GEMM's stage, added to xw; the GRU's n slice apart), then kernel 2 in
    reverse time: the cell's backward per (row, unit), and (t > 0) the
    carry d_hw_t @ W_h^T over all G H columns in chains of 64."""
    B, T, GH = xw.shape
    G = GATES[cell]
    H = GH // G
    f = np.float32
    h_prev = np.concatenate([np.zeros((B, 1, H), f), h_all[:, :-1]], axis=1)
    hw = _chained(h_prev.reshape(-1, H), wh, 32).reshape(B, T, GH)
    pre = (xw + hw).astype(f)
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
            xz, xr, xn = np.split(xw[:, t], 3, axis=-1)
            hz, hr, hn = np.split(hw[:, t], 3, axis=-1)
            a = [(xz + hz).astype(f), (xr + hr).astype(f), xn, hn]
            dg, dhc, dcc = _cell_bwd(cell, a, dh[:, t], kp, None, None,
                                     h_prev[:, t], dhc, dcc)
            d_xw[:, t] = np.concatenate(dg[:3], axis=-1)
            d_hw[:, t] = np.concatenate(dg[:2] + dg[3:], axis=-1)
        if t > 0:
            dhc = (dhc + _chained(d_hw[:, t], wh.T.copy(), 64)).astype(f)
    return d_xw, d_hw, h_prev


def _scaled_close(got, want, atol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


@functools.lru_cache(maxsize=None)
def _pallas(cell, H=400):
    """Seeded operands at B 4, T 3 (row 1 all invalid), the plain forward's
    states, and ``jax.vjp`` of the Pallas ``rnn_scan_fused`` (row 4) and
    ``rnn_scan`` (row 2, on the same xw) in interpret mode, both in one
    jitted call (the eager values, in a third of the time)."""
    B, T = 4, 3
    G = GATES[cell] * H
    rng = np.random.default_rng(H + 17 * len(cell))
    sd = H ** -0.5
    hin = rng.standard_normal((B, T, H)).astype(np.float32)
    wx = (sd * rng.standard_normal((H, G))).astype(np.float32)
    b = (0.1 * rng.standard_normal((G,))).astype(np.float32)
    wh = (sd * rng.standard_normal((H, G))).astype(np.float32)
    m = rng.random((B, T)) < 0.75
    m[1] = False
    dh = (0.1 * rng.standard_normal((B, T, H))).astype(np.float32)
    t = [torch.from_numpy(a) for a in (hin, wx, b, wh)]
    xw = t[0] @ t[1] + t[2]
    hs, cs = R.rnn_scan_states(cell, xw, t[3], torch.from_numpy(m), 1.0, True)
    j = [jnp.asarray(a) for a in (hin, wx, b, wh)]
    jm, jdh = jnp.asarray(m), jnp.asarray(dh)

    @jax.jit
    def both(hin, wx, b, wh, xw, m, ct):
        row4 = jax.vjp(lambda *a: jax_scan_fused(cell, *a, m),
                       hin, wx, b, wh)[1](ct)
        row2 = jax.vjp(lambda x, w: jax_scan(cell, x, w, m), xw, wh)[1](ct)
        return row4, row2

    row4, row2 = both(*j, jnp.asarray(xw.numpy()), jm, jdh)
    row4, row2 = ([np.asarray(g) for g in r] for r in (row4, row2))
    return (dict(hin=hin, wx=wx, b=b, wh=wh, m=m, dh=dh, xw=xw.numpy(),
                 h=hs.numpy(), c=None if cs is None else cs.numpy()),
            row4, row2)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_grid_model_matches_the_pallas_backwards_at_400(cell):
    """The kernel's order in 3xTF32 (:func:`grid_model`), its weight
    gradients and dhin as f32 products of its d_xw and d_hw, against
    ``jax.vjp`` of the Pallas ops at H 400: rows 4 (dhin, dW_x, db, dW_h)
    and 2 (dxw, dW_h), scaled atol 1e-5; the all-invalid row's gradients
    are 0."""
    ops, row4, row2 = _pallas(cell)
    H = ops["wh"].shape[0]
    d_xw, d_hw, h_prev = grid_model(cell, ops["xw"], ops["wh"], ops["m"],
                                    ops["h"], ops["c"], ops["dh"])
    assert np.isfinite(d_xw).all() and np.isfinite(d_hw).all()
    flat = (lambda a: a.reshape(-1, a.shape[-1]))
    dw_h = flat(h_prev).T @ flat(d_hw)
    got4 = (d_xw @ ops["wx"].T, flat(ops["hin"]).T @ flat(d_xw),
            d_xw.sum(axis=(0, 1)), dw_h)
    for g, w in zip(got4, row4):
        _scaled_close(g, w)
    for g, w in zip((d_xw, dw_h), row2):
        _scaled_close(g, w)
    assert not got4[0][1].any() and not d_xw[1].any()
    assert d_hw.shape[-1] == GATES[cell] * H


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_plain_rows_match_the_pallas_backwards_at_400(cell):
    """Rows 4 and 2's plain versions in float32 (what the kernel is held to
    on the card), on the plain forward's states, against the same
    ``jax.vjp`` at H 400: scaled atol 1e-5, the all-invalid row 0."""
    ops, row4, row2 = _pallas(cell)
    t = {k: None if v is None else torch.from_numpy(np.asarray(v))
         for k, v in ops.items()}
    got = R.rnn_scan_fused_bwd_reference(cell, t["hin"], t["wx"], t["b"],
                                         t["wh"], t["m"], t["h"], t["c"],
                                         t["dh"])
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, row4):
        assert torch.isfinite(g).all()
        _scaled_close(g.numpy(), w)
    assert not got[0][1].any()
    got = R.rnn_scan_bwd_reference(cell, t["xw"], t["wh"], t["m"], t["h"],
                                   t["c"], t["dh"])
    for g, w in zip(got, row2):
        assert torch.isfinite(g).all()
        _scaled_close(g.numpy(), w)
    assert not got[0][1].any()
