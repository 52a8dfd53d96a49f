"""Hidden widths off a multiple of 16 zero-padded onto the tensor-core
kernels' widths (``lfm_quant_tpu_torch/ops/rnn.py padded_launch``), held
to the JAX package on the CPU.

On the card the padding wraps the kernels' launchers; here it wraps their
plain versions, which run at the padded width Hp (12 → 16, 40 → 48) and
are sliced back to H. The same numpy inputs go through the JAX package's
Pallas ops (``rnn_scan_fused``, ``rnn_scan``; interpret mode on the CPU, as
``tests/test_pallas_rnn.py`` runs them): the forward, and ``jax.grad`` of
the sum of squares against the padded backward fed the same upstream
gradient, at the JAX tolerances (f32 atol 1e-5; bf16 atol/rtol 0.05 on h,
gradients scaled by their largest magnitude at atol 0.05). Seed-stacked
operands (S = 2, one operand shared by both seeds) against ``jax.vmap``.
At the padded width the padded units' states and every gradient in a
padded place are exactly 0, and the per-gate-block pad of every operand
round-trips exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfm_quant_tpu.ops.pallas_rnn import rnn_scan as jax_scan
from lfm_quant_tpu.ops.pallas_rnn import rnn_scan_fused as jax_scan_fused
from lfm_quant_tpu_torch.ops import rnn as R

GATES = {"lstm": 4, "gru": 3}
ATOL = {"f32": 1e-5, "bf16": 0.05}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(cell, S, B, T, H, seed):
    """numpy f32 hin, W_x, b, W_h and m, each ``[S, ...]``."""
    rng = np.random.default_rng(seed)
    G = GATES[cell] * H
    sd = 1.0 / np.sqrt(H)
    hin = rng.standard_normal((S, B, T, H)).astype(np.float32)
    wx = (sd * rng.standard_normal((S, H, G))).astype(np.float32)
    b = (0.1 * rng.standard_normal((S, G))).astype(np.float32)
    wh = (sd * rng.standard_normal((S, H, G))).astype(np.float32)
    m = (rng.random((S, B, T)) < 0.75).astype(np.float32)
    m[:, B // 2] = 0.0  # an all-invalid row
    return hin, wx, b, wh, m


def _plain_fwd(cell, xw, wh, m, forget_bias, save_c):
    """The hoisted forward's plain version, seed by seed when stacked."""
    if xw.dim() == 4:
        return R._over_seeds(
            lambda *a: R.rnn_scan_states(cell, *a, forget_bias, save_c),
            R._seed_extent(xw, wh, m), xw, wh, m)
    return R.rnn_scan_states(cell, xw, wh, m, forget_bias, save_c)


def _plain_bwd(cell, xw, wh, m, h, c, dh, forget_bias):
    """The hoisted backward's plain version, seed by seed when stacked."""
    if xw.dim() == 4:
        return R._over_seeds(
            lambda *a: R.rnn_scan_bwd_reference(cell, *a, forget_bias),
            R._seed_extent(xw, wh, m, h, c, dh), xw, wh, m, h, c, dh)
    return R.rnn_scan_bwd_reference(cell, xw, wh, m, h, c, dh, forget_bias)


PLAIN = {
    "fused_fwd": lambda cell, hin, wx, b, wh, m, fb, save_c:
        R._fused_states(cell, hin, wx, b, wh, m, fb, save_c),
    "fwd": _plain_fwd,
    "fused_bwd": R.rnn_scan_fused_bwd_reference,
    "bwd": _plain_bwd,
}


def _spy(launch, seen):
    """``launch`` recording its outputs (at the padded width) in ``seen``."""
    def run(*args, **kw):
        out = launch(*args, **kw)
        seen.extend(out)
        return out
    return run


def _padded_places_are_zero(t, kind, G, H):
    """Every place of an output at Hp that the pad added holds 0."""
    if t is None:
        return
    t = t.float()
    if kind == "w":
        assert not t[..., H:, :].any()
    if kind in "gw":
        t = t.unflatten(-1, (G, -1))
    assert not t[..., H:].any()


def _scaled_close(got, want, dtype_name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale,
                               atol=ATOL[dtype_name], rtol=0.0)


@pytest.mark.parametrize("seeds", ["one", "two, one shared"])
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("hoisted", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("H", [12, 40])
def test_padded_plain_version_matches_jax(H, cell, hoisted, dtype_name,
                                          seeds):
    """The padded route's forward and backward, through the plain versions,
    against the Pallas op and ``jax.grad`` (``jax.vmap`` for two seeds,
    W_x (fused) or W_h (hoisted) of seed extent 1 and ``in_axes=None``)."""
    B, T = 9, 5
    S = 1 if seeds == "one" else 2
    G = GATES[cell]
    Hp = R._padded_width(H)
    assert Hp == {12: 16, 40: 48}[H] and R._mma_route(torch.float32, H) \
        == "tf32" and R._mma_route(torch.bfloat16, H) == "mma"
    hin, wx, b, wh, m = _inputs(cell, S, B, T, H, seed=3 * H + S)
    if hoisted:
        xw = (np.einsum("sbth,shg->sbtg", hin, wx)
              + b[:, None, None]).astype(np.float32)
        ops, shared = [xw, wh, m], 1
        form = "fwd"
    else:
        ops, shared = [hin, wx, b, wh, m], 1
        form = "fused_fwd"
    if S > 1:
        ops[shared] = ops[shared][:1]
    else:
        ops = [a[0] for a in ops]
    td, jd = DTYPES[dtype_name]
    t_ops = [torch.from_numpy(a) for a in ops]
    t_ops = [t.to(td) for t in t_ops[:-1]] + [t_ops[-1]]

    seen = []
    h, c = R.padded_launch(_spy(PLAIN[form], seen), form)(
        cell, *t_ops, 1.0, True)
    assert h.shape == hin.shape[(1 if S == 1 else 0):] and h.dtype == td
    for t in seen:  # the padded units' h and c stay exactly 0
        _padded_places_are_zero(t, "u", G, H)
        assert t is None or t.shape[-1] == Hp

    # Upstream gradient of sum(h^2), as jax.grad hands it to the op.
    dh = (2.0 * h.float()).to(td)
    bwd = "bwd" if hoisted else "fused_bwd"
    seen = []
    grads = R.padded_launch(_spy(PLAIN[bwd], seen), bwd)(
        cell, *t_ops, h, c, dh, 1.0)
    for t, kind in zip(seen, R._PAD_FORMS[bwd][1]):
        _padded_places_are_zero(t, kind, G, H)

    # jax.vmap takes the shared operand without its seed axis.
    j_ops = [jnp.asarray(a[0] if S > 1 and i == shared else a).astype(jd)
             for i, a in enumerate(ops[:-1])]
    jm = jnp.asarray(ops[-1])
    op = jax_scan if hoisted else jax_scan_fused

    def fwd(*a):
        return op(cell, *a[:-1], a[-1].astype(a[0].dtype), block_b=8)

    def loss(*a):
        return (fwd(*a).astype(jnp.float32) ** 2).sum()

    argnums = tuple(range(len(j_ops)))
    if S > 1:
        axes = tuple(None if i == shared else 0 for i in range(len(ops)))
        want_h = jax.vmap(fwd, in_axes=axes)(*j_ops, jm)
        want = jax.jit(jax.vmap(jax.grad(loss, argnums=argnums),
                                in_axes=axes))(*j_ops, jm)
    else:
        want_h = fwd(*j_ops, jm)
        want = jax.jit(jax.grad(loss, argnums=argnums))(*j_ops, jm)
    np.testing.assert_allclose(
        h.float().numpy(), np.asarray(want_h.astype(jnp.float32)),
        atol=ATOL[dtype_name], rtol=0.0 if dtype_name == "f32" else 0.05)
    assert not h[..., B // 2, :, :].float().any()
    for g, w in zip(grads, want):
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape
        for s in range(S):
            _scaled_close(g[s] if S > 1 else g, w[s] if S > 1 else w,
                          dtype_name)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("H", [12, 40, 120])
def test_gate_block_pad_round_trips(H, cell, stacked):
    """Each kind of operand (``[.., H]``, ``[.., G H]``, ``[.., H, G H]``)
    padded per gate block to Hp: every real value in its place (gate q's H
    columns first in its Hp), zeros in the rest, and sliced back exactly;
    m and the "-" kind pass as they are."""
    G = GATES[cell]
    Hp = R._padded_width(H)
    lead = (2,) if stacked else ()
    rng = np.random.default_rng(H + G)
    shapes = {"u": lead + (3, 4, H), "g": lead + (3, G * H),
              "w": lead + (H, G * H)}
    for kind, shape in shapes.items():
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        p = R._pad_one(t, kind, G, H, Hp)
        if kind == "u":
            assert p.shape == shape[:-1] + (Hp,)
            assert torch.equal(p[..., :H], t)
        else:
            rows = (Hp,) if kind == "w" else ()
            assert p.shape == shape[:-1 - len(rows)] + rows + (G * Hp,)
            blocks = p.unflatten(-1, (G, Hp))
            real = blocks[..., :H, :, :H] if kind == "w" else \
                blocks[..., :H]
            assert torch.equal(real, t.unflatten(-1, (G, H)))
        _padded_places_are_zero(p, kind, G, H)
        back = R._unpad_one(p, kind, G, H, Hp)
        assert back.is_contiguous() and torch.equal(back, t)
    m = torch.ones(3, 4, dtype=torch.bool)
    assert R._pad_one(m, "m", G, H, Hp) is m
    assert R._pad_one(m, "-", G, H, Hp) is m


def test_padding_leaves_the_tensor_core_widths_alone():
    """At H = Hp the padded launch hands the launcher the operands
    themselves, and its outputs back as they are."""
    calls = []
    ops = [torch.zeros(2, 3, 4 * 32), torch.zeros(32, 4 * 32),
           torch.zeros(2, 3)]

    def launch(cell, *a):
        calls.append(a)
        return a[0], a[1]

    out = R.padded_launch(launch, "fwd")("lstm", *ops, 1.0, True)
    assert all(x is y for x, y in zip(calls[0][:3], ops))
    assert out[0] is ops[0] and out[1] is ops[1]
