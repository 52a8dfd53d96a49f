"""Gradients of the port's recurrence against ``jax.grad`` of the JAX
package's Pallas kernels.

The same numpy inputs go through ``lfm_quant_tpu.ops.pallas_rnn``
``rnn_scan_fused`` / ``rnn_scan`` (their ``custom_vjp`` backward kernels,
in Pallas interpret mode on the CPU, as ``tests/test_pallas_rnn.py`` runs
them) and the port's ``rnn_scan_fused`` / ``rnn_scan`` (on the CPU their
autograd Functions run the plain backward formulas). Shapes are those of
``tests/test_pallas_rnn.py``: B 9, T 5, H 8, and B 21 across several
batch blocks with padded rows. Tolerances, as there: gradients scaled by
the reference's largest magnitude, f32 atol 1e-5; bf16 atol 0.05.

The plain backward formulas are also held to torch autograd of the plain
forward (f32), which shares no code with them.

The seed-stacked op (``hin [S, B, T, H]`` with per-seed weights, the seed
ensemble's form) is held to ``jax.vmap`` of the JAX op, forward and
``jax.jit(jax.vmap(jax.grad(...)))`` as ``tests/test_pallas_rnn.py`` runs
it (the Pallas ``custom_vmap`` rules in interpret mode), with ``m``
per seed and shared by every seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfm_quant_tpu.ops.pallas_rnn import rnn_scan as jax_scan
from lfm_quant_tpu.ops.pallas_rnn import rnn_scan_fused as jax_scan_fused
from lfm_quant_tpu_torch.ops.rnn import (
    rnn_scan,
    rnn_scan_bwd_reference,
    rnn_scan_fused,
    rnn_scan_fused_bwd_reference,
    rnn_scan_fused_reference,
    rnn_scan_reference,
    rnn_scan_states,
)

GATES = {"lstm": 4, "gru": 3}
ATOL = {"f32": 1e-5, "bf16": 0.05}


def _inputs(cell, B, T, H, seed):
    rng = np.random.default_rng(seed)
    G = GATES[cell] * H
    hin = rng.standard_normal((B, T, H)).astype(np.float32)
    wx = (0.3 * rng.standard_normal((H, G))).astype(np.float32)
    b = (0.1 * rng.standard_normal((G,))).astype(np.float32)
    wh = (0.3 * rng.standard_normal((H, G))).astype(np.float32)
    m = (rng.random((B, T)) < 0.75).astype(np.float32)
    m[B // 2] = 0.0  # an all-invalid row
    return hin, wx, b, wh, m


def _scaled_close(got, want, dtype_name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale,
                               atol=ATOL[dtype_name], rtol=0.0)


def _torch_grads(fn, arrays, dtype):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True)
              for a in arrays]
    out = fn(*leaves)
    (out.float() ** 2).sum().backward()
    return [t.grad.float().numpy() for t in leaves], out


def _jax_grads(fn, arrays, dtype):
    ja = [jnp.asarray(a).astype(dtype) for a in arrays]

    def loss(*xs):
        return (fn(*xs).astype(jnp.float32) ** 2).sum()

    g = jax.jit(jax.grad(loss, argnums=tuple(range(len(ja)))))(*ja)
    return [np.asarray(x.astype(jnp.float32)) for x in g]


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("B,T,H", [(9, 5, 8), (21, 5, 8)])
def test_fused_gradients_match_jax(cell, dtype_name, B, T, H):
    """Row 4: dhin, dW_x, db, dW_h of the fused op, in the operands'
    types, against jax.grad through _fused_bwd_call (block_b 8, so B 21
    runs three batch blocks with three padded rows)."""
    hin, wx, b, wh, m = _inputs(cell, B, T, H, seed=12 + B)
    td = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    jd = jnp.bfloat16 if dtype_name == "bf16" else jnp.float32
    mt = torch.from_numpy(m)
    got, _ = _torch_grads(
        lambda *a: rnn_scan_fused(cell, *a, mt), (hin, wx, b, wh), td)
    want = _jax_grads(
        lambda *a: jax_scan_fused(cell, *a, jnp.asarray(m).astype(a[0].dtype),
                                  block_b=8),
        (hin, wx, b, wh), jd)
    for g, w in zip(got, want):
        _scaled_close(g, w, dtype_name)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_fused_gradients_at_tensor_core_width_match_jax(cell):
    """bf16 at H = 16, a width whose backward takes the tensor cores on
    the card (``ops/rnn.py _mma_route``): the plain backward those
    kernels are held to there, through ``_FusedScan`` on the CPU, against
    jax.grad through the Pallas fused backward, scaled atol 0.05."""
    from lfm_quant_tpu_torch.ops.rnn import _mma_route

    assert _mma_route(torch.bfloat16, 16) == "mma"
    hin, wx, b, wh, m = _inputs(cell, 9, 5, 16, seed=70)
    wx, wh = wx / np.sqrt(2.0), wh / np.sqrt(2.0)
    mt = torch.from_numpy(m)
    got, _ = _torch_grads(
        lambda *a: rnn_scan_fused(cell, *a, mt), (hin, wx, b, wh),
        torch.bfloat16)
    want = _jax_grads(
        lambda *a: jax_scan_fused(cell, *a, jnp.asarray(m).astype(a[0].dtype),
                                  block_b=8),
        (hin, wx, b, wh), jnp.bfloat16)
    for g, w in zip(got, want):
        _scaled_close(g, w, "bf16")


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("B,T,H", [(9, 5, 8), (21, 5, 8)])
def test_hoisted_gradients_match_jax(cell, dtype_name, B, T, H):
    """Row 2: dxw and dW_h of the recurrence over a hoisted projection,
    against jax.grad through _bwd_call."""
    hin, wx, b, wh, m = _inputs(cell, B, T, H, seed=40 + B)
    xw = (hin @ wx + b).astype(np.float32)
    td = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    jd = jnp.bfloat16 if dtype_name == "bf16" else jnp.float32
    mt = torch.from_numpy(m)
    got, out = _torch_grads(lambda x, w: rnn_scan(cell, x, w, mt),
                            (xw, wh), td)
    assert out.dtype == td and out.shape == (B, T, H)
    want = _jax_grads(
        lambda x, w: jax_scan(cell, x, w, jnp.asarray(m).astype(x.dtype),
                              block_b=8),
        (xw, wh), jd)
    for g, w in zip(got, want):
        _scaled_close(g, w, dtype_name)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_hoisted_gradients_at_tensor_core_width_match_jax(cell):
    """bf16 at H = 16, a width whose hoisted backward takes the tensor
    cores on the card (``ops/rnn.py _mma_route``): the plain backward
    those kernels are held to there, through ``_Scan`` on the CPU, against
    jax.grad through the Pallas _bwd_call, scaled atol 0.05."""
    from lfm_quant_tpu_torch.ops.rnn import _mma_route

    assert _mma_route(torch.bfloat16, 16) == "mma"
    hin, wx, b, wh, m = _inputs(cell, 9, 5, 16, seed=71)
    wx, wh = wx / np.sqrt(2.0), wh / np.sqrt(2.0)
    xw = (hin @ wx + b).astype(np.float32)
    mt = torch.from_numpy(m)
    got, out = _torch_grads(lambda x, w: rnn_scan(cell, x, w, mt),
                            (xw, wh), torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (9, 5, 16)
    want = _jax_grads(
        lambda x, w: jax_scan(cell, x, w, jnp.asarray(m).astype(x.dtype),
                              block_b=8),
        (xw, wh), jnp.bfloat16)
    for g, w in zip(got, want):
        _scaled_close(g, w, "bf16")


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_hoisted_forward_matches_jax(cell):
    """Row 1's forward against the Pallas forward in interpret mode."""
    hin, wx, b, wh, m = _inputs(cell, 13, 6, 8, seed=3)
    xw = (hin @ wx + b).astype(np.float32)
    want = np.asarray(jax_scan(cell, jnp.asarray(xw), jnp.asarray(wh),
                               jnp.asarray(m)))
    with torch.no_grad():
        got = rnn_scan(cell, torch.from_numpy(xw), torch.from_numpy(wh),
                       torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert not got[13 // 2].any()


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("fused", [True, False])
def test_plain_formulas_match_autograd(cell, fused):
    """The reverse-time formulas against torch autograd of the plain
    forward, f32, with an upstream gradient on every step."""
    hin, wx, b, wh, m = _inputs(cell, 11, 7, 6, seed=21)
    rng = np.random.default_rng(22)
    dh = torch.from_numpy(rng.standard_normal((11, 7, 6)).astype(
        np.float32))
    mt = torch.from_numpy(m)
    if fused:
        leaves = [torch.from_numpy(a).requires_grad_(True)
                  for a in (hin, wx, b, wh)]
        out = rnn_scan_fused_reference(cell, *leaves, mt)
        xw = hin @ wx + b
    else:
        xw = (hin @ wx + b).astype(np.float32)
        leaves = [torch.from_numpy(a).requires_grad_(True)
                  for a in (xw, wh)]
        out = rnn_scan_reference(cell, *leaves, mt)
    out.backward(dh)
    h, c = rnn_scan_states(cell, torch.from_numpy(xw), torch.from_numpy(wh),
                           mt)
    if fused:
        got = rnn_scan_fused_bwd_reference(
            cell, *(torch.from_numpy(a) for a in (hin, wx, b, wh)), mt, h, c,
            dh)
    else:
        got = rnn_scan_bwd_reference(cell, torch.from_numpy(xw),
                                     torch.from_numpy(wh), mt, h, c, dh)
    for g, leaf in zip(got, leaves):
        _scaled_close(g.numpy(), leaf.grad.numpy(), "f32")


def _stacked_inputs(cell, S, B, T, H, seed):
    per = [_inputs(cell, B, T, H, seed + s) for s in range(S)]
    return [np.stack([p[i] for p in per]) for i in range(5)]


@pytest.mark.parametrize("shared_m", [False, True])
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_stacked_fused_op_matches_jax_vmap(cell, dtype_name, shared_m):
    """3 seeds, B 21 over three batch blocks: the forward, and dhin, dW_x,
    db, dW_h per seed against jax.vmap(jax.grad) through the Pallas fused
    kernels; ``shared_m`` passes m with seed extent 1 here and unbatched
    (``in_axes=None``) to jax.vmap. Scaled per seed: f32 atol 1e-5, bf16
    0.05."""
    S = 3
    hin, wx, b, wh, m = _stacked_inputs(cell, S, 21, 5, 8, seed=90)
    if shared_m:
        m = m[:1]
    td = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    jd = jnp.bfloat16 if dtype_name == "bf16" else jnp.float32
    mt = torch.from_numpy(m)
    leaves = [torch.from_numpy(a).to(td).requires_grad_(True)
              for a in (hin, wx, b, wh)]
    out = rnn_scan_fused(cell, *leaves, mt)
    (out.float() ** 2).sum().backward()
    got = [t.grad.float().numpy() for t in leaves]
    assert out.shape == (S, 21, 5, 8) and out.dtype == td

    def loss(hin, wx, b, wh, m):
        return (jax_scan_fused(cell, hin, wx, b, wh, m.astype(hin.dtype),
                               block_b=8).astype(jnp.float32) ** 2).sum()

    ja = [jnp.asarray(a).astype(jd) for a in (hin, wx, b, wh)]
    jm = jnp.asarray(m[0] if shared_m else m)
    axes = (0, 0, 0, 0, None if shared_m else 0)
    want_out = jax.vmap(
        lambda *a: jax_scan_fused(cell, *a[:4], a[4].astype(a[0].dtype),
                                  block_b=8), in_axes=axes)(*ja, jm)
    want = jax.jit(jax.vmap(jax.grad(loss, argnums=(0, 1, 2, 3)),
                            in_axes=axes))(*ja, jm)
    np.testing.assert_allclose(
        out.detach().float().numpy(),
        np.asarray(want_out.astype(jnp.float32)),
        atol=ATOL[dtype_name], rtol=0.0 if dtype_name == "f32" else 0.05)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        for s in range(S):
            _scaled_close(g[s], w[s], dtype_name)


def test_stacked_op_shares_an_operand_of_extent_one():
    """W_x of seed extent 1 is shared: the output equals that of its
    broadcast copy, and its gradient is the sum of the seeds' gradients."""
    hin, wx, b, wh, m = _stacked_inputs("lstm", 3, 9, 5, 8, seed=5)
    mt = torch.from_numpy(m)
    shared = torch.from_numpy(wx[:1]).requires_grad_(True)
    full = torch.from_numpy(np.repeat(wx[:1], 3, 0)).requires_grad_(True)
    rest = [torch.from_numpy(a) for a in (hin, b, wh)]
    outs = []
    for w in (shared, full):
        o = rnn_scan_fused("lstm", rest[0], w, rest[1], rest[2], mt)
        (o ** 2).sum().backward()
        outs.append(o.detach())
    assert torch.equal(outs[0], outs[1])
    assert shared.grad.shape == (1, 8, 32)
    np.testing.assert_allclose(shared.grad[0].numpy(),
                               full.grad.sum(0).numpy(), rtol=1e-6,
                               atol=1e-6)
