"""The port's fused recurrence and RNNModel against the JAX package.

The same numpy inputs go through ``lfm_quant_tpu.ops.pallas_rnn
rnn_scan_fused`` (Pallas interpret mode on the CPU, as
``tests/test_pallas_rnn.py`` runs it) and ``lfm_quant_tpu_torch.ops.rnn
rnn_scan_fused`` (its plain version on the CPU); the Flax ``RNNModel``
with ``scan_impl="pallas_fused"`` and the port's ``RNNModel`` share one
param tree through ``weights.load_flax_params``. Tolerances are the JAX
tests' own: f32 atol 1e-5, bf16 atol/rtol 0.05.

The CUDA kernel itself is held to its plain version on the card in
``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfm_quant_tpu.models import build_model as jax_build_model
from lfm_quant_tpu.ops.pallas_rnn import rnn_scan_fused as jax_scan_fused
from lfm_quant_tpu_torch import config as tconfig
from lfm_quant_tpu_torch.models import RNNModel, build_model
from lfm_quant_tpu_torch.ops.rnn import rnn_scan_fused
from lfm_quant_tpu_torch.weights import (
    flatten_params,
    init_params,
    load_flax_params,
)

GATES = {"lstm": 4, "gru": 3}
TOL = {"f32": dict(atol=1e-5, rtol=0.0), "bf16": dict(atol=0.05, rtol=0.05)}


def _op_inputs(cell, B, T, H, seed, invalid_rows=()):
    rng = np.random.default_rng(seed)
    G = GATES[cell] * H
    hin = rng.standard_normal((B, T, H)).astype(np.float32)
    wx = (0.3 * rng.standard_normal((H, G))).astype(np.float32)
    b = (0.1 * rng.standard_normal((G,))).astype(np.float32)
    wh = (0.3 * rng.standard_normal((H, G))).astype(np.float32)
    m = rng.random((B, T)) < 0.75
    for r in invalid_rows:
        m[r] = False
    return hin, wx, b, wh, m


def _as(dtype_name, *arrays):
    jd = jnp.bfloat16 if dtype_name == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    j = [jnp.asarray(a).astype(jd) for a in arrays]
    t = [torch.from_numpy(a).to(td) for a in arrays]
    return j, t


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("B", [13, 5])
def test_fused_op_matches_jax(cell, dtype_name, B):
    """Odd batch sizes, an all-invalid row (which stays at the zero
    state), both cells, both dtypes."""
    hin, wx, b, wh, m = _op_inputs(cell, B, 6, 8, seed=B,
                                   invalid_rows=(1,))
    (jh, jwx, jb, jwh), (th, twx, tb, twh) = _as(dtype_name, hin, wx, b, wh)
    want = np.asarray(
        jax_scan_fused(cell, jh, jwx, jb, jwh, jnp.asarray(m))
        .astype(jnp.float32))
    got = rnn_scan_fused(cell, th, twx, tb, twh, torch.from_numpy(m))
    assert got.dtype == th.dtype and got.shape == (B, 6, 8)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, **TOL[dtype_name])
    assert not got[1].any(), "an all-invalid row must stay at the zero state"


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("H", [16, 64])
def test_fused_op_matches_jax_at_tensor_core_widths(cell, H):
    """bf16 at the widths that take the tensor-core kernel on the card
    (``ops/rnn.py _mma_route``): the plain version those kernels are
    held to on the card against the Pallas kernel, at the JAX bf16
    bound."""
    from lfm_quant_tpu_torch.ops.rnn import _mma_route

    assert _mma_route(torch.bfloat16, H) == "mma"
    hin, wx, b, wh, m = _op_inputs(cell, 7, 5, H, seed=H, invalid_rows=(2,))
    wx, wh = wx / np.sqrt(H / 8), wh / np.sqrt(H / 8)
    (jh, jwx, jb, jwh), (th, twx, tb, twh) = _as("bf16", hin, wx, b, wh)
    want = np.asarray(
        jax_scan_fused(cell, jh, jwx, jb, jwh, jnp.asarray(m))
        .astype(jnp.float32))
    got = rnn_scan_fused(cell, th, twx, tb, twh, torch.from_numpy(m))
    np.testing.assert_allclose(got.float().numpy(), want, **TOL["bf16"])
    assert not got[2].any()


def test_fused_op_forward_only():
    """Under no_grad / inference_mode the op is forward only: it builds no
    graph and saves no states. With a weight that wants a gradient it
    goes through the autograd Function, and both give the same h."""
    hin, wx, b, wh, m = _op_inputs("lstm", 3, 4, 8, seed=0)
    t = [torch.from_numpy(a) for a in (hin, wx, b, wh)]
    t[1].requires_grad_(True)
    with torch.no_grad():
        plain = rnn_scan_fused("lstm", *t, torch.from_numpy(m))
    with torch.inference_mode():
        served = rnn_scan_fused("lstm", *t, torch.from_numpy(m))
    assert plain.grad_fn is None and not served.requires_grad
    traced = rnn_scan_fused("lstm", *t, torch.from_numpy(m))
    assert type(traced.grad_fn).__name__ == "_FusedScanBackward"
    assert torch.equal(traced.detach(), plain) and torch.equal(plain, served)


def test_fused_op_checks_shapes():
    hin, wx, b, wh, m = _op_inputs("gru", 3, 4, 8, seed=0)
    t = [torch.from_numpy(a) for a in (hin, wx, b, wh)]
    with pytest.raises(ValueError, match="expected wx/wh"):
        rnn_scan_fused("lstm", *t, torch.from_numpy(m))
    with pytest.raises(ValueError, match="cell"):
        rnn_scan_fused("rnn", *t, torch.from_numpy(m))


def test_backward_checks_its_states():
    """The backwards take the saved states of the forward: the LSTM's
    c_all is required and every state must be [B, T, H]."""
    from lfm_quant_tpu_torch.ops.rnn import rnn_scan_bwd, rnn_scan_fused_bwd

    hin, wx, b, wh, m = (torch.from_numpy(a) for a in
                         _op_inputs("lstm", 3, 4, 8, seed=0))
    h = torch.zeros(3, 4, 8)
    with pytest.raises(ValueError, match="c_all"):
        rnn_scan_fused_bwd("lstm", hin, wx, b, wh, m, h, None, h)
    with pytest.raises(ValueError, match="dh must be"):
        rnn_scan_bwd("lstm", hin @ wx + b, wh, m, h, h, h[:, :2])


def _flax_params(jmodel, x, m, seed=0):
    p = jmodel.init(jax.random.key(seed), jnp.asarray(x), jnp.asarray(m))
    return jax.tree_util.tree_map(np.asarray, p["params"])


@pytest.mark.parametrize(
    "cell,layers,head_hidden,het,dtype_name,impl",
    [("lstm", 1, (), False, "f32", "pallas_fused"),
     ("lstm", 2, (6,), False, "f32", "pallas_fused"),
     ("gru", 2, (), True, "f32", "pallas_fused"),
     ("gru", 1, (6, 4), False, "f32", "pallas_fused"),
     ("lstm", 2, (6,), True, "bf16", "pallas_fused"),
     ("gru", 1, (), False, "bf16", "pallas_fused"),
     ("lstm", 2, (6,), False, "f32", "pallas"),
     ("gru", 1, (), False, "bf16", "pallas")])
def test_model_matches_flax(cell, layers, head_hidden, het, dtype_name,
                            impl):
    """Converted params reproduce the Flax RNNModel on its fused branch
    and on its hoisted-projection branch ("pallas", the port's
    "hoisted"): 1 and 2 layers, with and without hidden head layers
    (tanh-GELU) and a heteroscedastic head."""
    rng = np.random.default_rng(7)
    B, W, F, H = 9, 7, 3, 8
    x = rng.standard_normal((B, W, F)).astype(np.float32)
    m = rng.random((B, W)) < 0.8
    m[2] = False
    jd = jnp.bfloat16 if dtype_name == "bf16" else None
    td = torch.bfloat16 if dtype_name == "bf16" else None
    jmodel = jax_build_model(cell, hidden=H, layers=layers,
                             head_hidden=head_hidden, heteroscedastic=het,
                             dtype=jd, scan_impl=impl)
    params = _flax_params(jmodel, x, m)
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(m))
    tmodel = build_model(cell, n_features=F, hidden=H, layers=layers,
                         head_hidden=head_hidden, heteroscedastic=het,
                         dtype=td, scan_impl={"pallas": "hoisted"}.get(
                             impl, "fused"))
    load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(m))
    if het:
        assert isinstance(got, tuple) and len(got) == 2
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       **TOL[dtype_name])
    else:
        assert got.dtype == torch.float32 and got.shape == (B,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL[dtype_name])


def test_param_map_rejects_mismatched_trees():
    model = build_model("lstm", n_features=3, hidden=8)
    tree = {k: np.zeros(tuple(p.shape), np.float32)
            for k, p in _torch_named(model).items()}
    load_flax_params(model, tree)  # exact match loads
    tree.pop("head/out/bias")
    with pytest.raises(ValueError, match="missing"):
        load_flax_params(model, tree)
    tree["head/out/bias"] = np.zeros((2,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(model, tree)


def _torch_named(model):
    from lfm_quant_tpu_torch.weights import flax_param_map

    return flax_param_map(model)


def test_init_params_follow_flax_initialisers():
    """Seeded, deterministic, lecun-normal kernels and zero biases — the
    tree has exactly the Flax model's paths and shapes."""
    model = build_model("gru", n_features=5, hidden=16, layers=2,
                        head_hidden=(8,))
    init_params(model, torch.Generator().manual_seed(3))
    again = build_model("gru", n_features=5, hidden=16, layers=2,
                        head_hidden=(8,))
    init_params(again, torch.Generator().manual_seed(3))
    named, named2 = _torch_named(model), _torch_named(again)
    for k, p in named.items():
        assert torch.equal(p, named2[k])
        if k.endswith("bias"):
            assert not p.any()
        else:
            assert p.abs().max() <= 2.0 / 0.8796 / p.shape[0] ** 0.5 + 1e-6
    k = named["gru_0/h_proj/kernel"]
    assert abs(float(k.detach().std()) - 16 ** -0.5) < 0.1 * 16 ** -0.5
    jmodel = jax_build_model("gru", hidden=16, layers=2, head_hidden=(8,),
                             scan_impl="pallas_fused")
    flax = flatten_params(_flax_params(
        jmodel, np.zeros((2, 4, 5), np.float32), np.ones((2, 4), bool)))
    assert {k: tuple(v.shape) for k, v in flax.items()} == {
        k: tuple(p.shape) for k, p in named.items()}


def test_model_kwargs_route_scan_impl():
    cfg = tconfig.get_preset("c2")
    kind, kw = tconfig.model_kwargs(cfg)
    assert kind == "lstm" and kw["scan_impl"] == "fused"
    assert kw["dtype"] == torch.bfloat16
    for impl, want in (("pallas_fused", "fused"), ("xla", "plain"),
                       ("pallas", "hoisted")):
        c = tconfig.RunConfig(model=tconfig.ModelConfig(
            kind="gru", kwargs={"hidden": 8}, scan_impl=impl))
        assert tconfig.model_kwargs(c)[1]["scan_impl"] == want
    c = tconfig.RunConfig(model=tconfig.ModelConfig(
        kind="lstm", scan_impl="scan"))
    with pytest.raises(ValueError, match="scan_impl"):
        tconfig.model_kwargs(c)
    # The window-sharded encoder runs only with its seq axis bound, and a
    # factorized recurrence only on the loop (the JAX XLA scan).
    seq = build_model("transformer", n_features=3, window=4, seq_axis="seq")
    with pytest.raises(NameError, match="unbound axis name"):
        seq(torch.zeros(2, 4, 3), torch.ones(2, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="scan_impl='xla'"):
        RNNModel(3, factor_rank=4)


def test_plain_scan_matches_fused_on_cpu():
    """scan_impl 'plain' (config 'xla') is the same function as the fused
    op's CPU path."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 6, 3)).astype(np.float32))
    m = torch.from_numpy(rng.random((4, 6)) < 0.8)
    a = build_model("lstm", n_features=3, hidden=8)
    init_params(a, torch.Generator().manual_seed(0))
    b = build_model("lstm", n_features=3, hidden=8, scan_impl="plain")
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        assert torch.equal(a(x, m), b(x, m))
