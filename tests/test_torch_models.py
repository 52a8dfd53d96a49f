"""The port's MLP, transformer and LRU (``lfm_quant_tpu_torch/models/``)
against the JAX package's, on the CPU at small widths (dim 16, 4 heads,
depth 2, window 12, LRU hidden and state 16), inputs from a numpy seed,
the JAX params carried across by ``weights.load_flax_params``.

* The forward against ``build_model(kind).apply``: f32 atol 1e-5 + rtol
  1e-5, bf16 atol/rtol 0.05; the batch holds a window with no valid month
  and one whose anchor month is invalid; ``window_input=False`` and the
  heteroscedastic head are cases.
* The parameter gradients against ``jax.grad`` in f32, each scaled by its
  largest magnitude, within 1e-4 (the attention's key bias, whose exact
  gradient is zero, by the model's largest gradient).
* The plain LRU scan against the JAX ``_linear_scan`` and a
  serial float64 loop: f32 atol 1e-5.
* A seed-stacked model against S one-seed models (f32 atol 1e-6, dropout
  live with one generator per seed: the same draws).
* ``init_params`` per path: the Flax tree's paths and shapes, LayerNorm
  scales ones and biases zero, ``pos_emb`` std about 0.02, |λ| inside
  ``[R_MIN, R_MAX]``, each kernel's std about ``fan_in ** -0.5`` over its
  contracted axes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfm_quant_tpu.models import build_model as jax_build_model
from lfm_quant_tpu.models.lru import _linear_scan
from lfm_quant_tpu_torch.models import build_model
from lfm_quant_tpu_torch.models.lru import LRULayer, linear_scan
from lfm_quant_tpu_torch.weights import (
    flatten_params,
    flax_param_map,
    init_params,
    load_flax_params,
)

B, W, F = 6, 12, 5
KW = {
    "mlp": {"hidden": (16, 8)},
    "transformer": {"dim": 16, "depth": 2, "heads": 4},
    "lru": {"hidden": 16, "state_dim": 16, "layers": 2},
}
TOL = {"f32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=0.05, rtol=0.05)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, W, F)).astype(np.float32)
    m = rng.random((B, W)) < 0.7
    m[0] = False            # a window with no valid month
    m[1, -1] = False        # an invalid anchor month
    m[2] = True
    return x, m


def _pair(kind, dtype_name="f32", seed=0, **extra):
    """The JAX model and its params, and the port's model loaded with
    them."""
    kw = dict(KW[kind], **extra)
    jkw = dict(kw, dtype=jnp.bfloat16) if dtype_name == "bf16" else kw
    jmodel = jax_build_model(kind, **jkw)
    x, m = _inputs()
    params = jmodel.init(jax.random.key(seed), jnp.asarray(x),
                         jnp.asarray(m))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tkw = dict(kw, dtype=torch.bfloat16) if dtype_name == "bf16" else kw
    tmodel = build_model(kind, n_features=F, window=W, **tkw)
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel


def _np(out):
    if isinstance(out, tuple):
        return tuple(_np(o) for o in out)
    return np.asarray(out.detach().float() if torch.is_tensor(out) else out,
                      np.float32)


CASES = [
    ("mlp", "f32", {}), ("mlp", "bf16", {}),
    ("mlp", "f32", {"window_input": False}),
    ("mlp", "f32", {"heteroscedastic": True}),
    ("transformer", "f32", {}), ("transformer", "bf16", {}),
    ("transformer", "f32", {"heteroscedastic": True, "head_hidden": (8,)}),
    ("lru", "f32", {}), ("lru", "bf16", {}),
    ("lru", "f32", {"heteroscedastic": True, "head_hidden": (8,)}),
]


@pytest.mark.parametrize("kind,dtype_name,extra", CASES,
                         ids=[f"{k}-{d}-{'-'.join(e) or 'plain'}"
                              for k, d, e in CASES])
def test_forward_matches_jax(kind, dtype_name, extra):
    jmodel, params, tmodel = _pair(kind, dtype_name, **extra)
    x, m = _inputs(1)
    want = _np(jmodel.apply({"params": params}, jnp.asarray(x),
                            jnp.asarray(m)))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        if dtype_name == "bf16":  # the device panel's dtype
            xt = xt.to(torch.bfloat16)
        got = _np(tmodel(xt, torch.from_numpy(m)))
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.shape == (B,) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL[dtype_name])


@pytest.mark.parametrize("kind", sorted(KW))
def test_gradients_match_jax(kind):
    """d/dθ of sum(r · forecast) against ``jax.grad``, each gradient
    scaled by its largest magnitude, f32 atol 1e-4."""
    jmodel, params, tmodel = _pair(kind, seed=2)
    x, m = _inputs(3)
    r = np.random.default_rng(4).standard_normal(B).astype(np.float32)

    def loss(p):
        return jnp.sum(jmodel.apply({"params": p}, jnp.asarray(x),
                                    jnp.asarray(m)) * r)

    want = flatten_params(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss)(params)))
    named = flax_param_map(tmodel)
    out = (tmodel(torch.from_numpy(x), torch.from_numpy(m))
           * torch.from_numpy(r)).sum()
    grads = torch.autograd.grad(out, list(named.values()))
    assert set(named) == set(want)
    largest = max(float(np.abs(v).max()) for v in want.values())
    for key, g in zip(named, grads):
        scale = max(float(np.abs(want[key]).max()), 1e-12)
        if key.endswith("attn/key/bias"):
            # Zero in exact arithmetic (a key bias shifts every score of a
            # query alike, and the softmax is shift-invariant): both sides
            # are rounding noise, held to the model's largest gradient.
            scale = largest
        np.testing.assert_allclose(g.numpy() / scale, want[key] / scale,
                                   atol=1e-4, rtol=0, err_msg=key)


# T = 37 (not a power of two) under two lead axes; T = 64 with none.
@pytest.mark.parametrize("shape", [(3, 2, 37, 8), (64, 4)])
def test_linear_scan_matches_jax_and_a_loop(shape):
    rng = np.random.default_rng(5)
    mag = rng.uniform(0.5, 1.0, shape)
    ph = rng.uniform(-np.pi, np.pi, shape)
    a = mag * np.exp(1j * ph)
    a[..., 5, :] = 1.0      # a held (masked) step
    b = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    h, serial = np.zeros(shape[:-2] + shape[-1:], complex), np.zeros(
        shape, complex)
    for t in range(shape[-2]):
        h = a[..., t, :] * h + b[..., t, :]
        serial[..., t, :] = h
    parts = [v.astype(np.float32) for v in (a.real, a.imag, b.real, b.imag)]
    j_re, j_im = (np.asarray(v) for v in _linear_scan(
        *(jnp.asarray(v) for v in parts)))
    t_re, t_im = linear_scan(*(torch.from_numpy(v) for v in parts))
    for got, want in ((t_re.numpy(), j_re), (t_im.numpy(), j_im),
                      (t_re.numpy(), serial.real),
                      (t_im.numpy(), serial.imag)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind,dropout", [
    ("mlp", 0.0), ("mlp", 0.3), ("transformer", 0.0),
    ("transformer", 0.3), ("lru", 0.0)])
def test_seed_stacked_matches_one_seed_models(kind, dropout):
    """A seed-stacked model against S one-seed models from the same
    params: the shared input and a per-seed input; with dropout live,
    seed s's generator draws seed s's masks in both."""
    S = 3
    extra = {"dropout": dropout} if kind != "lru" else {}
    stacked = build_model(kind, n_features=F, window=W, n_seeds=S,
                          **KW[kind], **extra)
    init_params(stacked, [torch.Generator().manual_seed(s)
                          for s in range(S)])
    whole = flax_param_map(stacked)
    x, m = _inputs(6)
    xs = torch.from_numpy(np.stack([x, x[::-1].copy(), x * 0.5]))
    ms = torch.from_numpy(np.stack([m, m[::-1].copy(), m]))

    def gens(base):
        return [torch.Generator().manual_seed(base + s) for s in range(S)]

    with torch.no_grad():
        shared = stacked(torch.from_numpy(x), torch.from_numpy(m),
                         rng=gens(10) if dropout else None)
        per_seed = stacked(xs, ms, rng=gens(20) if dropout else None)
        for s in range(S):
            one = build_model(kind, n_features=F, window=W, **KW[kind],
                              **extra)
            load_flax_params(one, {k: p[s].numpy()
                                   for k, p in whole.items()})
            g = (lambda b: torch.Generator().manual_seed(b + s)) \
                if dropout else (lambda b: None)
            np.testing.assert_allclose(
                shared[s].numpy(), one(torch.from_numpy(x),
                                       torch.from_numpy(m),
                                       rng=g(10)).numpy(), atol=1e-6)
            np.testing.assert_allclose(
                per_seed[s].numpy(), one(xs[s], ms[s], rng=g(20)).numpy(),
                atol=1e-6)
    if dropout:
        with torch.no_grad():
            again = stacked(xs, ms, rng=gens(20))
            other = stacked(xs, ms, rng=gens(30))
            plain = stacked(xs, ms)
        assert torch.equal(again, per_seed)
        assert not torch.equal(other, per_seed)
        assert not torch.equal(plain, per_seed)


@pytest.mark.parametrize("kind", sorted(KW))
def test_init_params_per_path(kind):
    """The seeded init: the JAX tree's paths and shapes, and each path's
    Flax initialiser by its statistics (widths 64 so they settle)."""
    kw = {"mlp": {"hidden": (64, 64)},
          "transformer": {"dim": 64, "depth": 2, "heads": 4},
          "lru": {"hidden": 64, "state_dim": 256, "layers": 2}}[kind]
    model = build_model(kind, n_features=F, window=W, **kw)
    init_params(model, torch.Generator().manual_seed(0))
    named = {k: p.detach() for k, p in flax_param_map(model).items()}
    x, m = _inputs()
    jtree = flatten_params(jax.tree_util.tree_map(
        np.asarray, jax_build_model(kind, **kw).init(
            jax.random.key(0), jnp.asarray(x), jnp.asarray(m))["params"]))
    assert {k: tuple(v.shape) for k, v in jtree.items()} == {
        k: tuple(p.shape) for k, p in named.items()}
    for key, p in named.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("scale", "d_skip"):
            assert torch.equal(p, torch.ones_like(p)), key
        elif leaf == "bias":
            assert torch.equal(p, torch.zeros_like(p)), key
        elif leaf == "pos_emb":
            assert abs(float(p.std()) - 0.02) < 0.002, key
        elif leaf == "kernel" and p.numel() >= 1024:
            fan_in = (p.shape[0] * p.shape[1]
                      if key.endswith("attn/out/kernel") else p.shape[0])
            want = fan_in ** -0.5
            assert abs(float(p.std()) - want) < 0.1 * want, key
            assert float(p.abs().max()) <= 2 * want / .87962566103423978 \
                + 1e-6, key
        elif leaf == "nu_log":
            lam = torch.exp(-torch.exp(p))
            assert float(lam.min()) >= LRULayer.R_MIN - 1e-6, key
            assert float(lam.max()) <= LRULayer.R_MAX + 1e-6, key
            assert float(lam.max() - lam.min()) > 0.05, key
        elif leaf == "theta_log":
            phase = torch.exp(p)
            assert float(phase.min()) >= 1e-4 - 1e-7, key
            assert float(phase.max()) <= LRULayer.MAX_PHASE + 1e-4, key
