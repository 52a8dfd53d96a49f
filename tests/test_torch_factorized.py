"""The port's factorized recurrences (``models/rnn.py`` ``LowRankDense``,
``GroupedDense`` and the ``"loop"`` scan) against the JAX package's, on
the CPU at small widths (hidden 16, window 12), inputs from a numpy seed,
the JAX params carried across by ``weights.load_flax_params``.

* ``LowRankDense`` and ``GroupedDense`` against the Flax modules, forward
  and input gradient, f32 atol 1e-5; seed-stacked against S one-seed
  layers.
* The factored LSTM and GRU (rank 4, 4 groups) against the JAX XLA scan:
  forward in f32 (atol 1e-5 + rtol 1e-5) and bf16 (the port's bf16
  tolerance, atol/rtol 0.05: the XLA scan carries h in bf16 as the loop
  does, but XLA's CPU fusions keep elementwise bf16 in f32), parameter
  gradients in f32 scaled by the largest magnitude within 1e-4; a masked
  step holds the state; a seed-stacked model against S one-seed models.
* The weights: the JAX tree loads and maps back unchanged; ``init_params``
  draws the Flax tree's paths and shapes with each kernel's std about
  Flax's ``fan_in ** -0.5``.
* The routing and the errors: ``model_kwargs`` takes a factored model to
  the loop, a forced kernel impl raises, and the JAX validation texts.
* ``Trainer`` on a grouped LSTM against the JAX trainer (history rtol
  1e-4, params atol 1e-4), and under 2 gloo ranks (the data axis) against
  one process (the JAX ``tests/test_parallel.py:95`` case).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.models import build_model as jax_build_model
from lfm_quant_tpu.models.rnn import GroupedDense as JaxGrouped
from lfm_quant_tpu.models.rnn import LowRankDense as JaxLowRank
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.models import build_model
from lfm_quant_tpu_torch.models.rnn import GroupedDense, LowRankDense
from lfm_quant_tpu_torch.parallel.launch import run_ranks
from lfm_quant_tpu_torch.train.loop import Trainer
from lfm_quant_tpu_torch.weights import (
    flatten_params,
    flax_param_map,
    init_params,
    load_flax_params,
)

import torch_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))
B, W, F, H = 6, 12, 5, 16
FACTORS = {"rank": {"factor_rank": 4}, "groups": {"n_groups": 4}}
TOL = {"f32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=0.05, rtol=0.05)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, W, F)).astype(np.float32)
    m = rng.random((B, W)) < 0.7
    m[0] = False            # a window with no valid month
    m[1, -1] = False        # an invalid anchor month
    m[2] = True
    return x, m


def _pair(cell, factor, dtype_name="f32", seed=0):
    kw = dict(hidden=H, **FACTORS[factor])
    jkw = dict(kw, scan_impl="xla")
    if dtype_name == "bf16":
        jkw["dtype"] = jnp.bfloat16
    jmodel = jax_build_model(cell, **jkw)
    x, m = _inputs()
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(seed), jnp.asarray(x), jnp.asarray(m))["params"])
    tkw = dict(kw, scan_impl="loop")
    if dtype_name == "bf16":
        tkw["dtype"] = torch.bfloat16
    tmodel = build_model(cell, n_features=F, **tkw)
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layer", ["low_rank", "grouped"])
@pytest.mark.parametrize("bias", [True, False])
def test_layers_match_flax(layer, bias):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    if layer == "low_rank":
        jl, tl = (JaxLowRank(features=24, rank=5, use_bias=bias),
                  LowRankDense(16, 24, 5, use_bias=bias))
    else:
        jl, tl = (JaxGrouped(features=24, n_groups=4, use_bias=bias),
                  GroupedDense(16, 24, 4, use_bias=bias))
    params = jax.tree_util.tree_map(
        np.asarray, jl.init(jax.random.key(0), jnp.asarray(x))["params"])
    if bias:  # a non-zero bias, so that its path is exercised
        params = jax.tree_util.tree_map(lambda a: a + 0.1, params)
    flat = flatten_params(params)
    for name, p in tl.named_parameters():
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(flat[name.replace(".", "/")])))
    want = np.asarray(jl.apply({"params": params}, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tl(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    r = rng.standard_normal(want.shape).astype(np.float32)
    gx = jax.grad(lambda v: jnp.sum(jl.apply({"params": params}, v) * r))(
        jnp.asarray(x))
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5)


@pytest.mark.parametrize("layer", ["low_rank", "grouped"])
def test_layers_seed_stacked(layer):
    """S stacked members against S one-seed layers, the input per seed
    and shared."""
    S = 3
    make = ((lambda n: LowRankDense(16, 24, 5, n_seeds=n))
            if layer == "low_rank" else
            (lambda n: GroupedDense(16, 24, 4, n_seeds=n)))
    stacked = make(S)
    gens = [torch.Generator().manual_seed(s) for s in range(S)]
    with torch.no_grad():
        for p in stacked.parameters():
            for s in range(S):
                p[s].normal_(generator=gens[s])
    x = torch.randn(S, 2, 7, 16, generator=torch.Generator().manual_seed(9))
    for shared in (False, True):
        xin = x[:1] if shared else x
        out = stacked(xin)
        for s in range(S):
            one = make(None)
            with torch.no_grad():
                for (_, p1), (_, ps) in zip(one.named_parameters(),
                                            stacked.named_parameters()):
                    p1.copy_(ps[s])
            np.testing.assert_allclose(out[s].detach().numpy(),
                                       one(xin[0 if shared else s])
                                       .detach().numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the factored models against the JAX XLA scan
# ---------------------------------------------------------------------------

CASES = [(c, f, d) for c in ("lstm", "gru") for f in FACTORS
         for d in ("f32", "bf16")]


@pytest.mark.parametrize("cell,factor,dtype_name", CASES,
                         ids=["-".join(c) for c in CASES])
def test_forward_matches_jax(cell, factor, dtype_name):
    jmodel, params, tmodel = _pair(cell, factor, dtype_name)
    x, m = _inputs(1)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                   jnp.asarray(m)), np.float32)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        if dtype_name == "bf16":  # the device panel's dtype
            xt = xt.to(torch.bfloat16)
        got = tmodel(xt, torch.from_numpy(m)).float().numpy()
    assert got.shape == (B,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[dtype_name])


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("factor", sorted(FACTORS))
def test_gradients_match_jax(cell, factor):
    """d/dθ of sum(r · forecast) against ``jax.grad`` through the XLA
    scan, each gradient scaled by its largest magnitude, f32 atol 1e-4."""
    jmodel, params, tmodel = _pair(cell, factor, seed=2)
    x, m = _inputs(3)
    r = np.random.default_rng(4).standard_normal(B).astype(np.float32)
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p: jnp.sum(jmodel.apply({"params": p}, jnp.asarray(x),
                                       jnp.asarray(m)) * r))(params)))
    out = tmodel(torch.from_numpy(x), torch.from_numpy(m))
    (out * torch.from_numpy(r)).sum().backward()
    got = {k: p.grad.numpy() for k, p in flax_param_map(tmodel).items()}
    assert set(got) == set(want)
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-12)
        np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("factor", sorted(FACTORS))
def test_masked_step_holds_state(factor):
    """As the JAX ``test_factorized_rnn_masking_holds_state``: garbage
    behind a masked month does not move the forecast; masking it does."""
    _, _, tmodel = _pair("lstm", factor)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, W, F)).astype(np.float32))
    m = torch.ones(B, W, dtype=torch.bool)
    m2 = m.clone()
    m2[:, W // 2] = False
    x2, x3 = x.clone(), x.clone()
    x2[:, W // 2] = 0.0
    x3[:, W // 2] = 123.0
    with torch.no_grad():
        full, masked, garbage = (tmodel(a, b) for a, b in
                                 ((x, m), (x2, m2), (x3, m2)))
    np.testing.assert_allclose(masked.numpy(), garbage.numpy(), atol=1e-6)
    assert not np.allclose(full.numpy(), masked.numpy())


@pytest.mark.parametrize("factor", sorted(FACTORS))
def test_seed_stacked_model(factor):
    """A 3-seed factored GRU against its members run alone."""
    S = 3
    kw = dict(hidden=H, scan_impl="loop", **FACTORS[factor])
    stacked = build_model("gru", n_features=F, n_seeds=S, **kw)
    init_params(stacked, [torch.Generator().manual_seed(s) for s in range(S)])
    x, m = (torch.from_numpy(a) for a in _inputs(6))
    with torch.no_grad():
        out = stacked(x, m)
        for s in range(S):
            one = build_model("gru", n_features=F, **kw)
            load_flax_params(one, {k: p[s].numpy() for k, p in
                                   flax_param_map(stacked).items()})
            np.testing.assert_allclose(out[s].numpy(), one(x, m).numpy(),
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# weights, routing, errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("factor", sorted(FACTORS))
def test_weights_round_trip_and_init(cell, factor):
    _, params, tmodel = _pair(cell, factor)
    flat = flatten_params(params)
    back = {k: p.detach().numpy() for k, p in flax_param_map(tmodel).items()}
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    fresh = build_model(cell, n_features=F, hidden=64, scan_impl="loop",
                        **FACTORS[factor])
    init_params(fresh, torch.Generator().manual_seed(0))
    jfresh = flatten_params(jax_build_model(
        cell, hidden=64, scan_impl="xla", **FACTORS[factor]).init(
        jax.random.key(0), jnp.zeros((2, W, F)),
        jnp.ones((2, W), bool))["params"])
    mine = {k: p.detach().numpy() for k, p in flax_param_map(fresh).items()}
    assert {k: v.shape for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in jfresh.items()}
    for k, v in mine.items():
        if k.endswith("kernel"):
            fan_in = v.shape[0] * v.shape[1] if v.ndim == 3 else v.shape[0]
            assert abs(v.std() * fan_in ** 0.5 - 1.0) < 0.2, k
            assert abs(np.asarray(jfresh[k]).std() * fan_in ** 0.5
                       - 1.0) < 0.2, k
        else:
            assert not v.any(), k


def test_routing_and_errors():
    cfg = config.get_preset("c2")

    def with_kw(**kw):
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, kwargs=dict(cfg.model.kwargs, **kw)))

    for kw in FACTORS.values():
        for impl in ("auto", "xla"):
            c = with_kw(**kw)
            c = dataclasses.replace(c, model=dataclasses.replace(
                c.model, scan_impl=impl))
            assert config.model_kwargs(c)[1]["scan_impl"] == "loop"
        forced = dataclasses.replace(with_kw(**kw), model=dataclasses.replace(
            with_kw(**kw).model, scan_impl="pallas"))
        kind, kwargs = config.model_kwargs(forced)
        with pytest.raises(ValueError, match="scan_impl='xla'"):
            build_model(kind, n_features=F, **kwargs)
    assert config.model_kwargs(cfg)[1]["scan_impl"] == "fused"
    with pytest.raises(ValueError, match="factorized recurrences' route"):
        build_model("lstm", n_features=F, hidden=32, scan_impl="loop")
    for kw, match in (({"factor_rank": 4, "n_groups": 2},
                       "alternative factorizations"),
                      ({"n_groups": 3}, "divide evenly"),
                      ({"n_groups": 0}, "n_groups must be >= 1"),
                      ({"factor_rank": 0}, "factor_rank must be >= 1")):
        with pytest.raises(ValueError, match=match):
            build_model("lstm", n_features=F, hidden=32, scan_impl="loop",
                        **kw)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

PANEL = dict(n_firms=40, n_months=120, n_features=5, seed=0)
CUT = (84, 102)


def _cfg(mod, n_data_shards=1, **optim):
    return mod.RunConfig(
        name="grouped",
        data=mod.DataConfig(n_firms=40, n_months=120, n_features=5,
                            window=12, dates_per_batch=4, firms_per_date=16),
        model=mod.ModelConfig(kind="lstm", kwargs={"hidden": H,
                                                   "n_groups": 4}),
        optim=mod.OptimConfig(**dict(dict(lr=3e-3, warmup_steps=2, epochs=2,
                                          early_stop_patience=5), **optim)),
        seed=7, n_data_shards=n_data_shards)


def _jax_splits():
    p = jax_synthetic(**PANEL)
    return JaxSplits.by_date(p, int(p.dates[CUT[0]]), int(p.dates[CUT[1]]))


def test_trainer_matches_jax(monkeypatch):
    monkeypatch.setenv("LFM_ASYNC", "0")
    jt = JaxTrainer(_cfg(jax_config), _jax_splits())
    init = jax.tree_util.tree_map(np.asarray, jt.init_state().params)
    want = jt.fit()
    p = synthetic_panel(**PANEL)
    tt = Trainer(_cfg(config), PanelSplits.by_date(
        p, int(p.dates[CUT[0]]), int(p.dates[CUT[1]])), device="cpu")
    assert tt.model.scan_impl == "loop"
    got = tt.fit(init_params=init)
    assert got["best_epoch"] == want["best_epoch"]
    for g, w in zip(got["history"], want["history"]):
        for key in ("train_loss", "grad_norm", "val_ic", "val_mse"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=key)
    final = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                  jt.state.params))
    for k, v in tt.state.params.items():
        np.testing.assert_allclose(v.detach().numpy(), final[k], atol=1e-4,
                                   err_msg=k)


def test_grouped_lstm_on_two_data_ranks(tmp_path):
    """The grouped LSTM date-sharded over 2 gloo ranks equals one process
    (the JAX ``test_dp_training_grouped_lstm_matches_single_device``)."""
    init = jax.tree_util.tree_map(np.asarray, JaxTrainer(
        _cfg(jax_config), _jax_splits()).init_state().params)
    cfg = _cfg(config, n_data_shards=2, epochs=1)
    one = R.epoch_steps(cfg, PANEL, CUT, init)
    ranks = run_ranks(2, "torch_ranks:epoch_steps",
                      dict(cfg=cfg, panel_kw=PANEL, cut=CUT, init=init),
                      str(tmp_path / "job"), 120, python_path=[HERE])
    assert one["n_data"] == 1
    for got in ranks:
        assert got["n_data"] == 2
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norms"], one["grad_norms"],
                                   rtol=1e-5)
        for k, v in one["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
