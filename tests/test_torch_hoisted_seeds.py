"""The hoisted recurrence's seed rules and the wide widths, against the
JAX package, on the CPU.

* A seed-stacked ``lfm_quant_tpu_torch.ops.rnn rnn_scan`` (one autograd
  node for every seed) against ``jax.vmap`` of ``lfm_quant_tpu.ops.
  pallas_rnn rnn_scan``, whose ``custom_vmap`` rules (``_make_scan.
  _fwd_vmap`` and ``_bwd_vmap``) run the Pallas kernels in interpret mode
  on a seed grid, forward and ``jax.jit(jax.vmap(jax.grad(...)))`` (the
  ensemble train step's transform stack, as ``tests/test_pallas_rnn.py``
  runs it): every operand batched, ``m`` shared (the eval forward's
  ``in_axes``), and ``wh`` shared, whose gradient is the seeds' sum.
  f32 atol 1e-5, bf16 0.05 (gradients scaled by their largest magnitude).
* A tiny ``EnsembleTrainer`` (3 seeds, hidden 8, window 12) with
  ``scan_impl="pallas"`` in both packages for two epochs: histories and
  decisions, rtol 1e-4 in f32.
* ``RNNModel`` at hidden 256 (fused and hoisted) against Flax through
  ``weights.py``: the width the CUDA-core kernels now take on the card.

The kernels themselves are held to their plain versions on the card in
``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.models import build_model as jax_build_model
from lfm_quant_tpu.ops.pallas_rnn import rnn_scan as jax_rnn_scan
from lfm_quant_tpu.train.ensemble import EnsembleTrainer as JaxEnsemble
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.models import build_model
from lfm_quant_tpu_torch.ops.rnn import rnn_scan
from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
from lfm_quant_tpu_torch.weights import load_flax_params

GATES = {"lstm": 4, "gru": 3}
TOL = {"f32": 1e-5, "bf16": 0.05}
S = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stacked(cell, seed, B=7, T=5, H=6):
    rng = np.random.default_rng(seed)
    G = GATES[cell] * H
    xw = rng.standard_normal((S, B, T, G)).astype(np.float32)
    wh = (0.3 * rng.standard_normal((S, H, G))).astype(np.float32)
    m = rng.random((S, B, T)) < 0.75
    up = rng.standard_normal((S, B, T, H)).astype(np.float32)
    return xw, wh, m, up


#: What each case shares (seed extent 1 in the port, ``in_axes`` None in
#: JAX): nothing (the train step), m (the eval forward), W_h.
SHARED = {"none": (0, 0, 0), "m": (0, 0, None), "wh": (0, None, 0)}


def _scaled_close(got, want, atol):
    scale = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


@pytest.mark.parametrize("cell,dtype_name,shared", [
    ("lstm", "f32", "none"), ("lstm", "bf16", "m"), ("lstm", "f32", "wh"),
    ("gru", "bf16", "none"), ("gru", "f32", "m"), ("gru", "bf16", "wh")])
def test_seed_stacked_scan_matches_jax_vmap(cell, dtype_name, shared):
    """One seed-stacked ``rnn_scan`` node against ``jax.vmap`` of the
    Pallas hoisted scan: the states, and the gradients of a weighted sum
    through ``jit(vmap(grad))``; a shared operand's port gradient is the
    sum of JAX's per-seed ones. Each cell meets both dtypes and every
    case (a JAX compile a case is the cost)."""
    xw, wh, m, up = _stacked(cell, {"lstm": 1, "gru": 2}[cell])
    axes = SHARED[shared]
    ops = [a if ax == 0 else a[0] for a, ax in zip((xw, wh, m), axes)]
    jd = jnp.bfloat16 if dtype_name == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    jx, jw = (jnp.asarray(a).astype(jd) for a in ops[:2])
    jm = jnp.asarray(ops[2]).astype(jnp.float32)

    def loss(xw, wh, m, up):
        h = jax_rnn_scan(cell, xw, wh, m)
        return (h.astype(jnp.float32) * up).sum(), h

    # One compile: the states ride along as the gradient's aux output.
    (gx, gw), want = jax.jit(jax.vmap(
        jax.grad(loss, argnums=(0, 1), has_aux=True),
        in_axes=axes + (0,)))(jx, jw, jm, jnp.asarray(up))
    # The port: seed extent 1 for a shared operand.
    tx, tw = (torch.from_numpy(a if ax == 0 else a[None]).to(td)
              .requires_grad_(True) for a, ax in zip(ops[:2], axes))
    tm = torch.from_numpy(ops[2] if axes[2] == 0 else ops[2][None])
    out = rnn_scan(cell, tx, tw, tm)
    assert out.shape == (S,) + xw.shape[1:3] + (wh.shape[1],)
    assert type(out.grad_fn).__name__ == "_ScanBackward"
    (out.float() * torch.from_numpy(up)).sum().backward()
    tol = TOL[dtype_name]
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=0 if dtype_name == "f32"
                               else tol)
    gw = np.asarray(gw.astype(jnp.float32))
    if axes[1] is None:
        assert tw.grad.shape[0] == 1
        gw = gw.sum(axis=0, keepdims=True)
    _scaled_close(tx.grad.float().numpy(), np.asarray(gx.astype(jnp.float32)),
                  tol)
    _scaled_close(tw.grad.float().numpy(), gw, tol)


def _tiny(cfg_mod, scan_impl):
    return cfg_mod.RunConfig(
        name="tiny_hoisted_ens",
        data=cfg_mod.DataConfig(n_firms=48, n_months=120, n_features=5,
                                window=12, dates_per_batch=4,
                                firms_per_date=16),
        model=cfg_mod.ModelConfig(kind="lstm", kwargs={"hidden": 8},
                                  scan_impl=scan_impl),
        optim=cfg_mod.OptimConfig(lr=3e-3, warmup_steps=4, epochs=2,
                                  early_stop_patience=5),
        seed=3, n_seeds=S)


def _splits(splits_cls, panel):
    return splits_cls.by_date(panel, int(panel.dates[84]),
                              int(panel.dates[102]))


def test_hoisted_ensemble_matches_jax(monkeypatch):
    """The seed ensemble on the hoisted recurrence (``scan_impl="pallas"``
    in both packages: the JAX train step's ``vmap(grad)`` reaches the
    Pallas seed rules, the port's one ``_Scan`` node for 3 seeds) from
    the JAX stacked init for two epochs: epochs run, best epoch, each
    epoch's train loss, val IC and its spread within rtol 1e-4 in f32."""
    monkeypatch.setenv("LFM_ASYNC", "0")
    jpanel = jax_synthetic(n_firms=48, n_months=120, n_features=5, seed=0)
    jt = JaxEnsemble(_tiny(jax_config, "pallas"), _splits(JaxSplits, jpanel))
    # The members' init runs the Pallas forward in interpret mode under
    # vmap; jitted it compiles once instead of running op by op (the same
    # keys, the same params).
    monkeypatch.setattr(jt.inner, "init_state", jax.jit(jt.inner.init_state))
    init = jax.tree_util.tree_map(np.asarray, jt.init_state().params)
    want = jt.fit()
    tt = EnsembleTrainer(_tiny(config, "pallas"), _splits(
        PanelSplits, synthetic_panel(n_firms=48, n_months=120, n_features=5,
                                     seed=0)), device="cpu")
    assert tt.model.scan_impl == "hoisted"
    got = tt.fit(init_params=init)
    assert got["n_seeds"] == want["n_seeds"] == S
    assert got["epochs_run"] == want["epochs_run"] == 2
    assert got["best_epoch"] == want["best_epoch"]
    for g, w in zip(got["history"], want["history"], strict=True):
        assert g["epoch"] == w["epoch"] and g["step"] == w["step"]
        for key in ("train_loss", "val_ic", "val_ic_std"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=0.0,
                                       err_msg=key)


@pytest.mark.parametrize("cell,impl", [("lstm", "pallas_fused"),
                                       ("gru", "pallas")])
def test_wide_model_matches_flax(cell, impl):
    """``RNNModel`` at hidden 256 (past the CUDA-core kernels' former
    shared-memory caps: the fused LSTM backward stopped at 227) against
    the Flax model on its fused and hoisted branches, one tiny batch, f32
    atol 1e-5."""
    rng = np.random.default_rng(11)
    B, W, F, H = 2, 3, 3, 256
    x = rng.standard_normal((B, W, F)).astype(np.float32)
    m = rng.random((B, W)) < 0.8
    # The param tree is the same on every branch; the fused one inits
    # fastest in interpret mode.
    params = jax.tree_util.tree_map(np.asarray, jax_build_model(
        cell, hidden=H, scan_impl="pallas_fused").init(
            jax.random.key(0), jnp.asarray(x), jnp.asarray(m))["params"])
    jmodel = jax_build_model(cell, hidden=H, scan_impl=impl)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x),
                                 jnp.asarray(m))
    tmodel = build_model(cell, n_features=F, hidden=H, scan_impl={
        "pallas": "hoisted"}.get(impl, "fused"))
    load_flax_params(tmodel, params)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(m))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
