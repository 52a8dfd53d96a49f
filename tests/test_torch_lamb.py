"""LAMB (``train/optim.py Lamb``) against the optax chain the JAX trainer
builds for ``optimizer="lamb"``:

    optax.chain(clip_by_global_norm(grad_clip),
                lamb(warmup_cosine_decay_schedule(...), weight_decay))

* Step by step on one gradient sequence (at least 20 updates, clipped and
  unclipped steps, a parameter that starts at zero: trust ratio 1): the
  params within atol 1e-6, the grad norms within rtol 1e-6; and the
  per-seed form against ``jax.vmap`` of the chain, one member clipped
  every step, one never, one in turns.
* ``Trainer`` with ``optimizer="lamb"`` against the JAX ``Trainer`` (f32,
  the same init and sampler order): the per-epoch history within rtol
  1e-4, the same best and last epochs, the final params within atol 1e-4.
* ``EnsembleTrainer`` with ``optimizer="lamb"`` (per-seed trust ratios)
  against the JAX ``EnsembleTrainer``, the same way.
* An unknown optimizer name raises a ``ValueError``, as in JAX.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.train.ensemble import EnsembleTrainer as JaxEnsemble
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
from lfm_quant_tpu_torch.train.loop import Trainer
from lfm_quant_tpu_torch.train.optim import Lamb, make_optimizer
from lfm_quant_tpu_torch.weights import flatten_params

SHAPES = {"a/kernel": (3, 4), "a/bias": (4,), "b/kernel": (4, 2)}


def _chain(lr, wd, clip, warmup, total):
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, min(warmup, total // 2), total, end_value=lr * 0.1)
    return optax.chain(optax.clip_by_global_norm(clip),
                       optax.lamb(sched, weight_decay=wd))


@pytest.mark.parametrize("warmup,total", [(3, 24), (0, 20), (12, 30)])
def test_lamb_matches_optax(warmup, total):
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    params["a/bias"][:] = 0.0  # ||p|| = 0: the trust ratio is 1
    lr, wd, clip = 1e-2, 1e-4, 1.0
    tx = _chain(lr, wd, clip, warmup, total)
    jp = {k: jax.numpy.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = Lamb(lr, wd, clip, warmup, total)
    tstate = opt.init(tp)
    clipped = 0
    for step in range(total + 2):
        scale = 3.0 if step % 3 == 1 else 0.05
        grads = {k: (scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in SHAPES.items()}
        jg = {k: jax.numpy.asarray(v) for k, v in grads.items()}
        upd, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        gnorm = opt.step(tp, {k: torch.from_numpy(v)
                              for k, v in grads.items()}, tstate)
        np.testing.assert_allclose(float(gnorm),
                                   float(optax.global_norm(jg)), rtol=1e-6)
        clipped += float(gnorm) >= clip
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0.0, err_msg=k)
    assert total + 2 >= 20 and tstate.count == total + 2
    assert 2 <= clipped < total + 2
    assert np.abs(tp["a/bias"].numpy()).max() > 0  # left zero


def test_lamb_per_seed_matches_optax_vmap():
    S = 3
    rng = np.random.default_rng(1)
    params = {k: rng.standard_normal((S,) + s).astype(np.float32)
              for k, s in SHAPES.items()}
    lr, wd, clip, warmup, total = 1e-2, 1e-4, 1.0, 3, 20
    tx = _chain(lr, wd, clip, warmup, total)
    jp = {k: jax.numpy.asarray(v) for k, v in params.items()}
    jstate = jax.vmap(tx.init)(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = Lamb(lr, wd, clip, warmup, total, per_seed=True)
    tstate = opt.init(tp)
    clipped = np.zeros(S, int)
    for step in range(total + 2):
        scale = np.array([3.0, 3.0 if step % 2 else 0.05, 0.05], np.float32)
        grads = {k: (scale.reshape((S,) + (1,) * len(s))
                     * rng.standard_normal((S,) + s)).astype(np.float32)
                 for k, s in SHAPES.items()}
        jg = {k: jax.numpy.asarray(v) for k, v in grads.items()}
        upd, jstate = jax.vmap(tx.update)(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        gnorm = opt.step(tp, {k: torch.from_numpy(v)
                              for k, v in grads.items()}, tstate)
        np.testing.assert_allclose(
            gnorm.numpy(), np.asarray(jax.vmap(optax.global_norm)(jg)),
            rtol=1e-6)
        clipped += gnorm.numpy() >= clip
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0.0, err_msg=k)
    assert clipped[0] == total + 2 and clipped[2] == 0 and clipped[1] > 0


def test_make_optimizer_names():
    o = config.OptimConfig(optimizer="lamb")
    assert type(make_optimizer(o, 10)) is Lamb
    with pytest.raises(ValueError, match="adamw|lamb"):
        make_optimizer(dataclasses.replace(o, optimizer="sgd"), 10)


def _tiny(cfg_mod, epochs, patience, scan_impl, **over):
    return cfg_mod.RunConfig(
        name="tiny_lamb",
        data=cfg_mod.DataConfig(n_firms=48, n_months=120, n_features=5,
                                window=12, dates_per_batch=4,
                                firms_per_date=16),
        model=cfg_mod.ModelConfig(kind="gru", kwargs={"hidden": 8},
                                  scan_impl=scan_impl),
        optim=cfg_mod.OptimConfig(lr=1e-2, warmup_steps=4, epochs=epochs,
                                  early_stop_patience=patience,
                                  optimizer="lamb"),
        seed=3, **over)


def _splits(splits_cls, panel):
    return splits_cls.by_date(panel, int(panel.dates[84]),
                              int(panel.dates[102]))


def _panels():
    kw = dict(n_firms=48, n_months=120, n_features=5, seed=0)
    return (_splits(JaxSplits, jax_synthetic(**kw)),
            _splits(PanelSplits, synthetic_panel(**kw)))


def _same_fit(got, want, keys):
    assert got["epochs_run"] == want["epochs_run"]
    assert got["best_epoch"] == want["best_epoch"]
    assert len(got["history"]) == len(want["history"])
    for g, w in zip(got["history"], want["history"]):
        assert g["epoch"] == w["epoch"] and g["step"] == w["step"]
        for key in keys:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=0.0,
                                       err_msg=key)


def test_trainer_with_lamb_matches_jax(monkeypatch):
    monkeypatch.setenv("LFM_ASYNC", "0")
    jsplits, tsplits = _panels()
    jt = JaxTrainer(_tiny(jax_config, 4, 5, "xla"), jsplits)
    init = jax.tree_util.tree_map(np.asarray, jt.init_state().params)
    want = jt.fit()
    tt = Trainer(_tiny(config, 4, 5, "pallas_fused"), tsplits, device="cpu")
    assert type(tt.opt) is Lamb
    got = tt.fit(init_params=init)
    _same_fit(got, want, ("train_loss", "grad_norm", "val_ic", "val_mse"))
    final = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                  jt.state.params))
    for k, p in tt.state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), final[k], atol=1e-4,
                                   err_msg=k)


def test_ensemble_with_lamb_matches_jax(monkeypatch):
    monkeypatch.setenv("LFM_ASYNC", "0")
    jsplits, tsplits = _panels()
    jt = JaxEnsemble(_tiny(jax_config, 3, 5, "xla", n_seeds=3), jsplits)
    init = jax.tree_util.tree_map(np.asarray, jt.init_state().params)
    want = jt.fit()
    tt = EnsembleTrainer(_tiny(config, 3, 5, "pallas_fused", n_seeds=3),
                         tsplits, device="cpu")
    assert type(tt.opt) is Lamb and tt.opt.per_seed
    got = tt.fit(init_params=init)
    _same_fit(got, want, ("train_loss", "val_ic", "val_ic_std"))
    final = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                  jt.state.params))
    for k, p in tt.state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), final[k], atol=1e-4,
                                   err_msg=k)
