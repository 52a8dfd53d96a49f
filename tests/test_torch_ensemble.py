"""The port's seed ensemble against the JAX package's.

* ``EnsembleTrainer`` (``lfm_quant_tpu_torch/train/ensemble.py``) with 3
  seeds on a tiny synthetic panel, the kernels' plain versions on the
  CPU, against the JAX ``EnsembleTrainer`` (XLA scan, ``LFM_ASYNC=0``)
  from the same stacked init (the JAX ``vmap(init)`` tree, bridged by
  ``weights.load_flax_params``): epochs run, best epoch, the per-epoch
  ``train_loss``, ``val_ic`` and ``val_ic_std`` within rtol 1e-4 in f32
  (0.05 in bf16), the final stacked params within atol 1e-4 (0.05), and
  ``evaluate`` and ``predict`` from the same stacked params.
* The per-seed optimizer against ``jax.vmap`` of the optax chain: atol
  1e-6, with one member clipped and one not.
* A seed-stacked ``RNNModel`` against S one-seed models, the seeded
  stacked init against one-seed inits, ``seed_block`` against the
  unblocked step, and the chunked validation sweep against one chunk.
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
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.models import RNNModel
from lfm_quant_tpu_torch.train import ensemble as E
from lfm_quant_tpu_torch.train.optim import AdamW
from lfm_quant_tpu_torch.weights import (
    flatten_params,
    flax_param_map,
    init_params,
    load_flax_params,
)

S = 3


def _tiny(cfg_mod, dtype_name, epochs, patience, scan_impl, **over):
    return cfg_mod.RunConfig(
        name="tiny_ens",
        data=cfg_mod.DataConfig(n_firms=48, n_months=120, n_features=5,
                                window=12, dates_per_batch=4,
                                firms_per_date=16),
        model=cfg_mod.ModelConfig(kind="lstm", kwargs={"hidden": 8},
                                  bf16=dtype_name == "bf16",
                                  scan_impl=scan_impl),
        optim=cfg_mod.OptimConfig(lr=3e-3, warmup_steps=4, epochs=epochs,
                                  early_stop_patience=patience),
        seed=3, n_seeds=S, **over)


def _splits(splits_cls, panel):
    return splits_cls.by_date(panel, int(panel.dates[84]),
                              int(panel.dates[102]))


def _port_splits():
    return _splits(PanelSplits, synthetic_panel(n_firms=48, n_months=120,
                                                n_features=5, seed=0))


CASES = {"f32": (6, 1), "bf16": (3, 5)}


@pytest.fixture(scope="module", params=sorted(CASES))
def fitted(request):
    """Both trainers fitted from the JAX ensemble's stacked init."""
    dtype_name = request.param
    epochs, patience = CASES[dtype_name]
    mp = pytest.MonkeyPatch()
    mp.setenv("LFM_ASYNC", "0")
    try:
        jpanel = jax_synthetic(n_firms=48, n_months=120, n_features=5,
                               seed=0)
        jt = JaxEnsemble(_tiny(jax_config, dtype_name, epochs, patience,
                               "xla"), _splits(JaxSplits, jpanel))
        init = jax.tree_util.tree_map(np.asarray, jt.init_state().params)
        want = jt.fit()
    finally:
        mp.undo()
    tt = E.EnsembleTrainer(_tiny(config, dtype_name, epochs, patience,
                                 "pallas_fused"), _port_splits(),
                           device="cpu")
    got = tt.fit(init_params=init)
    return dtype_name, jt, want, tt, got


def test_ensemble_trainer_matches_jax(fitted):
    dtype_name, jt, want, tt, got = fitted
    tol = 1e-4 if dtype_name == "f32" else 0.05
    assert got["n_seeds"] == want["n_seeds"] == S
    assert got["epochs_run"] == want["epochs_run"]
    assert got["best_epoch"] == want["best_epoch"]
    assert len(got["history"]) == len(want["history"])
    for g, w in zip(got["history"], want["history"]):
        assert g["epoch"] == w["epoch"] and g["step"] == w["step"]
        for key in ("train_loss", "val_ic", "val_ic_std"):
            np.testing.assert_allclose(g[key], w[key], rtol=tol, atol=0.0,
                                       err_msg=key)
    final = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                  jt.state.params))
    for k, p in tt.state.params.items():
        assert p.shape[0] == S
        np.testing.assert_allclose(p.detach().numpy(), final[k],
                                   atol=1e-4 if dtype_name == "f32" else 0.05)
    ev, jev = tt.evaluate(), jt.evaluate(jt.state.params)
    np.testing.assert_allclose(ev["ic_per_seed"], jev["ic_per_seed"],
                               rtol=tol, atol=1e-6)


def test_predict_matches_jax(fitted):
    """``predict`` from the JAX trainer's final stacked params: ``[S, N,
    T]`` forecasts and the shared validity mask."""
    dtype_name, jt, _, tt, _ = fitted
    want, want_valid = jt.predict("test")
    tt.state = tt.init_state(jax.tree_util.tree_map(np.asarray,
                                                    jt.state.params))
    got, valid = tt.predict("test")
    assert got.shape == want.shape == (S, 48, 120)
    np.testing.assert_array_equal(valid, want_valid)
    assert valid.any()
    np.testing.assert_allclose(got, want, atol=1e-5 if dtype_name == "f32"
                               else 0.05, rtol=0.0 if dtype_name == "f32"
                               else 0.05)


def test_members_differ(fitted):
    """Own init and own data order: every member's params and forecasts
    differ from the others'."""
    _, _, _, tt, _ = fitted
    for p in tt.state.params.values():
        for s in range(1, S):
            assert not torch.equal(p[0], p[s])
    pred, valid = tt.predict("val")
    assert np.std(pred[:, valid], axis=0).mean() > 0


def test_optimizer_per_seed_matches_optax_vmap():
    """``AdamW(per_seed=True)`` against ``jax.vmap`` of the optax chain on
    3 stacked members: member 0's gradients are scaled past the clip
    every step, member 2's stay under it, member 1 alternates."""
    rng = np.random.default_rng(1)
    shapes = {"a/kernel": (3, 4), "a/bias": (4,), "b/kernel": (4, 2)}
    params = {k: rng.standard_normal((S,) + s).astype(np.float32)
              for k, s in shapes.items()}
    lr, wd, clip, warmup, total = 1e-2, 1e-4, 1.0, 3, 10
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, min(warmup, total // 2), total, end_value=lr * 0.1)
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adamw(sched, weight_decay=wd))
    jp = {k: jax.numpy.asarray(v) for k, v in params.items()}
    jstate = jax.vmap(tx.init)(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = AdamW(lr, wd, clip, warmup, total, per_seed=True)
    tstate = opt.init(tp)
    clipped = np.zeros(S, int)
    for step in range(total + 2):
        scale = np.array([3.0, 3.0 if step % 2 else 0.05, 0.05], np.float32)
        grads = {k: (scale.reshape((S,) + (1,) * len(s))
                     * rng.standard_normal((S,) + s)).astype(np.float32)
                 for k, s in shapes.items()}
        jg = {k: jax.numpy.asarray(v) for k, v in grads.items()}
        upd, jstate = jax.vmap(tx.update)(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        gnorm = opt.step(tp, {k: torch.from_numpy(v)
                              for k, v in grads.items()}, tstate)
        assert gnorm.shape == (S,)
        np.testing.assert_allclose(gnorm.numpy(),
                                   np.asarray(jax.vmap(optax.global_norm)(jg)),
                                   rtol=1e-6)
        clipped += gnorm.numpy() >= clip
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0.0)
    assert clipped[0] == total + 2 and clipped[2] == 0 and clipped[1] > 0


def _stacked_model(cell, scan_impl, **kw):
    model = RNNModel(5, cell=cell, hidden=8, layers=2, head_hidden=(6,),
                     scan_impl=scan_impl, n_seeds=S, **kw)
    init_params(model, [torch.Generator().manual_seed(10 + s)
                        for s in range(S)])
    return model


@pytest.mark.parametrize("scan_impl", ["fused", "hoisted", "plain"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_stacked_model_equals_single_models(cell, scan_impl):
    """Each seed of a stacked two-layer model with a hidden head layer
    equals a one-seed model holding that member's params, on per-seed and
    on shared inputs; member s of the stacked init is the one-seed init
    from generator s. f32, atol 1e-6 (batched against single products)."""
    model = _stacked_model(cell, scan_impl)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((S, 7, 9, 5)).astype(
        np.float32))
    m = torch.from_numpy(rng.random((S, 7, 9)) < 0.8)
    with torch.no_grad():
        out = model(x, m)
        shared = model(x[0], m[0])
    assert out.shape == (S, 7) and shared.shape == (S, 7)
    stacked = flax_param_map(model)
    for s in range(S):
        one = RNNModel(5, cell=cell, hidden=8, layers=2, head_hidden=(6,),
                       scan_impl=scan_impl)
        load_flax_params(one, {k: p[s].detach().numpy()
                               for k, p in stacked.items()})
        fresh = RNNModel(5, cell=cell, hidden=8, layers=2, head_hidden=(6,))
        init_params(fresh, torch.Generator().manual_seed(10 + s))
        for k, p in flax_param_map(fresh).items():
            assert torch.equal(p, stacked[k][s]), k
        with torch.no_grad():
            np.testing.assert_allclose(out[s].numpy(),
                                       one(x[s], m[s]).numpy(), atol=1e-6)
            np.testing.assert_allclose(shared[s].numpy(),
                                       one(x[0], m[0]).numpy(), atol=1e-6)


def test_stacked_model_without_n_seeds_is_unchanged():
    """``n_seeds=None`` keeps the one-seed shapes."""
    model = RNNModel(5, hidden=8)
    assert model.embed.kernel.shape == (5, 8)
    assert model.h_proj[0].shape == (8, 32)
    out = model(torch.zeros(4, 9, 5), torch.ones(4, 9, dtype=torch.bool))
    assert out.shape == (4,)


def test_seed_block_is_a_rebatching():
    """Blocks of 1 seed step the same members as the whole stack at once
    (atol 1e-6: the batched products regroup); a block at or above the
    seed count is the unblocked step; a negative or non-dividing block
    raises."""
    base = _tiny(config, "f32", 2, 5, "pallas_fused")
    splits = _port_splits()
    runs = {}
    for block in (0, 1, S):
        tt = E.EnsembleTrainer(dataclasses.replace(base, seed_block=block),
                               splits, device="cpu")
        runs[block] = (tt.fit(), tt.state.params)
    for block in (1, S):
        for a, b in zip(runs[block][0]["step_losses"],
                        runs[0][0]["step_losses"]):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0.0)
        for k, p in runs[block][1].items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       runs[0][1][k].detach().numpy(),
                                       atol=1e-6, rtol=0.0)
    for bad in (-1, 2):
        with pytest.raises(ValueError, match="seed_block"):
            E.EnsembleTrainer(dataclasses.replace(base, seed_block=bad),
                              splits, device="cpu")
    with pytest.raises(ValueError, match="n_seeds >= 2"):
        E.EnsembleTrainer(dataclasses.replace(base, n_seeds=1), splits,
                          device="cpu")


def test_sweep_chunks_over_seeds(monkeypatch):
    """A state budget of one seed per chunk gives the per-seed ICs of the
    unchunked sweep; at c5 (8 months x 3325 firms, W 60, H 128, bf16) a
    chunk holds 10 of the 64 seeds."""
    tt = E.EnsembleTrainer(_tiny(config, "f32", 1, 5, "pallas_fused"),
                           _port_splits(), device="cpu")
    tt.state = tt.init_state()
    assert tt._seed_chunk(64) == S
    whole = tt.evaluate()["ic_per_seed"]
    monkeypatch.setattr(E, "EVAL_STATE_BYTES", 1)
    assert tt._seed_chunk(64) == 1
    np.testing.assert_allclose(tt.evaluate()["ic_per_seed"], whole,
                               rtol=1e-6)
    assert (4 << 30) // (8 * 3325 * 60 * 128 * 2) == 10


def test_run_dir_and_load_ensemble(tmp_path):
    """``run_ensemble_experiment`` writes ``ensemble.flag``, the config
    and the summary; ``load_ensemble`` restores the best stacked state."""
    cfg = dataclasses.replace(_tiny(config, "f32", 2, 5, "pallas_fused"),
                              out_dir=str(tmp_path))
    summary, tt, _ = E.run_ensemble_experiment(
        cfg, panel=synthetic_panel(n_firms=48, n_months=120, n_features=5,
                                   seed=0), device="cpu")
    run_dir = summary["run_dir"]
    for name in ("ensemble.flag", "config.json", "summary.json",
                 "metrics.jsonl"):
        assert (tmp_path / "tiny_ens" / "ensemble" / name).is_file()
    loaded, _ = E.load_ensemble(run_dir, device="cpu")
    assert int(loaded.state.step[0]) == tt._steps_per_epoch * (
        summary["best_epoch"] + 1)
    for k, p in loaded.state.params.items():
        assert torch.equal(p, tt.state.params[k])
    a, va = tt.predict("test")
    b, vb = loaded.predict("test")
    assert np.array_equal(va, vb) and np.array_equal(a, b)
