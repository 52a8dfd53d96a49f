"""Sequence parallelism in the port (``parallel/ring.py``, the models'
``seq_axis`` modes, the trainer's seq axis) against the JAX package's on
the 8-device virtual CPU mesh (``tests/conftest.py``), with the port on 2
or 4 gloo ranks (``parallel/launch.py run_ranks``).

* ``ring_attention`` on 2 and 4 ranks against the JAX ``ring_attention``
  under ``shard_map`` and against full attention (f32 atol 1e-5); its
  q/k/v gradients against ``jax.grad`` of full attention (atol 1e-4,
  rtol 1e-4, as ``tests/test_ring.py``); a row with no valid key gives 0.
* The seq transformer (dim 16, depth 2, 2 heads) and the distributed LRU
  (hidden 16, state 16, 2 layers), window 16, against JAX
  ``sequence_parallel_apply`` (atol 1e-5) and the plain model (atol
  1e-4); the SUM over the ranks of each rank's parameter gradients
  against the plain model's ``jax.grad`` (f32 atol 1e-4, rtol 1e-3, the
  tolerance of ``tests/test_ring.py:120-147``).
* Training from config on 2 seq ranks (the transformer, window 8): every
  rank's per-step loss and grad norm equal the one-process port's (rtol
  1e-5) and the one-device JAX trainer's (rtol 1e-4); each step's loss
  equals the JAX trainer's at ``n_seq_shards=2`` fed the same state. The
  JAX seq-sharded trainer's gradients are ``n_seq`` times the one-device
  ones (ROADMAP.md Queue C), so the port is held to its loss only.
* Composition with the data axis (as ``tests/test_ring.py:376``): the LRU
  on 2 date × 2 seq ranks against one process, losses and params.
* The validation errors (as ``:279``: a recurrence cannot shard its
  window, the window must divide, dropout raises; an ensemble composes)
  and the degrade warning (as ``:329``).
"""

import dataclasses
import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.models import build_model as jax_build_model
from lfm_quant_tpu.parallel import ring_attention as jax_ring_attention
from lfm_quant_tpu.parallel import seq_mesh, sequence_parallel_apply
from lfm_quant_tpu.parallel.mesh import shard_map_compat
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.parallel import mesh as M
from lfm_quant_tpu_torch.parallel.launch import run_ranks
from lfm_quant_tpu_torch.weights import flatten_params

import torch_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))
JOB_S = 120
B, H, W, DH = 3, 2, 16, 8
MODELS = {
    "transformer": {"dim": 16, "depth": 2, "heads": 2},
    "lru": {"hidden": 16, "state_dim": 16, "layers": 2},
}
PANEL = dict(n_firms=40, n_months=120, n_features=5, seed=0)
CUT = (84, 102)


def _ranks(n, fn, tmp_path, **payload):
    return run_ranks(n, f"torch_ranks:{fn}", payload, str(tmp_path / fn),
                     JOB_S, python_path=[HERE])


def _attn_inputs():
    rng = np.random.default_rng(0)
    q, k, v, r = (rng.standard_normal((B, H, W, DH)).astype(np.float32)
                  for _ in range(4))
    m = rng.random((B, W)) < 0.7
    empty = m.copy()
    empty[0] = False  # a row with no valid key anywhere
    return dict(q=q, k=k, v=v, r=r, m=m, m_empty=empty)


def full_attention(q, k, v, m):
    """Dense masked reference (``tests/test_ring.py``)."""
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * (DH ** -0.5)
    s = jnp.where(m[:, None, None, :], s, -1e30)
    p = jax.nn.softmax(s, axis=-1)
    any_valid = m.any(axis=-1)[:, None, None, None]
    return jnp.where(any_valid, jnp.einsum("bhqk,bhkd->bhqd", p, v), 0.0)


def _jax_ring(q, k, v, m, n):
    fn = shard_map_compat(
        functools.partial(jax_ring_attention, axis_name="seq"),
        mesh=seq_mesh(n),
        in_specs=(P(None, None, "seq", None),) * 3 + (P(None, "seq"),),
        out_specs=P(None, None, "seq", None))
    return jax.jit(fn)(q, k, v, m)


def _model_inputs(kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, W, 5)).astype(np.float32)
    m = rng.random((8, W)) < 0.8
    m[:, -1] = True
    m[3] = False  # an entirely invalid history
    r = rng.standard_normal(8).astype(np.float32)
    plain = jax_build_model(kind, **MODELS[kind])
    params = jax.tree_util.tree_map(np.asarray, jax.jit(plain.init)(
        jax.random.key(seed), jnp.asarray(x), jnp.asarray(m))["params"])
    return plain, params, x, m, r


@pytest.mark.parametrize("n", [2, 4])
def test_ring_and_seq_models_match_jax(tmp_path, n):
    a = _attn_inputs()
    models = {kind: _model_inputs(kind, 2 + i)
              for i, kind in enumerate(sorted(MODELS))}
    ranks = _ranks(n, "seq_checks", tmp_path, attn=a, models=[
        (kind, MODELS[kind], params, x, m, r)
        for kind, (_, params, x, m, r) in sorted(models.items())])
    assert [g["rank"] for g in ranks] == list(range(n))
    assert all(g["n_seq"] == n for g in ranks)
    q, k, v, mm = (jnp.asarray(a[t]) for t in ("q", "k", "v", "m"))

    # ring attention: outputs, gradients, an empty row
    out, dq, dk, dv = (np.concatenate([g["attn"][i] for g in ranks], axis=2)
                       for i in range(4))
    np.testing.assert_allclose(out, np.asarray(_jax_ring(q, k, v, mm, n)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, np.asarray(full_attention(q, k, v, mm)),
                               atol=1e-5, rtol=1e-5)
    want = jax.grad(lambda q, k, v: jnp.sum(full_attention(q, k, v, mm)
                                            * a["r"]),
                    argnums=(0, 1, 2))(q, k, v)
    for got, w, name in zip((dq, dk, dv), want, "qkv"):
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=f"d{name}")
    empty = np.concatenate([g["empty"] for g in ranks], axis=2)
    assert np.isfinite(empty).all() and np.abs(empty[0]).max() == 0.0
    np.testing.assert_allclose(empty, np.asarray(full_attention(
        q, k, v, jnp.asarray(a["m_empty"]))), atol=1e-5, rtol=1e-5)

    # the window-sharded models
    for i, kind in enumerate(sorted(models)):
        plain, params, x, m, r = models[kind]
        seq = jax_build_model(kind, seq_axis="seq", **MODELS[kind])
        xj, mj = jnp.asarray(x), jnp.asarray(m)
        # jit: the eager shard_map dispatches op by op (about a minute).
        want_seq = np.asarray(jax.jit(
            lambda p, x, m: sequence_parallel_apply(seq, p, x, m,
                                                    seq_mesh(n)))(
            params, xj, mj))
        want_plain = np.asarray(plain.apply({"params": params}, xj, mj))
        g_plain = flatten_params(jax.tree_util.tree_map(np.asarray, jax.jit(
            jax.grad(lambda p: jnp.sum(plain.apply({"params": p}, xj, mj)
                                       * r)))(params)))
        summed = {key: sum(g["models"][i][1][key] for g in ranks)
                  for key in g_plain}
        for g in ranks:
            y = g["models"][i][0]
            np.testing.assert_allclose(y, want_seq, atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(y, want_plain, atol=1e-4, rtol=1e-4)
            assert set(g["models"][i][1]) == set(g_plain)
        for key, w in g_plain.items():
            np.testing.assert_allclose(summed[key], w, atol=1e-4, rtol=1e-3,
                                       err_msg=f"{kind} {key}")


def _cfg(mod, kind, n_seq, n_data=1, **over):
    kw = dict(MODELS[kind], depth=1) if kind == "transformer" else dict(
        MODELS[kind], layers=1)
    return mod.RunConfig(
        name=f"seq_{kind}",
        data=mod.DataConfig(n_firms=40, n_months=120, n_features=5,
                            window=8, dates_per_batch=4, firms_per_date=16),
        model=mod.ModelConfig(kind=kind, kwargs=kw),
        optim=mod.OptimConfig(lr=3e-3, warmup_steps=2, epochs=1,
                              loss="mse"),
        seed=5, n_seq_shards=n_seq, n_data_shards=n_data, **over)


def _jax_splits():
    p = jax_synthetic(**PANEL)
    return JaxSplits.by_date(p, int(p.dates[CUT[0]]), int(p.dates[CUT[1]]))


def _bad(cfg):
    """Configs whose bind must fail (or warn) on a 2-rank world."""
    t = cfg.model
    return {
        "lstm": dataclasses.replace(cfg, model=config.ModelConfig(
            kind="lstm", kwargs={"hidden": 16})),
        "window": dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, window=9)),
        "dropout": dataclasses.replace(cfg, model=dataclasses.replace(
            t, kwargs=dict(t.kwargs, dropout=0.1))),
        "ensemble": dataclasses.replace(cfg, n_seeds=2, n_seq_shards=2),
        "degrade": dataclasses.replace(cfg, n_seq_shards=8),
    }


def test_seq_training_matches_jax(tmp_path):
    """2 seq ranks train the transformer as one process and as JAX."""
    splits = _jax_splits()
    t1 = JaxTrainer(_cfg(jax_config, "transformer", 1), splits)
    t2 = JaxTrainer(_cfg(jax_config, "transformer", 2), splits)
    assert t1.mesh is None and dict(t2.mesh.shape)["seq"] == 2
    s = t1.init_state()
    init = jax.tree_util.tree_map(np.asarray, s.params)
    jx = {"losses": [], "grad_norms": [], "seq_losses": [], "ratio": []}
    replicated = NamedSharding(t2.mesh, P())
    for b in t1.train_sampler.epoch(0):
        s2 = jax.tree_util.tree_map(lambda a: jax.device_put(a, replicated),
                                    s)
        _, m2 = t2._jit_step(s2, t2.dev, *t2._batch_args(b, train=True))
        s, m1 = t1._jit_step(s, t1.dev, *t1._batch_args(b, train=True))
        jx["losses"].append(float(m1["loss"]))
        jx["grad_norms"].append(float(m1["grad_norm"]))
        jx["seq_losses"].append(float(m2["loss"]))
        jx["ratio"].append(float(m2["grad_norm"]) / float(m1["grad_norm"]))
    final = flatten_params(jax.tree_util.tree_map(np.asarray, s.params))
    # The JAX seq-sharded trainer's gradients: n_seq times the true ones.
    np.testing.assert_allclose(jx["ratio"], 2.0, rtol=1e-5)

    cfg = _cfg(config, "transformer", 2)
    one = R.epoch_steps(cfg, PANEL, CUT, init)
    ranks = _ranks(2, "seq_train_checks", tmp_path, cfg=cfg, panel_kw=PANEL,
                   cut=CUT, init=init, bad=_bad(cfg))
    n_steps = len(jx["losses"])
    assert n_steps >= 4 and len(one["losses"]) == n_steps
    for got in ranks:
        assert got["mesh"] == (("data", "seq"), (1, 2), "gloo")
        for key in ("losses", "grad_norms"):
            np.testing.assert_allclose(got[key], one[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
            np.testing.assert_allclose(got[key], jx[key], rtol=1e-4,
                                       atol=1e-5, err_msg=key)
        np.testing.assert_allclose(got["losses"], jx["seq_losses"],
                                   rtol=1e-4, atol=1e-5)
        for k, v in final.items():
            if k.endswith("attn/key/bias"):
                # Its gradient is rounding noise (a key bias shifts all of
                # a query's scores alike), which Adam scales to lr-sized
                # steps: both sides within lr x steps of the zero init.
                bound = cfg.optim.lr * n_steps
                assert np.abs(got["params"][k]).max() <= bound, k
                assert np.abs(v).max() <= bound, k
                continue
            np.testing.assert_allclose(got["params"][k], v, atol=1e-4,
                                       err_msg=k)
        assert got["eval"]["n_months"] == one["eval"]["n_months"]
        np.testing.assert_allclose(
            [got["eval"]["ic"], got["eval"]["mse"]],
            [one["eval"]["ic"], one["eval"]["mse"]], rtol=1e-5, atol=1e-6)
        err = got["errors"]
        assert "window-shardable" in err["lstm"]
        assert "ValueError" in err["window"] and "divide" in err["window"]
        assert "ValueError" in err["dropout"] and "dropout" in err["dropout"]
        # Seeds take the ranks first; seq degrades to what is left.
        assert err["ensemble"].startswith("ok (('seed', 'data'), (2, 1)") \
            and "degrading to 1" in err["ensemble"]
        assert err["degrade"].startswith("ok (('data', 'seq'), (1, 2)") \
            and "degrading to 2" in err["degrade"]


def test_seq_composes_with_data(tmp_path):
    """The LRU on 2 date × 2 seq ranks: the one-process run's losses,
    grad norms and params."""
    init = jax.tree_util.tree_map(np.asarray, JaxTrainer(
        _cfg(jax_config, "lru", 1), _jax_splits()).init_state().params)
    cfg = _cfg(config, "lru", 2, n_data=2)
    one = R.epoch_steps(cfg, PANEL, CUT, init)
    ranks = _ranks(4, "seq_train_checks", tmp_path, cfg=cfg, panel_kw=PANEL,
                   cut=CUT, init=init, bad={})
    for r, got in enumerate(ranks):
        assert got["mesh"] == (("data", "seq"), (2, 2), "gloo")
        assert got["n_data"] == 2
        for key in ("losses", "grad_norms"):
            np.testing.assert_allclose(got[key], one[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
        for k, v in one["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(
            [got["eval"]["ic"], got["eval"]["mse"]],
            [one["eval"]["ic"], one["eval"]["mse"]], rtol=1e-5, atol=1e-6)


def test_one_process_degrades_with_a_warning():
    """The lc preset in one process: its seq axis degrades to 1 with the
    JAX warning; the mesh rules for a seq axis."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        mesh = M.data_mesh(1, n_seq_shards=8)
    assert mesh == M.DataMesh()
    assert any("degrading to 1" in str(w.message) for w in rec)
    assert M.resolve_seq_shards(4, 8) == 4
    assert M.resolve_seed_shards(64, 2) == 2
    assert M.resolve_seed_shards(3, 2) == 1
    assert M.resolve_seed_shards(6, 4) == 2
    m = M.DataMesh(n_data=2, rank=1, n_seq=2, seq_rank=1)
    assert (m.n_batch, m.batch_rank) == (4, 3)
