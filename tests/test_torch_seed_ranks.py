"""The seed axis across ranks (``train/ensemble.py`` over
``parallel/mesh.py``) against one process and the JAX ``EnsembleTrainer``
(on the 8-device virtual CPU mesh of ``tests/conftest.py``), with the
port on 2 or 4 gloo ranks (``parallel/launch.py run_ranks``).

* 4 LSTM members (hidden 8, window 12, f32, the kernels' plain versions)
  on 2 and 4 ranks (2 and 1 members each), from the JAX ensemble's
  stacked init: every rank's history (``train_loss``, ``val_ic``,
  ``val_ic_std``) equals the one-process port's (rtol 1e-5) and the JAX
  ensemble's (rtol 1e-4), with the same epochs run and best epoch
  (early stopping at patience 1); each rank's members' params are the
  one-process rows; the gathered ``predict`` equals one process.
* The checkpoint: rank 0 wrote every member's state once; one process
  loads it (``load_ensemble``) and predicts what the ranks did. A fit
  on 2 ranks killed after its first epoch and resumed on 2 ranks ends as
  the unbroken one-process fit.
* Composition (as ``tests/test_ring.py:415``): 2 LRU members on 2 seed ×
  2 date × 2 seq ranks against the one-process ensemble (rtol 1e-4).
* ``seed_block`` per rank (JAX ``train/ensemble.py:330-340``): 6 members
  on 2 ranks are 3 a rank; a block of 2 raises naming the per-shard
  count, a block of 4 is a no-op.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.train.ensemble import EnsembleTrainer as JaxEnsemble
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.parallel.launch import run_ranks
from lfm_quant_tpu_torch.train.ensemble import load_ensemble

import torch_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))
JOB_S = 120
S = 4
PANEL = dict(n_firms=40, n_months=120, n_features=5, seed=0)
CUT = (84, 102)
KEYS = ("train_loss", "val_ic", "val_ic_std")


def _cfg(mod, out_dir, name="seeds", **over):
    over = dict(dict(seed=3, n_seeds=S), **over)
    return mod.RunConfig(
        name=name,
        data=mod.DataConfig(n_firms=40, n_months=120, n_features=5,
                            window=12, dates_per_batch=4, firms_per_date=16),
        model=mod.ModelConfig(kind="lstm", kwargs={"hidden": 8},
                              scan_impl="xla" if mod is jax_config
                              else "pallas_fused"),
        optim=mod.OptimConfig(lr=5e-3, warmup_steps=4, epochs=6,
                              early_stop_patience=1),
        out_dir=str(out_dir), **over)


def _ranks(n, tmp_path, job="ensemble_fit", **payload):
    return run_ranks(n, f"torch_ranks:{job}", payload,
                     str(tmp_path / f"job{n}"), JOB_S, python_path=[HERE])


def _histories_equal(got, want, rtol):
    assert got["epochs_run"] == want["epochs_run"]
    assert got["best_epoch"] == want["best_epoch"]
    assert len(got["history"]) == len(want["history"])
    for g, w in zip(got["history"], want["history"]):
        assert g["epoch"] == w["epoch"] and g["step"] == w["step"]
        for key in KEYS:
            np.testing.assert_allclose(g[key], w[key], rtol=rtol, atol=0.0,
                                       err_msg=key)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX ensemble and the one-process port, both fitted from the JAX
    stacked init."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LFM_ASYNC", "0")
    try:
        p = jax_synthetic(**PANEL)
        jt = JaxEnsemble(_cfg(jax_config, tmp_path_factory.mktemp("jax")),
                         JaxSplits.by_date(p, int(p.dates[CUT[0]]),
                                           int(p.dates[CUT[1]])))
        init = jax.tree_util.tree_map(np.asarray, jt.init_state().params)
        want = jt.fit()
    finally:
        mp.undo()
    one = R.ensemble_fit(_cfg(config, tmp_path_factory.mktemp("one")),
                         PANEL, CUT, init=init)
    return init, want, one


@pytest.mark.parametrize("n", [2, 4])
def test_seed_ranks_match_one_process_and_jax(tmp_path, reference, n):
    init, want, one = reference
    _histories_equal(one["summary"], want, 1e-4)
    assert want["epochs_run"] < 6  # the early stop is exercised
    bad = {}
    if n == 2:
        out = tmp_path / "bad"
        bad = {"block2": _cfg(config, out, n_seeds=6, seed_block=2),
               "block4": _cfg(config, out, n_seeds=6, seed_block=4)}
    ranks = _ranks(n, tmp_path, cfg=_cfg(config, tmp_path), panel_kw=PANEL,
                   cut=CUT, init=init, bad=bad)
    per = S // n
    for r, got in enumerate(ranks):
        assert got["seeds"] == list(range(r * per, (r + 1) * per))
        assert got["mesh"] == (("seed", "data"), (n, 1), "gloo")
        _histories_equal(got["summary"], one["summary"], 1e-5)
        _histories_equal(got["summary"], want, 1e-4)
        np.testing.assert_allclose(got["summary"]["step_losses"],
                                   one["summary"]["step_losses"], rtol=1e-5)
        for k, v in one["params"].items():
            np.testing.assert_allclose(got["params"][k],
                                       v[r * per:(r + 1) * per], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        (fc, valid), (fc1, valid1) = got["predict"], one["predict"]
        assert valid.any() and np.array_equal(valid, valid1)
        np.testing.assert_allclose(fc, fc1, rtol=1e-5, atol=1e-6)
    if n == 2:
        err = ranks[0]["errors"]
        assert "per-shard seed count 3" in err["block2"]
        assert err["block4"].startswith("ok (('seed', 'data'), (2, 1)")
        # The checkpoint: every member, written once, loaded by one
        # process.
        run_dir = os.path.join(tmp_path, "seeds", "ensemble")
        trainer, _ = load_ensemble(run_dir, device="cpu")
        assert trainer.n_local == S
        for k, v in one["params"].items():
            np.testing.assert_allclose(
                trainer.state.params[k].detach().numpy(), np.concatenate(
                    [g["params"][k] for g in ranks]), rtol=0, atol=0,
                err_msg=k)
        fc, valid = trainer.predict("test")
        np.testing.assert_array_equal(valid, ranks[0]["predict"][1])
        np.testing.assert_allclose(fc, ranks[0]["predict"][0], rtol=1e-6,
                                   atol=1e-7)


def test_seed_ranks_resume(tmp_path, reference):
    """Killed on 2 ranks after epoch 0, resumed on 2 ranks from the
    checkpoint rank 0 wrote: the unbroken one-process fit's end."""
    init, _, one = reference
    cfg = _cfg(config, tmp_path)
    crashed = _ranks(2, tmp_path, cfg=cfg, panel_kw=PANEL, cut=CUT,
                     init=init, crash_after_epoch=0)
    assert all(g.get("crashed") for g in crashed)
    resumed = _ranks(2, tmp_path, cfg=cfg, panel_kw=PANEL, cut=CUT,
                     init=init, resume=True)
    for r, got in enumerate(resumed):
        s, s1 = got["summary"], one["summary"]
        for key in ("epochs_run", "best_epoch", "steps"):
            assert s[key] == s1[key], key
        np.testing.assert_allclose(s["best_val_ic"], s1["best_val_ic"],
                                   rtol=1e-5)
        # The resumed history holds the epochs after the crash.
        _histories_equal(dict(s1, history=s1["history"][1:]),
                         dict(s, epochs_run=s1["epochs_run"]), 1e-5)
        for k, v in one["params"].items():
            np.testing.assert_allclose(got["params"][k], v[2 * r:2 * r + 2],
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_seed_data_seq_compose(tmp_path):
    """2 LRU members on 2 seed x 2 date x 2 seq ranks: the one-process
    ensemble's histories and params (as ``tests/test_ring.py:415``)."""

    def cfg(out, **over):
        return dataclasses.replace(
            _cfg(config, out, name="compose", n_seeds=2, **over),
            data=config.DataConfig(n_firms=40, n_months=120, n_features=5,
                                   window=8, dates_per_batch=4,
                                   firms_per_date=16),
            model=config.ModelConfig(kind="lru", kwargs={
                "hidden": 16, "state_dim": 16, "layers": 1}),
            optim=config.OptimConfig(lr=3e-3, warmup_steps=4, epochs=2,
                                     early_stop_patience=5))

    one = R.ensemble_fit(cfg(tmp_path / "one"), PANEL, CUT)
    ranks = _ranks(8, tmp_path, cfg=cfg(tmp_path / "ranks", n_data_shards=2,
                                        n_seq_shards=2),
                   panel_kw=PANEL, cut=CUT)
    for r, got in enumerate(ranks):
        assert got["mesh"] == (("seed", "data", "seq"), (2, 2, 2), "gloo")
        assert got["seeds"] == [r // 4]
        _histories_equal(got["summary"], one["summary"], 1e-4)
        for k, v in one["params"].items():
            np.testing.assert_allclose(got["params"][k], v[r // 4:r // 4 + 1],
                                       rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["predict"][0], one["predict"][0],
                                   rtol=1e-4, atol=1e-5)
