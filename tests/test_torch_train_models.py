"""The port's trainers on the MLP, transformer and LRU against the JAX
package's, on the CPU.

* ``Trainer`` on c1-, c4- and lru-shaped small configs (f32, dropout 0,
  window 12, widths 16) from the JAX ``Trainer``'s init: the per-epoch
  history within rtol 1e-4, the same best epoch, the final params within
  atol 1e-4 (the attention's key bias, whose gradient is rounding noise,
  within lr × steps of its zero init on both sides), the test-split
  forecasts within rtol 1e-4. The JAX side runs ``n_data_shards=1``: its
  sharded gradients are n_data times the true ones (ROADMAP.md Queue C).
* ``EnsembleTrainer`` on a small lru64 (3 seeds of the LRU) against the
  JAX ensemble from its stacked init, the same tolerances; ``seed_block``
  1 gives the unblocked run's losses.
* The train entry point on a small c4 with dropout: a run that dies after
  its first epoch, resumed from ``ckpt/latest``, ends with the history of
  an unbroken run (the dropout stream survives the resume).
* ``ScoringService(device="cpu")`` serving each kind (a dropout model
  among them: serving runs without dropout) against the JAX service on
  the same params: every month's scores within atol 1e-5.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.serve import ScoringService as JaxService
from lfm_quant_tpu.train.ensemble import EnsembleTrainer as JaxEnsemble
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.serve import ScoringService
from lfm_quant_tpu_torch.train.__main__ import main as train_main
from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
from lfm_quant_tpu_torch.train.loop import FitHarness, Trainer
from lfm_quant_tpu_torch.weights import flatten_params

#: preset whose shape each small config takes → (kind, kwargs)
SHAPES = {
    "c1": ("mlp", {"hidden": (16, 8)}),
    "c4": ("transformer", {"dim": 16, "depth": 2, "heads": 4}),
    "lru": ("lru", {"hidden": 16, "state_dim": 16, "layers": 2}),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its shapes are tiny, and the
    tier-1 run's workers share the machine's cores (more threads burn
    about three times the CPU for the same wall)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cfg_mod, preset, epochs=3, n_seeds=1, **over):
    kind, kw = SHAPES[preset]
    return cfg_mod.RunConfig(
        name=f"tiny_{preset}",
        data=cfg_mod.DataConfig(n_firms=48, n_months=120, n_features=5,
                                window=12, dates_per_batch=4,
                                firms_per_date=16),
        model=cfg_mod.ModelConfig(kind=kind, kwargs=dict(kw)),
        optim=cfg_mod.OptimConfig(lr=3e-3, warmup_steps=4, epochs=epochs,
                                  early_stop_patience=5),
        seed=3, n_seeds=n_seeds, n_data_shards=1, **over)


def _splits(splits_cls, panel):
    return splits_cls.by_date(panel, int(panel.dates[84]),
                              int(panel.dates[102]))


def _panels():
    return (jax_synthetic(n_firms=48, n_months=120, n_features=5, seed=0),
            synthetic_panel(n_firms=48, n_months=120, n_features=5, seed=0))


def _history_close(got, want, keys, tol):
    assert got["epochs_run"] == want["epochs_run"]
    assert got["best_epoch"] == want["best_epoch"]
    assert len(got["history"]) == len(want["history"])
    for g, w in zip(got["history"], want["history"]):
        assert g["epoch"] == w["epoch"] and g["step"] == w["step"]
        for key in keys:
            np.testing.assert_allclose(g[key], w[key], rtol=tol, atol=0.0,
                                       err_msg=key)


def _params_close(port, jax_params, atol, cfg, steps):
    """The final params within ``atol``, but for the attention's key bias:
    its gradient is rounding noise (a key bias shifts all of a query's
    scores alike, and the softmax is shift-invariant), which Adam scales
    to lr-sized steps, so both sides are held to that bound instead (it
    starts at zero)."""
    final = flatten_params(jax.tree_util.tree_map(np.asarray, jax_params))
    assert set(port) == set(final)
    for k, p in port.items():
        got = p.detach().numpy()
        if k.endswith("attn/key/bias"):
            bound = cfg.optim.lr * steps
            assert np.abs(got).max() <= bound, k
            assert np.abs(final[k]).max() <= bound, k
            continue
        np.testing.assert_allclose(got, final[k], atol=atol, err_msg=k)


@pytest.mark.parametrize("preset", sorted(SHAPES))
def test_trainer_matches_jax(monkeypatch, preset):
    monkeypatch.setenv("LFM_ASYNC", "0")
    jpanel, panel = _panels()
    jt = JaxTrainer(_cfg(jax_config, preset), _splits(JaxSplits, jpanel))
    init = jax.tree_util.tree_map(np.asarray, jt.init_state().params)
    want = jt.fit()
    tt = Trainer(_cfg(config, preset), _splits(PanelSplits, panel),
                 device="cpu")
    got = tt.fit(init_params=init)
    _history_close(got, want, ("train_loss", "grad_norm", "val_ic",
                               "val_mse"), 1e-4)
    _params_close(tt.state.params, jt.state.params, 1e-4, tt.cfg,
                  got["steps"])
    pred, valid = tt.predict("test")
    jpred, jvalid = jt.predict("test")
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(pred, jpred, rtol=1e-4, atol=1e-6)


def test_lru_ensemble_matches_jax(monkeypatch):
    """A small lru64: 3 stacked LRU members against the JAX ensemble, and
    ``seed_block`` 1 against the unblocked run."""
    monkeypatch.setenv("LFM_ASYNC", "0")
    jpanel, panel = _panels()
    jt = JaxEnsemble(_cfg(jax_config, "lru", epochs=2, n_seeds=3),
                     _splits(JaxSplits, jpanel))
    init = jax.tree_util.tree_map(np.asarray, jt.init_state().params)
    want = jt.fit()
    splits = _splits(PanelSplits, panel)
    tt = EnsembleTrainer(_cfg(config, "lru", epochs=2, n_seeds=3), splits,
                         device="cpu")
    got = tt.fit(init_params=init)
    _history_close(got, want, ("train_loss", "val_ic", "val_ic_std"), 1e-4)
    _params_close(tt.state.params, jt.state.params, 1e-4, tt.cfg,
                  got["steps"])
    blocked = EnsembleTrainer(_cfg(config, "lru", epochs=2, n_seeds=3,
                                   seed_block=1), splits, device="cpu")
    again = blocked.fit(init_params=init)
    np.testing.assert_allclose(again["step_losses"], got["step_losses"],
                               rtol=1e-6, atol=0.0)


class _Crash(Exception):
    pass


def test_cli_c4_with_dropout_resumes(tmp_path, capsys, monkeypatch):
    """``--config`` of a small c4 (window 12, dim 16, dropout 0.1) with
    ``--device cpu --scale 0.02 --epochs 2``: a run that dies after its
    first epoch, resumed, ends with the history of an unbroken run."""
    c4 = config.get_preset("c4")
    cfg = dataclasses.replace(
        c4, name="tiny_c4",
        data=dataclasses.replace(c4.data, window=12, firms_per_date=32,
                                 dates_per_batch=4),
        model=dataclasses.replace(c4.model, kwargs={
            "dim": 16, "depth": 2, "heads": 4, "dropout": 0.1}),
        optim=dataclasses.replace(c4.optim, warmup_steps=3))
    path = tmp_path / "tiny_c4.json"
    path.write_text(cfg.to_json())
    base = ["--config", str(path), "--device", "cpu", "--scale", "0.02",
            "--epochs", "2"]
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    assert train_main(base + ["--out", str(whole)]) == 0
    end_epoch = FitHarness.end_epoch

    def dies_after_epoch_0(self, epoch, *args):
        stop = end_epoch(self, epoch, *args)
        if epoch == 0:
            raise _Crash
        return stop

    monkeypatch.setattr(FitHarness, "end_epoch", dies_after_epoch_0)
    with pytest.raises(_Crash):
        train_main(base + ["--out", str(cut)])
    monkeypatch.undo()
    capsys.readouterr()
    assert train_main(base + ["--out", str(cut), "--resume"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["epochs_run"] == 2 and summary["steps"] > 0
    assert summary["mesh"][1] == [1]  # n_data_shards 16 resolves to 1

    def history(d):
        lines = (d / "tiny_c4" / "seed0" / "metrics.jsonl").read_text()
        return [{k: v for k, v in json.loads(x).items()
                 if k not in ("ts", "firm_months_per_sec")}
                for x in lines.splitlines()]

    assert [r["epoch"] for r in history(cut)] == [0, 1]
    for a, b in zip(history(cut), history(whole), strict=True):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("preset", sorted(SHAPES))
def test_service_serves_every_kind(preset):
    kind, kw = SHAPES[preset]
    if kind != "lru":
        kw = dict(kw, dropout=0.3)
    panel_kw = dict(n_firms=14, n_months=90, n_features=3, seed=3)

    def cfg(cfg_mod):
        return cfg_mod.RunConfig(
            name=f"serve_{preset}",
            data=cfg_mod.DataConfig(n_firms=14, n_months=90, n_features=3,
                                    window=6, dates_per_batch=2,
                                    firms_per_date=8),
            model=cfg_mod.ModelConfig(kind=kind, kwargs=kw),
            optim=cfg_mod.OptimConfig(epochs=1, warmup_steps=2))

    jpanel = jax_synthetic(**panel_kw)
    jt = JaxTrainer(cfg(jax_config), JaxSplits.by_date(jpanel, 197401,
                                                       197601))
    jt.state = jt.init_state()
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    jsvc = JaxService(max_rows=2, max_wait_ms=1.0)
    tsvc = ScoringService(device="cpu", max_rows=2, max_wait_ms=1.0)
    try:
        jsvc.register("u", jt, warm=False)
        tsvc.register("u", cfg(config), synthetic_panel(**panel_kw), params)
        months = tsvc.serveable_months("u")
        assert months == jsvc.serveable_months("u") and len(months) > 20
        for month in months:
            got, want = tsvc.score("u", month), jsvc.score("u", month)
            np.testing.assert_array_equal(got.firm_idx, want.firm_idx)
            np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                                       atol=1e-5, rtol=0.0)
            again = tsvc.score("u", month)
            np.testing.assert_array_equal(again.scores, got.scores)
    finally:
        jsvc.close()
        tsvc.close()
