"""The heteroscedastic variance forward of the port against the JAX
package's, on the CPU (f32, tiny shapes):

* ``Trainer.predict(return_variance=True)`` and
  ``EnsembleTrainer.predict(return_variance=True)`` against the JAX
  trainers', from the JAX init carried by ``weights.py``: forecasts and
  aleatoric variances at rtol 1e-4, the validity exact;
* a heteroscedastic walk-forward's stitched variances against JAX
  ``run_walkforward`` at rtol 1e-4, and the ``mean_minus_total_std``
  report of the port's backtest entry on its ``walkforward.npz`` against
  JAX ``backtest.py``'s on the same file, at ``tests/test_jax_backtest.py``'s
  ``TOL``; the port's backtest on a run dir and ``--wf-score`` take the
  same mode;
* the ``ValueError``s the JAX trainer raises.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

import backtest as jax_backtest_cli
from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.train.ensemble import EnsembleTrainer as JaxEnsemble
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu.train.walkforward import run_walkforward as jax_walkforward
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.backtest import engine
from lfm_quant_tpu_torch.backtest.__main__ import main as backtest_main
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.train import walkforward as W
from lfm_quant_tpu_torch.train.__main__ import main as train_main
from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
from lfm_quant_tpu_torch.train.forecast import load_forecaster
from lfm_quant_tpu_torch.train.loop import Trainer
from test_jax_backtest import TOL
from test_torch_walkforward import _bridge_inits

PANEL = dict(n_firms=40, n_months=120, n_features=4, seed=0, horizon=3)
SWEEP = dict(step_months=12, val_months=12, n_folds=2, train_months=36)


def _het(cfg_mod, cell="lstm", n_seeds=1, epochs=2):
    """A tiny heteroscedastic config (``loss="nll"``: the two-wide head;
    ``cell`` "mlp" where the model's kind does not matter and a scan
    would only lengthen the JAX compile)."""
    return cfg_mod.RunConfig(
        name="tiny_het",
        data=cfg_mod.DataConfig(n_firms=40, n_months=120, n_features=4,
                                window=12, dates_per_batch=4,
                                firms_per_date=16, horizon=3),
        model=cfg_mod.ModelConfig(
            kind=cell, kwargs={"hidden": (16,) if cell == "mlp" else 16},
            scan_impl="xla"),
        optim=cfg_mod.OptimConfig(lr=3e-3, warmup_steps=4, epochs=epochs,
                                  loss="nll", early_stop_patience=1),
        seed=5, n_seeds=n_seeds)


def _port(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, scan_impl="pallas_fused"))


def _splits(splits_cls, panel):
    return splits_cls.by_date(panel, int(panel.dates[84]),
                              int(panel.dates[102]))


@pytest.mark.parametrize("cell,n_seeds", [("lstm", 1), ("mlp", 2)])
def test_predict_variance_matches_jax(cell, n_seeds):
    """The test split from the JAX init: the mean and ``exp(log_var)`` at
    rtol 1e-4, the validity exact, every valid variance finite and > 0,
    the mean equal to the point predict's."""
    jpanel = jax_synthetic(**PANEL)
    panel = synthetic_panel(**PANEL)
    jcls, cls = ((JaxTrainer, Trainer) if n_seeds == 1
                 else (JaxEnsemble, EnsembleTrainer))
    jt = jcls(_het(jax_config, cell, n_seeds), _splits(JaxSplits, jpanel))
    jt.state = jt.init_state()
    tt = cls(_port(_het(config, cell, n_seeds)), _splits(PanelSplits, panel),
             device="cpu")
    tt.state = tt.init_state(jax.tree_util.tree_map(np.asarray,
                                                    jt.state.params))
    lead = (n_seeds,) if n_seeds > 1 else ()
    want_fc, want_var, want_valid = jt.predict(return_variance=True)
    fc, var, valid = tt.predict(return_variance=True)
    assert fc.shape == var.shape == lead + (40, 120)
    np.testing.assert_array_equal(valid, want_valid)
    assert valid.any()
    np.testing.assert_allclose(fc, want_fc, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(var, want_var, rtol=1e-4, atol=1e-7)
    assert np.isfinite(var[..., valid]).all()
    assert (var[..., valid] > 0).all() and not var[..., ~valid].any()
    np.testing.assert_array_equal(fc, tt.predict()[0])


def test_variance_errors_match_jax():
    """A point head has no variance; MC sampling and the variance do not
    combine (the JAX trainer's ValueErrors)."""
    panel = synthetic_panel(**PANEL)
    point = dataclasses.replace(_port(_het(config)), optim=dataclasses.replace(
        _het(config).optim, loss="mse"))
    tt = Trainer(point, _splits(PanelSplits, panel), device="cpu")
    tt.state = tt.init_state()
    with pytest.raises(ValueError, match="heteroscedastic"):
        tt.predict(return_variance=True)
    ens = EnsembleTrainer(dataclasses.replace(point, n_seeds=2),
                          _splits(PanelSplits, panel), device="cpu")
    ens.state = ens.init_state()
    with pytest.raises(ValueError, match="heteroscedastic"):
        ens.predict(return_variance=True)
    drop = _port(_het(config, "lstm"))
    drop = dataclasses.replace(drop, model=dataclasses.replace(
        drop.model, kind="mlp", kwargs={"hidden": (8,), "dropout": 0.2}))
    tt = Trainer(drop, _splits(PanelSplits, panel), device="cpu")
    tt.state = tt.init_state()
    with pytest.raises(ValueError, match="not combinable"):
        tt.predict(mc_samples=2, return_variance=True)
    # Without dropout the MC check comes first, as in JAX.
    tt = Trainer(_port(_het(config)), _splits(PanelSplits, panel),
                 device="cpu")
    tt.state = tt.init_state()
    with pytest.raises(ValueError, match="dropout"):
        tt.predict(mc_samples=2, return_variance=True)


def test_walkforward_variance_and_total_std_match_jax(monkeypatch, tmp_path):
    """Two heteroscedastic folds from the JAX inits: the stitched
    forecast and variance against JAX ``run_walkforward`` (rtol 1e-4),
    both ``walkforward.npz`` files carrying ``variance``; the
    ``mean_minus_total_std`` report of the port's backtest entry on the
    port's file against JAX ``backtest.py``'s on the same file (``TOL``)."""
    monkeypatch.setenv("LFM_ASYNC", "0")
    inits = {}
    _bridge_inits(monkeypatch, inits)
    panel = synthetic_panel(**PANEL)
    start = int(panel.dates[48])
    want_fc, want_valid, _ = jax_walkforward(
        _het(jax_config, "mlp", epochs=1), jax_synthetic(**PANEL),
        start=start, out_dir=str(tmp_path / "jax"), **SWEEP)
    fc, valid, summary = W.run_walkforward(
        _port(_het(config, "mlp", epochs=1)), panel, start=start,
        out_dir=str(tmp_path / "wf"),
        score_modes=["mean", ("mean_minus_total_std", 0.5)],
        score_kwargs=dict(min_universe=5), device="cpu", **SWEEP)
    want = np.load(tmp_path / "jax" / "walkforward.npz")
    got = np.load(tmp_path / "wf" / "walkforward.npz")
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(fc, want_fc, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["variance"], want["variance"], rtol=1e-4,
                               atol=1e-7)
    assert (got["variance"][valid] > 0).all()
    assert set(summary["backtest"]) == {"mean", "mean_minus_total_std@0.5"}
    reports = {}
    for name, cli in (("jax", jax_backtest_cli.main), ("port", backtest_main)):
        out = tmp_path / f"{name}.json"
        args = ["--forecast-npz", str(tmp_path / "wf"), "--mode",
                "mean_minus_total_std", "--risk-lambda", "0.5",
                "--json-out", str(out)]
        assert cli(args + (["--device", "cpu"] if name == "port" else [])) \
            == 0
        reports[name] = json.loads(out.read_text())
    a, b = reports["jax"], reports["port"]
    assert a["n_months"] == b["n_months"] and a["dates"] == b["dates"]
    for key, tol in (("monthly_returns", TOL["ret"]),
                     ("monthly_ic", TOL["ic"]), ("turnover", TOL["turn"]),
                     ("quantile_profile", TOL["profile"])):
        np.testing.assert_allclose(b[key], a[key], atol=tol, err_msg=key)
    np.testing.assert_allclose(b["cagr"], a["cagr"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        summary["backtest"]["mean_minus_total_std@0.5"]["cagr"], a["cagr"],
        rtol=1e-4, atol=1e-6)


def test_backtest_run_dir_and_wf_score_take_total_std(tmp_path):
    """A heteroscedastic run dir trained by the CLI: the backtest entry's
    ``mean_minus_total_std`` report equals the numpy engine's on the
    model's own forecast and variance; ``--wf-score
    mean_minus_total_std`` grades a heteroscedastic walk-forward."""
    cfg = _port(_het(config, "mlp", epochs=1))
    path = tmp_path / "het.json"
    path.write_text(dataclasses.replace(cfg, out_dir=str(tmp_path))
                    .to_json())
    base = ["--config", str(path), "--device", "cpu"]
    assert train_main(base) == 0
    run_dir = str(tmp_path / "tiny_het" / "seed5")
    out = tmp_path / "report.json"
    assert backtest_main(["--run-dir", run_dir, "--device", "cpu",
                          "--mode", "mean_minus_total_std",
                          "--json-out", str(out)]) == 0
    model, splits, _ = load_forecaster(run_dir, device="cpu")
    fc, var, valid = model.predict("test", return_variance=True)
    agg, v = engine.aggregate_ensemble(fc[None], valid,
                                       "mean_minus_total_std", 1.0,
                                       aleatoric_var=var[None])
    ref = engine.run_backtest(agg, v, splits.panel)
    got = json.loads(out.read_text())
    assert got["n_months"] == ref.n_months
    np.testing.assert_allclose(got["monthly_returns"], ref.monthly_returns,
                               atol=TOL["ret"])
    assert train_main(base + ["--walk-forward", "12", "--wf-folds", "1",
                              "--wf-val-months", "12", "--wf-score",
                              "mean_minus_total_std@2"]) == 0
    summary = json.loads((tmp_path / "tiny_het" / "wf" / "summary.json")
                         .read_text())
    assert set(summary["backtest"]) == {"mean_minus_total_std@2"}
    assert "variance" in np.load(tmp_path / "tiny_het" / "wf"
                                 / "walkforward.npz")
