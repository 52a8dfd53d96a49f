"""Telemetry around the port's train and backtest entry points, against
the JAX package's.

* The trainers' spans: ``Trainer.fit`` and ``EnsembleTrainer.fit`` emit
  ``fit`` (``kind``, ``epochs_run``, ``best_epoch``; the ensemble's
  ``n_seeds``), each epoch's ``sample`` and ``h2d`` (``epoch``) with the
  max-shape epochs and the bucketed ones (``LFM_BUCKETS=1``), and the
  validation sweeps' ``eval``; the names, categories and argument keys of
  the JAX trainer's spans for the same config, the same epochs sampled.
* ``python -m lfm_quant_tpu_torch.train`` opens a run scope in its run
  dir (``entry: train``), ``python -m lfm_quant_tpu_torch.backtest``
  appends its own (``entry: backtest``, ``predict`` and ``score``
  spans), and the unchanged ``scripts/trace_report.py`` renders the
  training run (its fit, epochs and host syncs) from the two processes.
"""

import json
import os

import jax
import numpy as np
import pytest

from lfm_quant_tpu.config import (DataConfig, ModelConfig, OptimConfig,
                                  RunConfig)
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.serve.stats import load_trace_report
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu.utils import telemetry as jax_telemetry
from lfm_quant_tpu_torch import config as tconfig
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
from lfm_quant_tpu_torch.train.loop import Trainer
from lfm_quant_tpu_torch.utils import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PANEL = dict(n_firms=40, n_months=100, n_features=4, seed=5)
SPLIT = (197401, 197601)
TRACED = ("fit", "eval", "sample", "h2d")


@pytest.fixture(autouse=True)
def _lockstep(monkeypatch):
    monkeypatch.setenv("LFM_ASYNC", "0")
    monkeypatch.delenv("LFM_BUCKETS", raising=False)
    monkeypatch.delenv("LFM_TELEMETRY", raising=False)


def _cfg(epochs=2, n_seeds=1):
    return RunConfig(
        name="tele_t",
        data=DataConfig(n_firms=PANEL["n_firms"], n_months=PANEL["n_months"],
                        n_features=PANEL["n_features"], window=6,
                        dates_per_batch=2, firms_per_date=8),
        model=ModelConfig(kind="mlp", kwargs={"hidden": (8,)}),
        optim=OptimConfig(lr=3e-3, epochs=epochs, warmup_steps=2,
                          loss="mse", early_stop_patience=5),
        n_seeds=n_seeds)


def _spans(run_dir):
    with open(os.path.join(run_dir, "spans.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _traced(spans):
    return [s for s in spans if s["name"] in TRACED]


def _shape(spans):
    """name → (cat, sorted arg keys), and the epochs sampled."""
    shape = {s["name"]: (s["cat"], sorted(s.get("args", {})))
             for s in spans}
    epochs = [s["args"]["epoch"] for s in spans if s["name"] == "sample"]
    return shape, epochs


@pytest.mark.parametrize("buckets", ["0", "1"])
def test_trainer_spans_match_jax(tmp_path, monkeypatch, buckets):
    monkeypatch.setenv("LFM_BUCKETS", buckets)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    cfg = _cfg()
    with jax_telemetry.run_scope(jdir, extra={"entry": "test"}):
        jtr = JaxTrainer(cfg, JaxSplits.by_date(jax_synthetic(**PANEL),
                                                *SPLIT))
        jfit = jtr.fit()
        jtr.evaluate(jtr.state.params)
    with telemetry.run_scope(tdir, extra={"entry": "test"}):
        ttr = Trainer(tconfig.RunConfig.from_json(cfg.to_json()),
                      PanelSplits.by_date(synthetic_panel(**PANEL), *SPLIT),
                      device="cpu")
        tfit = ttr.fit(init_params=jax.tree_util.tree_map(
            np.asarray, jtr.init_state().params))
        ttr.evaluate()
    jshape, jepochs = _shape(_traced(_spans(jdir)))
    tshape, tepochs = _shape(_traced(_spans(tdir)))
    assert set(tshape) == set(TRACED) == set(jshape)
    assert tshape == jshape
    assert tepochs == jepochs
    fit = [s for s in _spans(tdir) if s["name"] == "fit"]
    assert len(fit) == 1
    assert fit[0]["args"] == {"kind": "trainer",
                              "epochs_run": tfit["epochs_run"],
                              "best_epoch": tfit["best_epoch"]}
    assert tfit["epochs_run"] == jfit["epochs_run"]
    # Every epoch's sample and h2d inside the fit, on the fit's thread.
    spans = _spans(tdir)
    for name in ("sample", "h2d"):
        got = [s for s in spans if s["name"] == name]
        assert len(got) == len(jepochs)
        assert all(s["depth"] >= 1 for s in got)


def test_ensemble_spans(tmp_path):
    tdir = str(tmp_path / "torch")
    cfg = tconfig.RunConfig.from_json(_cfg(n_seeds=3).to_json())
    with telemetry.run_scope(tdir, extra={"entry": "test"}):
        ens = EnsembleTrainer(cfg, PanelSplits.by_date(
            synthetic_panel(**PANEL), *SPLIT), device="cpu")
        out = ens.fit()
    spans = _spans(tdir)
    shape, epochs = _shape(_traced(spans))
    # The JAX ensemble's spans (train/ensemble.py:460-608).
    assert shape == {"fit": ("fit", ["best_epoch", "epochs_run", "kind",
                                     "n_seeds"]),
                     "eval": ("eval", []),
                     "sample": ("span", ["epoch"]),
                     "h2d": ("span", ["epoch"])}
    assert epochs == list(range(out["epochs_run"]))
    fit = next(s for s in spans if s["name"] == "fit")
    assert fit["args"]["kind"] == "ensemble" and fit["args"]["n_seeds"] == 3


def test_train_and_backtest_entry_points_render_in_trace_report(tmp_path):
    from lfm_quant_tpu_torch.backtest.__main__ import main as backtest_main
    from lfm_quant_tpu_torch.train.__main__ import main as train_main

    cfg_path = tmp_path / "cfg.json"
    cfg = json.loads(_cfg(epochs=2).to_json())
    cfg["out_dir"] = str(tmp_path / "runs")
    cfg["data"]["n_firms"] = 120  # the backtest wants 20 firms a month
    cfg_path.write_text(json.dumps(cfg))
    assert train_main(["--config", str(cfg_path), "--device", "cpu"]) == 0
    run_dir = os.path.join(str(tmp_path / "runs"), "tele_t", "seed0")
    with open(os.path.join(run_dir, "manifest.json")) as fh:
        assert json.load(fh)["entry"] == "train"
    assert backtest_main(["--run-dir", run_dir, "--device", "cpu"]) == 0
    assert any(f.startswith("manifest.") and f != "manifest.json"
               for f in os.listdir(run_dir))  # the second process's
    names = {s["name"] for s in _spans(run_dir)}
    assert {"fit", "eval", "sample", "h2d", "predict", "score"} <= names

    tr_mod = load_trace_report(REPO)
    rep = tr_mod.build_report(tr_mod.load_run(run_dir))
    assert rep["n_fits"] == 1 and rep["n_epochs"] == 2
    assert rep["syncs_per_epoch"] == 1.0
    tops = {s["name"] for s in rep["top_spans"]}
    assert {"fit", "eval"} <= tops
    tr_mod.print_report(rep)  # renders
