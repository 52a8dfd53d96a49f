"""The port's walk-forward retraining against the JAX package's.

* The fold schedule (``walkforward_folds``) and ``month_add``: exactly
  the JAX package's.
* ``run_walkforward`` with 3 folds, one seed and two, against JAX
  ``run_walkforward`` (``LFM_ASYNC=0``) on the same panel, every fold of
  the port starting from the params of the JAX fold's ``init_state()``
  (bridged through ``weights.load_flax_params``): per-fold ``best_epoch``
  and ``epochs_run`` exact, ``best_val_ic`` and the stitched forecast at
  rtol 1e-4 in f32, the validity exact; the end-of-sweep grading against
  the JAX one.
* The protocols: ``resume`` skips completed folds and rejects another
  schedule, ``warm_start`` carries the previous fold's best params (also
  across a resume), the ensemble marker follows the trainer kind of a
  reused dir, and ``python -m lfm_quant_tpu_torch.train --walk-forward``
  with ``--device cpu`` end to end, its argument checks, and raising
  without a card. The fold-stacked sweep has its own file
  (``tests/test_torch_foldstack.py``).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.train.ensemble import EnsembleTrainer as JaxEnsemble
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu.train.walkforward import month_add as jax_month_add
from lfm_quant_tpu.train.walkforward import run_walkforward as jax_walkforward
from lfm_quant_tpu.train.walkforward import (
    walkforward_folds as jax_folds,
)
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.backtest import engine
from lfm_quant_tpu_torch.backtest.__main__ import main as backtest_main
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.forecast import main as forecast_main
from lfm_quant_tpu_torch.train import walkforward as W
from lfm_quant_tpu_torch.train.__main__ import main as train_main
from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
from lfm_quant_tpu_torch.train.forecast import load_forecaster
from lfm_quant_tpu_torch.train.loop import Trainer, run_experiment

PANEL = dict(n_firms=40, n_months=120, n_features=4, seed=0, horizon=3)
# Rolling 36-month train windows, 12-month validation and steps: 3 folds
# forecasting months 72..107.
SWEEP = dict(step_months=12, val_months=12, n_folds=3, train_months=36)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its shapes are tiny, and the
    tier-1 run's workers share the machine's cores (more threads burn
    about three times the CPU for the same wall)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(cfg_mod, cell="lstm", n_seeds=1, epochs=4, patience=1):
    return cfg_mod.RunConfig(
        name="tiny_wf",
        data=cfg_mod.DataConfig(n_firms=40, n_months=120, n_features=4,
                                window=12, dates_per_batch=4,
                                firms_per_date=16, horizon=3),
        model=cfg_mod.ModelConfig(kind=cell, kwargs={"hidden": 16},
                                  scan_impl="xla"),
        optim=cfg_mod.OptimConfig(lr=1e-2, warmup_steps=4, epochs=epochs,
                                  early_stop_patience=patience),
        seed=7, n_seeds=n_seeds)


def _port_cfg(**kw):
    cfg = _tiny(config, **kw)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, scan_impl="pallas_fused"))


@pytest.fixture(scope="module")
def panel():
    return synthetic_panel(**PANEL)


def _start(panel):
    return int(panel.dates[48])


def test_month_add_and_fold_schedule_match_jax(panel):
    jpanel = jax_synthetic(**PANEL)
    for ym, k in ((197001, 12), (197011, 3), (197001, -1), (199912, 1),
                  (198006, -30)):
        assert W.month_add(ym, k) == jax_month_add(ym, k)
    for args in ((_start(panel), 12, 12, None), (_start(panel), 6, 24, 2),
                 (int(panel.dates[30]), 1, 3, 5),
                 (int(panel.dates[100]), 12, 12, None)):
        assert W.walkforward_folds(panel, *args) == jax_folds(jpanel, *args)
    for bad in ((_start(panel), 0, 12), (_start(panel), 12, 0),
                (299001, 12, 12)):
        with pytest.raises(ValueError):
            W.walkforward_folds(panel, *bad)


def _bridge_inits(monkeypatch, inits):
    """Record the JAX trainers' fresh inits by seed, and start the port's
    trainers from them instead of their own seeded draws."""
    for jcls in (JaxTrainer, JaxEnsemble):
        orig = jcls.init_state

        def record(self, *a, _orig=orig, **k):
            st = _orig(self, *a, **k)
            leaves = jax.tree_util.tree_leaves(st.params)
            # The ensemble's init vmaps the single trainer's: keep the
            # stacked tree, not the traced member.
            if not any(isinstance(x, jax.core.Tracer) for x in leaves):
                inits[self.cfg.seed] = jax.tree_util.tree_map(np.asarray,
                                                              st.params)
            return st

        monkeypatch.setattr(jcls, "init_state", record)
    for cls in (Trainer, EnsembleTrainer):
        orig = cls.init_state

        def bridged(self, params=None, _orig=orig):
            return _orig(self, inits[self.cfg.seed] if params is None
                         else params)

        monkeypatch.setattr(cls, "init_state", bridged)


@pytest.mark.parametrize("cell,n_seeds", [("lstm", 1), ("gru", 2)])
def test_walkforward_matches_jax(monkeypatch, tmp_path, panel, cell,
                                 n_seeds):
    monkeypatch.setenv("LFM_ASYNC", "0")
    inits = {}
    _bridge_inits(monkeypatch, inits)
    jpanel = jax_synthetic(**PANEL)
    want_fc, want_valid, want = jax_walkforward(
        _tiny(jax_config, cell, n_seeds), jpanel, start=_start(panel),
        out_dir=str(tmp_path / "jax"), score_modes=["mean"],
        score_kwargs=dict(min_universe=5), **SWEEP)
    assert sorted(inits) == [7, 1007, 2007]
    fc, valid, got = W.run_walkforward(
        _port_cfg(cell=cell, n_seeds=n_seeds), panel, start=_start(panel),
        out_dir=str(tmp_path / "wf"), score_modes=["mean"],
        score_kwargs=dict(min_universe=5), device="cpu", **SWEEP)
    assert fc.shape == want_fc.shape
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(fc, want_fc, rtol=1e-4, atol=1e-6)
    assert len(got["folds"]) == len(want["folds"]) == 3
    assert any(r["epochs_run"] < 4 for r in got["folds"])  # early stops
    for g, w in zip(got["folds"], want["folds"]):
        assert set(g) == set(w) - {"reuse"}
        for key in ("fold", "train_end", "val_end", "pred_months",
                    "n_pred_cells", "best_epoch", "epochs_run",
                    "warm_started"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["best_val_ic"], w["best_val_ic"],
                                   rtol=1e-4)
    for key in ("n_folds", "step_months", "val_months", "train_months",
                "n_seeds", "warm_start", "oos_months"):
        assert got[key] == want[key], key
    for key, v in want["backtest"]["mean"].items():
        if key != "summary":
            np.testing.assert_allclose(got["backtest"]["mean"][key], v,
                                       rtol=1e-3, atol=2e-4, err_msg=key)
    # The run dir: the stitched file, the snapshot and loadable folds.
    wf = tmp_path / "wf"
    data = np.load(wf / "walkforward.npz")
    np.testing.assert_array_equal(data["forecast"], fc)
    np.testing.assert_array_equal(data["valid"], valid)
    assert json.loads((wf / "partial.json").read_text()) == json.loads(
        json.dumps(got["folds"]))
    assert json.loads((wf / "summary.json").read_text())["backtest"]
    model, splits, is_ensemble = load_forecaster(str(wf / "fold_2"),
                                                 panel=panel, device="cpu")
    assert is_ensemble == (n_seeds > 1) and model.cfg.seed == 2007
    lo, hi = W.walkforward_folds(panel, _start(panel), 12, 12)[2][2]
    fold_fc, fold_valid = model.predict(date_range=(lo, hi))
    np.testing.assert_array_equal(fold_fc[..., fold_valid],
                                  fc[..., fold_valid])


def test_resume_skips_completed_folds(monkeypatch, tmp_path, panel):
    """A sweep cut after 2 of 3 folds and resumed trains only the third
    and stitches what an unbroken sweep stitches; another schedule or
    seed count is rejected (one epoch a fold: the protocol's mechanics)."""
    cfg = _port_cfg(epochs=1)
    whole = W.run_walkforward(cfg, panel, start=_start(panel),
                              out_dir=str(tmp_path / "whole"),
                              device="cpu", **SWEEP)
    cut = str(tmp_path / "cut")
    W.run_walkforward(cfg, panel, start=_start(panel), out_dir=cut,
                      device="cpu", **dict(SWEEP, n_folds=2))
    fits = []
    orig = Trainer.fit
    monkeypatch.setattr(Trainer, "fit", lambda self, **k: (
        fits.append(self.cfg.seed), orig(self, **k))[1])
    fc, valid, summary = W.run_walkforward(
        cfg, panel, start=_start(panel), out_dir=cut, resume=True,
        device="cpu", **SWEEP)
    assert fits == [2007]
    np.testing.assert_array_equal(valid, whole[1])
    np.testing.assert_array_equal(fc, whole[0])
    assert [r["fold"] for r in summary["folds"]] == [0, 1, 2]
    with pytest.raises(ValueError, match="schedule mismatch"):
        W.run_walkforward(cfg, panel, start=int(panel.dates[50]),
                          out_dir=cut, resume=True, device="cpu", **SWEEP)
    with pytest.raises(ValueError, match="schedule mismatch"):
        W.run_walkforward(cfg, panel, start=_start(panel), out_dir=cut,
                          resume=True, device="cpu",
                          **dict(SWEEP, n_folds=2))
    with pytest.raises(ValueError, match="n_seeds changed"):
        W.run_walkforward(dataclasses.replace(cfg, n_seeds=2), panel,
                          start=_start(panel), out_dir=cut, resume=True,
                          device="cpu", **SWEEP)
    with pytest.raises(ValueError, match="needs out_dir"):
        W.run_walkforward(cfg, panel, start=_start(panel), resume=True,
                          device="cpu", **SWEEP)


def test_warm_start_carries_params(tmp_path, panel):
    """Fold 1 starts from fold 0's best params: its forecasts differ from
    a cold sweep's while fold 0's are identical; a resume that skipped
    fold 0 carries the same params from fold 0's ``ckpt/best`` (one
    epoch a fold: the carry's mechanics)."""
    cfg = _port_cfg(epochs=1)
    sweep = dict(SWEEP, n_folds=2)
    cold = W.run_walkforward(cfg, panel, start=_start(panel),
                             out_dir=str(tmp_path / "cold"), device="cpu",
                             **sweep)
    warm = W.run_walkforward(cfg, panel, start=_start(panel),
                             out_dir=str(tmp_path / "warm"), device="cpu",
                             warm_start=True, **sweep)
    assert [r["warm_started"] for r in warm[2]["folds"]] == [False, True]
    assert warm[2]["warm_start"] is True
    np.testing.assert_array_equal(warm[1], cold[1])
    lo = W.walkforward_folds(panel, _start(panel), 12, 12)[1][2][0]
    fold1 = warm[1].copy()
    fold1[:, :lo] = False
    assert fold1.any()
    assert not np.array_equal(warm[0][fold1], cold[0][fold1])
    fold0 = warm[1] & ~fold1
    np.testing.assert_array_equal(warm[0][fold0], cold[0][fold0])
    # Across a resume: fold 0 from one process, fold 1 from the next.
    cut = str(tmp_path / "cut")
    W.run_walkforward(cfg, panel, start=_start(panel), out_dir=cut,
                      device="cpu", warm_start=True,
                      **dict(sweep, n_folds=1))
    fc, _, summary = W.run_walkforward(
        cfg, panel, start=_start(panel), out_dir=cut, resume=True,
        warm_start=True, device="cpu", **sweep)
    assert [r["warm_started"] for r in summary["folds"]] == [False, True]
    np.testing.assert_array_equal(fc, warm[0])
    # Another model's params cannot be grafted.
    wide = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, kwargs={"hidden": 8}))
    trainer = Trainer(wide, PanelSplits.by_date(
        panel, int(panel.dates[60]), int(panel.dates[80])), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        trainer.fit(init_params=load_forecaster(
            os.path.join(cut, "fold_1"), panel=panel,
            device="cpu")[0].state.params)


def test_ensemble_flag_follows_the_trainer_kind(tmp_path, panel):
    """A fold dir reused by the other trainer kind has its marker written
    or cleared, so ``load_forecaster`` restores the right model; the
    single-model experiment clears a stale marker too."""
    out = str(tmp_path / "wf")
    sweep = dict(SWEEP, n_folds=1)
    flag = os.path.join(out, "fold_0", "ensemble.flag")
    W.run_walkforward(_port_cfg(n_seeds=2, epochs=1), panel,
                      start=_start(panel), out_dir=out, device="cpu",
                      **sweep)
    assert os.path.exists(flag)
    assert isinstance(load_forecaster(os.path.join(out, "fold_0"),
                                      panel=panel, device="cpu")[0],
                      EnsembleTrainer)
    W.run_walkforward(_port_cfg(epochs=1), panel, start=_start(panel),
                      out_dir=out, device="cpu", **sweep)
    assert not os.path.exists(flag)
    assert isinstance(load_forecaster(os.path.join(out, "fold_0"),
                                      panel=panel, device="cpu")[0],
                      Trainer)
    cfg = dataclasses.replace(_port_cfg(epochs=1), out_dir=str(tmp_path))
    run_dir = tmp_path / cfg.name / f"seed{cfg.seed}"
    run_dir.mkdir(parents=True)
    (run_dir / "ensemble.flag").write_text("stale\n")
    run_experiment(cfg, panel=panel, device="cpu")
    assert not (run_dir / "ensemble.flag").exists()


def test_unported_options_raise(panel, tmp_path):
    # The fold stack writes no per-epoch lines and the warm start is a
    # serial carry: both protocols are refused with it (JAX's ValueError).
    for bad in (dict(resume=True, out_dir=str(tmp_path)),
                dict(warm_start=True)):
        with pytest.raises(ValueError, match="incompatible with resume"):
            W.run_walkforward(_port_cfg(), panel, start=_start(panel),
                              foldstack=True, device="cpu", **SWEEP, **bad)
    # A heteroscedastic sweep resumes only from a snapshot that carries
    # its variances (the JAX package's check).
    het = dataclasses.replace(_port_cfg(), optim=dataclasses.replace(
        _port_cfg().optim, loss="nll"))
    shape = (panel.n_firms, panel.n_months)
    np.savez_compressed(tmp_path / "partial.npz",
                        forecast=np.zeros(shape, np.float32),
                        valid=np.zeros(shape, bool))
    (tmp_path / "partial.json").write_text("[]")
    with pytest.raises(ValueError, match="lacks variances"):
        W.run_walkforward(het, panel, start=_start(panel), device="cpu",
                          out_dir=str(tmp_path), resume=True, **SWEEP)
    fc = np.zeros((panel.n_firms, panel.n_months), np.float32)
    with pytest.raises(ValueError, match="stacked forecasts"):
        W.score_stitched(fc, panel.valid, panel, ["mean_minus_std"],
                         device="cpu")


def _cli_config(tmp_path):
    c2 = config.get_preset("c2")
    cfg = dataclasses.replace(
        c2, name="tiny_cli",
        data=dataclasses.replace(c2.data, window=12, firms_per_date=32),
        model=dataclasses.replace(c2.model, kwargs={"hidden": 8}),
        optim=dataclasses.replace(c2.optim, warmup_steps=3))
    path = tmp_path / "tiny.json"
    path.write_text(cfg.to_json())
    return str(path)


def test_train_cli_walk_forward(tmp_path, capsys):
    """``--walk-forward 12 --wf-folds 2 --wf-score mean --device cpu``:
    the run dir, the stitched file graded by the backtest's
    ``--forecast-npz`` as by the numpy engine, the forecast entry point
    on the walk-forward dir (its last fold), and the argument checks."""
    base = ["--config", _cli_config(tmp_path), "--device", "cpu",
            "--scale", "0.02", "--epochs", "2", "--out", str(tmp_path)]
    assert train_main(base + ["--walk-forward", "12", "--wf-folds", "2",
                              "--wf-val-months", "18", "--wf-score",
                              "mean"]) == 0
    summary = json.loads(capsys.readouterr().out)
    wf = tmp_path / "tiny_cli" / "wf"
    assert summary["run_dir"] == str(wf) and summary["n_folds"] == 2
    assert [r["fold"] for r in summary["folds"]] == [0, 1]
    for name in ("walkforward.npz", "summary.json", "config.json",
                 "partial.json", "fold_1/config.json", "fold_1/ckpt/best"):
        assert (wf / name).exists(), name
    out = tmp_path / "report.json"
    assert backtest_main(["--forecast-npz", str(wf), "--device", "cpu",
                          "--json-out", str(out)]) == 0
    got = json.loads(out.read_text())
    data = np.load(wf / "walkforward.npz")
    model, splits, _ = load_forecaster(str(wf / "fold_1"), device="cpu")
    ref = engine.run_backtest(data["forecast"], data["valid"], splits.panel)
    assert got["n_months"] == ref.n_months == summary["backtest"]["mean"][
        "n_months"]
    np.testing.assert_allclose(got["cagr"], ref.cagr, rtol=1e-4, atol=1e-6)
    capsys.readouterr()
    assert forecast_main(["--run-dir", str(wf), "--device", "cpu"]) == 0
    assert "using fold 1's model" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train_main(base + ["--wf-start", "197501"])
    with pytest.raises(SystemExit):
        train_main(base + ["--walk-forward", "12", "--wf-score",
                           "mean_minus_std"])
    with pytest.raises(SystemExit):
        train_main(base + ["--walk-forward", "12", "--wf-score", "median"])
    # Total std needs stitched variances: a point-head config is refused.
    with pytest.raises(SystemExit):
        train_main(base + ["--walk-forward", "12", "--wf-score",
                           "mean,mean_minus_total_std@1"])
    # The fold stack needs the rolling window; a sweep axis must be a
    # per-run operand.
    with pytest.raises(SystemExit):
        train_main(base + ["--walk-forward", "12", "--wf-foldstack"])
    with pytest.raises(SystemExit):
        train_main(base + ["--sweep-grid", "momentum=0.9"])


def test_train_cli_walk_forward_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--preset", "c2", "--walk-forward", "12"])
