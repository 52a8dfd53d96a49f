"""The port's fold-stacked walk-forward (``train/foldstack.py``) against
the JAX package's and against the port's sequential sweep.

* ``run_stacked_walkforward`` on an MLP against JAX
  ``run_walkforward(foldstack=True)`` on the unsharded fold stack, both
  from the JAX per-fold init (``Trainer.init_stacked_states``): per-fold
  histories at rtol 2e-5, epochs run and best epoch exact, each fold's
  forecasts at rtol 2e-5 (the JAX bitwise pins fail on the reference,
  ROADMAP Queue C).
* ``run_walkforward(foldstack=True)`` on an LSTM (the plain versions of
  the seed-grid recurrence and the folded gather) against the port's own
  sequential sweep, one seed and a c5-shaped ensemble of 2 seeds × 2
  folds:
  decisions exact, stitched forecasts and histories at rtol 2e-5 (the
  CPU's batched products round differently from one model's); the fold
  records and the summary's ``foldstack`` record; fold dirs load.
* The fold × config product (``run_walkforward_sweep``) stacked against
  sequential; foldstack's argument errors (the function's and the
  CLI's); an expanding window degrading loudly to the sequential sweep.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.data import synthetic_panel as jax_synthetic
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu.train.walkforward import run_walkforward as jax_wf
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.data.panel import synthetic_panel
from lfm_quant_tpu_torch.train import stacked as ST
from lfm_quant_tpu_torch.train import walkforward as W
from lfm_quant_tpu_torch.train.__main__ import main as train_main
from lfm_quant_tpu_torch.train.foldstack import run_stacked_walkforward
from lfm_quant_tpu_torch.train.forecast import load_forecaster
from lfm_quant_tpu_torch.utils import telemetry

PANEL = dict(n_firms=100, n_months=200, n_features=5, seed=5)
#: Three same-shape folds: a rolling 72-month window.
WF = dict(start=198001, step_months=12, val_months=24, n_folds=3,
          train_months=72)
RTOL = 2e-5
FIELDS = ("train_loss", "grad_norm", "val_ic", "val_mse", "val_ic_std")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its shapes are tiny, and the
    tier-1 run's workers share the machine's cores (more threads burn
    about three times the CPU for the same wall)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cfg_mod, tmp, kind="lstm", epochs=2, n_seeds=1, **optim):
    kwargs = {"hidden": (16,)} if kind == "mlp" else {"hidden": 8}
    return cfg_mod.RunConfig(
        name="fstk",
        data=cfg_mod.DataConfig(n_firms=100, n_months=200, n_features=5,
                                window=12, dates_per_batch=4,
                                firms_per_date=32),
        model=cfg_mod.ModelConfig(kind=kind, kwargs=kwargs),
        optim=cfg_mod.OptimConfig(**{"lr": 1e-3, "epochs": epochs,
                                     "warmup_steps": 5, "loss": "mse",
                                     **optim}),
        seed=0, n_seeds=n_seeds, out_dir=str(tmp))


@pytest.fixture(scope="module")
def panel():
    return synthetic_panel(**PANEL)


def _histories(out_dir, n):
    return [[json.loads(line) for line in open(os.path.join(
        out_dir, f"fold_{k}", "metrics.jsonl"))] for k in range(n)]


def _same_histories(got_dir, want_dir, n, rtol=RTOL):
    for k, (a, b) in enumerate(zip(_histories(got_dir, n),
                                   _histories(want_dir, n))):
        assert [r["epoch"] for r in a] == [r["epoch"] for r in b], k
        assert [r["step"] for r in a] == [r["step"] for r in b], k
        for ra, rb in zip(a, b):
            for f in FIELDS:
                if f in rb:
                    np.testing.assert_allclose(ra[f], rb[f], rtol=rtol,
                                               err_msg=f"fold {k} {f}")


def _same_decisions(got, want, rtol=RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["epochs_run"] == w["epochs_run"]
        assert g["best_epoch"] == w["best_epoch"]
        np.testing.assert_allclose(g["best_val_ic"], w["best_val_ic"],
                                   rtol=rtol)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX fold stack (unsharded) and its per-fold init."""
    tmp = tmp_path_factory.mktemp("jax_fold")
    old = os.environ.get("LFM_FOLDSTACK_SHARDS")
    os.environ["LFM_FOLDSTACK_SHARDS"] = "0"
    try:
        jp = jax_synthetic(**PANEL)
        cfg = _cfg(jax_config, tmp, kind="mlp")
        folds = W.walkforward_folds(jp, WF["start"], WF["step_months"],
                                    WF["val_months"], WF["n_folds"])
        splits = JaxSplits.by_date(jp, folds[0][0], folds[0][1],
                                   train_start=W.month_add(folds[0][0], -72))
        init = jax.tree_util.tree_map(np.asarray, JaxTrainer(
            cfg, splits).init_stacked_states(
                [cfg.seed + 1000 * k for k in range(len(folds))]).params)
        out = str(tmp / "out")
        fc, valid, summary = jax_wf(cfg, jp, out_dir=out, foldstack=True,
                                    **WF)
    finally:
        if old is None:
            os.environ.pop("LFM_FOLDSTACK_SHARDS")
        else:
            os.environ["LFM_FOLDSTACK_SHARDS"] = old
    assert summary["foldstack"]["enabled"] is True
    return fc, valid, summary, out, init, folds


def test_fold_stack_matches_the_jax_fold_stack(jax_ref, panel, tmp_path):
    """Per-fold decisions exact, histories and forecasts at rtol 2e-5."""
    want_fc, want_valid, want, want_dir, init, folds = jax_ref
    out = str(tmp_path / "stk")
    sums, preds, info = run_stacked_walkforward(
        _cfg(config, tmp_path, kind="mlp"), panel, folds, train_months=72,
        out_dir=out,
        device="cpu", init_params=init)
    assert info["enabled"] is True and info["fold_count"] == 3
    _same_decisions(sums, want["folds"])
    _same_histories(out, want_dir, 3)
    valid = np.zeros_like(want_valid)
    for fc, v in preds:
        assert not (valid & v).any()
        valid |= v
        np.testing.assert_allclose(fc[v], want_fc[v], rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(valid, want_valid)


@pytest.mark.parametrize("n_seeds,n_folds", [(1, 3), (2, 2)])
def test_fold_stack_matches_the_sequential_sweep(panel, tmp_path, n_seeds,
                                                 n_folds):
    """``run_walkforward(foldstack=True)`` against the sequential sweep
    (one seed; the c5-shaped 2 seeds × 2 folds): decisions exact, the
    stitched forecasts and the histories at rtol 2e-5; each fold dir
    loads (``load_forecaster``) to a model that predicts its window as
    the stack did (its member forward, within the same tolerance)."""
    cfg = _cfg(config, tmp_path, n_seeds=n_seeds)
    kw = dict(WF, n_folds=n_folds, device="cpu")
    fc_s, v_s, seq = W.run_walkforward(cfg, panel, out_dir=str(
        tmp_path / "seq"), **kw)
    out = str(tmp_path / "stk")
    fc_k, v_k, stk = W.run_walkforward(cfg, panel, out_dir=out,
                                       foldstack=True, **kw)
    assert "foldstack" not in seq
    assert stk["foldstack"]["enabled"] is True
    assert stk["foldstack"]["fold_count"] == n_folds
    assert all(r["foldstack"] for r in stk["folds"])
    _same_decisions(stk["folds"], seq["folds"])
    _same_histories(out, str(tmp_path / "seq"), n_folds)
    np.testing.assert_array_equal(v_k, v_s)
    np.testing.assert_allclose(fc_k, fc_s, rtol=RTOL, atol=1e-6)
    assert fc_k.shape[0] == n_seeds or n_seeds == 1
    model, _, is_ens = load_forecaster(os.path.join(out, f"fold_{n_folds - 1}"),
                                       panel=panel, device="cpu")
    assert is_ens == (n_seeds > 1)
    lo, hi = W.walkforward_folds(panel, WF["start"], 12, 24)[n_folds - 1][2]
    fold_fc, fold_v = model.predict(date_range=(lo, hi))
    np.testing.assert_allclose(fold_fc[..., fold_v], fc_k[..., fold_v],
                               rtol=RTOL, atol=1e-6)


def test_fold_by_config_product(panel, tmp_path):
    """``run_walkforward_sweep``: 2 folds × 2 configs as one stack against
    the same runs one after another; the product's ranking is exact."""
    cfg = _cfg(config, tmp_path, kind="mlp", epochs=1)
    grid = ST.parse_sweep_grid("lr=1e-3,3e-4")
    kw = dict(WF, n_folds=2, device="cpu")
    seq = ST.run_walkforward_sweep(cfg, grid, panel, stacked=False,
                                   out_dir=str(tmp_path / "seq"), **kw)
    stk = ST.run_walkforward_sweep(cfg, grid, panel, stacked=True,
                                   out_dir=str(tmp_path / "stk"), **kw)
    assert stk["stacked"]["kind"] == "grid" and seq["stacked"] is None
    assert stk["best_index"] == seq["best_index"]
    for a, b in zip(stk["folds"], seq["folds"]):
        assert a["best_index"] == b["best_index"]
        _same_decisions(a["runs"], b["runs"])
    np.testing.assert_allclose(
        [c["mean_best_val_ic"] for c in stk["by_config"]],
        [c["mean_best_val_ic"] for c in seq["by_config"]], rtol=RTOL)
    assert json.loads((tmp_path / "stk" / "sweep_summary.json").read_text(
    ))["best_config"] == stk["best_config"]
    assert (tmp_path / "stk" / "fold_1" / "config_001" / "ckpt"
            / "best").exists()


def test_foldstack_argument_errors_and_loud_degrade(panel, tmp_path,
                                                   monkeypatch):
    """``resume``/``warm_start`` with foldstack raise JAX's ValueError;
    the CLI's checks exit at parse time; an expanding window (no
    ``train_months``) degrades to the sequential sweep with a warning,
    the counter and the instant."""
    cfg = _cfg(config, tmp_path, epochs=1)
    for bad in (dict(resume=True, out_dir=str(tmp_path)),
                dict(warm_start=True)):
        with pytest.raises(ValueError, match="incompatible with resume"):
            W.run_walkforward(cfg, panel, foldstack=True, device="cpu",
                              **dict(WF, **bad))
    cli = tmp_path / "cfg.json"
    cli.write_text(cfg.to_json())
    base = ["--config", str(cli), "--device", "cpu"]
    for bad in (["--wf-foldstack"],
                ["--walk-forward", "12", "--wf-foldstack"],
                ["--walk-forward", "12", "--wf-train-months", "72",
                 "--wf-foldstack", "--wf-warm-start"],
                ["--walk-forward", "12", "--wf-train-months", "72",
                 "--wf-foldstack", "--resume"]):
        with pytest.raises(SystemExit):
            train_main(base + bad)
    instants = []
    monkeypatch.setattr(telemetry, "instant",
                        lambda name, **kw: instants.append((name, kw)))
    before = telemetry.COUNTERS.snapshot().get("stack_degrades", 0)
    kw = dict(WF, n_folds=2, train_months=None)
    with pytest.warns(UserWarning, match="rolling train_months"):
        _, _, summary = W.run_walkforward(cfg, panel, foldstack=True,
                                          device="cpu", **kw)
    assert "foldstack" not in summary and len(summary["folds"]) == 2
    assert telemetry.COUNTERS.snapshot()["stack_degrades"] == before + 1
    assert dict(instants)["stack_degraded"]["kind"] == "fold"
    monkeypatch.setenv("LFM_FOLDSTACK_SHARDS", "4")
    with pytest.raises(NotImplementedError, match="item 10"):
        W.run_walkforward(cfg, panel, foldstack=True, device="cpu", **WF)
