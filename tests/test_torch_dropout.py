"""Dropout in the port's trainers and MC-dropout prediction, the
properties ``tests/test_dropout.py`` pins for the JAX package, on the CPU:

* dropout changes the training loss; the same (state, batch) gives the
  same loss and the next step a different one; a fit cut after an epoch
  and resumed from ``ckpt/latest`` gives the unbroken fit's losses;
* the validation sweep is deterministic (equal to the no-dropout twin's);
* date shards draw different masks; ensemble members draw independent
  masks (member s the single model of seed ``seed + s``), and
  ``seed_block`` changes no draw;
* attention dropout draws one ``[1, 1, W, W]`` mask per step, shared
  over the batch and the heads;
* ``predict(mc_samples=K)``: ``[K, N, T]`` samples that differ, replayed
  bitwise by ``mc_seed`` and changed by another, the plain predict's
  validity, the per-sample loop equal to the batched path, a
  ``ValueError`` without dropout, and aggregation like an ensemble's;
  ``--mc-samples`` in the backtest and forecast entry points.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lfm_quant_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    OptimConfig,
    RunConfig,
)
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.models import transformer as T
from lfm_quant_tpu_torch.parallel.mesh import DataMesh
from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
from lfm_quant_tpu_torch.train.forecast import run_forecast
from lfm_quant_tpu_torch.train.loop import FitHarness, Trainer


def _cfg(tmp, dropout, kind="mlp", n_seeds=1, **over):
    kw = ({"hidden": (16,)} if kind == "mlp"
          else {"dim": 16, "depth": 1, "heads": 2})
    return RunConfig(
        name=f"drop{dropout}",
        data=DataConfig(n_firms=120, n_months=150, n_features=5, window=12,
                        dates_per_batch=8, firms_per_date=32),
        model=ModelConfig(kind=kind, kwargs=dict(kw, dropout=dropout)),
        optim=OptimConfig(lr=1e-3, epochs=2, warmup_steps=5, loss="mse"),
        seed=0, n_seeds=n_seeds, out_dir=str(tmp), **over)


@pytest.fixture(scope="module")
def splits():
    panel = synthetic_panel(n_firms=120, n_months=150, n_features=5,
                            seed=31)
    return PanelSplits.by_date(panel, 197910, 198101)


@pytest.fixture(scope="module")
def mc_trainer(splits, tmp_path_factory):
    """A dropout-0.5 MLP with its seeded init, shared by the MC tests."""
    t = Trainer(_cfg(tmp_path_factory.mktemp("mc"), 0.5), splits,
                device="cpu")
    t.state = t.init_state()
    return t


def _first_batch(t):
    b = t.train_sampler.stacked_epoch(0)
    return tuple(torch.as_tensor(a[0]) for a in (b.firm_idx, b.time_idx,
                                                 b.weight))


def _loss(t, state, batch):
    with torch.no_grad():
        num, den = t._loss_parts(*batch, t.step_generator(state))
    return float(num / den)


def test_dropout_changes_training_loss(splits, tmp_path):
    t0 = Trainer(_cfg(tmp_path, 0.0), splits, device="cpu")
    t5 = Trainer(_cfg(tmp_path, 0.5), splits, device="cpu")
    assert not t0._needs_rng and t5._needs_rng
    s0, s5 = t0.init_state(), t5.init_state()
    for k in s0.params:   # the same seeded init: dropout has no params
        assert torch.equal(s0.params[k], s5.params[k])
    batch = _first_batch(t0)
    assert t0.step_generator(s0) is None
    assert _loss(t0, s0, batch) != pytest.approx(_loss(t5, s5, batch),
                                                 rel=1e-6)


def test_dropout_deterministic_per_step_and_across_a_resume(splits,
                                                            tmp_path):
    t = Trainer(_cfg(tmp_path, 0.5), splits, device="cpu")
    s = t.init_state()
    assert s.rng == t.cfg.seed
    batch = _first_batch(t)
    assert _loss(t, s, batch) == _loss(t, s, batch)
    assert _loss(t, s._replace(step=s.step + 1), batch) != \
        _loss(t, s, batch)
    # A fit cut after epoch 0 and resumed replays the dropout stream.
    whole = Trainer(_cfg(tmp_path, 0.5), splits,
                    run_dir=str(tmp_path / "whole"), device="cpu").fit()
    end_epoch = FitHarness.end_epoch

    class Crash(Exception):
        pass

    def dies(self, epoch, *args):
        stop = end_epoch(self, epoch, *args)
        if epoch == 0:
            raise Crash
        return stop

    cut = Trainer(_cfg(tmp_path, 0.5), splits,
                  run_dir=str(tmp_path / "cut"), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FitHarness, "end_epoch", dies)
        with pytest.raises(Crash):
            cut.fit()
    resumed = cut.fit(resume=True)
    k = len(resumed["step_losses"])
    assert k and resumed["step_losses"] == whole["step_losses"][-k:]


def test_date_shards_draw_different_masks(splits, tmp_path):
    t = Trainer(_cfg(tmp_path, 0.5), splits, device="cpu")
    s = t.init_state()
    batch = _first_batch(t)
    t.mesh = DataMesh(2, 0)
    r0 = _loss(t, s, batch)
    t.mesh = DataMesh(2, 1)
    r1 = _loss(t, s, batch)
    t.mesh = DataMesh()
    assert len({r0, r1, _loss(t, s, batch)}) == 3


def test_eval_is_deterministic(splits, tmp_path):
    """The sweep runs without dropout: the dropout model's IC and MSE
    equal its no-dropout twin's on the same params."""
    t0 = Trainer(_cfg(tmp_path, 0.0), splits, device="cpu")
    t5 = Trainer(_cfg(tmp_path, 0.5), splits, device="cpu")
    t0.init_state(), t5.init_state()
    v0, v5 = t0.evaluate(), t5.evaluate()
    assert v0["ic"] == v5["ic"] and v0["mse"] == v5["mse"]
    assert t5.evaluate() == v5


def test_ensemble_members_draw_independent_masks(splits, tmp_path):
    """Member s's first step is the single model of seed ``seed + s``
    (init, data order and dropout stream); the members' losses differ;
    ``seed_block`` 1 gives the same losses."""
    S = 3
    e = EnsembleTrainer(_cfg(tmp_path, 0.3, n_seeds=S), splits,
                        device="cpu")
    state = e.init_state()
    assert state.rng.tolist() == [0, 1, 2]
    (fi, ti, w), _ = e._build_epoch(0)
    _, ms = e.step(state, fi[0], ti[0], w[0])
    losses = ms["loss"].tolist()
    assert len(set(losses)) == S
    for s in range(S):
        t = Trainer(dataclasses.replace(_cfg(tmp_path, 0.3), seed=s), splits,
                    device="cpu")
        one = t.init_state()
        batch = _first_batch(t)
        np.testing.assert_allclose(_loss(t, one, batch), losses[s],
                                   rtol=1e-6)
    blocked = EnsembleTrainer(_cfg(tmp_path, 0.3, n_seeds=S, seed_block=1),
                              splits, device="cpu")
    _, mb = blocked.step(blocked.init_state(), fi[0], ti[0], w[0])
    np.testing.assert_allclose(mb["loss"].tolist(), losses, rtol=1e-6)


def test_transformer_attention_dropout_trains(splits, tmp_path,
                                              monkeypatch):
    t = Trainer(_cfg(tmp_path, 0.2, kind="transformer"), splits,
                device="cpu")
    assert t._needs_rng
    shapes = []
    keep_mask = T.keep_mask

    def spy(rng, rate, shape, device):
        shapes.append(tuple(shape))
        return keep_mask(rng, rate, shape, device)

    monkeypatch.setattr(T, "keep_mask", spy)
    state = t.init_state()
    fi, ti, w = _first_batch(t)
    _, ms = t.step(state, fi[None], ti[None], w[None])
    assert np.isfinite(float(ms["loss"]))
    assert shapes == [(1, 1, 12, 12)]
    shapes.clear()
    t.evaluate()
    assert shapes == []


def test_mc_predict_shapes_diversity_and_replay(mc_trainer, splits):
    stacked, valid = mc_trainer.predict("test", mc_samples=4, mc_seed=7)
    n, tm = splits.panel.n_firms, splits.panel.n_months
    assert stacked.shape == (4, n, tm) and valid.shape == (n, tm)
    assert valid.any() and not stacked[:, ~valid].any()
    assert float(stacked.std(axis=0)[valid].max()) > 0.0
    again, _ = mc_trainer.predict("test", mc_samples=4, mc_seed=7)
    np.testing.assert_array_equal(stacked, again)
    other, _ = mc_trainer.predict("test", mc_samples=4, mc_seed=8)
    assert not np.array_equal(stacked, other)


def test_mc_predict_validity_matches_plain(mc_trainer):
    _, v_mc = mc_trainer.predict("test", mc_samples=2)
    plain, v = mc_trainer.predict("test")
    np.testing.assert_array_equal(v_mc, v)
    again, _ = mc_trainer.predict("test")
    np.testing.assert_array_equal(plain, again)


def test_mc_predict_batched_matches_the_loop(mc_trainer):
    loop, v_loop = mc_trainer.predict("val", mc_samples=3, mc_seed=5,
                                      mc_batched=False)
    batched, v_b = mc_trainer.predict("val", mc_samples=3, mc_seed=5)
    np.testing.assert_array_equal(v_loop, v_b)
    np.testing.assert_array_equal(loop, batched)


def test_mc_predict_requires_dropout(splits, tmp_path):
    t = Trainer(_cfg(tmp_path, 0.0), splits, device="cpu")
    t.state = t.init_state()
    with pytest.raises(ValueError, match="dropout"):
        t.predict("test", mc_samples=4)


def test_mc_predict_aggregates_like_an_ensemble(mc_trainer):
    from lfm_quant_tpu_torch.backtest import resolve_backtest

    fc, v = run_forecast(mc_trainer, False, mode="mean_minus_std",
                         risk_lambda=1.0, mc_samples=3, split="test")
    stacked, valid = mc_trainer.predict("test", mc_samples=3)
    np.testing.assert_array_equal(v, valid)
    want = stacked.mean(0) - stacked.std(0)
    np.testing.assert_allclose(fc[valid], want[valid], atol=1e-5)
    report = resolve_backtest(torch.device("cpu"))(
        fc, v, mc_trainer.panel, quantile=0.3)
    assert report.n_months > 0
    with pytest.raises(SystemExit, match="stacked"):
        run_forecast(mc_trainer, False, mode="mean_minus_std",
                     split="test")


def test_entry_points_take_mc_samples(splits, tmp_path, capsys):
    """``--mc-samples`` in the backtest and forecast entry points on a
    dropout model's run dir; the backtest's ``--mode mean_minus_std``
    needs it on a single model."""
    from lfm_quant_tpu_torch.backtest.__main__ import main as backtest_main
    from lfm_quant_tpu_torch.forecast import main as forecast_main
    from lfm_quant_tpu_torch.train.loop import run_experiment

    cfg = dataclasses.replace(_cfg(tmp_path, 0.5), optim=dataclasses.replace(
        _cfg(tmp_path, 0.5).optim, epochs=1))
    summary, _, _ = run_experiment(cfg, panel=splits.panel, device="cpu")
    run_dir = summary["run_dir"]
    assert backtest_main(["--run-dir", run_dir, "--mc-samples", "3",
                          "--mode", "mean_minus_std", "--device",
                          "cpu"]) == 0
    assert "CAGR" in capsys.readouterr().out
    out = tmp_path / "live.npz"
    assert forecast_main(["--run-dir", run_dir, "--mc-samples", "3",
                          "--mode", "mean_minus_std", "--device", "cpu",
                          "--out", str(out)]) == 0
    assert np.load(out)["valid"].any()
    with pytest.raises(SystemExit):
        backtest_main(["--run-dir", run_dir, "--mode", "mean_minus_std",
                       "--device", "cpu"])
