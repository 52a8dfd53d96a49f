"""The port's training path against the JAX package's.

* ``DateBatchSampler`` epochs and ``gather_targets``: byte-equal to the
  JAX sampler's for the same (seed, epoch).
* The optimizer (``train/optim.py``) against the optax chain the JAX
  trainer builds, step by step on one gradient sequence: atol 1e-6.
* ``Trainer`` on a tiny synthetic panel from the params of the JAX
  ``Trainer``'s ``init_state()`` (bridged by ``weights.load_flax_params``):
  the per-epoch history within rtol 1e-4 in f32 (0.05 in bf16), the same
  best and early-stop epochs, the final params within atol 1e-4.
* The CLI on the CPU: a run dir with ``metrics.jsonl``, ``ckpt/best``
  and ``ckpt/latest``, and ``--resume`` continuing with the same history,
  for one model and for the seed ensemble (``--n-seeds``).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.data.windows import DateBatchSampler as JaxSampler
from lfm_quant_tpu.data.windows import gather_targets as jax_gather_targets
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu_torch import config
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.data.windows import DateBatchSampler, gather_targets
from lfm_quant_tpu_torch.train.__main__ import main as train_main
from lfm_quant_tpu_torch.train.loop import FitHarness, Trainer
from lfm_quant_tpu_torch.train.optim import AdamW
from lfm_quant_tpu_torch.weights import flatten_params

FIELDS = ("firm_idx", "time_idx", "weight")


def _equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("firms_per_date", [16, 0, 40])
def test_sampler_epochs_byte_equal(firms_per_date):
    """Subsampled (16: pools larger and smaller than Bf; 40: most pools
    padded) and full-universe (0) modes, several (seed, epoch) pairs, a
    date range, and the epoch counter."""
    panel = synthetic_panel(n_firms=40, n_months=130, n_features=4, seed=2)
    for seed in (0, 7):
        kw = dict(seed=seed, min_valid_months=None, date_range=(10, 100))
        ours = DateBatchSampler(panel, 12, 3, firms_per_date, **kw)
        ref = JaxSampler(panel, 12, 3, firms_per_date, **kw)
        assert ours.firms_per_date == ref.firms_per_date
        assert ours.batches_per_epoch() == ref.batches_per_epoch()
        assert ours.n_eligible_dates == ref.n_eligible_dates
        for epoch in (0, 1, 5):
            _equal(ours.stacked_epoch(epoch), ref.stacked_epoch(epoch))
            for a, b in zip(ours.epoch(epoch), ref.epoch(epoch),
                            strict=True):
                _equal(a, b)
        # The implicit counter walks the same epochs.
        _equal(ours.stacked_epoch(), ref.stacked_epoch())
        _equal(ours.stacked_epoch(), ref.stacked_epoch())
        _equal(ours.stacked_cross_sections(), ref.stacked_cross_sections())


def test_sampler_engines_and_guards():
    from lfm_quant_tpu_torch import native

    panel = synthetic_panel(n_firms=30, n_months=100, n_features=3, seed=1)
    auto = DateBatchSampler(panel, 12, 2, 8, engine="auto")
    # "auto" takes the native engine when it builds, as the JAX package's.
    other = DateBatchSampler(panel, 12, 2, 8, engine="native"
                             if native.available() else "python")
    _equal(auto.stacked_epoch(3), other.stacked_epoch(3))
    with pytest.raises(ValueError, match="python|native|auto"):
        DateBatchSampler(panel, 12, 2, 8, engine="cython")
    with pytest.raises(ValueError, match="dates_per_batch"):
        DateBatchSampler(panel, 12, 10_000, 8)
    with pytest.raises(ValueError, match="firms_per_date"):
        DateBatchSampler(panel, 12, 2, -1)


def test_gather_targets_equal():
    panel = synthetic_panel(n_firms=30, n_months=100, n_features=3, seed=4)
    b = DateBatchSampler(panel, 12, 4, 8).stacked_epoch(0)
    targets = panel.targets
    for fi, ti in ((b.firm_idx[0], b.time_idx[0]),
                   (b.firm_idx, b.time_idx)):
        got = gather_targets(torch.from_numpy(targets),
                             torch.from_numpy(fi), torch.from_numpy(ti))
        want = np.asarray(jax_gather_targets(targets, fi, ti))
        assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("warmup,total", [(3, 10), (100, 8), (0, 6)])
def test_optimizer_matches_optax(warmup, total):
    """K updates on a fixed gradient sequence, from step 0 (a zero update:
    the schedule starts at lr 0) through warmup and cosine decay, with
    clipped (norm above 1) and unclipped steps; grad norms too."""
    rng = np.random.default_rng(0)
    shapes = {"a/kernel": (3, 4), "a/bias": (4,), "b/kernel": (4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    lr, wd, clip = 1e-2, 1e-4, 1.0
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, min(warmup, total // 2), total, end_value=lr * 0.1)
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adamw(sched, weight_decay=wd))
    jp = {k: jax.numpy.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = AdamW(lr, wd, clip, warmup, total)
    tstate = opt.init(tp)
    clipped = 0
    for step in range(total + 2):
        scale = 3.0 if step % 3 == 1 else 0.05
        grads = {k: (scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        jg = {k: jax.numpy.asarray(v) for k, v in grads.items()}
        upd, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        gnorm = opt.step(tp, {k: torch.from_numpy(v)
                              for k, v in grads.items()}, tstate)
        np.testing.assert_allclose(float(gnorm),
                                   float(optax.global_norm(jg)), rtol=1e-6)
        clipped += float(gnorm) >= clip
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0.0)
        if step == 0 and min(warmup, total // 2) > 0:
            # lr 0 at count 0: the first update is exactly zero.
            for k in shapes:
                assert np.array_equal(tp[k].numpy(), params[k])
    assert clipped >= 2 and tstate.count == total + 2


def _tiny(cfg_mod, dtype_name, epochs, patience):
    """The tiny panel's config in either package's dataclasses."""
    return cfg_mod.RunConfig(
        name="tiny",
        data=cfg_mod.DataConfig(n_firms=48, n_months=120, n_features=5,
                                window=12, dates_per_batch=4,
                                firms_per_date=16),
        model=cfg_mod.ModelConfig(kind="lstm", kwargs={"hidden": 8},
                                  bf16=dtype_name == "bf16",
                                  scan_impl="xla"),
        optim=cfg_mod.OptimConfig(lr=3e-3, warmup_steps=4, epochs=epochs,
                                  early_stop_patience=patience),
        seed=3)


def _splits(splits_cls, panel):
    return splits_cls.by_date(panel, int(panel.dates[84]),
                              int(panel.dates[102]))


@pytest.mark.parametrize("dtype_name,cell,impl,epochs,patience,stops", [
    ("f32", "lstm", "pallas_fused", 6, 1, True),
    ("f32", "gru", "pallas", 4, 1, False),
    ("bf16", "lstm", "pallas_fused", 3, 5, False),
])
def test_trainer_matches_jax(monkeypatch, dtype_name, cell, impl, epochs,
                             patience, stops):
    """The port's Trainer (its kernels' plain versions on the CPU) against
    the JAX Trainer (XLA scan) from the same init and sampler order; the
    first case stops early (patience 1) before its last epoch."""
    monkeypatch.setenv("LFM_ASYNC", "0")
    jcfg = _tiny(jax_config, dtype_name, epochs, patience)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, kind=cell))
    tcfg = _tiny(config, dtype_name, epochs, patience)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, kind=cell, scan_impl=impl))
    jpanel = jax_synthetic(n_firms=48, n_months=120, n_features=5, seed=0)
    panel = synthetic_panel(n_firms=48, n_months=120, n_features=5, seed=0)
    jt = JaxTrainer(jcfg, _splits(JaxSplits, jpanel))
    init = jax.tree_util.tree_map(np.asarray, jt.init_state().params)
    want = jt.fit()
    tt = Trainer(tcfg, _splits(PanelSplits, panel), device="cpu")
    got = tt.fit(init_params=init)
    tol = 1e-4 if dtype_name == "f32" else 0.05
    assert got["epochs_run"] == want["epochs_run"]
    assert (got["epochs_run"] < epochs) == stops
    assert got["best_epoch"] == want["best_epoch"]
    assert len(got["history"]) == len(want["history"])
    for g, w in zip(got["history"], want["history"]):
        assert g["epoch"] == w["epoch"] and g["step"] == w["step"]
        for key in ("train_loss", "grad_norm", "val_ic", "val_mse"):
            np.testing.assert_allclose(g[key], w[key], rtol=tol, atol=0.0,
                                       err_msg=key)
    ev, jev = tt.evaluate(), jt.evaluate(jt.state.params)
    assert ev["n_months"] == jev["n_months"]
    np.testing.assert_allclose([ev["ic"], ev["mse"]], [jev["ic"], jev["mse"]],
                               rtol=tol)
    final = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                  jt.state.params))
    for k, p in tt.state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), final[k],
                                   atol=1e-4 if dtype_name == "f32" else 0.05)


def _tiny_json(tmp_path):
    cfg = dataclasses.replace(
        config.get_preset("c2"), name="tiny_c2",
        data=dataclasses.replace(config.get_preset("c2").data, window=12,
                                 firms_per_date=32),
        model=dataclasses.replace(config.get_preset("c2").model,
                                  kwargs={"hidden": 8}),
        optim=dataclasses.replace(config.get_preset("c2").optim,
                                  warmup_steps=3))
    path = tmp_path / "tiny.json"
    path.write_text(cfg.to_json())
    return str(path)


class _Crash(Exception):
    pass


def test_cli_writes_run_dir_and_resumes(tmp_path, capsys, monkeypatch):
    """``--device cpu --scale``: metrics.jsonl, ckpt/best, ckpt/latest and
    the summary; a run that dies after its second epoch, resumed with
    ``--resume``, ends with the history of an unbroken run."""
    path = _tiny_json(tmp_path)
    base = ["--config", path, "--device", "cpu", "--scale", "0.02",
            "--epochs", "3"]
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    assert train_main(base + ["--out", str(whole)]) == 0
    end_epoch = FitHarness.end_epoch

    def dies_after_epoch_1(self, epoch, *args):
        stop = end_epoch(self, epoch, *args)
        if epoch == 1:
            raise _Crash
        return stop

    monkeypatch.setattr(FitHarness, "end_epoch", dies_after_epoch_1)
    with pytest.raises(_Crash):
        train_main(base + ["--out", str(cut)])
    monkeypatch.undo()
    capsys.readouterr()
    assert train_main(base + ["--out", str(cut), "--resume"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["epochs_run"] == 3 and summary["steps"] > 0
    run = cut / "tiny_c2" / "seed0"
    for name in ("metrics.jsonl", "summary.json", "config.json",
                 "fit_progress.json"):
        assert (run / name).is_file(), name
    assert len(os.listdir(run / "ckpt" / "best")) == 1
    assert len(os.listdir(run / "ckpt" / "latest")) == 2

    def history(d):
        lines = (d / "tiny_c2" / "seed0" / "metrics.jsonl").read_text()
        return [{k: v for k, v in json.loads(x).items()
                 if k not in ("ts", "firm_months_per_sec")}
                for x in lines.splitlines()]

    assert [r["epoch"] for r in history(cut)] == [0, 1, 2]
    for a, b in zip(history(cut), history(whole), strict=True):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)


def test_cli_trains_the_ensemble_and_resumes(tmp_path, capsys,
                                             monkeypatch):
    """``--n-seeds 3`` on a c5-derived config (hidden 8, window 12) with
    ``--device cpu --scale 0.02 --epochs 2``: the ensemble's run dir
    (``ensemble.flag``, config, summary, the stacked checkpoint lines),
    and a run that dies after its first epoch, resumed, ends with the
    history of an unbroken run."""
    c5 = config.get_preset("c5")
    cfg = dataclasses.replace(
        c5, name="tiny_c5",
        data=dataclasses.replace(c5.data, window=12, firms_per_date=32),
        model=dataclasses.replace(c5.model, kwargs={"hidden": 8}),
        optim=dataclasses.replace(c5.optim, warmup_steps=3))
    path = tmp_path / "tiny_c5.json"
    path.write_text(cfg.to_json())
    base = ["--config", str(path), "--device", "cpu", "--scale", "0.02",
            "--epochs", "2", "--n-seeds", "3"]
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
    assert summary["n_seeds"] == 3 and summary["epochs_run"] == 2
    run = cut / "tiny_c5" / "ensemble"
    for name in ("ensemble.flag", "config.json", "summary.json",
                 "metrics.jsonl", "fit_progress.json"):
        assert (run / name).is_file(), name
    assert len(os.listdir(run / "ckpt" / "latest")) == 2

    def history(d):
        lines = (d / "tiny_c5" / "ensemble" / "metrics.jsonl").read_text()
        return [{k: v for k, v in json.loads(x).items()
                 if k not in ("ts", "firm_months_per_sec")}
                for x in lines.splitlines()]

    assert [r["epoch"] for r in history(cut)] == [0, 1]
    for a, b in zip(history(cut), history(whole), strict=True):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)


def test_cli_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--preset", "c2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--preset", "c5"])
