"""The port's async epoch pipeline and preemption (``train/pipeline.py``,
``train/preempt.py``, ``train/checkpoint.py``), after the JAX package's
``tests/test_pipeline.py`` and the preemption half of
``tests/test_chaos.py``, on the CPU:

* the four ``LFM_ASYNC`` × ``LFM_ASYNC_CKPT`` settings give bitwise-equal
  histories, decisions and restored params; an early stop that strands
  the lookahead epoch rolls back to the last recorded epoch, which never
  reaches a checkpoint or the metrics stream; resume reconciles a
  progress sidecar that ran ahead of (or behind) the committed lines;
  exactly one counted host sync per epoch; the ensemble's parity; one
  fit with ``LFM_ASYNC=1`` on both sides against the JAX trainer at rtol
  1e-4;
* the ``ckpt_write`` fault site fires and heals, the checkpoint waits are
  bounded, a SIGTERM at a checkpoint write stops a fit that resumes with
  an identical history and best params (in process, and once as a real
  subprocess of ``python -m lfm_quant_tpu_torch.train`` that exits 75),
  and ``grace_scope`` installs and restores the handler;
* on the card (``cuda``): one pipelined epoch's dispatch never waits for
  the device.

jax is imported inside the one test that needs it: the ``cuda`` test
runs on the card machine, which has none.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from lfm_quant_tpu_torch.config import (DataConfig, ModelConfig, OptimConfig,
                                        RunConfig)
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.train import pipeline, preempt
from lfm_quant_tpu_torch.train.checkpoint import CheckpointManager
from lfm_quant_tpu_torch.train.ensemble import EnsembleTrainer
from lfm_quant_tpu_torch.train.loop import FitHarness, Trainer
from lfm_quant_tpu_torch.utils import faults, telemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: History fields that must match bit for bit across the settings.
DET = ("epoch", "train_loss", "grad_norm", "val_ic", "val_mse",
       "val_ic_std")
PANEL = dict(n_firms=100, n_months=200, n_features=5, seed=5)


def _cfg(tmp, epochs=4, patience=99, lr=1e-3, n_seeds=1, kind="mlp"):
    return RunConfig(
        name="pipe",
        data=DataConfig(n_firms=100, n_months=200, n_features=5, window=12,
                        dates_per_batch=4, firms_per_date=32),
        model=ModelConfig(kind=kind, kwargs={"hidden": (16,)} if kind == "mlp"
                          else {"hidden": 8}, scan_impl="pallas_fused"),
        optim=OptimConfig(lr=lr, epochs=epochs, warmup_steps=5, loss="mse",
                          early_stop_patience=patience),
        seed=0, n_seeds=n_seeds, out_dir=str(tmp))


@pytest.fixture(scope="module")
def splits():
    return PanelSplits.by_date(synthetic_panel(**PANEL), 198001, 198201)


@pytest.fixture(autouse=True)
def _clean():
    faults.configure("")
    preempt.clear()
    yield
    faults.configure("")
    preempt.clear()


def _knobs(monkeypatch, loop, ckpt):
    monkeypatch.setenv("LFM_ASYNC", "1" if loop else "0")
    monkeypatch.setenv("LFM_ASYNC_CKPT", "1" if ckpt else "0")


def _fit(cfg, splits, run_dir, device="cpu"):
    cls = EnsembleTrainer if cfg.n_seeds > 1 else Trainer
    trainer = cls(cfg, splits, run_dir=run_dir, device=device)
    return trainer, trainer.fit()


def _det(history):
    return [tuple((k, r[k]) for k in DET if k in r) for r in history]


def _params(trainer):
    return {k: p.detach().clone() for k, p in trainer.state.params.items()}


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("n_seeds", [1, 2])
def test_four_knob_settings_agree_bitwise(splits, tmp_path, monkeypatch,
                                          n_seeds):
    """History, best and early-stop epochs, step losses and the restored
    best params: bitwise equal under the four settings (the ensemble's
    too), each epoch ONE counted host sync."""
    out = {}
    for loop in (False, True):
        for ckpt in (False, True):
            _knobs(monkeypatch, loop, ckpt)
            snap = telemetry.COUNTERS.snapshot()
            t, s = _fit(_cfg(tmp_path, epochs=3, n_seeds=n_seeds), splits,
                        str(tmp_path / f"r{n_seeds}{int(loop)}{int(ckpt)}"))
            syncs = telemetry.COUNTERS.delta(snap).get("host_syncs", 0)
            assert syncs == s["epochs_run"], (loop, ckpt, syncs)
            out[loop, ckpt] = s, _params(t)
    ref, ref_p = out[False, False]
    for key, (s, p) in out.items():
        assert _det(s["history"]) == _det(ref["history"]), key
        assert s["step_losses"] == ref["step_losses"], key
        for k in ("best_epoch", "epochs_run", "best_val_ic", "steps"):
            assert s[k] == ref[k], (key, k)
        assert _same(p, ref_p), key


def test_early_stop_overrun_is_discarded(splits, tmp_path, monkeypatch):
    """lr 0 freezes the val IC after epoch 0, so patience 1 stops the run:
    with the lookahead, the epoch already queued is discarded; history,
    the epochs run and both checkpoint lines equal the lock-step run's
    and the overrun epoch never reaches the latest line or the metrics
    stream."""
    kw = dict(epochs=8, patience=1, lr=0.0)
    res = {}
    for loop in (False, True):
        _knobs(monkeypatch, loop, loop)
        run_dir = str(tmp_path / f"es{int(loop)}")
        t, s = _fit(_cfg(tmp_path, **kw), splits, run_dir)
        res[loop] = s, _params(t), run_dir, t
    (s0, p0, _, t0), (s1, p1, d1, _) = res[False], res[True]
    assert s0["epochs_run"] < 8
    assert s0["epochs_run"] == s1["epochs_run"]
    assert _det(s0["history"]) == _det(s1["history"])
    assert s1["lookahead_overrun"] and not s0["lookahead_overrun"]
    assert _same(p0, p1)
    spe = t0.train_sampler.batches_per_epoch()
    latest = CheckpointManager(os.path.join(d1, "ckpt", "latest"))
    assert latest.latest_step() == s1["epochs_run"] * spe
    with open(os.path.join(d1, "metrics.jsonl")) as fh:
        epochs = [json.loads(line)["epoch"] for line in fh]
    assert epochs == list(range(s1["epochs_run"]))


def test_overrun_rolls_back_without_a_run_dir(splits, tmp_path,
                                              monkeypatch):
    """A stranded epoch that really trained (lr > 0) and no best
    checkpoint to restore: the final state is rolled back to the last
    recorded epoch's clone, the lock-step run's params, and it is the
    MODEL's params (predict reads them)."""
    out = {}
    for loop in (False, True):
        _knobs(monkeypatch, loop, loop)
        t, s = _fit(_cfg(tmp_path, epochs=8, patience=1, lr=3e-2), splits,
                    None)
        assert s["epochs_run"] < 8
        assert s["lookahead_overrun"] == loop
        out[loop] = _params(t), t.predict()[0]
    assert _same(out[False][0], out[True][0])
    np.testing.assert_array_equal(out[False][1], out[True][1])


def _forge(run_dir, **prog):
    with open(os.path.join(run_dir, "fit_progress.json"), "w") as fh:
        json.dump(prog, fh)


def test_resume_reconciles_the_sidecar(splits, tmp_path, monkeypatch):
    """JAX ``tests/test_pipeline.py:149-240``: a sidecar AHEAD of the
    committed latest line (a save that never committed) and one BEHIND it
    (a lost sidecar write) fall back to counters from the checkpoint; a
    phantom best claim falls back to the committed best, its IC from
    metrics.jsonl; a healthy sidecar is trusted."""
    _knobs(monkeypatch, True, True)
    t1, s1 = _fit(_cfg(tmp_path, epochs=2), splits, str(tmp_path / "a"))
    spe = t1.train_sampler.batches_per_epoch()
    ok = FitHarness(str(tmp_path / "a"), 4, 99, spe)
    assert ok.resume() is not None and ok.start_epoch == 2
    assert ok.best_ic == s1["best_val_ic"]
    _forge(str(tmp_path / "a"), epoch=3, best_ic=99.0, best_epoch=3,
           bad_epochs=0)
    s2 = Trainer(_cfg(tmp_path, epochs=4), splits,
                 run_dir=str(tmp_path / "a"), device="cpu").fit(resume=True)
    assert [r["epoch"] for r in s2["history"]] == [2, 3]
    assert s2["best_val_ic"] != 99.0 and s2["steps"] == 4 * spe
    assert s2["best_val_ic"] >= s1["best_val_ic"]
    # Behind: epoch 1 committed, the sidecar still says epoch 0.
    _fit(_cfg(tmp_path, epochs=2), splits, str(tmp_path / "b"))
    _forge(str(tmp_path / "b"), epoch=0, best_ic=0.0, best_epoch=0,
           bad_epochs=0)
    s3 = Trainer(_cfg(tmp_path, epochs=4), splits,
                 run_dir=str(tmp_path / "b"), device="cpu").fit(resume=True)
    assert [r["epoch"] for r in s3["history"]] == [2, 3]
    # Phantom best: lr 0 only ever improves at epoch 0.
    tp, sp = _fit(_cfg(tmp_path, epochs=2, lr=0.0), splits,
                  str(tmp_path / "c"))
    assert sp["best_epoch"] == 0
    _forge(str(tmp_path / "c"), epoch=1, best_ic=99.0, best_epoch=1,
           bad_epochs=0)
    t4 = Trainer(_cfg(tmp_path, epochs=4, lr=0.0), splits,
                 run_dir=str(tmp_path / "c"), device="cpu")
    s4 = t4.fit(resume=True)
    assert [r["epoch"] for r in s4["history"]] == [2, 3]
    assert s4["best_epoch"] == 0
    assert s4["best_val_ic"] == sp["history"][0]["val_ic"]
    assert _same(_params(tp), _params(t4))


def test_async_fit_matches_jax(splits, tmp_path, monkeypatch):
    """``LFM_ASYNC=1`` on both sides, the port starting from the JAX init
    (``weights.py``): val ICs and losses at rtol 1e-4, the decisions
    exact."""
    import jax

    from lfm_quant_tpu import config as jax_config
    from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
    from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
    from lfm_quant_tpu.train.loop import Trainer as JaxTrainer

    _knobs(monkeypatch, True, True)
    cfg = _cfg(tmp_path, epochs=4, patience=2)
    jcfg = jax_config.RunConfig.from_json(cfg.to_json())
    jt = JaxTrainer(jcfg, JaxSplits.by_date(jax_synthetic(**PANEL), 198001,
                                            198201),
                    run_dir=str(tmp_path / "jax"))
    init = jax.tree_util.tree_map(np.asarray, jt.init_state().params)
    want = jt.fit()
    tt = Trainer(cfg, splits, run_dir=str(tmp_path / "port"), device="cpu")
    orig = tt.init_state
    tt.init_state = lambda params=None: orig(init if params is None
                                             else params)
    got = tt.fit()
    for k in ("best_epoch", "epochs_run", "lookahead_overrun"):
        assert got[k] == want[k], k
    for g, w in zip(got["history"], want["history"]):
        for k in ("val_ic", "train_loss", "val_mse"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6)


# ---- preemption -----------------------------------------------------------


def test_ckpt_write_site_fires_and_heals(tmp_path):
    faults.configure("ckpt_write:at=0")
    mgr = CheckpointManager(str(tmp_path / "latest"))
    state = {"x": torch.zeros(3)}
    with pytest.raises(faults.TransientFault):
        mgr.save(1, state)
    assert mgr.latest_step() is None
    faults.configure("")
    mgr.save(1, state, wait=True)
    assert mgr.latest_step() == 1
    mgr.close()


def test_checkpoint_waits_are_bounded(tmp_path, monkeypatch):
    """A wedged writer cannot hang shutdown: the wait is bounded
    (``LFM_CKPT_WAIT_S``), warns and counts, and ``close`` abandons."""
    mgr = CheckpointManager(str(tmp_path / "latest"))
    release = threading.Event()
    monkeypatch.setattr(mgr, "_write", lambda step, state: release.wait(30))
    mgr.save(1, {"x": torch.zeros(3)})
    before = telemetry.COUNTERS.get("ckpt_wait_timeouts") or 0
    t0 = time.perf_counter()
    with pytest.warns(RuntimeWarning, match="still\\s+unfinished"):
        assert mgr.wait(timeout_s=0.1) is False
    monkeypatch.setenv("LFM_CKPT_WAIT_S", "0.1")
    with pytest.warns(RuntimeWarning, match="abandoned"):
        mgr.close()
    assert time.perf_counter() - t0 < 5.0
    assert telemetry.COUNTERS.get("ckpt_wait_timeouts") == before + 2
    release.set()
    assert mgr.wait() is True


def _history(run_dir):
    """metrics.jsonl → {epoch: (val_ic, train_loss)}, the last line of an
    epoch winning (a resumed run appends)."""
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            out[rec["epoch"]] = (rec["val_ic"], rec["train_loss"])
    return out


def _best(run_dir):
    best = CheckpointManager(os.path.join(run_dir, "ckpt", "best")).restore()
    return best["params"]


def test_sigterm_grace_stop_resumes_identically(splits, tmp_path,
                                                monkeypatch):
    """SIGTERM at the third checkpoint write: the fit stops with its
    recorded epochs durable (``Preempted``); a resume reproduces the
    uninterrupted fit's history and best params exactly."""
    _knobs(monkeypatch, True, True)
    cfg = _cfg(tmp_path, epochs=4)
    _, ref = _fit(cfg, splits, str(tmp_path / "ref"))
    faults.configure("ckpt_write:at=2,kind=sigterm")
    with pytest.raises(preempt.Preempted):
        _fit(cfg, splits, str(tmp_path / "cut"))
    faults.configure("")
    preempt.clear()
    part = _history(str(tmp_path / "cut"))
    assert 0 < len(part) < ref["epochs_run"], part
    s = Trainer(cfg, splits, run_dir=str(tmp_path / "cut"),
                device="cpu").fit(resume=True)
    assert s["best_epoch"] == ref["best_epoch"]
    assert _history(str(tmp_path / "cut")) == _history(str(tmp_path / "ref"))
    assert _same(_best(str(tmp_path / "cut")), _best(str(tmp_path / "ref")))


def test_subprocess_sigterm_exits_75_and_resumes(tmp_path):
    """The entry point as a REAL subprocess: ``python -m
    lfm_quant_tpu_torch.train`` SIGTERM'd at a checkpoint write exits 75;
    ``--resume`` finishes it with the history and best params of an
    uninterrupted fit."""
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(_cfg(tmp_path / "run", epochs=4).to_json())
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("LFM_FAULTS", None)
    cmd = [sys.executable, "-m", "lfm_quant_tpu_torch.train", "--config",
           str(cfg_path), "--device", "cpu"]
    cut = subprocess.run(cmd, env=dict(env, LFM_FAULTS=(
        "ckpt_write:at=2,kind=sigterm")), capture_output=True, text=True,
        timeout=240, cwd=ROOT)
    assert cut.returncode == 75, cut.stderr[-2000:]
    assert json.loads(cut.stdout)["preempted"] is True
    run_dir = str(tmp_path / "run" / "pipe" / "seed0")
    assert 0 < len(_history(run_dir)) < 4
    done = subprocess.run(cmd + ["--resume"], env=env, capture_output=True,
                          text=True, timeout=240, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-2000:]
    from lfm_quant_tpu_torch.train.__main__ import main as train_main

    ref_path = tmp_path / "ref.json"
    ref_path.write_text(_cfg(tmp_path / "ref", epochs=4).to_json())
    assert train_main(["--config", str(ref_path), "--device", "cpu"]) == 0
    ref_dir = str(tmp_path / "ref" / "pipe" / "seed0")
    assert _history(run_dir) == _history(ref_dir)
    assert _same(_best(run_dir), _best(ref_dir))


def test_grace_scope_installs_and_restores_the_handler():
    prev = signal.getsignal(signal.SIGTERM)
    with preempt.grace_scope():
        assert signal.getsignal(signal.SIGTERM) is preempt._handler
        with preempt.grace_scope():  # nested: one installation
            assert signal.getsignal(signal.SIGTERM) is preempt._handler
        assert signal.getsignal(signal.SIGTERM) is preempt._handler
        assert not preempt.requested()
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.perf_counter() + 2.0
        while not preempt.requested() and time.perf_counter() < deadline:
            time.sleep(0.001)
        assert preempt.requested()
    assert signal.getsignal(signal.SIGTERM) == prev


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (python3 chip_smoke.py runs "
                    "phase 20 there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_seeds", [1, 2])
def test_dispatch_never_waits_for_the_card(cuda, splits, tmp_path,
                                           monkeypatch, n_seeds):
    """``torch.cuda.set_sync_debug_mode("error")`` around every dispatch
    after the first (which builds the kernels): a pipelined LSTM fit in
    bf16 at hidden 128 on the kernels, the ensemble's too, makes no
    synchronizing call between an epoch's first launch and its fetch."""
    _knobs(monkeypatch, True, True)
    orig = pipeline.run_fit_epochs
    calls = []

    def strict(harness, state, *, dispatch, **kw):
        def checked(state, batches):
            calls.append(1)
            if len(calls) > 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                return dispatch(state, batches)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        return orig(harness, state, dispatch=checked, **kw)

    monkeypatch.setattr(pipeline, "run_fit_epochs", strict)
    cfg = _cfg(tmp_path, epochs=3, n_seeds=n_seeds, kind="lstm")
    cfg = RunConfig.from_json(cfg.to_json())
    import dataclasses

    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, kwargs={"hidden": 128}, bf16=True))
    _, s = _fit(cfg, splits, str(tmp_path / "card"), device=cuda)
    assert len(calls) == 3 and s["epochs_run"] == 3
    assert all(np.isfinite(r["val_ic"]) for r in s["history"])
