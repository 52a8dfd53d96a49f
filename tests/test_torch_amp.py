"""The port's precision lane (``LFM_PRECISION``, ``config.py``) held to
the contracts of the JAX amp lane (``tests/test_amp.py``), and the
numerical sanitizer (``utils/debug.py``) held to JAX's ``sanitized()``.

* Knob routing: ``RunConfig.precision`` wins over ``LFM_PRECISION``,
  default f32, a bad value fails loudly; the lane round-trips through
  ``config.json`` and lands in the telemetry manifest.
* Cast boundaries: bf16 compute (the resident panel and the trunk) over
  f32 MASTER params and f32 Adam moments, before and after a fit, in the
  single model and in the stacked runs' member tree; targets, forecasts
  and the sweep's metrics stay f32; the trunk's activations really are
  bf16.
* Decisions: the bf16 fit's epochs run and best epoch EXACT against the
  f32 fit at equal seeds, val ICs within 0.02 (JAX's tolerance).
* Against the JAX lane: the port's bf16 fit from the JAX ``Trainer``'s
  init against the JAX bf16 fit of the same config and panel (the JAX
  recurrence on its device's path, ``scan_impl="pallas_fused"``, the
  Pallas kernel in interpret mode): epochs run and best epoch exact, val
  ICs within 0.02, and each epoch's train loss within atol 2e-4, which
  an f32 lane (3.7e-4 from the JAX bf16 fit) or a cast placed elsewhere
  than JAX's (the XLA scan's bf16 lane: 1.2e-3) does not meet.
* The sanitizer raises on a NaN injected into a step (the panel's
  features, an optimizer moment), names the bad leaves, and is a no-op
  when off.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lfm_quant_tpu import config as jax_config
from lfm_quant_tpu.data import synthetic_panel as jax_synthetic
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.windows import clear_panel_cache
from lfm_quant_tpu.train import reuse
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    OptimConfig,
    RunConfig,
    compute_dtype,
    resolve_precision,
)
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.train import stacked as ST
from lfm_quant_tpu_torch.train.loop import Trainer
from lfm_quant_tpu_torch.utils import debug, telemetry


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its shapes are tiny, and the
    tier-1 run's workers share the machine's cores (more threads burn
    about three times the CPU for the same wall)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(epochs=3, cfg_mod=None, scan_impl="auto", **opt):
    m = cfg_mod
    return (m.RunConfig if m else RunConfig)(
        name="amp",
        data=(m.DataConfig if m else DataConfig)(
            n_firms=100, n_months=200, n_features=5, window=12,
            dates_per_batch=4, firms_per_date=32),
        # A recurrent trunk, as JAX's lane: the widest cast surface.
        model=(m.ModelConfig if m else ModelConfig)(
            kind="gru", kwargs={"hidden": 8}, scan_impl=scan_impl),
        optim=(m.OptimConfig if m else OptimConfig)(
            **{"lr": 1e-3, "epochs": epochs, "warmup_steps": 5,
               "loss": "mse", **opt}),
        seed=0)


@pytest.fixture(scope="module")
def jax_bf16():
    """The JAX bf16 lane's fit (4 epochs, patience 2) on the same panel,
    with its recurrence on the path it takes on its device (the fused
    Pallas kernel, in interpret mode here); returns its init params and
    summary. The JAX caches are emptied around it (a lane flip must not
    reuse another lane's programs or resident panel)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LFM_PRECISION", "bf16")
        reuse.clear_program_cache()
        clear_panel_cache()
        try:
            jt = JaxTrainer(
                _cfg(4, jax_config, "pallas_fused", early_stop_patience=2),
                JaxSplits.by_date(jax_synthetic(n_firms=100, n_months=200,
                                                n_features=5, seed=5),
                                  198001, 198201))
            init = jax.tree_util.tree_map(np.asarray,
                                          jt.init_state().params)
            summary = jt.fit()
        finally:
            reuse.clear_program_cache()
            clear_panel_cache()
    return init, summary


@pytest.fixture(scope="module")
def splits():
    panel = synthetic_panel(n_firms=100, n_months=200, n_features=5, seed=5)
    return PanelSplits.by_date(panel, 198001, 198201)


def _f32(tensors):
    return {str(t.dtype) for t in tensors} == {"torch.float32"}


def test_knob_routing(monkeypatch):
    monkeypatch.delenv("LFM_PRECISION", raising=False)
    cfg = _cfg()
    assert resolve_precision() == resolve_precision(cfg) == "f32"
    assert compute_dtype(cfg) is None
    monkeypatch.setenv("LFM_PRECISION", "bf16")
    assert resolve_precision() == resolve_precision(cfg) == "bf16"
    assert compute_dtype(cfg) == torch.bfloat16
    pinned = dataclasses.replace(cfg, precision="f32")  # config wins
    assert resolve_precision(pinned) == "f32" and compute_dtype(pinned) is None
    monkeypatch.delenv("LFM_PRECISION")
    assert resolve_precision(dataclasses.replace(cfg, precision="bf16")) \
        == "bf16"
    mdl = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             bf16=True))
    assert compute_dtype(mdl) == torch.bfloat16
    monkeypatch.setenv("LFM_PRECISION", "fp16")
    with pytest.raises(ValueError, match="precision"):
        resolve_precision()
    monkeypatch.delenv("LFM_PRECISION")
    with pytest.raises(ValueError, match="precision"):
        resolve_precision(dataclasses.replace(cfg, precision="half"))


def test_precision_roundtrips_config_json_and_the_manifest(monkeypatch):
    monkeypatch.delenv("LFM_PRECISION", raising=False)
    back = RunConfig.from_json(dataclasses.replace(
        _cfg(), precision="bf16").to_json())
    assert back.precision == "bf16" and resolve_precision(back) == "bf16"
    monkeypatch.setenv("LFM_PRECISION", "bf16")
    m = telemetry.build_manifest()
    assert m["knobs"]["precision"] == "bf16"
    assert m["env_lfm"].get("LFM_PRECISION") == "bf16"


def test_master_params_and_moments_stay_f32(splits, monkeypatch):
    """bf16 compute over f32 state: the resident panel and the model in
    bf16, the targets, params, both moments, the forecasts and the sweep's
    metrics in f32, before and after a fit; and the same in the stacked
    runs' member tree."""
    monkeypatch.setenv("LFM_PRECISION", "bf16")
    tr = Trainer(_cfg(epochs=1), splits, device="cpu")
    assert tr.dev["xm"].dtype == torch.bfloat16
    assert tr.dev["targets"].dtype == torch.float32
    assert tr.model.dtype == torch.bfloat16
    state = tr.init_state()
    o = state.opt_state
    assert _f32(state.params.values())
    assert _f32(list(o.mu.values()) + list(o.nu.values()))
    tr.fit()
    o = tr.state.opt_state
    assert _f32(tr.state.params.values())
    assert _f32(list(o.mu.values()) + list(o.nu.values()))
    pred, valid = tr.predict(split="val")
    assert pred.dtype == np.float32 and valid.any()
    ev = tr.evaluate()
    assert np.isfinite(ev["ic"]) and np.isfinite(ev["mse"])
    one = _cfg(epochs=1)
    runs = [one, dataclasses.replace(one, optim=dataclasses.replace(
        one.optim, lr=3e-4))]
    eng = ST.StackedRuns(runs, [splits] * 2, splits.panel, device="cpu")
    assert eng.trainer.model.dtype == torch.bfloat16
    eng.fit()
    st = eng._final.state
    assert _f32(list(st.params.values()) + list(st.opt_state.mu.values())
                + list(st.opt_state.nu.values())
                + list(eng._final.best_params.values()))


def test_bf16_trunk_actually_computes_in_bf16(splits, monkeypatch):
    """The lane is not a no-op: the gathered windows and the trunk's
    activations of a bf16 step are bf16, while the f32 lane's stay f32;
    the head's output is f32 either way."""
    got = {}
    for lane in ("bf16", "f32"):
        monkeypatch.setenv("LFM_PRECISION", lane)
        tr = Trainer(_cfg(), splits, device="cpu")
        b = tr.val_sampler.stacked_cross_sections()
        fi, ti, _ = tr._batch(b)
        x, m = tr._gather(fi[:2], ti[:2])
        seen = []
        hook = tr.model.embed.register_forward_hook(
            lambda mod, inp, out: seen.append(out.dtype))
        out = tr._apply(x, m)
        hook.remove()
        got[lane] = (x.dtype, m.dtype, seen[0], out.dtype)
    assert got["bf16"][:3] == (torch.bfloat16, torch.bool, torch.bfloat16)
    assert got["f32"][:3] == (torch.float32, torch.bool, torch.float32)
    assert got["bf16"][3] == got["f32"][3] == torch.float32


def test_decisions_exact_vs_f32_at_equal_seeds(splits, monkeypatch):
    """Same seeds, f32 against bf16: the same epochs run and best epoch
    (early stopping compares f32 ICs on both lanes), every epoch's val IC
    within 0.02."""
    cfg = _cfg(epochs=4, early_stop_patience=2)
    monkeypatch.delenv("LFM_PRECISION", raising=False)
    f32 = Trainer(cfg, splits, device="cpu").fit()
    monkeypatch.setenv("LFM_PRECISION", "bf16")
    b16 = Trainer(cfg, splits, device="cpu").fit()
    assert b16["epochs_run"] == f32["epochs_run"]
    assert b16["best_epoch"] == f32["best_epoch"]
    assert abs(b16["best_val_ic"] - f32["best_val_ic"]) <= 0.02
    np.testing.assert_allclose([h["val_ic"] for h in b16["history"]],
                               [h["val_ic"] for h in f32["history"]],
                               atol=0.02)


def test_bf16_fit_matches_the_jax_bf16_lane(splits, jax_bf16, monkeypatch):
    """The port's bf16 fit from the JAX init against the JAX bf16 fit:
    epochs run and best epoch exact, val ICs within 0.02 (JAX's
    tolerance), each epoch's train loss within atol 2e-4 (the reading:
    9e-5; the same fit in f32 is 3.7e-4 away)."""
    init, want = jax_bf16
    monkeypatch.setenv("LFM_PRECISION", "bf16")
    tr = Trainer(_cfg(4, early_stop_patience=2), splits, device="cpu")
    assert tr.model.dtype == torch.bfloat16
    got = tr.fit(init_params=init)
    assert got["epochs_run"] == want["epochs_run"]
    assert got["best_epoch"] == want["best_epoch"]
    assert abs(got["best_val_ic"] - want["best_val_ic"]) <= 0.02
    np.testing.assert_allclose([h["val_ic"] for h in got["history"]],
                               [h["val_ic"] for h in want["history"]],
                               atol=0.02)
    np.testing.assert_allclose([h["train_loss"] for h in got["history"]],
                               [h["train_loss"] for h in want["history"]],
                               rtol=0, atol=2e-4)


def test_sanitizer_raises_on_an_injected_nan(splits):
    """Under ``sanitized()`` a NaN a step makes raises: one NaN feature
    cell in the resident panel (the backward's anomaly check or the step
    boundary's), then a broken Adam moment whose update makes a parameter
    NaN after a finite backward (the boundary's check names it); without
    it the same step runs on, NaN and all. The check never cleans a
    value."""
    tr = Trainer(_cfg(epochs=1), splits, device="cpu")
    b = tr.train_sampler.stacked_epoch(0)
    fi, ti, w = tr._batch(b)
    f, t = int(fi[0, 0, 0]), int(ti[0, 0])
    tr.dev["xm"][f, t, 0] = float("nan")
    state = tr.init_state()
    state, ms = tr.step(state, fi[0], ti[0], w[0])
    assert not torch.isfinite(ms["loss"])
    with pytest.raises((FloatingPointError, RuntimeError),
                       match="nan|non-finite"):
        with debug.sanitized():
            tr.step(tr.init_state(), fi[0], ti[0], w[0])
    assert not debug.active()
    tr.dev["xm"][f, t, 0] = 0.0
    state = tr.init_state()
    state.opt_state.nu["head/out/bias"].fill_(-1.0)  # sqrt → NaN update
    with pytest.raises(FloatingPointError, match="params/head/out/bias"):
        with debug.sanitized():
            tr.step(state, fi[0], ti[0], w[0])
    assert torch.isnan(state.params["head/out/bias"]).all()
    with pytest.raises(FloatingPointError, match="params/a"):
        debug.assert_finite_tree({"params": {"a": np.array([np.nan]),
                                             "b": np.zeros(2)}})
    debug.assert_finite_tree({"a": torch.ones(3)})
    debug.check_step({"loss": torch.tensor(float("nan"))})  # off: no-op
