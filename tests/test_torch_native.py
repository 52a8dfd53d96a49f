"""The port's native (C++) sampler (``native/``, ``DateBatchSampler(
engine="native")``), on the CPU: its epochs byte-equal to the JAX
package's native engine (each package builds its own library from its own
copy of the source); the structure checks of the JAX
``tests/test_native.py``; determinism and seed sensitivity; ``"native"``
raising and ``"auto"`` falling back when the library cannot be built; one
tiny epoch trained with it.
"""

import dataclasses

import numpy as np
import pytest

from lfm_quant_tpu_torch import native
from lfm_quant_tpu_torch.config import (DataConfig, ModelConfig, OptimConfig,
                                        RunConfig)
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.data.windows import DateBatchSampler
from lfm_quant_tpu_torch.train.loop import Trainer

PANEL = dict(n_firms=60, n_months=120, n_features=3, seed=1)


def _pair(**kw):
    panel = synthetic_panel(**PANEL)
    return tuple(DateBatchSampler(panel, window=12, dates_per_batch=4,
                                  firms_per_date=16, seed=5, engine=e, **kw)
                 for e in ("python", "native"))


def _bytes(b):
    return tuple(getattr(b, f).tobytes() for f in
                 ("firm_idx", "time_idx", "weight"))


def test_library_builds_outside_the_package():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "lfm_quant_tpu_torch"
    assert path.parent.parent.name == "build"
    assert not list(native.SRC.parent.glob("*.so"))


@pytest.mark.parametrize("kw", [{}, dict(date_range=(30, 100))])
def test_native_epoch_byte_equal_to_jax(kw):
    """The port's native epochs (stacked, and batch by batch) and the JAX
    package's native engine's, on the same panel and seed."""
    from lfm_quant_tpu import native as jax_native
    from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
    from lfm_quant_tpu.data.windows import DateBatchSampler as JaxSampler

    if not jax_native.available():
        pytest.skip("the JAX package's native library did not build")
    _, ours = _pair(**kw)
    ref = JaxSampler(jax_synthetic(**PANEL), window=12, dates_per_batch=4,
                     firms_per_date=16, seed=5, engine="native", **kw)
    for epoch in (0, 3):
        assert _bytes(ours.stacked_epoch(epoch)) == \
            _bytes(ref.stacked_epoch(epoch))
        for a, b in zip(ours.epoch(epoch), ref.epoch(epoch)):
            assert _bytes(a) == _bytes(b)


def test_native_sampler_structure():
    """JAX ``tests/test_native.py:168-200``: the same shapes and dates as
    the Python engine's epoch; each date's real firms drawn from its pool
    without replacement, pads from the pool at weight 0."""
    py, nat = _pair()
    assert nat.batches_per_epoch() == py.batches_per_epoch()
    b_nat, b_py = nat.stacked_epoch(0), py.stacked_epoch(0)
    assert b_nat.firm_idx.shape == b_py.firm_idx.shape
    assert b_nat.weight.shape == b_py.weight.shape
    np.testing.assert_array_equal(np.sort(b_nat.time_idx.ravel()),
                                  np.sort(b_py.time_idx.ravel()))
    pools = {int(t): set(map(int, nat._firms_by_date[int(t)]))
             for t in nat._dates}
    K, D, Bf = b_nat.firm_idx.shape
    for k in range(K):
        for j in range(D):
            t = int(b_nat.time_idx[k, j])
            fi, w = b_nat.firm_idx[k, j], b_nat.weight[k, j]
            assert set(map(int, fi)) <= pools[t]
            real = fi[w > 0]
            assert len(set(map(int, real))) == real.size
            assert (w > 0).sum() == min(len(pools[t]), Bf)


def test_native_deterministic_and_seed_sensitive():
    _, nat = _pair()
    a, b = nat.stacked_epoch(3), nat.stacked_epoch(3)
    assert _bytes(a) == _bytes(b)
    assert not np.array_equal(a.firm_idx, nat.stacked_epoch(4).firm_idx)
    other = DateBatchSampler(synthetic_panel(**PANEL), window=12,
                             dates_per_batch=4, firms_per_date=16, seed=6,
                             engine="native")
    assert not np.array_equal(a.firm_idx, other.stacked_epoch(3).firm_idx)
    auto = DateBatchSampler(synthetic_panel(**PANEL), window=12,
                            dates_per_batch=4, firms_per_date=16, seed=5,
                            engine="auto")
    assert _bytes(auto.stacked_epoch(3)) == _bytes(a)


def test_native_raises_and_auto_falls_back_without_a_build(tmp_path,
                                                           monkeypatch):
    """No toolchain: "native" raises, "auto" takes the Python engine."""
    import subprocess

    def no_gpp(*a, **k):
        raise OSError("g++: not found")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "missing.so")
    monkeypatch.setattr(subprocess, "run", no_gpp)
    panel = synthetic_panel(**PANEL)
    with pytest.raises(RuntimeError, match="native library"):
        DateBatchSampler(panel, 12, 4, 16, seed=5,
                         engine="native").stacked_epoch(0)
    auto = DateBatchSampler(panel, 12, 4, 16, seed=5, engine="auto")
    ref = DateBatchSampler(panel, 12, 4, 16, seed=5, engine="python")
    assert _bytes(auto.stacked_epoch(1)) == _bytes(ref.stacked_epoch(1))
    assert not native.available()


def test_one_epoch_trains_with_the_native_sampler(tmp_path):
    cfg = RunConfig(
        name="native_smoke",
        data=DataConfig(n_firms=80, n_months=96, n_features=4, window=8,
                        dates_per_batch=2, firms_per_date=16,
                        sampler_engine="native"),
        model=ModelConfig(kind="lstm", kwargs={"hidden": 8},
                          scan_impl="pallas_fused"),
        optim=OptimConfig(epochs=1, warmup_steps=1))
    panel = synthetic_panel(n_firms=80, n_months=96, n_features=4, seed=3,
                            min_history=40)
    splits = PanelSplits.by_date(panel, 197506, 197610)
    trainer = Trainer(cfg, splits, device="cpu")
    assert trainer.train_sampler._use_native()
    out = trainer.fit()
    assert out["steps"] > 0 and np.isfinite(out["best_val_ic"])
    py = Trainer(dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, sampler_engine="python")), splits, device="cpu").fit()
    assert py["steps"] == out["steps"]
    assert py["step_losses"] != out["step_losses"]  # another data order
