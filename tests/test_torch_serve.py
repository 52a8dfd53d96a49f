"""The slice as a whole: the port's scoring service against the JAX one.

A JAX ``Trainer`` (LSTM, ``scan_impl="pallas_fused"``, ``gather_impl=
"pallas"``, ``init_state()`` params) is registered in the JAX
``ScoringService``; the port's ``ScoringService(device="cpu")`` holds the
same params (converted Flax tree) over the same panel (the port's own
``synthetic_panel`` copy) and config (round-tripped through JSON). Every
serveable month must score the same — one request at a time and
coalesced across client threads. On the JAX side the Pallas kernels run
in interpret mode; on the port's side the kernels' plain versions run.
Tolerances: f32 1e-5, bf16 0.05 (the JAX tests' own bounds).
"""

import threading

import jax
import numpy as np
import pytest
import torch

from lfm_quant_tpu.config import (DataConfig, ModelConfig, OptimConfig,
                                  RunConfig)
from lfm_quant_tpu.data.panel import PanelSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.data.windows import clear_panel_cache
from lfm_quant_tpu.serve import ScoringService as JaxService
from lfm_quant_tpu.train import reuse
from lfm_quant_tpu.train.loop import Trainer
from lfm_quant_tpu_torch import config as tconfig
from lfm_quant_tpu_torch.data.panel import synthetic_panel
from lfm_quant_tpu_torch.serve import ScoringService
from lfm_quant_tpu_torch.serve.errors import ServiceClosedError

PANEL = dict(n_firms=14, n_months=90, n_features=3, seed=3)
TOL = {False: dict(atol=1e-5, rtol=0.0), True: dict(atol=0.05, rtol=0.05)}
MAX_ROWS = 2


@pytest.fixture(autouse=True)
def _fresh_caches():
    reuse.clear_program_cache()
    clear_panel_cache()
    yield
    reuse.clear_program_cache()
    clear_panel_cache()


def _jax_universe(bf16: bool):
    cfg = RunConfig(
        name="torch_serve_t",
        data=DataConfig(n_firms=PANEL["n_firms"],
                        n_months=PANEL["n_months"],
                        n_features=PANEL["n_features"], window=6,
                        dates_per_batch=2, firms_per_date=8,
                        gather_impl="pallas"),
        model=ModelConfig(kind="lstm", kwargs={"hidden": 8},
                          scan_impl="pallas_fused", bf16=bf16),
        optim=OptimConfig(epochs=1, warmup_steps=2),
    )
    panel = jax_synthetic(**PANEL)
    trainer = Trainer(cfg, PanelSplits.by_date(panel, 197401, 197601))
    trainer.state = trainer.init_state()
    assert trainer._gather_impl == "pallas"
    return cfg, trainer


def _both_services(bf16: bool):
    cfg, trainer = _jax_universe(bf16)
    jsvc = JaxService(max_rows=MAX_ROWS, max_wait_ms=1.0)
    jsvc.register("u", trainer, warm=False)
    params = jax.tree_util.tree_map(np.asarray, trainer.state.params)
    tsvc = ScoringService(device="cpu", max_rows=MAX_ROWS, max_wait_ms=1.0)
    tcfg = tconfig.RunConfig.from_json(cfg.to_json())
    tsvc.register("u", tcfg, synthetic_panel(**PANEL), params)
    return jsvc, tsvc


def _check(resp_t, resp_j, bf16):
    np.testing.assert_array_equal(resp_t.firm_idx, resp_j.firm_idx)
    assert resp_t.scores.dtype == np.float32
    assert resp_t.scores.shape == resp_j.scores.shape
    np.testing.assert_allclose(resp_t.scores, np.asarray(resp_j.scores),
                               **TOL[bf16])


@pytest.mark.parametrize("bf16", [False, True])
def test_served_scores_match_jax_service(bf16):
    jsvc, tsvc = _both_services(bf16)
    try:
        months = tsvc.serveable_months("u")
        assert months == jsvc.serveable_months("u")
        assert len(months) > 20
        for month in months:
            _check(tsvc.score("u", month), jsvc.score("u", month), bf16)
        # Coalesced: client threads race, so requests share dispatches
        # (pad rows repeat row 0, pad columns repeat the last firm).
        got = {}
        lock = threading.Lock()

        def client(k):
            for month in months[k::4]:
                r = tsvc.score("u", month)
                with lock:
                    got[month] = r

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        tsvc.reset_stats()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert sorted(got) == months
        futures = {m: jsvc.submit("u", m) for m in months}
        for month in months:
            _check(got[month], futures[month].result(timeout=120), bf16)
        st = tsvc.stats()
        assert st["completed"] == len(months)
        assert st["batches"] < len(months), "requests never coalesced"
        assert 0 < st["mean_occupancy"] <= 1
        assert st["p50_ms"] <= st["p99_ms"] and st["req_per_s"] > 0
    finally:
        jsvc.close()
        tsvc.close()


def test_routing_errors_and_close():
    cfg = tconfig.get_preset("c2")
    cfg = tconfig.RunConfig.from_json(cfg.to_json())
    cfg.data.n_firms, cfg.data.n_months = 12, 80
    cfg.model.kwargs = {"hidden": 8}
    svc = ScoringService(device="cpu", max_rows=4, max_wait_ms=1.0)
    entry = svc.register("c2", cfg, synthetic_panel(
        n_firms=12, n_months=80, n_features=20, seed=0))
    assert entry.generation == 0
    month = svc.serveable_months("c2")[-1]
    resp = svc.score("c2", month)
    assert resp.scores.shape == resp.firm_idx.shape and resp.generation == 0
    assert np.isfinite(resp.scores).all()
    with pytest.raises(KeyError, match="not registered"):
        svc.score("nope", month)
    with pytest.raises(KeyError, match="not serveable"):
        svc.score("c2", 190001)
    # A second registration publishes the next generation.
    assert svc.register("c2", cfg, entry.panel).generation == 1
    assert svc.score("c2", month).generation == 1
    svc.close()
    with pytest.raises(ServiceClosedError):
        svc.score("c2", month)


def test_no_card_raises(monkeypatch):
    """With no card the entry points raise instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScoringService()
    from lfm_quant_tpu_torch.serve.__main__ import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--preset", "c2", "--n-firms", "12", "--n-months", "80"])


def _tiny(n_firms=12):
    cfg = tconfig.RunConfig.from_json(tconfig.get_preset("c2").to_json())
    cfg.data.n_firms, cfg.data.n_months, cfg.data.window = n_firms, 80, 6
    cfg.data.n_features = 3
    cfg.model.kwargs = {"hidden": 8}
    cfg.model.bf16 = False
    return cfg, synthetic_panel(n_firms=n_firms, n_months=80, n_features=3,
                                seed=1)


def test_concurrent_clients_lose_no_request():
    """More client threads than cores, a tiny switch interval: every
    request completes exactly once with its own month's pool and the
    same scores it gets alone, and the stats count each one."""
    import sys

    cfg, panel = _tiny()
    svc = ScoringService(device="cpu", max_rows=4, max_wait_ms=0.5)
    svc.register("u", cfg, panel)
    months = svc.serveable_months("u")
    alone = {m: svc.score("u", m) for m in months[:6]}
    svc.reset_stats()
    got, lock = [], threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(k):
            for i in range(6):
                m = months[(k + i) % 6]
                r = svc.score("u", m, timeout=60)
                with lock:
                    got.append((m, r))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        svc.close()
    assert len(got) == 16 * 6
    for m, r in got:
        assert r.month == m
        np.testing.assert_array_equal(r.firm_idx, alone[m].firm_idx)
        np.testing.assert_allclose(r.scores, alone[m].scores, atol=1e-5)
    st = svc.stats()
    assert st["completed"] == 16 * 6 and st["rows_real"] == 16 * 6
    assert st["batches"] < 16 * 6


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dead_batcher_fails_requests_fast(monkeypatch):
    cfg, panel = _tiny()
    svc = ScoringService(device="cpu", max_rows=2, max_wait_ms=0.5)
    svc.register("u", cfg, panel)
    month = svc.serveable_months("u")[-1]

    def boom():
        raise RuntimeError("batcher bug")

    # The loop is waiting inside _next_batch: that call serves one more
    # request, and the next call dies outside the per-batch failure path.
    monkeypatch.setattr(svc.batcher, "_next_batch", boom)
    svc.score("u", month, timeout=30)
    svc.batcher._thread.join(timeout=10)
    assert not svc.batcher._thread.is_alive()
    from lfm_quant_tpu_torch.serve.errors import BatcherDeadError

    with pytest.raises(BatcherDeadError, match="batcher bug"):
        svc.score("u", month, timeout=5)
    assert svc.stats()["ready"] is False
    svc.close()


def test_zoo_lru_eviction_and_generations():
    cfg, panel = _tiny()
    svc = ScoringService(device="cpu", zoo_capacity=2, max_rows=2,
                         max_wait_ms=0.5)
    try:
        a = svc.register("a", cfg, panel, warm=False)
        svc.register("b", cfg, panel, warm=False)
        month = svc.serveable_months("a")[-1]
        svc.score("a", month)  # "a" is now the most recently leased
        svc.register("c", cfg, panel, warm=False)  # evicts "b"
        assert sorted(svc.zoo.universes()) == ["a", "c"]
        with pytest.raises(KeyError, match="not registered"):
            svc.score("b", month)
        a1 = svc.register("a", cfg, panel, warm=False)
        assert a1.generation == 1 and a.predictor is None  # released
        assert svc.score("a", month).generation == 1
        with pytest.raises(ValueError, match="does not advance"):
            svc.zoo.publish(a)
    finally:
        svc.close()
