"""The port's serving stack against the JAX package's: faults, metrics,
request ids, the flight recorder, the degradation layer, incidents, the
drift gate and refresh.

* ``utils/faults.py``: the same fired call indices at each site over N
  calls, for seeded, scheduled and capped specs, and the same errors on
  garbage.
* ``utils/metrics.py`` and ``serve/monitor.py slo_status``: histogram
  quantiles, the Prometheus text (byte-equal for the same records and
  timestamp), its parse, the drift PSI and the SLO burn rates equal.
* ``clean_request_id`` on hostile inputs and ``http_status`` of every
  serving error equal; the port's ``is_transient`` table.
* The flight ring: bounded, ordered, exact under a threaded hammer.
* The degradation layer on one tiny MLP universe in each package
  (``ScoringService(device="cpu")`` against the JAX service, the params
  of the JAX trainer's ``init_state()``): transient faults retried to
  bitwise-equal scores; retries run out loudly; the circuit breaker's
  instants (open, half-open, closed) in the JAX batcher's order under
  the same schedule; shedding, deadline drops before dispatch and the
  death guard as in the JAX package. Breaker cooldowns and deadlines run
  on an injected clock (the batcher module's ``time``), not on sleeps.
* One incident bundle per trigger within its cooldown; the drift gate
  vetoes a publish; ``LFM_FAULTS``, ``LFM_METRICS=0`` and
  ``LFM_FLIGHT=0`` leave the served scores and the launch counts as
  they were.
* ``refresh``: the served params bitwise unchanged, the new params
  within the trainers' rtol 1e-4 (f32) of the JAX ``refresh`` from the
  same params and splits, and no request dropped or torn across the
  swap.
"""

import json
import os
import sys
import threading
import time
import warnings

import jax
import numpy as np
import pytest

from lfm_quant_tpu.config import (DataConfig, ModelConfig, OptimConfig,
                                  RunConfig)
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.data.windows import clear_panel_cache
from lfm_quant_tpu.serve import ScoringService as JaxService
from lfm_quant_tpu.serve import batcher as jax_batcher
from lfm_quant_tpu.serve import errors as jax_errors
from lfm_quant_tpu.serve import monitor as jax_monitor
from lfm_quant_tpu.train import reuse
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu.utils import faults as jax_faults
from lfm_quant_tpu.utils import flight as jax_flight
from lfm_quant_tpu.utils import metrics as jax_metrics
from lfm_quant_tpu_torch import config as tconfig
from lfm_quant_tpu_torch.data.panel import PanelSplits, synthetic_panel
from lfm_quant_tpu_torch.ops import _build
from lfm_quant_tpu_torch.serve import ScoringService
from lfm_quant_tpu_torch.serve import batcher, errors, incident, monitor
from lfm_quant_tpu_torch.utils import faults, flight, metrics, telemetry
from lfm_quant_tpu_torch.weights import flatten_params

PANEL = dict(n_firms=40, n_months=100, n_features=4, seed=5)
SPLIT = (197401, 197601)


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """No fault schedule, fresh flight rings and metrics registries in
    both packages, in and out."""
    for knob in ("LFM_FAULTS", "LFM_METRICS", "LFM_FLIGHT",
                 "LFM_DRIFT_GATE", "LFM_DRIFT_MAX", "LFM_INCIDENT_DIR",
                 "LFM_SLO_P99_MS", "LFM_SLO_AVAIL", "LFM_ACCESS_LOG"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("LFM_ASYNC", "0")

    def fresh():
        for mod in (faults, jax_faults):
            mod.configure("")
        for mod in (flight, jax_flight):
            mod.configure()
        metrics.METRICS.reset()
        jax_metrics.METRICS.reset()
        telemetry.COUNTERS.reset()
        reuse.clear_program_cache()
        clear_panel_cache()

    fresh()
    yield
    fresh()


class _Clock:
    """The batcher module's ``time`` with an injected ``perf_counter``:
    real time plus an offset the test advances."""

    def __init__(self):
        self.offset = 0.0
        self.sleep = time.sleep
        self.time = time.time
        self.monotonic = time.monotonic

    def perf_counter(self):
        return time.perf_counter() + self.offset


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(batcher, "time", c)
    monkeypatch.setattr(jax_batcher, "time", c)
    return c


def _cfg(epochs=1):
    return RunConfig(
        name="stack_t",
        data=DataConfig(n_firms=PANEL["n_firms"],
                        n_months=PANEL["n_months"],
                        n_features=PANEL["n_features"], window=6,
                        dates_per_batch=4, firms_per_date=16),
        model=ModelConfig(kind="mlp", kwargs={"hidden": (16,)}),
        optim=OptimConfig(lr=3e-3, epochs=epochs, warmup_steps=2,
                          loss="mse"),
        seed=2)


def _jax_trainer():
    panel = jax_synthetic(**PANEL)
    trainer = JaxTrainer(_cfg(), JaxSplits.by_date(panel, *SPLIT))
    trainer.state = trainer.init_state()
    return trainer


def _params(trainer):
    return jax.tree_util.tree_map(np.asarray, trainer.state.params)


def _port(trainer=None, warm=True, **kw):
    """The port's service with the JAX trainer's params (or a seeded
    init) over the same panel."""
    kw.setdefault("max_rows", 2)
    kw.setdefault("max_wait_ms", 0.0)
    svc = ScoringService(device="cpu", **kw)
    tcfg = tconfig.RunConfig.from_json(_cfg().to_json())
    svc.register("u", tcfg, synthetic_panel(**PANEL),
                 None if trainer is None else _params(trainer), warm=warm)
    return svc


def _jax(trainer, **kw):
    kw.setdefault("max_rows", 2)
    kw.setdefault("max_wait_ms", 0.0)
    svc = JaxService(**kw)
    svc.register("u", trainer, warm=False)
    return svc


# ---- utils/faults.py -----------------------------------------------------

SPECS = ("serve_dispatch:n=3",
         "panel_h2d:p=0.3,seed=7",
         "zoo_lease:at=1+4+6,kind=permanent",
         "serve_dispatch:p=0.5,seed=11,n=4;zoo_lease:at=0",
         "ckpt_write:at=2,kind=sigterm;device_get:p=0.2;"
         "zoo_persist:n=1;manifest_write:at=0+1")


@pytest.mark.parametrize("spec", SPECS)
def test_fault_schedules_match_jax(spec):
    got, want = faults.parse_spec(spec), jax_faults.parse_spec(spec)
    assert sorted(got) == sorted(want)
    for site in got:
        a, b = got[site], want[site]
        assert (a.kind, a.prob, a.at, a.limit) == (b.kind, b.prob, b.at,
                                                   b.limit)
        assert [a.fire() for _ in range(64)] == [b.fire() for _ in range(64)]
    # Through check(): the same call indices raise at the serving sites.
    faults.configure(spec)
    jax_faults.configure(spec)
    for mod in (faults, jax_faults):
        assert mod.active()
    for site in ("serve_dispatch", "panel_h2d", "zoo_lease"):
        fired = []
        for mod in (faults, jax_faults):
            idx = []
            for k in range(40):
                try:
                    mod.check(site)
                except mod.FaultError as e:
                    idx.append((k, type(e).__name__, e.transient))
            fired.append(idx)
        assert fired[0] == fired[1], site


@pytest.mark.parametrize("spec", [
    "nope:p=1", "ckpt_write:kind=weird", "ckpt_write:frequency=2",
    "ckpt_write:at=0;ckpt_write:at=1", "serve_dispatch:p=2",
    "serve_dispatch:n", "serve_dispatch:at=x"])
def test_fault_garbage_specs_match_jax(spec):
    with pytest.raises(ValueError) as got:
        faults.parse_spec(spec)
    with pytest.raises(ValueError) as want:
        jax_faults.parse_spec(spec)
    assert str(got.value) == str(want.value)


# ---- utils/metrics.py / serve/monitor.py --------------------------------


def _record(mod, reg, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    lat = np.exp(rng.normal(2.0, 1.0, 500))
    for i, v in enumerate(lat):
        reg.histogram("serve_latency_ms", universe="u",
                      width=16 * (1 + i % 2)).record(float(v),
                                                     exemplar=f"r{i}")
    reg.mark("serve_ok", 480.0, now=1000.0)
    reg.mark("serve_err", 20.0, now=1000.0)
    reg.gauge("circuit_state", 0.0)
    reg.gauge("zoo_param_bytes", 1234.0, universe="u")
    return lat


def test_metrics_text_quantiles_and_parse_match_jax():
    got, want = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    lat = _record(metrics, got)
    _record(jax_metrics, want)
    counters = {"serve_requests": 500, "serve_retries": 3,
                "compile_s": 0.25}
    text = metrics.render_prometheus(got, counters=counters, ts=1.5e9)
    assert text == jax_metrics.render_prometheus(want, counters=counters,
                                                 ts=1.5e9)
    assert metrics.parse_prometheus(text) == \
        jax_metrics.parse_prometheus(text)
    h, jh = got.merged_histogram("serve_latency_ms"), \
        want.merged_histogram("serve_latency_ms")
    for q in (50.0, 90.0, 99.0, 99.9):
        assert h.quantile(q) == jh.quantile(q)
        # Within one bucket's relative resolution of the exact value.
        exact = float(np.percentile(lat, q))
        assert abs(h.quantile(q) - exact) <= h.rel_resolution * exact

    def untimed(snap):
        return {k: [{f: v for f, v in e.items() if f != "ts"} for e in es]
                for k, es in snap.items()}

    assert untimed(got.exemplar_snapshot("serve_latency_ms")) == \
        untimed(want.exemplar_snapshot("serve_latency_ms"))


def test_score_sketch_psi_matches_jax():
    rng = np.random.default_rng(3)
    ref = rng.normal(0.0, 1.0, 4000)
    for shift in (0.0, 0.5):
        live = rng.normal(shift, 1.0, 2000)
        a = metrics.ScoreSketch.reference(ref)
        b = jax_metrics.ScoreSketch.reference(ref)
        la, lb = a.live_twin(), b.live_twin()
        for chunk in np.array_split(live, 7):
            la.record_lazy(chunk.astype(np.float32))
            lb.record_lazy(chunk.astype(np.float32))
        assert a.psi(la) == b.psi(lb)
        assert (a.psi(la) > 0.1) == (shift > 0)


def test_slo_burn_rates_match_jax(monkeypatch):
    monkeypatch.setenv("LFM_SLO_P99_MS", "100")
    monkeypatch.setenv("LFM_SLO_AVAIL", "0.999")
    now = 10_000.0
    for reg in (metrics.METRICS, jax_metrics.METRICS):
        reg.mark("serve_ok", 1000.0, now=now - 200.0)
        reg.mark("serve_err", 5.0, now=now - 200.0)
        reg.mark("serve_ok", 1000.0, now=now)
        reg.mark("serve_err", 0.5, now=now)
        reg.mark("serve_slo_lat_bad", 50.0, now=now)
    got = monitor.slo_status(now=now)
    assert got == jax_monitor.slo_status(now=now)
    assert got["objectives"]["latency_p99"]["burning"]
    assert not got["objectives"]["availability"]["burning"]


# ---- request ids and the error taxonomy ---------------------------------

HOSTILE = [None, "", "   ", "abc-DEF_1.2", "x" * 5000,
           "evil\r\nSet-Cookie: a=b", "ünïcödé-id", "../../etc/passwd",
           "<script>alert(1)</script>", "a b\tc", "0" * 64 + "tail",
           "-_." * 40, "\x00\x01id", "traceparent=00-abc"]


@pytest.mark.parametrize("rid", HOSTILE)
def test_clean_request_id_matches_jax(rid):
    assert batcher.clean_request_id(rid) == \
        jax_batcher.clean_request_id(rid)


def _errors(mod):
    return [mod.ServeError("x"), mod.ShedError(8),
            mod.DeadlineError("u", 197501, 0.25),
            mod.CircuitOpenError(1.5), mod.BatcherDeadError(ValueError("b")),
            mod.MemberUnavailableError("u", 2),
            mod.SnapshotIntegrityError("bad"),
            mod.DriftVetoError("u", 0.4, 0.25), KeyError("k"),
            RuntimeError("r")]


def test_http_status_and_transience_match_jax():
    import torch

    for got, want in zip(_errors(errors), _errors(jax_errors)):
        assert type(got).__name__ == type(want).__name__
        assert errors.http_status(got) == jax_errors.http_status(want)
        assert getattr(got, "retry_after_s", None) == \
            getattr(want, "retry_after_s", None)
        assert str(got) == str(want)
    assert errors.http_status(errors.ServiceClosedError("c")) == 503
    # The port's transience table (serve/errors.py docstring).
    assert errors.is_transient(faults.TransientFault("serve_dispatch", 0))
    assert not errors.is_transient(faults.PermanentFault("serve_dispatch",
                                                         0))
    assert errors.is_transient(torch.cuda.OutOfMemoryError("oom"))
    assert not errors.is_transient(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    assert not errors.is_transient(RuntimeError(
        "CUDA error: unspecified launch failure"))
    assert not errors.is_transient(KeyError("u"))


# ---- the flight recorder ------------------------------------------------


def test_flight_ring_bounded_ordered_and_exact_under_hammer(tmp_path):
    rec = flight.FlightRecorder(64)
    threads, per = 8, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(per):
                rec.record("dispatch", thread=k, i=i, ms=float("nan"))

        ts = [threading.Thread(target=work, args=(k,))
              for k in range(threads)]
        for t in ts:
            t.start()
        # A dump mid-hammer parses line for line.
        rec.dump(str(tmp_path / "mid.jsonl"))
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    st = rec.stats()
    assert st == {"capacity": 64, "events": 64,
                  "total_seen": threads * per,
                  "dropped": threads * per - 64}
    seqs = [e["seq"] for e in rec.snapshot()]
    assert seqs == list(range(threads * per - 63, threads * per + 1))
    for name in ("mid.jsonl", "end.jsonl"):
        if name == "end.jsonl":
            assert rec.dump(str(tmp_path / name)) == 64
        lines = open(tmp_path / name).read().splitlines()
        evs = [json.loads(x) for x in lines]
        assert all(e["kind"] == "dispatch" and e["ms"] is None for e in evs)
        assert [e["seq"] for e in evs] == sorted(e["seq"] for e in evs)
    # Instants land in the ring with no telemetry run attached.
    flight.configure(16)
    telemetry.instant("circuit_open", cat="serve", streak=2)
    assert [e["kind"] for e in flight.snapshot()] == ["circuit_open"]


# ---- the degradation layer ---------------------------------------------


def test_transient_faults_retry_to_bitwise_equal_scores():
    svc = _port()
    try:
        months = svc.serveable_months("u")[:6]
        ref = {m: svc.score("u", m).scores for m in months}
        faults.configure("serve_dispatch:n=2;zoo_lease:at=3")
        for m in months:
            r = svc.score("u", m)
            np.testing.assert_array_equal(r.scores, ref[m])
            # The phases add up to the latency (each rounded to 1 us).
            total = sum(r.phases[k] for k in ("queue_ms", "batch_ms",
                                              "retry_ms", "dispatch_ms"))
            assert abs(total - r.latency_ms) <= 0.01, r.phases
        st = svc.stats()
        assert st["retries"] == 3 and st["circuit"] == "closed"
        assert telemetry.COUNTERS.get("fault_serve_dispatch") >= 2
        assert svc.health()["ok"]
        # The panel's H2D site fires where a Predictor is built.
        faults.configure("panel_h2d:at=0")
        tcfg = tconfig.RunConfig.from_json(_cfg().to_json())
        with pytest.raises(faults.TransientFault):
            svc.register("u", tcfg, synthetic_panel(**PANEL))
        assert svc.register("u", tcfg, synthetic_panel(**PANEL)
                            ).generation == 1
    finally:
        svc.close()


def _circuit_kinds(mod):
    return [e["kind"] for e in mod.snapshot()
            if e["kind"].startswith("circuit_") or e["kind"] in
            ("retry", "dispatch_fail", "fault_injected")]


def test_retries_and_breaker_follow_jax(clock):
    """Under the same schedule both batchers retry, run out loudly, open
    the circuit, fast-fail, probe half-open after the cooldown and
    close, with the same flight-recorder sequence."""
    trainer = _jax_trainer()
    kw = dict(retries=1, breaker_threshold=2, breaker_cooldown_ms=5000.0)
    outcomes = []
    for make, fmod, frec in ((lambda: _port(trainer, **kw), faults, flight),
                             (lambda: _jax(trainer, **kw), jax_faults,
                              jax_flight)):
        svc = make()
        seen = []
        try:
            m = svc.serveable_months("u")[4]
            svc.score("u", m)
            frec.configure()
            fmod.configure("serve_dispatch:kind=transient,n=10")
            with pytest.raises(fmod.TransientFault):
                svc.score("u", m, timeout=30)  # 2 attempts, then loud
            fmod.configure("serve_dispatch:kind=permanent")
            with pytest.raises(fmod.PermanentFault):
                svc.score("u", m, timeout=30)  # streak 2: opens
            h = svc.health()
            seen.append((h["ok"], h["circuit"], h["retry_after_s"] > 0))
            with pytest.raises(Exception) as ei:
                svc.score("u", m, timeout=30)
            seen.append((type(ei.value).__name__,
                         getattr(ei.value, "http_status", None)))
            clock.offset += 6.0  # the cooldown elapses, backend healed
            fmod.configure("")
            r = svc.score("u", m)
            h = svc.health()
            seen.append((h["ok"], h["circuit"], r.generation))
            st = svc.batcher.stats()
            seen.append((st["retries"], st["breaker_opens"],
                         st["dispatch_errors"], st["completed"]))
            seen.append(_circuit_kinds(frec))
        finally:
            clock.offset = 0.0
            svc.close()
        outcomes.append(seen)
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] == ("CircuitOpenError", 503)
    assert outcomes[0][-1][-2:] == ["circuit_half_open", "circuit_closed"]


def _blocked(svc):
    """Hold the batcher inside its next dispatch until released."""
    entered, release = threading.Event(), threading.Event()
    lease = svc.zoo.lease

    def slow(universe):
        entered.set()
        release.wait(30)
        return lease(universe)

    svc.zoo.lease = slow
    return entered, release


def _kill(svc):
    """Make the batcher loop die outside its per-batch failure path."""
    svc.batcher._next_batch = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        try:
            # Served by the call in progress, or failed fast when the
            # loop was between calls.
            svc.score("u", svc.serveable_months("u")[0], timeout=30)
        except (errors.BatcherDeadError, jax_errors.BatcherDeadError):
            pass
        svc.batcher._thread.join(timeout=10)
    assert not svc.batcher._thread.is_alive()


UNHANDLED = "ignore::pytest.PytestUnhandledThreadExceptionWarning"


@pytest.mark.filterwarnings(UNHANDLED)
def test_shedding_deadlines_and_death_follow_jax(clock):
    trainer = _jax_trainer()
    outcomes = []
    for make, errs in ((lambda: _port(trainer, queue_max=4, retries=0,
                                      breaker_threshold=0), errors),
                       (lambda: _jax(trainer, queue_max=4, retries=0,
                                     breaker_threshold=0), jax_errors)):
        svc = make()
        seen = []
        try:
            months = svc.serveable_months("u")
            svc.score("u", months[0])
            svc.batcher.reset_stats()
            entered, release = _blocked(svc)
            first = svc.submit("u", months[1])
            assert entered.wait(30)
            late = svc.submit("u", months[2], deadline_ms=1000.0)
            queued = [svc.submit("u", months[3 + k]) for k in range(3)]
            shed = [svc.submit("u", months[k]) for k in range(3)]
            for f in shed:
                with pytest.raises(errs.ShedError) as ei:
                    f.result(timeout=5)
                assert ei.value.http_status == 429
            clock.offset += 2.0  # the late request's deadline passes
            release.set()
            with pytest.raises(errs.DeadlineError) as ei:
                late.result(timeout=30)
            seen.append(ei.value.http_status)
            for f in [first] + queued:
                assert f.result(timeout=30).scores.size > 0
            st = svc.batcher.stats()
            seen.append((st["shed"], st["deadline_drops"], st["completed"],
                         st["batches"], st["queue_peak"]))
            # The death guard: the loop dies outside the per-batch path
            # (the call in progress serves one more request first).
            _kill(svc)
            f = svc.submit("u", months[0])
            with pytest.raises(errs.BatcherDeadError):
                f.result(timeout=5)
            h = svc.health()
            seen.append((h["ok"], h["circuit"],
                         svc.batcher.circuit_state_code()))
        finally:
            clock.offset = 0.0
            svc.close()
        outcomes.append(seen)
    assert outcomes[0] == outcomes[1]
    shed, drops, completed, _, peak = outcomes[0][1]
    assert (shed, drops, completed, peak) == (3, 1, 4, 4)


@pytest.mark.filterwarnings(UNHANDLED)
def test_restart_batcher_recovers_the_dead_path():
    svc = _port()
    try:
        m = svc.serveable_months("u")[2]
        svc.score("u", m)
        _kill(svc)
        assert not svc.health()["ok"]
        done = svc.stats()["completed"]
        out = svc.restart_batcher()
        assert out["ok"] and out["was_dead"]
        assert svc.score("u", m).scores.size > 0
        assert svc.health()["ok"] and svc.stats()["completed"] == done + 1
    finally:
        svc.close()


def test_one_incident_bundle_per_trigger_within_cooldown(tmp_path, clock):
    svc = _port(retries=0, breaker_threshold=1, breaker_cooldown_ms=10.0,
                incident_dir=str(tmp_path), incident_cooldown_s=300.0)
    try:
        m = svc.serveable_months("u")[3]
        for _ in range(3):
            svc.score("u", m)
        faults.configure("serve_dispatch:kind=permanent")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for _ in range(3):
                with pytest.raises(faults.PermanentFault):
                    svc.score("u", m, timeout=30)  # opens; probe reopens
                svc.incidents.wait()
                clock.offset += 0.02
        faults.configure("")
        assert svc.batcher.stats()["breaker_opens"] == 3
        bundles = incident.find_bundles(str(tmp_path))
        assert len(bundles) == 1
        assert svc.incidents.captured == 1 and svc.incidents.suppressed == 2
        meta = json.load(open(os.path.join(bundles[0], "incident.json")))
        assert meta["trigger"] == "breaker_open"
        assert meta["host"]["torch"] and meta["host"]["backend"] == "cpu"
        assert "jax" not in meta["host"]
        for name in ("flight.jsonl", "metrics.prom", "snapshot.json",
                     "slow_requests.json", "exemplars.json"):
            assert meta["files"][name] not in (None, "") and \
                not meta["files"][name].startswith("failed"), name
        slow = json.load(open(os.path.join(bundles[0],
                                           "slow_requests.json")))
        assert slow and all("dispatch_ms" in t for t in slow)
    finally:
        clock.offset = 0.0
        svc.close()


def test_drift_gate_vetoes_publish(monkeypatch):
    monkeypatch.setenv("LFM_DRIFT_GATE", "1")
    svc = _port()
    try:
        entry = svc.zoo.current("u")
        assert entry.ref_sketch is not None
        m = svc.serveable_months("u")[5]
        base = svc.score("u", m).scores
        entry.live_sketch.record(np.tile(base + 5.0, 8))
        assert svc.monitor.drift_status()["breached"] == ["u"]
        tcfg = tconfig.RunConfig.from_json(_cfg().to_json())
        with pytest.raises(errors.DriftVetoError) as ei:
            svc.register("u", tcfg, entry.panel)
        assert ei.value.http_status == 409
        with pytest.raises(errors.DriftVetoError):
            svc.refresh("u", PanelSplits.by_date(entry.panel, *SPLIT))
        assert svc.zoo.current("u") is entry
        assert svc.score("u", m).generation == 0
        assert svc.health()["drift"]["breached"] == ["u"]
        monkeypatch.setenv("LFM_DRIFT_GATE", "0")
        assert svc.register("u", tcfg, entry.panel).generation == 1
    finally:
        svc.close()


def _served(svc, months):
    return {m: svc.score("u", m).scores for m in months}


@pytest.mark.parametrize("knob,value", [("LFM_FAULTS", "ckpt_write:at=0"),
                                        ("LFM_METRICS", "0"),
                                        ("LFM_FLIGHT", "0")])
def test_knobs_off_are_exact_noops(monkeypatch, knob, value):
    svc = _port(warm=False)
    try:
        months = svc.serveable_months("u")[::9]
        _build.reset_launch_counts()
        want = _served(svc, months)
        want_launches = _build.launch_counts()
        monkeypatch.setenv(knob, value)
        faults.configure()
        flight.configure()
        metrics.METRICS.reset()
        _build.reset_launch_counts()
        got = _served(svc, months)
        assert _build.launch_counts() == want_launches
        for m in months:
            np.testing.assert_array_equal(got[m], want[m])
        if knob == "LFM_METRICS":
            assert metrics.METRICS.snapshot() == \
                metrics.MetricsRegistry().snapshot()
        if knob == "LFM_FLIGHT":
            assert flight.recorder() is None and flight.snapshot() == []
        if knob == "LFM_FAULTS":
            assert faults.active()
    finally:
        svc.close()


# ---- refresh ------------------------------------------------------------


def test_refresh_matches_jax_and_drops_nothing():
    trainer = _jax_trainer()
    jsvc = _jax(trainer)
    svc = _port(trainer)
    try:
        served = svc.zoo.current("u").predictor
        before = {k: p.detach().clone()
                  for k, p in served.model.named_parameters()}
        months = svc.serveable_months("u")
        got, lock, stop = [], threading.Lock(), threading.Event()

        def client(k):
            i = k
            while not stop.is_set() or i < k + 8:
                m = months[i % len(months)]
                r = svc.score("u", m, timeout=60)
                with lock:
                    got.append(r)
                i += 3

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while len(got) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)  # generation 0 serves before the swap
        splits = PanelSplits.by_date(svc.zoo.current("u").panel, *SPLIT)
        entry = svc.refresh("u", splits, epochs=1)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        want = jsvc.refresh("u", JaxSplits.by_date(
            trainer.splits.panel, *SPLIT), epochs=1)
        assert entry.generation == want.generation == 1
        # The served generation's params are untouched by the fit.
        for k, p in served.model.named_parameters():
            assert torch_equal(p, before[k]), k
        new = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                    want.params))
        for k, p in entry.predictor.state.params.items():
            np.testing.assert_allclose(p.detach().numpy(), new[k],
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        # Nothing dropped or torn: every response is one generation's.
        gens = {r.generation for r in got}
        assert gens <= {0, 1} and 0 in gens and len(got) >= 9
        for r in got:
            pred = served if r.generation == 0 else entry.predictor
            t = svc.zoo.current("u").month_col(r.month)
            want_scores = pred.score(r.firm_idx[None, :],
                                     np.asarray([t], np.int32),
                                     np.ones((1, r.firm_idx.size),
                                             np.float32))[0]
            np.testing.assert_allclose(r.scores, want_scores, atol=1e-6)
        assert svc.score("u", months[0]).generation == 1
        assert svc.stats()["dispatch_errors"] == 0
    finally:
        svc.close()
        jsvc.close()


def torch_equal(a, b):
    import torch

    return torch.equal(a.detach(), b)
