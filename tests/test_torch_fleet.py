"""The port's fleet (``serve/fleet.py``) against the JAX package's, and
its own failover pins.

* Parity with ``lfm_quant_tpu/serve/fleet.py``: ``_hrw`` and
  ``FleetCoordinator.route`` give the same member order for the same
  names (any registration order, replica count and month);
  ``relabel_scrape`` the same text; ``member_retryable`` the same
  classification.
* The one-member fleet is the single process, bitwise, and a fleet with
  every member gone answers 503 + Retry-After.
* Failover: an open-circuit member is rerouted around and readmitted
  only through a half-open probe; a dead batcher costs one failed call
  and a reroute, never a client error.
* The join gate: a store-bootstrapped member syncs to the fence and is
  admitted; unverified, behind-the-fence and imposter members are
  refused and never routed to; a publish reaches every member through
  ``sync_members``.
* The HTTP front door's ``/fleet`` and ``/sync`` routes; the fleet's
  ``/metrics`` and ``/healthz`` over remote members.
* One real SIGKILL of a subprocess member under traffic: every response
  bitwise equal to the pre-kill scores, and a replacement joins from the
  store at 0 kernel builds.
* ``LFM_FLEET`` unset: nothing of the fleet runs (scores, counters and
  dispatches as without the module); ``scripts/trace_report.py``'s fleet
  section renders the port's trace.
"""

import json
import os
import signal
import time
import urllib.request

import jax
import numpy as np
import pytest

from lfm_quant_tpu.config import (DataConfig, ModelConfig, OptimConfig,
                                  RunConfig)
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.serve import FleetCoordinator as JaxCoordinator
from lfm_quant_tpu.serve import fleet as jax_fleet
from lfm_quant_tpu.serve.stats import load_trace_report
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu_torch import config as tconfig
from lfm_quant_tpu_torch.data.panel import synthetic_panel
from lfm_quant_tpu_torch.ops import _build
from lfm_quant_tpu_torch.serve import (
    FleetCoordinator,
    FleetRouter,
    HttpMember,
    LocalMember,
    MemberJoinRefused,
    ScoringService,
    ZooStore,
)
from lfm_quant_tpu_torch.serve import errors as serrors
from lfm_quant_tpu_torch.serve import fleet
from lfm_quant_tpu_torch.serve.http import make_http_server
from lfm_quant_tpu_torch.utils import faults, metrics, telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PANEL = dict(n_firms=40, n_months=100, n_features=4, seed=5)
FLEET_KNOBS = ("LFM_FLEET", "LFM_FLEET_REPLICAS", "LFM_FLEET_RETRIES",
               "LFM_FLEET_BREAKER", "LFM_FLEET_COOLDOWN_MS",
               "LFM_FLEET_HEALTH_TTL_MS", "LFM_FLEET_TIMEOUT_MS",
               "LFM_ZOO_PERSIST", "LFM_FAULTS")


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    for k in FLEET_KNOBS:
        monkeypatch.delenv(k, raising=False)
    faults.configure("")
    telemetry.COUNTERS.reset()
    yield
    faults.configure("")
    telemetry.COUNTERS.set("serve_batcher_dead", 0)


def _cfg(seed=0):
    return RunConfig(
        name="fleet_t",
        data=DataConfig(n_firms=PANEL["n_firms"], n_months=PANEL["n_months"],
                        n_features=PANEL["n_features"], window=6,
                        dates_per_batch=2, firms_per_date=8),
        model=ModelConfig(kind="lstm", kwargs={"hidden": 8}),
        optim=OptimConfig(lr=3e-3, epochs=1, warmup_steps=2, loss="mse"),
        seed=seed)


_PARAMS = {}


def _params(seed=0):
    if seed not in _PARAMS:
        tr = JaxTrainer(_cfg(seed), JaxSplits.by_date(
            jax_synthetic(**PANEL), 197401, 197601))
        _PARAMS[seed] = jax.tree_util.tree_map(np.asarray,
                                               tr.init_state().params)
    return _PARAMS[seed]


def _service(store_dir=None, seed=0, register=True, **kw):
    kw.setdefault("max_rows", 2)
    kw.setdefault("max_wait_ms", 0.0)
    svc = ScoringService(device="cpu", persist_dir=store_dir, **kw)
    if register:
        svc.register("us", tconfig.RunConfig.from_json(_cfg(seed).to_json()),
                     synthetic_panel(**PANEL), _params(seed))
    return svc


class _FakeMember:
    """Registry-only member for routing tests."""

    remote = False

    def __init__(self, name, universes):
        self.name = name
        self._universes = dict(universes)

    def join_report(self):
        return {"member": self.name, "universes": dict(self._universes)}

    def universes(self):
        return dict(self._universes)

    def close(self):
        pass


# ---- parity with the JAX package ----------------------------------------

NAMES = ["alpha", "beta", "gamma", "delta", "m0", "m1", "m2"]


@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_routing_matches_jax(replicas):
    unis = {"ua": 0, "c2_lstm_single": 3, "c3_gru_rankic": 1}

    def build(mod_coord, member_cls, order):
        coord = mod_coord(replicas=replicas)
        for n in order:
            coord.add_member(member_cls(n, unis), verify=False)
        return coord

    port = build(FleetCoordinator, _FakeMember, NAMES)
    port_rev = build(FleetCoordinator, _FakeMember, NAMES[::-1])
    ref = build(JaxCoordinator, _FakeMember, NAMES)
    for u in unis:
        assert fleet._hrw(u, "m1") == jax_fleet._hrw(u, "m1")
        assert port.route(u) == ref.route(u) == port_rev.route(u)
        for month in (197001, 199002, 199007, 200012):
            assert port.route(u, month) == ref.route(u, month)
    port.set_replicas("ua", replicas + 1)
    ref.set_replicas("ua", replicas + 1)
    assert port.route("ua", 199001) == ref.route("ua", 199001)
    with pytest.raises(KeyError, match="not served"):
        port.route("nope")


def test_relabel_scrape_matches_jax():
    svc = _service()
    try:
        svc.score("us", svc.serveable_months("us")[5])
        texts = [svc.metrics_text(),
                 '# HELP x y\n# TYPE lfm_a counter\nlfm_a_total 3\n'
                 'lfm_b{universe="us",width="64"} 2.5\nlfm_c{} 1\n']
    finally:
        svc.close()
    for text in texts:
        assert fleet.relabel_scrape(text, "m7") == \
            jax_fleet.relabel_scrape(text, "m7")
    prom = metrics.parse_prometheus(fleet.relabel_scrape(texts[1], "m7"))
    assert prom["lfm_b"] == [({"member": "m7", "universe": "us",
                               "width": "64"}, 2.5)]


def test_member_retryable_matches_jax():
    cases = [KeyError("u"), ValueError("v"), TypeError("t"),
             serrors.DeadlineError("u", 199001, 0.1), serrors.ShedError(4),
             serrors.CircuitOpenError(0.2),
             serrors.BatcherDeadError(RuntimeError("x")),
             faults.TransientFault("serve_dispatch", 0),
             faults.PermanentFault("serve_dispatch", 0),
             fleet.MemberCallError("m0", "connection refused"),
             RuntimeError("undiagnosed")]
    from lfm_quant_tpu.serve import errors as jax_errors
    from lfm_quant_tpu.utils import faults as jax_faults

    twins = cases[:3] + [
        jax_errors.DeadlineError("u", 199001, 0.1), jax_errors.ShedError(4),
        jax_errors.CircuitOpenError(0.2),
        jax_errors.BatcherDeadError(RuntimeError("x")),
        jax_faults.TransientFault("serve_dispatch", 0),
        jax_faults.PermanentFault("serve_dispatch", 0),
        jax_fleet.MemberCallError("m0", "connection refused"),
        RuntimeError("undiagnosed")]
    got = [fleet.member_retryable(e) for e in cases]
    assert got == [jax_fleet.member_retryable(e) for e in twins]
    assert got == [False, False, False, False, True, True, True, True, True,
                   True, True]
    assert fleet.MemberCallError("m0", "x").transient
    assert serrors.is_transient(fleet.MemberCallError("m0", "x"))
    e = serrors.MemberUnavailableError("us", tried=2, retry_after_s=0.5)
    assert serrors.http_status(e) == 503 and e.retry_after_s == 0.5


# ---- knobs / non-interference -------------------------------------------


def test_fleet_knobs_and_unset_is_an_exact_noop(monkeypatch):
    assert fleet.fleet_members_default() == 0 and not fleet.fleet_enabled()
    monkeypatch.setenv("LFM_FLEET", "3")
    assert fleet.fleet_members_default() == 3 and fleet.fleet_enabled()
    monkeypatch.setenv("LFM_FLEET", "x")
    with pytest.raises(ValueError, match="LFM_FLEET"):
        fleet.fleet_members_default()
    monkeypatch.delenv("LFM_FLEET")
    for knob, fn, want in (("LFM_FLEET_REPLICAS", fleet.replicas_default, 2),
                           ("LFM_FLEET_RETRIES", fleet.retries_default, 2),
                           ("LFM_FLEET_BREAKER", fleet.breaker_default, 2),
                           ("LFM_FLEET_COOLDOWN_MS",
                            fleet.cooldown_ms_default, 1000.0)):
        assert fn() == want
        monkeypatch.setenv(knob, "5")
        assert fn() == 5
        monkeypatch.delenv(knob)
    # The fleet module imported and unset: serving as without it.
    telemetry.COUNTERS.reset()
    _build.reset_launch_counts()
    svc = _service()
    try:
        months = svc.serveable_months("us")[:4]
        scores = [svc.score("us", m).scores for m in months]
        counters = telemetry.COUNTERS.snapshot()
        assert not any(k.startswith("fleet_") for k in counters)
        assert svc.store is None
        assert _build.launch_counts() == dict.fromkeys(_build.LAUNCHES, 0)
    finally:
        svc.close()
    assert len(scores) == 4


# ---- the one-member fleet -------------------------------------------------


def test_one_member_fleet_is_the_single_process():
    svc = _service()
    try:
        months = svc.serveable_months("us")[:4]
        refs = {m: svc.score("us", m).scores.copy() for m in months}
        coord = FleetCoordinator.local(svc)
        router = FleetRouter(coord, retries=1, cooldown_ms=100)
        assert router.universes() == ["us"]
        assert router.serveable_months("us") == svc.serveable_months("us")
        for m in months:
            r = router.score("us", m)
            np.testing.assert_array_equal(r.scores, refs[m])
            assert r.generation == 0
        assert router.health()["ok"] and router.stats()["completed"] == 4
        with pytest.raises(KeyError):
            router.score("us", 999999)
        assert coord.slot("m0").state == "in"  # a data error is an answer
        agg = metrics.parse_prometheus(router.metrics_text())
        assert any(v >= 4 for _, v in agg["lfm_fleet_requests_total"])
    finally:
        svc.close()
    with pytest.raises(serrors.MemberUnavailableError) as ei:
        router.score("us", months[0])
    assert serrors.http_status(ei.value) == 503
    assert ei.value.retry_after_s > 0


# ---- failover -----------------------------------------------------------


def _pair(**kw):
    svc_a, svc_b = _service(**kw), _service(**kw)
    coord = FleetCoordinator(replicas=2)
    coord.add_member(LocalMember("m0", svc_a), verify=False)
    coord.add_member(LocalMember("m1", svc_b), verify=False)
    return svc_a, svc_b, coord


def test_open_breaker_reroute_and_half_open_readmission():
    svc_a, svc_b, coord = _pair(breaker_cooldown_ms=100.0)
    try:
        months = svc_a.serveable_months("us")[:4]
        refs = {m: svc_a.score("us", m).scores.copy() for m in months}
        for m in months:  # the same params: the reroute's premise
            np.testing.assert_array_equal(svc_b.score("us", m).scores,
                                          refs[m])
        router = FleetRouter(coord, breaker=1, cooldown_ms=150,
                             health_ttl_ms=0, retries=2)
        primary = coord.route("us")[0]
        victim = {"m0": svc_a, "m1": svc_b}[primary]
        for _ in range(4):  # trip the member's own circuit breaker
            victim.batcher._dispatch_fail()
        assert not victim.health()["ok"]
        for m in months:
            np.testing.assert_array_equal(router.score("us", m).scores,
                                          refs[m])
        assert coord.slot(primary).state == "out"
        deadline = time.perf_counter() + 10.0
        while (coord.slot(primary).state != "in"
               and time.perf_counter() < deadline):
            time.sleep(0.03)
            np.testing.assert_array_equal(
                router.score("us", months[0]).scores, refs[months[0]])
        assert coord.slot(primary).state == "in"
        c = telemetry.COUNTERS.snapshot()
        assert c.get("fleet_member_out", 0) >= 1
        assert c.get("fleet_probes", 0) >= 1
        assert c.get("fleet_readmissions", 0) >= 1
        assert c.get("fleet_unroutable", 0) == 0
        assert victim.health()["ok"]
    finally:
        svc_a.close()
        svc_b.close()


def test_dead_member_is_a_reroute_not_an_error():
    svc_a, svc_b, coord = _pair()
    try:
        m = svc_a.serveable_months("us")[5]
        ref = svc_a.score("us", m).scores.copy()
        router = FleetRouter(coord, breaker=1, cooldown_ms=60_000,
                             health_ttl_ms=60_000, retries=2)
        primary = coord.route("us", m)[0]
        victim = {"m0": svc_a, "m1": svc_b}[primary]
        np.testing.assert_array_equal(router.score("us", m).scores, ref)
        boom = RuntimeError("boom in _next_batch")
        victim.batcher._next_batch = lambda: (_ for _ in ()).throw(boom)
        try:
            victim.score("us", m)
        except serrors.BatcherDeadError:
            pass
        deadline = time.perf_counter() + 5.0
        while victim.batcher._dead is None and \
                time.perf_counter() < deadline:
            time.sleep(0.001)
        np.testing.assert_array_equal(router.score("us", m).scores, ref)
        assert coord.slot(primary).state == "out"
        assert router.stats()["failovers"] >= 1
    finally:
        svc_a.close()
        svc_b.close()


# ---- the join gate and the fence --------------------------------------------


def test_store_bootstrap_join_syncs_to_the_fence(tmp_path):
    store_dir = str(tmp_path / "store")
    svc = _service(store_dir)
    months = svc.serveable_months("us")[:3]
    refs = {m: svc.score("us", m).scores.copy() for m in months}
    svc.close()
    # A fresh read-only member with an EMPTY zoo: behind the fence, the
    # gate's one sync pulls generation 0, verified like a restore.
    svc2 = _service(store_dir, persist_readonly=True, register=False)
    try:
        coord = FleetCoordinator(store=ZooStore(store_dir, readonly=True))
        coord.add_member(LocalMember("m0", svc2))
        assert coord.slot("m0").universes == {"us": 0}
        assert coord.fence() == {"us": 0}
        assert svc2.last_restore_compiles == 0
        assert svc2.last_restore_panel_h2d == 1
        router = FleetRouter(coord)
        for m in months:
            np.testing.assert_array_equal(router.score("us", m).scores,
                                          refs[m])
        assert telemetry.COUNTERS.get("fleet_joins") == 1
        # A read-only attach never publishes.
        with pytest.raises(RuntimeError, match="READ-ONLY"):
            svc2.store.record_publish(svc2.zoo.current("us"), 2)
    finally:
        svc2.close()


class _Unverified(_FakeMember):
    def join_report(self):
        return {"member": self.name, "universes": {"us": 0},
                "restore": [{"universe": "us", "generation": 0,
                             "probe": "quarantined"}]}


class _Behind(_FakeMember):
    def join_report(self):
        return {"member": self.name, "universes": {}}

    def sync(self):
        raise RuntimeError("store unreachable")


@pytest.mark.parametrize("case", ["unverified", "behind_fence", "imposter"])
def test_join_gate_refuses(tmp_path, case):
    store_dir = str(tmp_path / "store")
    _service(store_dir).close()
    coord = FleetCoordinator(store=ZooStore(store_dir, readonly=True))
    imposter = None
    if case == "unverified":
        member, match = _Unverified("bad", {"us": 0}), "probe != bit_equal"
    elif case == "behind_fence":
        member, match = _Behind("stale", {}), "sync failed"
    else:  # its own generation 0 (other params), never restored
        imposter = _service(seed=9)
        member, match = LocalMember("imposter", imposter), \
            "parity probe mismatch"
    try:
        with pytest.raises(MemberJoinRefused, match=match):
            coord.add_member(member)
        assert coord.members() == []  # never routed to
        assert telemetry.COUNTERS.get("fleet_refusals") == 1
    finally:
        if imposter is not None:
            imposter.close()


def test_publish_fence_propagates_fleet_wide(tmp_path):
    store_dir = str(tmp_path / "store")
    svc_w = _service(store_dir)
    svc_r = _service(store_dir, persist_readonly=True, register=False)
    try:
        svc_r.restore()
        coord = FleetCoordinator(store=svc_w.store, replicas=2)
        coord.add_member(LocalMember("w", svc_w))
        coord.add_member(LocalMember("r", svc_r))
        svc_w.register("us", tconfig.RunConfig.from_json(
            _cfg(9).to_json()), synthetic_panel(**PANEL), _params(9))
        m = svc_w.serveable_months("us")[5]
        ref1 = svc_w.score("us", m)
        assert ref1.generation == 1 and coord.fence() == {"us": 1}
        assert svc_r.zoo.current("us").generation == 0
        out = coord.sync_members()
        assert out["members"]["w"]["up_to_date"]
        assert out["members"]["r"] == {"synced": 1, "up_to_date": True}
        r = svc_r.score("us", m)
        assert r.generation == 1
        np.testing.assert_array_equal(r.scores, ref1.scores)
        assert coord.sync_members()["members"]["r"]["synced"] == 0
    finally:
        svc_w.close()
        svc_r.close()


# ---- the HTTP front door ------------------------------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_fleet_and_sync_routes(tmp_path):
    import threading

    store_dir = str(tmp_path / "store")
    for svc, want_sync in ((_service(), 404), (_service(store_dir), 200)):
        httpd = make_http_server(svc, 0)
        port = httpd.server_address[1]
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            status, body = _get(port, "/fleet")
            rep = json.loads(body)
            assert status == 200 and rep["universes"] == {"us": 0}
            assert rep["months"]["us"] == svc.serveable_months("us")
            assert rep["build"]["pid"] == os.getpid()
            status, body = _get(port, "/sync")
            assert status == want_sync, body
            if want_sync == 200:
                assert json.loads(body) == {"synced": [],
                                            "universes": {"us": 0}}
            # Through HttpMember: the same report and the same scores.
            hm = HttpMember("h", f"http://127.0.0.1:{port}")
            assert hm.serveable_months("us") == svc.serveable_months("us")
            m = svc.serveable_months("us")[5]
            np.testing.assert_array_equal(hm.score("us", m).scores,
                                          svc.score("us", m).scores)
            with pytest.raises(KeyError):
                hm.score("nope", m)
        finally:
            httpd.shutdown()
            httpd.server_close()
            svc.close()


# ---- trace_report -------------------------------------------------------


def test_fleet_section_in_trace_report(tmp_path):
    run_dir = str(tmp_path / "run")
    svc_a, svc_b = _service(), _service()
    try:
        months = svc_a.serveable_months("us")[:3]
        with telemetry.run_scope(run_dir, extra={"entry": "test"}):
            coord = FleetCoordinator(replicas=2)
            coord.add_member(LocalMember("m0", svc_a), verify=False)
            coord.add_member(LocalMember("m1", svc_b), verify=False)
            router = FleetRouter(coord, breaker=1, cooldown_ms=60_000,
                                 health_ttl_ms=0, retries=2)
            primary = coord.route("us")[0]
            victim = {"m0": svc_a, "m1": svc_b}[primary]
            for _ in range(4):
                victim.batcher._dispatch_fail()
            for m in months:
                router.score("us", m)
            with open(os.path.join(run_dir, "fleet.prom"), "w") as fh:
                fh.write(router.metrics_text())
    finally:
        svc_a.close()
        svc_b.close()
    tr_mod = load_trace_report(REPO)
    fl = tr_mod.build_report(tr_mod.load_run(run_dir))["fleet"]
    assert fl["requests"] == len(months)
    assert fl["member_outs"] >= 1
    assert fl["mismatches"] == []
    events = [e["event"] for e in fl["timeline"][primary]]
    assert "member_joined" in events and "member_out" in events


# ---- a real SIGKILL of a subprocess member ------------------------------------


def test_sigkill_member_failover_subprocess(tmp_path):
    """Two members started from the store (``python -m
    lfm_quant_tpu_torch.serve.fleet --device cpu``), admitted through the
    gate at 0 kernel builds and one panel upload; one is SIGKILLed under
    traffic: every response bitwise equal to the pre-kill scores, no
    client error, the fleet still ready. A replacement joins from the
    store."""
    store_dir = str(tmp_path / "store")
    svc = _service(store_dir)
    months = svc.serveable_months("us")[:6]
    refs = {m: svc.score("us", m).scores.copy() for m in months}
    svc.close()
    env = {"OMP_NUM_THREADS": "1"}
    procs = []
    try:
        rfs = [str(tmp_path / f"ready{k}.json") for k in range(3)]
        for rf in rfs[:2]:
            procs.append(fleet.spawn_member(store_dir, ready_file=rf,
                                            env=env, device="cpu"))
        infos = [fleet.wait_member_ready(p, rf, 240)
                 for p, rf in zip(procs, rfs)]
        coord = FleetCoordinator(store=ZooStore(store_dir, readonly=True))
        for k, info in enumerate(infos):
            assert info["restore_compiles"] == 0, info
            assert info["restore_panel_h2d"] == 1, info
            assert [r["probe"] for r in info["restore"]] == ["bit_equal"]
            coord.add_member(HttpMember(
                f"m{k}", f"http://127.0.0.1:{info['port']}",
                pid=info["pid"]))
        router = FleetRouter(coord, breaker=1, cooldown_ms=60_000,
                             retries=3)
        for m in months:
            np.testing.assert_array_equal(router.score("us", m).scores,
                                          refs[m])
        victim = coord.route("us")[0]
        os.kill(procs[int(victim[1:])].pid, signal.SIGKILL)
        for _ in range(2):
            for m in months:
                np.testing.assert_array_equal(
                    router.score("us", m).scores, refs[m])
        assert coord.slot(victim).state == "out"
        assert router.stats()["failovers"] >= 1
        assert router.health()["ok"]
        agg = router.metrics_text()
        assert 'member="' in agg and "scrape unavailable" in agg
        procs.append(fleet.spawn_member(store_dir, ready_file=rfs[2],
                                        env=env, device="cpu"))
        info = fleet.wait_member_ready(procs[-1], rfs[2], 240)
        assert info["restore_compiles"] == 0
        hm = HttpMember("m2", f"http://127.0.0.1:{info['port']}")
        coord.add_member(hm)
        assert "m2" in coord.route("us")
        np.testing.assert_array_equal(
            hm.score("us", months[0], timeout_s=30).scores, refs[months[0]])
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)


def test_serve_cli_fleet_mode(tmp_path, capsys, monkeypatch):
    """``python -m lfm_quant_tpu_torch.serve --fleet 2``: publishes to the
    store, starts two members that pass the gate at 0 kernel builds,
    drives the load through the router, writes the aggregated scrape
    (``fleet.prom``) that trace_report's fleet section reads, and stops
    the members."""
    from lfm_quant_tpu_torch.serve.__main__ import main

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # The entry point records its fleet mode in LFM_FLEET, as serve.py
    # does: restored after the test.
    monkeypatch.setenv("LFM_FLEET", "0")
    run_dir = str(tmp_path / "run")
    assert main(["--preset", "c1", "--n-firms", "40", "--n-months", "90",
                 "--device", "cpu", "--requests", "8", "--threads", "2",
                 "--persist", str(tmp_path / "store"), "--fleet", "2",
                 "--run-dir", run_dir]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["completed"] == 8 and stats["unroutable"] == 0
    assert sorted(stats["members"]) == ["m0", "m1"]
    assert all(m["restore_compiles"] == 0 and m["state"] == "in"
               for m in stats["members"].values())
    for m in stats["members"].values():  # stopped
        with pytest.raises(ProcessLookupError):
            os.kill(m["pid"], 0)
    assert os.environ["LFM_FLEET"] == "2"
    tr_mod = load_trace_report(REPO)
    fl = tr_mod.build_report(tr_mod.load_run(run_dir))["fleet"]
    assert fl["requests"] == 8 and fl["mismatches"] == []
    assert sorted(fl["scrape_members"]) == ["m0", "m1"]
