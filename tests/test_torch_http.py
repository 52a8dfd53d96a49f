"""The port's HTTP front door against ``serve.py``'s, and the port's
run-dir artifacts in the unchanged ``scripts/trace_report.py``.

* A real HTTP round trip on 127.0.0.1, port 0: the port's
  ``make_http_server`` over ``ScoringService(device="cpu")`` and
  ``serve.py``'s over the JAX service, the same tiny MLP universe (the
  params of the JAX trainer's ``init_state()``), the same requests —
  healthy, unknown universe and month, unknown path, ``/healthz``,
  ``/stats``, ``/metrics``, then a permanent dispatch fault that opens
  the circuit. Both answer with the same status codes, JSON keys,
  ``X-Request-Id`` echo, ``Retry-After`` and ``LFM_ACCESS_LOG`` fields;
  scores within the f32 serve tolerance (atol 1e-5).
* A telemetry run of the port's service (retries, a breaker opening
  that writes an incident bundle into the run dir, the saved
  ``metrics.prom`` scrape) renders clean in ``scripts/trace_report.py``:
  its serve, metrics and incidents sections present, no mismatch.
"""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request
import warnings
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

import serve as jax_serve_py
from lfm_quant_tpu.config import (DataConfig, ModelConfig, OptimConfig,
                                  RunConfig)
from lfm_quant_tpu.data.panel import PanelSplits as JaxSplits
from lfm_quant_tpu.data.panel import synthetic_panel as jax_synthetic
from lfm_quant_tpu.data.windows import clear_panel_cache
from lfm_quant_tpu.serve import ScoringService as JaxService
from lfm_quant_tpu.serve.stats import load_trace_report
from lfm_quant_tpu.train import reuse
from lfm_quant_tpu.train.loop import Trainer as JaxTrainer
from lfm_quant_tpu.utils import faults as jax_faults
from lfm_quant_tpu_torch import config as tconfig
from lfm_quant_tpu_torch.data.panel import synthetic_panel
from lfm_quant_tpu_torch.serve import ScoringService
from lfm_quant_tpu_torch.serve import batcher
from lfm_quant_tpu_torch.serve import http as port_http
from lfm_quant_tpu_torch.utils import faults, flight, metrics, telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PANEL = dict(n_firms=36, n_months=90, n_features=4, seed=8)


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    for knob in ("LFM_FAULTS", "LFM_METRICS", "LFM_FLIGHT",
                 "LFM_INCIDENT_DIR", "LFM_ACCESS_LOG", "LFM_DRIFT_GATE"):
        monkeypatch.delenv(knob, raising=False)

    def fresh():
        faults.configure("")
        jax_faults.configure("")
        flight.configure()
        metrics.METRICS.reset()
        telemetry.COUNTERS.reset()
        reuse.clear_program_cache()
        clear_panel_cache()

    fresh()
    yield
    fresh()


def _cfg():
    return RunConfig(
        name="http_t",
        data=DataConfig(n_firms=PANEL["n_firms"],
                        n_months=PANEL["n_months"],
                        n_features=PANEL["n_features"], window=6,
                        dates_per_batch=4, firms_per_date=16),
        model=ModelConfig(kind="mlp", kwargs={"hidden": (16,)}),
        optim=OptimConfig(epochs=1, warmup_steps=2, loss="mse"),
        seed=4)


KW = dict(max_rows=2, max_wait_ms=0.0, retries=0, breaker_threshold=1,
          breaker_cooldown_ms=59_500.0)


def _get(port, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _drive(svc, make_server, fault_mod, month, log_path, monkeypatch):
    monkeypatch.setenv("LFM_ACCESS_LOG", log_path)
    httpd = make_server(svc, 0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    tp = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    score = f"/score?universe=u&month={month}"
    out = []
    try:
        for path, hdr in ((score, {"X-Request-Id": "hdr-rt-1"}),
                          (score, {"traceparent": tp}),
                          (score, {"X-Request-Id":
                                   "evil id <x>/../" + "z" * 90}),
                          (score, None),
                          (f"/score?universe=nope&month={month}", None),
                          ("/score?universe=u&month=190001", None),
                          ("/healthz", None), ("/stats", None),
                          ("/metrics", None), ("/nope", None)):
            out.append(_get(port, path, hdr))
        fault_mod.configure("serve_dispatch:kind=permanent")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            out.append(_get(port, score, {"X-Request-Id": "fails-1"}))
            svc.incidents.wait()
        out.append(_get(port, "/healthz"))
        out.append(_get(port, score))
        fault_mod.configure("")
    finally:
        httpd.shutdown()
        httpd.server_close()
    lines = [json.loads(x) for x in open(log_path).read().splitlines()]
    return out, lines


def test_http_round_trip_matches_serve_py(tmp_path, monkeypatch):
    jpanel = jax_synthetic(**PANEL)
    trainer = JaxTrainer(_cfg(), JaxSplits.by_date(jpanel, 197401, 197601))
    trainer.state = trainer.init_state()
    jsvc = JaxService(**KW)
    jsvc.register("u", trainer, warm=False)
    svc = ScoringService(device="cpu", **KW)
    svc.register("u", tconfig.RunConfig.from_json(_cfg().to_json()),
                 synthetic_panel(**PANEL),
                 jax.tree_util.tree_map(np.asarray, trainer.state.params))
    try:
        month = svc.serveable_months("u")[7]
        assert month == jsvc.serveable_months("u")[7]
        got, got_log = _drive(svc, port_http.make_http_server, faults,
                              month, str(tmp_path / "port.jsonl"),
                              monkeypatch)
        want, want_log = _drive(jsvc, jax_serve_py.make_http_server,
                                jax_faults, month,
                                str(tmp_path / "jax.jsonl"), monkeypatch)
    finally:
        svc.close()
        jsvc.close()
    assert [s for s, _, _ in got] == [s for s, _, _ in want] == [
        200, 200, 200, 200, 404, 404, 200, 200, 200, 404, 500, 503, 503]
    for k, ((_, gh, gb), (_, wh, wb)) in enumerate(zip(got, want)):
        assert gh.get("Content-Type") == wh.get("Content-Type"), k
        assert gh.get("Retry-After") == wh.get("Retry-After"), k
        if k == 8:  # /metrics: Prometheus text
            assert b"lfm_serve_latency_ms_bucket" in gb
            continue
        g, w = json.loads(gb), json.loads(wb)
        if k == 7:  # /stats: the port's keys are a superset
            assert set(w) <= set(g)
            assert g["completed"] == w["completed"] == 4
            continue
        assert set(g) == set(w), k
        if k < 4:
            rid_g, rid_w = gh.get("X-Request-Id"), wh.get("X-Request-Id")
            assert rid_g == g["request_id"] and rid_w == w["request_id"]
            if k < 3:
                assert rid_g == rid_w
            else:
                assert len(rid_g) == len(rid_w) == 32
            assert set(g["phases"]) == set(w["phases"])
            np.testing.assert_array_equal(g["firm_idx"], w["firm_idx"])
            np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5)
    assert got[0][2] and json.loads(got[0][2])["request_id"] == "hdr-rt-1"
    assert got[1][1]["X-Request-Id"] == "0af7651916cd43dd8448eb211c80319c"
    assert json.loads(got[11][2])["circuit"] == "open"
    assert int(got[11][1]["Retry-After"]) == 60
    # The access log: one line per /score, the same fields and statuses.
    assert len(got_log) == len(want_log) == 8
    for g, w in zip(got_log, want_log):
        assert set(g) == set(w) and g["status"] == w["status"]
        assert g["request_id"] == w["request_id"] or g["status"] == 200


class _Clock:
    def __init__(self):
        self.offset = 0.0
        self.sleep = time.sleep
        self.time = time.time
        self.monotonic = time.monotonic

    def perf_counter(self):
        return time.perf_counter() + self.offset


def test_port_run_dir_renders_clean_in_trace_report(tmp_path, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(batcher, "time", clock)
    run_dir = str(tmp_path / "run")
    assert telemetry.active_run() is None
    with telemetry.run_scope(run_dir, extra={"entry": "test_torch_http"}):
        svc = ScoringService(device="cpu", max_rows=2, max_wait_ms=0.0,
                             retries=1, breaker_threshold=1,
                             breaker_cooldown_ms=10.0)
        try:
            svc.register("u", tconfig.RunConfig.from_json(_cfg().to_json()),
                         synthetic_panel(**PANEL))
            months = svc.serveable_months("u")
            for m in months[:8]:
                svc.score("u", m)
            faults.configure("serve_dispatch:n=1")
            svc.score("u", months[3])  # one retry
            faults.configure("serve_dispatch:kind=permanent")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                with pytest.raises(faults.PermanentFault):
                    svc.score("u", months[4], timeout=30)
                svc.incidents.wait()
            faults.configure("")
            clock.offset += 0.05  # the half-open probe closes it
            for m in months[8:12]:
                svc.score("u", m)
            assert svc.health()["ok"]
            st = svc.stats()
            with open(os.path.join(run_dir, "metrics.prom"), "w") as fh:
                fh.write(svc.metrics_text())
        finally:
            svc.close()
    tr = load_trace_report(REPO)
    rep = tr.build_report(tr.load_run(run_dir))
    sv = rep["serve"]
    assert sv["completed"] == st["completed"] == 13
    assert sv["requests"] == 14  # the failed request's span too
    assert sv["retries"] == 1 and sv["breaker_opens"] == 1
    assert sv["faults_injected"] == 2
    assert sv["p99_ms"] == pytest.approx(st["p99_ms"], rel=0.01)
    assert sv["slowest"] and "dispatch_ms" in sv["slowest"][0]
    assert rep["metrics"]["requests"] == 13
    assert rep["metrics"]["mismatches"] == []
    inc = rep["incidents"]
    # The breaker's bundle, and the scrape's: 1 error in 14 requests
    # burns the availability objective in both windows.
    assert inc["mismatches"] == []
    assert [b["trigger"] for b in inc["bundles"]] == ["breaker_open",
                                                       "slo_burn"]
    assert all(b["flight_events"] > 0 and b["slow_traces"] > 0
               for b in inc["bundles"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        tr.print_report(rep)
    text = buf.getvalue()
    for section in ("serve", "metrics", "incidents"):
        assert f"\n{section}" in text, section
    assert "MISMATCH" not in text.upper()
