"""Live service health: SLO burn rates, score drift, gauge collection.

The port of ``lfm_quant_tpu/serve/monitor.py``; the ``build_info`` gauge
is labelled with torch, its CUDA build and the device's name where the
JAX package's carries jax and jaxlib.

``utils/metrics.py`` owns the instruments (histograms, rings, gauges);
this module owns their INTERPRETATION for the always-on service:

* **SLO burn rates** (:func:`slo_status`) — the declared objectives
  (``LFM_SLO_P99_MS`` latency, ``LFM_SLO_AVAIL`` availability) are
  evaluated as MULTI-WINDOW burn rates over the windowed rings the
  batcher marks per request (60 s and 300 s — the fast window catches
  an acute outage, the slow one rejects a blip). Burn rate 1.0 means
  the error budget is being consumed exactly at the rate that exhausts
  it at the objective boundary; an objective is ``burning`` only when
  EVERY window's burn exceeds 1.0 (the classic multi-window AND — a
  single bad 10 s ring can spike the fast window, but only a sustained
  breach lights both). Surfaced as ``slo_burn`` gauges and in the
  ``/healthz`` detail — detail, not readiness: a burning SLO is an
  alert for the operator, while readiness (503) stays owned by the
  breaker/batcher machinery.
* **Score drift** (:func:`drift_status`) — each zoo generation carries
  a publish-time REFERENCE :class:`~lfm_quant_tpu_torch.utils.metrics.ScoreSketch`
  of its batch-scored months and a LIVE twin the batcher streams served
  scores into; their PSI divergence is the ``score_drift_psi`` gauge.
  Crossing ``LFM_DRIFT_MAX`` flips the ``/healthz`` drift detail and —
  knob-gated via ``LFM_DRIFT_GATE``, default OFF —
  :func:`check_publish_gate` VETOES the universe's next atomic publish
  (serve/errors.py ``DriftVetoError``): the first concrete piece of the
  ROADMAP 5b risk gate, where a generation whose serving distribution
  has left its reference must be re-validated before another swap
  compounds the drift.
* **Gauge collection** (:meth:`ServiceMonitor.collect`) — point-in-time
  service state set at scrape/snapshot time, never per event: queue
  depth, zoo entries, resident panel/param bytes (computed from array
  METADATA — shape × dtype — so no device fetch ever originates here),
  ``circuit_state``, the ``slo_burn`` and ``score_drift_psi`` gauges.

Everything here is host-side arithmetic over locked snapshots; under
``LFM_METRICS=0`` collection degrades to an exact no-op and the status
functions report inactive objectives.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from lfm_quant_tpu_torch.utils import metrics, telemetry
from lfm_quant_tpu_torch.utils.metrics import METRICS

#: Burn windows (seconds): fast catches an acute outage, slow rejects a
#: blip; both must burn > 1.0 for an objective to count as burning.
SLO_WINDOWS = (60.0, 300.0)

#: The p99 objective's error budget: 1% of requests may exceed the
#: latency bound (that is what "p99 <= X" means as a budget).
LATENCY_BUDGET_FRACTION = 0.01

#: A live sketch must hold at least this many served scores before its
#: PSI is reported — a handful of requests is sampling noise, not drift.
DRIFT_MIN_SCORES = 32


def slo_status(now: Optional[float] = None) -> Dict[str, Any]:
    """Evaluate the declared SLOs as multi-window burn rates over the
    ``serve_ok`` / ``serve_err`` / ``serve_slo_lat_bad`` rings the
    batcher marks. Returns ``{active, objectives: {name: {burn: {w: x},
    burning}}, max_burn, burning}``; inactive objectives (disabled by
    knob value) are omitted."""
    p99_ms = metrics.slo_p99_ms_default()
    avail = metrics.slo_avail_default()
    out: Dict[str, Any] = {"objectives": {}, "max_burn": 0.0,
                           "burning": False}
    if not metrics.enabled():
        out["active"] = False
        return out
    totals = {}
    for w in SLO_WINDOWS:
        ok = METRICS.window_total("serve_ok", w, now=now)
        err = METRICS.window_total("serve_err", w, now=now)
        bad = METRICS.window_total("serve_slo_lat_bad", w, now=now)
        totals[w] = (ok, err, bad)
    if 0.0 < avail < 1.0:
        budget = 1.0 - avail
        burns = {}
        for w, (ok, err, _) in totals.items():
            total = ok + err
            frac = err / total if total > 0 else 0.0
            burns[w] = frac / budget
        out["objectives"]["availability"] = {
            "objective": avail,
            "burn": {f"{int(w)}s": round(b, 3) for w, b in burns.items()},
            "burning": all(b > 1.0 for b in burns.values()),
        }
    if p99_ms > 0.0:
        burns = {}
        for w, (ok, _, bad) in totals.items():
            frac = bad / ok if ok > 0 else 0.0
            burns[w] = frac / LATENCY_BUDGET_FRACTION
        out["objectives"]["latency_p99"] = {
            "objective_ms": p99_ms,
            "burn": {f"{int(w)}s": round(b, 3) for w, b in burns.items()},
            "burning": all(b > 1.0 for b in burns.values()),
        }
    out["active"] = bool(out["objectives"])
    all_burns = [b for o in out["objectives"].values()
                 for b in o["burn"].values()]
    out["max_burn"] = round(max(all_burns, default=0.0), 3)
    out["burning"] = any(o["burning"] for o in out["objectives"].values())
    return out


class ServiceMonitor:
    """The evaluation layer bound to one :class:`ScoringService`: turns
    the recorded instruments plus the service's live structures into
    gauges, SLO/drift status, the publish gate and the ``/metrics``
    document. Owns no locks of its own — every read is a locked
    snapshot from the structure that owns the state."""

    def __init__(self, service: Any):
        self._service = service

    # ---- score drift -------------------------------------------------

    def drift_status(self) -> Dict[str, Any]:
        """Per-universe PSI of served scores against the generation's
        publish-time reference. ``breached`` lists universes past
        ``LFM_DRIFT_MAX``; universes whose live sketch holds fewer than
        ``DRIFT_MIN_SCORES`` scores report ``psi: None`` (not enough
        served mass to call drift either way)."""
        drift_max = metrics.drift_max_default()
        out: Dict[str, Any] = {"threshold": drift_max, "universes": {},
                               "breached": []}
        if not metrics.enabled() or drift_max <= 0:
            out["active"] = False
            return out
        zoo = self._service.zoo
        for universe in zoo.universes():
            try:
                entry = zoo.current(universe)
            except KeyError:
                continue  # dropped between listing and read
            psi = entry.drift_psi(min_scores=DRIFT_MIN_SCORES)
            if entry.ref_sketch is None:
                continue  # no reference stamped (metrics were off)
            rec = {"generation": entry.generation,
                   "psi": None if psi is None else round(psi, 4),
                   "served_scores": (entry.live_sketch.size()
                                     if entry.live_sketch is not None
                                     else 0)}
            out["universes"][universe] = rec
            if psi is not None and psi > drift_max:
                out["breached"].append(universe)
        out["active"] = bool(out["universes"])
        return out

    def check_publish_gate(self, universe: str) -> None:
        """The knob-gated publish veto (``LFM_DRIFT_GATE=1``): raise
        :class:`~lfm_quant_tpu_torch.serve.errors.DriftVetoError` when the
        universe's CURRENT generation is past ``LFM_DRIFT_MAX`` — a
        serving distribution that has left its reference must be
        re-validated before another atomic swap compounds it. With the
        gate off (the default) drift stays observable (gauge +
        ``/healthz`` detail) but never blocks an operator."""
        if not (metrics.enabled() and metrics.drift_gate_enabled()):
            return
        drift_max = metrics.drift_max_default()
        if drift_max <= 0:
            return
        try:
            entry = self._service.zoo.current(universe)
        except KeyError:
            return  # first publish of a new universe: nothing to drift
        psi = entry.drift_psi(min_scores=DRIFT_MIN_SCORES)
        if psi is not None and psi > drift_max:
            from lfm_quant_tpu_torch.serve.errors import DriftVetoError

            telemetry.COUNTERS.bump("serve_drift_vetoes")
            telemetry.instant("drift_veto", cat="serve",
                              universe=universe, psi=round(psi, 4),
                              threshold=drift_max)
            # A veto IS the incident: the serving
            # distribution left its reference badly enough to block a
            # publish — capture the evidence while the live sketch
            # still holds the drifted stream.
            inc = getattr(self._service, "incidents", None)
            if inc is not None:
                inc.trigger("drift_veto", universe=universe,
                            psi=round(psi, 4), threshold=drift_max)
            raise DriftVetoError(universe, psi, drift_max)

    # ---- gauge collection --------------------------------------------

    def collect(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Set every point-in-time gauge (called at scrape/snapshot
        time, never per event) and return ``{slo, drift}`` for the
        ``/healthz`` detail. Exact no-op (beyond computing the returned
        status) under ``LFM_METRICS=0``."""
        slo = slo_status(now=now)
        drift = self.drift_status()
        if not metrics.enabled():
            return {"slo": slo, "drift": drift}
        svc = self._service
        batcher = svc.batcher
        # Per-entity families are REBUILT from live state each
        # collection: clear them first so a retired generation's PSI or
        # an evicted universe's bytes can't linger in the exposition
        # (an alert on a series that no longer serves).
        for name in ("zoo_param_bytes", "slo_burn_window",
                     "score_drift_psi"):
            METRICS.clear_gauges(name)
        METRICS.gauge("serve_queue_depth", float(batcher.queue_depth()))
        METRICS.gauge("circuit_state", float(batcher.circuit_state_code()))
        zsnap = svc.zoo.snapshot()
        METRICS.gauge("zoo_entries", float(zsnap["size"]))
        METRICS.gauge("zoo_capacity", float(zsnap["capacity"]))
        # Resident bytes from array METADATA (shape × dtype) — the
        # metrics path must never fetch from the device. Distinct
        # panel objects counted once (a refresh generation shares its
        # predecessor's panel).
        param_bytes = 0
        panel_bytes = 0
        seen_panels: set = set()
        zoo = svc.zoo
        for universe in zsnap["universes"]:
            try:
                entry = zoo.current(universe)
            except KeyError:
                continue
            pb = entry.param_bytes()
            param_bytes += pb
            METRICS.gauge("zoo_param_bytes", float(pb), universe=universe)
            if id(entry.panel) not in seen_panels:
                seen_panels.add(id(entry.panel))
                panel_bytes += entry.panel_bytes()
        METRICS.gauge("zoo_param_bytes_total", float(param_bytes))
        METRICS.gauge("zoo_panel_bytes_total", float(panel_bytes))
        METRICS.gauge("slo_burn", float(slo["max_burn"]))
        for name, obj in slo["objectives"].items():
            for w, b in obj["burn"].items():
                METRICS.gauge("slo_burn_window", float(b),
                              objective=name, window=w)
        for universe, rec in drift["universes"].items():
            if rec["psi"] is not None:
                METRICS.gauge("score_drift_psi", float(rec["psi"]),
                              universe=universe,
                              generation=rec["generation"])
        # Fleet identity (serve/fleet.py): WHICH build,
        # backend and MEMBER (host + pid) produced this scrape — the
        # classic value-1 info gauge, from the cached
        # telemetry.build_info() probe. The fleet aggregator relabels
        # each member's scrape with member="name", and host/pid here
        # let every stat and incident bundle be attributed to the
        # member process that produced it.
        info = telemetry.build_info()
        METRICS.clear_gauges("build_info")
        METRICS.gauge(
            "build_info", 1.0,
            git_sha=(info.get("git_sha") or "unknown")[:12],
            torch=info.get("torch") or "unknown",
            cuda=info.get("cuda") or "none",
            backend=info.get("backend") or "unknown",
            device=info.get("device") or "unknown",
            dtype=info.get("dtype") or "unknown",
            device_count=info.get("device_count") or 0,
            host=info.get("host") or "unknown",
            pid=info.get("pid") or 0)
        # Incident triggers evaluated at scrape/snapshot time (the
        # signals are windowed aggregates — there is no per-event
        # moment to hook): a burning SLO or a shed-rate spike starts a
        # rate-limited capture (serve/incident.py; its own scrape is
        # re-entrancy-guarded there).
        inc = getattr(svc, "incidents", None)
        if inc is not None:
            if slo.get("burning"):
                inc.trigger("slo_burn", max_burn=slo.get("max_burn"),
                            objectives=sorted(slo.get("objectives", {})))
            from lfm_quant_tpu_torch.serve.incident import (
                SHED_SPIKE_FRACTION, SHED_SPIKE_MIN_EVENTS,
                SHED_SPIKE_WINDOW_S)

            shed = METRICS.window_total("serve_shed",
                                        SHED_SPIKE_WINDOW_S, now=now)
            ok = METRICS.window_total("serve_ok", SHED_SPIKE_WINDOW_S,
                                      now=now)
            err = METRICS.window_total("serve_err", SHED_SPIKE_WINDOW_S,
                                       now=now)
            total = ok + err
            if (total >= SHED_SPIKE_MIN_EVENTS
                    and shed / total > SHED_SPIKE_FRACTION):
                inc.trigger("shed_spike", shed_60s=int(shed),
                            traffic_60s=int(total),
                            fraction=round(shed / total, 4))
        return {"slo": slo, "drift": drift}

    # ---- exposition --------------------------------------------------

    def metrics_text(self, ts: Optional[float] = None) -> str:
        """The ``GET /metrics`` document: collect gauges, then render
        the registry plus the absorbed telemetry counters as Prometheus
        text format 0.0.4."""
        self.collect()
        return metrics.render_prometheus(
            METRICS, counters=telemetry.COUNTERS.snapshot(), ts=ts)

    def snapshot(self, ts: Optional[float] = None) -> Dict[str, Any]:
        """The JSON twin of the scrape (``ScoringService.
        metrics_snapshot()``): gauges collected, every instrument
        summarized, SLO/drift status attached."""
        status = self.collect()
        return {
            "ts": time.time() if ts is None else ts,
            "metrics_enabled": metrics.enabled(),
            "slo": status["slo"],
            "drift": status["drift"],
            "instruments": METRICS.snapshot(),
            # Trace-id exemplars per latency bucket:
            # the JSON surface only — the text exposition stays plain
            # 0.0.4 (OpenMetrics exemplar syntax would break every
            # parse twin and any strict scraper).
            "exemplars": METRICS.exemplar_snapshot("serve_latency_ms"),
            "counters": {
                k: v for k, v in
                sorted(telemetry.COUNTERS.snapshot().items())
                if isinstance(v, (int, float))},
        }
