"""Automatic incident capture: a self-contained bundle per degradation.

The port's copy of ``lfm_quant_tpu/serve/incident.py`` (the imports
changed; the bundle's ``host`` block is the port's ``build_info()``:
torch, its CUDA build and the card). The ``quarantine`` trigger below
belongs to the durable store, which the port does not have yet.

When the always-on service degrades — the PR 10 breaker opens, a PR 11
SLO starts burning, the drift gate vetoes a publish, a PR 12 restore
quarantines a snapshot, the shed rate spikes — the operator previously
got a gauge flip and nothing else: by the time anyone scrapes, the
evidence of the seconds BEFORE the degradation is gone. This module
turns each of those existing signals into a trigger that writes one
rate-limited, self-contained **incident bundle** to disk :

    <dir>/incidents/inc_<NNN>_<trigger>/
        flight.jsonl        the black-box flight-recorder ring
                            (utils/flight.py — the causal timeline)
        metrics.prom        one full /metrics scrape at capture time
        snapshot.json       the one-lock ScoringService.snapshot()
                            view (stats + health + SLO/drift detail)
        slow_requests.json  the K slowest recent request traces, each
                            with the queue/batch/retry/dispatch phase
                            breakdown (the histogram-exemplar targets)
        exemplars.json      per-bucket latency exemplars (trace ids)
        incident.json       trigger, context, host/build identity
                            (telemetry.build_info()) — written LAST,
                            fsync'd: its presence marks a complete
                            bundle (readers skip half-written ones)

Triggers (all EXISTING signals — this module adds no new detection):

* ``breaker_open``  — the circuit breaker transitioned to OPEN
  (serve/batcher.py ``_dispatch_fail``);
* ``slo_burn``      — an SLO objective is burning in every window
  (serve/monitor.py ``collect``, i.e. at scrape/snapshot time);
* ``shed_spike``    — sheds exceed :data:`SHED_SPIKE_FRACTION` of the
  last 60 s of traffic (monitor ``collect``, the ``serve_shed`` ring);
* ``drift_veto``    — the knob-gated publish gate fired
  (serve/monitor.py ``check_publish_gate``);
* ``quarantine``    — a durable snapshot failed restore verification
  (serve/persist.py ``_quarantine``).

Rate limiting: one bundle per trigger kind per
``LFM_INCIDENT_COOLDOWN_S`` (default 300 s) — a flapping breaker under
sustained overload must not turn the run dir into a bundle farm;
suppressed triggers still count (``incidents_suppressed``).

Where bundles land: ``LFM_INCIDENT_DIR`` if set, else the active
telemetry run dir, else capture is disabled (no run dir and no
explicit destination means nobody asked for evidence on this host —
the trigger is a no-op beyond a counter bump).

Capture runs on a daemon thread: the triggering code path (the batcher
thread that just opened the circuit, the scrape handler that noticed a
burn) pays one rate-limit check; file writes, the scrape render and
the locked snapshot happen off it. Captures are serialized (one at a
time) and re-entrancy-guarded — a capture's OWN scrape calling
``collect()`` can notice the same burning SLO; it must not recurse.

Non-interference: no code path here touches a device; everything reads
locked host-side snapshots. With no triggers firing the layer costs
nothing on the request path (the breaker hook is one attribute read on
the failure path only).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

#: Shed-spike trigger: sheds over the last 60 s exceeding this fraction
#: of that window's traffic (with at least MIN_EVENTS of volume —
#: 3 sheds out of 4 requests is startup noise, not an incident).
SHED_SPIKE_FRACTION = 0.10
SHED_SPIKE_MIN_EVENTS = 20

#: The rate/SLO window the shed-spike trigger evaluates over (seconds).
SHED_SPIKE_WINDOW_S = 60.0


def incident_dir_default() -> str:
    """``LFM_INCIDENT_DIR``: explicit bundle destination; empty/unset
    defers to the active telemetry run dir (and disables capture when
    neither exists)."""
    return os.environ.get("LFM_INCIDENT_DIR", "").strip()


def incident_cooldown_default() -> float:
    """``LFM_INCIDENT_COOLDOWN_S``: minimum seconds between bundles of
    the SAME trigger kind (default 300; <= 0 disables capture
    entirely — the loud-off switch)."""
    return float(os.environ.get("LFM_INCIDENT_COOLDOWN_S", "300"))


def _atomic_json(path: str, obj: Any, fsync: bool = False) -> None:
    """Write ``obj`` as JSON via temp file + rename (readers never see
    a torn file); non-finite floats nulled (the spans.jsonl policy)."""
    from lfm_quant_tpu_torch.utils.logging import _finite

    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(_finite(obj), fh, indent=2, default=str)
        if fsync:
            fh.flush()
            os.fsync(fh.fileno())
    os.replace(tmp, path)


class IncidentManager:
    """One per :class:`~lfm_quant_tpu_torch.serve.service.ScoringService`:
    holds the trigger cooldowns and writes the bundles. Construction is
    cheap and unconditional — whether capture is ACTIVE is re-resolved
    per trigger (the run dir can attach after the service starts)."""

    def __init__(self, service: Any, incident_dir: Optional[str] = None,
                 cooldown_s: Optional[float] = None):
        self._service = service
        self._dir = incident_dir  # explicit ctor dir wins; None = env
        self._cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._last: Dict[str, float] = {}
        self._seq = 0
        # Captures in flight (guarded by _lock, incremented at trigger
        # ACCEPT — before the thread starts — so the window where a
        # second trigger could slip past is closed): >0 means a
        # capture is running and any further trigger is dropped
        # WITHOUT consuming its cooldown (it may fire once the capture
        # finishes). This both serializes captures (two bundles
        # writing concurrently would race the gauge clear+rebuild in
        # collect()) and breaks the recursion where a capture's own
        # scrape re-notices the burning SLO.
        self._active = 0
        self._threads: List[threading.Thread] = []
        self.captured = 0
        self.suppressed = 0

    # ---- config resolution -------------------------------------------

    def cooldown_s(self) -> float:
        return (self._cooldown_s if self._cooldown_s is not None
                else incident_cooldown_default())

    def resolve_dir(self) -> Optional[str]:
        """The bundle destination, re-resolved per trigger: explicit
        ctor dir, else ``LFM_INCIDENT_DIR``, else the active telemetry
        run dir, else None (capture disabled)."""
        if self._dir:
            return self._dir
        env = incident_dir_default()
        if env:
            return env
        from lfm_quant_tpu_torch.utils import telemetry

        run = telemetry.active_run()
        return run.run_dir if run is not None else None

    # ---- trigger / capture -------------------------------------------

    def trigger(self, trigger: str, sync: bool = False,
                **ctx: Any) -> bool:
        """Fire a trigger: rate-limit check, then capture on a daemon
        thread (``sync=True`` captures inline — tests and operator
        tooling). Returns True when a capture was started. Never
        raises — incident capture must not be able to take down the
        path that noticed the incident."""
        try:
            return self._trigger(trigger, sync, ctx)
        except Exception as e:  # noqa: BLE001 — capture is best-effort
            import warnings

            warnings.warn(f"incident capture failed for {trigger!r}: "
                          f"{type(e).__name__}: {e}", RuntimeWarning,
                          stacklevel=2)
            return False

    def _trigger(self, trigger: str, sync: bool,
                 ctx: Dict[str, Any]) -> bool:
        from lfm_quant_tpu_torch.utils import telemetry

        cooldown = self.cooldown_s()
        if cooldown <= 0:
            return False
        out_dir = self.resolve_dir()
        if out_dir is None:
            return False
        now = time.monotonic()
        with self._lock:
            if self._active > 0:
                # A capture is already running (possibly THIS trigger
                # re-noticed by the capture's own scrape): drop without
                # consuming the cooldown.
                return False
            last = self._last.get(trigger)
            if last is not None and now - last < cooldown:
                self.suppressed += 1
                telemetry.COUNTERS.bump("incidents_suppressed")
                return False
            self._last[trigger] = now
            # The bundle name must be fresh ON DISK, not just fresh in
            # this process: a restarted service pointing at the same
            # persistent LFM_INCIDENT_DIR would otherwise restart at
            # inc_001 and silently overwrite the previous process's
            # evidence — often the most interesting bundle (the crash).
            while True:
                self._seq += 1
                seq = self._seq
                bundle = os.path.join(out_dir, "incidents",
                                      f"inc_{seq:03d}_{trigger}")
                if not os.path.exists(bundle):
                    break
            self._active += 1
        telemetry.COUNTERS.bump("incidents_triggered")
        telemetry.instant("incident_trigger", cat="incident",
                          trigger=trigger, seq=seq, **ctx)
        if sync:
            self._capture(bundle, trigger, ctx)
            return True
        t = threading.Thread(target=self._capture,
                             args=(bundle, trigger, ctx),
                             name=f"incident-{trigger}", daemon=True)
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        try:
            t.start()
        except BaseException:
            # _capture never ran, so its finally can't release the
            # in-flight slot — release it here or capture deadlocks off.
            with self._lock:
                self._active -= 1
            raise
        return True

    def _capture(self, bundle_dir: str, trigger: str,
                 ctx: Dict[str, Any]) -> None:
        from lfm_quant_tpu_torch.utils import flight, metrics, telemetry

        t0 = time.perf_counter()
        try:
            os.makedirs(bundle_dir, exist_ok=True)
            svc = self._service
            files: Dict[str, Optional[str]] = {}
            # Every artifact below is individually guarded: a partial
            # bundle with incident.json naming what failed beats a
            # half-written directory a crashed capture orphans (readers
            # key completeness on incident.json, written LAST).
            # 1. The flight-recorder ring — the causal timeline of the
            #    seconds before the trigger (crash-safe dump).
            n_events = 0
            try:
                n_events = flight.dump(os.path.join(bundle_dir,
                                                    "flight.jsonl"))
                files["flight.jsonl"] = f"{n_events} events"
            except Exception as e:  # noqa: BLE001 — partial > nothing
                files["flight.jsonl"] = f"failed: {type(e).__name__}: {e}"
            # 2. One /metrics scrape, rendered from ONE counter
            #    snapshot that incident.json below also records
            #    verbatim — so the scrape's lfm_*_total lines and the
            #    manifest's counters_at_capture agree EXACTLY, which is
            #    what lets trace_report catch a torn/forged scrape.
            #    The monitor's collect() runs first (gauges + the SLO/
            #    shed trigger checks — the _capturing guard keeps a
            #    burning SLO it notices from recursing into another
            #    capture).
            counters_now: Dict[str, Any] = {}
            try:
                svc.monitor.collect()
                counters_now = {
                    k: v for k, v in
                    telemetry.COUNTERS.snapshot().items()
                    if isinstance(v, (int, float))}
                with open(os.path.join(bundle_dir, "metrics.prom"),
                          "w") as fh:
                    fh.write(metrics.render_prometheus(
                        metrics.METRICS, counters=counters_now))
                files["metrics.prom"] = "ok"
            except Exception as e:  # noqa: BLE001 — partial > nothing
                files["metrics.prom"] = f"failed: {type(e).__name__}: {e}"
            # Run-scoped counter deltas: the registry is process-
            # LIFETIME (a long-lived service carries counts from before
            # this run dir attached), so the bundle stamps totals MINUS
            # the run's starting snapshot — the anchor trace_report's
            # 1% discipline compares against the span-derived counts
            # (a mid-run capture can only have seen AT MOST what the
            # full run ends with).
            run = telemetry.active_run()
            counters_since_run = None
            if run is not None and counters_now:
                c0 = run.counters_at_start()
                counters_since_run = {
                    k: v - c0.get(k, 0) for k, v in counters_now.items()
                    if isinstance(c0.get(k, 0), (int, float))
                    and v != c0.get(k, 0)}
            # 3. The one-lock service snapshot (stats + health detail).
            try:
                _atomic_json(os.path.join(bundle_dir, "snapshot.json"),
                             svc.snapshot())
                files["snapshot.json"] = "ok"
            except Exception as e:  # noqa: BLE001
                files["snapshot.json"] = f"failed: {type(e).__name__}: {e}"
            # 4. The K slowest recent request traces (phase breakdowns)
            #    — what the histogram exemplars point at.
            slow: List[Dict[str, Any]] = []
            try:
                slow = svc.batcher.slow_traces()
                _atomic_json(os.path.join(bundle_dir,
                                          "slow_requests.json"), slow)
                files["slow_requests.json"] = f"{len(slow)} traces"
            except Exception as e:  # noqa: BLE001
                files["slow_requests.json"] = \
                    f"failed: {type(e).__name__}: {e}"
            # 5. The per-bucket latency exemplars (trace ids).
            try:
                _atomic_json(os.path.join(bundle_dir, "exemplars.json"),
                             metrics.METRICS.exemplar_snapshot(
                                 "serve_latency_ms"))
                files["exemplars.json"] = "ok"
            except Exception as e:  # noqa: BLE001
                files["exemplars.json"] = \
                    f"failed: {type(e).__name__}: {e}"
            # 6. The manifest — LAST, fsync'd: a complete incident.json
            #    marks a complete bundle.
            _atomic_json(os.path.join(bundle_dir, "incident.json"), {
                "schema_version": 1,
                "trigger": trigger,
                "context": ctx,
                "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                "ts_unix": time.time(),
                "cooldown_s": self.cooldown_s(),
                "capture_wall_s": round(time.perf_counter() - t0, 4),
                "flight": flight.recorder().stats()
                if flight.recorder() else {"capacity": 0},
                "slow_traces": len(slow),
                "files": files,
                # The SAME snapshot the scrape above rendered (exact
                # agreement = the scrape-integrity anchor) + the run-
                # scoped deltas (the spans-discipline anchor).
                "counters_at_capture": counters_now,
                "counters_since_run": counters_since_run,
                # Host/process identity (ROADMAP item 2 groundwork): a
                # fleet aggregator collecting bundles must know which
                # member, build and backend produced each one.
                "host": telemetry.build_info(),
            }, fsync=True)
            with self._lock:
                self.captured += 1
            telemetry.COUNTERS.bump("incidents_captured")
            telemetry.instant("incident_captured", cat="incident",
                              trigger=trigger, path=bundle_dir,
                              events=n_events, slow=len(slow))
            import warnings

            warnings.warn(
                f"incident captured ({trigger}): {bundle_dir} — "
                f"{n_events} flight events, {len(slow)} slow traces",
                RuntimeWarning, stacklevel=2)
        finally:
            with self._lock:
                self._active -= 1

    # ---- introspection / lifecycle -----------------------------------

    def wait(self, timeout: float = 10.0) -> None:
        """Join outstanding capture threads (tests, shutdown)."""
        with self._lock:
            threads = list(self._threads)
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"captured": self.captured,
                    "suppressed": self.suppressed,
                    "cooldown_s": self.cooldown_s(),
                    "dir": self.resolve_dir(),
                    "triggers_seen": sorted(self._last)}


def find_bundles(root: str) -> List[str]:
    """Complete incident bundles under ``root`` (a run dir or an
    explicit incident dir), oldest first — a bundle is complete iff its
    ``incident.json`` exists (written last, fsync'd)."""
    base = os.path.join(root, "incidents")
    if not os.path.isdir(base):
        return []
    out = []
    for name in sorted(os.listdir(base)):
        path = os.path.join(base, name)
        if os.path.isfile(os.path.join(path, "incident.json")):
            out.append(path)
    return out
