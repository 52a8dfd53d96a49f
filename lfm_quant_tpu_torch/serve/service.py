"""The scoring service: zoo + batcher + refresh, one object.

Port of ``lfm_quant_tpu/serve/service.py``. ``register`` a model per
universe, warm every request-shape bucket the universe can produce, then
``score`` / ``submit`` serve month queries.
The service owns the device: every registered model and its panel live
there. Around the batcher sit the degradation layer (shedding,
deadlines, retries, the circuit breaker: serve/batcher.py), the metrics
plane and its monitor (SLO burn, score drift, the publish gate:
serve/monitor.py) and incident capture (serve/incident.py).

Monthly data arrival is a **refresh**: a fresh
:class:`~lfm_quant_tpu_torch.train.loop.Trainer` on the advanced splits,
fitted from a COPY of the served generation's params, warmed, stamped
with its drift reference and published atomically. Requests in flight
finish on the old generation, new ones route to the new; nothing is
dropped or torn. The copy is load-bearing: the optimizer updates params
in place, so the served generation's tensors must never reach the fit.
The refresh trains on the same card and stream as the batcher's
dispatches, so the two serialize on the card while it runs.

Durable state (serve/persist.py): with a store (``persist_dir=`` or
``LFM_ZOO_PERSIST``) every publish of ``register`` and ``refresh`` is
committed to it before the in-memory swap; :meth:`ScoringService.restore`
stands a fresh process back up from it, verified, and
:meth:`ScoringService.sync_from_store` pulls the generations a fleet's
writer published since (serve/fleet.py). With no store nothing of this
runs.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from lfm_quant_tpu_torch.config import RunConfig
from lfm_quant_tpu_torch.data.panel import Panel
from lfm_quant_tpu_torch.device import resolve_device
from lfm_quant_tpu_torch.serve import buckets, persist
from lfm_quant_tpu_torch.serve.batcher import MicroBatcher, ScoreResponse
from lfm_quant_tpu_torch.serve.incident import IncidentManager
from lfm_quant_tpu_torch.serve.monitor import ServiceMonitor, slo_status
from lfm_quant_tpu_torch.serve.zoo import ModelZoo, ZooEntry
from lfm_quant_tpu_torch.train.loop import Predictor, Trainer
from lfm_quant_tpu_torch.utils import metrics, telemetry
from lfm_quant_tpu_torch.weights import flax_param_map


class ScoringService:
    """One serving object. ``device``: None means ``cuda`` (raises with
    no card); ``"cpu"`` serves through the kernels' plain versions. The
    degradation knobs default to their ``LFM_SERVE_*`` values
    (serve/buckets.py); the incident knobs to ``LFM_INCIDENT_DIR`` and
    ``LFM_INCIDENT_COOLDOWN_S``."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None,
                 zoo_capacity: Optional[int] = None,
                 max_rows: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 queue_max: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 retries: Optional[int] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_cooldown_ms: Optional[float] = None,
                 incident_dir: Optional[str] = None,
                 incident_cooldown_s: Optional[float] = None,
                 persist_dir: Optional[str] = None,
                 keep_generations: Optional[int] = None,
                 persist_readonly: bool = False):
        self.device = resolve_device(device)
        self.zoo = ModelZoo(zoo_capacity or buckets.zoo_capacity_default())
        self.max_rows = max_rows or buckets.max_rows_default()
        self.batcher = MicroBatcher(
            self.zoo, self.max_rows,
            buckets.max_wait_ms_default() if max_wait_ms is None
            else max_wait_ms,
            queue_max=queue_max, deadline_ms=deadline_ms, retries=retries,
            breaker_threshold=breaker_threshold,
            breaker_cooldown_ms=breaker_cooldown_ms)
        self.monitor = ServiceMonitor(self)
        self.incidents = IncidentManager(
            self, incident_dir=incident_dir,
            cooldown_s=incident_cooldown_s)
        self.batcher.incidents = self.incidents
        self._refresh_lock = threading.Lock()
        # The durable store: the ctor's dir, else LFM_ZOO_PERSIST; unset
        # means NO store object and every publish path as without it.
        # persist_readonly: a fleet member attaching the deploy artifact
        # (no sweep, no journal, no quarantine renames).
        pd = persist_dir if persist_dir is not None \
            else persist.persist_dir_default()
        self.store = (persist.ZooStore(pd, keep=keep_generations,
                                       readonly=persist_readonly)
                      if pd else None)
        if self.store is not None:
            self.store.incidents = self.incidents
        # The last restore()/sync_from_store() outcome and what it cost:
        # the nvcc builds it caused and its panel uploads (the join
        # report a fleet's gate reads).
        self.last_restore: Optional[List[Dict[str, Any]]] = None
        self.last_restore_compiles: Optional[int] = None
        self.last_restore_panel_h2d: Optional[int] = None

    # ---- registration / warmup --------------------------------------

    def register(self, universe: str, cfg: RunConfig, panel: Panel,
                 params: Optional[Mapping[str, Any]] = None, *,
                 warm: bool = True) -> ZooEntry:
        """Serve ``cfg``'s model over ``panel`` as ``universe``:
        generation 0, or the next one if the universe is registered.
        ``params`` is a Flax param tree (numpy arrays) or None for a
        seeded init. ``warm=True`` dispatches every (rows, width) bucket
        once and stamps the drift reference before the entry goes live.
        The drift gate (``LFM_DRIFT_GATE``) is checked first: a vetoed
        publish leaves the served generation serving."""
        try:
            gen = self.zoo.current(universe).generation + 1
        except KeyError:
            gen = 0
        self.monitor.check_publish_gate(universe)
        entry = ZooEntry(universe, gen,
                         Predictor(cfg, panel, params, device=self.device))
        if warm:
            self.warmup_entry(entry)
            self._stamp_reference(entry)
        # Durable record BEFORE the in-memory swap: a crash after the
        # manifest commit restores this generation, one before it the
        # predecessor.
        if self.store is not None:
            self.store.record_publish(entry, max_rows=self.max_rows)
        self.zoo.publish(entry)
        return entry

    def warmup_entry(self, entry: ZooEntry) -> int:
        """Dispatch one zero-weight batch per (rows, width) bucket the
        entry can produce (the first builds the kernels). Returns the
        bucket count."""
        widths = entry.widths()
        cols = entry.serveable_cols()
        if not widths or cols.size == 0:
            raise ValueError(
                f"universe {entry.universe!r}: no serveable months (no "
                "month has an eligible cross-section under this panel/"
                "window) — nothing to warm, nothing to serve")
        ladder = buckets.rows_ladder(self.max_rows)
        t0 = int(cols[0])
        with telemetry.span("serve_warmup", cat="serve",
                            universe=entry.universe,
                            buckets=len(widths) * len(ladder)):
            for width in widths:
                for rows in ladder:
                    entry.score(np.zeros((rows, width), np.int32),
                                np.full((rows,), t0, np.int32),
                                np.zeros((rows, width), np.float32))
        return len(widths) * len(ladder)

    #: Cap on the months scored for a publish-time reference sketch
    #: (evenly spread across the serveable range).
    REFERENCE_MONTH_CAP = 32

    def _stamp_reference(self, entry: ZooEntry) -> None:
        """Score-drift reference at publish: score an even spread of the
        entry's serveable months in batcher-shaped buckets and stamp the
        distribution sketch into the entry; served scores then stream
        into its live twin and the monitor's PSI compares the two. Exact
        no-op when ``LFM_METRICS=0`` or ``LFM_DRIFT_MAX <= 0``."""
        if not (metrics.enabled() and metrics.drift_max_default() > 0):
            return
        cols = sorted(entry._month_index.values())
        if not cols:
            return
        cap = self.REFERENCE_MONTH_CAP
        if len(cols) > cap:
            step = (len(cols) - 1) / (cap - 1)
            cols = sorted({cols[int(round(i * step))] for i in range(cap)})
        by_width: Dict[int, List[Any]] = {}
        for t in cols:
            pool = entry.pool(t)
            if pool.size == 0:
                continue
            by_width.setdefault(
                buckets.bucket_width(pool.size), []).append((t, pool))
        chunk_scores: List[np.ndarray] = []
        with telemetry.span("drift_reference", cat="serve",
                            universe=entry.universe,
                            generation=entry.generation,
                            months=sum(len(v) for v in by_width.values())):
            for width, items in sorted(by_width.items()):
                for k in range(0, len(items), self.max_rows):
                    chunk = items[k:k + self.max_rows]
                    rows = buckets.bucket_rows(len(chunk), self.max_rows)
                    fi = np.zeros((rows, width), np.int32)
                    ti = np.zeros((rows,), np.int32)
                    w = np.zeros((rows, width), np.float32)
                    for i, (t, pool) in enumerate(chunk):
                        fi[i, :pool.size] = pool
                        fi[i, pool.size:] = pool[-1]
                        ti[i] = t
                        w[i, :pool.size] = 1.0
                    for i in range(len(chunk), rows):
                        fi[i], ti[i] = fi[0], ti[0]
                    out = entry.score(fi, ti, w)
                    for i, (_, pool) in enumerate(chunk):
                        chunk_scores.append(out[i, :pool.size])
        if not chunk_scores:
            return
        try:
            entry.stamp_reference(metrics.ScoreSketch.reference(
                np.concatenate(chunk_scores)))
        except ValueError:
            import warnings

            warnings.warn(
                f"universe {entry.universe!r} gen {entry.generation}: "
                "no finite scores — drift reference not stamped (the "
                "drift gauge stays inactive for this generation)",
                RuntimeWarning, stacklevel=2)

    # ---- query path --------------------------------------------------

    def submit(self, universe: str, month: int,
               deadline_ms: Optional[float] = None,
               request_id: Optional[str] = None) -> Future:
        """Async query: a Future of a :class:`ScoreResponse`.
        ``deadline_ms`` bounds how long the request may wait — past it
        the batcher drops it before dispatch (DeadlineError).
        ``request_id`` propagates an inbound trace id; None mints one —
        the response echoes it either way."""
        return self.batcher.submit(universe, month, deadline_ms=deadline_ms,
                                   request_id=request_id)

    def score(self, universe: str, month: int,
              timeout: Optional[float] = 60.0,
              request_id: Optional[str] = None) -> ScoreResponse:
        """Sync query: the month's scored cross-section. The client
        ``timeout`` propagates into the batcher as the request deadline,
        so a request this caller has given up on is dropped instead of
        costing a dispatch."""
        return self.batcher.submit(
            universe, month,
            deadline_ms=None if timeout is None else timeout * 1e3,
            request_id=request_id,
        ).result(timeout=timeout)

    def serveable_months(self, universe: str) -> List[int]:
        return self.zoo.current(universe).serveable_months()

    # ---- refresh -----------------------------------------------------

    def refresh(self, universe: str, splits: Any,
                epochs: Optional[int] = None) -> ZooEntry:
        """Monthly data arrival: warm single-fold retrain + atomic swap.

        Checks the drift gate, builds ``Trainer(cfg, splits,
        run_dir=None)`` on the service's device, fits it from a COPY of
        the served generation's params (``epochs`` overrides the
        config's), warms the new entry, stamps its drift reference and
        publishes it. Serving continues throughout: the old generation
        handles traffic until the publish, then drains. Returns the new
        entry."""
        with self._refresh_lock:
            cur = self.zoo.current(universe)
            self.monitor.check_publish_gate(universe)
            cfg = cur.cfg
            if epochs is not None:
                cfg = dataclasses.replace(
                    cfg, optim=dataclasses.replace(cfg.optim, epochs=epochs))
            predictor = cur.predictor
            if predictor is None:
                raise KeyError(f"universe {universe!r}: generation "
                               f"{cur.generation} was decommissioned")
            with torch.no_grad():
                init = {k: p.detach().clone() for k, p in
                        flax_param_map(predictor.model).items()}
            with telemetry.span("serve_refresh", cat="serve",
                                universe=universe,
                                generation=cur.generation + 1) as sp:
                trainer = Trainer(cfg, splits, run_dir=None,
                                  device=self.device)
                fit = trainer.fit(init_params=init)
                trainer.model.eval()
                sp.set(epochs_run=fit["epochs_run"],
                       best_val_ic=fit["best_val_ic"])
                entry = ZooEntry(universe, cur.generation + 1, trainer)
                self.warmup_entry(entry)
                self._stamp_reference(entry)
                if self.store is not None:
                    self.store.record_publish(entry,
                                              max_rows=self.max_rows)
                self.zoo.publish(entry)
            return entry

    # ---- durable restore / in-process recovery -----------------------

    def _from_store(self, warm: bool, only_newer: bool):
        """The store's restore into this service, and the nvcc builds
        and panel uploads it caused."""
        if self.store is None:
            raise RuntimeError(
                "restore() and sync_from_store() need a durable store — "
                "pass persist_dir= or set LFM_ZOO_PERSIST to the store "
                "directory")
        snap = telemetry.COUNTERS.snapshot()
        out = self.store.restore_into(self, warm=warm,
                                      only_newer=only_newer)
        d = telemetry.COUNTERS.delta(snap)
        return out, int(d.get("kernel_builds", 0)), int(
            d.get("panel_transfers", 0))

    def restore(self, warm: bool = True) -> List[Dict[str, Any]]:
        """Stand the service up from the durable store: every committed
        universe re-registered, verified (panel hash, params checksum,
        the probe month bitwise equal to the publish-time probe), warmed,
        its drift reference re-stamped. Returns one info dict per
        restored universe; a snapshot that fails verification is
        quarantined and its universe falls back to an older generation
        or to nothing (a fresh retrain), never to wrong numbers."""
        out, builds, h2d = self._from_store(warm, only_newer=False)
        self.last_restore = out
        self.last_restore_compiles = builds
        self.last_restore_panel_h2d = h2d
        return out

    def sync_from_store(self) -> List[Dict[str, Any]]:
        """A fleet's publish propagation: pull every generation the store
        committed BEYOND what this service serves (the manifest's
        generation is the fence), verified like a restore. Universes at
        the fence are untouched; returns the adopted generations, and
        folds their cost into the ``last_restore*`` fields."""
        out, builds, h2d = self._from_store(True, only_newer=True)
        self.last_restore = (self.last_restore or []) + out
        self.last_restore_compiles = (self.last_restore_compiles or 0) + builds
        self.last_restore_panel_h2d = (self.last_restore_panel_h2d or 0) + h2d
        return out

    # ---- in-process recovery -----------------------------------------

    def restart_batcher(self) -> Dict[str, Any]:
        """In-process recovery for the ``BatcherDeadError`` path: replace
        the batcher thread with a fresh one, same knobs, zoo and
        generations untouched, rolling stats carried over. Pending
        submits were already failed by the death guard, or are failed by
        ``close()`` here when a live batcher is restarted."""
        old = self.batcher
        was_dead = old._dead is not None
        old.close()
        nb = MicroBatcher(
            self.zoo, self.max_rows, old.max_wait_s * 1e3,
            queue_max=old.queue_max,
            deadline_ms=old.default_deadline_s * 1e3,
            retries=old.retries,
            breaker_threshold=old._breaker_threshold,
            breaker_cooldown_ms=old._breaker_cooldown_s * 1e3)
        nb.carry_stats(old)
        nb.incidents = self.incidents
        self.batcher = nb
        telemetry.COUNTERS.set("serve_batcher_dead", 0)
        telemetry.COUNTERS.bump("serve_batcher_restarts")
        telemetry.instant("batcher_restarted", cat="serve",
                          was_dead=was_dead)
        return {"ok": True, "was_dead": was_dead,
                "restarts": telemetry.COUNTERS.get(
                    "serve_batcher_restarts")}

    # ---- observability / lifecycle -----------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """One consistent observability snapshot: ``{ts, stats,
        health}``, each built from a single locked read of the structure
        that owns it; ``/stats`` and ``/healthz`` share one call and
        carry the same ``ts``."""
        ts = time.time()
        stats = self.batcher.stats()
        zsnap = self.zoo.snapshot()
        stats["ts"] = ts
        info = telemetry.build_info()
        stats["member"] = {"host": info.get("host"),
                           "pid": info.get("pid")}
        stats["device"] = str(self.device)
        stats["universes"] = zsnap["universes"]
        stats["zoo_size"] = zsnap["size"]
        stats["zoo_capacity"] = zsnap["capacity"]
        stats["incidents"] = {
            "captured": self.incidents.captured,
            "suppressed": self.incidents.suppressed,
        }
        health = self.batcher.health()
        health["ts"] = ts
        health["zoo_size"] = zsnap["size"]
        if metrics.enabled():
            # SLO / drift detail: operator alerts; readiness (the 503
            # path) stays owned by the batcher and its breaker.
            slo = slo_status()
            drift = self.monitor.drift_status()
            health["slo"] = {"burning": slo["burning"],
                             "max_burn": slo["max_burn"],
                             "objectives": slo["objectives"]}
            health["drift"] = {"breached": drift["breached"],
                               "threshold": drift["threshold"],
                               "universes": drift["universes"]}
        return {"ts": ts, "stats": stats, "health": health}

    def stats(self) -> Dict[str, Any]:
        """Requests served, req/s over the stats window, p50/p99 latency,
        batch occupancy, the degradation tallies and the routing table
        (one :meth:`snapshot` view)."""
        return self.snapshot()["stats"]

    def health(self) -> Dict[str, Any]:
        """Readiness: not ready, with the reason, when the batcher thread
        is dead or the circuit is open (``retry_after_s`` carries the
        remaining cooldown); SLO-burn and drift detail ride along."""
        return self.snapshot()["health"]

    def metrics_snapshot(self) -> Dict[str, Any]:
        """The live metrics plane as JSON (serve/monitor.py); the
        Prometheus text twin is :meth:`metrics_text`."""
        return self.monitor.snapshot()

    def metrics_text(self, ts: Optional[float] = None) -> str:
        """The ``GET /metrics`` document (Prometheus text format 0.0.4):
        the instrument registry plus ``telemetry.COUNTERS``."""
        return self.monitor.metrics_text(ts=ts)

    def reset_stats(self) -> None:
        self.batcher.reset_stats()

    def close(self) -> None:
        self.batcher.close()
        # A capture racing shutdown finishes its bundle (bounded).
        self.incidents.wait(timeout=5.0)

    def __enter__(self) -> "ScoringService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
