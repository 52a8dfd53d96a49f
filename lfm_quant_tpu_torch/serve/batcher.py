"""Request micro-batcher: coalesce concurrent queries into one dispatch.

Port of ``lfm_quant_tpu/serve/batcher.py``, degradation layer and
request tracing included. N concurrent requests for one universe are ONE
``[rows, width]`` scoring dispatch: the batcher thread pops the queue,
coalesces requests with the same ``(universe, width bucket)`` for at
most ``max_wait_ms`` or until ``max_rows``, pads them to the
request-shape bucket and scores them through the zoo entry on the card
(the gather kernel and the fused recurrence). Padding is the JAX
package's: pad columns repeat ``pool[-1]`` at weight 0, pad rows repeat
row 0, and the entry zeroes every weight-0 slot. Each dispatch takes ONE
device→host copy of its scores, here, counted as ``serve_d2h``: the
drift sketch, the responses and the metrics read host arrays only.

Graceful degradation (every path drivable on demand through the
``serve_dispatch`` and ``zoo_lease`` fault sites, utils/faults.py):

* **Bounded admission** — the queue is capped at ``LFM_SERVE_QUEUE_MAX``;
  a submit over the cap is SHED in O(1) (:class:`ShedError`, HTTP 429).
* **Deadlines** — each request carries a deadline (explicit per call,
  else ``LFM_SERVE_DEADLINE_MS``; ``ScoringService.score`` propagates
  its client timeout). Expired or client-cancelled requests are dropped
  BEFORE dispatch (:class:`DeadlineError`, HTTP 504): no kernel runs
  for them.
* **Bounded jittered retry** — a TRANSIENT dispatch failure
  (serve/errors.py ``is_transient``) re-dispatches the surviving batch
  on the same kernels up to ``LFM_SERVE_RETRIES`` times with capped
  exponential backoff; deadlines are re-checked before every retry. A
  failed dispatch never falls back to the plain path.
* **Circuit breaker** — ``LFM_SERVE_BREAKER`` consecutive exhausted
  dispatch failures OPEN the circuit: submits fast-fail
  (:class:`CircuitOpenError`, HTTP 503 + retry-after) for
  ``LFM_SERVE_BREAKER_COOLDOWN_MS``, then a half-open probe admits
  traffic again — one success closes the circuit, one failure re-opens
  it. Transitions emit ``circuit_open``/``circuit_half_open``/
  ``circuit_closed`` instants and the ``circuit_state`` gauge
  (0 closed / 1 half-open / 2 open).
* **Thread-death guard** — if the batcher thread dies OUTSIDE the
  per-batch failure path, every pending future fails loudly
  (:class:`BatcherDeadError`), later submits fail fast, and
  :meth:`health` reports unready.

Request tracing: every request carries a 32-hex trace id (minted here or
propagated from the front door's ``X-Request-Id``/``traceparent``) and a
queue/batch/retry/dispatch phase breakdown from host stamps around the
dispatch; ``dispatch_ms`` ends after the scores' device→host copy, where
the host waits for the card. Every request is an async ``serve_request``
span, every dispatch a sync ``serve_batch`` span; counters
``serve_requests`` / ``serve_batches`` / ``serve_rows`` /
``serve_rows_real`` / ``serve_queue_peak`` / ``serve_d2h`` and the
degradation set ``serve_shed`` / ``serve_deadline_drops`` /
``serve_retries`` / ``serve_breaker_opens`` / ``circuit_state`` feed the
run record (``scripts/trace_report.py``'s serve section).
"""

from __future__ import annotations

import heapq
import random
import threading
import time
import uuid
import warnings
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from lfm_quant_tpu_torch.serve.buckets import (
    breaker_cooldown_ms_default,
    breaker_threshold_default,
    bucket_rows,
    bucket_width,
    deadline_ms_default,
    queue_max_default,
    retries_default,
)
from lfm_quant_tpu_torch.serve.errors import (
    BatcherDeadError,
    CircuitOpenError,
    DeadlineError,
    ServiceClosedError,
    ShedError,
    is_transient,
)
from lfm_quant_tpu_torch.serve.stats import latency_summary
from lfm_quant_tpu_torch.serve.zoo import ModelZoo
from lfm_quant_tpu_torch.utils import faults, flight, metrics, telemetry


def new_request_id() -> str:
    """A fresh 32-hex trace id (W3C ``traceparent`` trace-id width, so
    an id minted here propagates cleanly into any tracing fabric)."""
    return uuid.uuid4().hex


def backoff_sleep(attempt: int) -> None:
    """Capped exponential backoff with full jitter, bounded at 50 ms
    so a retry burst can never stall its caller past a deadline's
    resolution."""
    time.sleep(min(0.05, 0.002 * (2 ** (attempt - 1)))
               * (0.5 + random.random()))


def clean_request_id(rid: Optional[str]) -> Optional[str]:
    """Sanitize an INBOUND id (header-sourced — hostile by default):
    keep it opaque but bounded and log-line-safe. None/empty → None
    (the caller mints one)."""
    if not rid:
        return None
    # Pre-truncate BEFORE the per-character filter: header values can
    # be tens of KB, and the filter must not scan all of it per request.
    rid = "".join(c for c in str(rid).strip()[:256]
                  if c.isalnum() or c in "-_.")[:64]
    return rid or None


class ScoreResponse(NamedTuple):
    """One served query: the month's eligible firms and their scores.

    ``firm_idx`` are panel rows (int32) in pool order; ``scores`` the
    matching float32 forecasts — the ranking signal a client trades on.
    ``generation`` tags which zoo generation served it (every response
    is entirely one generation's — the no-torn-request contract).
    """

    universe: str
    month: int
    generation: int
    firm_idx: np.ndarray
    scores: np.ndarray
    latency_ms: float
    #: Request-scoped trace id: minted at submit or
    #: propagated from the caller's X-Request-Id / traceparent header —
    #: the same id the serve_request span, the access log, the slow-
    #: trace tracker and the histogram exemplars all carry.
    request_id: str = ""
    #: The per-request phase breakdown (ms): queue_ms (submit → joined
    #: a batch), batch_ms (coalescing-window wait), dispatch_ms (the
    #: successful device attempt), retry_ms (failed attempts+backoff),
    #: retries (count). Recorded O(1) from perf_counter stamps.
    phases: Optional[Dict[str, Any]] = None


class _Request:
    __slots__ = ("universe", "month", "width", "future", "t_submit",
                 "span", "deadline", "rid", "t_batched", "t_dispatch0",
                 "t_dispatch", "retries")

    def __init__(self, universe: str, month: int, width: int,
                 future: Future, span, deadline: Optional[float],
                 rid: str):
        self.universe = universe
        self.month = month
        self.width = width
        self.future = future
        self.t_submit = time.perf_counter()
        self.span = span
        self.deadline = deadline  # absolute perf_counter seconds, or None
        self.rid = rid
        # Phase stamps (perf_counter): set as the request moves through
        # the pipeline — queue pop, first dispatch attempt, last
        # dispatch attempt. O(1) per request, no allocation.
        self.t_batched: Optional[float] = None
        self.t_dispatch0: Optional[float] = None
        self.t_dispatch: Optional[float] = None
        self.retries = 0

    def phase_breakdown(self, t_done: float) -> Dict[str, Any]:
        """The queue/batch/dispatch/retry split of this request's
        latency, in ms. Stamps missing on early-failed
        requests degrade to the last known boundary, so the phases
        always sum to ~latency."""
        tb = self.t_batched if self.t_batched is not None else t_done
        td0 = self.t_dispatch0 if self.t_dispatch0 is not None else t_done
        td = self.t_dispatch if self.t_dispatch is not None else td0
        return {
            "queue_ms": round(max(0.0, tb - self.t_submit) * 1e3, 3),
            "batch_ms": round(max(0.0, td0 - tb) * 1e3, 3),
            "retry_ms": round(max(0.0, td - td0) * 1e3, 3),
            "dispatch_ms": round(max(0.0, t_done - td) * 1e3, 3),
            "retries": self.retries,
        }


class MicroBatcher:
    """The queue + batcher thread. One instance per ScoringService."""

    #: How many slowest request traces the rolling tracker keeps (the
    #: incident bundles' ``slow_requests.json`` and the trace_report
    #: waterfall's depth). Bounded heap: O(log K) per completion.
    SLOW_TRACES_K = 16

    def __init__(self, zoo: ModelZoo, max_rows: int, max_wait_ms: float,
                 latency_window: int = 65536,
                 queue_max: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 retries: Optional[int] = None,
                 breaker_threshold: Optional[int] = None,
                 breaker_cooldown_ms: Optional[float] = None):
        self.zoo = zoo
        self.max_rows = max(1, int(max_rows))
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        # Degradation knobs: explicit ctor values win (tests, scripts),
        # else the LFM_SERVE_* env defaults (serve/buckets.py).
        self.queue_max = int(queue_max if queue_max is not None
                             else queue_max_default())
        self.default_deadline_s = float(
            deadline_ms if deadline_ms is not None
            else deadline_ms_default()) / 1e3
        self.retries = max(0, int(retries if retries is not None
                                  else retries_default()))
        self._breaker_threshold = int(
            breaker_threshold if breaker_threshold is not None
            else breaker_threshold_default())
        self._breaker_cooldown_s = max(0.0, float(
            breaker_cooldown_ms if breaker_cooldown_ms is not None
            else breaker_cooldown_ms_default())) / 1e3
        self._queue: "deque[_Request]" = deque()
        self._cv = threading.Condition()
        self._stop = False
        # Breaker / death state (guarded by _cv; _dead is also read
        # lock-free on the submit fast path — a benign GIL-atomic read).
        self._circuit = "closed"  # closed | half_open | open
        self._fail_streak = 0
        self._open_until = 0.0
        self._dead: Optional[BaseException] = None
        self._stats_lock = threading.Lock()
        self._lat_ms: "deque[float]" = deque(maxlen=max(1, latency_window))
        # The K slowest completed request traces since the last stats
        # reset (a bounded min-heap — O(log K) per completion, keyed on
        # latency with a monotone tiebreak so trace dicts never
        # compare): the incident bundles' slow-request evidence and the
        # trace_report waterfall's cross-check anchor.
        self._slow: List[Tuple[float, int, Dict[str, Any]]] = []
        self._slow_seq = 0
        # Incident hook (serve/incident.py): set by ScoringService; a
        # breaker OPEN transition triggers an automatic capture. Plain
        # attribute read on the failure path — never on the hot path.
        self.incidents: Optional[Any] = None
        self._rows = 0
        self._rows_real = 0
        self._batches = 0
        self._requests = 0
        self._errors = 0
        self._rejects = 0
        self._queue_peak = 0
        self._shed = 0
        self._deadline_drops = 0
        self._retry_count = 0
        self._breaker_opens = 0
        self._t_window = time.perf_counter()
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-batcher", daemon=True)
        self._thread.start()

    # ---- client side -------------------------------------------------

    def submit(self, universe: str, month: int,
               deadline_ms: Optional[float] = None,
               request_id: Optional[str] = None) -> Future:
        """Enqueue one scoring query; the Future resolves to a
        :class:`ScoreResponse` (or raises the routing/validation/
        degradation error). Validation that only needs the ROUTING
        table happens here so a bad request fails fast without
        occupying the batcher; admission control (dead batcher, open
        circuit, full queue) fails fast the same way. ``deadline_ms``
        (else ``LFM_SERVE_DEADLINE_MS``; 0/None = none) bounds how long
        the request may wait — past it the batcher DROPS it before
        dispatch. ``request_id`` propagates a caller-supplied trace id
        (the front door's X-Request-Id / traceparent header); None
        mints a fresh one — either way the id rides the span, the
        response, the access log and the exemplars."""
        rid = clean_request_id(request_id) or new_request_id()
        future: Future = Future()
        dead = self._dead
        if dead is not None:
            future.set_exception(BatcherDeadError(dead))
            return future
        now = time.perf_counter()
        with self._cv:
            state, ticked = self._circuit_tick_locked(now)
            open_until = self._open_until
        if ticked:
            self._emit_half_open()
        if state == "open":
            telemetry.COUNTERS.bump("serve_circuit_rejects")
            metrics.METRICS.mark("serve_err")
            future.set_exception(CircuitOpenError(open_until - now))
            return future
        try:
            entry = self.zoo.current(universe)  # KeyError → unregistered
            t = entry.month_col(month)
            n_firms = entry.pool_size(t)  # memoized — no pool copy here
            width = bucket_width(n_firms)
        except Exception as e:  # noqa: BLE001 — routed to the caller
            future.set_exception(e)
            return future
        if deadline_ms is None:
            deadline_ms = self.default_deadline_s * 1e3
        deadline = (now + deadline_ms / 1e3
                    if deadline_ms and deadline_ms > 0 else None)
        span = telemetry.begin_async("serve_request", cat="serve",
                                     universe=universe, month=int(month),
                                     n_firms=int(n_firms),
                                     request_id=rid)
        req = _Request(universe, int(month), width, future, span, deadline,
                       rid)
        shed = False
        with self._cv:
            if self._dead is not None:
                span.end(error="unready")
                future.set_exception(BatcherDeadError(self._dead))
                return future
            if self._stop:
                span.end(error="closed")
                future.set_exception(
                    ServiceClosedError("scoring service is closed"))
                return future
            if 0 < self.queue_max <= len(self._queue):
                shed = True
            else:
                self._queue.append(req)
                depth = len(self._queue)
                self._cv.notify()
        if shed:
            span.end(error="shed")
            telemetry.COUNTERS.bump("serve_shed")
            metrics.METRICS.mark("serve_err")  # availability budget
            # Dedicated shed ring: the incident layer's shed-rate-spike
            # trigger reads it (serve/monitor.py) — serve_err blends
            # sheds with dispatch errors and deadline drops.
            metrics.METRICS.mark("serve_shed")
            flight.record("shed", universe=universe, month=int(month),
                          request_id=rid, queue_max=self.queue_max)
            with self._stats_lock:
                self._shed += 1
            future.set_exception(ShedError(self.queue_max))
            return future
        telemetry.COUNTERS.bump("serve_requests")
        telemetry.COUNTERS.peak("serve_queue_peak", depth)
        with self._stats_lock:
            if depth > self._queue_peak:
                self._queue_peak = depth
        return future

    # ---- circuit breaker ---------------------------------------------

    def _circuit_tick_locked(self, now: float) -> Tuple[str, bool]:
        """Advance the breaker clock (caller holds ``_cv``): an OPEN
        circuit whose cooldown elapsed becomes HALF-OPEN — admission
        resumes and the next dispatch outcome decides. Returns
        ``(state, transitioned)``; the CALLER emits the transition
        telemetry after releasing the lock (the zoo.lease convention —
        an instant's trace write must never run under the admission
        lock every submit contends on)."""
        if self._circuit == "open" and now >= self._open_until:
            self._circuit = "half_open"
            return "half_open", True
        return self._circuit, False

    @staticmethod
    def _emit_half_open() -> None:
        telemetry.COUNTERS.set("circuit_state", 1)
        telemetry.instant("circuit_half_open", cat="serve")

    def _dispatch_ok(self) -> None:
        with self._cv:
            self._fail_streak = 0
            reclosed = self._circuit != "closed"
            self._circuit = "closed"
        if reclosed:
            telemetry.COUNTERS.set("circuit_state", 0)
            telemetry.instant("circuit_closed", cat="serve")

    def _dispatch_fail(self) -> None:
        """One exhausted dispatch (retries included) failed: advance the
        streak; at the threshold — or instantly in half-open (the probe
        failed) — OPEN the circuit for the cooldown."""
        opened = False
        with self._cv:
            self._fail_streak += 1
            streak = self._fail_streak
            if self._breaker_threshold > 0 and (
                    self._circuit == "half_open"
                    or streak >= self._breaker_threshold):
                opened = self._circuit != "open"
                self._circuit = "open"
                self._open_until = (time.perf_counter()
                                    + self._breaker_cooldown_s)
        if opened:
            telemetry.COUNTERS.set("circuit_state", 2)
            telemetry.COUNTERS.bump("serve_breaker_opens")
            telemetry.instant("circuit_open", cat="serve", streak=streak)
            with self._stats_lock:
                self._breaker_opens += 1
            # Automatic incident capture: the breaker
            # opening IS the degradation moment — snapshot the evidence
            # (flight ring, scrape, slow traces) before it scrolls
            # away. The capture runs on its own thread; this is one
            # attribute read + a rate-limited trigger call.
            inc = self.incidents
            if inc is not None:
                inc.trigger("breaker_open", streak=streak)

    # ---- batcher thread ----------------------------------------------

    def _loop(self) -> None:
        try:
            while True:
                batch = self._next_batch()
                if batch is None:
                    return
                try:
                    self._dispatch(batch)
                except Exception as e:  # noqa: BLE001 — the loop survives
                    with self._stats_lock:
                        self._errors += 1
                    failed = 0
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(e)
                            failed += 1
                        r.span.end(error=type(e).__name__)
                    if failed:
                        metrics.METRICS.mark("serve_err", float(failed))
        except BaseException as e:  # noqa: BLE001 — death guard
            # The loop died OUTSIDE the per-batch failure path (e.g.
            # _next_batch raising): without this guard every pending and
            # future submit hangs until client timeout.
            self._die(e)
            raise

    def _die(self, exc: BaseException) -> None:
        """Batcher-thread death: fail pending futures LOUDLY, mark the
        service unready (submits fast-fail, /healthz goes 503)."""
        with self._cv:
            self._dead = exc
            pending = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        telemetry.COUNTERS.set("serve_batcher_dead", 1)
        telemetry.instant("batcher_died", cat="serve",
                          error=type(exc).__name__)
        warnings.warn(
            f"serve batcher thread died: {type(exc).__name__}: {exc} — "
            f"failing {len(pending)} pending request(s); the service is "
            "unready until restarted", RuntimeWarning, stacklevel=2)
        for r in pending:
            if not r.future.done():
                r.future.set_exception(BatcherDeadError(exc))
            r.span.end(error="batcher_dead")

    def _next_batch(self) -> Optional[List[_Request]]:
        """Pop the head request, then coalesce same-(universe, width)
        requests until ``max_rows`` or the ``max_wait_ms`` window closes.
        Non-matching requests stay queued in order for the next batch."""
        with self._cv:
            while not self._queue:
                if self._stop:
                    return None
                self._cv.wait(0.05)
            first = self._queue.popleft()
            first.t_batched = time.perf_counter()
            key = (first.universe, first.width)
            batch = [first]
            deadline = first.t_batched + self.max_wait_s
            while len(batch) < self.max_rows:
                matched = False
                for i, r in enumerate(self._queue):
                    if (r.universe, r.width) == key:
                        del self._queue[i]
                        r.t_batched = time.perf_counter()
                        batch.append(r)
                        matched = True
                        break
                if matched:
                    continue
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or self._stop:
                    break
                self._cv.wait(remaining)
                if not self._queue and self._stop:
                    break
            telemetry.COUNTERS.set("serve_queue_depth", len(self._queue))
            return batch

    def _reap(self, batch: List[_Request]) -> List[_Request]:
        """Drop expired / client-abandoned requests BEFORE they cost a
        device dispatch (the deadline contract — run again before every
        retry, since backoff consumes deadline budget too)."""
        now = time.perf_counter()
        live: List[_Request] = []
        dropped = 0
        for r in batch:
            if r.future.cancelled():
                r.span.end(error="abandoned")
                dropped += 1
                continue
            if r.future.done():
                continue  # already routed (validation failure)
            if r.deadline is not None and now >= r.deadline:
                r.span.end(error="deadline", **r.phase_breakdown(now))
                flight.record("deadline_drop", universe=r.universe,
                              month=r.month, request_id=r.rid,
                              overdue_ms=round((now - r.deadline) * 1e3, 3))
                r.future.set_exception(
                    DeadlineError(r.universe, r.month, now - r.deadline))
                dropped += 1
                continue
            live.append(r)
        if dropped:
            telemetry.COUNTERS.bump("serve_deadline_drops", dropped)
            metrics.METRICS.mark("serve_err", float(dropped))
            with self._stats_lock:
                self._deadline_drops += dropped
        return live

    def _dispatch(self, batch: List[_Request]) -> None:
        """Dispatch with bounded jittered retry: a TRANSIENT failure
        (serve/errors.py ``is_transient`` — injected transient faults,
        the card out of memory) re-dispatches the SURVIVING batch on the
        same kernels
        (deadlines re-checked) up to ``self.retries`` times; permanent
        failures and exhaustion fail the batch and feed the breaker."""
        universe = batch[0].universe
        attempt = 0
        while True:
            batch = self._reap(batch)
            if not batch:
                return
            try:
                self._dispatch_once(universe, batch)
                return
            except Exception as e:  # noqa: BLE001 — classified below
                batch = [r for r in batch if not r.future.done()]
                if (not is_transient(e) or attempt >= self.retries
                        or self._stop):
                    self._dispatch_fail()
                    flight.record("dispatch_fail", universe=universe,
                                  rows=len(batch), attempt=attempt,
                                  error=type(e).__name__)
                    raise
                attempt += 1
                for r in batch:
                    r.retries += 1
                telemetry.COUNTERS.bump("serve_retries")
                flight.record("retry", universe=universe,
                              rows=len(batch), attempt=attempt,
                              error=type(e).__name__)
                with self._stats_lock:
                    self._retry_count += 1
                backoff_sleep(attempt)

    def _dispatch_once(self, universe: str, batch: List[_Request]) -> None:
        # Phase stamps (O(1) per request): first attempt fixes the end
        # of the coalescing wait, the last attempt anchors dispatch_ms
        # — the gap between the two is retry_ms (failed attempts plus
        # backoff). Stamped BEFORE the fault site: an injected failure
        # is part of the attempt it fails.
        t_attempt = time.perf_counter()
        for r in batch:
            if r.t_dispatch0 is None:
                r.t_dispatch0 = t_attempt
            r.t_dispatch = t_attempt
        faults.check("serve_dispatch", universe=universe,
                     rows=len(batch))
        with self.zoo.lease(universe) as entry:
            # Per-request validation against the LEASED entry: a request
            # validated at submit against an older generation can be
            # stale by dispatch (a refresh changed the serveable set).
            # Only the stale request fails — its coalesced neighbors
            # must not be poisoned by someone else's KeyError.
            live: List[_Request] = []
            pools = []
            for r in batch:
                try:
                    t = entry.month_col(r.month)
                    pool = entry.pool(t)
                except Exception as e:  # noqa: BLE001 — per-request fate
                    r.span.end(error=type(e).__name__)
                    r.future.set_exception(e)
                    with self._stats_lock:
                        self._rejects += 1
                    continue
                live.append(r)
                pools.append((t, pool))
            batch = live
            if not batch:
                return
            rows = bucket_rows(len(batch), self.max_rows)
            # The width comes from the LEASED entry's pools, the truth
            # this response is built from (a generation swap between
            # submit and dispatch can change pool sizes either way).
            width = bucket_width(max(p.size for _, p in pools))
            fi = np.zeros((rows, width), np.int32)
            ti = np.zeros((rows,), np.int32)
            w = np.zeros((rows, width), np.float32)
            for i, (t, pool) in enumerate(pools):
                fi[i, :pool.size] = pool
                fi[i, pool.size:] = pool[-1] if pool.size else 0
                ti[i] = t
                w[i, :pool.size] = 1.0
            # Padded rows repeat row 0 at weight 0 (same scheme as the
            # eval sweep's thin dates — shapes static, outputs masked).
            for i in range(len(batch), rows):
                fi[i], ti[i] = fi[0], ti[0]
            occupancy = len(batch) / rows
            with telemetry.span("serve_batch", cat="serve",
                                universe=universe, generation=entry.generation,
                                rows=rows, rows_real=len(batch),
                                width=width, occupancy=round(occupancy, 4),
                                queue_depth=len(self._queue)):
                # The one device→host copy of the dispatch: the host
                # waits here for the kernels, so dispatch_ms ends after
                # it.
                out = entry.score_device(fi, ti, w).cpu().numpy()
                telemetry.COUNTERS.bump("serve_d2h")
            # Success bookkeeping BEFORE the futures resolve: a client
            # woken by its result must observe the breaker already
            # reset/closed (health() right after a successful probe).
            self._dispatch_ok()
            t_done = time.perf_counter()
            gen = entry.generation
        lats = []
        score_slices = []
        slow_items = []
        for i, r in enumerate(batch):
            pool = pools[i][1]
            lat = round((t_done - r.t_submit) * 1e3, 3)
            lats.append(lat)
            scores = out[i, :pool.size].copy()
            score_slices.append(scores)
            # The per-request causal trail: where the
            # latency went — queue, coalescing window, retries,
            # dispatch — echoed in the span (trace_report's waterfall),
            # the response (the client/access log) and the slow-trace
            # tracker (incident bundles).
            phases = r.phase_breakdown(t_done)
            phases["width"] = width  # the bucket that served it
            slow_items.append({
                "request_id": r.rid, "universe": universe,
                "month": r.month, "rows": rows,
                "generation": gen, "latency_ms": lat, **phases})
            r.span.end(latency_ms=lat, generation=gen,
                       request_id=r.rid, **phases)
            r.future.set_result(ScoreResponse(
                universe=universe, month=r.month, generation=gen,
                firm_idx=pool, scores=scores, latency_ms=lat,
                request_id=r.rid, phases=phases))
        # Live metrics plane (utils/metrics.py): O(1)
        # per event, lock-guarded inside each instrument, exact no-op
        # under LFM_METRICS=0. Latency attributed per (universe,
        # width-bucket) — the Khomenko-style request stream means a
        # bucket-ladder regression must be visible per bucket, not
        # blended away — plus the SLO rings and the drift sketch (the
        # served scores are already host arrays; nothing here touches
        # the device).
        if metrics.enabled():
            m = metrics.METRICS
            # One label-set resolution per BATCH, then bare records —
            # and no numpy anywhere in this block: numpy calls release
            # the GIL, and a GIL release on this thread under
            # closed-loop contention costs a scheduling quantum.
            hist = m.histogram("serve_latency_ms",
                               universe=universe, width=width)
            for r, lat in zip(batch, lats):
                # Exemplar wiring: each bucket keeps
                # the last trace id that landed in it — O(1), no
                # allocation growth — so a p99 bucket in a scrape
                # points at a REAL request whose phase breakdown is in
                # the slow-trace tracker / span record.
                hist.record(lat, exemplar=r.rid)
            m.mark("serve_ok", float(len(batch)))
            slo_ms = metrics.slo_p99_ms_default()
            if slo_ms > 0:
                bad = sum(1 for lat in lats if lat > slo_ms)
                if bad:
                    m.mark("serve_slo_lat_bad", float(bad))
            # The response-path copies, not views of `out`: a lazy
            # sketch entry pins its base array until a fold, and 256
            # pending views of full (rows × width) batch outputs is
            # tens of MB at large width. The fold re-copies to f64, so
            # sharing with the (read-mostly) client response is safe.
            entry.record_scores(score_slices)
        telemetry.COUNTERS.bump("serve_batches")
        telemetry.COUNTERS.bump("serve_rows", rows)
        telemetry.COUNTERS.bump("serve_rows_real", len(batch))
        flight.record("dispatch", universe=universe, rows=rows,
                      rows_real=len(batch), width=width, generation=gen,
                      ms=round((t_done - t_attempt) * 1e3, 3))
        with self._stats_lock:
            self._lat_ms.extend(lats)
            self._rows += rows
            self._rows_real += len(batch)
            self._batches += 1
            self._requests += len(batch)
            for item in slow_items:
                self._slow_seq += 1
                entry = (item["latency_ms"], self._slow_seq, item)
                if len(self._slow) < self.SLOW_TRACES_K:
                    heapq.heappush(self._slow, entry)
                elif entry[0] > self._slow[0][0]:
                    heapq.heapreplace(self._slow, entry)

    # ---- stats / health / lifecycle ----------------------------------

    def slow_traces(self) -> List[Dict[str, Any]]:
        """The K slowest completed request traces since the last stats
        reset, slowest first — request id, routing, and the full
        queue/batch/retry/dispatch phase breakdown each (the incident
        bundles' slow-request evidence)."""
        with self._stats_lock:
            items = [dict(item) for _, _, item in self._slow]
        return sorted(items, key=lambda d: -d["latency_ms"])

    def queue_depth(self) -> int:
        """Current queue depth (gauge read: a single ``len`` is
        GIL-atomic; staleness by one in-flight submit is the documented
        worst case for cross-thread gauge readers)."""
        return len(self._queue)

    def circuit_state_code(self) -> int:
        """The ``circuit_state`` gauge encoding: 0 closed, 1 half-open, 2 open, 3 batcher dead."""
        if self._dead is not None:
            return 3
        return {"closed": 0, "half_open": 1, "open": 2}.get(
            self._circuit, 0)

    def health(self) -> Dict[str, Any]:
        """Readiness, with the reason when degraded: a dead batcher
        thread or an OPEN circuit is NOT ready (the /healthz 503 path);
        half-open is ready-but-probing. ``retry_after_s`` carries the
        remaining cooldown when open."""
        dead = self._dead
        if dead is not None:
            return {"ok": False, "circuit": "dead",
                    "reason": ("batcher thread dead: "
                               f"{type(dead).__name__}: {dead}")}
        now = time.perf_counter()
        with self._cv:
            if self._stop:
                return {"ok": False, "circuit": self._circuit,
                        "reason": "service closed"}
            state, ticked = self._circuit_tick_locked(now)
            retry = max(0.0, self._open_until - now)
        if ticked:
            self._emit_half_open()
        if state == "open":
            return {"ok": False, "circuit": state,
                    "reason": ("circuit open (consecutive dispatch "
                               "failures); fast-failing until the "
                               "half-open probe"),
                    "retry_after_s": round(retry, 3)}
        return {"ok": True, "circuit": state}

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            lat = list(self._lat_ms)
            rows, real = self._rows, self._rows_real
            out: Dict[str, Any] = {
                "completed": self._requests,
                "batches": self._batches,
                "dispatch_errors": self._errors,
                "rejected": self._rejects,
                "shed": self._shed,
                "deadline_drops": self._deadline_drops,
                "retries": self._retry_count,
                "breaker_opens": self._breaker_opens,
                # THIS batcher's peak (the process-global
                # serve_queue_peak counter spans every instance and is
                # never reset — it feeds the run record, not stats).
                "queue_peak": self._queue_peak,
            }
            window_s = time.perf_counter() - self._t_window
        out["circuit"] = ("dead" if self._dead is not None
                          else self._circuit)
        out["ready"] = self._dead is None and not self._stop
        out["window_s"] = window_s
        out["req_per_s"] = (out["completed"] / window_s if window_s > 0
                            else None)
        out.update(latency_summary(lat))
        # The rolling window bounds memory on long-lived services; past
        # its size the percentiles cover only the newest requests while
        # trace_report covers every span — the flag marks when the
        # "stats == trace_report" cross-check stops being exact.
        out["latency_truncated"] = out["completed"] > len(lat)
        out["mean_occupancy"] = round(real / rows, 4) if rows else None
        out["rows"] = rows
        out["rows_real"] = real
        return out

    def carry_stats(self, other: "MicroBatcher") -> None:
        """Adopt a predecessor batcher's rolling stats — the
        in-process ``restart_batcher`` recovery swaps
        the thread, not the observability: completed counts, latency
        window, degradation tallies and peaks carry over so ``stats()``
        stays continuous across the restart. Both stats locks are
        taken in sequence, never nested (the predecessor is already
        closed — nothing concurrently mutates it)."""
        with other._stats_lock:
            lat = list(other._lat_ms)
            slow = [item for _, _, item in other._slow]
            snap = (other._rows, other._rows_real, other._batches,
                    other._requests, other._errors, other._rejects,
                    other._queue_peak, other._shed,
                    other._deadline_drops, other._retry_count,
                    other._breaker_opens)
        with self._stats_lock:
            self._lat_ms.extend(lat)
            for item in slow:
                self._slow_seq += 1
                entry = (item["latency_ms"], self._slow_seq, item)
                if len(self._slow) < self.SLOW_TRACES_K:
                    heapq.heappush(self._slow, entry)
                elif entry[0] > self._slow[0][0]:
                    heapq.heapreplace(self._slow, entry)
            (rows, real, batches, requests, errors, rejects, peak,
             shed, drops, retries, opens) = snap
            self._rows += rows
            self._rows_real += real
            self._batches += batches
            self._requests += requests
            self._errors += errors
            self._rejects += rejects
            self._queue_peak = max(self._queue_peak, peak)
            self._shed += shed
            self._deadline_drops += drops
            self._retry_count += retries
            self._breaker_opens += opens

    def reset_stats(self) -> None:
        """Zero the rolling stats window (latencies, occupancy, peaks,
        degradation tallies) — the entry point draws the line between
        warmup and the measured steady state with this, so the reported
        percentiles cover exactly the timed window. Circuit STATE is
        not reset — it is live machinery, not a statistic."""
        with self._stats_lock:
            self._lat_ms.clear()
            self._slow.clear()
            self._rows = self._rows_real = 0
            self._batches = self._requests = 0
            self._errors = self._rejects = 0
            self._queue_peak = 0
            self._shed = self._deadline_drops = 0
            self._retry_count = self._breaker_opens = 0
            self._t_window = time.perf_counter()

    def close(self) -> None:
        """Stop the batcher thread; drain the queue by failing pending
        requests loudly (a silent drop would hang clients forever)."""
        with self._cv:
            self._stop = True
            pending = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        for r in pending:
            if not r.future.done():
                r.future.set_exception(ServiceClosedError(
                    "scoring service closed with the request still "
                    "queued"))
            r.span.end(error="closed")
        self._thread.join(timeout=10.0)
