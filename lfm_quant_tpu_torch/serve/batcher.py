"""Request micro-batcher: coalesce concurrent queries into one dispatch.

Port of ``lfm_quant_tpu/serve/batcher.py`` without the degradation layer
(retries, the circuit breaker, shedding and deadlines come with a later
slice, ROADMAP.md Queue A). N concurrent requests for one universe are
ONE ``[rows, width]`` scoring dispatch: the batcher thread pops the
queue, coalesces requests with the same ``(universe, width bucket)`` for
at most ``max_wait_ms`` or until ``max_rows``, pads them to the
request-shape bucket and scores them through the zoo entry. Padding is
the JAX package's: pad columns repeat ``pool[-1]`` at weight 0, pad rows
repeat row 0, and the entry zeroes every weight-0 slot.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from lfm_quant_tpu_torch.serve.buckets import bucket_rows, bucket_width
from lfm_quant_tpu_torch.serve.errors import (
    BatcherDeadError,
    ServiceClosedError,
)
from lfm_quant_tpu_torch.serve.stats import latency_summary
from lfm_quant_tpu_torch.serve.zoo import ModelZoo


class ScoreResponse(NamedTuple):
    """One served query: the month's eligible firms (panel rows, pool
    order) and their float32 scores, tagged with the generation that
    served it (every response is entirely one generation's)."""

    universe: str
    month: int
    generation: int
    firm_idx: np.ndarray
    scores: np.ndarray
    latency_ms: float


class _Request:
    __slots__ = ("universe", "month", "width", "future", "t_submit")

    def __init__(self, universe: str, month: int, width: int,
                 future: Future):
        self.universe = universe
        self.month = month
        self.width = width
        self.future = future
        self.t_submit = time.perf_counter()


class MicroBatcher:
    """The queue + batcher thread. One instance per ScoringService."""

    #: Latencies kept for the percentiles (the newest ones).
    LATENCY_WINDOW = 65536

    def __init__(self, zoo: ModelZoo, max_rows: int, max_wait_ms: float):
        self.zoo = zoo
        self.max_rows = max(1, int(max_rows))
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self._queue: "deque[_Request]" = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._dead: Optional[BaseException] = None
        self._stats_lock = threading.Lock()
        self._lat_ms: "deque[float]" = deque(maxlen=self.LATENCY_WINDOW)
        self._reset_counters()
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-batcher", daemon=True)
        self._thread.start()

    def _reset_counters(self) -> None:
        self._rows = self._rows_real = 0
        self._batches = self._requests = 0
        self._errors = self._rejects = 0
        self._queue_peak = 0
        self._t_window = time.perf_counter()

    # ---- client side -------------------------------------------------

    def submit(self, universe: str, month: int) -> Future:
        """Enqueue one scoring query; the Future resolves to a
        :class:`ScoreResponse` or raises. An unknown universe or month
        fails here, without occupying the batcher."""
        future: Future = Future()
        if self._dead is not None:
            future.set_exception(BatcherDeadError(self._dead))
            return future
        try:
            entry = self.zoo.current(universe)
            width = bucket_width(entry.pool_size(entry.month_col(month)))
        except (KeyError, ValueError) as e:
            future.set_exception(e)
            return future
        req = _Request(universe, int(month), width, future)
        with self._cv:
            if self._dead is not None:
                future.set_exception(BatcherDeadError(self._dead))
                return future
            if self._stop:
                future.set_exception(
                    ServiceClosedError("scoring service is closed"))
                return future
            self._queue.append(req)
            depth = len(self._queue)
            self._cv.notify()
        with self._stats_lock:
            self._queue_peak = max(self._queue_peak, depth)
        return future

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
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(e)
        except BaseException as e:  # noqa: BLE001 — death guard
            # Died outside the per-batch failure path: fail every pending
            # request loudly instead of letting clients hang.
            with self._cv:
                self._dead = e
                pending = list(self._queue)
                self._queue.clear()
            for r in pending:
                if not r.future.done():
                    r.future.set_exception(BatcherDeadError(e))
            raise

    def _next_batch(self) -> Optional[List[_Request]]:
        """Pop the head request, then coalesce same-(universe, width)
        requests until ``max_rows`` or the ``max_wait_ms`` window closes.
        Other requests stay queued in order for the next batch."""
        with self._cv:
            while not self._queue:
                if self._stop:
                    return None
                self._cv.wait(0.05)
            first = self._queue.popleft()
            key = (first.universe, first.width)
            batch = [first]
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.max_rows:
                for i, r in enumerate(self._queue):
                    if (r.universe, r.width) == key:
                        del self._queue[i]
                        batch.append(r)
                        break
                else:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or self._stop:
                        break
                    self._cv.wait(remaining)
                    if not self._queue and self._stop:
                        break
            return batch

    def _dispatch(self, batch: List[_Request]) -> None:
        universe = batch[0].universe
        with self.zoo.lease(universe) as entry:
            # Validate each request against the LEASED entry: a newer
            # generation may have changed the serveable set since submit,
            # and only the stale request fails.
            live: List[_Request] = []
            pools = []
            for r in batch:
                try:
                    t = entry.month_col(r.month)
                except KeyError as e:
                    r.future.set_exception(e)
                    with self._stats_lock:
                        self._rejects += 1
                    continue
                live.append(r)
                pools.append((t, entry.pool(t)))
            batch = live
            if not batch:
                return
            rows = bucket_rows(len(batch), self.max_rows)
            # The width comes from the leased entry's pools, the truth
            # this response is built from.
            width = bucket_width(max(p.size for _, p in pools))
            fi = np.zeros((rows, width), np.int32)
            ti = np.zeros((rows,), np.int32)
            w = np.zeros((rows, width), np.float32)
            for i, (t, pool) in enumerate(pools):
                fi[i, :pool.size] = pool
                fi[i, pool.size:] = pool[-1] if pool.size else 0
                ti[i] = t
                w[i, :pool.size] = 1.0
            # Padded rows repeat row 0 at weight 0.
            for i in range(len(batch), rows):
                fi[i], ti[i] = fi[0], ti[0]
            out = entry.score(fi, ti, w)
            gen = entry.generation
        t_done = time.perf_counter()
        lats = []
        for i, r in enumerate(batch):
            pool = pools[i][1]
            lat = (t_done - r.t_submit) * 1e3
            lats.append(lat)
            r.future.set_result(ScoreResponse(
                universe=universe, month=r.month, generation=gen,
                firm_idx=pool, scores=out[i, :pool.size].copy(),
                latency_ms=lat))
        with self._stats_lock:
            self._lat_ms.extend(lats)
            self._rows += rows
            self._rows_real += len(batch)
            self._batches += 1
            self._requests += len(batch)

    # ---- stats / lifecycle -------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Completed requests, request rate over the stats window,
        latency percentiles (ms) and batch occupancy (real rows over
        dispatched rows)."""
        with self._stats_lock:
            lat = list(self._lat_ms)
            rows, real = self._rows, self._rows_real
            window_s = time.perf_counter() - self._t_window
            out: Dict[str, Any] = {
                "completed": self._requests,
                "batches": self._batches,
                "dispatch_errors": self._errors,
                "rejected": self._rejects,
                "queue_peak": self._queue_peak,
            }
        out["window_s"] = window_s
        out["req_per_s"] = out["completed"] / window_s if window_s > 0 else None
        out.update(latency_summary(lat))
        out["mean_occupancy"] = real / rows if rows else None
        out["rows"] = rows
        out["rows_real"] = real
        out["ready"] = self._dead is None and not self._stop
        return out

    def reset_stats(self) -> None:
        """Zero the stats window: what comes after is the measured steady
        state (warmup stays out of it)."""
        with self._stats_lock:
            self._lat_ms.clear()
            self._reset_counters()

    def close(self) -> None:
        """Stop the batcher thread; fail queued requests loudly."""
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
        self._thread.join(timeout=10.0)
