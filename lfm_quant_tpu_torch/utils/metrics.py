"""Live metrics plane: O(1)-per-event instruments + Prometheus text.

The port's copy of ``lfm_quant_tpu/utils/metrics.py`` (standard library and
numpy only; nothing changed but this paragraph).

Everything observable before this module was post-hoc: the telemetry
spans/ledger (utils/telemetry.py) and ``scripts/trace_report.py`` read
a FINISHED run dir, and the chaos layer's shed/retry/breaker counters
(PR 10) could not be scraped while the service was actually degrading.
This module is the pull-side half: always-on, in-process instruments a
live endpoint (``serve.py /metrics``) can render at any moment —

* :class:`LogHistogram` — fixed log-spaced-bucket latency histograms:
  O(1) record (one ``log``, one index clamp), lock-guarded per the
  ``telemetry.CounterRegistry`` convention (request threads, the
  batcher thread and a refresh fit all record concurrently), mergeable
  across label sets, with quantile estimates whose error is bounded by
  ONE BUCKET'S RELATIVE RESOLUTION (the growth factor — ~12% at the
  default 20 buckets/decade; tests/test_metrics.py pins the estimate
  against the exact ``serve/stats.py percentile`` twins on the same
  stream). Histograms are labeled per (universe, width-bucket): the
  Khomenko-style bucketed request stream means a bucket-ladder
  regression must be attributable per bucket, not hidden in a blended
  histogram.
* :class:`WindowedRing` — last ~5 minutes in ~10 s rings: O(1) add,
  O(rings) read, the rate/availability substrate the SLO burn windows
  (serve/monitor.py) sum over. Old rings expire by overwrite — no
  allocation, no unbounded growth on a long-lived service.
* **Gauges** — point-in-time values (queue depth, zoo entries, resident
  panel/param bytes, ``circuit_state``, ``slo_burn``, drift PSI), set
  by the monitor at collection time.
* :class:`ScoreSketch` — the score-drift monitor's distribution sketch:
  running moments (count/mean/M2) plus a fixed-edge histogram. At
  publish each zoo generation is stamped with a REFERENCE sketch of its
  batch-scored months; served scores stream into a LIVE sketch with
  the same edges; :meth:`ScoreSketch.psi` is the PSI-style divergence
  the ``score_drift_psi`` gauge reports and the (knob-gated) publish
  veto reads (DESIGN.md §19).
* :func:`render_prometheus` — Prometheus text exposition (format
  0.0.4) over this registry PLUS the absorbed ``telemetry.COUNTERS``
  (every counter the spans already attribute is scrapeable live as
  ``lfm_<name>_total`` — one counter store, two consumers, no drift).

Knobs: ``LFM_METRICS`` (default ON; ``0`` = exact no-op — every
mutator returns on one env read, nothing records, nothing allocates,
and no metrics code path ever touches a device: no device_get, no
block_until_ready, no trace — the measured non-interference contract
of the ``metrics`` test lane), ``LFM_SLO_P99_MS`` / ``LFM_SLO_AVAIL``
(the declared SLO objectives the burn rates are computed against),
``LFM_DRIFT_MAX`` (the PSI threshold), ``LFM_DRIFT_GATE`` (default
OFF: whether a breached drift gauge VETOES the next atomic publish).
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple


def enabled() -> bool:
    """Master kill switch: ``LFM_METRICS=0`` disables every mutator in
    this module (exact no-op — one env read and a compare; the
    telemetry-layer convention)."""
    return os.environ.get("LFM_METRICS", "1") != "0"


# ---- SLO / drift knobs ---------------------------------------------------


def slo_p99_ms_default() -> float:
    """``LFM_SLO_P99_MS``: the declared p99 latency objective in ms —
    requests slower than this consume latency error budget (default
    250; <= 0 disables the latency SLO)."""
    return float(os.environ.get("LFM_SLO_P99_MS", "250"))


def slo_avail_default() -> float:
    """``LFM_SLO_AVAIL``: the declared availability objective as a
    fraction (default 0.999 — an error budget of 0.1% of requests;
    <= 0 or >= 1 disables the availability SLO)."""
    return float(os.environ.get("LFM_SLO_AVAIL", "0.999"))


def drift_max_default() -> float:
    """``LFM_DRIFT_MAX``: the PSI divergence past which a generation's
    served-score distribution counts as DRIFTED from its publish-time
    reference (default 0.2 — between the classic 0.1 "moderate" and
    0.25 "major" PSI rules of thumb; <= 0 disables drift evaluation)."""
    return float(os.environ.get("LFM_DRIFT_MAX", "0.2"))


def drift_gate_enabled() -> bool:
    """``LFM_DRIFT_GATE``: when ``1``, a universe whose served scores
    breach ``LFM_DRIFT_MAX`` VETOES its next atomic publish
    (serve/errors.py DriftVetoError) — the first concrete piece of the
    ROADMAP 5b risk gate. Default OFF: the gauge and /healthz detail
    flip either way; blocking an operator's publish is an opt-in."""
    return os.environ.get("LFM_DRIFT_GATE", "0") == "1"


# ---- log-spaced histogram ------------------------------------------------


class LogHistogram:
    """Fixed log-spaced-bucket histogram: O(1) record, lock-guarded,
    mergeable, bounded-error quantiles.

    Bucket ``i`` (1-based) holds values in ``(lo·g^(i-1), lo·g^i]``
    with ``g = 10^(1/buckets_per_decade)``; bucket 0 is the underflow
    (``<= lo``), the last bucket the overflow (``> hi``). Estimated
    quantiles interpolate inside one bucket, so they can never be off
    by more than that bucket's width — a RELATIVE error of ``g − 1``
    (:attr:`rel_resolution`, ~12.2% at the default 20 buckets/decade).
    Exact ``count``/``sum``/``min``/``max`` are tracked alongside, so
    totals and means carry no bucketing error at all."""

    __slots__ = ("lo", "hi", "growth", "_log_lo", "_inv_log_g",
                 "_counts", "count", "sum", "vmin", "vmax", "_lock",
                 "_exemplars")

    def __init__(self, lo: float = 1e-2, hi: float = 1e5,
                 buckets_per_decade: int = 20):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.growth = 10.0 ** (1.0 / max(1, int(buckets_per_decade)))
        self._log_lo = math.log(self.lo)
        self._inv_log_g = 1.0 / math.log(self.growth)
        n = int(math.ceil((math.log(self.hi) - self._log_lo)
                          * self._inv_log_g))
        # [underflow] + n log buckets + [overflow]
        self._counts = [0] * (n + 2)
        self.count = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        # Exemplars (DESIGN.md §21): per bucket, the LAST (trace_id,
        # value, unix_ts) that landed there — one fixed slot per
        # bucket (the classic Prometheus client behavior), so a p99
        # bucket points at a real request id whose full phase
        # breakdown lives in the span record / slow-trace tracker.
        # Bounded by construction: at most one tuple per bucket.
        self._exemplars: Dict[int, Tuple[str, float, float]] = {}
        self._lock = threading.Lock()

    @property
    def rel_resolution(self) -> float:
        """The one-bucket relative error bound of estimated quantiles."""
        return self.growth - 1.0

    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        # ceil() so bucket i's upper bound lo·g^i is INCLUSIVE — the
        # cumulative counts then match the Prometheus `le` semantics.
        i = int(math.ceil((math.log(v) - self._log_lo) * self._inv_log_g))
        return min(max(i, 1), len(self._counts) - 1)

    def record(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        i = self._index(v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v
            if exemplar is not None:
                self._exemplars[i] = (exemplar, v, time.time())

    def exemplars(self) -> List[Dict[str, Any]]:
        """The per-bucket exemplars, ascending by bucket bound: each a
        ``{le, trace_id, value, ts}`` record — the trace ids a scrape
        consumer (or an incident bundle reader) follows back to real
        request traces. Kept OUT of the text exposition on purpose:
        OpenMetrics exemplar syntax is not valid Prometheus text 0.0.4
        and would break every existing parse twin; the JSON surfaces
        (``metrics_snapshot()``, incident bundles) carry them instead."""
        with self._lock:
            items = sorted(self._exemplars.items())
        out = []
        for i, (t, v, ts) in items:
            le = self.upper_bound(i)
            out.append({"le": (le if math.isfinite(le) else None),
                        "trace_id": t, "value": v, "ts": ts})
        return out

    def merge(self, other: "LogHistogram") -> None:
        """Fold another histogram of the SAME geometry into this one
        (label-set rollups — e.g. all universes into one ladder view)."""
        if (other.lo, other.hi, other.growth) != (self.lo, self.hi,
                                                  self.growth):
            raise ValueError("cannot merge histograms with different "
                             "bucket geometry")
        with other._lock:
            counts = list(other._counts)
            cnt, s = other.count, other.sum
            vmin, vmax = other.vmin, other.vmax
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self.count += cnt
            self.sum += s
            self.vmin = min(self.vmin, vmin)
            self.vmax = max(self.vmax, vmax)

    def upper_bound(self, i: int) -> float:
        """Bucket i's inclusive upper bound (+inf for the overflow)."""
        if i >= len(self._counts) - 1:
            return math.inf
        return self.lo * self.growth ** i

    def quantile(self, q: float) -> Optional[float]:
        """Estimated ``q``-quantile (q in [0, 100], the percentile
        convention of ``serve/stats.py``): linear interpolation inside
        the covering bucket, clamped to the exact observed min/max so
        degenerate streams (all-equal values) estimate exactly."""
        with self._lock:
            if self.count == 0:
                return None
            counts = list(self._counts)
            total = self.count
            vmin, vmax = self.vmin, self.vmax
        rank = (total - 1) * q / 100.0
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c > rank:
                # Interpolate inside bucket i between its bounds.
                lo_b = self.lo * self.growth ** (i - 1) if i >= 1 else vmin
                hi_b = self.upper_bound(i)
                if not math.isfinite(hi_b):
                    hi_b = vmax
                frac = (rank - cum + 0.5) / c
                est = lo_b + (hi_b - lo_b) * min(max(frac, 0.0), 1.0)
                return float(min(max(est, vmin), vmax))
            cum += c
        return float(vmax)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            out = {"count": self.count, "sum": round(self.sum, 6),
                   "min": (None if self.count == 0 else self.vmin),
                   "max": (None if self.count == 0 else self.vmax)}
        out["p50"] = self.quantile(50.0)
        out["p99"] = self.quantile(99.0)
        out["nonzero_buckets"] = sum(1 for c in counts if c)
        return out

    def prom_snapshot(self) -> Tuple[List[Tuple[float, int]], int, float]:
        """One locked read of ``(prom_buckets, count, sum)`` — the
        exposition needs the three CONSISTENT (a record landing between
        a bucket copy and an unlocked count read would emit a
        ``_count`` larger than its own +Inf bucket, violating the
        Prometheus histogram invariant scrape consumers assume)."""
        with self._lock:
            counts = list(self._counts)
            total = self.count
            s = self.sum
        out: List[Tuple[float, int]] = []
        cum = 0
        last = max((i for i, c in enumerate(counts) if c), default=-1)
        # Walk finite buckets only (cap BEFORE the overflow slot): the
        # overflow's upper bound IS +Inf, so walking into it would emit
        # a duplicate +Inf series beside the total appended below —
        # Prometheus rejects the whole scrape on duplicate samples.
        for i, c in enumerate(counts[:min(last + 1, len(counts) - 1)]):
            cum += c
            out.append((self.upper_bound(i), cum))
        out.append((math.inf, total))
        return out, total, s

    def prom_buckets(self) -> List[Tuple[float, int]]:
        """Cumulative ``(le_upper_bound, count)`` pairs, Prometheus
        histogram semantics (only buckets up to the last non-empty one
        plus the +Inf total — a 142-bucket ladder would otherwise emit
        a page of zeros per label set)."""
        return self.prom_snapshot()[0]


# ---- windowed ring aggregation -------------------------------------------


class WindowedRing:
    """Sliding-window event aggregation: ``rings`` slots of ``ring_s``
    seconds each (default 30 × 10 s = the last 5 minutes). ``add`` is
    O(1) (index, maybe reset, accumulate); ``total``/``rate`` sum the
    slots still inside the asked window. Slots expire by overwrite —
    constant memory on an always-on service. ``now`` is injectable for
    deterministic tests."""

    __slots__ = ("ring_s", "rings", "_epoch", "_val", "_lock")

    def __init__(self, ring_s: float = 10.0, rings: int = 30):
        self.ring_s = float(ring_s)
        self.rings = max(2, int(rings))
        self._epoch = [-1] * self.rings   # absolute ring index, -1 empty
        self._val = [0.0] * self.rings
        self._lock = threading.Lock()

    @property
    def span_s(self) -> float:
        """The longest window this ring can answer for."""
        return self.ring_s * self.rings

    def add(self, value: float = 1.0, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        epoch = int(now / self.ring_s)
        slot = epoch % self.rings
        with self._lock:
            if self._epoch[slot] != epoch:
                self._epoch[slot] = epoch
                self._val[slot] = 0.0
            self._val[slot] += value

    def total(self, window_s: float, now: Optional[float] = None) -> float:
        """Sum of values recorded within the last ``window_s`` seconds
        (quantized to whole rings — the youngest ``ceil(window/ring)``
        of them; a ring is counted iff it could hold in-window events)."""
        now = time.monotonic() if now is None else now
        epoch = int(now / self.ring_s)
        n_rings = min(self.rings,
                      max(1, int(math.ceil(window_s / self.ring_s))))
        oldest = epoch - n_rings + 1
        with self._lock:
            return sum(v for e, v in zip(self._epoch, self._val)
                       if e >= oldest)

    def rate(self, window_s: float, now: Optional[float] = None) -> float:
        """Events (or value) per second over the window."""
        w = min(max(window_s, self.ring_s), self.span_s)
        return self.total(window_s, now) / w


# ---- score-drift sketch --------------------------------------------------


class ScoreSketch:
    """A score-distribution sketch: running moments + fixed-edge
    histogram. The REFERENCE sketch (built once at publish from the
    generation's batch-scored months) defines the bin edges; the LIVE
    sketch (streamed from served responses) shares them, so the two are
    always comparable. PSI is the classic population-stability index
    over the shared bins with Laplace smoothing.

    Recording is lock-guarded — the batcher thread streams while
    /metrics scrapes — and comes in two shapes: :meth:`record`
    (vectorized, one ``np.histogram`` per call) and
    :meth:`record_lazy`, the serving hot path. The lazy path matters:
    numpy calls RELEASE the GIL, and on the batcher's critical path a
    GIL release under closed-loop client contention costs a scheduling
    quantum, not microseconds (measured ~16% of serve throughput when
    the histogram ran per dispatch). ``record_lazy`` is a bare list
    append under the lock — O(1), no numpy, no GIL release — and every
    READER folds the pending arrays down first (plus an amortized
    inline fold past ``LAZY_FOLD_LIMIT`` so an unscraped service can't
    grow the buffer unboundedly)."""

    __slots__ = ("edges", "_counts", "n", "_sum", "_sumsq", "_lock",
                 "_pending")

    #: Pending lazy-record arrays folded inline past this many entries
    #: (amortized: one vectorized fold per LIMIT batches).
    LAZY_FOLD_LIMIT = 256

    def __init__(self, edges):
        import numpy as np

        self.edges = np.asarray(edges, np.float64)
        if self.edges.ndim != 1 or self.edges.size < 2:
            raise ValueError("ScoreSketch needs >= 2 bin edges")
        # len(edges)-1 interior bins + underflow + overflow
        self._counts = np.zeros(self.edges.size + 1, np.int64)
        self.n = 0
        self._sum = 0.0
        self._sumsq = 0.0
        self._pending: List[Any] = []
        self._lock = threading.Lock()

    @classmethod
    def reference(cls, scores, bins: int = 16,
                  span_sigmas: float = 4.0) -> "ScoreSketch":
        """Build the publish-time reference: linear edges over
        mean ± ``span_sigmas``·std of the reference scores (degenerate
        distributions widen to a unit span), then record them."""
        import numpy as np

        s = np.asarray(scores, np.float64).ravel()
        s = s[np.isfinite(s)]
        if s.size == 0:
            raise ValueError("reference sketch needs at least one "
                             "finite score")
        mu = float(s.mean())
        sd = float(s.std())
        if not (sd > 0):
            sd = max(abs(mu), 1.0) * 1e-3
        half = span_sigmas * sd
        sk = cls(np.linspace(mu - half, mu + half, max(2, int(bins)) + 1))
        sk.record(s)
        return sk

    def live_twin(self) -> "ScoreSketch":
        """An empty sketch over the SAME edges — what served scores
        stream into."""
        return ScoreSketch(self.edges)

    def record_lazy(self, arr) -> None:
        """The serving hot path: O(1) append under the lock — no
        numpy, no GIL release on the batcher's critical path. Folded
        into the counts by the next reader (or inline, amortized, past
        ``LAZY_FOLD_LIMIT`` pending arrays)."""
        fold_now = None
        with self._lock:
            self._pending.append(arr)
            if len(self._pending) >= self.LAZY_FOLD_LIMIT:
                fold_now, self._pending = self._pending, []
        if fold_now is not None:
            self._fold(fold_now)

    def drain(self) -> None:
        """Fold every pending lazy record down into the counts (all
        readers call this first, so lazy mass is never invisible)."""
        with self._lock:
            if not self._pending:
                return
            pending, self._pending = self._pending, []
        self._fold(pending)

    def _fold(self, arrays) -> None:
        import numpy as np

        self.record(arrays[0] if len(arrays) == 1
                    else np.concatenate(
                        [np.asarray(a, np.float64).ravel()
                         for a in arrays]))

    def size(self) -> int:
        """Scores recorded so far, pending lazy mass included."""
        with self._lock:
            return self.n + sum(int(getattr(a, "size", 0))
                                for a in self._pending)

    def record(self, arr) -> None:
        import numpy as np

        a = np.asarray(arr, np.float64).ravel()
        a = a[np.isfinite(a)]
        if a.size == 0:
            return
        inner, _ = np.histogram(a, bins=self.edges)
        under = int((a <= self.edges[0]).sum())
        over = int((a > self.edges[-1]).sum())
        # np.histogram's first bin is closed on the left — keep values
        # exactly at edge[0] in the underflow for a stable partition.
        first = int((a == self.edges[0]).sum())
        with self._lock:
            self._counts[0] += under
            self._counts[1:-1] += inner
            self._counts[1] -= first
            self._counts[-1] += over
            self.n += int(a.size)
            self._sum += float(a.sum())
            self._sumsq += float((a * a).sum())

    # -- introspection -------------------------------------------------

    def mean(self) -> Optional[float]:
        self.drain()
        with self._lock:
            return self._sum / self.n if self.n else None

    def std(self) -> Optional[float]:
        self.drain()
        with self._lock:
            if self.n == 0:
                return None
            var = self._sumsq / self.n - (self._sum / self.n) ** 2
            return math.sqrt(max(var, 0.0))

    def counts(self):
        self.drain()
        with self._lock:
            return self._counts.copy()

    def psi(self, live: "ScoreSketch") -> Optional[float]:
        """Population-stability index of ``live`` against this
        reference over the shared bins (None until the live sketch has
        any mass). Laplace-smoothed so empty bins cannot produce
        infinities; 0 = identical, ~0.1 moderate shift, > 0.25 major
        (the classic rule of thumb — ``LFM_DRIFT_MAX`` defaults between
        them at 0.2)."""
        import numpy as np

        if (self.edges.size != live.edges.size
                or not bool(np.all(self.edges == live.edges))):
            raise ValueError("psi() needs sketches over the same edges")
        ref_c = self.counts().astype(np.float64)
        live_c = live.counts().astype(np.float64)
        if ref_c.sum() == 0 or live_c.sum() == 0:
            return None
        p = (ref_c + 0.5) / (ref_c.sum() + 0.5 * ref_c.size)
        q = (live_c + 0.5) / (live_c.sum() + 0.5 * live_c.size)
        return float(np.sum((q - p) * np.log(q / p)))

    def snapshot(self) -> Dict[str, Any]:
        self.drain()
        with self._lock:
            return {"n": int(self.n),
                    "mean": (self._sum / self.n if self.n else None),
                    "lo": float(self.edges[0]),
                    "hi": float(self.edges[-1]),
                    "bins": int(self.edges.size - 1)}

    # -- durable serialization (serve/persist.py, DESIGN.md §20) -------

    def to_state(self) -> Dict[str, Any]:
        """JSON-serializable full state (edges + counts + moments) —
        what the durable zoo store writes at publish so a restore can
        re-stamp the drift reference WITHOUT re-scoring a single month.
        Lazy mass is drained first, so the state is exact."""
        self.drain()
        with self._lock:
            return {"edges": [float(e) for e in self.edges],
                    "counts": [int(c) for c in self._counts],
                    "n": int(self.n),
                    "sum": float(self._sum),
                    "sumsq": float(self._sumsq)}

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "ScoreSketch":
        """Rebuild a sketch from :meth:`to_state` output. Loud on a
        malformed state (wrong counts length) — a durable artifact that
        half-parses must never silently stamp a wrong reference."""
        sk = cls(state["edges"])
        import numpy as np

        counts = np.asarray(state["counts"], np.int64)
        if counts.shape != sk._counts.shape:
            raise ValueError(
                f"sketch state counts length {counts.size} does not match "
                f"{sk._counts.size} for {sk.edges.size} edges")
        sk._counts = counts
        sk.n = int(state["n"])
        sk._sum = float(state["sum"])
        sk._sumsq = float(state["sumsq"])
        return sk


# ---- registry ------------------------------------------------------------

LabelTuple = Tuple[Tuple[str, str], ...]


def _labels(kw: Dict[str, Any]) -> LabelTuple:
    return tuple(sorted((k, str(v)) for k, v in kw.items()))


class MetricsRegistry:
    """The process-wide instrument store: named histograms, windowed
    rings and gauges, each keyed by (name, sorted label tuple).
    Creation is guarded by the registry lock; each instrument then
    guards its own mutation (two-level locking so a 142-bucket
    histogram write never serializes against an unrelated gauge set).
    Every mutator is an EXACT no-op under ``LFM_METRICS=0``."""

    def __init__(self):
        self._hists: Dict[Tuple[str, LabelTuple], LogHistogram] = {}
        self._rings: Dict[Tuple[str, LabelTuple], WindowedRing] = {}
        self._gauges: Dict[Tuple[str, LabelTuple], float] = {}
        self._lock = threading.Lock()

    # -- mutators (all gated on enabled()) ----------------------------

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one value into the named histogram (created on first
        use with the default latency geometry)."""
        if not enabled():
            return
        self.histogram(name, **labels).record(value)

    def mark(self, name: str, value: float = 1.0,
             now: Optional[float] = None, **labels) -> None:
        """Add to the named windowed ring (rates / SLO events)."""
        if not enabled():
            return
        self.ring(name, **labels).add(value, now=now)

    def gauge(self, name: str, value: float, **labels) -> None:
        if not enabled():
            return
        with self._lock:
            self._gauges[(name, _labels(labels))] = value

    def clear_gauges(self, name: str) -> None:
        """Drop every label set of the named gauge. Per-entity gauges
        (drift PSI per (universe, generation), param bytes per
        universe) are re-set at each collection — without clearing
        first, a retired generation's PSI or an evicted universe's
        bytes would sit in the exposition forever, firing alerts for a
        series that no longer serves."""
        with self._lock:
            for key in [k for k in self._gauges if k[0] == name]:
                del self._gauges[key]

    # -- instrument access --------------------------------------------

    def histogram(self, name: str, **labels) -> LogHistogram:
        key = (name, _labels(labels))
        h = self._hists.get(key)
        if h is None:
            with self._lock:
                h = self._hists.get(key)
                if h is None:
                    h = self._hists[key] = LogHistogram()
        return h

    def ring(self, name: str, **labels) -> WindowedRing:
        key = (name, _labels(labels))
        r = self._rings.get(key)
        if r is None:
            with self._lock:
                r = self._rings.get(key)
                if r is None:
                    r = self._rings[key] = WindowedRing()
        return r

    def merged_histogram(self, name: str) -> Optional[LogHistogram]:
        """All label sets of ``name`` folded into one histogram (the
        blended view — per-label histograms stay the primary record)."""
        with self._lock:
            hists = [h for (n, _), h in self._hists.items() if n == name]
        if not hists:
            return None
        bpd = int(round(1.0 / math.log10(hists[0].growth)))
        out = LogHistogram(hists[0].lo, hists[0].hi,
                           buckets_per_decade=bpd)
        for h in hists:
            out.merge(h)
        return out

    def window_total(self, name: str, window_s: float,
                     now: Optional[float] = None, **labels) -> float:
        key = (name, _labels(labels))
        r = self._rings.get(key)
        return r.total(window_s, now=now) if r is not None else 0.0

    # -- introspection -------------------------------------------------

    def exemplar_snapshot(self, name: Optional[str] = None
                          ) -> Dict[str, List[Dict[str, Any]]]:
        """Every histogram's exemplars (``name`` filters), keyed the
        snapshot way — the JSON surface trace ids ride out on (the
        text exposition stays exemplar-free; see
        :meth:`LogHistogram.exemplars`)."""
        with self._lock:
            hists = [(k, h) for k, h in sorted(self._hists.items())
                     if name is None or k[0] == name]
        out: Dict[str, List[Dict[str, Any]]] = {}
        for k, h in hists:
            ex = h.exemplars()
            if ex:
                out[_fmt_key(k)] = ex
        return out

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            hists = dict(self._hists)
            rings = dict(self._rings)
            gauges = dict(self._gauges)
        return {
            "histograms": {_fmt_key(k): h.snapshot()
                           for k, h in sorted(hists.items())},
            "rates_per_sec": {
                _fmt_key(k): {"60s": round(r.rate(60.0), 4),
                              "300s": round(r.rate(300.0), 4)}
                for k, r in sorted(rings.items())},
            "gauges": {_fmt_key(k): v for k, v in sorted(gauges.items())},
        }

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()
            self._rings.clear()
            self._gauges.clear()


def _fmt_key(key: Tuple[str, LabelTuple]) -> str:
    name, labels = key
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


#: The process-wide registry (the ``telemetry.COUNTERS`` convention:
#: one store, many writers, scraped by serve/monitor.py).
METRICS = MetricsRegistry()


# ---- Prometheus text exposition ------------------------------------------


def _prom_name(name: str) -> str:
    return "lfm_" + "".join(c if c.isalnum() or c == "_" else "_"
                            for c in name)


def _prom_labels(labels: LabelTuple) -> str:
    if not labels:
        return ""
    body = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", "\\\\")
                         .replace('"', '\\"'))
        for k, v in labels)
    return "{" + body + "}"


def _prom_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v)) if isinstance(v, float) else str(v)


def render_prometheus(registry: MetricsRegistry = None,
                      counters: Optional[Dict[str, Any]] = None,
                      ts: Optional[float] = None) -> str:
    """The ``GET /metrics`` document: every histogram/ring/gauge in the
    registry plus the absorbed telemetry counters, Prometheus text
    format 0.0.4. Pure host-side string building over locked snapshots
    — no device work, ever."""
    registry = METRICS if registry is None else registry
    lines: List[str] = []
    with registry._lock:
        hists = sorted(registry._hists.items())
        rings = sorted(registry._rings.items())
        gauges = sorted(registry._gauges.items())

    seen_types: set = set()

    def _typ(pname: str, kind: str, help_: str) -> None:
        if pname not in seen_types:
            seen_types.add(pname)
            lines.append(f"# HELP {pname} {help_}")
            lines.append(f"# TYPE {pname} {kind}")

    for (name, labels), h in hists:
        pname = _prom_name(name)
        _typ(pname, "histogram",
             f"log-spaced histogram of {name} (utils/metrics.py)")
        base = _prom_labels(labels)[1:-1] if labels else ""
        pairs, count, hsum = h.prom_snapshot()
        for le, cum in pairs:
            lab = (base + "," if base else "") + f'le="{_prom_num(le)}"'
            lines.append(f"{pname}_bucket{{{lab}}} {cum}")
        lines.append(f"{pname}_sum{_prom_labels(labels)} "
                     f"{_prom_num(hsum)}")
        lines.append(f"{pname}_count{_prom_labels(labels)} {count}")

    for (name, labels), r in rings:
        pname = _prom_name(name) + "_rate_per_sec"
        _typ(pname, "gauge",
             f"windowed rate of {name} (ring aggregation)")
        for w in (60, 300):
            lab = dict(labels)
            lab["window"] = f"{w}s"
            lines.append(f"{pname}{_prom_labels(_labels(lab))} "
                         f"{_prom_num(round(r.rate(float(w)), 6))}")

    for (name, labels), v in gauges:
        pname = _prom_name(name)
        _typ(pname, "gauge", f"{name} (utils/metrics.py gauge)")
        lines.append(f"{pname}{_prom_labels(labels)} {_prom_num(v)}")

    if counters:
        for name in sorted(counters):
            v = counters[name]
            if not isinstance(v, (int, float)):
                continue
            pname = _prom_name(name) + "_total"
            _typ(pname, "counter",
                 f"process-wide counter {name} (telemetry registry)")
            lines.append(f"{pname} {_prom_num(float(v))}")

    pts = _prom_name("scrape_ts_seconds")
    _typ(pts, "gauge", "unix time of this scrape")
    lines.append(f"{pts} {repr(time.time() if ts is None else ts)}")
    return "\n".join(lines) + "\n"


def hist_quantile_from_buckets(pairs: Sequence[Tuple[float, float]],
                               q: float) -> Optional[float]:
    """Estimated ``q``-quantile (q in [0, 100]) from CUMULATIVE
    ``(le_upper_bound, count)`` histogram pairs — the scrape-side twin
    of :meth:`LogHistogram.quantile` (same rank rule, same in-bucket
    interpolation), for consumers that only hold a rendered
    ``/metrics`` document. The VERBATIM twin lives in
    ``scripts/trace_report.py`` (no package dependency there); the
    metrics test lane pins the two against each other and against the
    in-process histogram on the same stream."""
    if not pairs:
        return None
    pairs = sorted(pairs, key=lambda p: p[0])
    total = pairs[-1][1]
    if total <= 0:
        return None
    rank = (total - 1) * q / 100.0
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in pairs:
        if cum > rank and cum > prev_cum:
            if not math.isfinite(le):
                return float(prev_le)  # overflow bucket: clamp
            c = cum - prev_cum
            frac = (rank - prev_cum + 0.5) / c
            return float(prev_le + (le - prev_le)
                         * min(max(frac, 0.0), 1.0))
        if math.isfinite(le):
            prev_le, prev_cum = le, max(prev_cum, cum)
    return float(prev_le)


# ---- scrape parsing (shared with scripts/trace_report.py twin) -----------


def parse_prometheus(text: str) -> Dict[str, List[Tuple[Dict[str, str],
                                                        float]]]:
    """Parse a Prometheus text scrape into name → [(labels, value)].
    The VERBATIM twin lives in ``scripts/trace_report.py`` (which must
    stay importable with no package dependency); the metrics test lane
    cross-checks the two on the same scrape, the percentile-twin
    discipline applied to parsing."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            head, _, val = line.rpartition(" ")
            if "{" in head:
                name, _, rest = head.partition("{")
                body = rest.rsplit("}", 1)[0]
                labels: Dict[str, str] = {}
                for part in body.split(","):
                    if not part:
                        continue
                    k, _, v = part.partition("=")
                    labels[k.strip()] = v.strip().strip('"')
            else:
                name, labels = head, {}
            v = float("inf") if val == "+Inf" else float(val)
            out.setdefault(name.strip(), []).append((labels, v))
        except ValueError:
            continue  # never die on a foreign exposition line
    return out
