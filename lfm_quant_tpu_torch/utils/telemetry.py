"""Run telemetry: span tracing, the counter registry, run manifests.

The port of ``lfm_quant_tpu/utils/telemetry.py``: the counter registry
(:data:`COUNTERS`), sync and async spans and instants, the run
(``spans.jsonl``, the streamed Chrome trace ``trace.json``, the run
record) and its manifest, :func:`run_scope` and :func:`build_info`.
Every run-dir artifact has the JAX package's format, so
``scripts/trace_report.py`` reads the port's run dirs unchanged.

What differs: :func:`build_info` and the manifest report torch, its CUDA
build and the device's name where the JAX package reports jax, jaxlib
and the backend, and the knob probes name the port's modules. The
program ledger (``record_program_build``, compile seconds and XLA's cost
and memory analysis per jitted program) has no counterpart: PyTorch runs
eagerly, with no compiled program to record.

Gating: ``LFM_TELEMETRY`` (default on; ``0`` disables spans and
manifests). Span emission also needs an active run (:func:`run_scope`),
so library code instruments unconditionally. Nothing here touches a
device.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional


def _jsonsafe(d: Dict[str, Any]) -> Dict[str, Any]:
    """Non-finite floats → None (recursive): a bare ``NaN`` token would
    corrupt the strict-JSON span stream and trace.json. One policy,
    one implementation — shared with the metrics stream."""
    from lfm_quant_tpu_torch.utils.logging import _finite

    return {k: _finite(v) for k, v in d.items()}


def enabled() -> bool:
    """Master kill switch: ``LFM_TELEMETRY=0`` disables spans and
    manifests (the counters in :data:`COUNTERS` stay live
    — the reuse/pipeline lanes assert on them and they predate this
    module)."""
    return os.environ.get("LFM_TELEMETRY", "1") != "0"


# ---- named-counter registry ---------------------------------------------


class CounterRegistry:
    """Process-wide named counters (int or float), safe under concurrent
    writers. The pre-serving design was lock-free (every hot-path writer
    — trace counting, H2D accounting, host-sync timing — ran on the one
    dispatching thread, so a ``dict`` read-modify-write under the GIL
    was enough); the scoring service broke that assumption: request
    threads, the micro-batcher thread and a refresh fit all bump
    concurrently, and ``c[name] = c.get(name, 0) + value`` loses
    increments when two threads interleave between the read and the
    store. Every mutation now takes the registry lock — an uncontended
    ``threading.Lock`` is tens of nanoseconds against multi-ms
    dispatches, and the reuse/pipeline lanes' non-interference contract
    is re-measured with the lock in place. ``get`` stays lock-free (a
    single dict read is atomic under the GIL; staleness by one in-flight
    bump was always possible for cross-thread readers and remains the
    documented worst case)."""

    __slots__ = ("_c", "_lock")

    def __init__(self):
        self._c: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def bump(self, name: str, value=1) -> None:
        with self._lock:
            c = self._c
            c[name] = c.get(name, 0) + value

    def peak(self, name: str, value) -> None:
        """Monotone max: record ``value`` if it exceeds the current one
        (queue-depth high-water marks and the like)."""
        with self._lock:
            c = self._c
            if value > c.get(name, 0):
                c[name] = value

    def get(self, name: str):
        return self._c.get(name, 0)

    def set(self, name: str, value) -> None:
        with self._lock:
            self._c[name] = value

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._c)

    def delta(self, since: Dict[str, Any]) -> Dict[str, Any]:
        """Non-zero counter increments since a :meth:`snapshot` (keys
        absent from ``since`` count from 0)."""
        with self._lock:
            return {k: v - since.get(k, 0) for k, v in self._c.items()
                    if v != since.get(k, 0)}

    def reset(self) -> None:
        with self._lock:
            self._c.clear()


#: The registry every instrument bumps. ``ReuseCounters``
#: (utils/profiling.py) is a fixed-field compatibility view over it.
COUNTERS = CounterRegistry()


# ---- span tracer ---------------------------------------------------------

_TL = threading.local()  # .stack: [span name, ...] per thread


def _fresh_path(run_dir: str, stem: str, ext: str, pid: int) -> str:
    """Atomically CLAIM ``<stem>.<ext>`` (O_CREAT|O_EXCL — exactly one
    process wins even when several race on the same run dir, e.g. a
    multi-host pod's ranks or a backtest launched beside a live train),
    else fall back to ``<stem>.<pid>.<ext>``: later processes must
    never clobber the first one's artifact (the train run's
    manifest/trace are the canonical ones; a follow-up backtest gets
    its own files). The claimed empty file is atomically replaced with
    real content by the caller."""
    path = os.path.join(run_dir, f"{stem}.{ext}")
    try:
        os.close(os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        return path
    except FileExistsError:
        return os.path.join(run_dir, f"{stem}.{pid}.{ext}")


def _stack() -> List[str]:
    s = getattr(_TL, "stack", None)
    if s is None:
        s = _TL.stack = []
    return s


class _NullSpan:
    """Shared no-op span: the disabled/inactive path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass

    def end(self, **args) -> None:
        pass


_NULL = _NullSpan()


class _Span:
    """A sync (nested, thread-local) span → one "X" trace event."""

    __slots__ = ("_run", "name", "cat", "args", "_t0", "_wall0", "_c0",
                 "_parent", "_depth")

    def __init__(self, run: "TelemetryRun", name: str, cat: str,
                 args: Dict[str, Any]):
        self._run = run
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **args) -> None:
        """Attach result args before the span closes (e.g. epochs_run)."""
        self.args.update(args)

    def __enter__(self):
        st = _stack()
        self._parent = st[-1] if st else None
        self._depth = len(st)
        st.append(self.name)
        self._c0 = COUNTERS.snapshot()
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        st = _stack()
        if st and st[-1] == self.name:
            st.pop()
        self._run._record(self.name, self.cat, self._wall0, self._t0, dur,
                          self.args, COUNTERS.delta(self._c0),
                          parent=self._parent, depth=self._depth)
        return False


class _AsyncSpan:
    """An id-keyed span that may overlap others on the same thread (the
    pipeline's in-flight epochs) → a "b"/"e" trace event pair."""

    __slots__ = ("_run", "name", "cat", "args", "_t0", "_wall0", "_c0",
                 "_id", "_parent", "_done")

    def __init__(self, run: "TelemetryRun", name: str, cat: str,
                 args: Dict[str, Any]):
        self._run = run
        self.name = name
        self.cat = cat
        self.args = args
        st = _stack()
        self._parent = st[-1] if st else None
        self._id = run._next_id()
        self._c0 = COUNTERS.snapshot()
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        self._done = False
        run._event("b", name, cat, self._t0, args=dict(args), id=self._id)

    def set(self, **args) -> None:
        self.args.update(args)

    def end(self, **args) -> None:
        if self._done:
            return
        self._done = True
        self.args.update(args)
        dur = time.perf_counter() - self._t0
        self._run._event("e", self.name, self.cat, time.perf_counter(),
                         args={}, id=self._id)
        self._run._record(self.name, self.cat, self._wall0, self._t0, dur,
                          self.args, COUNTERS.delta(self._c0),
                          parent=self._parent, depth=None, event=False)


class TelemetryRun:
    """One activated run: open span stream + streamed Chrome events.

    ``spans.jsonl`` gets a line per CLOSED span as it closes (line-
    buffered append — a crash loses at most the in-flight spans). The
    Chrome-trace stream is written the same way: the trace file is
    claimed at run START (the first process owns the canonical
    ``trace.json``; racers get ``trace.<pid>.json``) and every event
    streams to it line-buffered with a trailing comma — O(1) host
    memory over arbitrarily long runs, and a crash leaves a truncated
    array Perfetto still loads (its JSON importer tolerates an
    unterminated ``traceEvents``). :meth:`finish` writes the closing
    sentinel + bracket (strict JSON from then on) plus a run-level
    record in the jsonl stream carrying the run's wall time and counter
    deltas — what ``trace_report`` rolls up."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._fh: Optional[io.TextIOBase] = open(
            os.path.join(run_dir, "spans.jsonl"), "a", buffering=1)
        self._pid = os.getpid()
        self.trace_path = _fresh_path(run_dir, "trace", "json", self._pid)
        self._trace_fh: Optional[io.TextIOBase] = open(
            self.trace_path, "w", buffering=1)
        self._trace_fh.write('{"displayTimeUnit": "ms", "traceEvents": [\n')
        self._lock = threading.Lock()
        self._ids = 0
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self._c0 = COUNTERS.snapshot()
        self.n_spans = 0
        self._threads_named: set = set()

    def counters_at_start(self) -> Dict[str, Any]:
        """The counter-registry snapshot taken when this run attached —
        the baseline that turns process-LIFETIME counter totals into
        run-scoped deltas (the run record's ``d`` uses it at finish;
        the incident bundles use it mid-run)."""
        return dict(self._c0)

    # -- low-level emission ------------------------------------------

    def _next_id(self) -> int:
        with self._lock:
            self._ids += 1
            return self._ids

    def _us(self, t_perf: float) -> float:
        return (t_perf - self._t0) * 1e6

    def _event(self, ph: str, name: str, cat: str, t_perf: float, *,
               args: Dict[str, Any], dur_s: Optional[float] = None,
               id: Optional[int] = None) -> None:
        tid = threading.get_ident()
        ev = {"name": name, "cat": cat or "span", "ph": ph,
              "ts": round(self._us(t_perf), 1), "pid": self._pid,
              "tid": tid, "args": _jsonsafe(args)}
        if dur_s is not None:
            ev["dur"] = round(dur_s * 1e6, 1)
        if id is not None:
            ev["id"] = id
        with self._lock:
            if self._trace_fh is None:
                return
            if tid not in self._threads_named:
                self._threads_named.add(tid)
                self._trace_fh.write(json.dumps({
                    "name": "thread_name", "ph": "M", "pid": self._pid,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name}})
                    + ",\n")
            self._trace_fh.write(json.dumps(ev, default=str) + ",\n")

    def _record(self, name: str, cat: str, wall0: float, t0_perf: float,
                dur_s: float, args: Dict[str, Any],
                deltas: Dict[str, Any], *, parent: Optional[str],
                depth: Optional[int], event: bool = True) -> None:
        rec = {"name": name, "cat": cat, "ts": round(wall0, 6),
               "dur_s": round(dur_s, 6), "parent": parent,
               "thread": threading.current_thread().name}
        if depth is not None:
            rec["depth"] = depth
        if args:
            rec["args"] = _jsonsafe(args)
        if deltas:
            rec["d"] = _jsonsafe(
                {k: (round(v, 6) if isinstance(v, float) else v)
                 for k, v in deltas.items()})
        line = json.dumps(rec, default=str) + "\n"
        if event:
            self._event("X", name, cat, t0_perf, args={**args, **deltas},
                        dur_s=dur_s)
        with self._lock:
            if self._fh is None:
                return
            self.n_spans += 1
            self._fh.write(line)

    # -- lifecycle ----------------------------------------------------

    def finish(self) -> None:
        """Write the run record, terminate the trace document (a final
        sentinel metadata event absorbs the streamed trailing comma)
        and close both streams. A run dir accumulates processes (train,
        then backtest, then a resume): ``spans.jsonl`` appends; each
        process has its own trace document (claimed at start)."""
        global _ACTIVE
        dur = time.perf_counter() - self._t0
        self._event("X", "run", "run", self._t0, args={}, dur_s=dur)
        self._record("run", "run", self._wall0, self._t0, dur,
                     {"n_spans": self.n_spans},
                     COUNTERS.delta(self._c0), parent=None, depth=0,
                     event=False)
        with self._lock:
            if self._fh is None:
                return
            self._fh.close()
            self._fh = None
            self._trace_fh.write(json.dumps(
                {"name": "trace_end", "ph": "M", "pid": self._pid,
                 "args": {"n_spans": self.n_spans}}) + "\n]}\n")
            self._trace_fh.close()
            self._trace_fh = None
        if _ACTIVE is self:
            _ACTIVE = None


_ACTIVE: Optional[TelemetryRun] = None


def active_run() -> Optional[TelemetryRun]:
    return _ACTIVE if enabled() else None


def span(name: str, cat: str = "span", **args):
    """A sync span context manager; no-op (shared singleton, no
    allocation beyond the kwargs dict) when telemetry is disabled or no
    run is active. ``with telemetry.span("sample", epoch=3): ...``"""
    run = _ACTIVE
    if run is None or not enabled():
        return _NULL
    return _Span(run, name, cat, args)


def begin_async(name: str, cat: str = "epoch", **args):
    """Begin an async (overlappable) span; call ``.end(**args)`` to
    close it. Used for the pipeline's in-flight epochs, which overlap
    on the dispatching thread."""
    run = _ACTIVE
    if run is None or not enabled():
        return _NULL
    return _AsyncSpan(run, name, cat, args)


def instant(name: str, cat: str = "mark", **args) -> None:
    """A zero-duration marker event (early stop, fold boundary, ...).
    Emitted to the Chrome-trace stream AND as a zero-duration spans.jsonl
    record, so offline rollups (scripts/trace_report.py — e.g. the
    fold-stack section's per-fold ``fold_stopped`` marks) can read
    markers without parsing the trace file.

    Every instant ALSO lands in the black-box flight recorder
    (``utils/flight.py``) — BEFORE the run-active gate, because the
    recorder's whole point is capturing breaker transitions, fault
    injections, publishes and quarantines on processes that never
    attached a run dir (the incident bundles of )."""
    from lfm_quant_tpu_torch.utils import flight

    flight.note(name, cat, args)
    run = _ACTIVE
    if run is None or not enabled():
        return
    t0 = time.perf_counter()
    run._event("i", name, cat, t0, args=args)
    stack = _stack()
    run._record(name, cat, time.time(), t0, 0.0, args, {},
                parent=stack[-1] if stack else None, depth=len(stack),
                event=False)


# ---- run manifest --------------------------------------------------------

#: Resolved-knob probes for the manifest: name → zero-arg callable.
_KNOB_PROBES = (
    ("precision", "lfm_quant_tpu_torch.config", "resolve_precision"),
    ("metrics", "lfm_quant_tpu_torch.utils.metrics", "enabled"),
    ("flight", "lfm_quant_tpu_torch.utils.flight", "enabled"),
)


def _git_sha() -> Optional[str]:
    try:
        import subprocess

        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=5)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:
        return None


_BUILD_INFO: Optional[Dict[str, Any]] = None


def build_info() -> Dict[str, Any]:
    """Host and build identity, cached after the first probe: git sha,
    torch and its CUDA build, the backend (``cuda`` or ``cpu``), the
    device's name and count, the resolved compute dtype, hostname and
    pid. Two consumers: the ``build_info`` gauge labels on ``/metrics``
    (serve/monitor.py) and the host block of every incident bundle
    (serve/incident.py). Every probe degrades to None rather than
    failing a serving process."""
    global _BUILD_INFO
    if _BUILD_INFO is not None:
        info = dict(_BUILD_INFO)
    else:
        import socket

        info = {
            "git_sha": _git_sha(),
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "python": sys.version.split()[0],
        }
        _probe_build_env(info)
        _BUILD_INFO = dict(info)
    # The precision lane is re-resolved per call (it can change
    # in-process); everything above is process-constant and cached.
    try:
        from lfm_quant_tpu_torch.config import resolve_precision

        info["dtype"] = resolve_precision()
    except Exception:
        info["dtype"] = None
    return info


def _probe_build_env(info: Dict[str, Any]) -> None:
    try:
        import torch

        cuda = torch.cuda.is_available()
        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        info["backend"] = "cuda" if cuda else "cpu"
        info["device"] = torch.cuda.get_device_name(0) if cuda else "cpu"
        info["device_count"] = torch.cuda.device_count() if cuda else 0
    except Exception:
        for k in ("torch", "cuda", "backend", "device", "device_count"):
            info.setdefault(k, None)


def build_manifest(config: Any = None,
                   extra: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """The run-start provenance record: everything needed to interpret
    (and re-run) the run dir's artifacts. Every probe degrades to an
    error string rather than failing the run."""
    import dataclasses

    m: Dict[str, Any] = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "argv": list(sys.argv),
        "cwd": os.getcwd(),
        "python": sys.version.split()[0],
        "pid": os.getpid(),
        "git_sha": _git_sha(),
        "env_lfm": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith("LFM_")},
    }
    if config is not None:
        try:
            m["config"] = (dataclasses.asdict(config)
                           if dataclasses.is_dataclass(config) else config)
        except Exception as e:
            m["config"] = f"<unserializable: {e!r}>"
    knobs: Dict[str, Any] = {"telemetry": enabled()}
    for name, mod, fn in _KNOB_PROBES:
        try:
            import importlib

            knobs[name] = getattr(importlib.import_module(mod), fn)()
        except Exception:
            knobs[name] = None
    m["knobs"] = knobs
    try:
        import torch

        cuda = torch.cuda.is_available()
        m["torch"] = {
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "backend": "cuda" if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 0,
            "device_names": sorted({
                torch.cuda.get_device_name(i)
                for i in range(torch.cuda.device_count())}) if cuda else [],
        }
    except Exception as e:
        m["torch"] = f"<unavailable: {e!r}>"
    if extra:
        m.update(extra)
    return m


def write_manifest(run_dir: str, config: Any = None,
                   extra: Optional[Dict[str, Any]] = None
                   ) -> Optional[Dict[str, Any]]:
    """Atomically write the run manifest into ``run_dir`` (no-op when
    telemetry is disabled). The first process owns ``manifest.json``;
    later ones (a backtest pass over a train run dir) write
    ``manifest.<pid>.json`` so the training provenance survives.
    Returns the manifest dict."""
    if not enabled():
        return None
    m = build_manifest(config, extra)
    os.makedirs(run_dir, exist_ok=True)
    path = _fresh_path(run_dir, "manifest", "json", os.getpid())
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(m, fh, indent=2, default=str)
    os.replace(tmp, path)
    return m


# ---- run lifecycle -------------------------------------------------------


def start_run(run_dir: str, config: Any = None,
              extra: Optional[Dict[str, Any]] = None
              ) -> Optional[TelemetryRun]:
    """Activate span emission into ``run_dir`` and write the run
    manifest. Returns None (and does nothing) when telemetry is
    disabled or a run is already active — nested activations keep the
    outermost run (one process = one trace stream)."""
    global _ACTIVE
    if not enabled() or _ACTIVE is not None:
        return None
    write_manifest(run_dir, config, extra)
    _ACTIVE = TelemetryRun(run_dir)
    return _ACTIVE


@contextlib.contextmanager
def run_scope(run_dir: Optional[str], config: Any = None,
              extra: Optional[Dict[str, Any]] = None):
    """Context manager the CLI entry points wrap their work in:
    manifest + span emission on entry, ``trace.json`` + run record on
    exit. A None run dir (or disabled telemetry, or an already-active
    run) degrades to a no-op."""
    run = start_run(run_dir, config, extra) if run_dir else None
    try:
        yield run
    finally:
        if run is not None:
            run.finish()


