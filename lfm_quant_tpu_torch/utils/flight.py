"""Black-box flight recorder: the last ~N structured events, always.

The port's copy of ``lfm_quant_tpu/utils/flight.py`` (standard library and
numpy only; the imports changed, nothing else).

Every observability layer before this one either needs a run dir
(telemetry spans — attached only when an entry point asked for one) or
answers "what is happening NOW" (the /metrics scrape). Neither answers
the incident question: *what happened in the seconds BEFORE the
breaker opened / the SLO started burning / the snapshot quarantined?*
By the time an operator scrapes, the evidence is gone.

This module is the aviation answer: a bounded, lock-guarded, in-memory
ring of the last ``LFM_FLIGHT`` structured events (default 1024) that
is ALWAYS on — no run dir required — and cheap enough to leave on
(one lock, one ``deque.append``; the ring recycles storage, so memory
is bounded by construction). Two feeds fill it:

* **telemetry instants** — :func:`note` is called by
  ``utils/telemetry.py instant()`` BEFORE its run-active gate, so every
  marker the codebase already emits (``circuit_open``/``circuit_closed``
  breaker transitions, ``zoo_swap`` publishes, ``fault_injected``
  chaos injections, ``restore_quarantine`` verdicts, ``drift_veto``,
  ``batcher_died``, fold/run stops) lands in the ring even when no
  telemetry run is attached — the black-box property;
* **explicit serve events** — the micro-batcher records the hot-path
  outcomes that deliberately have no instant (per-batch dispatches,
  sheds, deadline drops, retries) via :func:`record`.

The ring is dumped crash-safely (:func:`dump`: temp file + fsync +
rename, one JSON line per event, non-finite floats nulled) into every
incident bundle (``serve/incident.py``) — the captured
evidence of the seconds before a degradation.

Knob: ``LFM_FLIGHT`` — ``0`` disables (exact no-op: one cached read +
a None test per event), unset/``1`` = the 1024-event default, any
other integer ≥ 2 sets the ring capacity. Like ``LFM_FAULTS``, the env
is resolved once on first use; tests re-resolve via :func:`configure`.

Non-interference: nothing here touches a device, takes the admission
lock, or allocates beyond one small dict per event.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: Default ring capacity (events) when ``LFM_FLIGHT`` is unset/``1``.
DEFAULT_CAPACITY = 1024


def flight_capacity() -> int:
    """Resolve ``LFM_FLIGHT``: 0 = off, unset/1 = the default capacity,
    N >= 2 = that capacity. Loud on garbage — a flight recorder that
    silently recorded nothing would be worse than none."""
    raw = os.environ.get("LFM_FLIGHT", "").strip()
    if raw in ("", "1"):
        return DEFAULT_CAPACITY
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"LFM_FLIGHT must be an integer (0=off, 1=default "
            f"{DEFAULT_CAPACITY}, N>=2=capacity), got {raw!r}") from None
    if n <= 0:
        return 0
    return max(2, n)


class FlightRecorder:
    """One bounded event ring. ``record`` is the O(1) hot path; every
    reader (:meth:`snapshot`, :meth:`dump`) copies under the lock and
    serializes outside it."""

    __slots__ = ("capacity", "_ring", "_lock", "_seq", "_dropped")

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(2, int(capacity))
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._dropped = 0  # events pushed out of the ring (bounded-ness
        #                    made visible: total seen = seq, kept = ring)

    def record(self, kind: str, cat: str = "serve",
               **fields: Any) -> None:
        """Append one event: ``{seq, ts, kind, cat, **fields}``. O(1):
        one dict build, one lock, one deque append (which recycles the
        evicted slot — bounded memory by construction)."""
        ev = {"ts": time.time(), "kind": kind, "cat": cat}
        if fields:
            ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(ev)

    def note(self, name: str, cat: str, args: Dict[str, Any]) -> None:
        """The ``telemetry.instant`` adapter: same event shape, args
        folded in (reserved keys never clobbered — an instant arg named
        ``ts`` would otherwise corrupt the event's own timestamp)."""
        ev = {"ts": time.time(), "kind": name, "cat": cat}
        for k, v in args.items():
            if k not in ("ts", "kind", "cat", "seq"):
                ev[k] = v
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(ev)

    def snapshot(self) -> List[Dict[str, Any]]:
        """The ring's events, oldest first (copies: callers may mutate)."""
        with self._lock:
            return [dict(ev) for ev in self._ring]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"capacity": self.capacity, "events": len(self._ring),
                    "total_seen": self._seq, "dropped": self._dropped}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._dropped = 0

    def dump(self, path: str) -> int:
        """Crash-safe dump: every ring event as one strict-JSON line
        (non-finite floats nulled — the spans.jsonl policy), written to
        a temp file, fsync'd, then atomically renamed over ``path`` —
        a reader never sees a torn dump. Returns the event count."""
        from lfm_quant_tpu_torch.utils.logging import _finite

        events = self.snapshot()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            for ev in events:
                fh.write(json.dumps({k: _finite(v) for k, v in ev.items()},
                                    default=str) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return len(events)


#: Sentinel: env not yet resolved (the ``utils/faults.py`` pattern —
#: one env read on first use, re-resolved only via :func:`configure`).
_UNSET = object()
_RECORDER: Any = _UNSET
_LOCK = threading.Lock()


def configure(capacity: Optional[int] = None) -> Optional[FlightRecorder]:
    """(Re)build the process recorder. ``capacity=None`` re-reads the
    ``LFM_FLIGHT`` knob (what tests that monkeypatch the env call); an
    explicit int configures directly (0 disables). Returns the active
    recorder, or None when disabled."""
    global _RECORDER
    cap = flight_capacity() if capacity is None else int(capacity)
    rec = FlightRecorder(cap) if cap > 0 else None
    with _LOCK:
        _RECORDER = rec
    return rec


def recorder() -> Optional[FlightRecorder]:
    """The active process recorder (None when ``LFM_FLIGHT=0``)."""
    rec = _RECORDER
    if rec is _UNSET:
        rec = configure()
    return rec


def enabled() -> bool:
    """Whether the flight recorder is on (the manifest probe)."""
    return recorder() is not None


def record(kind: str, cat: str = "serve", **fields: Any) -> None:
    """Module-level hot-path append (the serve layer's entry point):
    exact no-op — one global read + a None test — when disabled."""
    rec = _RECORDER
    if rec is _UNSET:
        rec = configure()
    if rec is not None:
        rec.record(kind, cat=cat, **fields)


def note(name: str, cat: str, args: Dict[str, Any]) -> None:
    """The ``telemetry.instant`` feed (see module docstring)."""
    rec = _RECORDER
    if rec is _UNSET:
        rec = configure()
    if rec is not None:
        rec.note(name, cat, args)


def snapshot() -> List[Dict[str, Any]]:
    rec = recorder()
    return rec.snapshot() if rec is not None else []


def dump(path: str) -> int:
    """Dump the active ring to ``path`` (0 events when disabled — the
    file is still written, so an incident bundle is always complete)."""
    rec = recorder()
    if rec is None:
        rec = FlightRecorder(2)  # empty dump: complete, explicit
    return rec.dump(path)
