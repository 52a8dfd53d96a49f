"""Serving failure taxonomy: one vocabulary for shed / deadline /
breaker / dead-batcher outcomes, shared by the micro-batcher (which
raises them), the HTTP front door (which maps them to status codes) and
the tests (which assert on them). The port of
``lfm_quant_tpu/serve/errors.py``, plus :class:`ServiceClosedError`.

The transient-vs-permanent split is the retry layer's routing decision:
:func:`is_transient` answers "is a retry of the same dispatch worth
anything?". The JAX package reads XLA's status text
(``RESOURCE_EXHAUSTED``, ``UNAVAILABLE``, ...); the port's table:

======================================  =========  =========================
failure                                 transient  why
======================================  =========  =========================
injected ``TransientFault``             yes        the fault layer says so
``torch.cuda.OutOfMemoryError``         yes        the counterpart of
                                                   ``RESOURCE_EXHAUSTED``:
                                                   memory freed by other
                                                   work can let a retry in
injected ``PermanentFault``             no         fail fast, feed the
                                                   breaker
CUDA launch failure, illegal address,   no         an asynchronous error
any other ``torch.AcceleratorError``               poisons the CUDA
or "CUDA error" text                               context: every later
                                                   call fails too, so it
                                                   counts toward the
                                                   breaker and fails loudly
``KeyError``/``ValueError``/            no         routing errors and bugs
``TypeError``, everything else
======================================  =========  =========================
"""

from __future__ import annotations

from typing import Optional


class ServeError(RuntimeError):
    """Base of the serving-degradation failures. ``http_status`` is the
    front door's mapping; ``retry_after_s`` (when set) becomes the
    HTTP ``Retry-After`` hint."""

    http_status = 500
    retry_after_s: Optional[float] = None


class ShedError(ServeError):
    """Bounded admission refused the request: the queue is at
    ``LFM_SERVE_QUEUE_MAX``. Shedding is O(1) and intentional — the
    alternative is unbounded queue growth where EVERY request times out
    instead of most succeeding. HTTP 429."""

    http_status = 429
    retry_after_s = 0.1

    def __init__(self, queue_max: int):
        super().__init__(
            f"request shed: serving queue full ({queue_max} queued, "
            "LFM_SERVE_QUEUE_MAX) — retry after backoff")
        self.queue_max = queue_max


class DeadlineError(ServeError):
    """The request's deadline expired before dispatch — the batcher
    dropped it instead of spending a device dispatch on an answer
    nobody is waiting for. HTTP 504."""

    http_status = 504

    def __init__(self, universe: str, month: int, overdue_s: float):
        super().__init__(
            f"deadline expired {overdue_s * 1e3:.1f} ms before dispatch "
            f"for {universe!r}/{month} — dropped undispatched")
        self.universe = universe
        self.month = month


class CircuitOpenError(ServeError):
    """The circuit breaker is OPEN after consecutive dispatch failures:
    fast-fail instead of queueing onto a backend that is currently
    failing everything. HTTP 503 with a Retry-After of the remaining
    cooldown (after which a half-open probe decides)."""

    http_status = 503

    def __init__(self, retry_after_s: float):
        super().__init__(
            "circuit open after consecutive dispatch failures — "
            f"fast-failing; retry in {retry_after_s:.3f}s "
            "(half-open probe follows)")
        self.retry_after_s = max(0.0, float(retry_after_s))


class BatcherDeadError(ServeError):
    """The batcher thread died outside the per-batch failure path; the
    service is unready until restarted. Pending and subsequent requests
    fail fast with the original cause instead of hanging until client
    timeout. HTTP 503."""

    http_status = 503

    def __init__(self, cause: BaseException):
        super().__init__(
            "scoring service unready: batcher thread died "
            f"({type(cause).__name__}: {cause})")
        self.cause = cause


class ServiceClosedError(ServeError):
    """The service was closed with the request still queued, or before
    it was submitted. HTTP 503."""

    http_status = 503


class MemberUnavailableError(ServeError):
    """The fleet router exhausted every candidate member for the
    universe (serve/fleet.py ``FleetRouter``): each replica was out
    (dead, open-circuit, unready) or failed its attempt within the
    bounded member-retry budget. The fleet-level twin of
    :class:`CircuitOpenError` — fast-fail with a Retry-After covering
    the member cooldown, after which half-open probes readmit. HTTP
    503, so a fleet client sees the same taxonomy a single-process
    client does."""

    http_status = 503

    def __init__(self, universe: str, tried: int,
                 retry_after_s: float = 0.25):
        super().__init__(
            f"no fleet member available for universe {universe!r} "
            f"(tried {tried} member(s); the rest were out) — "
            f"fast-failing; retry in {retry_after_s:.3f}s "
            "(half-open member probes follow)")
        self.universe = universe
        self.tried = int(tried)
        self.retry_after_s = max(0.0, float(retry_after_s))


class SnapshotIntegrityError(ServeError):
    """A durable zoo generation failed restore-time verification
    (serve/persist.py ``ZooStore``): params checksum mismatch,
    parity-probe bit-inequality, panel hash mismatch, or an unreadable
    artifact. The restore loop catches it, QUARANTINES the snapshot
    (renamed aside, loud warning) and falls back to the next-older
    committed generation — or to a fresh retrain — because serving
    wrong numbers is the one failure mode a restore may never pick.
    ``artifact_quarantined`` True means the failing rung already
    quarantined the faulty artifact itself (e.g. a shared panel file)
    — the catch must then NOT also quarantine the healthy generation
    directory. ``skip_quarantine`` True means the failure was
    ENVIRONMENTAL (a transient device fault mid-restore, an active
    chaos schedule) — the attempt fails but the snapshot, which may be
    perfectly healthy, is not condemned. HTTP 500: if it ever reaches
    a client, something upstream skipped the quarantine ladder."""

    http_status = 500
    artifact_quarantined = False
    skip_quarantine = False


class DriftVetoError(ServeError):
    """The knob-gated publish veto (``LFM_DRIFT_GATE=1``): the universe's served-score distribution has drifted past
    ``LFM_DRIFT_MAX`` from its publish-time reference sketch, so the
    next atomic publish is BLOCKED until the operator re-validates (or
    overrides with the gate off) — the first concrete piece of the
    ROADMAP 5b risk gate. HTTP 409: the request conflicts with the
    service's current (drifted) state, it is not a service outage."""

    http_status = 409

    def __init__(self, universe: str, psi: float, threshold: float):
        super().__init__(
            f"publish vetoed for universe {universe!r}: served-score "
            f"drift PSI {psi:.4f} exceeds LFM_DRIFT_MAX {threshold:g} "
            "against the serving generation's reference sketch — "
            "re-validate the universe (or disable LFM_DRIFT_GATE) "
            "before publishing the next generation")
        self.universe = universe
        self.psi = float(psi)
        self.threshold = float(threshold)


def is_transient(exc: BaseException) -> bool:
    """The retry layer's classification (the table in the module
    docstring): True when re-dispatching the same batch has a chance
    (injected transient faults, the card out of memory); False for
    everything else — permanent faults, a poisoned CUDA context,
    routing errors, genuine bugs — which fail fast and count toward the
    circuit breaker."""
    if getattr(exc, "transient", False):
        return True
    if isinstance(exc, (KeyError, ValueError, TypeError)):
        return False
    import torch

    return isinstance(exc, torch.cuda.OutOfMemoryError)


def http_status(exc: BaseException) -> int:
    """Exception → HTTP status for the front door (serve/http.py): shed →
    429, open circuit / dead batcher / closed service → 503, expired
    deadline → 504, publish vetoed → 409, unknown universe/month → 404,
    anything else → 500."""
    if isinstance(exc, ServeError):
        return exc.http_status
    if isinstance(exc, KeyError):
        return 404
    return 500
