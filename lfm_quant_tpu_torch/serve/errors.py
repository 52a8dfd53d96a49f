"""Serving failures the micro-batcher raises: the part of the JAX
package's ``serve/errors.py`` taxonomy this slice needs. Shedding,
deadlines and the circuit breaker come with a later slice (ROADMAP.md
Queue A)."""

from __future__ import annotations


class ServeError(RuntimeError):
    """Base of the serving failures."""


class BatcherDeadError(ServeError):
    """The batcher thread died outside the per-batch failure path; the
    service is unready. Pending and later requests fail fast with the
    original cause instead of hanging until the client's timeout."""

    def __init__(self, cause: BaseException):
        super().__init__(
            "scoring service unready: batcher thread died "
            f"({type(cause).__name__}: {cause})")
        self.cause = cause


class ServiceClosedError(ServeError):
    """The service was closed with the request still queued, or before
    it was submitted."""
