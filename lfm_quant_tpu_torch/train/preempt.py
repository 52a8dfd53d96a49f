"""SIGTERM / preemption grace layer for fits: the port of
``lfm_quant_tpu/train/preempt.py`` (standard library only).

Preemptible capacity delivers SIGTERM with a short grace window. This
module turns the signal into a CLEAN stop at the next epoch boundary:

* :func:`grace_scope` installs a SIGTERM handler (ref-counted: nested
  fits share one installation; restored on exit) that does nothing but
  set a flag. Installation is skipped off the main thread (a CPython
  restriction): a fit driven from a worker thread keeps default
  delivery.
* The epoch driver (``train/pipeline.py run_fit_epochs``) checks
  :func:`requested` once per loop iteration: when set, it SETTLES the
  in-flight epoch (recorded and checkpointed like any other, never
  discarded), flushes both checkpoint lines through the harness's
  ``preempt_flush`` (bounded waits, ``train/checkpoint.py``), and raises
  :class:`Preempted`.
* The entry point (``python -m lfm_quant_tpu_torch.train``) catches
  :class:`Preempted` and exits 75 (EX_TEMPFAIL: "transient, re-run
  me"); a re-run with ``--resume`` continues from the last recorded
  epoch with IDENTICAL history (the samplers are deterministic in
  (seed, epoch); ``tests/test_torch_pipeline.py`` holds the history and
  the best params of a killed and resumed subprocess to an uninterrupted
  fit's).

:class:`Preempted` subclasses ``BaseException`` (like
``KeyboardInterrupt``) on purpose: blanket ``except Exception``
degrade-don't-die paths must never swallow a preemption and keep
training into the kill window.

Deterministic preemption for tests comes from the fault harness: a
``ckpt_write:at=K,kind=sigterm`` ``LFM_FAULTS`` spec (``utils/faults.py``)
delivers the SIGTERM at an exact checkpoint write.
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Optional


class Preempted(BaseException):
    """Raised by the epoch driver after a SIGTERM grace stop: the last
    settled epoch is recorded and durable; nothing after it ran."""

    def __init__(self, epoch: Optional[int] = None):
        super().__init__(
            "fit preempted by SIGTERM"
            + (f" (grace stop after epoch {epoch})" if epoch is not None
               else " (grace stop before the first epoch settled)"))
        self.epoch = epoch


_EVENT = threading.Event()
_LOCK = threading.Lock()
_DEPTH = 0
_PREV = None
_INSTALLED = False


def requested() -> bool:
    """Whether a SIGTERM arrived since the last :func:`clear`."""
    return _EVENT.is_set()


def clear() -> None:
    """Reset the flag (tests / long-lived drivers that survived a
    graceful stop). The entry points never clear — the process exits."""
    _EVENT.clear()


def _handler(signum, frame):
    # Signal-handler minimal: set the flag; the epoch driver does the
    # settle + flush at the next boundary. The counter bump is safe —
    # Python handlers run between bytecodes, not in async-signal
    # context — and makes the request visible in the run record.
    _EVENT.set()
    try:
        from lfm_quant_tpu_torch.utils import telemetry

        telemetry.COUNTERS.set("preempt_requested", 1)
    except Exception:  # noqa: BLE001 — the flag is the contract
        pass


@contextlib.contextmanager
def grace_scope():
    """Install the SIGTERM grace handler for the duration of a fit (or
    a whole entry-point run). Ref-counted: nested scopes (entry point →
    walk-forward → per-fold fit) share one installation; the outermost
    exit restores the previous handler. No-op off the main thread."""
    global _DEPTH, _PREV, _INSTALLED
    with _LOCK:
        _DEPTH += 1
        if _DEPTH == 1:
            try:
                _PREV = signal.signal(signal.SIGTERM, _handler)
                _INSTALLED = True
            except ValueError:  # not the main thread
                _INSTALLED = False
    try:
        yield
    finally:
        with _LOCK:
            _DEPTH -= 1
            if _DEPTH == 0 and _INSTALLED:
                try:
                    signal.signal(signal.SIGTERM, _PREV)
                except ValueError:  # pragma: no cover — symmetric guard
                    pass
                _INSTALLED = False
                _PREV = None
