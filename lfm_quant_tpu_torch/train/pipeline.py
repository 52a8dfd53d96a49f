"""Async epoch pipeline: the port of ``lfm_quant_tpu/train/pipeline.py``.

The epoch loop of both trainers runs through :func:`run_fit_epochs`, with
the JAX package's callback contract (``build``, ``dispatch``, ``finish``)
and its two knobs:

* **One fetch per epoch.** ``dispatch`` queues the epoch's train steps
  and the chained validation sweep on the device and returns the
  epoch's scalars as device tensors; :class:`Fetch` queues their copy
  (and, when checkpointing, the state's) into pinned host memory behind
  them and records a CUDA event. Waiting on that event is the epoch's
  ONE counted blocking device→host fetch (``host_syncs`` and
  ``host_sync_s`` in ``utils/telemetry.py COUNTERS``; the ``device_get``
  fault site). Nothing in ``dispatch`` may wait for the device.
* **One-epoch lookahead** (``LFM_ASYNC``, default on). Epoch e+1's index
  batches are sampled and staged on a background thread while epoch e
  computes, and epoch e+1 is queued before epoch e's fetch is waited
  for: since the fetch's copies sit in the stream before e+1's launches,
  waiting for them never waits for e+1. The early-stopping decision
  runs one epoch behind; when it fires, the epoch already queued is
  discarded (never recorded, never checkpointed).
* **Async checkpointing** (``LFM_ASYNC_CKPT``, default on). Both lines
  are written by background threads from the fetched host copy
  (``train/checkpoint.py``); the loop waits only at ``finalize``, resume
  and preemption.

The torch twin of JAX's buffer donation: a torch optimizer updates the
parameters in place, so once epoch e+1 is queued, epoch e's state is
gone. Before queueing e+1 the driver takes a device-side clone of the
state (:func:`clone_state`, ordered before e+1 by the stream); the run
rolls back to it when early stopping fires one epoch late, so every
consumer of the final state sees what the lock-step loop would have
ended on.

Numerics: pipelining reorders host work only. Every launch, every input
and every recorded metric is the lock-step loop's, so ``LFM_ASYNC`` and
``LFM_ASYNC_CKPT`` in any of their four settings give the same history,
best epoch, early-stop epoch and restored best params
(``tests/test_torch_pipeline.py``).

Preemption (``train/preempt.py``): the loop runs inside a SIGTERM
``grace_scope``; a signal stops it at the next iteration boundary: the
in-flight epoch settles (recorded, checkpointed), the harness's
``preempt_flush`` makes both lines durable with bounded waits, and
:class:`~lfm_quant_tpu_torch.train.preempt.Preempted` propagates for the
entry point to exit 75.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from lfm_quant_tpu_torch.train import preempt
from lfm_quant_tpu_torch.utils import faults, telemetry


def async_enabled() -> bool:
    """Epoch-pipeline kill switch: ``LFM_ASYNC=0`` forces the lock-step
    loop (build → dispatch → fetch → checkpoint per epoch), the parity
    reference for the lookahead. Default on. Pipelining changes the
    order of host work only, never a launch or its numerics."""
    return os.environ.get("LFM_ASYNC", "1") != "0"


def async_ckpt_enabled() -> bool:
    """Async-checkpoint kill switch: ``LFM_ASYNC_CKPT=0`` makes
    ``FitHarness.end_epoch`` wait for both checkpoint lines before it
    returns (the two saves still overlap each other). With it on
    (default) the writes run in the background from a host copy and the
    loop waits only at ``finalize``, resume and preemption. A crash
    mid-save loses at most the in-flight epoch's checkpoint:
    ``FitHarness.resume`` reconciles a progress sidecar that ran ahead.
    Orthogonal to ``LFM_ASYNC``."""
    return os.environ.get("LFM_ASYNC_CKPT", "1") != "0"


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over every tensor leaf of nested dicts, named tuples and
    dataclasses (the train state); other leaves pass."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def clone_state(state: Any) -> Any:
    """A device-side copy of a train state (every tensor cloned, queued
    on the stream like any launch): the rollback target of a stranded
    lookahead epoch."""
    return tree_map(lambda t: t.detach().clone(), state)


class Fetch:
    """A queued device→host copy of a tree: every tensor leaf copied
    into fresh (pinned, on the card) host memory behind the work already
    queued, then an event recorded. :meth:`wait` is the one counted
    blocking fetch; :meth:`ready` polls without blocking. On the CPU the
    copies are made at once (real copies: the live state moves on)."""

    def __init__(self, tree: Any):
        self._event = None

        def copy(t: torch.Tensor) -> torch.Tensor:
            t = t.detach()
            host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                               pin_memory=t.is_cuda)
            host.copy_(t, non_blocking=t.is_cuda)
            if t.is_cuda and self._event is None:
                self._event = torch.cuda.Event()
            return host

        self._host = tree_map(copy, tree)
        if self._event is not None:
            self._event.record()

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self) -> Any:
        """The host tree, once the copies landed: the ``device_get``
        fault site, counted as ``host_syncs`` with its blocked seconds
        in ``host_sync_s``."""
        faults.check("device_get")
        t0 = time.perf_counter()
        if self._event is not None:
            self._event.synchronize()
        telemetry.COUNTERS.bump("host_syncs")
        telemetry.COUNTERS.bump("host_sync_s", time.perf_counter() - t0)
        return self._host


class EpochPrefetcher:
    """One-epoch-lookahead batch builder: runs ``build(epoch)`` (host
    sampling and the index batches' copy to the device) on a daemon
    thread while the in-flight epoch computes. One outstanding epoch at a
    time; ``get`` for another epoch than the one staged builds inline, so
    resumes stay correct. Safe because a ``DateBatchSampler`` call with an
    explicit epoch is a pure read."""

    def __init__(self, build: Callable[[int], Any]):
        self._build = build
        self._epoch: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._out: Optional[Dict[str, Any]] = None

    def start(self, epoch: int) -> None:
        if self._thread is not None and self._epoch == epoch:
            return
        self.cancel()
        out: Dict[str, Any] = {}

        def run():
            try:
                with telemetry.span("prefetch", cat="sample", epoch=epoch):
                    out["result"] = self._build(epoch)
            except BaseException as e:  # noqa: BLE001 — re-raised in get()
                out["error"] = e

        self._epoch, self._out = epoch, out
        self._thread = threading.Thread(
            target=run, name=f"lfm-epoch-prefetch-{epoch}", daemon=True)
        self._thread.start()

    def get(self, epoch: int) -> Any:
        """The staged batches of ``epoch`` (joins the builder), or an
        inline build on a miss."""
        if self._thread is None or self._epoch != epoch:
            self.cancel()
            return self._build(epoch)
        self._thread.join()
        out = self._out
        self._thread, self._epoch, self._out = None, None, None
        if "error" in out:
            raise out["error"]
        return out["result"]

    def cancel(self) -> None:
        """Join and discard a staged build (bounded by one epoch of host
        sampling), so it never races a ``rebind`` after ``fit``."""
        if self._thread is not None:
            self._thread.join()
        self._thread, self._epoch, self._out = None, None, None


class _InFlight(NamedTuple):
    """A dispatched epoch not yet settled: its queued fetch (the scalars
    and, when checkpointing, the state's host copy), the rollback
    snapshot, the firm-month count and its telemetry span."""

    epoch: int
    fetch: Fetch
    snap: Any
    fm: float
    span: Any


def run_fit_epochs(harness, state, *, build, dispatch, finish, timer,
                   checkpointing: bool,
                   snapshot: Optional[Callable[[Any], Any]] = None
                   ) -> Tuple[Any, Optional[int]]:
    """Drive a fit's epoch loop, lock-step or pipelined (``LFM_ASYNC``).

    ``harness``: ``epochs``, ``next_epoch()`` and ``end_epoch(epoch,
    step, state_dict, val_ic) -> stop`` (``FitHarness``); its
    ``preempt_flush`` runs on a grace stop.

    * ``build(epoch) -> (batches, firm_months)``: host sampling and the
      batches' copy to the device; must be thread-safe for explicit
      epochs (it runs on the prefetch thread in async mode).
    * ``dispatch(state, batches) -> (state, vals)``: queue the epoch's
      steps and the validation sweep; ``vals`` is a dict of device
      tensors (and host ints) fetched once. Must not wait for the device.
    * ``finish(epoch, host_vals, firm_months) -> (step, val_ic)``: log
      the epoch and return the step and the validation IC.
    * ``snapshot(state)``: the tree a checkpoint saves (device tensors,
      or None on a rank that does not write), copied to the host in the
      epoch's fetch when ``checkpointing``.

    Returns ``(final_state, overrun_epoch)``: the epoch queued when
    early stopping fired (discarded; the state is then the last recorded
    epoch's clone, which the caller adopts), or None."""
    async_mode = async_enabled()
    prefetch = EpochPrefetcher(build) if async_mode else None
    drained_at: Optional[float] = None

    def settle(p: _InFlight, drained: bool) -> bool:
        """Wait for one epoch's fetch, record it and run the harness's
        bookkeeping. True on early stop."""
        nonlocal drained_at
        with telemetry.span("eval_sync", epoch=p.epoch):
            host = p.fetch.wait()
        if drained:
            drained_at = time.perf_counter()
        timer.stop(firm_months=p.fm)
        timer.start()
        step, val_ic = finish(p.epoch, host["vals"], p.fm)
        with telemetry.span("ckpt", epoch=p.epoch, step=step):
            stop = harness.end_epoch(p.epoch, step, host["state"], val_ic)
        p.span.end(val_ic=round(val_ic, 6), stop=stop)
        return stop

    # (timestamp, whether the in-flight epoch had drained) at the end of
    # an iteration: a drained epoch makes every second until the next
    # dispatch measured device idle, a LOWER bound.
    probe: Optional[Tuple[float, bool]] = None

    timer.start()
    epoch = harness.next_epoch()
    inflight: Optional[_InFlight] = None
    overrun: Optional[int] = None
    try:
        with preempt.grace_scope():
            while epoch is not None:
                if preempt.requested():
                    # Grace stop: settle the in-flight epoch (recorded and
                    # checkpointed like any other), flush both lines
                    # (bounded), raise. No further dispatch.
                    if inflight is not None:
                        settle(inflight, drained=True)
                        last: Optional[int] = inflight.epoch
                        inflight = None
                    else:
                        le = getattr(harness, "last_epoch", 0) - 1
                        last = le if le >= 0 else None
                    flush = getattr(harness, "preempt_flush", None)
                    if flush is not None:
                        flush()
                    telemetry.instant("preempted", cat="fit", epoch=last)
                    raise preempt.Preempted(last)
                if prefetch is not None:
                    with telemetry.span("sample_wait", epoch=epoch):
                        batches, fm = prefetch.get(epoch)
                else:
                    batches, fm = build(epoch)
                if drained_at is not None:
                    telemetry.COUNTERS.bump(
                        "device_idle_s", time.perf_counter() - drained_at)
                    drained_at = None
                if probe is not None and probe[1]:
                    telemetry.COUNTERS.bump(
                        "device_idle_s", time.perf_counter() - probe[0])
                probe = None
                esp = telemetry.begin_async("epoch", epoch=epoch)
                with telemetry.span("dispatch", epoch=epoch):
                    state, vals = dispatch(state, batches)
                    tree = (snapshot(state)
                            if checkpointing and snapshot is not None
                            else None)
                    fetch = Fetch({"vals": vals, "state": tree})
                    snap = clone_state(state) if async_mode else None
                if not async_mode:
                    if settle(_InFlight(epoch, fetch, snap, fm, esp),
                              drained=True):
                        break
                    epoch = harness.next_epoch()
                    continue
                # Lookahead: stage e+1's batches and dispatch e+1 BEFORE
                # waiting for e's fetch; the harness's epoch counter moves
                # only when the previous epoch settles as "continue".
                cand = epoch + 1 if epoch + 1 < harness.epochs else None
                if cand is not None:
                    prefetch.start(cand)
                if inflight is not None:
                    if settle(inflight, drained=False):
                        # Early stop with `epoch` in flight: roll back to
                        # the last RECORDED epoch's clone.
                        overrun = epoch
                        esp.end(discarded=True)
                        telemetry.instant("lookahead_overrun", epoch=epoch)
                        state = inflight.snap
                        inflight = None
                        break
                    stepped = harness.next_epoch()
                    if stepped != epoch:  # pragma: no cover — invariant
                        raise RuntimeError(
                            f"pipeline epoch skew: dispatched {epoch}, "
                            f"harness advanced to {stepped}")
                inflight = _InFlight(epoch, fetch, snap, fm, esp)
                probe = (time.perf_counter(), fetch.ready())
                epoch = cand
            if inflight is not None:
                settle(inflight, drained=True)
    finally:
        if prefetch is not None:
            prefetch.cancel()
    return state, overrun
