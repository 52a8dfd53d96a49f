"""Request-shape buckets and the serving knobs' defaults.

Both axes of a scoring dispatch are ragged: the month's eligible
cross-section and the number of requests the batcher coalesced. Each is
rounded up to a power-of-two bucket (``lfm_quant_tpu_torch/buckets.py``)
and padded with weight-0 slots, as ``lfm_quant_tpu/serve/buckets.py``
does.
"""

from __future__ import annotations

import os
from typing import Tuple

from lfm_quant_tpu_torch.buckets import (  # noqa: F401 — re-exports
    bucket_width,
    next_pow2,
    rows_ladder,
    width_ladder,
)

BucketKey = Tuple[int, int]  # (rows, cross-section width)


def bucket_rows(n_requests: int, max_rows: int) -> int:
    """Row (coalesced-request) bucket: next power of two, capped at the
    batcher's ``max_rows`` (the cap is itself a ladder member)."""
    if n_requests < 1:
        raise ValueError(f"bucket_rows needs >= 1 request, got {n_requests}")
    return min(next_pow2(n_requests), next_pow2(max_rows))


def max_rows_default() -> int:
    """``LFM_SERVE_MAX_ROWS``: the micro-batch row cap (default 8)."""
    return max(1, int(os.environ.get("LFM_SERVE_MAX_ROWS", "8")))


def max_wait_ms_default() -> float:
    """``LFM_SERVE_MAX_WAIT_MS``: how long the batcher holds a batch
    open for more same-bucket requests (default 2 ms)."""
    return float(os.environ.get("LFM_SERVE_MAX_WAIT_MS", "2"))


def zoo_capacity_default() -> int:
    """``LFM_SERVE_ZOO``: resident universes before LRU eviction
    (default 8)."""
    return max(1, int(os.environ.get("LFM_SERVE_ZOO", "8")))


# ---- degradation knobs -----------------------------------
# Operational defaults for the graceful-degradation layer, resolved here
# beside the other LFM_SERVE_* knobs so the batcher has one place to
# read and the knob checker one place to find.


def queue_max_default() -> int:
    """``LFM_SERVE_QUEUE_MAX``: bounded admission — a submit that finds
    this many requests already queued is SHED (429-path ShedError)
    instead of growing the queue without bound (default 256; <= 0
    disables the bound — the pre-chaos behavior)."""
    return int(os.environ.get("LFM_SERVE_QUEUE_MAX", "256"))


def deadline_ms_default() -> float:
    """``LFM_SERVE_DEADLINE_MS``: default per-request deadline in ms
    (0, the default, = none). A request whose deadline expires before
    dispatch is dropped (504-path DeadlineError) WITHOUT costing a
    device dispatch; ``score(timeout=...)`` propagates the client
    timeout as the deadline regardless of this knob."""
    return float(os.environ.get("LFM_SERVE_DEADLINE_MS", "0"))


def retries_default() -> int:
    """``LFM_SERVE_RETRIES``: bounded jittered retries of the surviving
    batch on a TRANSIENT dispatch failure (serve/errors.py
    ``is_transient``; default 2 — i.e. up to 3 attempts)."""
    return max(0, int(os.environ.get("LFM_SERVE_RETRIES", "2")))


def breaker_threshold_default() -> int:
    """``LFM_SERVE_BREAKER``: consecutive exhausted dispatch failures
    that OPEN the circuit breaker (default 4; <= 0 disables it)."""
    return int(os.environ.get("LFM_SERVE_BREAKER", "4"))


def breaker_cooldown_ms_default() -> float:
    """``LFM_SERVE_BREAKER_COOLDOWN_MS``: how long an OPEN circuit
    fast-fails (503 + retry-after) before admitting a half-open probe
    (default 250 ms)."""
    return float(os.environ.get("LFM_SERVE_BREAKER_COOLDOWN_MS", "250"))
