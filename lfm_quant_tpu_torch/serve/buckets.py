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
