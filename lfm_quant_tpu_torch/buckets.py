"""Shape-bucket ladders: ragged geometry rounded up to a finite ladder.

The port of ``lfm_quant_tpu/buckets.py``, both halves:

* **Serving**: a coalesced request batch is padded to a ``(rows,
  width)`` bucket from a pow2 ladder, so the service dispatches a bounded
  set of shapes and warmup can visit every one.
* **Training and batch scoring** (``LFM_BUCKETS``, ``data/windows.py
  bucket_geometry``): dates and eval months are grouped on a (lookback
  rows × cross-section width) ladder instead of padding every batch to
  the one max shape, so thin dates stop carrying weight-0 pad columns and
  short-history cohorts stop paying the full window's scan.

Padding wastes under 2x slots on a pow2 ladder; weight-0 slots and
masked steps cost only FLOPs, never correctness: the weighted losses and
metrics treat w = 0 entries as absent and the recurrent models HOLD their
state through masked steps, which is what makes a bucketed batch's
results those of the same batch padded to the max shape.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

#: Smallest cross-section bucket.
MIN_WIDTH = 8

#: Smallest lookback-rows bucket: below this the per-dispatch fixed
#: costs dwarf the scan savings, and the eligibility floor
#: (``min_valid_months``, default window//2) rarely admits shorter
#: histories anyway.
MIN_LOOKBACK = 8

#: A training-geometry bucket: (lookback rows W_b, cross-section width).
TrainBucket = Tuple[int, int]


def next_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def bucket_width(n_firms: int) -> int:
    """Cross-section bucket for a month's eligible pool: next power of
    two, floored at :data:`MIN_WIDTH`."""
    if n_firms < 1:
        raise ValueError(f"bucket_width needs >= 1 firm, got {n_firms}")
    return next_pow2(n_firms, MIN_WIDTH)


def rows_ladder(max_rows: int) -> List[int]:
    """Every row bucket a pow2 ladder capped at ``max_rows`` can
    produce: 1, 2, 4, ... max bucket."""
    top = next_pow2(max_rows)
    out, r = [], 1
    while r <= top:
        out.append(r)
        r <<= 1
    return out


def width_ladder(pool_sizes: Sequence[int]) -> List[int]:
    """The distinct cross-section buckets a universe's serveable months
    occupy (sorted ascending)."""
    return sorted({bucket_width(int(n)) for n in pool_sizes if n > 0})


def capped_width(n: int, cap: int) -> int:
    """Cross-section bucket CAPPED at ``cap`` — the cap itself is a
    ladder member, so the widest months produce exactly the legacy
    max-shape batch (bit-for-bit the un-bucketed geometry) while thin
    months ride the pow2 rungs below it."""
    if cap < 1:
        raise ValueError(f"capped_width needs cap >= 1, got {cap}")
    return min(bucket_width(max(1, n)), cap)


def width_rungs(cap: int) -> List[int]:
    """Every width :func:`capped_width` can produce under ``cap``:
    the pow2 rungs in [MIN_WIDTH, cap) plus ``cap`` itself (ascending)."""
    out = [w for w in
           (MIN_WIDTH << i for i in range(max(1, cap).bit_length()))
           if w < cap]
    return out + [cap]


def lookback_rungs(window: int) -> List[int]:
    """The lookback-rows ladder for a ``window``-month model: pow2 rungs
    in [MIN_LOOKBACK, window) plus the full ``window`` itself (the cap
    member — anchors with deep history pay exactly the legacy scan)."""
    if window < 1:
        raise ValueError(f"lookback_rungs needs window >= 1, got {window}")
    out = [r for r in
           (MIN_LOOKBACK << i for i in range(window.bit_length()))
           if r < window]
    return out + [window]


def bucket_lookback(depth: int, window: int) -> int:
    """Smallest lookback rung >= ``depth`` (the trailing-window span an
    anchor's valid history actually occupies), capped at ``window``."""
    for r in lookback_rungs(window):
        if r >= depth:
            return r
    return window


def buckets_enabled() -> bool:
    """``LFM_BUCKETS=1`` opts training and batch scoring into the
    (lookback × width) geometry-bucket ladder (``data/windows.py``).
    Default OFF: bucketing regroups batches by geometry, which changes
    batch COMPOSITION (never a batch's numerics), so it is an explicit
    opt-in."""
    return os.environ.get("LFM_BUCKETS", "0") not in ("0", "")
