"""Shape-bucket ladders: ragged request geometry rounded up to powers of two.

The serving half of ``lfm_quant_tpu/buckets.py``. A coalesced request
batch is padded to a ``(rows, width)`` bucket from a finite ladder, so
the service dispatches a bounded set of shapes and warmup can visit every
one. Padding wastes under 2x slots on a pow2 ladder; weight-0 slots cost
only FLOPs, never correctness (responses slice them off).
"""

from __future__ import annotations

from typing import List, Sequence

#: Smallest cross-section bucket.
MIN_WIDTH = 8


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
