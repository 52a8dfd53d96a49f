"""Latency statistics for the scoring service — pure python (the JAX
package's ``serve/stats.py``)."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Linear-interpolation percentile (numpy's default rule) over a
    small sample; None on empty input. ``q`` in [0, 100]."""
    if not values:
        return None
    v = sorted(values)
    k = (len(v) - 1) * q / 100.0
    f, c = math.floor(k), math.ceil(k)
    if f == c:
        return float(v[int(k)])
    return float(v[f] * (c - k) + v[c] * (k - f))


def latency_summary(lat_ms: Sequence[float]) -> dict:
    """The serve latency rollup ``stats()`` reports."""
    return {
        "requests": len(lat_ms),
        "p50_ms": percentile(lat_ms, 50.0),
        "p99_ms": percentile(lat_ms, 99.0),
        "max_ms": max(lat_ms) if lat_ms else None,
    }
