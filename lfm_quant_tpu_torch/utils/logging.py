"""Structured run metrics and step timing.

``MetricsLogger`` is the port of ``lfm_quant_tpu/utils/logging.py``: an
append-only ``metrics.jsonl`` stream per run directory, one strict-JSON
dict per line (non-finite floats written as ``null``). ``StepTimer`` is
the port of ``utils/profiling.py``'s timer in firm-months per second; on
the card it synchronises the device at both ends of an interval, so a
time is the device's, not the enqueue's.
"""

from __future__ import annotations

import json
import math
import os
import time
import warnings
from typing import Any, Dict, Optional, Union

import torch


def _finite(v: Any) -> Any:
    """Non-finite floats → None, recursively through containers (a bare
    ``NaN`` token is not JSON)."""
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, (list, tuple)):
        return [_finite(x) for x in v]
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    return v


class MetricsLogger:
    """Append-only JSONL metric stream (one dict per line, ts + step
    added). The dict returned to the caller keeps the original values."""

    def __init__(self, run_dir: Optional[str],
                 filename: str = "metrics.jsonl", echo: bool = False):
        self.run_dir = run_dir
        self.echo = echo
        self._fh = None
        if run_dir is not None:
            os.makedirs(run_dir, exist_ok=True)
            self._fh = open(os.path.join(run_dir, filename), "a",
                            buffering=1)

    def log(self, step: int, **metrics: Any) -> Dict[str, Any]:
        rec = {"ts": time.time(), "step": step}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        if self._fh or self.echo:
            line = {k: _finite(v) for k, v in rec.items()}
            if self._fh:
                self._fh.write(json.dumps(line, allow_nan=False) + "\n")
            if self.echo:
                shown = {k: v for k, v in line.items() if k != "ts"}
                print(json.dumps(shown, allow_nan=False))
        return rec

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class StepTimer:
    """Interval timer with firm-month accounting.

    ``start()`` and ``stop(firm_months=n)`` bracket device work; on a CUDA
    device both synchronise it first, so queued kernels are inside the
    interval. ``throughput()`` is firm-months per second over the
    recorded intervals."""

    def __init__(self, device: Union[str, torch.device] = "cpu"):
        self.device = torch.device(device)
        self.reset()

    def reset(self) -> None:
        self._t0: Optional[float] = None
        self.seconds = 0.0
        self.firm_months = 0.0
        self.steps = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self, firm_months: float = 0.0) -> float:
        """Record one interval since :meth:`start`; returns its seconds. A
        stop with no open interval warns and records nothing."""
        if self._t0 is None:
            warnings.warn("StepTimer.stop() called before start(); "
                          "ignoring this stop", RuntimeWarning, stacklevel=2)
            return 0.0
        self._sync()
        dt = time.perf_counter() - self._t0
        self.seconds += dt
        self.firm_months += firm_months
        self.steps += 1
        self._t0 = None
        return dt

    def throughput(self) -> float:
        return self.firm_months / self.seconds if self.seconds > 0 else 0.0
