"""Backtest layer: forecasts → portfolio → performance report.

Two engines, one contract (the port of ``lfm_quant_tpu/backtest``):

* ``engine`` — the numpy reference (a host loop over months), the golden
  reference of the tests and ``chip_smoke.py``. Reached only by importing
  it by name.
* ``torch_engine`` — every month of every aggregation mode in one pass on
  the device.

``resolve_backtest(device)`` gives the entry points the device engine on
the trainer's device. Unlike the JAX package it has no environment knob
and never falls back to numpy: with no card, it raises.
"""

import functools

from lfm_quant_tpu_torch.backtest.engine import (
    BacktestReport,
    aggregate_ensemble,
    assemble_report,
    run_backtest,
)
from lfm_quant_tpu_torch.backtest.torch_engine import run_backtest_torch
from lfm_quant_tpu_torch.device import resolve_device


def resolve_backtest(device=None):
    """The backtest callable of the entry points: ``run_backtest_torch``
    bound to ``device`` (None means ``cuda``; a missing card raises here,
    before any work)."""
    return functools.partial(run_backtest_torch,
                             device=resolve_device(device))


__all__ = [
    "BacktestReport",
    "run_backtest",
    "run_backtest_torch",
    "aggregate_ensemble",
    "assemble_report",
    "resolve_backtest",
]
