"""The scoring service: zoo + batcher, one object.

Port of ``lfm_quant_tpu/serve/service.py``: ``register`` a model per
universe, ``warmup`` every request-shape bucket the universe can produce,
then ``score`` / ``submit`` serve month queries. The service owns the
device: every registered model and its panel live there. Refresh (which
needs training), persistence, metrics and the fleet come with later
slices (ROADMAP.md Queue A).
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from lfm_quant_tpu_torch.config import RunConfig
from lfm_quant_tpu_torch.data.panel import Panel
from lfm_quant_tpu_torch.device import resolve_device
from lfm_quant_tpu_torch.serve import buckets
from lfm_quant_tpu_torch.serve.batcher import MicroBatcher, ScoreResponse
from lfm_quant_tpu_torch.serve.zoo import ModelZoo, ZooEntry
from lfm_quant_tpu_torch.train.loop import Predictor


class ScoringService:
    """One serving object. ``device``: None means ``cuda`` (raises with
    no card); ``"cpu"`` serves through the kernels' plain versions."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None,
                 zoo_capacity: Optional[int] = None,
                 max_rows: Optional[int] = None,
                 max_wait_ms: Optional[float] = None):
        self.device = resolve_device(device)
        self.zoo = ModelZoo(zoo_capacity or buckets.zoo_capacity_default())
        self.max_rows = max_rows or buckets.max_rows_default()
        self.batcher = MicroBatcher(
            self.zoo, self.max_rows,
            buckets.max_wait_ms_default() if max_wait_ms is None
            else max_wait_ms)

    # ---- registration / warmup --------------------------------------

    def register(self, universe: str, cfg: RunConfig, panel: Panel,
                 params: Optional[Mapping[str, Any]] = None, *,
                 warm: bool = True) -> ZooEntry:
        """Serve ``cfg``'s model over ``panel`` as ``universe``:
        generation 0, or the next one if the universe is registered.
        ``params`` is a Flax param tree (numpy arrays) or None for a
        seeded init. ``warm=True`` dispatches every (rows, width) bucket
        once before the entry goes live."""
        try:
            gen = self.zoo.current(universe).generation + 1
        except KeyError:
            gen = 0
        entry = ZooEntry(universe, gen,
                         Predictor(cfg, panel, params, device=self.device))
        if warm:
            self.warmup_entry(entry)
        self.zoo.publish(entry)
        return entry

    def warmup_entry(self, entry: ZooEntry) -> int:
        """Dispatch one zero-weight batch per (rows, width) bucket the
        entry can produce (the first builds the kernels). Returns the
        bucket count."""
        widths = entry.widths()
        cols = entry.serveable_cols()
        ladder = buckets.rows_ladder(self.max_rows)
        t0 = int(cols[0])
        for width in widths:
            for rows in ladder:
                entry.score(np.zeros((rows, width), np.int32),
                            np.full((rows,), t0, np.int32),
                            np.zeros((rows, width), np.float32))
        return len(widths) * len(ladder)

    # ---- query path --------------------------------------------------

    def submit(self, universe: str, month: int) -> Future:
        """Async query: a Future of a :class:`ScoreResponse`."""
        return self.batcher.submit(universe, month)

    def score(self, universe: str, month: int,
              timeout: Optional[float] = 60.0) -> ScoreResponse:
        """Sync query: the month's scored cross-section."""
        return self.batcher.submit(universe, month).result(timeout=timeout)

    def serveable_months(self, universe: str) -> List[int]:
        return self.zoo.current(universe).serveable_months()

    # ---- observability / lifecycle -----------------------------------

    def stats(self) -> Dict[str, Any]:
        """Requests served, req/s over the stats window, p50/p99 latency
        and batch occupancy, plus the routing table."""
        out = self.batcher.stats()
        out["device"] = str(self.device)
        out["universes"] = {u: self.zoo.current(u).generation
                            for u in self.zoo.universes()}
        return out

    def reset_stats(self) -> None:
        self.batcher.reset_stats()

    def close(self) -> None:
        self.batcher.close()

    def __enter__(self) -> "ScoringService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
