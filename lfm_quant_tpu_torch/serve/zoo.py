"""The model zoo: many (universe, generation) models resident on the card.

Port of ``lfm_quant_tpu/serve/zoo.py``. A :class:`ZooEntry` is one
servable generation: a :class:`~lfm_quant_tpu_torch.train.loop.Predictor`
(model, params, device panel; a refreshed generation's is the
:class:`~lfm_quant_tpu_torch.train.loop.Trainer` that fitted it) plus its
serving pools, built with ``require_target=False`` so the live months are
servable, and its score-drift sketches. The JAX package compiles one
program per request-shape bucket (``ServePrograms``, ``adopt_programs``,
the AOT export); PyTorch runs eagerly, so an entry scores any bucket
through the same predictor and none of those has a counterpart.

Lifecycle, all under the zoo's lock: the batcher scores through
:meth:`ModelZoo.lease`, which pins the entry for the dispatch; a publish,
an LRU eviction or a :meth:`ModelZoo.drop` unlinks an entry at once (new
requests route to the new generation or miss) and releases its device
memory only when its last lease drains.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from lfm_quant_tpu_torch.data.windows import DateBatchSampler
from lfm_quant_tpu_torch.serve.buckets import width_ladder
from lfm_quant_tpu_torch.utils import faults, metrics, telemetry


class ZooEntry:
    """One servable (universe, generation) model resident on the device."""

    def __init__(self, universe: str, generation: int, predictor):
        self.universe = universe
        self.generation = int(generation)
        self.predictor = predictor
        self.cfg = predictor.cfg
        self.panel = predictor.panel
        d = self.cfg.data
        # Pools over the whole panel, live months included.
        self._sampler = DateBatchSampler(
            self.panel, d.window, 1, 8, min_valid_months=d.min_valid_months,
            min_cross_section=1, require_target=False)
        months = self._sampler.months_with_anchors()
        self._month_index: Dict[int, int] = {
            int(self.panel.dates[t]): int(t) for t in months}
        self._pool_sizes = {int(t): self._sampler.cross_section(int(t)).size
                            for t in months}
        # Score-drift sketches (utils/metrics.py ScoreSketch): the
        # reference is stamped at publish from the generation's scored
        # months, the live twin streams from served responses. None
        # until the service stamps them (metrics off, or warm=False).
        self.ref_sketch = None
        self.live_sketch = None
        # Zoo bookkeeping (guarded by the zoo's lock).
        self.refs = 0
        self.doomed = False

    # ---- serveable geometry -----------------------------------------

    def serveable_months(self) -> List[int]:
        """YYYYMM months with a non-empty scoreable cross-section."""
        return sorted(self._month_index)

    def serveable_cols(self) -> np.ndarray:
        """Panel columns of the serveable months (int32, sorted)."""
        return self._sampler.months_with_anchors()

    def month_col(self, yyyymm: int) -> int:
        """Panel column of a serveable YYYYMM month (the KeyError names
        the universe — the error a client sees)."""
        try:
            return self._month_index[int(yyyymm)]
        except KeyError:
            raise KeyError(
                f"month {yyyymm} is not serveable for universe "
                f"{self.universe!r} (no eligible cross-section)") from None

    def pool(self, t: int) -> np.ndarray:
        return self._sampler.cross_section(t)

    def pool_size(self, t: int) -> int:
        """Memoized pool size: submit needs only the width bucket."""
        return self._pool_sizes.get(int(t), 0)

    def widths(self) -> List[int]:
        """Every cross-section bucket this universe's months occupy."""
        return width_ladder(self._pool_sizes.values())

    # ---- scoring -----------------------------------------------------

    def score_device(self, firm_idx: np.ndarray, time_idx: np.ndarray,
                     weight: np.ndarray) -> torch.Tensor:
        """Served scores for one padded ``[rows, width]`` bucket (weight-0
        slots zeroed), left on the device: the caller takes the one
        device→host copy of the dispatch."""
        return self.predictor.score_device(firm_idx, time_idx, weight)

    def score(self, firm_idx: np.ndarray, time_idx: np.ndarray,
              weight: np.ndarray) -> np.ndarray:
        """:meth:`score_device`, on the host."""
        return self.score_device(firm_idx, time_idx, weight).cpu().numpy()

    # ---- score-drift sketches ----------------------------------------

    def stamp_reference(self, sketch) -> None:
        """Attach the publish-time reference sketch and its empty live
        twin (same bin edges, so the two are always comparable)."""
        self.ref_sketch = sketch
        self.live_sketch = sketch.live_twin()

    def record_scores(self, scores) -> None:
        """Stream served scores (host arrays: one, or a list of
        per-request arrays) into the live sketch: lazy appends, folded
        by readers. Exact no-op when no reference was stamped or
        ``LFM_METRICS=0``."""
        if self.live_sketch is None or not metrics.enabled():
            return
        if isinstance(scores, (list, tuple)):
            for a in scores:
                self.live_sketch.record_lazy(a)
        else:
            self.live_sketch.record_lazy(scores)

    def drift_psi(self, min_scores: int = 1):
        """PSI of the live served-score distribution against the
        publish-time reference; None until sketches exist and the live
        one holds at least ``min_scores`` scores."""
        if self.ref_sketch is None or self.live_sketch is None:
            return None
        if self.live_sketch.size() < max(1, int(min_scores)):
            return None
        return self.ref_sketch.psi(self.live_sketch)

    # ---- resident-footprint metadata ---------------------------------

    def param_bytes(self) -> int:
        """Resident parameter bytes, from tensor metadata (no device
        read)."""
        pred = self.predictor
        if pred is None:
            return 0
        return int(sum(p.nelement() * p.element_size()
                       for p in pred.model.parameters()))

    def panel_bytes(self) -> int:
        """Resident panel bytes (the packed panel at the entry's compute
        dtype and the f32 targets), from tensor metadata."""
        pred = self.predictor
        if pred is None:
            return 0
        return int(sum(t.nelement() * t.element_size()
                       for t in pred.dev.values()))


class ModelZoo:
    """The routing table: universe name → current resident generation."""

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, ZooEntry]" = OrderedDict()

    def universes(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def current(self, universe: str) -> ZooEntry:
        with self._lock:
            entry = self._entries.get(universe)
            if entry is None:
                raise KeyError(
                    f"universe {universe!r} is not registered "
                    f"(resident: {list(self._entries)})")
            return entry

    def snapshot(self) -> Dict[str, Any]:
        """One-lock routing-table snapshot: ``{universes: {name: gen},
        size, capacity}`` — what the service's snapshot and the
        monitor's gauges read, never torn by a concurrent publish."""
        with self._lock:
            return {
                "universes": {u: e.generation
                              for u, e in self._entries.items()},
                "size": len(self._entries),
                "capacity": self.capacity,
            }

    def __len__(self) -> int:
        return len(self._entries)

    @contextlib.contextmanager
    def lease(self, universe: str):
        """Pin the universe's current entry for one dispatch. It stays
        servable for the whole block even if a publish or an eviction
        unlinks it meanwhile; release waits for the last lease. The
        ``zoo_lease`` fault site is checked first, outside the lock."""
        faults.check("zoo_lease", universe=universe)
        with self._lock:
            entry = self._entries.get(universe)
            if entry is None:
                raise KeyError(f"universe {universe!r} is not registered "
                               f"(resident: {list(self._entries)})")
            self._entries.move_to_end(universe)  # LRU recency
            entry.refs += 1
        try:
            yield entry
        finally:
            with self._lock:
                entry.refs -= 1
                dead = entry.doomed and entry.refs == 0
            if dead:
                self._decommission(entry)

    def publish(self, entry: ZooEntry) -> Optional[ZooEntry]:
        """Atomically make ``entry`` the served generation of its
        universe; returns the replaced entry (already unlinked). A new
        universe over capacity evicts the least recently leased one."""
        evicted: List[ZooEntry] = []
        with self._lock:
            old = self._entries.get(entry.universe)
            if old is not None and old.generation >= entry.generation:
                raise ValueError(
                    f"universe {entry.universe!r}: generation "
                    f"{entry.generation} does not advance the served "
                    f"generation {old.generation}")
            self._entries[entry.universe] = entry
            self._entries.move_to_end(entry.universe)
            if old is not None:
                old.doomed = True
                if old.refs == 0:
                    evicted.append(old)
            while len(self._entries) > self.capacity:
                _, lru = self._entries.popitem(last=False)
                telemetry.COUNTERS.bump("serve_zoo_evictions")
                lru.doomed = True
                if lru.refs == 0:
                    evicted.append(lru)
        for e in evicted:
            self._decommission(e)
        if old is not None:
            telemetry.instant("zoo_swap", cat="serve",
                              universe=entry.universe,
                              generation=entry.generation)
        return old

    def drop(self, universe: str) -> None:
        """Unregister a universe (tests, operators)."""
        with self._lock:
            entry = self._entries.pop(universe, None)
            if entry is None:
                return
            entry.doomed = True
            dead = entry.refs == 0
        if dead:
            self._decommission(entry)

    @staticmethod
    def _decommission(entry: ZooEntry) -> None:
        """Release a dead entry's device memory: dropping the predictor
        frees its panel and params once nothing else holds them."""
        entry.predictor = None
        telemetry.COUNTERS.bump("serve_zoo_decommissions")
