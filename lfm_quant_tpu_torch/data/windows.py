"""Windowing: anchor eligibility, the date-batch sampler, the device panel
and the plain window gather.

The port of ``lfm_quant_tpu/data/windows.py``: the sampler with its
Python and native (C++, ``native/``) engines, the serving pools, the eval
sweep and the geometry buckets (``LFM_BUCKETS``: ``bucket_geometry``,
``bucketed_epoch``, ``bucketed_cross_sections``, copied from the JAX
package; ``stacked_eval_months`` and ``stack_fold_epochs``, the stacked
runs' shape probe and batch supply). The panel lives on the device as
one packed tensor ``xm [N, T, F+1]``
(features with validity appended as the last column) in the compute
dtype; a batch is an index pair ``firm_idx [D, Bf]`` / ``time_idx [D]``
that the window gather turns into ``(x [D, Bf, W, F], m [D, Bf, W])``.

The JAX package pads ``xm`` to 128 lanes and 8 months for its TPU DMA
gather; those are Mosaic constraints and the port stores ``xm`` unpadded.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from lfm_quant_tpu_torch.buckets import TrainBucket, capped_width, lookback_rungs
from lfm_quant_tpu_torch.data.panel import Panel

log = logging.getLogger(__name__)

#: Full-universe widths from ``2 * FIRM_CHUNK`` up round to this multiple.
FIRM_CHUNK = 512


@dataclasses.dataclass
class WindowIndex:
    """One batch of window anchors in the [D, Bf] per-date layout:
    ``firm_idx [D, Bf]`` int32 panel rows, ``time_idx [D]`` int32 anchor
    months, ``weight [D, Bf]`` float32 (0 marks padding)."""

    firm_idx: np.ndarray
    time_idx: np.ndarray
    weight: np.ndarray


def rolling_valid_count(valid: np.ndarray, window: int) -> np.ndarray:
    """``[N, T]`` count of valid months in the trailing window ``[t-W+1, t]``."""
    csum = np.cumsum(valid.astype(np.int64), axis=1)
    total = np.empty_like(csum)
    total[:, :window] = csum[:, :window]
    total[:, window:] = csum[:, window:] - csum[:, :-window]
    return total


def anchor_index(
    panel: Panel, window: int, min_valid_months: Optional[int] = None,
    require_target: bool = True,
) -> np.ndarray:
    """``[N, T]`` bool eligibility of window anchors: the anchor month is
    valid and the trailing window holds at least ``min_valid_months``
    valid months (default W//2). ``require_target=True`` also needs the
    target observable at t (training/backtest); serving passes False so
    the live months, whose targets lie in the future, are scoreable."""
    if min_valid_months is None:
        min_valid_months = max(1, window // 2)
    total = rolling_valid_count(panel.valid, window)
    elig = (total >= min_valid_months) & panel.valid
    return elig if not require_target else elig & panel.target_valid


@dataclasses.dataclass
class BucketGeometry:
    """A sampler's (lookback-rows × cross-section-width) bucket ladder
    (``LFM_BUCKETS``): the epoch-invariant assignment of
    training dates and eval months to shape buckets, so every batch a
    bucketed epoch can ever emit has a shape from a finite, known
    ladder — each rung compiles exactly once (the compile-once totality
    argument, same as the serving ladder's warmup).

    Buckets are keyed ``(lookback_rows, width)``; the cap bucket
    ``(window, width_cap)`` reproduces the legacy max-shape geometry
    bit-for-bit. ``train_buckets`` maps bucket → training-date array
    (small buckets folded into a containing bucket so every bucket
    fills whole [D]-date batches); ``eval_buckets`` maps bucket →
    POSITIONS into the stacked eval-month order (what
    ``stacked_cross_sections`` would emit), so per-month outputs
    reassemble exactly."""

    window: int
    width_cap: int        # the static training Bf widths are capped at
    eval_width_cap: int   # the panel-wide eval pad width (_eval_bf)
    train_buckets: "OrderedDict[TrainBucket, np.ndarray]"
    eval_buckets: "OrderedDict[TrainBucket, np.ndarray]"

    def summary(self, dates_per_batch: int) -> Dict[str, object]:
        """JSON-able geometry digest (telemetry instant / bench row):
        per-epoch dispatched firm-month cells on the bucket ladder vs
        the same batches padded to max shape, and the eval-sweep twin.
        'Cells' are firm-month positions inside a dispatch — the FLOP
        unit every padding cost here scales with."""
        tr_disp = tr_max = 0
        for (lb, w), dates in self.train_buckets.items():
            nb = dates.size // dates_per_batch
            tr_disp += nb * dates_per_batch * w * lb
            tr_max += nb * dates_per_batch * self.width_cap * self.window
        ev_disp = ev_max = 0
        for (lb, w), pos in self.eval_buckets.items():
            ev_disp += pos.size * w * lb
            ev_max += pos.size * self.eval_width_cap * self.window
        return {
            "ladder": sorted([list(k) for k in
                              set(self.train_buckets) | set(self.eval_buckets)]),
            "n_train_buckets": len(self.train_buckets),
            "n_eval_buckets": len(self.eval_buckets),
            "train_cells_bucketed": int(tr_disp),
            "train_cells_max_shape": int(tr_max),
            "eval_cells_bucketed": int(ev_disp),
            "eval_cells_max_shape": int(ev_max),
        }


class DateBatchSampler:
    """Seed-keyed sampler over per-month eligible pools, emitting
    ``WindowIndex`` batches in the [D, Bf] layout: the JAX package's
    ``DateBatchSampler`` with its Python engine.

    Every epoch shuffles the eligible training dates and, for each date,
    samples ``firms_per_date`` eligible firms without replacement; all
    randomness flows from ``(seed, epoch)`` through the same numpy draws in
    the same order as the JAX package, so both give the same batches.
    ``firms_per_date=0`` is full-universe mode: each row carries a date's
    whole pool, padded to the largest training pool rounded up (to a
    multiple of ``FIRM_CHUNK`` from ``2 * FIRM_CHUNK`` up, else of 8).
    ``date_range=(lo, hi)`` bounds the ANCHOR months to panel columns
    [lo, hi); windows still reach back before ``lo``. Serving and the eval
    sweep read the pools over every month with an eligible anchor
    (``months_with_anchors``, ``cross_section``, ``full_cross_sections``).

    ``engine``: "python" (numpy draws, the JAX package's byte-equal
    stream), "native" (the C++ sampler of ``native/panel_native.cpp``:
    its own deterministic stream keyed by (seed, epoch), the JAX native
    engine's byte for byte; raises when the library cannot be built) or
    "auto" (native when ``g++`` builds it, else Python; the choice is
    logged).
    """

    def __init__(self, panel: Panel, window: int, dates_per_batch: int,
                 firms_per_date: int, seed: int = 0,
                 min_valid_months: Optional[int] = None,
                 min_cross_section: int = 8,
                 date_range: Optional[tuple] = None,
                 engine: str = "python", require_target: bool = True):
        self.window = window
        self.dates_per_batch = dates_per_batch
        if firms_per_date < 0:
            raise ValueError(
                f"firms_per_date must be >= 0 (0 = full universe), got "
                f"{firms_per_date}")
        self.firms_per_date = firms_per_date
        self.seed = seed
        if engine not in ("python", "native", "auto"):
            raise ValueError(
                f"engine must be python|native|auto, got {engine!r}")
        self.engine = engine
        # For the lazy geometry-bucket analysis (bucket_geometry): the
        # lookback-rung test reads validity counts at each rung.
        self._valid = panel.valid
        self._bucket_geo: Optional[BucketGeometry] = None
        eligible = anchor_index(panel, window, min_valid_months,
                                require_target=require_target)
        # Panel-wide max cross-section, before the date_range bound: the
        # static eval pad width, the same for every split.
        self._eval_bf = int(eligible.sum(axis=0).max())
        if date_range is not None:
            lo, hi = date_range
            if not (0 <= lo < hi <= panel.n_months):
                raise ValueError(
                    f"date_range {date_range} outside panel months "
                    f"[0, {panel.n_months})")
            bounded = np.zeros_like(eligible)
            bounded[:, lo:hi] = eligible[:, lo:hi]
            eligible = bounded
        counts = eligible.sum(axis=0)
        self._dates = np.nonzero(counts >= min_cross_section)[0].astype(
            np.int32)
        if self._dates.size == 0:
            raise ValueError(
                "no date has an eligible cross-section >= "
                f"{min_cross_section}; panel too small for window={window}")
        if self._dates.size < dates_per_batch:
            raise ValueError(
                f"dates_per_batch={dates_per_batch} exceeds the "
                f"{self._dates.size} eligible dates in the panel")
        # Eval sweeps cover every date with an eligible anchor; the
        # min_cross_section filter is a training concern only.
        self._all_dates = np.nonzero(counts > 0)[0].astype(np.int32)
        self._firms_by_date = {
            int(t): np.nonzero(eligible[:, t])[0].astype(np.int32)
            for t in self._all_dates
        }
        if self.firms_per_date == 0:
            mx = max(self._firms_by_date[int(t)].size for t in self._dates)
            mult = FIRM_CHUNK if mx >= 2 * FIRM_CHUNK else 8
            self.firms_per_date = -(-mx // mult) * mult
        # CSR pools over the TRAINING dates, for the native sampler.
        pools = [self._firms_by_date[int(t)] for t in self._dates]
        self._pool_offs = np.zeros(len(pools) + 1, np.int64)
        np.cumsum([p.size for p in pools], out=self._pool_offs[1:])
        self._pool_flat = (np.concatenate(pools) if pools
                           else np.zeros(0, np.int32))
        self._native: Optional[bool] = None
        self._epoch = 0

    def reseeded(self, seed: int) -> "DateBatchSampler":
        """This sampler under another seed: the seed is read only when an
        epoch is drawn, so the eligibility, pools and geometry (read-only
        arrays) are shared, not recomputed (an ensemble's members)."""
        out = copy.copy(self)
        out.seed = seed
        return out

    def _use_native(self) -> bool:
        """Whether this sampler draws with the C++ engine: "native"
        raises when the library does not build, "auto" takes it when it
        does (resolved once, and logged)."""
        if self.engine == "python":
            return False
        if self._native is None:
            from lfm_quant_tpu_torch import native

            ok = native.available()
            if not ok and self.engine == "native":
                raise RuntimeError(
                    "engine='native' but the native library is "
                    "unavailable (g++ could not build "
                    "lfm_quant_tpu_torch/native/panel_native.cpp)")
            log.info("DateBatchSampler engine=%r: the %s sampler",
                     self.engine, "native" if ok else "Python")
            self._native = ok
        return self._native

    def _native_epoch(self, epoch: int) -> WindowIndex:
        """One epoch as stacked ``[K, D, Bf]`` arrays from the C++
        sampler (``sample_epoch`` in ``native/panel_native.cpp``)."""
        import ctypes

        from lfm_quant_tpu_torch import native

        lib = native.get_lib()
        D, bf = self.dates_per_batch, self.firms_per_date
        K = self.batches_per_epoch()
        fi = np.empty((K, D, bf), np.int32)
        ti = np.empty((K, D), np.int32)
        w = np.empty((K, D, bf), np.float32)

        def p(a, ty):
            return a.ctypes.data_as(ctypes.POINTER(ty))

        got = lib.sample_epoch(
            p(self._dates, ctypes.c_int32), self._dates.size,
            p(self._pool_flat, ctypes.c_int32),
            p(self._pool_offs, ctypes.c_int64),
            self.seed, epoch, D, bf,
            p(fi, ctypes.c_int32), p(ti, ctypes.c_int32),
            p(w, ctypes.c_float))
        if got != K:
            raise RuntimeError(f"native sample_epoch gave {got} batches, "
                               f"expected {K}")
        return WindowIndex(firm_idx=fi, time_idx=ti, weight=w)

    @property
    def n_eligible_dates(self) -> int:
        return int(self._dates.size)

    def batches_per_epoch(self) -> int:
        return self._dates.size // self.dates_per_batch

    def epoch(self, epoch: Optional[int] = None) -> Iterator[WindowIndex]:
        """Iterate one epoch of batches. Deterministic in (seed, epoch)."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        if self._use_native():
            b = self._native_epoch(epoch)
            for k in range(b.firm_idx.shape[0]):
                yield WindowIndex(firm_idx=b.firm_idx[k],
                                  time_idx=b.time_idx[k],
                                  weight=b.weight[k])
            return
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, 0xF1B]))
        order = rng.permutation(self._dates)
        nb = self.batches_per_epoch()
        bf = self.firms_per_date
        D = self.dates_per_batch
        for b in range(nb):
            dsel = order[b * D:(b + 1) * D]
            firm_idx = np.empty((dsel.size, bf), dtype=np.int32)
            weight = np.ones((dsel.size, bf), dtype=np.float32)
            for j, t in enumerate(dsel):
                pool = self._firms_by_date[int(t)]
                if pool.size >= bf:
                    firm_idx[j] = rng.choice(pool, size=bf, replace=False)
                else:
                    firm_idx[j, :pool.size] = rng.permutation(pool)
                    firm_idx[j, pool.size:] = pool[
                        rng.integers(0, pool.size, size=bf - pool.size)]
                    weight[j, pool.size:] = 0.0
            yield WindowIndex(firm_idx=firm_idx,
                              time_idx=dsel.astype(np.int32), weight=weight)

    def stacked_epoch(self, epoch: Optional[int] = None) -> WindowIndex:
        """One whole epoch as a ``[K, D, Bf]`` index stack."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        if self._use_native():
            return self._native_epoch(epoch)
        batches = list(self.epoch(epoch))
        return WindowIndex(
            firm_idx=np.stack([b.firm_idx for b in batches]),
            time_idx=np.stack([b.time_idx for b in batches]),
            weight=np.stack([b.weight for b in batches]),
        )

    def stacked_cross_sections(self) -> WindowIndex:
        """Every eligible cross-section as one ``[M, bf]`` index batch (M
        months x the panel-wide max pool): the eval sweep's input."""
        batches = list(self.full_cross_sections())
        return WindowIndex(
            firm_idx=np.concatenate([b.firm_idx for b in batches], axis=0),
            time_idx=np.concatenate([b.time_idx for b in batches], axis=0),
            weight=np.concatenate([b.weight for b in batches], axis=0),
        )

    def stacked_eval_months(self) -> int:
        """The number of months :meth:`stacked_cross_sections` covers: the
        stacked runs' shape probe (runs must agree on it before their
        validation sweeps can stack)."""
        return int(self._all_dates.size)

    def months_with_anchors(self) -> np.ndarray:
        """Month indices (panel columns) with >= 1 eligible anchor (int32,
        sorted)."""
        return self._all_dates.copy()

    def cross_section(self, t: int) -> np.ndarray:
        """Month ``t``'s eligible firm pool (int32 panel rows; empty when
        the month has no eligible anchor)."""
        pool = self._firms_by_date.get(int(t))
        return (pool.copy() if pool is not None
                else np.zeros(0, dtype=np.int32))

    def full_cross_sections(self) -> Iterator[WindowIndex]:
        """Every eligible (month, firm) pair, one month per batch, padded
        to the panel-wide max pool by repeating the last firm at
        weight 0."""
        bf = self._eval_bf
        for t in self._all_dates:
            pool = self._firms_by_date[int(t)]
            firm_idx = np.empty((1, bf), dtype=np.int32)
            weight = np.zeros((1, bf), dtype=np.float32)
            firm_idx[0, : pool.size] = pool
            firm_idx[0, pool.size :] = pool[-1] if pool.size else 0
            weight[0, : pool.size] = 1.0
            yield WindowIndex(
                firm_idx=firm_idx,
                time_idx=np.asarray([t], dtype=np.int32),
                weight=weight,
            )


    # ---- geometry buckets (LFM_BUCKETS) --------------------------------

    def _safe_lookback_rung(self, months: np.ndarray) -> Dict[int, int]:
        """Per-month smallest SAFE lookback rung: rung r is safe for
        month t iff NO firm in t's eligible pool has a valid month in
        the window gap [t-W+1, t-r] — then the r-step gather sees
        exactly the valid history the full W-step gather sees, and the
        models hold state through masked steps, so outputs are
        bit-identical (the parity contract; keying on valid-month COUNT
        alone would truncate gapped histories and break it)."""
        rungs = lookback_rungs(self.window)
        out = {int(t): self.window for t in months}
        if len(rungs) == 1:
            return out
        full = rolling_valid_count(self._valid, self.window)
        for r in rungs[:-1]:
            # Valid months in [t-W+1, t-r]: anything the r-rung window
            # would drop.
            beyond = full - rolling_valid_count(self._valid, r)
            for t in months:
                t = int(t)
                if out[t] < self.window:
                    continue  # already found a smaller safe rung
                pool = self._firms_by_date[t]
                if pool.size and not beyond[pool, t].any():
                    out[t] = r
        return out

    def bucket_geometry(self) -> BucketGeometry:
        """The sampler's epoch-invariant bucket ladder (memoized).

        Training dates bucket on ``(safe lookback rung, capped_width of
        the date's pool under the static Bf)``; buckets too thin to
        fill one [D]-date batch fold into the CHEAPEST containing
        bucket (>= in both dims, minimal lookback × width cells; the
        ``(window, Bf)`` cap bucket always contains) — padding up is
        always legal, so folding never affects correctness, only
        occupancy. Eval months bucket the
        same way under the panel-wide ``_eval_bf`` cap, with no folding
        (each month is one batch row)."""
        if self._bucket_geo is not None:
            return self._bucket_geo
        D = self.dates_per_batch
        cap = self.firms_per_date
        months = np.unique(np.concatenate([self._dates, self._all_dates]))
        rung = self._safe_lookback_rung(months)

        train: Dict[TrainBucket, List[int]] = {}
        for t in self._dates:
            t = int(t)
            key = (rung[t], capped_width(self._firms_by_date[t].size, cap))
            train.setdefault(key, []).append(t)
        cap_key = (self.window, cap)
        while True:
            small = sorted(k for k, v in train.items() if len(v) < D)
            if not small:
                break
            if small == [cap_key]:
                if len(train) == 1:
                    break  # degenerate tiny panel: one thin cap bucket
                # A thin CAP residue has no container to fold into —
                # fold another bucket INTO it instead (the cap contains
                # every bucket), so no date is silently dropped forever.
                k = min(c for c in train if c != cap_key)
                train[cap_key].extend(train.pop(k))
                continue
            k = next(c for c in small if c != cap_key)
            cands = [c for c in train
                     if c != k and c[0] >= k[0] and c[1] >= k[1]]
            # Cheapest container by per-date cell cost (lookback ×
            # width), not tuple order — folding is a padding tax and
            # (16, 8) at 128 cells beats (8, 64) at 512. Lexicographic
            # tie-break keeps the assignment deterministic.
            dest = (min(cands, key=lambda c: (c[0] * c[1], c))
                    if cands else cap_key)
            train.setdefault(dest, []).extend(train.pop(k))

        evals: Dict[TrainBucket, List[int]] = {}
        for pos, t in enumerate(self._all_dates):
            t = int(t)
            key = (rung[t],
                   capped_width(self._firms_by_date[t].size, self._eval_bf))
            evals.setdefault(key, []).append(pos)

        self._bucket_geo = BucketGeometry(
            window=self.window, width_cap=cap, eval_width_cap=self._eval_bf,
            train_buckets=OrderedDict(
                (k, np.asarray(sorted(v), np.int32))
                for k, v in sorted(train.items())),
            eval_buckets=OrderedDict(
                (k, np.asarray(v, np.int64))
                for k, v in sorted(evals.items())),
        )
        return self._bucket_geo

    def bucketed_batches_per_epoch(self) -> int:
        """Steps per bucketed epoch: Σ over buckets of whole [D]-date
        batches. May differ from :meth:`batches_per_epoch` (per-bucket
        flooring drops up to D-1 dates per bucket instead of per
        epoch) — the trainer threads THIS count into the LR-schedule
        horizon and the program key, so the schedule always matches the
        steps actually taken."""
        geo = self.bucket_geometry()
        return sum(d.size // self.dates_per_batch
                   for d in geo.train_buckets.values())

    def bucketed_epoch(self, epoch: Optional[int] = None
                       ) -> List[Tuple[TrainBucket, WindowIndex]]:
        """One training epoch on the bucket ladder: per bucket, a
        stacked ``[K_b, D, width]`` index batch whose dates are the
        bucket's own (re-shuffled per epoch, deterministic in
        (seed, epoch, bucket)). Shapes are EPOCH-INVARIANT — bucket
        membership and K_b never change — so warm epochs re-dispatch
        the same compiled programs (zero jit traces, the reuse-lane
        guard). A bucketed epoch is its own deterministic stream, not a
        regrouping of :meth:`epoch`'s batches: bucketing changes batch
        COMPOSITION by design (Khomenko-style length grouping); the
        parity contract is per-batch vs max-shape padding, not
        per-epoch vs the unbucketed order."""
        geo = self.bucket_geometry()
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        D = self.dates_per_batch
        out: List[Tuple[TrainBucket, WindowIndex]] = []
        for (lb, w), dates in geo.train_buckets.items():
            nb = dates.size // D
            if nb == 0:
                continue  # the cap bucket absorbed a thin residue
            rng = np.random.default_rng(np.random.SeedSequence(
                [self.seed, epoch, 0xB5C, lb, w]))
            order = rng.permutation(dates)
            fi = np.empty((nb, D, w), np.int32)
            ti = np.empty((nb, D), np.int32)
            wt = np.ones((nb, D, w), np.float32)
            for b in range(nb):
                dsel = order[b * D:(b + 1) * D]
                ti[b] = dsel
                for j, t in enumerate(dsel):
                    pool = self._firms_by_date[int(t)]
                    if pool.size >= w:
                        fi[b, j] = rng.choice(pool, size=w, replace=False)
                    else:
                        fi[b, j, :pool.size] = rng.permutation(pool)
                        fi[b, j, pool.size:] = pool[rng.integers(
                            0, pool.size, size=w - pool.size)]
                        wt[b, j, pool.size:] = 0.0
            out.append(((lb, w), WindowIndex(fi, ti, wt)))
        return out

    def bucketed_cross_sections(
            self) -> List[Tuple[TrainBucket, WindowIndex, np.ndarray]]:
        """The eval sweep on the bucket ladder: per bucket, an
        ``[M_b, width]`` batch of its months' full cross-sections (same
        pool layout and pad convention as :meth:`full_cross_sections`,
        just narrower) plus the months' POSITIONS in the
        :meth:`stacked_cross_sections` order — callers scatter
        per-month outputs back through them, so downstream aggregation
        sees exactly the month order the max-shape sweep produces."""
        geo = self.bucket_geometry()
        out: List[Tuple[TrainBucket, WindowIndex, np.ndarray]] = []
        for (lb, w), pos in geo.eval_buckets.items():
            months = self._all_dates[pos]
            fi = np.empty((months.size, w), np.int32)
            wt = np.zeros((months.size, w), np.float32)
            for j, t in enumerate(months):
                pool = self._firms_by_date[int(t)]
                fi[j, :pool.size] = pool
                fi[j, pool.size:] = pool[-1] if pool.size else 0
                wt[j, :pool.size] = 1.0
            out.append(((lb, w),
                        WindowIndex(fi, months.astype(np.int32), wt), pos))
        return out


def stack_fold_epochs(samplers, epoch: int) -> WindowIndex:
    """One training epoch from EACH run's sampler, stacked on a leading
    run axis: ``firm_idx [R, K, D, Bf]``, ``time_idx [R, K, D]``,
    ``weight [R, K, D, Bf]`` (the stacked runs' batch supply,
    ``train/stacked.py``). Entry r is exactly the index stack run r's
    sequential fit samples for this epoch: each sampler keeps its own
    seed and anchor range, and ``stacked_epoch`` with an explicit epoch
    is a pure read. Raises when the runs disagree on steps per epoch
    (stacking needs the same-shape schedule that a rolling
    ``train_months`` window gives; truncating would train some runs on
    partial epochs)."""
    per = [s.stacked_epoch(epoch) for s in samplers]
    ks = {b.firm_idx.shape[0] for b in per}
    if len(ks) != 1:
        raise ValueError(
            f"fold-stacked epoch needs equal steps-per-epoch across "
            f"folds, got {sorted(ks)} — use a rolling train_months "
            "window (same-shape folds)")
    return WindowIndex(
        firm_idx=np.stack([b.firm_idx for b in per]),
        time_idx=np.stack([b.time_idx for b in per]),
        weight=np.stack([b.weight for b in per]),
    )


def resolve_gather_impl(impl: str) -> str:
    """``DataConfig.gather_impl`` → the port's gather: "auto" and
    "pallas" pick the hand-written gather (``ops/gather.py``: the kernel
    for a panel on the card, its plain version on the CPU); "xla" picks
    the plain gather on any device."""
    if impl in ("auto", "pallas"):
        return "kernel"
    if impl == "xla":
        return "plain"
    raise ValueError(f"gather_impl must be auto|xla|pallas, got {impl!r}")


def device_panel(panel: Panel, device: Union[str, torch.device],
                 compute_dtype: Optional[torch.dtype] = None
                 ) -> Dict[str, torch.Tensor]:
    """Pin the panel in device memory: ``{"xm": [N, T, F+1], "targets":
    [N, T]}``. ``xm`` packs validity as the last column, in
    ``compute_dtype`` (bf16 halves the resident bytes and every gather's;
    the cast rounds to nearest even on the host, as the JAX package's
    does); the targets stay f32."""
    xm = np.concatenate(
        [panel.features, panel.valid[..., None].astype(panel.features.dtype)],
        axis=-1,
    )
    xm_t = torch.from_numpy(xm)
    if compute_dtype is not None:
        xm_t = xm_t.to(compute_dtype)
    return {"xm": xm_t.to(device).contiguous(),
            "targets": torch.from_numpy(panel.targets).to(device)}


def gather_windows_packed(xm: torch.Tensor, firm_idx: torch.Tensor,
                          time_idx: torch.Tensor, window: int,
                          fp: Optional[int] = None):
    """Plain window gather over the packed panel: the plain version of
    the gather kernel (``ops/gather.py``).

    ``xm [N, T, Fp]``, ``firm_idx [D, Bf]``, ``time_idx [D]`` →
    ``(x [D, Bf, W, F], m [D, Bf, W] bool)`` with ``x`` in ``xm.dtype``
    and ``F = fp - 1``. Window position ``j`` holds month
    ``t - W + 1 + j``: the anchor sits last, months before the panel's
    start are masked, and masked steps are zero-filled. This equals the
    JAX package's clamp-slice-and-roll for every anchor (for a young
    anchor the rolled-in months all lie after the anchor, so they are
    masked either way).
    """
    fp = fp or xm.shape[-1]
    T = xm.shape[1]
    months = (time_idx.long()[:, None] - (window - 1)
              + torch.arange(window, device=xm.device))  # [D, W]
    live = months >= 0
    rows = xm[firm_idx.long()[:, :, None],
              months.clamp(0, T - 1)[:, None, :]]  # [D, Bf, W, Fp]
    m = (rows[..., fp - 1] != 0) & live[:, None, :]
    x = torch.where(m[..., None], rows[..., :fp - 1],
                    torch.zeros((), dtype=xm.dtype, device=xm.device))
    return x, m


def gather_targets(targets: torch.Tensor, firm_idx: torch.Tensor,
                   time_idx: torch.Tensor) -> torch.Tensor:
    """Anchor-month targets for an index batch → ``firm_idx``-shaped."""
    if time_idx.dim() == firm_idx.dim() - 1:
        time_idx = time_idx[..., None]
    t = time_idx.expand_as(firm_idx)
    return targets[firm_idx.long(), t.long()]
