"""Windowing: anchor eligibility, the date-batch sampler, the device panel
and the plain window gather.

The port of ``lfm_quant_tpu/data/windows.py`` (the Python sampler engine,
the serving pools and the eval sweep; not the geometry buckets). The
panel lives on the device as one packed tensor ``xm [N, T, F+1]``
(features with validity appended as the last column) in the compute
dtype; a batch is an index pair ``firm_idx [D, Bf]`` / ``time_idx [D]``
that the window gather turns into ``(x [D, Bf, W, F], m [D, Bf, W])``.

The JAX package pads ``xm`` to 128 lanes and 8 months for its TPU DMA
gather; those are Mosaic constraints and the port stores ``xm`` unpadded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from lfm_quant_tpu_torch.data.panel import Panel

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

    ``engine``: "python" or "auto" (which takes the Python engine, as the
    JAX package does when its native library is not built); "native" is
    not ported (ROADMAP.md Queue A).
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
        if engine == "native":
            raise NotImplementedError(
                "sampler_engine='native' (the C++ sampler) is not ported: "
                "ROADMAP.md Queue A; use 'python' or 'auto'")
        if engine not in ("python", "auto"):
            raise ValueError(
                f"engine must be python|native|auto, got {engine!r}")
        self.engine = engine
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
        self._epoch = 0

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
