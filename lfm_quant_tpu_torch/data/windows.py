"""Windowing: anchor eligibility, serving pools, the device panel and the
plain window gather.

The port of the serving half of ``lfm_quant_tpu/data/windows.py``. The
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
    """Per-month eligible pools over a panel: the part of the JAX
    package's ``DateBatchSampler`` that serving and the eval sweep read.
    Training epochs come with the port's training slice."""

    def __init__(self, panel: Panel, window: int,
                 min_valid_months: Optional[int] = None,
                 require_target: bool = True):
        self.window = window
        eligible = anchor_index(panel, window, min_valid_months,
                                require_target=require_target)
        counts = eligible.sum(axis=0)
        # Panel-wide max cross-section: the static eval pad width.
        self._eval_bf = int(counts.max())
        self._all_dates = np.nonzero(counts > 0)[0].astype(np.int32)
        if self._all_dates.size == 0:
            raise ValueError(
                "no month has an eligible cross-section; panel too small "
                f"for window={window}")
        self._firms_by_date = {
            int(t): np.nonzero(eligible[:, t])[0].astype(np.int32)
            for t in self._all_dates
        }

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
    """Pin the packed panel in device memory: ``{"xm": [N, T, F+1]}``
    with validity as the last column, in ``compute_dtype`` (bf16 halves
    the resident bytes and every gather's; the cast rounds to nearest
    even on the host, as the JAX package's does)."""
    xm = np.concatenate(
        [panel.features, panel.valid[..., None].astype(panel.features.dtype)],
        axis=-1,
    )
    xm_t = torch.from_numpy(xm)
    if compute_dtype is not None:
        xm_t = xm_t.to(compute_dtype)
    return {"xm": xm_t.to(device).contiguous()}


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
