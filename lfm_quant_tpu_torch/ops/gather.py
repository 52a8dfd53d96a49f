"""The window gather: a hand-written CUDA kernel (``csrc/window_gather.cu``)
and its plain version.

Port of ``lfm_quant_tpu/ops/pallas_gather.py``. Same contract as
``data/windows.py gather_windows_packed``, which is the plain version: a
panel on the CPU goes there; a panel on the card launches the kernel or
raises. Seed-stacked index batches ``[S, D, Bf]`` over the one shared
panel fold into the date axis of a single call (the JAX ``_call_vmap``,
``pallas_gather.py:169-187``); a per-seed panel is not taken.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from lfm_quant_tpu_torch.data.windows import gather_windows_packed
from lfm_quant_tpu_torch.ops import _build


def fold_seeds(gather: Callable, xm: torch.Tensor, firm_idx: torch.Tensor,
               time_idx: torch.Tensor, window: int,
               fp: Optional[int] = None):
    """``gather`` (this module's or the plain one) over seed-stacked
    indices ``firm_idx [S, D, Bf]``, ``time_idx [S, D]``, folded into one
    call over ``S * D`` date rows → ``(x [S, D, Bf, W, fp-1], m [S, D,
    Bf, W])``."""
    S, D, Bf = firm_idx.shape
    x, m = gather(xm, firm_idx.reshape(S * D, Bf), time_idx.reshape(S * D),
                  window, fp=fp)
    return x.view(S, D, *x.shape[1:]), m.view(S, D, *m.shape[1:])


def gather_windows(xm: torch.Tensor, firm_idx: torch.Tensor,
                   time_idx: torch.Tensor, window: int,
                   fp: Optional[int] = None):
    """``xm [N, T, Fp]`` packed panel, ``firm_idx [D, Bf]`` int32,
    ``time_idx [D]`` int32 → ``(x [D, Bf, W, fp-1] in xm.dtype,
    m [D, Bf, W] bool)``; ``fp`` is the logical packed width (validity at
    column ``fp - 1``), by default ``Fp``. Seed-stacked ``firm_idx [S, D,
    Bf]`` and ``time_idx [S, D]`` give ``x [S, D, Bf, W, fp-1]`` and ``m
    [S, D, Bf, W]`` from one launch over ``S * D`` date rows."""
    if firm_idx.dim() == 3 and time_idx.dim() == 2 \
            and time_idx.shape == firm_idx.shape[:2]:
        return fold_seeds(gather_windows, xm, firm_idx, time_idx, window, fp)
    fp = fp or xm.shape[-1]
    if xm.dim() != 3 or firm_idx.dim() != 2 or time_idx.dim() != 1 \
            or time_idx.shape[0] != firm_idx.shape[0]:
        raise ValueError(
            f"expected xm [N, T, Fp], firm_idx [D, Bf], time_idx [D]; got "
            f"{tuple(xm.shape)}, {tuple(firm_idx.shape)}, "
            f"{tuple(time_idx.shape)}")
    if not 2 <= fp <= xm.shape[-1]:
        raise ValueError(f"fp={fp} outside [2, {xm.shape[-1]}]")
    if xm.device.type == "cpu":
        return gather_windows_packed(xm, firm_idx, time_idx, window, fp=fp)
    if xm.device.type != "cuda":
        raise ValueError(f"unsupported device {xm.device}")
    for name, t in (("firm_idx", firm_idx), ("time_idx", time_idx)):
        if t.device != xm.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous int32 tensor on {xm.device}, "
                f"got {t.dtype} on {t.device}")
    if not xm.is_contiguous():
        raise ValueError("xm must be contiguous")
    N, T, Fp = xm.shape
    D, Bf = firm_idx.shape
    x = torch.empty((D, Bf, window, fp - 1), dtype=xm.dtype,
                    device=xm.device)
    m = torch.empty((D, Bf, window), dtype=torch.bool, device=xm.device)
    if x.numel() == 0:
        return x, m
    lib = _build.library()
    with torch.cuda.device(xm.device):
        err = lib.lfm_window_gather(
            _build.dtype_code(xm.dtype), xm.data_ptr(), firm_idx.data_ptr(),
            time_idx.data_ptr(), x.data_ptr(), m.data_ptr(), N, T, Fp, fp,
            D, Bf, window, _build.stream_of(xm))
    _build.check(lib, err, "window_gather")
    _build.count_launch("window_gather")
    return x, m
