"""The window gather: a hand-written CUDA kernel (``csrc/window_gather.cu``)
and its plain version.

Port of ``lfm_quant_tpu/ops/pallas_gather.py``. Same contract as
``data/windows.py gather_windows_packed``, which is the plain version: a
panel on the CPU goes there; a panel on the card launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from lfm_quant_tpu_torch.data.windows import gather_windows_packed
from lfm_quant_tpu_torch.ops import _build


def gather_windows(xm: torch.Tensor, firm_idx: torch.Tensor,
                   time_idx: torch.Tensor, window: int,
                   fp: Optional[int] = None):
    """``xm [N, T, Fp]`` packed panel, ``firm_idx [D, Bf]`` int32,
    ``time_idx [D]`` int32 → ``(x [D, Bf, W, fp-1] in xm.dtype,
    m [D, Bf, W] bool)``; ``fp`` is the logical packed width (validity at
    column ``fp - 1``), by default ``Fp``."""
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
