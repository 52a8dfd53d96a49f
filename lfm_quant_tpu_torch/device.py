"""Device resolution: the port runs on the card unless asked otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device with no card raises: the
    port never moves itself to the CPU. ``device="cpu"`` runs every
    kernel's plain version (the tests' mode)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card. "
            "Pass device='cpu' to run the kernels' plain versions on the "
            "CPU.")
    return dev
