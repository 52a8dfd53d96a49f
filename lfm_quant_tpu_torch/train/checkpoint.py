"""Checkpoint lines of a run directory, torch-native.

The port of ``lfm_quant_tpu/train/checkpoint.py`` (Orbax there). A line is
a directory of committed steps, ``<line>/<step>/state.pt`` written with
``torch.save``; a save goes to a temporary directory first and is renamed
into place, so ``latest_step`` only ever sees committed steps. The run
directory keeps the JAX package's layout: ``ckpt/latest`` keeps 2 steps,
``ckpt/best`` keeps 1, beside ``fit_progress.json`` and ``metrics.jsonl``.
Saves are synchronous: ``wait`` and ``close`` have nothing to flush.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch


class CheckpointManager:
    """One checkpoint line: ``save`` / ``latest_step`` / ``restore``,
    keeping the newest ``max_to_keep`` steps."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(1, max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, "state.pt")))

    def save(self, step: int, state: Any, wait: bool = True) -> None:
        """Commit ``state`` (a dict of tensors, ints and nested dicts) at
        ``step``, then drop the oldest steps beyond ``max_to_keep``."""
        del wait  # saves are synchronous
        final = os.path.join(self.directory, str(int(step)))
        tmp = os.path.join(self.directory, f".tmp-{int(step)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, "state.pt"))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Any:
        """The state saved at ``step`` (default the latest), on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(os.path.join(self.directory, str(int(step)),
                                       "state.pt"),
                          map_location="cpu", weights_only=True)

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        """Saves are synchronous: always durable."""
        del timeout_s
        return True

    def close(self) -> None:
        pass
