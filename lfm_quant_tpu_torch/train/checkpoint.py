"""Checkpoint lines of a run directory, torch-native.

The port of ``lfm_quant_tpu/train/checkpoint.py`` (Orbax there). A line is
a directory of committed steps, ``<line>/<step>/state.pt`` written with
``torch.save``; a save goes to a temporary directory first and is renamed
into place, so ``latest_step`` only ever sees committed steps. The run
directory keeps the JAX package's layout: ``ckpt/latest`` keeps 2 steps,
``ckpt/best`` keeps 1, beside ``fit_progress.json`` and ``metrics.jsonl``.
In a process group rank 0 alone writes (the state is replicated); every
rank reads.

Saves are asynchronous unless asked to wait: ``save(wait=False)`` hands a
HOST copy of the state (the epoch pipeline's one fetch made it,
``train/pipeline.py``) to a background writer thread and returns. One
manager writes one save at a time (a second save first joins the
first), so overlapping the best and latest lines needs two managers,
which is what ``FitHarness`` holds. :meth:`CheckpointManager.wait` and
:meth:`CheckpointManager.close` are BOUNDED (``LFM_CKPT_WAIT_S``, 120 s;
<= 0 waits without bound): a wedged writer warns, bumps the
``ckpt_wait_timeouts`` counter and is abandoned instead of hanging
shutdown. ``ckpt_write`` is a fault site (``utils/faults.py``): the
preemption tests schedule their SIGTERM there.
"""

from __future__ import annotations

import os
import shutil
import threading
import warnings
from typing import Any, List, Optional

import torch

from lfm_quant_tpu_torch.utils import faults, telemetry
from lfm_quant_tpu_torch.utils.distributed import is_main


class CheckpointManager:
    """One checkpoint line: ``save`` / ``latest_step`` / ``restore`` /
    ``wait`` / ``close``, keeping the newest ``max_to_keep`` steps."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self._line = os.path.basename(self.directory)  # "best" | "latest"
        self.max_to_keep = max(1, max_to_keep)
        if is_main():
            os.makedirs(self.directory, exist_ok=True)
        #: The save in flight (a writer thread) and its error, if any.
        self._writer: Optional[threading.Thread] = None
        self._err: List[BaseException] = []

    def _steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, "state.pt")))

    def _write(self, step: int, state: Any) -> None:
        """Commit ``state`` at ``step`` (tmp dir + rename), then drop the
        oldest steps beyond ``max_to_keep``."""
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

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Save ``state`` (a dict of host tensors, ints and nested dicts)
        at ``step`` on a background writer; ``wait=True`` blocks until it
        is committed (deliberately UNBOUNDED: that path's contract is
        "durable before proceeding"). A no-op off rank 0, apart from the
        fault site."""
        faults.check("ckpt_write", line=self._line, step=int(step))
        if not is_main():
            return
        with telemetry.span("ckpt_save", cat="ckpt", line=self._line,
                            step=step, wait=wait):
            self._join()
            err = self._err = []

            def run():
                try:
                    self._write(step, state)
                except BaseException as e:  # noqa: BLE001 — re-raised by wait
                    err.append(e)

            self._writer = threading.Thread(
                target=run, daemon=True, name=f"ckpt-{self._line}-{step}")
            self._writer.start()
            if wait:
                self._join()

    def _join(self) -> None:
        """Unbounded join of the save in flight; raises its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._err:
            err, self._err = self._err[0], []
            raise err

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
        """Block until the save in flight commits, for at most
        ``timeout_s`` (default ``LFM_CKPT_WAIT_S``, 120 s; <= 0 waits
        without bound). True when the line is durable; on timeout it
        warns, bumps ``ckpt_wait_timeouts`` and returns False (the save
        may still commit in the background). A failed save raises."""
        if timeout_s is None:
            timeout_s = float(os.environ.get("LFM_CKPT_WAIT_S", "120"))
        with telemetry.span("ckpt_wait", cat="ckpt", line=self._line):
            writer = self._writer
            if writer is not None and timeout_s > 0:
                writer.join(timeout_s)
                if writer.is_alive():
                    warnings.warn(
                        f"checkpoint line {self._line!r}: async save still "
                        f"unfinished after {timeout_s:.0f}s "
                        "(LFM_CKPT_WAIT_S) — abandoning the wait so "
                        "shutdown cannot hang; the save may still commit "
                        "in the background", RuntimeWarning, stacklevel=2)
                    telemetry.COUNTERS.bump("ckpt_wait_timeouts")
                    return False
            self._join()
            return True

    def close(self, timeout_s: Optional[float] = None) -> None:
        """Flush (bounded, see :meth:`wait`); a wedged save is ABANDONED
        with a warning instead of hanging shutdown."""
        if not self.wait(timeout_s):
            warnings.warn(
                f"checkpoint line {self._line!r}: close() abandoned with a "
                "save still in flight (see the ckpt_wait warning above)",
                RuntimeWarning, stacklevel=2)
