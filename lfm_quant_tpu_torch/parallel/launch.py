"""Run a function on N local ranks: one process each, joined through a
``file://`` rendezvous, with a time limit on the whole job.

    results = run_ranks(2, "my_module:my_function", {"arg": 1},
                        workdir="/tmp/job", timeout_s=300)

Rank r runs ``python -m lfm_quant_tpu_torch.parallel.launch WORKDIR r``
with ``LFM_COORDINATOR=file://WORKDIR/rendezvous``,
``LFM_NUM_PROCESSES`` and ``LFM_PROCESS_ID`` set, initializes the process
group through :func:`~lfm_quant_tpu_torch.utils.distributed.maybe_initialize`
on ``gloo`` (the CPU, or ranks that share one card: NCCL refuses two
ranks on one device), with a :data:`COLLECTIVE_TIMEOUT_S` limit, calls
the function with the payload's keyword arguments and ``torch.save``-s
its return value. The parent returns the values in rank order. A rank
that exits non-zero, or a job that outlives ``timeout_s``, kills every
rank still running and raises: a rank failure is fatal, never retried on
fewer ranks. ``python_path`` names extra import roots for the function's
module (the repository root is always on it).

The train entry point's own multi-process runs use ``torchrun`` or the
``LFM_*`` variables; this is for jobs that drive the trainer from code
(the tests, the card's smoke run).
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

import torch

from lfm_quant_tpu_torch.utils import distributed as D

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: The rendezvous and every collective of a job's ranks give up after
#: this long (well inside any job's own limit).
COLLECTIVE_TIMEOUT_S = 60.0


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as fh:
            return fh.read()[-n:]
    except OSError:
        return ""


def run_ranks(n: int, target: str, payload: Dict[str, Any], workdir: str,
              timeout_s: float, python_path: Sequence[str] = ()
              ) -> List[Any]:
    """Run ``target`` ("module:function") on ``n`` ranks; return each
    rank's result in rank order (see the module docstring)."""
    os.makedirs(workdir, exist_ok=True)
    for stale in ["rendezvous"] + [f"result{r}.pt" for r in range(n)]:
        if os.path.exists(os.path.join(workdir, stale)):
            os.remove(os.path.join(workdir, stale))
    torch.save({"target": target, "payload": payload},
               os.path.join(workdir, "job.pt"))
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [ROOT, *python_path, os.environ.get("PYTHONPATH", "")]),
               LFM_COORDINATOR="file://" + os.path.join(
                   os.path.abspath(workdir), "rendezvous"),
               LFM_NUM_PROCESSES=str(n))
    env.pop("LFM_AUTO_DISTRIBUTED", None)
    procs = []
    try:
        for r in range(n):
            with open(os.path.join(workdir, f"rank{r}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "lfm_quant_tpu_torch.parallel."
                     "launch", workdir, str(r)],
                    env=dict(env, LFM_PROCESS_ID=str(r)),
                    stdout=log, stderr=subprocess.STDOUT, cwd=ROOT))
        deadline = time.monotonic() + timeout_s
        pending = set(range(n))
        while pending:
            for r in sorted(pending):
                rc = procs[r].poll()
                if rc is None:
                    continue
                pending.discard(r)
                if rc != 0:
                    raise RuntimeError(
                        f"rank {r} of {n} exited with {rc}:\n"
                        + _tail(os.path.join(workdir, f"rank{r}.log")))
            if pending and time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {sorted(pending)} of {n} still running after "
                    f"{timeout_s} s:\n" + "\n".join(
                        _tail(os.path.join(workdir, f"rank{r}.log"))
                        for r in sorted(pending)))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    return [torch.load(os.path.join(workdir, f"result{r}.pt"),
                       weights_only=False) for r in range(n)]


def _rank_main(argv: Optional[Sequence[str]] = None) -> int:
    workdir, r = (argv if argv is not None else sys.argv[1:])[:2]
    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=False)
    try:
        D.maybe_initialize(backend="gloo", timeout_s=COLLECTIVE_TIMEOUT_S)
        module, _, name = job["target"].partition(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(**job["payload"])
        D.barrier()
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)  # skip the process group's teardown: a peer may be gone
    torch.save(result, os.path.join(workdir, f"result{r}.pt"))
    D.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main())
