"""Multi-process initialization: the port of
``lfm_quant_tpu/utils/distributed.py`` on ``torch.distributed``.

Each process of a data-parallel run calls :func:`maybe_initialize` once at
startup. The launcher configures it through the environment, as for the
JAX package:

  LFM_COORDINATOR    — "host:port" of process 0 (``tcp://`` is added), or
                       a full init URL such as ``file:///tmp/rendezvous``.
  LFM_NUM_PROCESSES  — total process count.
  LFM_PROCESS_ID     — this process's rank.

``LFM_AUTO_DISTRIBUTED=1``, or a launcher that set all of its own
variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
``torchrun`` does), initializes from those instead (``env://``): the
twin of JAX's argument-free ``jax.distributed.initialize()``, which
detects its cluster's launcher.

The backend is ``nccl`` when the process has a card of its own
(``cuda:{local_rank()}``) and ``gloo`` on the CPU; ``backend=`` overrides
it (two ranks sharing one card need ``gloo``: NCCL refuses two ranks on
one device). Without a process group every helper answers for a world of
one.
"""

from __future__ import annotations

import datetime
import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

KEYS = ("LFM_COORDINATOR", "LFM_NUM_PROCESSES", "LFM_PROCESS_ID")
LAUNCHER_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
#: How long a rank waits for the others at the rendezvous and in every
#: collective before the process group raises.
TIMEOUT_S = 600.0


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def maybe_initialize(env: Optional[Mapping[str, str]] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = TIMEOUT_S) -> bool:
    """Initialize the default process group from the environment when
    configured. Returns True if it did. Raises ``ValueError`` on a
    partially specified configuration: a silent single-process fallback
    on a half-configured launch would train on 1/N of the data with no
    error. A process whose group is already up (a launcher made it) is
    left as it is: False."""
    if initialized():
        return False
    env = os.environ if env is None else env
    backend = backend or default_backend()
    timeout = datetime.timedelta(seconds=timeout_s)
    if env.get("LFM_AUTO_DISTRIBUTED") or all(env.get(k)
                                              for k in LAUNCHER_KEYS):
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return True
    present = [k for k in KEYS if env.get(k)]
    if not present:
        return False
    if len(present) < len(KEYS):
        missing = sorted(set(KEYS) - set(present))
        raise ValueError(
            f"partial multi-host config: {present} set but {missing} "
            "missing — refusing to guess")
    coord = env["LFM_COORDINATOR"]
    dist.init_process_group(
        backend, init_method=coord if "://" in coord else f"tcp://{coord}",
        world_size=int(env["LFM_NUM_PROCESSES"]),
        rank=int(env["LFM_PROCESS_ID"]), timeout=timeout)
    return True


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main() -> bool:
    """Rank 0 (or no process group): the one writer of a run's files."""
    return rank() == 0


def local_rank() -> int:
    """This process's card on its host: ``LOCAL_RANK`` when the launcher
    sets it (``torchrun``), else the rank modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank() % max(1, torch.cuda.device_count())


def barrier() -> None:
    """Wait for every rank; a no-op without a process group."""
    if initialized() and world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """Destroy the process group, if one was initialized."""
    if initialized():
        dist.destroy_process_group()
