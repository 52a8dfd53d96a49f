"""The data axis: the port of ``lfm_quant_tpu/parallel/mesh.py``'s
date-sharded data parallelism on ``torch.distributed``.

One process per shard. Batches use the ``[D dates, Bf firms]`` layout and
shard the DATE axis only, so each month's cross-section stays on one rank
and the rank-IC loss needs no collective of its own. Every rank holds the
whole replicated state and the whole device panel, draws the same global
batch from the same sampler seed and takes its contiguous block of dates
(the JAX ``P(DATA_AXIS)`` placement in ``shard_batch``). The loss parts
and the gradients are summed across ranks (``all_reduce_sum``); the
evaluation and prediction sweeps give each rank a block of months and
gather the per-month outputs (``month_block``, ``all_gather_dates``).

The JAX package's other axes are not ported: a run that would need one
raises :func:`axis_not_ported`'s error, which names its ROADMAP.md item.

With the ``gloo`` backend (the CPU, or several ranks sharing one card) a
collective on a CUDA tensor is staged through a host copy: that is the
collective's transport, while the model, the kernels and the optimizer
stay on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple

import torch
import torch.distributed as dist

from lfm_quant_tpu_torch.utils import distributed as D

SEED_AXIS = "seed"
DATA_AXIS = "data"
SEQ_AXIS = "seq"
FOLD_AXIS = "fold"
STACK_AXIS = "stack"

_ROADMAP = {
    SEED_AXIS: "ROADMAP.md Queue A item 8 (the seed axis across ranks)",
    SEQ_AXIS: "ROADMAP.md Queue A item 9 (the sequence axis: ring "
              "attention and the distributed linear scan over ranks)",
    FOLD_AXIS: "ROADMAP.md Queue A item 5 (fold-stacked walk-forwards)",
    STACK_AXIS: "ROADMAP.md Queue A item 5 (stacked config sweeps)",
}


def axis_not_ported(axis: str, why: str = "") -> NotImplementedError:
    """The error for a run that would need a mesh axis the port lacks."""
    return NotImplementedError(
        f"the {axis!r} mesh axis is not ported{why}: {_ROADMAP[axis]}")


@dataclass(frozen=True)
class DataMesh:
    """``n_data`` date shards, one per rank; ``rank`` is this process's
    shard and ``group`` the process group (None: the default one)."""

    n_data: int = 1
    rank: int = 0
    group: Any = None


def resolve_data_shards(n_data_shards: int, world: int) -> int:
    """The JAX trainer's rule (``train/loop.py:961``): the configured
    shards, degraded to the processes there are."""
    return max(1, min(n_data_shards, world))


def data_mesh(n_data_shards: int, n_seeds: int = 1,
              n_seq_shards: int = 1) -> DataMesh:
    """The data mesh of a run in this process group. One rank per shard:
    a world larger than the resolved shard count raises a ``ValueError``
    (the JAX package would put several devices behind one process)."""
    world = D.world_size()
    if world > 1 and n_seeds > 1:
        raise axis_not_ported(SEED_AXIS, f" ({n_seeds} seeds on a world of "
                              f"{world}: every rank would train every seed)")
    if world > 1 and n_seq_shards > 1:
        raise axis_not_ported(SEQ_AXIS)
    n_data = resolve_data_shards(n_data_shards, world)
    if world > n_data:
        raise ValueError(
            f"{world} processes but n_data_shards resolves to {n_data}: the "
            "port runs one process per date shard")
    return DataMesh(n_data, D.rank())


def mesh_fingerprint(mesh: DataMesh) -> Tuple:
    """Hashable identity of a mesh, equal on every rank: its axis and
    size, and the collectives' backend."""
    backend = (dist.get_backend(mesh.group) if mesh.n_data > 1
               else None)
    return ((DATA_AXIS,), (mesh.n_data,), backend)


def shard_dates(x: torch.Tensor, mesh: DataMesh, axis: int = 0
                ) -> torch.Tensor:
    """Rank r's contiguous block r of the date axis (``axis``) of a global
    batch. The date count must divide by ``n_data``."""
    if mesh.n_data == 1:
        return x
    D_ = x.shape[axis]
    if D_ % mesh.n_data:
        raise ValueError(f"{D_} dates are not divisible by n_data_shards="
                         f"{mesh.n_data}")
    per = D_ // mesh.n_data
    return x.narrow(axis, mesh.rank * per, per)


def month_block(M: int, dates_per_batch: int, mesh: DataMesh
                ) -> Tuple[torch.Tensor, int]:
    """This rank's rows of an ``M``-month sweep: the month axis padded to
    ``n_data`` blocks of whole chunks (chunk ``min(dates_per_batch,
    ceil(M / n_data))``) by repeating months, and block ``rank`` of it.
    Returns ``(month index of each row [Mr] (int64, on the CPU), the
    number of real rows)``; the real rows come first, the rest are
    repeats whose weight the caller sets to 0. On one rank this is the
    single-device sweep's padding: months 0.. repeated after the last."""
    C = min(dates_per_batch, -(-M // mesh.n_data))
    Mr = -(-M // (mesh.n_data * C)) * C
    lo = mesh.rank * Mr
    rows = torch.arange(lo, lo + Mr) % M
    return rows, max(0, min(M - lo, Mr))


def _staged(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """A private buffer for a collective: on the host when gloo must carry
    a CUDA tensor, else a copy on ``t``'s device."""
    if t.is_cuda and dist.get_backend(mesh.group) == "gloo":
        return t.detach().to("cpu", copy=True)
    return t.detach().clone()


def all_reduce_sum(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """``t`` summed over the ranks (``t`` itself on one rank)."""
    if mesh.n_data == 1:
        return t
    buf = _staged(t, mesh)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(t.device)


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh: DataMesh
                    ) -> List[torch.Tensor]:
    """Each tensor summed over the ranks through ONE flat buffer (one
    collective per step for every gradient)."""
    if mesh.n_data == 1:
        return list(tensors)
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    out = torch.split(flat, [t.numel() for t in tensors])
    return [o.view_as(t) for o, t in zip(out, tensors)]


def all_gather_dates(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's equal-sized block of the date axis (axis 0),
    concatenated in rank order, on every rank."""
    if mesh.n_data == 1:
        return t
    buf = _staged(t, mesh)
    out = [torch.empty_like(buf) for _ in range(mesh.n_data)]
    dist.all_gather(out, buf.contiguous(), group=mesh.group)
    return torch.cat(out).to(t.device)
