"""The mesh of a run: the port of ``lfm_quant_tpu/parallel/mesh.py``'s
(seed × data × seq) composition on ``torch.distributed``.

One process per shard. Rank ``r`` has the coordinates (seed block, date
shard, seq shard) with seq innermost, as ``make_mesh`` lays out its grid:
``r = (seed_rank * n_data + rank) * n_seq + seq_rank``.

* ``seed`` — ensemble members: rank r trains its block of the seeds
  (``train/ensemble.py``). No step collective crosses it; the per-seed
  validation ICs, the forecasts and the checkpoint are gathered over it.
* ``data`` — batches use the ``[D dates, Bf firms]`` layout and shard the
  DATE axis only, so each month's cross-section stays on one rank and the
  rank-IC loss needs no collective of its own. Every rank holds the whole
  panel, draws the same global batch and takes its contiguous block of
  dates (the JAX ``P(DATA_AXIS)`` placement in ``shard_batch``).
* ``seq`` — the window axis of the train forward (sequence parallelism:
  ``parallel/ring.py``): each seq rank gathers and runs its sub-window,
  and the window-shardable models (transformer, LRU) exchange what they
  need over the seq group.

The data and seq shards of one seed block together form its ``batch``
group: the gradients are summed over it, and the sweeps split their
months over it (``month_block``, ``all_gather_dates``). Each axis, and the
batch, gets its own sub-group from ``dist.new_group``; every rank creates
every group, in one order (``_groups``), or the job would hang.

The JAX package's run axes, ``stack`` (a config sweep's runs) and
``fold`` (a fold-stacked walk-forward's folds), live in one process
here: the whole stack trains as members of one stacked tree
(``train/stacked.py``), which is what JAX's ``auto`` resolves to on one
card. :func:`resolve_run_shards` reads their knobs; a request for the
run axis over more than one rank raises :func:`axis_not_ported`'s
error, which names its ROADMAP.md item.

With the ``gloo`` backend (the CPU, or several ranks sharing one card) a
collective on a CUDA tensor is staged through a host copy: that is the
collective's transport, while the model, the kernels and the optimizer
stay on the card.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from lfm_quant_tpu_torch.utils import distributed as D

SEED_AXIS = "seed"
DATA_AXIS = "data"
SEQ_AXIS = "seq"
FOLD_AXIS = "fold"
STACK_AXIS = "stack"
#: The data and seq shards of one seed block (not an axis of JAX's mesh:
#: the pair its steps psum over).
BATCH = "batch"

_ROADMAP = {
    FOLD_AXIS: "ROADMAP.md Queue A item 10 (the run axis over ranks)",
    STACK_AXIS: "ROADMAP.md Queue A item 10 (the run axis over ranks)",
}


def axis_not_ported(axis: str, why: str = "") -> NotImplementedError:
    """The error for a run that would need a mesh axis the port lacks."""
    return NotImplementedError(
        f"the {axis!r} mesh axis is not ported{why}: {_ROADMAP[axis]}")


def resolve_run_shards(axis: str) -> int:
    """The ranks a stacked run's ``axis`` (``stack`` or ``fold``) spreads
    over: ``LFM_STACK_SHARDS`` / ``LFM_FOLDSTACK_SHARDS`` unset, "auto",
    0 or 1 all mean 1, the whole stack in this process. More raises
    :func:`axis_not_ported`: the runs are never split silently."""
    # Literal reads: scripts/check_knobs.py sees each knob.
    knob, v = (("LFM_STACK_SHARDS", os.environ.get("LFM_STACK_SHARDS"))
               if axis == STACK_AXIS else
               ("LFM_FOLDSTACK_SHARDS",
                os.environ.get("LFM_FOLDSTACK_SHARDS")))
    if v in (None, "", "auto"):
        return 1
    try:
        n = int(v)
    except ValueError:
        raise ValueError(f"{knob} must be auto or an integer, got {v!r}"
                         ) from None
    if n > 1:
        raise axis_not_ported(axis, f" over {n} ranks ({knob}={v})")
    return 1


@dataclass(frozen=True)
class DataMesh:
    """This rank's view of the (seed × data × seq) mesh: each axis's size
    and this rank's index on it; ``group`` is the data group,
    ``seed_group``, ``seq_group`` and ``batch_group`` the others (None:
    the default group, or no group at all on one process), ``seq_peers``
    the global ranks of the seq group in seq order (the ring's
    neighbours). The name is the data-only mesh's it grew from."""

    n_data: int = 1
    rank: int = 0
    group: Any = None
    n_seed: int = 1
    seed_rank: int = 0
    seed_group: Any = None
    n_seq: int = 1
    seq_rank: int = 0
    seq_group: Any = None
    seq_peers: Tuple[int, ...] = ()
    batch_group: Any = None

    @property
    def n_batch(self) -> int:
        return self.n_data * self.n_seq

    @property
    def batch_rank(self) -> int:
        return self.rank * self.n_seq + self.seq_rank

    def size(self, axis: str) -> int:
        return {SEED_AXIS: self.n_seed, DATA_AXIS: self.n_data,
                SEQ_AXIS: self.n_seq, BATCH: self.n_batch}[axis]

    def group_of(self, axis: str) -> Any:
        return {SEED_AXIS: self.seed_group, DATA_AXIS: self.group,
                SEQ_AXIS: self.seq_group, BATCH: self.batch_group}[axis]


def resolve_data_shards(n_data_shards: int, world: int) -> int:
    """The JAX trainer's rule (``train/loop.py:961``): the configured
    shards, degraded to the processes there are."""
    return max(1, min(n_data_shards, world))


def resolve_seed_shards(n_seeds: int, world: int) -> int:
    """The JAX ensemble's rule (``train/ensemble.py:305-309``): the
    largest seed axis dividing both the seed count and the world."""
    for cand in range(min(n_seeds, world), 0, -1):
        if n_seeds % cand == 0 and world % cand == 0:
            return cand
    return 1


def resolve_seq_shards(requested: int, devices_left: int) -> int:
    """Degrade a requested seq-axis size to the processes left over by the
    seed and data axes, warning when it shrinks (JAX
    ``parallel/mesh.py:227``); 1 means no seq axis: the plain full-window
    model."""
    n_seq = max(1, min(requested, devices_left))
    if n_seq < requested:
        warnings.warn(
            f"n_seq_shards={requested} exceeds the {devices_left} "
            f"device(s) left by the other mesh axes; degrading to "
            f"{n_seq}", stacklevel=3)
    return n_seq


#: Sub-groups made in this process, by (default group, sizes): a group is
#: made once per process group however often a trainer binds its mesh.
_GROUPS: Dict[Tuple, Dict[str, List[Any]]] = {}


def _groups(n_seed: int, n_data: int, n_seq: int) -> Dict[str, List[Any]]:
    """Every sub-group of the mesh, keyed by axis and then by the
    coordinates of the other axes: made by every rank in one order."""
    key = (id(dist.group.WORLD), n_seed, n_data, n_seq)
    if key in _GROUPS:
        return _GROUPS[key]
    world = n_seed * n_data * n_seq

    def rank_of(s, d, q):
        return (s * n_data + d) * n_seq + q

    def make(ranks):
        # One rank's axis needs no group; the whole world's is the default.
        if len(ranks) in (1, world):
            return None
        return dist.new_group(list(ranks))

    out = {
        SEED_AXIS: [make([rank_of(s, d, q) for s in range(n_seed)])
                    for d in range(n_data) for q in range(n_seq)],
        DATA_AXIS: [make([rank_of(s, d, q) for d in range(n_data)])
                    for s in range(n_seed) for q in range(n_seq)],
        SEQ_AXIS: [make([rank_of(s, d, q) for q in range(n_seq)])
                   for s in range(n_seed) for d in range(n_data)],
        BATCH: [make([rank_of(s, d, q) for d in range(n_data)
                      for q in range(n_seq)]) for s in range(n_seed)],
    }
    _GROUPS[key] = out
    return out


def data_mesh(n_data_shards: int, n_seeds: int = 1,
              n_seq_shards: int = 1) -> DataMesh:
    """The mesh of a run in this process group, sized by the JAX rule: the
    seed axis the largest divisor of both ``n_seeds`` and the world, the
    data axis ``min(n_data_shards, what is left)``, the seq axis
    ``resolve_seq_shards(n_seq_shards, what is left)``. One rank per
    shard: a world that is not the product of the three sizes raises a
    ``ValueError`` naming them (the JAX package would put several devices
    behind one process)."""
    world = D.world_size()
    n_seed = resolve_seed_shards(n_seeds, world)
    n_data = resolve_data_shards(n_data_shards, world // n_seed)
    n_seq = (resolve_seq_shards(n_seq_shards, world // (n_seed * n_data))
             if n_seq_shards > 1 else 1)
    size = n_seed * n_data * n_seq
    if size != world:
        raise ValueError(
            f"{world} processes but the mesh resolves to {size} (seed "
            f"{n_seed} x data {n_data} x seq {n_seq}, from n_seeds={n_seeds}, "
            f"n_data_shards={n_data_shards}, n_seq_shards={n_seq_shards}): "
            "the port runs one process per shard")
    if world == 1:
        return DataMesh()
    groups = _groups(n_seed, n_data, n_seq)
    r = D.rank()
    q, d, s = r % n_seq, (r // n_seq) % n_data, r // (n_seq * n_data)
    return DataMesh(
        n_data=n_data, rank=d, group=groups[DATA_AXIS][s * n_seq + q],
        n_seed=n_seed, seed_rank=s, seed_group=groups[SEED_AXIS][
            d * n_seq + q],
        n_seq=n_seq, seq_rank=q, seq_group=groups[SEQ_AXIS][s * n_data + d],
        seq_peers=tuple((s * n_data + d) * n_seq + i for i in range(n_seq)),
        batch_group=groups[BATCH][s])


def mesh_fingerprint(mesh: DataMesh) -> Tuple:
    """Hashable identity of a mesh, equal on every rank: its live axes
    (the data axis always) and their sizes, and the collectives'
    backend."""
    axes = [(a, mesh.size(a)) for a in (SEED_AXIS, DATA_AXIS, SEQ_AXIS)
            if a == DATA_AXIS or mesh.size(a) > 1]
    live = mesh.n_seed * mesh.n_data * mesh.n_seq > 1
    backend = dist.get_backend() if live else None
    return tuple(a for a, _ in axes), tuple(n for _, n in axes), backend


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
    """This rank's rows of an ``M``-month sweep, split over the batch
    group (the data and seq shards of its seed block): the month axis
    padded to ``n_batch`` blocks of whole chunks (chunk
    ``min(dates_per_batch, ceil(M / n_batch))``) by repeating months, and
    block ``batch_rank`` of it. Returns ``(month index of each row [Mr]
    (int64, on the CPU), the number of real rows)``; the real rows come
    first, the rest are repeats whose weight the caller sets to 0. On one
    rank this is the single-device sweep's padding: months 0.. repeated
    after the last."""
    n = mesh.n_batch
    C = min(dates_per_batch, -(-M // n))
    Mr = -(-M // (n * C)) * C
    lo = mesh.batch_rank * Mr
    rows = torch.arange(lo, lo + Mr) % M
    return rows, max(0, min(M - lo, Mr))


def _staged(t: torch.Tensor, group: Any) -> torch.Tensor:
    """A private buffer for a collective: on the host when gloo must carry
    a CUDA tensor, else a copy on ``t``'s device."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.detach().to("cpu", copy=True)
    return t.detach().clone()


def all_reduce_sum(t: torch.Tensor, mesh: DataMesh, axis: str = DATA_AXIS
                   ) -> torch.Tensor:
    """``t`` summed over the ranks of ``axis`` (``t`` itself when the axis
    has one rank)."""
    if mesh.size(axis) == 1:
        return t
    group = mesh.group_of(axis)
    buf = _staged(t, group)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh: DataMesh,
                    axis: str = DATA_AXIS) -> List[torch.Tensor]:
    """Each tensor summed over the ranks of ``axis`` through ONE flat
    buffer (one collective per step for every gradient)."""
    if mesh.size(axis) == 1:
        return list(tensors)
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]), mesh,
                          axis)
    out = torch.split(flat, [t.numel() for t in tensors])
    return [o.view_as(t) for o, t in zip(out, tensors)]


def all_gather_cat(t: torch.Tensor, mesh: DataMesh, axis: str, dim: int = 0
                   ) -> torch.Tensor:
    """Every rank of ``axis``'s equal-shaped ``t``, concatenated along
    ``dim`` in the axis's order, on every rank of it."""
    if mesh.size(axis) == 1:
        return t
    group = mesh.group_of(axis)
    buf = _staged(t, group).contiguous()
    out = [torch.empty_like(buf) for _ in range(mesh.size(axis))]
    dist.all_gather(out, buf, group=group)
    return torch.cat(out, dim=dim).to(t.device)


def all_gather_dates(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every batch rank's :func:`month_block` rows (axis 0), concatenated
    in order, on every rank."""
    return all_gather_cat(t, mesh, BATCH)
