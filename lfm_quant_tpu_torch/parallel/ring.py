"""Sequence parallelism over the ranks of a seq group: the port of
``lfm_quant_tpu/parallel/ring.py`` (``ring_attention``,
``sequence_parallel_apply``) and of the collectives the window-shardable
models need (the transformer's pooled sums, the LRU's aggregates).

The window axis of the train forward is split over the ``seq`` axis of
the mesh (``parallel/mesh.py``): seq rank ``s`` holds positions ``[s·Wl,
(s+1)·Wl)`` of each window. A model built with ``seq_axis="seq"`` runs
only inside :func:`bind_seq_axis` (as a JAX model with an axis name runs
only inside ``shard_map``), which tells it its rank, its group and the
ring's neighbours.

Gradients. JAX differentiates ``ppermute`` and ``psum`` by their
transposes; here each cross-rank operation is a ``torch.autograd.Function``
with the transpose as its backward: the ring hop sends the gradient back
the way the block came (``_Hop``), the sum over the group
all-reduces the gradient (:func:`seq_sum`), and the all-gather sums every
rank's gradient of each block and hands block ``s`` to rank ``s``
(:func:`seq_all_gather`). A seq model's output is the same on every rank
of the group, so each rank's loss is a copy of the one loss: the output
passes its gradient on divided by the group's size (:func:`replicated`),
and the ranks' parameter gradients then SUM to the one-process gradient.
The trainer sums them over the seq group with the data group's.

Transport. Under ``gloo`` (the CPU, or ranks that share one card) every
message from a CUDA tensor is staged through a host copy, as the mesh's
collectives are (``parallel/mesh.py _staged``); the hop is one
``batch_isend_irecv`` pair per layer and step.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from lfm_quant_tpu_torch.parallel.mesh import SEQ_AXIS, DataMesh

_NEG = -1e30  # additive mask for invalid keys (f32-safe, exp() == 0.0)

#: The meshes bound to the seq axis in this process (innermost last).
_BOUND: List[DataMesh] = []


@contextlib.contextmanager
def bind_seq_axis(mesh: DataMesh) -> Iterator[None]:
    """Run the models with ``seq_axis="seq"`` over ``mesh``'s seq group
    inside the block (JAX: the axis name bound by ``shard_map``)."""
    _BOUND.append(mesh)
    try:
        yield
    finally:
        _BOUND.pop()


def seq_axis(name: str) -> DataMesh:
    """The mesh bound to the axis ``name``; an unbound name raises, as in
    JAX."""
    if name != SEQ_AXIS or not _BOUND:
        raise NameError(
            f"unbound axis name: {name!r}: a model with seq_axis={name!r} "
            "runs inside parallel/ring.py bind_seq_axis (the trainer's "
            f"step under a seq mesh, or sequence_parallel_apply; the axis "
            f"is {SEQ_AXIS!r})")
    return _BOUND[-1]


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where the group's backend can send it: a host copy for gloo
    and a CUDA tensor, else ``t`` itself (contiguous)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.detach().to("cpu", copy=True)
    return t.detach().contiguous()


def _shift(t: torch.Tensor, mesh: DataMesh, by: int) -> torch.Tensor:
    """``t`` sent to seq rank ``i + by`` and received from ``i - by``
    (modulo the group): one send and one receive, posted together."""
    n, i = mesh.n_seq, mesh.seq_rank
    send = _staged(t, mesh.seq_group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, mesh.seq_peers[(i + by) % n],
                      mesh.seq_group),
           dist.P2POp(dist.irecv, recv, mesh.seq_peers[(i - by) % n],
                      mesh.seq_group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device)


class _Hop(torch.autograd.Function):
    """One ring hop (JAX ``ppermute`` with ``perm i → i+1``): the
    forward sends to the next rank and receives from the previous one;
    the backward sends the gradient back."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
        ctx.mesh = mesh
        return _shift(x, mesh, 1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _shift(g, ctx.mesh, -1), None


class _SeqSum(torch.autograd.Function):
    """The sum over the seq group (JAX ``psum``); its transpose
    all-reduces the gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
        ctx.mesh = mesh
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _all_reduce(g, ctx.mesh), None


def _all_reduce(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    buf = _staged(t, mesh.seq_group).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.seq_group)
    return buf.to(t.device)


def seq_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """``x`` summed over the seq group, on every rank of it."""
    return x if mesh.n_seq == 1 else _SeqSum.apply(x, mesh)


class _SeqGather(torch.autograd.Function):
    """Every seq rank's ``x`` stacked ``[n_seq, ...]`` (JAX's one-hot
    psum in ``_distributed_linear_scan``); the transpose sums the
    gradients of block s over the group and hands the sum to rank s."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
        ctx.mesh = mesh
        buf = _staged(x, mesh.seq_group)
        out = [torch.empty_like(buf) for _ in range(mesh.n_seq)]
        dist.all_gather(out, buf, group=mesh.seq_group)
        return torch.stack(out).to(x.device)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _all_reduce(g, ctx.mesh)[ctx.mesh.seq_rank], None


def seq_all_gather(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every seq rank's ``x`` stacked on a new leading axis."""
    return x[None] if mesh.n_seq == 1 else _SeqGather.apply(x, mesh)


class _Replicated(torch.autograd.Function):
    """A result the whole seq group holds: the identity, its gradient
    divided by the group's size (each rank's loss is one copy)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, n: int) -> torch.Tensor:
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g / ctx.n, None


def replicated(out, mesh: DataMesh):
    """A seq model's output (a tensor or a tuple of them) marked as held
    by every rank of the group: see the module docstring."""
    if mesh.n_seq == 1:
        return out
    if isinstance(out, tuple):
        return tuple(_Replicated.apply(o, mesh.n_seq) for o in out)
    return _Replicated.apply(out, mesh.n_seq)


def _rotate(kb: torch.Tensor, vb: torch.Tensor, mb: torch.Tensor,
            mesh: DataMesh) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """K, V and the key mask one hop round the ring, as ONE message (the
    mask carried as 0/1 in K's dtype)."""
    sizes = [kb.numel(), vb.numel(), mb.numel()]
    packed = torch.cat([kb.reshape(-1), vb.reshape(-1),
                        mb.to(kb.dtype).reshape(-1)])
    k2, v2, m2 = _Hop.apply(packed, mesh).split(sizes)
    return (k2.view(kb.shape), v2.view(vb.shape),
            m2.detach().view(mb.shape) != 0)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: torch.Tensor, mesh: DataMesh,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Masked bidirectional attention with K/V ring-rotated over the seq
    group (JAX ``ring_attention``, ``parallel/ring.py:49``).

    ``q, k, v [..., H, Wl, Dh]`` are this rank's blocks, ``kv_mask [...,
    Wl]`` bool the validity of its keys (leading axes broadcast, a seed
    axis among them). An online softmax in f32: running max, denominator
    and numerator, rescaled at each hop; invalid keys get ``_NEG``; after
    ``n_seq - 1`` hops every query block has seen every key block.
    Queries with no valid key anywhere return 0. Returns ``[..., H, Wl,
    Dh]`` in ``q.dtype``."""
    n = mesh.n_seq
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf = q.float() * scale
    m_acc = torch.full(qf.shape[:-1], _NEG, dtype=torch.float32,
                       device=q.device)
    l_acc = torch.zeros_like(m_acc)
    o_acc = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    kb, vb, mb = k, v, kv_mask
    for hop in range(n):
        s = torch.einsum("...hqd,...hkd->...hqk", qf, kb.float())
        s = s + torch.where(mb, 0.0, _NEG)[..., None, None, :]
        m_b = s.amax(dim=-1)
        p = torch.exp(s - m_b[..., None])
        l_b = p.sum(dim=-1)
        o_b = torch.einsum("...hqk,...hkd->...hqd", p, vb.float())
        m_new = torch.maximum(m_acc, m_b)
        c_acc = torch.exp(m_acc - m_new)
        c_b = torch.exp(m_b - m_new)
        l_acc = l_acc * c_acc + l_b * c_b
        o_acc = o_acc * c_acc[..., None] + o_b * c_b[..., None]
        m_acc = m_new
        if hop + 1 < n:  # the last hop needs no rotation
            kb, vb, mb = _rotate(kb, vb, mb, mesh)
    # Queries with no valid key anywhere: m_acc is still _NEG.
    empty = m_acc <= _NEG * 0.5
    out = o_acc / torch.where(empty, 1.0, l_acc)[..., None]
    out = torch.where(empty[..., None], 0.0, out)
    return out.to(q.dtype)


def window_block(x: torch.Tensor, mesh: DataMesh, axis: int = -2
                 ) -> torch.Tensor:
    """This seq rank's block of the window axis ``axis`` (its length must
    divide by ``n_seq``)."""
    W = x.shape[axis]
    if W % mesh.n_seq:
        raise ValueError(
            f"window {W} not divisible by seq axis size {mesh.n_seq}")
    wl = W // mesh.n_seq
    return x.narrow(axis, mesh.seq_rank * wl, wl)


def sequence_parallel_apply(model: torch.nn.Module, x: torch.Tensor,
                            m: torch.Tensor, mesh: DataMesh):
    """A ``seq_axis``-aware model on the full ``x [..., W, F]`` and ``m
    [..., W]`` with the WINDOW axis sharded over the mesh's seq group
    (JAX ``sequence_parallel_apply``, ``parallel/ring.py:114``): this
    rank runs its block of the window, and every rank returns the same
    output."""
    with bind_seq_axis(mesh):
        return model(window_block(x, mesh), window_block(m, mesh, axis=-1))
