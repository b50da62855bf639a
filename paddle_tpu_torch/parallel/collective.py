"""Collective communication over ``torch.distributed`` (counterpart of
paddle_tpu/parallel/collective.py).

A rank is one process, driving one card or the CPU. The JAX package's
collectives run inside a ``shard_map`` over a mesh axis; here they run
eagerly over the default process group, which the ``axis`` argument names
(every name names it: the port has no mesh yet, ROADMAP A.9). Each has the
meaning of its ``lax`` namesake with the group's ranks as the axis:

- ``allreduce_sum``/``_mean``/``_max``/``_min``: the elementwise
  reduction over the ranks, in the input's type;
- ``allgather``: the ranks' values stacked on a new first axis, (n, ...);
- ``reduce_scatter``: ``lax.psum_scatter``'s untiled form: the first axis
  has one entry a rank, and each rank gets its entry of the sum (an
  all-reduce and a pick: one form for both backends);
- ``broadcast``: rank ``root``'s value;
- ``alltoall``: the first axis split in n chunks, chunk i sent to rank i,
  the received chunks concatenated in rank order;
- ``ppermute``: for each ``(src, dst)`` pair of ``perm``, rank dst gets
  rank src's value, a rank no pair names gets zeros (gathered, then
  picked);
- ``barrier``: waits for every rank; returns a 0-d f32 zero, as the JAX
  one returns its ``psum`` of zero.

Without a process group, or in one of a single rank, each returns its
single-process meaning (the sums, the means and the moves return the
input; ``allgather`` adds the axis of one). The JAX eager functions raise
outside a ``shard_map`` (ROADMAP C.18).

The gloo backend may refuse CUDA tensors, and some types (bf16, int8):
with gloo, each collective runs on a host copy of its input and its
result is copied back to the input's device, and the moves (gathers,
broadcasts, all-to-alls) carry a tensor of another type than f32, f64,
int32, int64 and uint8 as its bytes (a uint8 view), which is exact. NCCL
runs on the card as it is. Nothing is caught: a collective that fails
raises.

The registered ``c_*`` ops are the reference's collective ops in a
program. Where no group of more than one rank exists they are the
identity, the JAX package's ``_axis_bound`` rule for ``c_allreduce_sum``
and its bucket, which the port applies to all of them (the JAX package's
others raise on an unbound axis, ROADMAP C.18); in a larger group they
are the collectives above, ``c_allreduce_sum`` at its ``comm_dtype``
(quant_collectives.py).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.registry import register_op

__all__ = ['group_size', 'group_rank', 'allreduce_sum', 'allreduce_mean',
           'allreduce_max', 'allreduce_min', 'allgather', 'reduce_scatter',
           'broadcast', 'alltoall', 'ppermute', 'barrier', 'sum_in_order']


def _live():
    return dist.is_available() and dist.is_initialized()


def group_size(axis='dp'):
    """The ranks of the group ``axis`` names: the default process
    group's, 1 without one."""
    return dist.get_world_size() if _live() else 1


def group_rank(axis='dp'):
    """This process's rank in the group ``axis`` names, 0 without one."""
    return dist.get_rank() if _live() else 0


def _gloo():
    return dist.get_backend() == 'gloo'


_GLOO_TYPES = (torch.float32, torch.float64, torch.int32, torch.int64,
               torch.uint8)


def _comm_copy(x, move=False):
    """A contiguous copy of ``x`` for a collective to write: on the host
    under gloo, and for a move under gloo one of another type as its
    bytes."""
    t = x.detach()
    if _gloo():
        t = t.cpu().contiguous()
        if move and t.dtype not in _GLOO_TYPES:
            return t.view(torch.uint8).clone()
    return t.clone(memory_format=torch.contiguous_format)


def _back(t, x):
    """``t`` in ``x``'s type, on ``x``'s device."""
    if t.dtype != x.dtype:
        t = t.view(x.dtype)
    return t.to(x.device)


def _reduce(x, op):
    if group_size() <= 1:
        return x
    t = _comm_copy(x)
    dist.all_reduce(t, op=op)
    return _back(t, x)


def allreduce_sum(x, axis='dp'):
    return _reduce(x, dist.ReduceOp.SUM)


def allreduce_mean(x, axis='dp'):
    n = group_size(axis)
    if n <= 1:
        return x
    return (allreduce_sum(x, axis) / n).to(x.dtype)


def allreduce_max(x, axis='dp'):
    return _reduce(x, dist.ReduceOp.MAX)


def allreduce_min(x, axis='dp'):
    return _reduce(x, dist.ReduceOp.MIN)


def allgather(x, axis='dp'):
    """(n, *x.shape): every rank's ``x`` in rank order."""
    n = group_size(axis)
    if n <= 1:
        return x.unsqueeze(0)
    t = _comm_copy(x, move=True)
    out = t.new_empty((n,) + tuple(t.shape))
    dist.all_gather(list(out.unbind(0)), t)
    return _back(out, x)


def reduce_scatter(x, axis='dp'):
    """This rank's entry of the sum over the ranks of ``x`` (n, ...)."""
    n = group_size(axis)
    if x.shape[0] != n:
        raise ValueError(f'reduce_scatter: the first axis of {tuple(x.shape)}'
                         f' must have one entry a rank ({n})')
    return allreduce_sum(x, axis)[group_rank(axis)]


def broadcast(x, root=0, axis='dp'):
    """Rank ``root``'s ``x`` on every rank."""
    if group_size(axis) <= 1:
        return x
    t = _comm_copy(x, move=True)
    dist.broadcast(t, src=root)
    return _back(t, x)


def alltoall(x, axis='dp'):
    """Chunk i of ``x``'s first axis to rank i; the chunks received,
    concatenated in rank order."""
    n = group_size(axis)
    if x.shape[0] % n:
        raise ValueError(f'alltoall: the first axis of {tuple(x.shape)} is '
                         f'not a multiple of the ranks ({n})')
    if n <= 1:
        return x
    t = _comm_copy(x, move=True)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t)
    return _back(out, x)


def ppermute(x, perm, axis='dp'):
    """For each ``(src, dst)`` of ``perm``, rank dst gets rank src's
    ``x``; a rank that is no pair's dst gets zeros."""
    me = group_rank(axis)
    src = [s for s, d in perm if d == me]
    gathered = allgather(x, axis)
    return gathered[src[0]] if src else torch.zeros_like(x)


def barrier(axis='dp'):
    if group_size(axis) > 1:
        dist.barrier()
    return torch.zeros((), dtype=torch.float32)


def sum_in_order(rows):
    """The sum of ``rows`` (a (n, ...) tensor or a list), added one after
    the other in rank order, so every rank that holds the same rows gets
    the same bits."""
    acc = rows[0].clone()
    for r in rows[1:]:
        acc.add_(r)
    return acc


# the reference's collective ops in a program: the identity where no group
# of more than one rank exists (see the module docstring)
def _bound(axis):
    return group_size(axis) > 1


@register_op('c_allreduce_sum')
def c_allreduce_sum(x, *, ring_id=0, use_calc_stream=True, axis='dp',
                    comm_dtype=None):
    """AllReduce-sum; ``comm_dtype`` (f32/bf16/int8) block-quantizes the
    payload (quant_collectives.py), exact at f32."""
    if not _bound(axis):
        return x
    from . import quant_collectives as qc
    return qc.qallreduce_sum(x, axis, comm_dtype=comm_dtype)


@register_op('c_allreduce_sum_bucket', variadic=('xs',))
def c_allreduce_sum_bucket(xs, *, ring_id=0, use_calc_stream=True,
                           axis='dp', comm_dtype=None):
    """One bucket of gradient AllReduces: the members flattened into one
    bundle, one collective over it, the results split back to the
    members' shapes."""
    from ..ops.fused_ops import _bundle, _split
    flat, shapes, sizes = _bundle(xs)
    if _bound(axis):
        from . import quant_collectives as qc
        flat = qc.qallreduce_sum(flat, axis, comm_dtype=comm_dtype)
    return _split(flat, shapes, sizes)


@register_op('c_allreduce_max')
def c_allreduce_max(x, *, ring_id=0, use_calc_stream=True, axis='dp'):
    return allreduce_max(x, axis) if _bound(axis) else x


@register_op('c_allreduce_min')
def c_allreduce_min(x, *, ring_id=0, use_calc_stream=True, axis='dp'):
    return allreduce_min(x, axis) if _bound(axis) else x


@register_op('c_allreduce_prod')
def c_allreduce_prod(x, *, ring_id=0, use_calc_stream=True, axis='dp'):
    return torch.prod(allgather(x, axis), dim=0) if _bound(axis) else x


@register_op('c_allgather')
def c_allgather(x, *, nranks=1, ring_id=0, use_calc_stream=True, axis='dp'):
    """The ranks' values concatenated on the first axis."""
    if not _bound(axis):
        return x
    g = allgather(x, axis)
    return g.reshape((-1,) + tuple(g.shape[2:]))


@register_op('c_broadcast')
def c_broadcast(x, *, root=0, ring_id=0, use_calc_stream=True, axis='dp'):
    return broadcast(x, root, axis) if _bound(axis) else x


@register_op('c_reducescatter')
def c_reducescatter(x, *, nranks=1, ring_id=0, use_calc_stream=True,
                    axis='dp'):
    return reduce_scatter(x, axis) if _bound(axis) else x


@register_op('c_sync_calc_stream')
def c_sync_calc_stream(x):
    return x


@register_op('c_sync_comm_stream')
def c_sync_comm_stream(x):
    return x
