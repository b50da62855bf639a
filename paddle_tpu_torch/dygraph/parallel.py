"""Dygraph data parallelism on ``torch.distributed`` (counterpart of
paddle_tpu/dygraph/parallel.py).

A rank is one process with its own model replica, driving one card (or
the CPU). A user's loop is the reference's: each rank computes the loss
of its own batch, ``scale_loss`` divides it by the ranks, ``backward``
lands the local gradients, ``apply_collective_grads`` sums them over the
ranks, and every rank applies the same update. At a world of one both
hooks are the identity, as in the JAX package.

Above one rank, ``apply_collective_grads`` flattens the gradients into
one bundle per gradient type (``ops/fused_ops.py``'s ``_bundle``), so
there is one collective a type, not one a parameter. A bundle crosses the
ranks at ``comm_dtype`` (``PADDLE_TPU_COMM_DTYPE``, else the strategy's
``comm_dtype``, else f32), as the JAX package's
``_cross_process_allreduce`` does it: each rank's payload (f32, bf16, or
block-quantized int8 with its scales) is all-gathered, then every rank
dequantizes the rows and sums them in f32 in rank order, so every rank
holds the same bits. The sums land in the parameters' ``.grad`` in place.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .layers import Layer

__all__ = ['ParallelEnv', 'Env', 'prepare_context', 'DataParallel']


def _world():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ParallelEnv:
    """The rank and the world of the default process group (0 and 1
    without one), with the JAX package's endpoint strings."""

    def __init__(self):
        self._local_rank, self._nranks = _world()

    @property
    def nranks(self):
        return self._nranks

    @property
    def local_rank(self):
        return self._local_rank

    @property
    def rank(self):
        return self._local_rank

    @property
    def world_size(self):
        return self._nranks

    @property
    def dev_id(self):
        return 0

    @property
    def current_endpoint(self):
        return f"process:{self._local_rank}"

    @property
    def trainer_endpoints(self):
        return [f"process:{i}" for i in range(self._nranks)]


Env = ParallelEnv


def prepare_context(strategy=None):
    return ParallelEnv()


def _cross_process_allreduce(flat, n, comm):
    """The sum over the ``n`` ranks of one flat f32 bundle, its payload
    at ``comm``: gathered, dequantized and summed in f32 in rank order."""
    from ..parallel import quant_collectives as qc
    from ..parallel.collective import allgather, sum_in_order
    size = flat.numel()
    if comm == 'int8':
        q, s = qc.block_quantize(flat)
        qg, sg = allgather(q), allgather(s)
        return sum_in_order([qc.block_dequantize(qg[r], sg[r])
                             for r in range(n)])[:size]
    if comm == 'bf16':
        return sum_in_order(allgather(flat.to(torch.bfloat16)).float())
    return sum_in_order(allgather(flat))


def _allreduce_bundles(params, reduce_flat, comm='f32', nranks=1,
                       record=True):
    """Flatten every pending gradient into one bundle per gradient type,
    reduce each with one ``reduce_flat(flat_f32) -> flat_f32`` call and
    copy the results back into the parameters' ``.grad``. Returns the
    number of reduce calls, one a type."""
    from ..ops.fused_ops import _bundle, _split
    from ..parallel import quant_collectives as qc
    groups = {}
    for p in params:
        if p.grad is not None:
            groups.setdefault(p.grad.dtype, []).append(p)
    calls = 0
    for dtype, ps in sorted(groups.items(), key=lambda kv: str(kv[0])):
        grads = [p.grad for p in ps]
        flat, shapes, sizes = _bundle(grads)
        reduced = reduce_flat(flat.to(torch.float32))
        calls += 1
        if record:
            qc.record_collective('dygraph_dp', flat.numel(), comm, nranks,
                                 phases=2)
            qc.record_quant_error('dygraph_dp', flat, comm)
        with torch.no_grad():
            torch._foreach_copy_(grads, _split(reduced.to(dtype), shapes,
                                               sizes))
    return calls


class DataParallel(Layer):
    """``DataParallel(layers, strategy=None)`` wraps a layer for data
    parallelism: ``forward`` is the layer's; ``scale_loss(loss)`` divides
    by the ranks and ``apply_collective_grads()`` sums the gradients over
    them (the module docstring), both the identity at a world of one.
    ``parameters``, ``named_parameters``, ``state_dict``, ``set_dict`` and
    ``load_dict`` are the wrapped layer's, under its own names."""

    def __init__(self, layers, strategy=None):
        super().__init__()
        self._layers = layers
        self._strategy = strategy or ParallelEnv()

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @property
    def _nranks(self):
        return _world()[1]

    def scale_loss(self, loss):
        n = self._nranks
        if n <= 1:
            return loss
        return loss * (1.0 / n)

    def apply_collective_grads(self):
        n = self._nranks
        if n <= 1:
            return
        from ..parallel import quant_collectives as qc
        comm = qc.resolve_comm_dtype(
            getattr(self._strategy, 'comm_dtype', None))
        _allreduce_bundles(
            list(self._layers.parameters()),
            lambda flat: _cross_process_allreduce(flat, n, comm),
            comm=comm, nranks=n)

    def parameters(self, include_sublayers=True, **torch_kwargs):
        return self._layers.parameters(include_sublayers, **torch_kwargs)

    def named_parameters(self, prefix='', **torch_kwargs):
        return self._layers.named_parameters(prefix, **torch_kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_dict(self, *a, **k):
        return self._layers.set_dict(*a, **k)

    load_dict = set_dict
