"""Quantized collectives: fewer bytes on the wire for gradient sync
(counterpart of paddle_tpu/parallel/quant_collectives.py).

- The codecs. ``rowwise_quantize`` is the int8 KV pool's (one scale a
  row, serving/decode/kv_cache.py); ``block_quantize`` is the gradient
  codec, one f32 scale a block of 256 contiguous elements. Both keep the
  reference's order of operations, so the two packages give the same
  bits: the scale ``absmax / 127``, its reciprocal (0 for an all-zero
  block or row), the product, ``torch.round`` (half to even, as
  ``jnp.round``), the clip to ±127 and the cast. The scale divides by a
  tensor of 127s: CUDA turns a division by a Python number into a
  product by its reciprocal, which rounds otherwise, so the card's codec
  would part from the CPU's and the reference's.
- The collectives, over the process group (parallel/collective.py), the
  reference's EQuARX decomposition: each rank quantizes its padded copy,
  an all-to-all sends chunk i to rank i (the reduce-scatter phase), the
  partials are dequantized and summed in f32 in rank order, the reduced
  chunk is requantized and all-gathered, and every rank dequantizes the
  whole. At ``f32`` or in a group of one rank each is the plain
  collective, exactly.
- ``comm_dtype`` is one knob: ``PADDLE_TPU_COMM_DTYPE`` (wins), then the
  argument (a strategy's ``comm_dtype``), then ``'f32'``; an unknown name
  raises ``ValueError`` naming the supported set.
- Accounting: ``wire_bytes`` (the logical bytes one rank puts on the
  wire), ``record_collective`` and ``record_quant_error`` into the
  observability registry (no-ops with telemetry off), under the JAX
  package's metric names.

The sparse gather (``sparse_allgather``, ``record_sparse_collective``)
waits for ROADMAP A.10's rows-only gradients.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from .. import observability as _obs
from .collective import (allgather, allreduce_mean, allreduce_sum, alltoall,
                         group_rank, group_size, sum_in_order)

__all__ = ['SUPPORTED_COMM_DTYPES', 'resolve_comm_dtype', 'block_quantize',
           'block_dequantize', 'qallreduce_sum', 'qallreduce_mean',
           'qreduce_scatter_sum', 'wire_bytes', 'record_collective',
           'quant_error_stats', 'record_quant_error', 'DEFAULT_BLOCK_SIZE',
           'rowwise_quantize', 'rowwise_dequantize']

SUPPORTED_COMM_DTYPES = ('f32', 'bf16', 'int8')
DEFAULT_BLOCK_SIZE = 256
ENV_COMM_DTYPE = 'PADDLE_TPU_COMM_DTYPE'


def _validate(value, source):
    if value not in SUPPORTED_COMM_DTYPES:
        raise ValueError(
            f"{source}: unknown comm_dtype {value!r} "
            f"(supported: {', '.join(SUPPORTED_COMM_DTYPES)})")
    return value


def resolve_comm_dtype(value=None):
    """``PADDLE_TPU_COMM_DTYPE`` if set, else ``value`` if given, else
    ``'f32'``; an unknown name raises."""
    env = os.environ.get(ENV_COMM_DTYPE)
    if env is not None and env != '':
        return _validate(env, ENV_COMM_DTYPE)
    if value is not None:
        return _validate(value, 'comm_dtype')
    return 'f32'


def _padded_size(size, block_size):
    return -(-size // block_size) * block_size


def _over_127(absmax):
    """``absmax / 127`` rounded as a true division on every device."""
    return absmax / torch.full_like(absmax, 127.0)


def _reciprocal(scale):
    pos = scale > 0
    return torch.where(pos, 1.0 / torch.where(pos, scale,
                                              torch.ones_like(scale)),
                       torch.zeros_like(scale))


def block_quantize(x, block_size=DEFAULT_BLOCK_SIZE):
    """``(q, scales)``: ``x`` flattened to f32, padded with zeros to whole
    blocks, as int8 ``q`` (padded,) and one f32 scale a block (padded //
    block_size,). An all-zero block gets scale 0 and decodes to zeros."""
    f = x.reshape(-1).to(torch.float32)
    size = f.numel()
    padded = _padded_size(max(size, 1), block_size)
    if padded != size:
        f = F.pad(f, (0, padded - size))
    b = f.reshape(-1, block_size)
    scale = _over_127(b.abs().amax(dim=1))
    q = torch.clamp(torch.round(b * _reciprocal(scale)[:, None]), -127, 127)
    return q.to(torch.int8).reshape(-1), scale


def block_dequantize(q, scales, shape=None, block_size=DEFAULT_BLOCK_SIZE):
    """The inverse of :func:`block_quantize`; ``shape`` slices the padding
    off and reshapes."""
    f = (q.reshape(-1, block_size).to(torch.float32)
         * scales.to(torch.float32)[:, None]).reshape(-1)
    if shape is not None:
        shape = tuple(shape)
        size = 1
        for d in shape:
            size *= int(d)
        f = f[:size].reshape(shape)
    return f


def rowwise_quantize(vals):
    """``(q, scale)``: ``vals`` (..., D) f32 as int8 rows of symmetric
    round-to-nearest values and one f32 scale (...,) per row, absmax / 127.
    An all-zero row gets scale 0 and decodes to exact zeros."""
    v = torch.as_tensor(vals, dtype=torch.float32)
    scale = _over_127(v.abs().amax(dim=-1))
    q = torch.clamp(torch.round(v * _reciprocal(scale)[..., None]),
                    -127, 127)
    return q.to(torch.int8), scale


def rowwise_dequantize(q, scales):
    """f32 rows of ``q`` (..., D) int8 times their ``scales`` (...,)."""
    return q.to(torch.float32) * scales.to(torch.float32)[..., None]


def _encode(flat, comm_dtype, block_size):
    if comm_dtype == 'int8':
        return block_quantize(flat, block_size)
    return flat.to(torch.bfloat16), None


def _dequantize_rows(payload, scales, n, block_size):
    """(n, m) f32 from n rows of payload (and their block scales)."""
    if scales is None:
        return payload.reshape(n, -1).to(torch.float32)
    m = payload.numel() // n
    return (payload.reshape(n, m // block_size, block_size)
            .to(torch.float32)
            * scales.reshape(n, m // block_size)[:, :, None]).reshape(n, m)


def qallreduce_sum(x, axis='dp', comm_dtype=None, block_size=None):
    """All-reduce-sum of ``x`` over the group with the payload at
    ``comm_dtype`` (the two phases of the module docstring); the plain
    all-reduce at ``f32`` or in a group of one."""
    comm = resolve_comm_dtype(comm_dtype)
    block_size = int(block_size or DEFAULT_BLOCK_SIZE)
    n = group_size(axis)
    if comm == 'f32' or n == 1:
        return allreduce_sum(x, axis)
    shape, dtype = x.shape, x.dtype
    size = x.numel()
    chunk = _padded_size(-(-size // n), block_size)
    padded = chunk * n
    f = x.reshape(-1).to(torch.float32)
    if padded != size:
        f = F.pad(f, (0, padded - size))
    payload, scales = _encode(f, comm, block_size)
    part = _dequantize_rows(
        alltoall(payload, axis), None if scales is None
        else alltoall(scales, axis), n, block_size)
    reduced = sum_in_order(part)
    payload, scales = _encode(reduced, comm, block_size)
    out = _dequantize_rows(
        allgather(payload, axis), None if scales is None
        else allgather(scales, axis), n, block_size).reshape(-1)
    return out[:size].reshape(shape).to(dtype)


def qallreduce_mean(x, axis='dp', comm_dtype=None, block_size=None):
    """The mean counterpart of :func:`qallreduce_sum`."""
    comm = resolve_comm_dtype(comm_dtype)
    n = group_size(axis)
    if comm == 'f32' or n == 1:
        return allreduce_mean(x, axis)
    s = qallreduce_sum(x, axis, comm_dtype=comm, block_size=block_size)
    return (s / n).to(x.dtype)


def qreduce_scatter_sum(x, axis='dp', comm_dtype=None, block_size=None,
                        scattered_dimension=0):
    """This rank's tile (1/n of ``scattered_dimension``) of the sum over
    the ranks, ``lax.psum_scatter(..., tiled=True)``'s meaning, with the
    payload at ``comm_dtype``: phase 1 of :func:`qallreduce_sum` alone.
    The plain sum's tile at ``f32`` or in a group of one."""
    comm = resolve_comm_dtype(comm_dtype)
    block_size = int(block_size or DEFAULT_BLOCK_SIZE)
    n = group_size(axis)
    d = scattered_dimension
    if x.shape[d] % n:
        raise ValueError(
            f"qreduce_scatter_sum: dim {d} of shape {tuple(x.shape)} is "
            f"not divisible by the axis size {n}")
    k = x.shape[d] // n
    if comm == 'f32' or n == 1:
        return allreduce_sum(x, axis).narrow(d, group_rank(axis) * k, k)
    dtype = x.dtype
    moved = torch.movedim(x, d, 0)
    tile_shape = (k,) + tuple(moved.shape[1:])
    piece = moved[:k].numel()
    padded = _padded_size(piece, block_size)
    flat = moved.reshape(n, piece).to(torch.float32)
    if padded != piece:
        flat = F.pad(flat, (0, padded - piece))
    payload, scales = _encode(flat.reshape(-1), comm, block_size)
    part = _dequantize_rows(
        alltoall(payload, axis), None if scales is None
        else alltoall(scales, axis), n, block_size)
    tile = sum_in_order(part)[:piece].reshape(tile_shape)
    return torch.movedim(tile, 0, d).to(dtype)


def wire_bytes(num_elements, comm_dtype, axis_size, block_size=None,
               phases=2):
    """Logical payload bytes one rank puts on the wire for a collective
    over ``num_elements``: ``phases`` passes over the block-padded tensor
    at the codec's width, plus the f32 scales for int8; 0 in a group of
    one."""
    comm = resolve_comm_dtype(comm_dtype)
    if axis_size <= 1:
        return 0
    block_size = int(block_size or DEFAULT_BLOCK_SIZE)
    n = int(num_elements)
    if comm == 'f32':
        return phases * n * 4
    padded = _padded_size(n, block_size)
    if comm == 'bf16':
        return phases * padded * 2
    return phases * (padded + (padded // block_size) * 4)


def record_collective(path, num_elements, comm_dtype, axis_size,
                      block_size=None, phases=2):
    """One sync call into the registry: ``collective_sync_calls``, the
    bytes on the wire at ``comm_dtype`` and their f32 equivalent. No-op
    with telemetry off."""
    if not _obs._ENABLED:
        return
    comm = resolve_comm_dtype(comm_dtype)
    _obs.inc('collective_sync_calls', 1,
             help='gradient/param sync collectives by path and comm dtype',
             path=path, dtype=comm)
    _obs.inc('collective_bytes_on_wire',
             wire_bytes(num_elements, comm, axis_size,
                        block_size=block_size, phases=phases),
             help='logical collective payload bytes at the wire dtype',
             path=path, dtype=comm)
    _obs.inc('collective_bytes_f32_equiv',
             wire_bytes(num_elements, 'f32', axis_size, phases=phases),
             help='f32-equivalent bytes for the same syncs (ratio = '
                  'compression)',
             path=path)


def quant_error_stats(x, comm_dtype=None, block_size=None):
    """``(max_abs_err, max_rel_err)`` of one codec round trip of ``x``,
    the relative one against its absmax; ``(0.0, 0.0)`` at f32."""
    comm = resolve_comm_dtype(comm_dtype)
    f = x.reshape(-1).to(torch.float32)
    if comm == 'f32':
        return 0.0, 0.0
    block_size = int(block_size or DEFAULT_BLOCK_SIZE)
    if comm == 'int8':
        q, s = block_quantize(f, block_size)
        rt = block_dequantize(q, s, block_size=block_size)[:f.numel()]
    else:
        rt = f.to(torch.bfloat16).to(torch.float32)
    err = float((rt - f).abs().max()) if f.numel() else 0.0
    amax = float(f.abs().max()) if f.numel() else 0.0
    return err, (err / amax if amax > 0 else 0.0)


def record_quant_error(path, x, comm_dtype=None, block_size=None):
    """The round-trip relative error of one synced tensor into the
    ``collective_quant_rel_error`` histogram (telemetry on, not at f32)."""
    if not _obs._ENABLED:
        return
    comm = resolve_comm_dtype(comm_dtype)
    if comm == 'f32':
        return
    _, rel = quant_error_stats(x, comm, block_size)
    _obs.observe('collective_quant_rel_error', rel,
                 help='per-call codec round-trip error relative to tensor '
                      'absmax (one phase of the two-phase contract)',
                 path=path, dtype=comm)
