"""Tensor ops of the static graph (counterpart of
paddle_tpu/ops/tensor_ops.py): ``cast``, ``reshape`` and ``fill_constant``."""
from __future__ import annotations

import torch

from ..core.dtypes import to_torch_dtype
from .registry import register_op

__all__ = ['cast', 'reshape', 'fill_constant']


@register_op('cast')
def cast(x, *, dtype):
    """``x`` in ``dtype``. ``int64`` stays 64-bit here; the JAX package
    computes it in int32 unless x64 is on."""
    return x.to(to_torch_dtype(dtype))


@register_op('reshape')
def reshape(x, *, shape):
    """Paddle's reshape: a 0 in ``shape`` copies ``x``'s dim there, one -1
    is inferred."""
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


@register_op('fill_constant')
def fill_constant(*, shape, value, dtype='float32'):
    """A tensor of ``shape`` filled with ``value``. It has no input to take
    a device from: it lands on torch's default device, which the executor
    sets to its own around this op."""
    return torch.full(tuple(shape), value, dtype=to_torch_dtype(dtype))
