"""Tensor ops (counterpart of paddle_tpu/ops/tensor_ops.py): ``cast``,
``reshape``, ``transpose``, ``fill_constant`` and ``one_hot``."""
from __future__ import annotations

import torch

from ..core.dtypes import to_torch_dtype
from .registry import register_op

__all__ = ['cast', 'reshape', 'transpose', 'fill_constant', 'one_hot']


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


@register_op('transpose')
def transpose(x, *, perm):
    return x.permute(*perm)


@register_op('fill_constant')
def fill_constant(*, shape, value, dtype='float32'):
    """A tensor of ``shape`` filled with ``value``. It has no input to take
    a device from: it lands on torch's default device, which the executor
    sets to its own around this op."""
    return torch.full(tuple(shape), value, dtype=to_torch_dtype(dtype))


@register_op('one_hot')
def one_hot(x, *, depth, allow_out_of_range=False):
    """f32 one-hot rows of ``depth`` for the ids ``x`` (a trailing dim of 1
    squeezed); an id outside [0, depth) gives a row of zeros, as
    ``jax.nn.one_hot`` gives it."""
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x[..., 0]
    return (x[..., None] == torch.arange(depth, device=x.device)).to(
        torch.float32)
