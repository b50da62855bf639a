"""Elementwise math, products and reductions of the static graph
(counterpart of paddle_tpu/ops/math_ops.py): the ops the LeNet programs,
the optimizers and the dygraph Transformer emit. Each is a few torch
calls; the JAX package computes them in XLA, outside any Pallas kernel, so
they stay torch's own ops."""
from __future__ import annotations

import math

import torch

from .registry import register_op

__all__ = ['elementwise_add', 'elementwise_sub', 'elementwise_mul',
           'elementwise_div', 'scale', 'matmul', 'mul', 'mean',
           'reduce_sum', 'reduce_mean', 'not_equal']


def _align_y(x, y, axis=-1):
    """Paddle's elementwise broadcast: a ``y`` of lower rank lines up with
    ``x`` from dim ``axis`` (-1: from the trailing dims)."""
    if y.dim() == 0 or x.shape == y.shape or y.dim() >= x.dim():
        return y
    if axis == -1 or axis is None:
        axis = x.dim() - y.dim()
    trailing = x.dim() - axis - y.dim()
    if trailing > 0:
        y = y.reshape(tuple(y.shape) + (1,) * trailing)
    return y


def _ew(name, fn):
    @register_op(name)
    def op(x, y, *, axis=-1):
        return fn(x, _align_y(x, y, axis))
    op.__name__ = op.__qualname__ = name
    op.__doc__ = (f'``{fn.__name__}(x, y)`` with ``y`` aligned to ``x`` '
                  f'from dim ``axis`` (Paddle\'s broadcast).')
    return op


elementwise_add = _ew('elementwise_add', torch.add)
elementwise_sub = _ew('elementwise_sub', torch.sub)
elementwise_mul = _ew('elementwise_mul', torch.mul)
elementwise_div = _ew('elementwise_div', torch.div)


@register_op('scale')
def scale(x, *, scale=1.0, bias=0.0, bias_after_scale=True):
    """``x * scale + bias`` (or ``(x + bias) * scale``) in ``x``'s type."""
    s = torch.tensor(scale, dtype=x.dtype)
    b = torch.tensor(bias, dtype=x.dtype)
    return x * s + b if bias_after_scale else (x + b) * s


@register_op('matmul')
def matmul(x, y, *, transpose_x=False, transpose_y=False, alpha=1.0):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        out = out * torch.tensor(alpha, dtype=out.dtype)
    return out


@register_op('mul')
def mul(x, y, *, x_num_col_dims=1, y_num_col_dims=1):
    """Paddle's mul: ``x`` flattened to 2-D at ``x_num_col_dims``, ``y`` at
    ``y_num_col_dims``, multiplied, and the product shaped
    ``x.shape[:x_num_col_dims] + y.shape[y_num_col_dims:]``."""
    xs, ys = tuple(x.shape), tuple(y.shape)
    xm = x.reshape(math.prod(xs[:x_num_col_dims]), -1)
    ym = y.reshape(math.prod(ys[:y_num_col_dims]), -1)
    return (xm @ ym).reshape(xs[:x_num_col_dims] + ys[y_num_col_dims:])


@register_op('mean')
def mean(x):
    return torch.mean(x)


def _norm_dim(dim, ndim):
    if dim is None:
        return None
    dims = [dim] if isinstance(dim, int) else list(dim)
    return tuple(d % ndim for d in dims)


def _reduce(name, fn):
    @register_op(name)
    def op(x, *, dim=None, keep_dim=False, reduce_all=False):
        axis = None if reduce_all or dim is None else _norm_dim(dim, x.dim())
        if axis is None:
            out = fn(x)
            return out.reshape((1,) * x.dim()) if keep_dim else out
        return fn(x, dim=axis, keepdim=keep_dim)
    op.__name__ = op.__qualname__ = name
    op.__doc__ = (f'``{fn.__name__}`` over ``dim`` (every dim with '
                  f'``reduce_all`` or ``dim=None``).')
    return op


reduce_sum = _reduce('reduce_sum', torch.sum)
reduce_mean = _reduce('reduce_mean', torch.mean)


@register_op('not_equal')
def not_equal(x, y):
    """``x != y``, broadcast, as a bool tensor."""
    return torch.ne(x, y)
