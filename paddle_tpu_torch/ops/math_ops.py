"""Elementwise math, products, reductions and comparisons of the static
graph (counterpart of paddle_tpu/ops/math_ops.py): the ops the LeNet
programs, the optimizers and the dygraph Transformer emit. Each is a few
torch calls; the JAX package computes them in XLA, outside any Pallas
kernel, so they stay torch's own ops (so do ``sign``, ``square``,
``sqrt``, ``sum``, ``clip``, ``clip_by_norm`` and ``elementwise_max``,
which the regularizers and gradient clips of regularizer.py and clip.py
append, and the ops the static learning-rate schedules are written in:
``elementwise_min``/``_pow``, ``exp``, ``log``, ``floor``, ``ceil``,
``cos``, ``pow``, the comparisons and ``increment``; ``sigmoid`` and
``tanh``, which every recurrent cell is written in; and the logical ops,
``logical_not`` of which gates the fp16 update of static AMP)."""
from __future__ import annotations

import math

import torch

from .registry import register_op

__all__ = ['elementwise_add', 'elementwise_sub', 'elementwise_mul',
           'elementwise_div', 'scale', 'matmul', 'mul', 'mean',
           'reduce_sum', 'reduce_mean', 'not_equal', 'elementwise_max',
           'sum_op', 'clip', 'clip_by_norm', 'sqrt', 'square', 'sign',
           'elementwise_min', 'elementwise_pow', 'exp', 'log_', 'floor',
           'ceil', 'cos', 'pow_op', 'reduce_max', 'reduce_min', 'equal',
           'less_than', 'less_equal', 'greater_than', 'greater_equal',
           'increment', 'sigmoid', 'tanh', 'elementwise_mod',
           'elementwise_floordiv', 'logical_and', 'logical_or',
           'logical_xor', 'logical_not']


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
elementwise_max = _ew('elementwise_max', torch.maximum)
elementwise_min = _ew('elementwise_min', torch.minimum)
elementwise_pow = _ew('elementwise_pow', torch.pow)
elementwise_mod = _ew('elementwise_mod', torch.remainder)
elementwise_floordiv = _ew('elementwise_floordiv', torch.floor_divide)


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
reduce_max = _reduce('reduce_max', torch.amax)
reduce_min = _reduce('reduce_min', torch.amin)


def _cmp(name, fn):
    @register_op(name)
    def op(x, y):
        return fn(x, y)
    op.__name__ = op.__qualname__ = name
    op.__doc__ = (f'``{fn.__name__}(x, y)``, broadcast, as a bool '
                  f'tensor.')
    return op


not_equal = _cmp('not_equal', torch.ne)
equal = _cmp('equal', torch.eq)
less_than = _cmp('less_than', torch.lt)
less_equal = _cmp('less_equal', torch.le)
greater_than = _cmp('greater_than', torch.gt)
greater_equal = _cmp('greater_equal', torch.ge)
logical_and = _cmp('logical_and', torch.logical_and)
logical_or = _cmp('logical_or', torch.logical_or)
logical_xor = _cmp('logical_xor', torch.logical_xor)


@register_op('sum', variadic=['xs'])
def sum_op(xs):
    """The sum of the tensors of the list ``xs``, added in order."""
    if not isinstance(xs, (list, tuple)):
        return xs
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@register_op('clip')
def clip(x, *, min, max):
    return torch.clamp(x, min, max)


@register_op('clip_by_norm')
def clip_by_norm(x, *, max_norm):
    """``x * (max_norm / ‖x‖)`` where the norm is above ``max_norm``, else
    ``x``."""
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return torch.where(norm > max_norm, x * (max_norm / norm), x)


def _unary(name, fn):
    @register_op(name)
    def op(x):
        return fn(x)
    op.__name__ = op.__qualname__ = name
    op.__doc__ = f'``{fn.__name__}(x)``, elementwise.'
    return op


sqrt = _unary('sqrt', torch.sqrt)
square = _unary('square', torch.square)
sign = _unary('sign', torch.sign)
exp = _unary('exp', torch.exp)
log_ = _unary('log', torch.log)
floor = _unary('floor', torch.floor)
ceil = _unary('ceil', torch.ceil)
cos = _unary('cos', torch.cos)
sigmoid = _unary('sigmoid', torch.sigmoid)
tanh = _unary('tanh', torch.tanh)
logical_not = _unary('logical_not', torch.logical_not)


@register_op('pow')
def pow_op(x, *, factor=1.0):
    return torch.pow(x, factor)


@register_op('increment')
def increment(x, *, value=1.0):
    """``x + value`` in ``x``'s type (an int64 step counter stays
    int64)."""
    return x + torch.tensor(value, dtype=x.dtype)
