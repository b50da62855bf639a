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
``logical_not`` of which gates the fp16 update of static AMP), and every
activation of the JAX package's (the unary ops and ``gelu``,
``leaky_relu``, ``relu6``, ``elu``, ``selu``, ``prelu``, ``brelu``,
``soft_relu``, ``stanh``, ``hard_sigmoid``, ``hard_swish``, ``swish``,
``hard_shrink``, ``softshrink``, ``thresholded_relu``, ``maxout``), which
a dygraph layer's or a static layer's ``act`` names.

The activations give the JAX functions' gradients where those are not
smooth: a ``jnp.where`` branch is picked by the same comparison (the
gradient of ``leaky_relu`` and ``prelu`` at 0 is 1, of ``elu`` and
``selu`` at 0 their negative branch's), ``abs`` has gradient 1 at 0, a
clip's gradient at its bounds is 1/2 (``jnp.clip`` is a max and a min,
whose gradients JAX splits evenly at ties; so do torch's ``maximum`` and
``minimum``, where ``clamp`` gives 1), and ``maxout`` splits a tie
evenly (``amax``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
           'logical_xor', 'logical_not', 'logsigmoid', 'atan',
           'tanh_shrink', 'rsqrt', 'abs_', 'sin', 'acos', 'asin', 'cosh',
           'sinh', 'round_', 'reciprocal', 'softplus', 'softsign', 'erf',
           'gelu', 'leaky_relu', 'relu6', 'elu', 'selu', 'prelu', 'brelu',
           'soft_relu', 'stanh', 'hard_sigmoid', 'hard_swish', 'swish',
           'hard_shrink', 'softshrink', 'thresholded_relu', 'maxout']


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
logsigmoid = _unary('logsigmoid', F.logsigmoid)
atan = _unary('atan', torch.atan)
tanh_shrink = _unary('tanh_shrink', F.tanhshrink)
rsqrt = _unary('rsqrt', torch.rsqrt)
sin = _unary('sin', torch.sin)
acos = _unary('acos', torch.acos)
asin = _unary('asin', torch.asin)
cosh = _unary('cosh', torch.cosh)
sinh = _unary('sinh', torch.sinh)
round_ = _unary('round', torch.round)        # half to even, as jnp.round
reciprocal = _unary('reciprocal', torch.reciprocal)
softplus = _unary('softplus', F.softplus)
softsign = _unary('softsign', F.softsign)
erf = _unary('erf', torch.erf)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: a max and a min, so that the gradient at
    a bound is 1/2 (``clamp``'s is 1)."""
    return torch.minimum(
        torch.maximum(x, torch.tensor(lo, dtype=x.dtype, device=x.device)),
        torch.tensor(hi, dtype=x.dtype, device=x.device))


@register_op('abs')
def abs_(x):
    """``|x|``, with gradient 1 at 0 as JAX's."""
    return torch.where(x >= 0, x, -x)


@register_op('gelu')
def gelu(x, *, approximate=False):
    """GELU in its exact erf form (the tanh form with ``approximate``)."""
    return F.gelu(x, approximate='tanh' if approximate else 'none')


@register_op('leaky_relu')
def leaky_relu(x, *, alpha=0.02):
    """``x`` where ``x >= 0``, else ``alpha * x`` (Paddle's default alpha
    0.02, not torch's 0.01)."""
    return torch.where(x >= 0, x, alpha * x)


@register_op('relu6')
def relu6(x, *, threshold=6.0):
    return _clip(x, 0.0, threshold)


@register_op('elu')
def elu(x, *, alpha=1.0):
    return torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


@register_op('selu')
def selu(x, *, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


@register_op('prelu')
def prelu(x, alpha, *, mode='all'):
    """``x`` where ``x >= 0``, else ``alpha * x``: one ``alpha`` for all
    (``'all'``), one a channel of dim 1 (``'channel'``), or one an element
    of a sample (``'element'``: the flat (prod(x.shape[1:]),) parameter
    read as ``x.shape[1:]``, Paddle's documented meaning; the JAX op
    broadcasts the flat vector against ``x``, and so raises on an input of
    more than two dims, ROADMAP C.4 item 20)."""
    a = alpha
    if mode == 'channel' and a.numel() > 1:
        a = a.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == 'all':
        a = a.reshape(()) if a.numel() == 1 else a
    elif mode == 'element':
        a = a.reshape((1,) + tuple(x.shape[1:]))
    return torch.where(x >= 0, x, a * x)


@register_op('brelu')
def brelu(x, *, t_min=0.0, t_max=24.0):
    return _clip(x, t_min, t_max)


@register_op('soft_relu')
def soft_relu(x, *, threshold=40.0):
    return torch.log1p(torch.exp(_clip(x, -threshold, threshold)))


@register_op('stanh')
def stanh(x, *, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@register_op('hard_sigmoid')
def hard_sigmoid(x, *, slope=0.2, offset=0.5):
    return _clip(slope * x + offset, 0.0, 1.0)


@register_op('hard_swish')
def hard_swish(x, *, threshold=6.0, scale=6.0, offset=3.0):
    return x * _clip(x + offset, 0.0, threshold) / scale


@register_op('swish')
def swish(x, *, beta=1.0):
    return x * torch.sigmoid(beta * x)


@register_op('hard_shrink')
def hard_shrink(x, *, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


@register_op('softshrink')
def softshrink(x, *, lambda_=0.5):
    return torch.where(x > lambda_, x - lambda_,
                       torch.where(x < -lambda_, x + lambda_, _zero(x)))


@register_op('thresholded_relu')
def thresholded_relu(x, *, threshold=1.0):
    return torch.where(x > threshold, x, _zero(x))


@register_op('maxout')
def maxout(x, *, groups, axis=1):
    """The max of each run of ``groups`` channels along ``axis``: C
    channels become C / groups, a tie's gradient split evenly."""
    axis %= x.dim()
    c = x.shape[axis]
    if c % groups:
        raise ValueError(f'maxout: {c} channels do not split into groups '
                         f'of {groups}')
    shape = list(x.shape)
    shape[axis:axis + 1] = [c // groups, groups]
    return torch.amax(x.reshape(shape), dim=axis + 1)


@register_op('pow')
def pow_op(x, *, factor=1.0):
    return torch.pow(x, factor)


@register_op('increment')
def increment(x, *, value=1.0):
    """``x + value`` in ``x``'s type (an int64 step counter stays
    int64)."""
    return x + torch.tensor(value, dtype=x.dtype)
