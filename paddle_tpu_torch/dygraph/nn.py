"""Dygraph layers of the port (counterpart of paddle_tpu/dygraph/nn.py):
``Conv2D``, ``Pool2D``, ``BatchNorm``, ``Linear``, ``Embedding``,
``LayerNorm`` and ``Dropout``, as Layers over the registered ops of
ops/nn_ops.py, with the reference's parameters (plus a keyword-only
``device``; see dygraph/layers.py for where parameters live otherwise).

Parameters come from ``Layer.create_parameter`` with the reference's
initializers and names; ``param_attr`` / ``bias_attr`` work as there.
``Linear.weight`` has Paddle's (in, out) shape, so state dicts and
checkpoints need no transposes. Conv weights are OIHW whatever
``data_format`` (torch's layout; the reference keeps HWIO for NHWC, and
convert.py transposes). An
NHWC conv takes and returns (B, H, W, C) tensors, as the reference's does;
it stores its weight in ``torch.channels_last``, and its ops run torch's
kernels on the channels_last NCHW view of the activation, so nothing is
transposed or copied on the way.

Types follow the reference: convolutions cast the activation to the
weight's type (``_match_weight_dtype``), BatchNorm computes in the
activation's type from f32 statistics, and ``Linear``/``LayerNorm`` promote
as JAX does (bf16 with f32 gives f32).

The reference's other layers raise ``NotImplementedError`` naming ROADMAP
A.4 when built: Conv3D, Conv2DTranspose, Conv3DTranspose, GroupNorm,
SpectralNorm, PRelu, BilinearTensorProduct, GRUUnit, NCE and TreeConv.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..initializer import ConstantInitializer, NormalInitializer
from ..ops.nn_ops import (batch_norm, conv2d, dropout, layer_norm,
                          lookup_table, pool2d)
from .layers import Layer

__all__ = ['Conv2D', 'Pool2D', 'BatchNorm', 'Linear', 'Embedding',
           'LayerNorm', 'Dropout', 'Conv3D', 'Conv2DTranspose',
           'Conv3DTranspose', 'GroupNorm', 'SpectralNorm', 'PRelu',
           'BilinearTensorProduct', 'GRUUnit', 'NCE', 'TreeConv']

_ACTS = {'gelu': F.gelu, 'tanh': torch.tanh, 'relu': torch.relu}


def _check_act(act, allowed=tuple(_ACTS)):
    if act is not None and act not in allowed:
        raise NotImplementedError(f'act={act!r}: only {", ".join(allowed)} '
                                  f'are ported (ROADMAP A.4)')


def _promote(*ts):
    """The tensors in their common type (JAX's promotion: bf16 with f32
    gives f32); the tensors themselves when they already share one, the
    case of every call but an f32 bias meeting bf16 weights under AMP.
    None stays None."""
    dt = ts[0].dtype
    if all(t is None or t.dtype == dt for t in ts):
        return ts
    dt = functools.reduce(torch.promote_types,
                          (t.dtype for t in ts if t is not None))
    return [t if t is None or t.dtype == dt else t.to(dt) for t in ts]


class Conv2D(Layer):
    """Paddle's Conv2D: weight (O, C/groups, fh, fw) drawn from
    Normal(0, sqrt(2 / (fh * fw * C))), a zero bias unless
    ``bias_attr=False``, an optional fused ``act`` (relu only)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None, dtype='float32',
                 data_format='NCHW', *, device=None):
        super().__init__(dtype=dtype, device=device)
        if data_format not in ('NCHW', 'NHWC'):
            raise ValueError(f'data_format must be NCHW or NHWC, got '
                             f'{data_format!r}')
        _check_act(act, ('relu',))
        fs = filter_size if isinstance(filter_size, (list, tuple)) \
            else (filter_size, filter_size)
        std = math.sqrt(2.0 / (fs[0] * fs[1] * num_channels))
        w = self.create_parameter(
            [num_filters, num_channels // groups, fs[0], fs[1]], param_attr,
            dtype, default_initializer=NormalInitializer(0.0, std))
        if data_format == 'NHWC':
            w.data = w.data.contiguous(memory_format=torch.channels_last)
        self.weight = w
        self.bias = self.create_parameter([num_filters], bias_attr, dtype,
                                          is_bias=True)
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation,
                           groups=groups, data_format=data_format)
        self._act = act

    def forward(self, x):
        out = conv2d(x, self.weight, **self._attrs)
        if self.bias is not None:
            shape = ((1, -1, 1, 1) if self._attrs['data_format'] == 'NCHW'
                     else (-1,))
            out = out + self.bias.reshape(shape)
        return torch.relu(out) if self._act == 'relu' else out


class Pool2D(Layer):
    """Paddle's Pool2D over ops/nn_ops.py:pool2d."""

    def __init__(self, pool_size=-1, pool_type='max', pool_stride=1,
                 pool_padding=0, global_pooling=False, use_cudnn=True,
                 ceil_mode=False, exclusive=True, data_format='NCHW'):
        super().__init__()
        self._attrs = dict(pool_size=pool_size, pool_type=pool_type,
                           pool_stride=pool_stride, pool_padding=pool_padding,
                           global_pooling=global_pooling, ceil_mode=ceil_mode,
                           exclusive=exclusive, data_format=data_format)

    def forward(self, x):
        return pool2d(x, **self._attrs)


class BatchNorm(Layer):
    """Paddle's BatchNorm over ops/nn_ops.py:batch_norm: parameters
    ``weight`` (ones) and ``bias`` (zeros); f32 buffers ``_mean_buf``
    (zeros) and ``_variance_buf`` (ones), also read as ``_mean`` and
    ``_variance``. In training it normalises with the batch statistics and
    moves the running ones in place, under ``no_grad``, on the layer's own
    buffers (``copy_``), so they survive ``torch.func.functional_call``'s
    parameter binding in the AMP training step; in eval it normalises with
    the running ones. ``sync_stats=True`` raises (ROADMAP A.9), and so does
    ``act``, which the reference's BatchNorm accepts and never applies."""

    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 dtype='float32', data_layout='NCHW', in_place=False,
                 moving_mean_name=None, moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False,
                 sync_stats=False, *, device=None):
        super().__init__(dtype=dtype, device=device)
        if sync_stats:
            raise NotImplementedError('BatchNorm(sync_stats=True) is not '
                                      'ported yet (ROADMAP A.9)')
        if act is not None:
            raise NotImplementedError('BatchNorm(act=...): the reference '
                                      'ignores it; apply the activation '
                                      'after the layer')
        self.weight = self.create_parameter(
            [num_channels], param_attr, dtype,
            default_initializer=ConstantInitializer(1.0))
        self.bias = self.create_parameter([num_channels], bias_attr, dtype,
                                          is_bias=True)
        self.register_buffer('_mean_buf',
                             self.create_buffer([num_channels], dtype, 0.0))
        self.register_buffer('_variance_buf',
                             self.create_buffer([num_channels], dtype, 1.0))
        self._attrs = dict(momentum=momentum, epsilon=epsilon,
                           data_layout=data_layout,
                           use_global_stats=use_global_stats)

    @property
    def _mean(self):
        return self._mean_buf

    @property
    def _variance(self):
        return self._variance_buf

    def forward(self, x):
        y, new_mean, new_var = batch_norm(
            x, self.weight, self.bias, self._mean_buf, self._variance_buf,
            is_test=not self.training, **self._attrs)
        if self.training:
            with torch.no_grad():
                self._mean_buf.copy_(new_mean)
                self._variance_buf.copy_(new_var)
        return y


class Linear(Layer):
    """Paddle's Linear: ``act(x @ weight + bias)`` with ``weight`` (in, out)
    (Xavier) and ``bias`` (out,) (zeros, none for ``bias_attr=False``);
    ``act`` is ``'gelu'`` (the exact erf form), ``'tanh'`` or ``'relu'``.
    Types promote as in JAX.

    The weight has Paddle's shape over ``nn.Linear``'s memory: it is the
    transpose of a contiguous (out, in) tensor, so the product is the one
    GEMM ``F.linear`` runs, bias in its epilogue, and its gradient lands
    in the same layout with no copy."""

    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype='float32', *, device=None):
        super().__init__(dtype=dtype, device=device)
        _check_act(act)
        w = self.create_parameter([input_dim, output_dim], param_attr,
                                  dtype)
        # (in, out) as a transposed view of (out, in) memory, nn.Linear's
        w.data = w.data.t().contiguous().t()
        self.weight = w
        self.bias = self.create_parameter([output_dim], bias_attr, dtype,
                                          is_bias=True)
        self._act = act

    def forward(self, x):
        x, w, b = _promote(x, self.weight, self.bias)
        y = F.linear(x, w.t(), b)
        return y if self._act is None else _ACTS[self._act](y)


class Embedding(Layer):
    """Paddle's Embedding over the ``lookup_table`` op: a (vocab, dim)
    table (Xavier); rows of ``padding_idx`` (negative counts from the end)
    read as zeros. ``is_sparse=True`` (rows-only gradients) is not ported
    and raises (ROADMAP A.10, ``ops/sparse_ops.py``)."""

    def __init__(self, size, is_sparse=False, is_distributed=False,
                 padding_idx=None, param_attr=None, dtype='float32', *,
                 device=None):
        super().__init__(dtype=dtype, device=device)
        if is_sparse:
            raise NotImplementedError(
                'Embedding(is_sparse=True): rows-only gradients '
                '(ops/sparse_ops.py) are not ported yet (ROADMAP A.10)')
        self.weight = self.create_parameter(list(size), param_attr, dtype)
        self._padding_idx = -1 if padding_idx is None else (
            padding_idx if padding_idx >= 0 else size[0] + padding_idx)
        self._is_distributed = is_distributed

    def forward(self, ids):
        return lookup_table(self.weight, ids, padding_idx=self._padding_idx,
                            is_distributed=self._is_distributed)


class LayerNorm(Layer):
    """Paddle's LayerNorm over the trailing ``normalized_shape`` dims:
    scale (ones) and shift (zeros) unless turned off, epsilon 1e-5, an
    optional ``act``."""

    def __init__(self, normalized_shape, scale=True, shift=True,
                 epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
                 dtype='float32', *, device=None):
        super().__init__(dtype=dtype, device=device)
        _check_act(act)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        n = math.prod(normalized_shape)
        self.weight = self.create_parameter(
            [n], param_attr, dtype,
            default_initializer=ConstantInitializer(1.0)) if scale else None
        self.bias = self.create_parameter(
            [n], bias_attr, dtype, is_bias=True) if shift else None
        self._epsilon = epsilon
        self._ndims = len(normalized_shape)
        self._act = act

    def forward(self, x):
        out = layer_norm(x, self.weight, self.bias,
                         begin_norm_axis=x.dim() - self._ndims,
                         epsilon=self._epsilon)
        return out if self._act is None else _ACTS[self._act](out)


class Dropout(Layer):
    """Paddle's Dropout over the ``dropout`` op: in training each element
    is zeroed with probability ``p``; ``upscale_in_train`` scales the kept
    ones by 1/(1-p), ``downgrade_in_infer`` (the default) scales by 1-p at
    inference instead. Masks come from a generator of ``seed`` when one is
    given, else from ``generator`` if one is set, else from the device's
    generator (core/random.py). Like the JAX layer it follows
    ``train()``/``eval()`` and not ``is_test``."""

    def __init__(self, p=0.5, seed=None,
                 dropout_implementation='downgrade_in_infer',
                 is_test=False):
        super().__init__()
        if dropout_implementation not in ('downgrade_in_infer',
                                          'upscale_in_train'):
            raise ValueError(f'dropout_implementation '
                             f'{dropout_implementation!r}')
        self._p = float(p)
        self._seed = seed
        self._impl = dropout_implementation
        self.generator = None

    def _key(self, device):
        if self._seed is None:
            if self.generator is not None:
                return self.generator
            from ..core.random import default_generator
            return default_generator.generator(device)
        if self.generator is None or self.generator.device != device:
            self.generator = torch.Generator(device=device)
            self.generator.manual_seed(int(self._seed))
        return self.generator

    def forward(self, x):
        if self._p == 0.0:
            return x
        return dropout(x, dropout_prob=self._p, is_test=not self.training,
                       dropout_implementation=self._impl,
                       key=self._key(x.device) if self.training else None)


def _unported(name, sig):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f'dygraph.{name} is not ported yet '
                                  f'(ROADMAP A.4)')
    __init__.__doc__ = f'{name}{sig}: not ported yet (ROADMAP A.4).'
    return type(name, (Layer,), {'__init__': __init__,
                                 '__doc__': __init__.__doc__,
                                 '__module__': __name__})


Conv3D = _unported('Conv3D', '(num_channels, num_filters, filter_size)')
Conv2DTranspose = _unported('Conv2DTranspose',
                            '(num_channels, num_filters, filter_size)')
Conv3DTranspose = _unported('Conv3DTranspose',
                            '(num_channels, num_filters, filter_size)')
GroupNorm = _unported('GroupNorm', '(channels, groups)')
SpectralNorm = _unported('SpectralNorm', '(weight_shape)')
PRelu = _unported('PRelu', '(mode)')
BilinearTensorProduct = _unported('BilinearTensorProduct',
                                  '(input1_dim, input2_dim, output_dim)')
GRUUnit = _unported('GRUUnit', '(size)')
NCE = _unported('NCE', '(num_total_classes, dim)')
TreeConv = _unported('TreeConv', '(feature_size, output_size)')
