"""Dygraph layers of the port (counterpart of paddle_tpu/dygraph/nn.py):
``Conv2D``, ``Pool2D``, ``BatchNorm``, ``Linear``, ``LayerNorm`` and
``Dropout``, as ``nn.Module``s over ops/nn_ops.py.

Conv weights are OIHW whatever ``data_format`` (torch's layout; the
reference keeps HWIO for NHWC, and convert.py transposes). An NHWC layer
takes and returns (B, H, W, C) tensors, as the reference's does; it stores
its conv weight in ``torch.channels_last``, and its ops run torch's kernels
on the channels_last NCHW view of the activation, so nothing is transposed
or copied on the way.

Types follow the reference: convolutions cast the activation to the
weight's type (``_match_weight_dtype``), BatchNorm computes in the
activation's type from f32 statistics, and ``Linear``/``LayerNorm`` promote
as JAX does (bf16 with f32 gives f32).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nn_ops import batch_norm, conv2d, pool2d

__all__ = ['Conv2D', 'Pool2D', 'BatchNorm', 'Linear', 'LayerNorm', 'Dropout']


def _promote(*ts):
    """The tensors in their common type (JAX's promotion: bf16 with f32
    gives f32); the tensors themselves when they already share one, the
    case of every call but an f32 bias meeting bf16 weights under AMP."""
    dt = ts[0].dtype
    if all(t.dtype == dt for t in ts):
        return ts
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return [t if t.dtype == dt else t.to(dt) for t in ts]


class Conv2D(nn.Module):
    """Paddle's Conv2D: weight (O, C/groups, fh, fw) drawn from
    Normal(0, sqrt(2 / (fh * fw * C))) with ``generator``, a zero bias
    unless ``bias_attr=False``, an optional fused ``act``. ``param_attr``
    and a ``ParamAttr`` ``bias_attr`` are not ported and raise."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None, dtype='float32',
                 data_format='NCHW', device=None, generator=None):
        super().__init__()
        if param_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError('param_attr / ParamAttr bias_attr are '
                                      'not ported; weights load through '
                                      'convert.py')
        if dtype != 'float32':
            raise NotImplementedError(f'dtype={dtype!r}: parameters are f32 '
                                      f'masters')
        if data_format not in ('NCHW', 'NHWC'):
            raise ValueError(f'data_format must be NCHW or NHWC, got '
                             f'{data_format!r}')
        fs = filter_size if isinstance(filter_size, (list, tuple)) \
            else (filter_size, filter_size)
        std = math.sqrt(2.0 / (fs[0] * fs[1] * num_channels))
        fmt = (torch.channels_last if data_format == 'NHWC'
               else torch.contiguous_format)
        w = torch.empty((num_filters, num_channels // groups, fs[0], fs[1]),
                        device=device, memory_format=fmt)
        with torch.no_grad():
            w.normal_(0.0, std, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = (None if bias_attr is False else
                     nn.Parameter(torch.zeros(num_filters, device=device)))
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation,
                           groups=groups, data_format=data_format)
        if act not in (None, 'relu'):
            raise NotImplementedError(f'act={act!r}: only relu is ported')
        self._act = act

    def forward(self, x):
        out = conv2d(x, self.weight, **self._attrs)
        if self.bias is not None:
            shape = ((1, -1, 1, 1) if self._attrs['data_format'] == 'NCHW'
                     else (-1,))
            out = out + self.bias.reshape(shape)
        return torch.relu(out) if self._act == 'relu' else out


class Pool2D(nn.Module):
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


class BatchNorm(nn.Module):
    """Paddle's BatchNorm over ops/nn_ops.py:batch_norm: parameters
    ``weight`` (ones) and ``bias`` (zeros); f32 buffers ``_mean_buf``
    (zeros) and ``_variance_buf`` (ones). In training it normalises with
    the batch statistics and moves the running ones in place, under
    ``no_grad``, on the module's own buffers (``copy_``), so they survive
    ``torch.func.functional_call``'s parameter binding in the AMP training
    step; in eval it normalises with the running ones. ``sync_stats=True``
    raises (ROADMAP A.9), and so does ``act``, which the reference's
    BatchNorm accepts and never applies."""

    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 dtype='float32', data_layout='NCHW', in_place=False,
                 moving_mean_name=None, moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False,
                 sync_stats=False, device=None):
        super().__init__()
        if sync_stats:
            raise NotImplementedError('BatchNorm(sync_stats=True) is not '
                                      'ported yet (ROADMAP A.9)')
        if act is not None:
            raise NotImplementedError('BatchNorm(act=...): the reference '
                                      'ignores it; apply the activation '
                                      'after the layer')
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))
        self.register_buffer('_mean_buf',
                             torch.zeros(num_channels, device=device))
        self.register_buffer('_variance_buf',
                             torch.ones(num_channels, device=device))
        self._attrs = dict(momentum=momentum, epsilon=epsilon,
                           data_layout=data_layout,
                           use_global_stats=use_global_stats)

    def forward(self, x):
        y, new_mean, new_var = batch_norm(
            x, self.weight, self.bias, self._mean_buf, self._variance_buf,
            is_test=not self.training, **self._attrs)
        if self.training:
            with torch.no_grad():
                self._mean_buf.copy_(new_mean)
                self._variance_buf.copy_(new_var)
        return y


class Linear(nn.Linear):
    """``nn.Linear`` with Paddle's fused activation (``'gelu'``, the exact
    erf form, ``'tanh'`` or ``'relu'``) and JAX's type promotion."""

    _ACTS = {'gelu': F.gelu, 'tanh': torch.tanh, 'relu': torch.relu}

    def __init__(self, in_features, out_features, act=None, device=None):
        super().__init__(in_features, out_features, device=device)
        if act is not None and act not in self._ACTS:
            raise NotImplementedError(f'act={act!r}: only gelu, tanh and '
                                      f'relu are ported')
        self.act = act

    def forward(self, x):
        y = F.linear(*_promote(x, self.weight, self.bias))
        return y if self.act is None else self._ACTS[self.act](y)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (epsilon 1e-5, as Paddle's) with JAX's type
    promotion."""

    def __init__(self, size, device=None):
        super().__init__(size, eps=1e-5, device=device)

    def forward(self, x):
        x, w, b = _promote(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


class Dropout(nn.Module):
    """Paddle's ``upscale_in_train`` dropout: in training, zero each entry
    with probability ``p`` and scale the rest by 1/(1-p); identity in eval
    and at p = 0. Masks come from ``generator`` when one is given."""

    def __init__(self, p, generator=None):
        super().__init__()
        self.p = float(p)
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            return F.dropout(x, self.p, training=True)
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return x * keep / (1.0 - self.p)
