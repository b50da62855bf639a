"""Dygraph layers of the port (counterpart of paddle_tpu/dygraph/nn.py):
``Conv2D``, ``Pool2D``, ``BatchNorm``, ``Linear``, ``Embedding``,
``LayerNorm`` and ``Dropout``, as Layers over the registered ops of
ops/nn_ops.py, with the reference's parameters (plus a keyword-only
``device``; see dygraph/layers.py for where parameters live otherwise).

Parameters come from ``Layer.create_parameter`` with the reference's
initializers and names; ``param_attr`` / ``bias_attr`` work as there.
``Linear.weight`` has Paddle's (in, out) shape, so state dicts and
checkpoints need no transposes. Conv weights are OIHW whatever
``data_format`` (torch's layout); the reference keeps HWIO for NHWC, so an
NHWC Conv2D's ``state_dict`` gives its weight as an HWIO view and
``set_dict`` copies through that view (dygraph/layers.py), and checkpoints
carry across both ways (convert.py's torch state dicts stay OIHW). An
NHWC conv takes and returns (B, H, W, C) tensors, as the reference's does;
it stores its weight in ``torch.channels_last``, and its ops run torch's
kernels on the channels_last NCHW view of the activation, so nothing is
transposed or copied on the way.

Types follow the reference: convolutions cast the activation to the
weight's type (``_match_weight_dtype``), BatchNorm computes in the
activation's type from f32 statistics, and ``Linear``/``LayerNorm`` promote
as JAX does (bf16 with f32 gives f32).

The rest of the reference's layers run too: Conv3D, Conv2DTranspose,
Conv3DTranspose, GroupNorm, SpectralNorm, PRelu, BilinearTensorProduct,
GRUUnit, NCE and TreeConv, over the ops of ops/nn_ops.py, ops/extra_ops.py
and ops/math_ops.py, with the JAX layers' parameters, shapes, initializers
and names (a transposed conv's weight keeps Paddle's (C_in, C_out /
groups, ...) shape, torch's own transposed layout).

Every layer's ``act`` names a registered op, as in the JAX package, so any
activation of ops/math_ops.py works; one that names no op raises the JAX
package's ``KeyError`` when the layer runs. BatchNorm applies its ``act``,
as Paddle 1.7's does; the JAX package's BatchNorm never reads it (ROADMAP
C.4 item 11). Where the JAX layer takes an argument and ignores it, the
port raises on any value but the default, naming its C.4 item:
Conv2DTranspose's ``output_size`` (item 12), GRUUnit's activations (item
13), NCE's sampler, distribution, sample weights, seed and ``is_sparse``
(item 14); GroupNorm's NHWC raises (item 17). TreeConv computes what the
JAX layer computes, reading neither ``edge_set`` nor its bias (item 15).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..initializer import ConstantInitializer, NormalInitializer
from ..ops.extra_ops import (check_nce_defaults, gru_unit, nce,
                              spectral_norm, tree_conv)
from ..ops.math_ops import prelu
from ..ops.nn_ops import (batch_norm, bilinear_tensor_product, conv2d,
                          conv2d_transpose, conv3d, conv3d_transpose,
                          dropout, group_norm, layer_norm, lookup_table,
                          pool2d)
from ..ops.registry import find_op
from .layers import Layer

__all__ = ['Conv2D', 'Pool2D', 'BatchNorm', 'Linear', 'Embedding',
           'LayerNorm', 'Dropout', 'Conv3D', 'Conv2DTranspose',
           'Conv3DTranspose', 'GroupNorm', 'SpectralNorm', 'PRelu',
           'BilinearTensorProduct', 'GRUUnit', 'NCE', 'TreeConv']


def _activation(act, x):
    """``x`` through the registered op ``act`` (none for a false
    ``act``); a name that is no op raises the JAX package's KeyError."""
    if not act:
        return x
    op = find_op(act)
    if op is None:
        raise KeyError(f'unknown op type {act!r}')
    return op.fn(x)


def _triple(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 3


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
    ``bias_attr=False``, then ``act`` (any registered activation)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None, dtype='float32',
                 data_format='NCHW', *, device=None):
        super().__init__(dtype=dtype, device=device)
        if data_format not in ('NCHW', 'NHWC'):
            raise ValueError(f'data_format must be NCHW or NHWC, got '
                             f'{data_format!r}')
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

    def _paddle_layouts(self):
        nhwc = self._attrs['data_format'] == 'NHWC'
        return {'weight': (2, 3, 1, 0) if nhwc else None}

    def forward(self, x):
        out = conv2d(x, self.weight, **self._attrs)
        if self.bias is not None:
            shape = ((1, -1, 1, 1) if self._attrs['data_format'] == 'NCHW'
                     else (-1,))
            out = out + self.bias.reshape(shape)
        return _activation(self._act, out)


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
    the running ones, then applies ``act`` (any registered activation), as
    Paddle 1.7's BatchNorm does; the JAX package's never reads ``act``
    (ROADMAP C.4 item 11). ``sync_stats=True`` raises (ROADMAP A.9)."""

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
        self._act = act

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
        return _activation(self._act, y)


class Linear(Layer):
    """Paddle's Linear: ``act(x @ weight + bias)`` with ``weight`` (in, out)
    (Xavier) and ``bias`` (out,) (zeros, none for ``bias_attr=False``);
    ``act`` any registered activation (``'gelu'`` the exact erf form).
    Types promote as in JAX.

    The weight has Paddle's shape over ``nn.Linear``'s memory: it is the
    transpose of a contiguous (out, in) tensor, so the product is the one
    GEMM ``F.linear`` runs, bias in its epilogue, and its gradient lands
    in the same layout with no copy."""

    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype='float32', *, device=None):
        super().__init__(dtype=dtype, device=device)
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
        return _activation(self._act, F.linear(x, w.t(), b))


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
        return _activation(self._act, out)


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


class Conv3D(Layer):
    """Paddle's Conv3D over the ``conv3d`` op: weight (O, C/groups, fd, fh,
    fw) (Xavier, the JAX layer's default), a zero bias unless
    ``bias_attr=False``, then ``act``; NCDHW."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype='float32', *, device=None):
        super().__init__(dtype=dtype, device=device)
        self.weight = self.create_parameter(
            [num_filters, num_channels // groups, *_triple(filter_size)],
            param_attr, dtype)
        self.bias = self.create_parameter([num_filters], bias_attr, dtype,
                                          is_bias=True)
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation,
                           groups=groups)
        self._act = act

    def forward(self, x):
        out = conv3d(x, self.weight, **self._attrs)
        if self.bias is not None:
            out = out + self.bias.reshape(1, -1, 1, 1, 1)
        return _activation(self._act, out)


class Conv2DTranspose(Layer):
    """Paddle's Conv2DTranspose over the ``conv2d_transpose`` op: weight
    (C_in, O/groups, fh, fw) (Paddle's shape, torch's transposed layout;
    Xavier), a zero bias unless ``bias_attr=False``, then ``act``; NCHW.
    An ``output_size`` other than the size the layer computes raises when
    it runs (the JAX layer never reads it; ROADMAP C.4 item 12)."""

    def __init__(self, num_channels, num_filters, filter_size,
                 output_size=None, padding=0, stride=1, dilation=1, groups=1,
                 param_attr=None, bias_attr=None, use_cudnn=True, act=None,
                 dtype='float32', *, device=None):
        super().__init__(dtype=dtype, device=device)
        fs = filter_size if isinstance(filter_size, (list, tuple)) \
            else (filter_size, filter_size)
        self.weight = self.create_parameter(
            [num_channels, num_filters // groups, fs[0], fs[1]], param_attr,
            dtype)
        self.bias = self.create_parameter([num_filters], bias_attr, dtype,
                                          is_bias=True)
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation,
                           groups=groups, output_size=output_size)
        self._act = act

    def forward(self, x):
        out = conv2d_transpose(x, self.weight, **self._attrs)
        if self.bias is not None:
            out = out + self.bias.reshape(1, -1, 1, 1)
        return _activation(self._act, out)


class Conv3DTranspose(Layer):
    """Paddle's Conv3DTranspose over the ``conv3d_transpose`` op: weight
    (C_in, O/groups, fd, fh, fw) (Xavier), a zero bias unless
    ``bias_attr=False``, then ``act``; NCDHW. ``groups`` > 1 computes
    Paddle's grouped transposed convolution, where the JAX layer raises
    (ROADMAP C.4 item 19)."""

    def __init__(self, num_channels, num_filters, filter_size, padding=0,
                 stride=1, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype='float32', *, device=None):
        super().__init__(dtype=dtype, device=device)
        self.weight = self.create_parameter(
            [num_channels, num_filters // groups, *_triple(filter_size)],
            param_attr, dtype)
        self.bias = self.create_parameter([num_filters], bias_attr, dtype,
                                          is_bias=True)
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation,
                           groups=groups)
        self._act = act

    def forward(self, x):
        out = conv3d_transpose(x, self.weight, **self._attrs)
        if self.bias is not None:
            out = out + self.bias.reshape(1, -1, 1, 1, 1)
        return _activation(self._act, out)


class GroupNorm(Layer):
    """Paddle's GroupNorm over the ``group_norm`` op: scale (ones) and bias
    (zeros) a channel, then ``act``. NCHW only: the JAX layer groups an
    NHWC input as if it were NCHW, so ``data_layout='NHWC'`` raises
    (ROADMAP C.4 item 17)."""

    def __init__(self, channels, groups, epsilon=1e-5, param_attr=None,
                 bias_attr=None, act=None, data_layout='NCHW',
                 dtype='float32', *, device=None):
        super().__init__(dtype=dtype, device=device)
        if data_layout != 'NCHW':
            raise NotImplementedError(
                f'GroupNorm(data_layout={data_layout!r}): the reference '
                f'groups an NHWC input as if it were NCHW; only NCHW is '
                f'ported (ROADMAP C.4 item 17)')
        self.weight = self.create_parameter(
            [channels], param_attr, dtype,
            default_initializer=ConstantInitializer(1.0))
        self.bias = self.create_parameter([channels], bias_attr, dtype,
                                          is_bias=True)
        self._attrs = dict(groups=groups, epsilon=epsilon)
        self._act = act

    def forward(self, x):
        return _activation(self._act, group_norm(x, self.weight, self.bias,
                                                 **self._attrs))


class SpectralNorm(Layer):
    """Paddle's SpectralNorm over the ``spectral_norm`` op: ``forward(w)``
    returns ``w`` (the layer's own Xavier ``weight`` of ``weight_shape``
    when none is given) over its largest singular value. The power
    iteration starts from ones on every call, as the JAX layer's does
    (ROADMAP C.4 item 16)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype='float32', *, device=None):
        super().__init__(dtype=dtype, device=device)
        self.weight = self.create_parameter(list(weight_shape), None, dtype)
        self._attrs = dict(dim=dim, power_iters=power_iters, eps=eps)

    def forward(self, weight=None):
        w = weight if weight is not None else self.weight
        return spectral_norm(w, **self._attrs)


class PRelu(Layer):
    """Paddle's PRelu over the ``prelu`` op: its ``weight`` (0.25) is one
    value (``'all'``), one a channel (``'channel'``) or one an element of
    a sample, flat (``'element'``, prod(input_shape[1:]) values, read as
    ``input_shape[1:]``; the JAX layer raises there on an input of more
    than two dims, ROADMAP C.4 item 20)."""

    def __init__(self, mode, channel=None, input_shape=None, param_attr=None,
                 dtype='float32', *, device=None):
        super().__init__(dtype=dtype, device=device)
        if mode == 'all':
            shape = [1]
        elif mode == 'channel':
            shape = [channel]
        else:
            shape = [math.prod(input_shape[1:])]
        self.weight = self.create_parameter(
            shape, param_attr, dtype,
            default_initializer=ConstantInitializer(0.25))
        self._mode = mode

    def forward(self, x):
        return prelu(x, self.weight, mode=self._mode)


class BilinearTensorProduct(Layer):
    """Paddle's BilinearTensorProduct: ``act(x[b]ᵀ W[k] y[b] + bias[k])``
    with ``weight`` (output_dim, input1_dim, input2_dim) (Xavier) and a
    zero ``bias`` (output_dim,)."""

    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 act=None, param_attr=None, bias_attr=None, dtype='float32',
                 *, device=None):
        super().__init__(dtype=dtype, device=device)
        self.weight = self.create_parameter(
            [output_dim, input1_dim, input2_dim], param_attr, dtype)
        self.bias = self.create_parameter([output_dim], bias_attr, dtype,
                                          is_bias=True)
        self._act = act

    def forward(self, x, y):
        return _activation(self._act, bilinear_tensor_product(
            x, y, self.weight, self.bias))


class GRUUnit(Layer):
    """Paddle's GRUUnit over the ``gru_unit`` op: ``size`` is 3 D,
    ``weight`` (D, 3D) (Xavier) and ``bias`` (1, 3D) (zeros);
    ``forward(input, hidden)`` returns (hidden, reset hidden, gate). The
    gates are sigmoid and the candidate tanh: the JAX layer never reads
    ``activation`` or ``gate_activation``, so others raise (ROADMAP C.4
    item 13)."""

    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation='tanh', gate_activation='sigmoid',
                 origin_mode=False, dtype='float32', *, device=None):
        super().__init__(dtype=dtype, device=device)
        if activation != 'tanh' or gate_activation != 'sigmoid':
            raise NotImplementedError(
                f'GRUUnit(activation={activation!r}, gate_activation='
                f'{gate_activation!r}): the reference computes tanh and '
                f'sigmoid whatever it is given; no other is ported (ROADMAP '
                f'C.4 item 13)')
        d = size // 3
        self.weight = self.create_parameter([d, d * 3], param_attr, dtype)
        self.bias = self.create_parameter([1, d * 3], bias_attr, dtype,
                                          is_bias=True)
        self._origin_mode = origin_mode

    def forward(self, inputs, hidden):
        return gru_unit(inputs, hidden, self.weight, self.bias,
                        origin_mode=self._origin_mode)


class NCE(Layer):
    """Paddle's NCE over the ``nce`` op: ``weight`` (classes, dim) (Xavier)
    and ``bias`` (classes,) (zeros); ``forward(input, label)`` gives the
    (B, 1) loss over ``num_neg_samples`` uniform negatives, one set for
    the batch, drawn from the device's generator. The JAX layer never
    reads ``sampler``, ``custom_dist``, ``sample_weight``, ``seed`` or
    ``is_sparse``, so any value but the default raises (ROADMAP C.4 item
    14)."""

    def __init__(self, num_total_classes, dim, sample_weight=None,
                 param_attr=None, bias_attr=None, num_neg_samples=10,
                 sampler='uniform', custom_dist=None, seed=0,
                 is_sparse=False, dtype='float32', *, device=None):
        super().__init__(dtype=dtype, device=device)
        check_nce_defaults(sample_weight=sample_weight, sampler=sampler,
                           custom_dist=custom_dist, seed=seed,
                           is_sparse=is_sparse)
        self.weight = self.create_parameter([num_total_classes, dim],
                                            param_attr, dtype)
        self.bias = self.create_parameter([num_total_classes], bias_attr,
                                          dtype, is_bias=True)
        self._attrs = dict(num_total_classes=num_total_classes,
                           num_neg_samples=num_neg_samples)

    def forward(self, input, label, sample_weight=None):
        check_nce_defaults(sample_weight=sample_weight)
        from ..core.random import default_generator
        return nce(input, label, self.weight, self.bias, **self._attrs,
                   key=default_generator.generator(input.device))


class TreeConv(Layer):
    """Paddle's TreeConv over the ``tree_conv`` op: ``weight`` (feature_size,
    3, output_size, num_filters) (Xavier), then ``act`` (tanh). As in the
    JAX layer, ``forward(nodes_vector, edge_set)`` reads neither
    ``edge_set`` nor the layer's ``bias`` (num_filters, output_size),
    which it creates (ROADMAP C.4 item 15)."""

    def __init__(self, feature_size, output_size, num_filters=1,
                 max_depth=8, act='tanh', param_attr=None, bias_attr=None,
                 name=None, dtype='float32', *, device=None):
        super().__init__(dtype=dtype, device=device)
        self.weight = self.create_parameter(
            [feature_size, 3, output_size, num_filters], param_attr, dtype)
        self.bias = self.create_parameter([num_filters, output_size],
                                          bias_attr, dtype, is_bias=True)
        self._max_depth = max_depth
        self._act = act

    def forward(self, nodes_vector, edge_set):
        return _activation(self._act, tree_conv(
            nodes_vector, edge_set, self.weight, max_depth=self._max_depth))
