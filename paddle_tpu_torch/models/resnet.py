"""ResNet-18/34/50/101/152 (counterpart of paddle_tpu/models/resnet.py), the
repo's flagship vision training workload (``bench.py:bench_resnet``).

Submodule names give exactly the JAX model's ``named_parameters()`` and
``named_buffers()`` names (``conv._conv.weight``, ``blocks.0.conv0._bn.bias``,
``blocks.3.short._conv.weight``, ``conv._bn._mean_buf``, ``out.weight``,
...); convert.py maps the reference's weights onto them.

``data_format='NHWC'`` takes (B, H, W, C) input, as the JAX model does, and
runs every layer on NHWC tensors whose NCHW views are ``channels_last``,
with the conv weights stored ``channels_last``: torch's convolutions then
run NHWC kernels end to end, with no layout transposes. The blocks are
dygraph Layers, as the reference's are, so ``state_dict``/``set_dict`` and
``save_dygraph``/``load_dygraph`` carry the reference's checkpoints (an
NHWC conv weight in Paddle's HWIO), while ``load_state_dict`` takes
convert.py's torch state dicts (OIHW). ``'NCHW'`` is
plain NCHW. ``stem_space_to_depth=True`` runs the NHWC stem through
ops/pallas_conv.py:stem_space_to_depth on the same 7x7 weight.

As in the reference, the model never calls the fused 1x1 conv + BN + act
op (K4): its ConvBNLayer runs conv, BatchNorm and the activation as three
ops, in training and in eval.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from ..dygraph.layers import Layer
from ..dygraph.nn import BatchNorm, Conv2D, Linear, Pool2D
from ..initializer import Uniform
from ..core.random import default_generator
from ..ops.nn_ops import relu
from ..ops.pallas_conv import stem_space_to_depth

__all__ = ['ConvBNLayer', 'BottleneckBlock', 'BasicBlock', 'ResNet',
           'ResNet18', 'ResNet34', 'ResNet50', 'ResNet101', 'ResNet152']


class ConvBNLayer(Layer):
    """conv (no bias, 'same' padding for odd kernels) -> BatchNorm -> act
    (None or ``'relu'``)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 groups=1, act=None, data_format='NCHW',
                 space_to_depth=False, device=None):
        super().__init__()
        if act not in (None, 'relu'):
            raise NotImplementedError(f'act={act!r}: only relu is ported')
        if space_to_depth and (filter_size != 7 or stride != 2
                               or data_format != 'NHWC'):
            raise ValueError('space_to_depth stem requires the 7x7/s2 '
                             'NHWC stem conv')
        self._conv = Conv2D(num_channels, num_filters, filter_size,
                            stride=stride, padding=(filter_size - 1) // 2,
                            groups=groups, bias_attr=False,
                            data_format=data_format, device=device)
        self._bn = BatchNorm(num_filters, data_layout=data_format,
                             device=device)
        self._act = act
        self._s2d = space_to_depth

    def forward(self, x):
        if self._s2d:
            y = stem_space_to_depth(x, self._conv.weight)
        else:
            y = self._conv(x)
        y = self._bn(y)
        return relu(y) if self._act == 'relu' else y


class BottleneckBlock(Layer):
    def __init__(self, num_channels, num_filters, stride, shortcut=True,
                 data_format='NCHW', device=None):
        super().__init__()
        kw = {'data_format': data_format, 'device': device}
        self.conv0 = ConvBNLayer(num_channels, num_filters, 1, act='relu',
                                 **kw)
        self.conv1 = ConvBNLayer(num_filters, num_filters, 3, stride=stride,
                                 act='relu', **kw)
        self.conv2 = ConvBNLayer(num_filters, num_filters * 4, 1, act=None,
                                 **kw)
        if not shortcut:
            self.short = ConvBNLayer(num_channels, num_filters * 4, 1,
                                     stride=stride, act=None, **kw)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.conv2(self.conv1(self.conv0(x)))
        short = x if self.shortcut else self.short(x)
        return relu(short + y)


class BasicBlock(Layer):
    def __init__(self, num_channels, num_filters, stride, shortcut=True,
                 data_format='NCHW', device=None):
        super().__init__()
        kw = {'data_format': data_format, 'device': device}
        self.conv0 = ConvBNLayer(num_channels, num_filters, 3, stride=stride,
                                 act='relu', **kw)
        self.conv1 = ConvBNLayer(num_filters, num_filters, 3, act=None, **kw)
        if not shortcut:
            self.short = ConvBNLayer(num_channels, num_filters, 1,
                                     stride=stride, act=None, **kw)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.conv1(self.conv0(x))
        short = x if self.shortcut else self.short(x)
        return relu(short + y)


# depth -> (blocks per stage, block class, expansion)
_DEPTH_CFG = {
    18: ([2, 2, 2, 2], BasicBlock, 1),
    34: ([3, 4, 6, 3], BasicBlock, 1),
    50: ([3, 4, 6, 3], BottleneckBlock, 4),
    101: ([3, 4, 23, 3], BottleneckBlock, 4),
    152: ([3, 8, 36, 3], BottleneckBlock, 4),
}


class ResNet(Layer):
    """``ResNet(layers_depth=50, class_dim=1000, data_format='NCHW',
    stem_space_to_depth=False, device=None, seed=0)``: parameters live on
    ``device`` (the card unless ``'cpu'`` is asked for; see device.py),
    conv weights drawn with a generator seeded from ``seed``, the
    classifier's weight uniform in +-1/sqrt(features) as the reference's;
    load real ones with ``load_state_dict(convert.resnet_state_dict_from_paddle(...))``.
    """

    def __init__(self, layers_depth=50, class_dim=1000, data_format='NCHW',
                 stem_space_to_depth=False, device=None, seed=0):
        super().__init__()
        if layers_depth not in _DEPTH_CFG:
            raise ValueError(f'layers_depth must be one of '
                             f'{sorted(_DEPTH_CFG)}, got {layers_depth}')
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        # parameters drawn from the model's own generator, not the pool
        with default_generator.drawing_from(gen):
            depth, block_cls, expansion = _DEPTH_CFG[layers_depth]
            num_filters = [64, 128, 256, 512]
            kw = {'data_format': data_format, 'device': device}
            self.conv = ConvBNLayer(3, 64, 7, stride=2, act='relu',
                                    space_to_depth=stem_space_to_depth, **kw)
            self.pool = Pool2D(3, 'max', 2, 1, data_format=data_format)
            self.blocks = nn.ModuleList()
            num_channels = 64
            for i, n in enumerate(depth):
                for b in range(n):
                    stride = 2 if b == 0 and i != 0 else 1
                    self.blocks.append(block_cls(num_channels, num_filters[i],
                                                 stride, b != 0, **kw))
                    num_channels = num_filters[i] * expansion
            self.global_pool = Pool2D(pool_type='avg', global_pooling=True,
                                      data_format=data_format)
            stdv = 1.0 / math.sqrt(num_channels)
            self.out = Linear(num_channels, class_dim,
                              param_attr=Uniform(-stdv, stdv), device=device)
            self._feat_dim = num_channels

    def forward(self, x):
        y = self.pool(self.conv(x))
        for blk in self.blocks:
            y = blk(y)
        y = self.global_pool(y)
        return self.out(y.reshape(y.shape[0], self._feat_dim))


def ResNet50(class_dim=1000, data_format='NCHW', stem_space_to_depth=False,
             device=None, seed=0):
    return ResNet(50, class_dim, data_format=data_format,
                  stem_space_to_depth=stem_space_to_depth, device=device,
                  seed=seed)


def ResNet18(class_dim=1000, device=None, seed=0):
    return ResNet(18, class_dim, device=device, seed=seed)


def ResNet34(class_dim=1000, device=None, seed=0):
    return ResNet(34, class_dim, device=device, seed=seed)


def ResNet101(class_dim=1000, device=None, seed=0):
    return ResNet(101, class_dim, device=device, seed=seed)


def ResNet152(class_dim=1000, device=None, seed=0):
    return ResNet(152, class_dim, device=device, seed=seed)
