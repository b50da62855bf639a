"""MobileNet V1/V2, VGG, TSM and the DCGAN (counterpart of
paddle_tpu/models/vision.py): PaddleCV's image_classification MobileNet,
MobileNetV2 and VGG, the video TSM over a ResNet backbone, and the DCGAN
of the reference's GAN unittests, on the port's dygraph layers, NCHW.

Each model takes ``device`` (the card unless ``'cpu'`` is asked for; see
device.py) and ``seed`` (its parameters are drawn from a generator seeded
with it), as the port's ResNet does. Submodule names give exactly the JAX
models' ``named_parameters()`` and ``named_buffers()`` names
(``stem.conv.weight``, ``ds_0.dw.bn._mean_buf``, ``ir_3.b1.conv.weight``,
``conv_0.bn.weight``, ``backbone.blocks.0.conv0._conv.weight``,
``deconv1.weight``, ...) in the same shapes and layouts, so ``set_dict``
over the JAX model's ``state_dict()`` carries a model across.

Two differences from the JAX models, both the JAX package's (ROADMAP C.4):

- A ConvBN's activation (relu, or relu6 in MobileNetV2) and the DCGAN
  generator's relus are BatchNorm's ``act``, which the port's BatchNorm
  applies as Paddle 1.7's does and the JAX package's never reads (item
  11): the JAX MobileNets, the BN VGGs and the generator run without
  those activations.
- TSM shifts the input of each bottleneck block, as the JAX model does;
  ResNet-18 and -34 have none (the JAX TSM over them shifts nothing), so
  the port takes the bottleneck depths only (item 21).
"""
from __future__ import annotations

import contextlib

import torch

from ..core.random import default_generator
from ..device import resolve_device
from ..dygraph.layers import Layer
from ..dygraph.nn import (BatchNorm, Conv2D, Conv2DTranspose, Dropout, Linear,
                          Pool2D)
from ..ops.math_ops import leaky_relu
from ..ops.tensor_ops import temporal_shift
from .resnet import ResNet

__all__ = ['ConvBN', 'DepthwiseSeparable', 'MobileNetV1', 'InvertedResidual',
           'MobileNetV2', 'VGG', 'TSM', 'DCGenerator', 'DCDiscriminator']


@contextlib.contextmanager
def _seeded(device, seed):
    """Parameters made inside are drawn from a generator on ``device``
    seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    with default_generator.drawing_from(gen):
        yield


class ConvBN(Layer):
    """A bias-free Conv2D ('same' padding for odd kernels unless
    ``padding`` is given), then BatchNorm with ``act``."""

    def __init__(self, cin, cout, k, stride=1, padding=None, groups=1,
                 act='relu', *, device=None):
        super().__init__(device=device)
        self.conv = Conv2D(cin, cout, k, stride=stride,
                           padding=(k - 1) // 2 if padding is None
                           else padding, groups=groups, bias_attr=False,
                           device=device)
        self.bn = BatchNorm(cout, act=act, device=device)

    def forward(self, x):
        return self.bn(self.conv(x))


class DepthwiseSeparable(Layer):
    """MobileNet's block: a 3x3 depthwise ConvBN, then a 1x1 one, each
    with relu, channels scaled by ``scale``."""

    def __init__(self, cin, cout, stride, scale=1.0, *, device=None):
        super().__init__(device=device)
        cin, cout = int(cin * scale), int(cout * scale)
        self.dw = ConvBN(cin, cin, 3, stride=stride, groups=cin,
                         device=device)
        self.pw = ConvBN(cin, cout, 1, device=device)

    def forward(self, x):
        return self.pw(self.dw(x))


def _flat(x):
    return x.reshape(x.shape[0], -1)


class MobileNetV1(Layer):
    """PaddleCV's MobileNet (V1): a stride-2 stem, 13 depthwise separable
    blocks, global average pooling and the classifier."""

    def __init__(self, num_classes=1000, scale=1.0, *, device=None, seed=0):
        device = resolve_device(device)
        super().__init__(device=device)
        s = lambda c: int(c * scale)    # noqa: E731
        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
              [(512, 1024, 2), (1024, 1024, 1)]
        with _seeded(device, seed):
            self.stem = ConvBN(3, s(32), 3, stride=2, device=device)
            self.blocks = []
            for i, (cin, cout, st) in enumerate(cfg):
                self.blocks.append(self.add_sublayer(
                    f'ds_{i}', DepthwiseSeparable(cin, cout, st, scale,
                                                  device=device)))
            self.pool = Pool2D(pool_type='avg', global_pooling=True)
            self.fc = Linear(s(1024), num_classes, device=device)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(_flat(self.pool(x)))


class InvertedResidual(Layer):
    """MobileNetV2's block: a 1x1 expansion (unless ``expand`` is 1), a 3x3
    depthwise ConvBN, both relu6, and a linear 1x1 projection; the input
    is added back where the shapes allow."""

    def __init__(self, cin, cout, stride, expand, *, device=None):
        super().__init__(device=device)
        hidden = int(round(cin * expand))
        self.use_res = stride == 1 and cin == cout
        layers = []
        if expand != 1:
            layers.append(ConvBN(cin, hidden, 1, act='relu6', device=device))
        layers.append(ConvBN(hidden, hidden, 3, stride=stride, groups=hidden,
                             act='relu6', device=device))
        layers.append(ConvBN(hidden, cout, 1, act=None, device=device))
        self.body = [self.add_sublayer(f'b{i}', layer)
                     for i, layer in enumerate(layers)]

    def forward(self, x):
        y = x
        for layer in self.body:
            y = layer(y)
        return x + y if self.use_res else y


class MobileNetV2(Layer):
    """PaddleCV's MobileNetV2: a relu6 stem, 17 inverted residual blocks,
    a 1x1 head of 1280 channels (more for a scale above 1), global average
    pooling and the classifier."""

    def __init__(self, num_classes=1000, scale=1.0, *, device=None, seed=0):
        device = resolve_device(device)
        super().__init__(device=device)
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        cin = int(32 * scale)
        with _seeded(device, seed):
            self.stem = ConvBN(3, cin, 3, stride=2, act='relu6',
                               device=device)
            self.blocks = []
            for expand, c, n, st in cfg:
                cout = int(c * scale)
                for j in range(n):
                    self.blocks.append(self.add_sublayer(
                        f'ir_{len(self.blocks)}',
                        InvertedResidual(cin, cout, st if j == 0 else 1,
                                         expand, device=device)))
                    cin = cout
            clast = int(1280 * max(1.0, scale))
            self.head = ConvBN(cin, clast, 1, act='relu6', device=device)
            self.pool = Pool2D(pool_type='avg', global_pooling=True)
            self.fc = Linear(clast, num_classes, device=device)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(_flat(self.pool(self.head(x))))


_VGG_CFGS = {
    11: [1, 1, 2, 2, 2], 13: [2, 2, 2, 2, 2],
    16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4],
}


class VGG(Layer):
    """PaddleCV's VGG-11/13/16/19: five stages of 3x3 convolutions (ConvBN
    with ``use_bn``, else Conv2D with relu) each closed by a 2x2 max pool,
    then two ``fc_dim`` relu layers with dropout 0.5 and the
    classifier."""

    def __init__(self, layers=16, num_classes=1000, use_bn=True,
                 image_channels=3, fc_dim=4096, input_size=224, *,
                 device=None, seed=0):
        device = resolve_device(device)
        super().__init__(device=device)
        with _seeded(device, seed):
            self.features = []
            cin, idx = image_channels, 0
            for n, cout in zip(_VGG_CFGS[layers], [64, 128, 256, 512, 512]):
                for _ in range(n):
                    conv = (ConvBN(cin, cout, 3, device=device) if use_bn
                            else Conv2D(cin, cout, 3, padding=1, act='relu',
                                        device=device))
                    self.features.append(self.add_sublayer(f'conv_{idx}',
                                                           conv))
                    cin = cout
                    idx += 1
                self.features.append(self.add_sublayer(
                    f'pool_{idx}', Pool2D(2, pool_type='max', pool_stride=2)))
            spatial = input_size // 32
            self.fc1 = Linear(512 * spatial * spatial, fc_dim, act='relu',
                              device=device)
            self.fc2 = Linear(fc_dim, fc_dim, act='relu', device=device)
            self.fc3 = Linear(fc_dim, num_classes, device=device)
            self.drop = Dropout(0.5)

    def forward(self, x):
        for f in self.features:
            x = f(x)
        x = self.drop(self.fc1(_flat(x)))
        x = self.drop(self.fc2(x))
        return self.fc3(x)


class TSM(Layer):
    """TSM over a ResNet backbone: input (N * seg_num, C, H, W), each
    bottleneck block's input shifted in time (``temporal_shift``, a
    quarter of the channels each way) by a forward pre-hook, so the
    parameter names stay the backbone's; the frames' logits are averaged
    a clip, (N, num_classes). ``backbone_layers`` 50, 101 or 152 (ROADMAP
    C.4 item 21: the JAX TSM over ResNet-18/34 shifts nothing)."""

    def __init__(self, num_classes=400, seg_num=8, backbone_layers=50, *,
                 device=None, seed=0):
        if backbone_layers in (18, 34):
            raise NotImplementedError(
                f'TSM(backbone_layers={backbone_layers}): the reference '
                f'shifts the inputs of bottleneck blocks, which ResNet-'
                f'{backbone_layers} does not have, so its TSM shifts nothing; '
                f'only 50, 101 and 152 are ported (ROADMAP C.4 item 21)')
        device = resolve_device(device)
        super().__init__(device=device)
        self.seg_num = seg_num
        self.backbone = ResNet(backbone_layers, class_dim=num_classes,
                               device=device, seed=seed)

        def shift(layer, inputs):
            return (temporal_shift(inputs[0], seg_num=seg_num,
                                   shift_ratio=0.25),) + tuple(inputs[1:])

        for block in self.backbone.blocks:
            block.register_forward_pre_hook(shift)

    def forward(self, x):
        logits = self.backbone(x)
        return logits.reshape(logits.shape[0] // self.seg_num, self.seg_num,
                              -1).mean(1)


class DCGenerator(Layer):
    """The DCGAN generator: z (B, z_dim) through a Linear to (B, 4 base, 4,
    4), two stride-2 Conv2DTransposes each with BatchNorm and relu, and a
    third with tanh: (B, out_channels, 32, 32)."""

    def __init__(self, z_dim=100, base=64, out_channels=1, *, device=None,
                 seed=0):
        device = resolve_device(device)
        super().__init__(device=device)
        self.base = base
        with _seeded(device, seed):
            self.fc = Linear(z_dim, base * 4 * 4 * 4, device=device)
            self.deconv1 = Conv2DTranspose(base * 4, base * 2, 4, stride=2,
                                           padding=1, device=device)
            self.bn1 = BatchNorm(base * 2, act='relu', device=device)
            self.deconv2 = Conv2DTranspose(base * 2, base, 4, stride=2,
                                           padding=1, device=device)
            self.bn2 = BatchNorm(base, act='relu', device=device)
            self.deconv3 = Conv2DTranspose(base, out_channels, 4, stride=2,
                                           padding=1, device=device)

    def forward(self, z):
        x = self.fc(z).reshape(z.shape[0], self.base * 4, 4, 4)
        x = self.bn1(self.deconv1(x))
        x = self.bn2(self.deconv2(x))
        return torch.tanh(self.deconv3(x))


class DCDiscriminator(Layer):
    """The DCGAN discriminator: three stride-2 4x4 Conv2Ds (the last two
    with BatchNorm), each followed by leaky_relu(0.2), and a Linear to one
    logit: (B, in_channels, 32, 32) -> (B, 1)."""

    def __init__(self, base=64, in_channels=1, *, device=None, seed=0):
        device = resolve_device(device)
        super().__init__(device=device)
        with _seeded(device, seed):
            self.conv1 = Conv2D(in_channels, base, 4, stride=2, padding=1,
                                device=device)
            self.conv2 = Conv2D(base, base * 2, 4, stride=2, padding=1,
                                device=device)
            self.bn2 = BatchNorm(base * 2, device=device)
            self.conv3 = Conv2D(base * 2, base * 4, 4, stride=2, padding=1,
                                device=device)
            self.bn3 = BatchNorm(base * 4, device=device)
            self.fc = Linear(base * 4 * 4 * 4, 1, device=device)

    def forward(self, x):
        x = leaky_relu(self.conv1(x), alpha=0.2)
        x = leaky_relu(self.bn2(self.conv2(x)), alpha=0.2)
        x = leaky_relu(self.bn3(self.conv3(x)), alpha=0.2)
        return self.fc(_flat(x))
