"""MNIST LeNet (counterpart of paddle_tpu/models/lenet.py), the book
recipe's ``conv_net``: two conv-pool blocks of 20 and 50 5x5 filters, fc 500
with ReLU, fc 10. ``build_static_lenet`` builds it on the static graph;
``LeNet`` is the dygraph module on dygraph/nn.py's layers."""
from __future__ import annotations

from torch import nn

from .. import layers, nets
from ..device import resolve_device
from ..dygraph.nn import Conv2D, Linear, Pool2D

__all__ = ['build_static_lenet', 'LeNet']


def build_static_lenet(img, label):
    """``img``: a data var (N, 1, 28, 28); ``label``: (N, 1) int64.
    Returns (loss, acc, logits)."""
    conv1 = nets.simple_img_conv_pool(img, num_filters=20, filter_size=5,
                                      pool_size=2, pool_stride=2, act='relu')
    conv2 = nets.simple_img_conv_pool(conv1, num_filters=50, filter_size=5,
                                      pool_size=2, pool_stride=2, act='relu')
    fc = layers.fc(conv2, size=500, act='relu')
    logits = layers.fc(fc, size=10)
    loss = layers.reduce_mean(
        layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits


class LeNet(nn.Module):
    """Dygraph LeNet: (N, 1, 28, 28) -> (N, 10) logits, on the card
    unless ``device='cpu'``."""

    def __init__(self, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.conv1 = Conv2D(1, 20, 5, act='relu', device=device,
                            generator=generator)
        self.pool1 = Pool2D(2, 'max', 2)
        self.conv2 = Conv2D(20, 50, 5, act='relu', device=device,
                            generator=generator)
        self.pool2 = Pool2D(2, 'max', 2)
        self.fc1 = Linear(50 * 4 * 4, 500, act='relu', device=device)
        self.fc2 = Linear(500, 10, device=device)

    def forward(self, x):
        x = self.pool1(self.conv1(x))
        x = self.pool2(self.conv2(x))
        return self.fc2(self.fc1(x.reshape(x.shape[0], 50 * 4 * 4)))
