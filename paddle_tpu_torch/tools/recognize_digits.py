"""PaddleBook's recognize_digits (chapter 2, the convolutional model), as
its ``train.py`` writes it against Fluid 1.7's high-level API.

The functions take the ``fluid`` module they build with and import neither
package, so the same code runs in ``paddle_tpu_torch`` and in the JAX
package ``paddle_tpu``::

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.tools import recognize_digits as book
    trainer = fluid.contrib.Trainer(
        train_func=lambda: book.train_program(fluid),
        optimizer_func=lambda: book.optimizer_func(fluid),
        place=fluid.CUDAPlace(0))
    trainer.train(num_epochs=1, event_handler=handler,
                  reader=book.mnist_reader(0, 200),
                  feed_order=book.FEED_ORDER)
    inferencer = fluid.contrib.Inferencer(
        infer_func=lambda: book.inference_program(fluid),
        param_path=params_dir, place=fluid.CUDAPlace(0))

The net is ``models/lenet.py``'s ``build_static_lenet``, op for op: two
``simple_img_conv_pool`` blocks of 20 and 50 5x5 filters with 2x2 max
pools and relu, ``fc(500, relu)``, ``fc(10)``, softmax cross entropy, its
mean and ``accuracy`` on the softmax; Adam at 1e-3, batches of 64.
``inference_program`` builds the same layers up to the softmax under a
fresh name counter, so its parameters take the training program's names
when that was built under one too (``train_program`` uses one).

MNIST itself is not in the repository: :func:`mnist_reader` yields
seeded synthetic digits in ``paddle.dataset.mnist``'s row format (784
float32 pixels in [-1, 1] and an int label), each a class template plus
noise, so that a model can learn them."""
from __future__ import annotations

import numpy as np

__all__ = ['IMAGE_SHAPE', 'BATCH', 'LEARNING_RATE', 'FEED_ORDER',
           'TEMPLATE_SEED', 'conv_net', 'train_program', 'inference_program',
           'optimizer_func', 'mnist_reader']

IMAGE_SHAPE = [1, 28, 28]
BATCH = 64
LEARNING_RATE = 1e-3
FEED_ORDER = ['img', 'label']


def conv_net(fluid, img):
    """The logits (N, 10) of ``build_static_lenet``'s net."""
    conv1 = fluid.nets.simple_img_conv_pool(
        img, num_filters=20, filter_size=5, pool_size=2, pool_stride=2,
        act='relu')
    conv2 = fluid.nets.simple_img_conv_pool(
        conv1, num_filters=50, filter_size=5, pool_size=2, pool_stride=2,
        act='relu')
    fc = fluid.layers.fc(conv2, size=500, act='relu')
    return fluid.layers.fc(fc, size=10)


def train_program(fluid):
    """``train_func``: [mean loss, accuracy], built under a fresh name
    counter."""
    with fluid.unique_name.guard():
        img = fluid.layers.data('img', IMAGE_SHAPE, dtype='float32')
        label = fluid.layers.data('label', [1], dtype='int64')
        logits = conv_net(fluid, img)
        loss = fluid.layers.reduce_mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
    return [loss, acc]


def inference_program(fluid):
    """``infer_func``: the softmax over the 10 classes."""
    with fluid.unique_name.guard():
        img = fluid.layers.data('img', IMAGE_SHAPE, dtype='float32')
        return fluid.layers.softmax(conv_net(fluid, img))


def optimizer_func(fluid):
    return fluid.optimizer.Adam(learning_rate=LEARNING_RATE)


# the seed of the ten class templates, shared by every reader (the
# "dataset"); a reader's own seed draws its rows
TEMPLATE_SEED = 1998


def mnist_reader(seed, batches, batch=BATCH, nan_pixel=False):
    """A reader of ``batches`` lists of ``batch`` rows ``(pixels, label)``:
    784 float32 pixels in [-1, 1] (the label's template, scaled by 0.5,
    plus normal noise of 0.5, clipped) and an int label, drawn from
    ``seed``. Every call yields the same rows. ``nan_pixel``: the first
    row's first pixel is NaN."""
    templates = np.random.default_rng(TEMPLATE_SEED).uniform(-1, 1,
                                                              (10, 784))

    def reader():
        rng = np.random.default_rng(seed)
        for b in range(batches):
            labels = rng.integers(0, 10, batch)
            pixels = np.clip(0.5 * templates[labels]
                             + 0.5 * rng.standard_normal((batch, 784)),
                             -1, 1).astype(np.float32)
            if nan_pixel and b == 0:
                pixels[0, 0] = np.nan
            yield [(p, int(y)) for p, y in zip(pixels, labels)]
    return reader
