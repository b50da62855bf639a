"""Training loops for the vision models of models/vision.py, as a user of
the dygraph API writes them:

- :func:`mobilenet_v2_step`: PaddleCV image_classification's MobileNetV2
  settings, ``Momentum(0.9)`` over ``CosineDecay`` from 0.1 a batch of
  ImageNet's epoch for ``MOBILENET_V2_EPOCHS`` (240) epochs,
  ``L2Decay(4e-5)``, through
  ``TrainStep`` (``amp_dtype`` for bf16 AMP); MobileNetV1 and VGG train
  through the same :func:`classifier_step` with their own rate and decay;
- :func:`tsm_step`: TSM's, ``Momentum(0.9)`` at 0.01, ``L2Decay(1e-4)``;
- :func:`dcgan_iteration` (:func:`dcgan_d_step`, then
  :func:`dcgan_g_step`): the DCGAN loop of the reference's
  ``test_imperative_gan``: the discriminator on real and fake images
  (``loss.backward()``, ``minimize``, ``clear_gradients()`` on both
  models), then the generator through the discriminator, with two
  ``Adam(2e-4, beta1=0.5)`` (:func:`dcgan_optimizers`). Clearing both
  models after each update keeps the gradients the generator's loss
  leaves on the discriminator out of its next update.

The loss of the classifiers is softmax cross entropy of the logits cast to
f32, the batch mean (bench.py's). Each loop takes tensors on the models'
device::

    import torch
    from paddle_tpu_torch.models import MobileNetV2
    from paddle_tpu_torch.tools import vision_recipes
    model = MobileNetV2(1000, device='cuda')
    step = vision_recipes.mobilenet_v2_step(model, 128,
                                            amp_dtype=torch.bfloat16)
    loss = step(images, labels)         # (128, 3, 224, 224), (128, 1)
"""
from __future__ import annotations

from ..dygraph.jit import TrainStep
from ..dygraph.learning_rate_scheduler import CosineDecay
from ..ops.loss_ops import (sigmoid_cross_entropy_with_logits,
                            softmax_with_cross_entropy)
from ..optimizer import Adam, Momentum
from ..regularizer import L2Decay

__all__ = ['IMAGENET_TRAIN_IMAGES', 'MOBILENET_V2_EPOCHS',
           'classification_loss', 'classifier_step',
           'mobilenet_v2_step', 'tsm_step', 'dcgan_optimizers',
           'dcgan_d_step', 'dcgan_g_step', 'dcgan_iteration']

IMAGENET_TRAIN_IMAGES = 1281167
MOBILENET_V2_EPOCHS = 240


def classification_loss(model, x, y):
    """Softmax cross entropy of ``model(x)`` cast to f32 against int64
    labels ``y`` (B, 1), the batch mean."""
    loss, _ = softmax_with_cross_entropy(model(x).float(), y)
    return loss.mean()


def classifier_step(model, lr, l2_decay, *, cosine=None, amp_dtype=None):
    """A ``TrainStep`` of :func:`classification_loss` with ``Momentum(0.9)``
    and ``L2Decay(l2_decay)``; the rate ``lr``, or ``CosineDecay(lr,
    *cosine)`` for ``cosine`` = (steps an epoch, epochs)."""
    rate = lr if cosine is None else CosineDecay(lr, *cosine)
    opt = Momentum(rate, momentum=0.9, parameter_list=model.parameters(),
                   regularization=L2Decay(l2_decay))
    return TrainStep(model, classification_loss, opt, amp_dtype=amp_dtype)


def mobilenet_v2_step(model, batch_size, *, amp_dtype=None):
    """PaddleCV's MobileNetV2 recipe: cosine decay from 0.1 over
    ``MOBILENET_V2_EPOCHS`` of ImageNet's training set at ``batch_size``,
    ``L2Decay(4e-5)``."""
    return classifier_step(
        model, 0.1, 4e-5, cosine=(IMAGENET_TRAIN_IMAGES // batch_size,
                                  MOBILENET_V2_EPOCHS), amp_dtype=amp_dtype)


def tsm_step(model, *, amp_dtype=None):
    """TSM's recipe: ``Momentum(0.9)`` at 0.01, ``L2Decay(1e-4)``; the
    step takes (N * seg_num, 3, H, W) frames and (N, 1) labels."""
    return classifier_step(model, 0.01, 1e-4, amp_dtype=amp_dtype)


def dcgan_optimizers(generator, discriminator):
    """(the discriminator's, the generator's) ``Adam(2e-4, beta1=0.5)``,
    each over its own model's parameters."""
    return (Adam(2e-4, beta1=0.5,
                 parameter_list=discriminator.parameters()),
            Adam(2e-4, beta1=0.5, parameter_list=generator.parameters()))


def _bce(logits, target):
    return sigmoid_cross_entropy_with_logits(logits, target).mean()


def dcgan_d_step(generator, discriminator, d_opt, real, z):
    """The discriminator's update on ``real`` images and ``generator(z)``;
    both models' gradients are cleared after it. Returns its loss."""
    d_loss = (_bce(discriminator(real), real.new_ones((real.shape[0], 1)))
              + _bce(discriminator(generator(z)),
                     real.new_zeros((real.shape[0], 1))))
    d_loss.backward()
    d_opt.minimize(d_loss)
    discriminator.clear_gradients()
    generator.clear_gradients()
    return d_loss


def dcgan_g_step(generator, discriminator, g_opt, z):
    """The generator's update through the discriminator; both models'
    gradients are cleared after it, so the discriminator's next update
    does not see the ones this loss leaves on it. Returns its loss."""
    fake_logits = discriminator(generator(z))
    g_loss = _bce(fake_logits, fake_logits.new_ones(fake_logits.shape))
    g_loss.backward()
    g_opt.minimize(g_loss)
    discriminator.clear_gradients()
    generator.clear_gradients()
    return g_loss


def dcgan_iteration(generator, discriminator, d_opt, g_opt, real, z):
    """:func:`dcgan_d_step`, then :func:`dcgan_g_step`; returns the two
    losses (tensors, not read on the host)."""
    return (dcgan_d_step(generator, discriminator, d_opt, real, z),
            dcgan_g_step(generator, discriminator, g_opt, z))
