"""Loss layers of the static graph (counterpart of
paddle_tpu/layers/loss.py): ``cross_entropy`` (of probabilities),
``square_error_cost``, ``mse_loss``, ``softmax_with_cross_entropy`` and
``sigmoid_cross_entropy_with_logits``. ``mean`` and ``reduce_mean`` are
generated layers of layers/nn.py, as in the JAX package."""
from __future__ import annotations

from .common import apply_op_layer

__all__ = ['cross_entropy', 'square_error_cost', 'mse_loss',
           'softmax_with_cross_entropy', 'sigmoid_cross_entropy_with_logits']


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    return apply_op_layer('cross_entropy', {'x': input, 'label': label},
                          {'soft_label': soft_label,
                           'ignore_index': ignore_index})


def square_error_cost(input, label):
    return apply_op_layer('square_error_cost', {'x': input, 'label': label})


def mse_loss(input, label):
    sq = apply_op_layer('square_error_cost', {'x': input, 'label': label})
    return apply_op_layer('reduce_mean', {'x': sq})


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss, sm = apply_op_layer('softmax_with_cross_entropy',
                              {'logits': logits, 'label': label},
                              {'soft_label': soft_label,
                               'ignore_index': ignore_index, 'axis': axis})
    return (loss, sm) if return_softmax else loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    return apply_op_layer('sigmoid_cross_entropy_with_logits',
                          {'x': x, 'label': label},
                          {'ignore_index': ignore_index,
                           'normalize': normalize}, name=name)
