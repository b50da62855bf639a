"""Loss layers of the static graph (counterpart of
paddle_tpu/layers/loss.py): ``softmax_with_cross_entropy``. ``mean`` and
``reduce_mean`` are generated layers of layers/nn.py, as in the JAX
package."""
from __future__ import annotations

from .common import apply_op_layer

__all__ = ['softmax_with_cross_entropy']


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss, sm = apply_op_layer('softmax_with_cross_entropy',
                              {'logits': logits, 'label': label},
                              {'soft_label': soft_label,
                               'ignore_index': ignore_index, 'axis': axis})
    return (loss, sm) if return_softmax else loss
