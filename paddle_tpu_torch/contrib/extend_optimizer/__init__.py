"""``contrib.extend_optimizer`` (counterpart of the JAX package's
``contrib/extend_optimizer``, whose function lives in ``contrib/extra.py``):
decoupled weight decay, the AdamW form, for any optimizer of the port."""
from __future__ import annotations

import torch

from ...framework import Variable, default_main_program
from ...layers.common import apply_op_layer

__all__ = ['extend_with_decoupled_weight_decay']


def extend_with_decoupled_weight_decay(base_optimizer_cls):
    """A subclass of ``base_optimizer_cls`` whose constructor takes
    ``weight_decay`` first (``cls(weight_decay, *args, **kwargs)``) and
    decays the weights apart from the gradient:

    - dygraph: before each update, every parameter that has a gradient
      and trains shrinks to ``p * (1 - lr * weight_decay)`` at the rate
      the update takes (the torch AdamW form: the pre-update weights);
    - static graph: ``p -= p * (lr * weight_decay)`` before each update
      op, from the live rate variable (``scale``, ``elementwise_mul``,
      ``elementwise_sub``), so a schedule scales the decay too."""

    class DecoupledWeightDecay(base_optimizer_cls):
        def __init__(self, weight_decay=0.01, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._decoupled_wd = float(weight_decay)

        def apply_gradients(self, params):
            if params and isinstance(params[0], tuple) \
                    and isinstance(params[0][0], Variable):
                return super().apply_gradients(params)
            shrink = [p for p in params
                      if p.grad is not None and p.requires_grad]
            if shrink:
                coeff = self._decoupled_wd * self.current_step_lr
                with torch.no_grad():
                    torch._foreach_mul_(shrink, 1.0 - coeff)
            return super().apply_gradients(params)

        def _append_optimize_op(self, param, grad, lr, block=None):
            decay = apply_op_layer('scale', {'x': lr},
                                   {'scale': self._decoupled_wd})
            shrink = apply_op_layer('elementwise_mul',
                                    {'x': param, 'y': decay})
            default_main_program().current_block().append_op(
                type='elementwise_sub',
                inputs={'x': param.name, 'y': shrink.name},
                outputs={'Out': param.name}, attrs={})
            super()._append_optimize_op(param, grad, lr, block)

    DecoupledWeightDecay.__name__ = \
        base_optimizer_cls.__name__ + 'WithDecoupledWeightDecay'
    return DecoupledWeightDecay
