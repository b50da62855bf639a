"""Weight-decay regularizers (counterpart of paddle_tpu/regularizer.py):
``L2Decay`` adds ``coeff * p`` to a parameter's gradient, ``L1Decay`` adds
``coeff * sign(p)``.

- Dygraph: :meth:`WeightDecayRegularizer.apply_group` works on a group of
  parameters at once with ``torch._foreach_*`` (the optimizers call it);
  ``apply(p, g)`` is the one-tensor form.
- Static graph: ``append_regularization_op`` appends the reference's ops
  (``scale``, ``sign``, ``elementwise_add``) and returns the new gradient
  Variable.

A parameter's own ``ParamAttr(regularizer=)`` wins over the optimizer's
``regularization=``, as the reference has it.
"""
from __future__ import annotations

import torch

__all__ = ['WeightDecayRegularizer', 'L2DecayRegularizer',
           'L1DecayRegularizer', 'L1Decay', 'L2Decay',
           'append_regularization_ops']


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad):
        """Static graph: the Variable ``grad + penalty'(param)``."""
        raise NotImplementedError

    def apply(self, p, g):
        """``g + penalty'(p)`` of one tensor."""
        return self.apply_group([p], [g])[0]

    def apply_group(self, params, grads):
        """``grads[i] + penalty'(params[i])`` for every i, as new
        tensors."""
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = float(regularization_coeff)

    def append_regularization_op(self, param, grad):
        from .layers.common import apply_op_layer
        decay = apply_op_layer('scale', {'x': param}, {'scale': self.coeff})
        return apply_op_layer('elementwise_add', {'x': grad, 'y': decay})

    def apply_group(self, params, grads):
        return torch._foreach_add(grads, params, alpha=self.coeff)


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = float(regularization_coeff)

    def append_regularization_op(self, param, grad):
        from .layers.common import apply_op_layer
        s = apply_op_layer('sign', {'x': param})
        decay = apply_op_layer('scale', {'x': s}, {'scale': self.coeff})
        return apply_op_layer('elementwise_add', {'x': grad, 'y': decay})

    def apply_group(self, params, grads):
        decay = torch._foreach_sign(params)
        torch._foreach_mul_(decay, self.coeff)
        return torch._foreach_add(grads, decay)


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    """Static graph: ``[(param, grad)]`` with each trainable parameter's
    gradient regularized by its own regularizer, else ``regularization``."""
    out = []
    for p, g in params_grads:
        reg = getattr(p, 'regularizer', None) or regularization
        if reg is not None and getattr(p, 'trainable', True):
            g = reg.append_regularization_op(p, g)
        out.append((p, g))
    return out
