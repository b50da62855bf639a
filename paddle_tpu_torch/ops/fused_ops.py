"""The ops the IR passes emit (counterpart of paddle_tpu/ops/fused_ops.py).

- ``fused_elemwise_add_activation``: the (add, activation) pair that
  ``ir/fuse_act.py`` collapses, one dispatch where there were two. The
  activation runs in place on the sum, which no other op reads, so the
  pair allocates one tensor where it allocated two; autograd allows it
  (the add saves nothing, and relu, sigmoid and tanh save their output).
- ``fused_sgd``, ``fused_momentum``, ``fused_lars_momentum`` and
  ``fused_adam``: the update of
  every parameter of a group that ``ir/fuse_optimizer.py`` gathers, as
  torch's multi-tensor (``_foreach``) ops over the lists, a few launches
  for the group where the per-parameter ops take some four (Momentum) to
  twenty (Adam) each. They are the static graph's functional forms of
  ``optimizer_ops.multi_tensor_momentum`` and ``multi_tensor_adam``: the
  same operations in the same order, with the first of each chain out of
  place, so they return new tensors and leave their inputs as they were,
  as every static update op does (the executor writes the new state into
  the scope's tensors, in place where it may). Each operation is the one
  the per-parameter op (``optimizer_ops._momentum_out``, ``_adam_out``)
  does on that parameter, so each parameter gets the same bits. Adam's
  step size is computed for each parameter from its own ``beta1_pow`` and
  ``beta2_pow`` (``multi_tensor_adam`` takes the first pair's), as the
  per-parameter op and the JAX package's ``fused_adam`` do. LARS takes
  each parameter's and gradient's norm from ``torch._foreach_norm``; on
  the CPU that is the per-parameter op's ``torch.linalg.vector_norm``,
  bit for bit, while the card's multi-tensor reduction may sum in
  another order.
"""
from __future__ import annotations

import torch

from .math_ops import _align_y
from .registry import register_op

__all__ = ['fused_elemwise_add_activation', 'fused_sgd', 'fused_momentum',
           'fused_lars_momentum', 'fused_adam']

_INPLACE_ACTS = {'relu': torch.relu_, 'sigmoid': torch.sigmoid_,
                 'tanh': torch.tanh_}


@register_op('fused_elemwise_add_activation')
def fused_elemwise_add_activation(x, y, *, functor='relu', axis=-1):
    """``functor(x + y)``, ``y`` aligned to ``x`` from dim ``axis``."""
    return _INPLACE_ACTS[functor](torch.add(x, _align_y(x, y, axis)))


def _scalar(lr):
    """The (1,) learning rate as the 0-d tensor the ``_foreach`` ops
    take."""
    return lr.reshape(())


@register_op('fused_sgd', outputs=['ParamOut'], variadic=['params', 'grads'])
def fused_sgd(params, grads, lr):
    """``param - lr * grad`` for each pair, new tensors."""
    return torch._foreach_sub(params, torch._foreach_mul(grads,
                                                         _scalar(lr)))


@register_op('fused_momentum', outputs=['ParamOut', 'VelocityOut'],
             variadic=['params', 'grads', 'velocities'])
def fused_momentum(params, grads, velocities, lr, *, mu=0.9,
                   use_nesterov=False):
    """Paddle's momentum step for each triple, new tensors:
    ``(params, velocities)``."""
    lr = _scalar(lr)
    v_new = torch._foreach_mul(velocities, mu)
    torch._foreach_add_(v_new, grads)
    if use_nesterov:
        step = torch._foreach_mul(v_new, mu)
        step = torch._foreach_add(grads, step)
        torch._foreach_mul_(step, lr)
    else:
        step = torch._foreach_mul(v_new, lr)
    return torch._foreach_sub(params, step), v_new


@register_op('fused_lars_momentum', outputs=['ParamOut', 'VelocityOut'],
             variadic=['params', 'grads', 'velocities'])
def fused_lars_momentum(params, grads, velocities, lr, *, mu=0.9,
                        lars_coeff=0.001, lars_weight_decay=0.0005,
                        epsilon=0.0):
    """LARS for each triple (``optimizer_ops.lars_momentum``), new
    tensors: ``(params, velocities)``."""
    lr = _scalar(lr)
    pn = torch.stack(torch._foreach_norm(params))
    gn = torch.stack(torch._foreach_norm(grads))
    local_lr = torch.where(
        (pn > 0) & (gn > 0),
        lr * lars_coeff * pn / (gn + lars_weight_decay * pn + epsilon), lr)
    step = torch._foreach_mul(params, lars_weight_decay)
    torch._foreach_add_(step, grads)
    torch._foreach_mul_(step, list(local_lr.unbind()))
    v_new = torch._foreach_mul(velocities, mu)
    torch._foreach_add_(v_new, step)
    return torch._foreach_sub(params, v_new), v_new


@register_op('fused_adam', outputs=['ParamOut', 'Moment1Out', 'Moment2Out',
                                    'Beta1PowOut', 'Beta2PowOut'],
             variadic=['params', 'grads', 'moment1s', 'moment2s',
                       'beta1_pows', 'beta2_pows'])
def fused_adam(params, grads, moment1s, moment2s, beta1_pows, beta2_pows,
               lr, *, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """Paddle's Adam step for each parameter, new tensors: ``(params,
    moment1s, moment2s, beta1_pows, beta2_pows)``."""
    m1n = torch._foreach_mul(moment1s, beta1)
    torch._foreach_add_(m1n, torch._foreach_mul(grads, 1 - beta1))
    m2n = torch._foreach_mul(moment2s, beta2)
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - beta2)
    torch._foreach_add_(m2n, sq)
    # lr * sqrt(1 - beta2_pow) / (1 - beta1_pow), a (1,) each: 1 - b is
    # -b + 1 exactly
    c2 = torch._foreach_neg(beta2_pows)
    torch._foreach_add_(c2, 1)
    torch._foreach_sqrt_(c2)
    c1 = torch._foreach_neg(beta1_pows)
    torch._foreach_add_(c1, 1)
    lr_t = torch._foreach_mul(c2, _scalar(lr))
    torch._foreach_div_(lr_t, c1)
    step = torch._foreach_mul(m1n, lr_t)
    den = torch._foreach_sqrt(m2n)
    torch._foreach_add_(den, epsilon)
    torch._foreach_div_(step, den)
    return (torch._foreach_sub(params, step), m1n, m2n,
            torch._foreach_mul(beta1_pows, beta1),
            torch._foreach_mul(beta2_pows, beta2))
