"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py).

The JAX ops return new arrays, which the fused training step donates so XLA
writes them in place. Here the dygraph update writes the parameter and its
slots in place under ``no_grad``; that takes the place of the donation
(``momentum``, ``adam`` and their multi-tensor forms, which ``TrainStep``
runs).

The static graph's ops are the functional forms the JAX package registers:
``sgd``, ``momentum`` and ``adam`` return the new parameter and slots
(``ParamOut``, ``VelocityOut``, ``Moment1Out``, ...), which the executor
writes back to the scope. The registry binds ``momentum`` and ``adam`` to
:func:`_momentum_out` and :func:`_adam_out`, the same arithmetic with the
JAX ops' outputs.

Static AMP's dynamic loss scaling (contrib/mixed_precision.py) adds
``check_finite_and_unscale`` and ``update_loss_scaling``, which keep the
scale and its step counts on the device: no host read.
"""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = ['sgd', 'momentum', 'multi_tensor_momentum', 'adam',
           'multi_tensor_adam', 'check_finite_and_unscale',
           'update_loss_scaling']


@register_op('sgd', outputs=['ParamOut'])
def sgd(param, grad, lr):
    """``param - lr * grad``, a new tensor."""
    return param - lr * grad


@register_op('momentum', outputs=['ParamOut', 'VelocityOut'])
def _momentum_out(param, grad, velocity, lr, *, mu=0.9, use_nesterov=False):
    """:func:`momentum`'s step as new tensors: ``(param, velocity)``."""
    v_new = mu * velocity + grad
    if use_nesterov:
        return param - (grad + mu * v_new) * lr, v_new
    return param - lr * v_new, v_new


@register_op('adam', outputs=['ParamOut', 'Moment1Out', 'Moment2Out',
                              'Beta1PowOut', 'Beta2PowOut'])
def _adam_out(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr, *,
              beta1=0.9, beta2=0.999, epsilon=1e-8):
    """:func:`adam`'s step as new tensors: ``(param, moment1, moment2,
    beta1_pow, beta2_pow)``."""
    m1n = beta1 * moment1 + (1 - beta1) * grad
    m2n = beta2 * moment2 + (1 - beta2) * torch.square(grad)
    lr_t = lr * torch.sqrt(1 - beta2_pow) / (1 - beta1_pow)
    pn = param - lr_t * m1n / (torch.sqrt(m2n) + epsilon)
    return pn, m1n, m2n, beta1_pow * beta1, beta2_pow * beta2


@torch.no_grad()
def momentum(param, grad, velocity, lr, *, mu=0.9, use_nesterov=False):
    """Paddle's momentum step, in place on ``param`` and ``velocity``:

        v = mu * v + g
        p -= lr * v                    (Nesterov: p -= (g + mu * v) * lr)

    ``lr`` is a float or a (1,) tensor. Returns ``param``."""
    p_new, v_new = _momentum_out(param, grad, velocity, lr, mu=mu,
                                 use_nesterov=use_nesterov)
    velocity.copy_(v_new)
    return param.copy_(p_new)


@torch.no_grad()
def multi_tensor_momentum(params, grads, velocities, lr, *, mu=0.9,
                          use_nesterov=False):
    """:func:`momentum` over lists of tensors, in place, with torch's
    multi-tensor (``_foreach``) ops: a few launches for the whole list, the
    counterpart of the reference's one fused update over all parameters.
    The arithmetic is :func:`momentum`'s, operation for operation, so each
    tensor gets the same bits."""
    torch._foreach_mul_(velocities, mu)
    torch._foreach_add_(velocities, grads)
    if use_nesterov:
        step = torch._foreach_mul(velocities, mu)
        step = torch._foreach_add(grads, step)
        torch._foreach_mul_(step, lr)
    else:
        step = torch._foreach_mul(velocities, lr)
    torch._foreach_sub_(params, step)


@torch.no_grad()
def adam(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr, *,
         beta1=0.9, beta2=0.999, epsilon=1e-8):
    """Paddle's Adam step, in place on ``param``, ``moment1``, ``moment2``,
    ``beta1_pow`` and ``beta2_pow``:

        m1 = beta1 * m1 + (1 - beta1) * g
        m2 = beta2 * m2 + (1 - beta2) * g * g
        p -= lr * sqrt(1 - beta2_pow) / (1 - beta1_pow) * m1 / (sqrt(m2) + eps)
        beta1_pow *= beta1; beta2_pow *= beta2

    ``beta1_pow`` and ``beta2_pow`` are (1,) slots that start at ``beta1``
    and ``beta2``. This is not ``torch.optim.Adam``: there epsilon is added
    to the bias-corrected second moment, which gives another step wherever
    sqrt(m2) is near epsilon. ``lr`` is a float or a (1,) tensor. Returns
    ``param``."""
    outs = _adam_out(param, grad, moment1, moment2, beta1_pow, beta2_pow,
                     lr, beta1=beta1, beta2=beta2, epsilon=epsilon)
    for t, new in zip((param, moment1, moment2, beta1_pow, beta2_pow), outs):
        t.copy_(new)
    return param


@torch.no_grad()
def multi_tensor_adam(params, grads, moment1s, moment2s, beta1_pows,
                      beta2_pows, lr, *, beta1=0.9, beta2=0.999,
                      epsilon=1e-8):
    """:func:`adam` over lists of tensors, in place, with torch's
    multi-tensor (``_foreach``) ops: a few launches for the whole list
    instead of some twenty per tensor, the counterpart of the reference's
    one fused update over all parameters. The arithmetic is :func:`adam`'s,
    operation for operation, so each tensor gets the same bits.

    Every ``beta1_pows[i]`` (and ``beta2_pows[i]``) must hold the same value,
    as it does for parameters updated together since their first step: the
    step size is computed once, from the first pair."""
    torch._foreach_mul_(moment1s, beta1)
    torch._foreach_add_(moment1s, torch._foreach_mul(grads, 1 - beta1))
    torch._foreach_mul_(moment2s, beta2)
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - beta2)
    torch._foreach_add_(moment2s, sq)
    lr_t = lr * torch.sqrt(1 - beta2_pows[0]) / (1 - beta1_pows[0])
    step = torch._foreach_mul(moment1s, lr_t.reshape(()))
    den = torch._foreach_sqrt(moment2s)
    torch._foreach_add_(den, epsilon)
    torch._foreach_div_(step, den)
    torch._foreach_sub_(params, step)
    torch._foreach_mul_(beta1_pows, beta1)
    torch._foreach_mul_(beta2_pows, beta2)


@register_op('check_finite_and_unscale', outputs=['Out', 'FoundInfinite'],
             variadic=['xs'])
def check_finite_and_unscale(xs, scale):
    """Every tensor of ``xs`` times ``1 / scale``, and a (1,) bool: whether
    any entry of them is not finite (the largest magnitude of each in one
    ``_foreach_norm(inf)``, which is inf or NaN wherever an entry is)."""
    inv = 1.0 / scale.reshape(())
    outs = [x * inv for x in xs]
    amax = torch._foreach_norm(outs, float('inf'))
    found = torch.logical_not(torch.isfinite(torch.stack(
        [a.to(torch.float32) for a in amax])).all())
    return outs, found.reshape(1)


@register_op('update_loss_scaling',
             outputs=['LossScaling', 'OutGoodSteps', 'OutBadSteps'])
def update_loss_scaling(found_inf, prev_loss_scaling, in_good_steps,
                        in_bad_steps, *, incr_every_n_steps=1000,
                        decr_every_n_nan_or_inf=2, incr_ratio=2.0,
                        decr_ratio=0.8):
    """The dynamic loss scale's update, branchless: a bad step counts up
    the bad steps and zeroes the good ones, a good step the other way; at
    ``decr_every_n_nan_or_inf`` bad steps the scale becomes
    ``max(scale * decr_ratio, 1)``, at ``incr_every_n_steps`` good steps
    ``scale * incr_ratio``, and each resets its own count. Returns the
    scale (f32) and the counts (int32), each of shape (1,)."""
    found = found_inf.reshape(()).to(torch.bool)
    scale = prev_loss_scaling.reshape(()).to(torch.float32)
    good = in_good_steps.reshape(()).to(torch.int32)
    bad = in_bad_steps.reshape(()).to(torch.int32)
    zero = torch.zeros_like(bad)
    bad_n = torch.where(found, bad + 1, zero)
    good_n = torch.where(found, zero, good + 1)
    decr = bad_n >= decr_every_n_nan_or_inf
    incr = good_n >= incr_every_n_steps
    scale_n = torch.where(
        decr, torch.clamp(scale * decr_ratio, min=1.0),
        torch.where(incr, scale * incr_ratio, scale))
    bad_n = torch.where(decr, zero, bad_n)
    good_n = torch.where(incr, zero, good_n)
    return scale_n.reshape(1), good_n.reshape(1), bad_n.reshape(1)
