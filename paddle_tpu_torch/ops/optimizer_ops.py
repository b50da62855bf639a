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

The other rules (``lars_momentum``, ``adamax``, ``adagrad``,
``decayed_adagrad``, ``rmsprop``, ``adadelta``, ``ftrl``, ``lamb``,
``dpsgd`` and ``dgc_momentum``) are registered under the JAX names, inputs
and outputs, as functional ops that return new tensors: each is the plain
version of its rule, which the static graph runs one a parameter and
against which its multi-tensor form is held. Beside each, a
``multi_tensor_<rule>`` updates lists of parameters and slots in place
with torch's ``_foreach`` ops, for the dygraph path, by the same
operations in the same order. Where a rule scales a parameter by its own
norms (LARS, Lamb, Dpsgd's clip), the multi-tensor form takes them from
``torch._foreach_norm`` and keeps the op's guard: a parameter or gradient
of norm 0 takes the plain rate. Where a rule reads a (1,) power slot
(Adamax, Lamb), the multi-tensor form takes its step size from the first
parameter's, as ``multi_tensor_adam`` does: the optimizer groups
parameters by the updates behind them, so the powers of a group agree.

Static AMP's dynamic loss scaling (contrib/mixed_precision.py) adds
``check_finite_and_unscale`` and ``update_loss_scaling``, which keep the
scale and its step counts on the device: no host read.
"""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = ['sgd', 'momentum', 'multi_tensor_momentum', 'adam',
           'multi_tensor_adam', 'lars_momentum',
           'multi_tensor_lars_momentum', 'adamax', 'multi_tensor_adamax',
           'adagrad', 'multi_tensor_adagrad', 'decayed_adagrad',
           'multi_tensor_decayed_adagrad', 'rmsprop', 'multi_tensor_rmsprop',
           'adadelta', 'multi_tensor_adadelta', 'ftrl', 'multi_tensor_ftrl',
           'lamb', 'multi_tensor_lamb', 'dpsgd', 'multi_tensor_dpsgd',
           'dgc_momentum', 'multi_tensor_dgc_momentum',
           'check_finite_and_unscale', 'update_loss_scaling']


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

def _as_rate(lr, like):
    """The rate as a tensor: a number becomes a 0-d f32 tensor on
    ``like``'s device (a fill, no copy), so that products of the rate and
    another number round in f32, as the JAX ops' ``jnp.asarray(lr)``
    does."""
    if isinstance(lr, torch.Tensor):
        return lr
    return torch.full((), lr, dtype=torch.float32, device=like.device)


def _scalar_rate(lr, like):
    """:func:`_as_rate` as a 0-d tensor, the form the ``_foreach`` ops
    take."""
    return _as_rate(lr, like).reshape(())


def _norms(tensors):
    """The L2 norm of each tensor, stacked: (N,)."""
    return torch.stack(torch._foreach_norm(tensors))


@register_op('lars_momentum', outputs=['ParamOut', 'VelocityOut'])
def lars_momentum(param, grad, velocity, lr, *, mu=0.9, lars_coeff=0.001,
                  lars_weight_decay=0.0005, epsilon=0.0):
    """LARS: momentum at a local rate ``lr * lars_coeff * |p| / (|g| +
    lars_weight_decay * |p| + epsilon)``, the plain rate where either norm
    is 0. Returns new ``(param, velocity)``."""
    lr = _as_rate(lr, param)
    pn = torch.linalg.vector_norm(param)
    gn = torch.linalg.vector_norm(grad)
    local_lr = torch.where(
        (pn > 0) & (gn > 0),
        lr * lars_coeff * pn / (gn + lars_weight_decay * pn + epsilon), lr)
    v_new = mu * velocity + local_lr * (grad + lars_weight_decay * param)
    return param - v_new, v_new


@torch.no_grad()
def multi_tensor_lars_momentum(params, grads, velocities, lr, *, mu=0.9,
                               lars_coeff=0.001, lars_weight_decay=0.0005,
                               epsilon=0.0):
    """:func:`lars_momentum` over lists, in place."""
    lr = _scalar_rate(lr, params[0])
    pn, gn = _norms(params), _norms(grads)
    local_lr = torch.where(
        (pn > 0) & (gn > 0),
        lr * lars_coeff * pn / (gn + lars_weight_decay * pn + epsilon), lr)
    step = torch._foreach_mul(params, lars_weight_decay)
    torch._foreach_add_(step, grads)
    torch._foreach_mul_(step, list(local_lr.unbind()))
    torch._foreach_mul_(velocities, mu)
    torch._foreach_add_(velocities, step)
    torch._foreach_sub_(params, velocities)


@register_op('adamax', outputs=['ParamOut', 'MomentOut', 'InfNormOut',
                                'Beta1PowOut'])
def adamax(param, grad, moment, inf_norm, beta1_pow, lr, *, beta1=0.9,
           beta2=0.999, epsilon=1e-8):
    """Adamax. Returns new ``(param, moment, inf_norm, beta1_pow)``."""
    lr = _as_rate(lr, param)
    mn = beta1 * moment + (1 - beta1) * grad
    un = torch.maximum(beta2 * inf_norm, torch.abs(grad))
    pn = param - (lr / (1 - beta1_pow)) * mn / (un + epsilon)
    return pn, mn, un, beta1_pow * beta1


@torch.no_grad()
def multi_tensor_adamax(params, grads, moments, inf_norms, beta1_pows, lr,
                        *, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """:func:`adamax` over lists, in place."""
    torch._foreach_mul_(moments, beta1)
    torch._foreach_add_(moments, torch._foreach_mul(grads, 1 - beta1))
    torch._foreach_mul_(inf_norms, beta2)
    torch._foreach_maximum_(inf_norms, torch._foreach_abs(grads))
    rate = _as_rate(lr, params[0]) / (1 - beta1_pows[0])
    step = torch._foreach_mul(moments, rate.reshape(()))
    torch._foreach_div_(step, torch._foreach_add(inf_norms, epsilon))
    torch._foreach_sub_(params, step)
    torch._foreach_mul_(beta1_pows, beta1)


@register_op('adagrad', outputs=['ParamOut', 'MomentOut'])
def adagrad(param, grad, moment, lr, *, epsilon=1e-6):
    """Adagrad. Returns new ``(param, moment)``."""
    mn = moment + torch.square(grad)
    return param - _as_rate(lr, param) * grad / (torch.sqrt(mn) + epsilon), mn


def _adagrad_step(params, grads, moments, lr, epsilon):
    step = torch._foreach_mul(grads, _scalar_rate(lr, params[0]))
    den = torch._foreach_sqrt(moments)
    torch._foreach_add_(den, epsilon)
    torch._foreach_div_(step, den)
    torch._foreach_sub_(params, step)


@torch.no_grad()
def multi_tensor_adagrad(params, grads, moments, lr, *, epsilon=1e-6):
    """:func:`adagrad` over lists, in place."""
    torch._foreach_add_(moments, torch._foreach_mul(grads, grads))
    _adagrad_step(params, grads, moments, lr, epsilon)


@register_op('decayed_adagrad', outputs=['ParamOut', 'MomentOut'])
def decayed_adagrad(param, grad, moment, lr, *, decay=0.95, epsilon=1e-6):
    """Adagrad with a decaying accumulator. Returns new ``(param,
    moment)``."""
    mn = decay * moment + (1 - decay) * torch.square(grad)
    return param - _as_rate(lr, param) * grad / (torch.sqrt(mn) + epsilon), mn


@torch.no_grad()
def multi_tensor_decayed_adagrad(params, grads, moments, lr, *, decay=0.95,
                                 epsilon=1e-6):
    """:func:`decayed_adagrad` over lists, in place."""
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - decay)
    torch._foreach_mul_(moments, decay)
    torch._foreach_add_(moments, sq)
    _adagrad_step(params, grads, moments, lr, epsilon)


@register_op('rmsprop', outputs=['ParamOut', 'MeanSquareOut', 'MomentOut',
                                 'MeanGradOut'])
def rmsprop(param, grad, mean_square, moment, mean_grad, lr, *, rho=0.95,
            epsilon=1e-6, momentum=0.0, centered=False):
    """RMSProp, plain or ``centered``. Returns new ``(param, mean_square,
    moment, mean_grad)``."""
    msn = rho * mean_square + (1 - rho) * torch.square(grad)
    if centered:
        mgn = rho * mean_grad + (1 - rho) * grad
        denom = torch.sqrt(msn - torch.square(mgn) + epsilon)
    else:
        mgn = mean_grad
        denom = torch.sqrt(msn + epsilon)
    momn = momentum * moment + _as_rate(lr, param) * grad / denom
    return param - momn, msn, momn, mgn


@torch.no_grad()
def multi_tensor_rmsprop(params, grads, mean_squares, moments, mean_grads,
                         lr, *, rho=0.95, epsilon=1e-6, momentum=0.0,
                         centered=False):
    """:func:`rmsprop` over lists, in place."""
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - rho)
    torch._foreach_mul_(mean_squares, rho)
    torch._foreach_add_(mean_squares, sq)
    if centered:
        torch._foreach_mul_(mean_grads, rho)
        torch._foreach_add_(mean_grads, torch._foreach_mul(grads, 1 - rho))
        den = torch._foreach_sub(mean_squares,
                                 torch._foreach_mul(mean_grads, mean_grads))
        torch._foreach_add_(den, epsilon)
    else:
        den = torch._foreach_add(mean_squares, epsilon)
    torch._foreach_sqrt_(den)
    step = torch._foreach_mul(grads, _scalar_rate(lr, params[0]))
    torch._foreach_div_(step, den)
    torch._foreach_mul_(moments, momentum)
    torch._foreach_add_(moments, step)
    torch._foreach_sub_(params, moments)


@register_op('adadelta', outputs=['ParamOut', 'AvgSquaredGradOut',
                                  'AvgSquaredUpdateOut'])
def adadelta(param, grad, avg_squared_grad, avg_squared_update, *, rho=0.95,
             epsilon=1e-6):
    """Adadelta (no rate). Returns new ``(param, avg_squared_grad,
    avg_squared_update)``."""
    asgn = rho * avg_squared_grad + (1 - rho) * torch.square(grad)
    update = -torch.sqrt((avg_squared_update + epsilon)
                         / (asgn + epsilon)) * grad
    asun = rho * avg_squared_update + (1 - rho) * torch.square(update)
    return param + update, asgn, asun


@torch.no_grad()
def multi_tensor_adadelta(params, grads, avg_squared_grads,
                          avg_squared_updates, *, rho=0.95, epsilon=1e-6):
    """:func:`adadelta` over lists, in place."""
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - rho)
    torch._foreach_mul_(avg_squared_grads, rho)
    torch._foreach_add_(avg_squared_grads, sq)
    update = torch._foreach_add(avg_squared_updates, epsilon)
    torch._foreach_div_(update, torch._foreach_add(avg_squared_grads,
                                                   epsilon))
    torch._foreach_sqrt_(update)
    torch._foreach_neg_(update)
    torch._foreach_mul_(update, grads)
    sq = torch._foreach_mul(update, update)
    torch._foreach_mul_(sq, 1 - rho)
    torch._foreach_mul_(avg_squared_updates, rho)
    torch._foreach_add_(avg_squared_updates, sq)
    torch._foreach_add_(params, update)


@register_op('ftrl', outputs=['ParamOut', 'SquaredAccumOut',
                              'LinearAccumOut'])
def ftrl(param, grad, squared_accum, linear_accum, lr, *, l1=0.0, l2=0.0,
         lr_power=-0.5):
    """FTRL-proximal. Returns new ``(param, squared_accum,
    linear_accum)``."""
    lr = _as_rate(lr, param)
    new_sq = squared_accum + torch.square(grad)
    sigma = (torch.pow(new_sq, -lr_power)
             - torch.pow(squared_accum, -lr_power)) / lr
    new_lin = linear_accum + grad - sigma * param
    x = -new_lin + torch.clamp(new_lin, -l1, l1)
    y = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    pn = torch.where(torch.abs(new_lin) > l1, x / y, torch.zeros_like(param))
    return pn, new_sq, new_lin


@torch.no_grad()
def multi_tensor_ftrl(params, grads, squared_accums, linear_accums, lr, *,
                      l1=0.0, l2=0.0, lr_power=-0.5):
    """:func:`ftrl` over lists, in place."""
    lr = _scalar_rate(lr, params[0])
    new_sq = torch._foreach_add(squared_accums,
                                torch._foreach_mul(grads, grads))
    new_pow = torch._foreach_pow(new_sq, -lr_power)
    sigma = torch._foreach_sub(new_pow,
                               torch._foreach_pow(squared_accums, -lr_power))
    torch._foreach_div_(sigma, lr)
    torch._foreach_add_(linear_accums, grads)
    torch._foreach_sub_(linear_accums, torch._foreach_mul(sigma, params))
    x = torch._foreach_neg(linear_accums)
    torch._foreach_add_(x, torch._foreach_clamp_max(
        torch._foreach_clamp_min(linear_accums, -l1), l1))
    y = torch._foreach_div(new_pow, lr)
    torch._foreach_add_(y, 2 * l2)
    torch._foreach_div_(x, y)
    for p, lin, v in zip(params, linear_accums, x):
        p.copy_(torch.where(torch.abs(lin) > l1, v, torch.zeros_like(p)))
    torch._foreach_copy_(squared_accums, new_sq)


@register_op('lamb', outputs=['ParamOut', 'Moment1Out', 'Moment2Out',
                              'Beta1PowOut', 'Beta2PowOut'])
def lamb(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr, *,
         weight_decay=0.01, beta1=0.9, beta2=0.999, epsilon=1e-6):
    """LAMB: Adam's direction plus ``weight_decay * p``, scaled by the
    trust ratio ``|p| / |r|`` (1 where either norm is 0). Returns new
    ``(param, moment1, moment2, beta1_pow, beta2_pow)``."""
    m1n = beta1 * moment1 + (1 - beta1) * grad
    m2n = beta2 * moment2 + (1 - beta2) * torch.square(grad)
    m1h = m1n / (1 - beta1_pow)
    m2h = m2n / (1 - beta2_pow)
    r = m1h / (torch.sqrt(m2h) + epsilon) + weight_decay * param
    pnorm = torch.linalg.vector_norm(param)
    rnorm = torch.linalg.vector_norm(r)
    trust = torch.where((pnorm > 0) & (rnorm > 0), pnorm / rnorm, 1.0)
    return (param - _as_rate(lr, param) * trust * r, m1n, m2n,
            beta1_pow * beta1, beta2_pow * beta2)


@torch.no_grad()
def multi_tensor_lamb(params, grads, moment1s, moment2s, beta1_pows,
                      beta2_pows, lr, *, weight_decay=0.01, beta1=0.9,
                      beta2=0.999, epsilon=1e-6):
    """:func:`lamb` over lists, in place."""
    torch._foreach_mul_(moment1s, beta1)
    torch._foreach_add_(moment1s, torch._foreach_mul(grads, 1 - beta1))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, 1 - beta2)
    torch._foreach_mul_(moment2s, beta2)
    torch._foreach_add_(moment2s, sq)
    r = torch._foreach_div(moment1s, (1 - beta1_pows[0]).reshape(()))
    den = torch._foreach_div(moment2s, (1 - beta2_pows[0]).reshape(()))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, epsilon)
    torch._foreach_div_(r, den)
    torch._foreach_add_(r, torch._foreach_mul(params, weight_decay))
    pn, rn = _norms(params), _norms(r)
    trust = torch.where((pn > 0) & (rn > 0), pn / rn, 1.0)
    rate = _scalar_rate(lr, params[0]) * trust
    torch._foreach_mul_(r, list(rate.unbind()))
    torch._foreach_sub_(params, r)
    torch._foreach_mul_(beta1_pows, beta1)
    torch._foreach_mul_(beta2_pows, beta2)


@register_op('dpsgd', outputs=['ParamOut'], needs_rng=True)
def dpsgd(param, grad, lr, *, clip=10.0, batch_size=16.0, sigma=1.0,
          key=None):
    """Differentially private SGD: the gradient clipped to norm ``clip``,
    plus Gaussian noise of deviation ``sigma * clip / batch_size`` drawn
    from ``key`` (the device's ``torch.Generator``; the draws differ from
    the JAX package's PRNG by design). Returns the new parameter."""
    gn = torch.linalg.vector_norm(grad)
    g = grad / torch.clamp(gn / clip, min=1.0)
    noise = sigma * clip / batch_size * torch.randn(
        grad.shape, generator=key, dtype=grad.dtype, device=grad.device)
    return param - _as_rate(lr, param) * (g + noise)


@torch.no_grad()
def multi_tensor_dpsgd(params, grads, lr, *, clip=10.0, batch_size=16.0,
                       sigma=1.0, key=None):
    """:func:`dpsgd` over lists, in place: the noise is drawn a parameter
    at a time, in order, so the same generator state gives each
    parameter :func:`dpsgd`'s draw."""
    scale = torch.clamp(_norms(grads) / clip, min=1.0)
    g = torch._foreach_div(grads, list(scale.unbind()))
    noise = [torch.randn(t.shape, generator=key, dtype=t.dtype,
                         device=t.device) for t in grads]
    torch._foreach_mul_(noise, sigma * clip / batch_size)
    torch._foreach_add_(g, noise)
    torch._foreach_mul_(g, _scalar_rate(lr, params[0]))
    torch._foreach_sub_(params, g)


def _dgc_keep(acc, sparsity):
    """The mask of the entries of ``acc`` at or above its k-th largest
    magnitude, k = max(1, int(n * (1 - sparsity))): ties at the threshold
    are all kept, so more than k entries may pass."""
    flat = torch.abs(acc).reshape(-1)
    k = max(1, int(flat.shape[0] * (1.0 - sparsity)))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(acc) >= thresh).to(acc.dtype)


@register_op('dgc_momentum', outputs=['ParamOut', 'VelocityOut',
                                      'ErrorOut'])
def dgc_momentum(param, grad, velocity, error, lr, *, mu=0.9,
                 sparsity=0.999, rampup_step=1.0, use_nesterov=False):
    """Deep Gradient Compression momentum: the gradient plus the carried
    error, kept where its magnitude reaches the top ``1 - sparsity``
    (:func:`_dgc_keep`), the rest carried as the new error; momentum on
    the kept part. Returns new ``(param, velocity, error)``."""
    lr = _as_rate(lr, param)
    acc = error + grad
    sparse = acc * _dgc_keep(acc, sparsity)
    e_new = acc - sparse
    v_new = mu * velocity + sparse
    if use_nesterov:
        return param - lr * (sparse + mu * v_new), v_new, e_new
    return param - lr * v_new, v_new, e_new


@torch.no_grad()
def multi_tensor_dgc_momentum(params, grads, velocities, errors, lr, *,
                              mu=0.9, sparsity=0.999, rampup_step=1.0,
                              use_nesterov=False):
    """:func:`dgc_momentum` over lists, in place (the threshold is one
    ``topk`` a parameter)."""
    lr = _scalar_rate(lr, params[0])
    acc = torch._foreach_add(errors, grads)
    sparse = torch._foreach_mul(acc, [_dgc_keep(a, sparsity) for a in acc])
    torch._foreach_copy_(errors, torch._foreach_sub(acc, sparse))
    torch._foreach_mul_(velocities, mu)
    torch._foreach_add_(velocities, sparse)
    if use_nesterov:
        step = torch._foreach_mul(velocities, mu)
        step = torch._foreach_add(sparse, step)
        torch._foreach_mul_(step, lr)
    else:
        step = torch._foreach_mul(velocities, lr)
    torch._foreach_sub_(params, step)


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
