"""Automatic mixed precision (counterpart of
paddle_tpu/contrib/mixed_precision.py): ``decorate``,
``OptimizerWithMixedPrecision``, ``AutoMixedPrecisionLists`` and
``cast_model_to_bf16``.

bf16 keeps f32's exponent range, so the fast path needs no loss scaling;
the bf16 forward and backward come from ``TrainStep(amp_dtype=)``, which
runs the decorated optimizer's inner one, as the JAX step does. What the
wrapper adds in dygraph ``minimize`` is the reference's gate: one fused
all-finite check over the gradients, with one host sync; on a non-finite
gradient the update is skipped (and the gradients cleared), the skip
counted, and under dynamic scaling the scale decays after
``decr_every_n_nan_or_inf`` bad steps; after ``incr_every_n_steps`` good
steps it grows. ``get_loss_scaling`` and ``overflow_steps`` read that
state. The loss itself is not scaled in dygraph, as in the reference.

The static graph's AMP (the cast-list rewrite and in-graph loss scaling)
raises (ROADMAP A.8e). The reference's ``amp_loss_scale`` gauge and
skip counter of its observability registry wait for ROADMAP A.11.
"""
from __future__ import annotations

import torch

__all__ = ['AutoMixedPrecisionLists', 'OptimizerWithMixedPrecision',
           'decorate', 'cast_model_to_bf16', 'white_list', 'black_list']

# the reference's cast lists (fp16_lists.py)
white_list = {'conv2d', 'conv3d', 'matmul', 'mul', 'conv2d_transpose'}
black_list = {'exp', 'square', 'log', 'mean', 'sum', 'cos_sim',
              'softmax', 'softmax_with_cross_entropy',
              'sigmoid_cross_entropy_with_logits', 'cross_entropy',
              'layer_norm', 'batch_norm', 'reduce_sum'}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(white_list) | set(custom_white_list or ())
        self.black_list = set(black_list) | set(custom_black_list or ())


def _all_finite(grads):
    """Whether every entry of ``grads`` is finite, as a bool: the largest
    magnitude of each gradient in one ``_foreach_norm(inf)`` (inf or NaN
    wherever an entry is), then one host sync."""
    dev = grads[0].device
    amax = torch._foreach_norm(grads, float('inf'))
    return bool(torch.isfinite(torch.stack(
        [a.to(dev, torch.float32) for a in amax])).all())


class OptimizerWithMixedPrecision:
    """Wraps an optimizer (the reference's decorator.py); every attribute
    it does not define is the inner optimizer's."""

    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=2.**15,
                 incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 incr_ratio=2.0, decr_ratio=0.8,
                 use_dynamic_loss_scaling=True, dtype='bfloat16'):
        self._inner = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._loss_scale = float(init_loss_scaling)
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._dynamic = use_dynamic_loss_scaling
        self._dtype = dtype
        self._good_steps = 0
        self._bad_steps = 0
        self._skip_count = 0

    def __getattr__(self, item):
        if item == '_inner':      # not set yet (copy, unpickling)
            raise AttributeError(item)
        return getattr(self._inner, item)

    def get_loss_scaling(self, scope=None):
        return self._loss_scale

    def overflow_steps(self, scope=None):
        """Updates skipped on a non-finite gradient so far."""
        return self._skip_count

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..framework import Variable
        if isinstance(loss, Variable):
            raise NotImplementedError(
                'static-graph mixed precision (decorate on a Program) is '
                'not ported yet (ROADMAP A.8e)')
        return self._dygraph_minimize(loss, parameter_list)

    def _dygraph_minimize(self, loss, parameter_list):
        params = (list(parameter_list) if parameter_list is not None
                  else self._inner._parameter_list)
        if params is None:
            raise ValueError('no parameter_list: pass one to the '
                             'constructor or to minimize')
        grads = [p.grad for p in params if p.grad is not None]
        if grads and not _all_finite(grads):
            # the skip is unconditional; dynamic scaling only decides
            # whether the scale decays
            if self._dynamic:
                self._bad_steps += 1
                self._good_steps = 0
                if self._bad_steps >= self._decr_every:
                    self._loss_scale = max(
                        self._loss_scale * self._decr_ratio, 1.0)
                    self._bad_steps = 0
            self._skip_count += 1
            for p in params:
                p.grad = None
            return None, []
        self._good_steps += 1
        self._bad_steps = 0
        if self._dynamic and self._good_steps >= self._incr_every:
            self._loss_scale *= self._incr_ratio
            self._good_steps = 0
        return self._inner.minimize(loss, parameter_list=params)


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.**15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8, use_dynamic_loss_scaling=True,
             dtype='bfloat16'):
    """``fluid.contrib.mixed_precision.decorate``: ``optimizer`` wrapped in
    an :class:`OptimizerWithMixedPrecision`."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, incr_every_n_steps,
        decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        use_dynamic_loss_scaling, dtype)


def cast_model_to_bf16(layer):
    """Cast a dygraph model's floating parameters to bfloat16, in place
    (for inference); returns the model."""
    with torch.no_grad():
        for p in layer.parameters():
            if p.is_floating_point():
                p.data = p.data.to(torch.bfloat16)
    return layer
