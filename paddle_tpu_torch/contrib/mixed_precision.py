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

In the static graph, ``minimize`` of a Variable records the cast lists on
the program (``program._amp_config``: the AMP type, the white and the
black list); the executor then casts a white-list op's floating inputs to
that type and a black-list op's to f32 (executor.py), and the master
parameters stay f32 in the scope. bf16 then runs the inner optimizer's
``minimize``. fp16 follows the reference's recipe in the program: the loss
times the persistable ``loss_scaling``, the backward, one
``check_finite_and_unscale`` over every gradient, an in-graph skip counter
(``loss_scaling_skips``), ``update_loss_scaling`` under dynamic scaling
(``loss_scaling_good``/``_bad`` count the steps), and the update inside a
``cond`` on ``logical_not`` of the overflow flag, all on the device; the
``cond`` reads its predicate on the host, one sync a step. On that path
``get_loss_scaling`` and ``overflow_steps`` read the scope.

The reference's ``amp_loss_scale`` gauge and skip counter of its
observability registry wait for ROADMAP A.11.
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


def _scope_value(var, scope):
    """The value of the static graph's ``var`` in ``scope`` (the global
    one if None) as a Python number, or None."""
    if var is None:
        return None
    from ..core.scope import global_scope
    val = (scope if scope is not None else global_scope()).find(var.name)
    return None if val is None else val.reshape(()).item()


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
        self._scale_var = None        # the static graph's loss_scaling
        self._skip_var = None         # and its in-graph skip counter

    def __getattr__(self, item):
        if item == '_inner':      # not set yet (copy, unpickling)
            raise AttributeError(item)
        return getattr(self._inner, item)

    def get_loss_scaling(self, scope=None):
        """The loss scale: the static graph's ``loss_scaling`` from the
        scope (a host read) once ``minimize`` made it, else the dygraph
        gate's."""
        val = _scope_value(self._scale_var, scope)
        return self._loss_scale if val is None else float(val)

    def overflow_steps(self, scope=None):
        """Updates skipped on a non-finite gradient so far: the static
        graph's in-graph counter from the scope (a host read) once
        ``minimize`` made it, else the dygraph gate's count."""
        val = _scope_value(self._skip_var, scope)
        return self._skip_count if val is None else int(val)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..framework import Variable
        if not isinstance(loss, Variable):
            return self._dygraph_minimize(loss, parameter_list)
        program = loss.block.program
        program._amp_config = {
            'dtype': (torch.float16 if self._dtype == 'float16'
                      else torch.bfloat16),
            'white': frozenset(self._amp_lists.white_list),
            'black': frozenset(self._amp_lists.black_list)}
        program._bump_version()
        if self._dtype == 'float16':
            # fp16 always scales (a constant scale without dynamic scaling)
            return self._static_minimize_with_loss_scaling(loss,
                                                           parameter_list)
        return self._inner.minimize(loss, startup_program, parameter_list,
                                    no_grad_set)

    def _static_minimize_with_loss_scaling(self, loss, parameter_list):
        """The reference's fp16 program: scale the loss, the backward, one
        ``check_finite_and_unscale`` over the gradients, the skip counter,
        ``update_loss_scaling`` when dynamic, and the update under
        ``cond(logical_not(found))``."""
        from ..backward import append_backward
        from ..core import unique_name as un
        from ..layer_helper import LayerHelper
        from ..layers import control_flow as cf
        from ..layers import tensor as T
        from ..layers.common import apply_op_layer

        scale_var = T.create_global_var(
            [1], float(self._loss_scale), 'float32', persistable=True,
            name=un.generate('loss_scaling'))
        good = T.create_global_var([1], 0, 'int32', persistable=True,
                                   name=un.generate('loss_scaling_good'))
        bad = T.create_global_var([1], 0, 'int32', persistable=True,
                                  name=un.generate('loss_scaling_bad'))
        self._scale_var = scale_var
        scaled = apply_op_layer('elementwise_mul',
                                {'x': loss, 'y': scale_var})
        params_grads = append_backward(
            scaled, parameter_list or self._inner._parameter_names())

        helper = LayerHelper('amp')
        found = helper.create_variable_for_type_inference('bool')
        found.shape = (1,)
        gnames = [g.name for _, g in params_grads]
        helper.append_op(
            type='check_finite_and_unscale',
            inputs={'xs': gnames, 'scale': scale_var.name},
            outputs={'Out': gnames, 'FoundInfinite': found.name})
        skip_var = T.create_global_var(
            [1], 0, 'int32', persistable=True,
            name=un.generate('loss_scaling_skips'))
        self._skip_var = skip_var
        found_i32 = apply_op_layer('cast', {'x': found}, {'dtype': 'int32'})
        helper.append_op(
            type='elementwise_add',
            inputs={'x': skip_var.name, 'y': found_i32.name},
            outputs={'Out': skip_var.name})
        if self._dynamic:
            helper.append_op(
                type='update_loss_scaling',
                inputs={'found_inf': found.name,
                        'prev_loss_scaling': scale_var.name,
                        'in_good_steps': good.name, 'in_bad_steps': bad.name},
                outputs={'LossScaling': scale_var.name,
                         'OutGoodSteps': good.name, 'OutBadSteps': bad.name},
                attrs={'incr_every_n_steps': self._incr_every,
                       'decr_every_n_nan_or_inf': self._decr_every,
                       'incr_ratio': self._incr_ratio,
                       'decr_ratio': self._decr_ratio})
        ok = apply_op_layer('logical_not', {'x': found})

        def apply_block():
            self._inner.apply_gradients(params_grads)

        cf.cond(ok, apply_block, None)
        return None, params_grads

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
