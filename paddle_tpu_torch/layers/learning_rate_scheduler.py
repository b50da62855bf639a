"""Static-graph learning-rate schedules (counterpart of
paddle_tpu/layers/learning_rate_scheduler.py).

Each schedule is ordinary ops over a persistable int64 step counter
(``lr_decay_counter_n``) that starts at ``begin - 1`` and that an
``increment`` op moves in place on every run of the program, so the rate
is computed on the device inside each step and a repeat run lowers
nothing new. The counter is tagged ``belong_to_optimizer``
(``io.is_belong_to_optimizer``). ``piecewise_decay`` is the reference's
branch-free form: the count of boundaries already passed gathers the rate
from a constant table (no control-flow op).

Under a ``dygraph.guard`` each returns the port's dygraph schedule
(dygraph/learning_rate_scheduler.py), as the reference does.
"""
from __future__ import annotations

import math

import numpy as np

from ..core import unique_name
from ..framework import in_dygraph_mode
from .common import apply_op_layer as _op
from .control_flow import greater_equal, increment, less_than
from .tensor import assign, cast, create_global_var, fill_constant

__all__ = ['exponential_decay', 'natural_exp_decay', 'inverse_time_decay',
           'polynomial_decay', 'piecewise_decay', 'noam_decay',
           'cosine_decay', 'linear_lr_warmup']


def _decay_step_counter(begin=0):
    """The counter as f32: ``begin`` on the first run."""
    counter = create_global_var(
        [1], begin - 1, 'int64', persistable=True,
        name=unique_name.generate('lr_decay_counter'))
    counter.belong_to_optimizer = True
    increment(counter, value=1, in_place=True)
    return cast(counter, 'float32')


def _dygraph_sched(cls, *args, **kwargs):
    from ..dygraph import learning_rate_scheduler as imperate_lr
    return getattr(imperate_lr, cls)(*args, **kwargs)


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """lr * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)."""
    if in_dygraph_mode():
        return _dygraph_sched('NoamDecay', d_model, warmup_steps,
                              learning_rate=learning_rate)
    step = _decay_step_counter(begin=1)
    a = _op('pow', {'x': step}, {'factor': -0.5})
    b = (warmup_steps ** -1.5) * step
    return learning_rate * (d_model ** -0.5) * _op('elementwise_min',
                                                   {'x': a, 'y': b})


def _div_steps(step, decay_steps, staircase):
    div = step / float(decay_steps)
    if staircase:
        div = _op('floor', {'x': div})
    return div


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    if in_dygraph_mode():
        return _dygraph_sched('ExponentialDecay', learning_rate, decay_steps,
                              decay_rate, staircase)
    div = _div_steps(_decay_step_counter(), decay_steps, staircase)
    # decay_rate ** div == exp(div * log(decay_rate))
    return learning_rate * _op('exp', {'x': div * math.log(decay_rate)})


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    if in_dygraph_mode():
        return _dygraph_sched('NaturalExpDecay', learning_rate, decay_steps,
                              decay_rate, staircase)
    div = _div_steps(_decay_step_counter(), decay_steps, staircase)
    return learning_rate * _op('exp', {'x': (-1.0 * decay_rate) * div})


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    if in_dygraph_mode():
        return _dygraph_sched('InverseTimeDecay', learning_rate, decay_steps,
                              decay_rate, staircase)
    div = _div_steps(_decay_step_counter(), decay_steps, staircase)
    return learning_rate / (1.0 + decay_rate * div)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    if in_dygraph_mode():
        return _dygraph_sched('PolynomialDecay', learning_rate, decay_steps,
                              end_learning_rate, power, cycle)
    step = _decay_step_counter()
    if cycle:
        mult = _op('ceil', {'x': step / float(decay_steps)})
        mult = _op('elementwise_max', {
            'x': mult, 'y': fill_constant([1], 'float32', 1.0)})
        ds = mult * float(decay_steps)
    else:
        ds = fill_constant([1], 'float32', float(decay_steps))
        step = _op('elementwise_min', {'x': step, 'y': ds})
    frac = _op('pow', {'x': 1.0 - step / ds}, {'factor': float(power)})
    return (learning_rate - end_learning_rate) * frac + end_learning_rate


def piecewise_decay(boundaries, values):
    """``values[i]`` where ``i`` is the count of ``boundaries`` the step
    has reached."""
    if len(values) - len(boundaries) != 1:
        raise ValueError('len(values) must be len(boundaries) + 1')
    if in_dygraph_mode():
        return _dygraph_sched('PiecewiseDecay', boundaries, values, 0)
    step = _decay_step_counter()
    bounds = assign(np.asarray(boundaries, 'float32'))
    table = assign(np.asarray(values, 'float32'))
    passed = cast(greater_equal(step, bounds), 'float32')
    idx = cast(_op('reduce_sum', {'x': passed}, {'keep_dim': True}),
               'int32')
    return _op('gather', {'x': table, 'index': idx})


def cosine_decay(learning_rate, step_each_epoch, epochs):
    if in_dygraph_mode():
        return _dygraph_sched('CosineDecay', learning_rate, step_each_epoch,
                              epochs)
    cur_epoch = _op('floor',
                    {'x': _decay_step_counter() / float(step_each_epoch)})
    return learning_rate * 0.5 * (
        _op('cos', {'x': cur_epoch * (math.pi / epochs)}) + 1.0)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """A linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate`` (a number or a schedule Variable), blended by a
    mask rather than a branch."""
    if in_dygraph_mode():
        return _dygraph_sched('LinearLrWarmup', learning_rate, warmup_steps,
                              start_lr, end_lr)
    step = _decay_step_counter()
    if not hasattr(learning_rate, 'name'):
        learning_rate = fill_constant([1], 'float32', float(learning_rate))
    warm = start_lr + (end_lr - start_lr) * (step / float(warmup_steps))
    in_warmup = cast(less_than(step, fill_constant([1], 'float32',
                                                   float(warmup_steps))),
                     'float32')
    return in_warmup * warm + (1.0 - in_warmup) * learning_rate
