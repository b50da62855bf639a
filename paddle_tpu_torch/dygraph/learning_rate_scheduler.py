"""Dygraph learning-rate schedules (counterpart of
paddle_tpu/dygraph/learning_rate_scheduler.py).

A schedule is host arithmetic on its step count: ``schedule()`` is the
rate of the current step as a float and ``step()`` moves it on. The
optimizers (optimizer.py) read it once a ``minimize`` (and a ``TrainStep``
call) and step it after the update, as the reference's do.
"""
from __future__ import annotations

import math

__all__ = ['LearningRateDecay', 'PiecewiseDecay', 'NaturalExpDecay',
           'ExponentialDecay', 'InverseTimeDecay', 'PolynomialDecay',
           'CosineDecay', 'LinearLrWarmup', 'NoamDecay']


class LearningRateDecay:
    def __init__(self, begin=0, step=1, dtype='float32'):
        self.step_num = begin
        self.step_size = step

    def __call__(self):
        return self.create_lr_var(self.step_num)

    def step(self):
        self.step_num += self.step_size

    def create_lr_var(self, step_num):
        raise NotImplementedError


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin=0, step=1, dtype='float32'):
        super().__init__(begin, step)
        self.boundaries = boundaries
        self.values = values

    def create_lr_var(self, n):
        for b, v in zip(self.boundaries, self.values):
            if n < b:
                return v
        return self.values[len(self.boundaries)]


class _DecayByRate(LearningRateDecay):
    """What the natural-exp, exponential and inverse-time schedules share:
    ``t = n / decay_steps`` (floored with ``staircase``)."""

    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype='float32'):
        super().__init__(begin, step)
        self.lr, self.decay_steps = learning_rate, decay_steps
        self.decay_rate, self.staircase = decay_rate, staircase

    def _t(self, n):
        t = n / self.decay_steps
        return math.floor(t) if self.staircase else t


class NaturalExpDecay(_DecayByRate):
    def create_lr_var(self, n):
        return self.lr * math.exp(-self.decay_rate * self._t(n))


class ExponentialDecay(_DecayByRate):
    def create_lr_var(self, n):
        return self.lr * (self.decay_rate ** self._t(n))


class InverseTimeDecay(_DecayByRate):
    def create_lr_var(self, n):
        return self.lr / (1 + self.decay_rate * self._t(n))


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=0.0001,
                 power=1.0, cycle=False, begin=0, step=1, dtype='float32'):
        super().__init__(begin, step)
        self.lr, self.decay_steps = learning_rate, decay_steps
        self.end_lr, self.power, self.cycle = end_learning_rate, power, cycle

    def create_lr_var(self, n):
        ds = self.decay_steps
        if self.cycle:
            ds = ds * max(1.0, math.ceil(n / ds))
        else:
            n = min(n, ds)
        return ((self.lr - self.end_lr) * ((1 - n / ds) ** self.power)
                + self.end_lr)


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1, dtype='float32'):
        super().__init__(begin, step)
        self.lr = learning_rate
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def create_lr_var(self, n):
        cur_epoch = math.floor(n / self.step_each_epoch)
        return self.lr * 0.5 * (math.cos(cur_epoch * math.pi / self.epochs)
                                + 1)


class LinearLrWarmup(LearningRateDecay):
    """A linear ramp from ``start_lr`` to ``end_lr`` over ``warmup_steps``,
    then ``learning_rate`` (a number or a schedule, stepped along)."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 begin=1, step=1, dtype='float32'):
        super().__init__(begin, step)
        self.lr = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr, self.end_lr = start_lr, end_lr

    def step(self):
        super().step()
        if isinstance(self.lr, LearningRateDecay):
            self.lr.step()

    def create_lr_var(self, n):
        if n < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * (
                n / self.warmup_steps)
        lr = self.lr
        return (lr.create_lr_var(lr.step_num)
                if isinstance(lr, LearningRateDecay) else lr)


class NoamDecay(LearningRateDecay):
    """``learning_rate * d_model**-0.5 * min(n**-0.5,
    warmup_steps**-1.5 * n)``, from step 1."""

    def __init__(self, d_model, warmup_steps, begin=1, step=1,
                 dtype='float32', learning_rate=1.0):
        super().__init__(begin, step)
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        self.base_lr = learning_rate

    def create_lr_var(self, n):
        n = max(n, 1)
        a = n ** -0.5
        b = self.warmup_steps ** -1.5 * n
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)
