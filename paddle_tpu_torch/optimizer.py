"""Optimizers of the port (counterpart of paddle_tpu/optimizer.py). Only
Adam is ported; it is what the training slice (BERT pretraining) runs."""
from __future__ import annotations

import torch

from .ops.optimizer_ops import multi_tensor_adam

__all__ = ['AdamOptimizer', 'Adam']


class AdamOptimizer:
    """``AdamOptimizer(learning_rate, beta1, beta2, epsilon,
    parameter_list=)``: Paddle's Adam (ops/optimizer_ops.py:adam) with the
    slots ``moment1``, ``moment2`` (zeros like the parameter, f32) and
    ``beta1_pow``, ``beta2_pow`` ((1,) f32, starting at beta1 and beta2),
    made at a parameter's first update.

    :meth:`step` updates every parameter of ``parameter_list`` that has a
    ``.grad``; :meth:`apply_gradients` updates the parameters it is given
    (the training step passes the layer's). Parameters on one device, of
    one type and with as many updates behind them are updated together by
    ``multi_tensor_adam``, which gives each the bits ``adam`` would.
    ``regularization``, ``grad_clip`` and ``lazy_mode=True`` are not ported
    and raise."""

    _slot_names = ('moment1', 'moment2', 'beta1_pow', 'beta2_pow')

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameter_list=None, regularization=None,
                 grad_clip=None, name=None, lazy_mode=False):
        for what, value in (('regularization', regularization),
                            ('grad_clip', grad_clip)):
            if value is not None:
                raise NotImplementedError(f'{what}= is not ported yet '
                                          f'(ROADMAP queue B)')
        if lazy_mode:
            raise NotImplementedError('lazy_mode=True is not ported yet '
                                      '(ROADMAP queue B)')
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError('learning-rate schedules are not '
                                      'ported yet; pass a number')
        self._learning_rate = float(learning_rate)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._parameter_list = (list(parameter_list) if parameter_list
                                is not None else None)
        self._slots = {}          # id(param) -> {slot name: tensor}
        self._updates = {}        # id(param) -> updates applied so far

    def slots(self, param):
        """The slots of ``param``, made at first use."""
        s = self._slots.get(id(param))
        if s is None:
            f32 = {'dtype': torch.float32, 'device': param.device}
            s = {'moment1': torch.zeros(param.shape, **f32),
                 'moment2': torch.zeros(param.shape, **f32),
                 'beta1_pow': torch.full((1,), self._beta1, **f32),
                 'beta2_pow': torch.full((1,), self._beta2, **f32)}
            self._slots[id(param)] = s
        return s

    def apply_gradients(self, params):
        """One Adam update of every parameter in ``params`` that has a
        gradient, in place."""
        groups = {}
        for p in params:
            if p.grad is not None:
                key = (p.device, p.dtype, self._updates.get(id(p), 0))
                groups.setdefault(key, []).append(p)
        for group in groups.values():
            slots = [self.slots(p) for p in group]
            multi_tensor_adam(
                group, [p.grad for p in group],
                *([s[n] for s in slots] for n in self._slot_names),
                self._learning_rate, beta1=self._beta1, beta2=self._beta2,
                epsilon=self._epsilon)
            for p in group:
                self._updates[id(p)] = self._updates.get(id(p), 0) + 1

    def step(self):
        if self._parameter_list is None:
            raise ValueError('no parameter_list: pass one to the '
                             'constructor or call apply_gradients(params)')
        self.apply_gradients(self._parameter_list)


Adam = AdamOptimizer
