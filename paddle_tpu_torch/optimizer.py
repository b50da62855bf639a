"""Optimizers of the port (counterpart of paddle_tpu/optimizer.py). Momentum
(the ResNet-50 slice) and Adam (the BERT pretraining slice) are ported."""
from __future__ import annotations

import torch

from .ops.optimizer_ops import multi_tensor_adam, multi_tensor_momentum

__all__ = ['MomentumOptimizer', 'Momentum', 'AdamOptimizer', 'Adam']


class _Optimizer:
    """What the ported optimizers share: the constructor's checks, the
    slots (made at a parameter's first update, f32 on its device), and
    :meth:`step` / :meth:`apply_gradients`, which update the parameters
    that have a ``.grad`` in groups of one device and one type through the
    subclass's multi-tensor update. ``regularization``, ``grad_clip`` and
    learning-rate schedules are not ported and raise."""

    _slot_names = ()

    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, grad_clip=None):
        for what, value in (('regularization', regularization),
                            ('grad_clip', grad_clip)):
            if value is not None:
                raise NotImplementedError(f'{what}= is not ported yet '
                                          f'(ROADMAP A.4)')
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError('learning-rate schedules are not '
                                      'ported yet; pass a number')
        self._learning_rate = float(learning_rate)
        self._parameter_list = (list(parameter_list) if parameter_list
                                is not None else None)
        self._slots = {}          # id(param) -> {slot name: tensor}
        self._updates = {}        # id(param) -> updates applied so far

    def _new_slots(self, param):
        raise NotImplementedError

    def _update(self, params, slots):
        """One update of ``params`` (one device, one type, as many updates
        behind each) with their ``slots`` ({name: [tensor per param]})."""
        raise NotImplementedError

    def slots(self, param):
        """The slots of ``param``, made at first use."""
        s = self._slots.get(id(param))
        if s is None:
            s = self._slots[id(param)] = self._new_slots(param)
        return s

    def apply_gradients(self, params):
        """One update of every parameter in ``params`` that has a
        gradient, in place."""
        groups = {}
        for p in params:
            if p.grad is not None:
                key = (p.device, p.dtype, self._updates.get(id(p), 0))
                groups.setdefault(key, []).append(p)
        for group in groups.values():
            slots = [self.slots(p) for p in group]
            self._update(group, {n: [s[n] for s in slots]
                                 for n in self._slot_names})
            for p in group:
                self._updates[id(p)] = self._updates.get(id(p), 0) + 1

    def step(self):
        if self._parameter_list is None:
            raise ValueError('no parameter_list: pass one to the '
                             'constructor or call apply_gradients(params)')
        self.apply_gradients(self._parameter_list)


class MomentumOptimizer(_Optimizer):
    """``MomentumOptimizer(learning_rate, momentum=0.9, use_nesterov=False,
    parameter_list=)``: Paddle's momentum (ops/optimizer_ops.py:momentum)
    with the slot ``velocity`` (zeros like the parameter, f32), updated by
    ``multi_tensor_momentum``, which gives each parameter the bits
    ``momentum`` would."""

    _slot_names = ('velocity',)

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 parameter_list=None, regularization=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)

    def _new_slots(self, param):
        return {'velocity': torch.zeros(param.shape, dtype=torch.float32,
                                        device=param.device)}

    def _update(self, params, slots):
        multi_tensor_momentum(params, [p.grad for p in params],
                              slots['velocity'], self._learning_rate,
                              mu=self._momentum,
                              use_nesterov=self._use_nesterov)


class AdamOptimizer(_Optimizer):
    """``AdamOptimizer(learning_rate, beta1, beta2, epsilon,
    parameter_list=)``: Paddle's Adam (ops/optimizer_ops.py:adam) with the
    slots ``moment1``, ``moment2`` (zeros like the parameter, f32) and
    ``beta1_pow``, ``beta2_pow`` ((1,) f32, starting at beta1 and beta2).
    Parameters with as many updates behind them are updated together by
    ``multi_tensor_adam``, which gives each the bits ``adam`` would.
    ``lazy_mode=True`` is not ported and raises."""

    _slot_names = ('moment1', 'moment2', 'beta1_pow', 'beta2_pow')

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameter_list=None, regularization=None,
                 grad_clip=None, name=None, lazy_mode=False):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        if lazy_mode:
            raise NotImplementedError('lazy_mode=True is not ported yet '
                                      '(ROADMAP A.4)')
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)

    def _new_slots(self, param):
        f32 = {'dtype': torch.float32, 'device': param.device}
        return {'moment1': torch.zeros(param.shape, **f32),
                'moment2': torch.zeros(param.shape, **f32),
                'beta1_pow': torch.full((1,), self._beta1, **f32),
                'beta2_pow': torch.full((1,), self._beta2, **f32)}

    def _update(self, params, slots):
        multi_tensor_adam(params, [p.grad for p in params],
                          *(slots[n] for n in self._slot_names),
                          self._learning_rate, beta1=self._beta1,
                          beta2=self._beta2, epsilon=self._epsilon)


Momentum = MomentumOptimizer
Adam = AdamOptimizer
