"""Optimizers of the port (counterpart of paddle_tpu/optimizer.py): SGD,
Momentum (the ResNet-50 slice) and Adam (the BERT pretraining slice), in
both modes.

- Dygraph: ``minimize(loss)`` (or :meth:`step`, or ``TrainStep``) updates
  the trainable parameters that have a ``.grad`` in place, through the
  multi-tensor updates of ops/optimizer_ops.py; slots are kept per
  parameter. ``learning_rate`` is a number or a dygraph schedule
  (dygraph/learning_rate_scheduler.py), read once an update and stepped
  after it; a schedule's rate reaches the update as a 0-d f32 tensor on
  the parameters' device, written with ``fill_`` (no host sync).
  ``regularization=`` (regularizer.py; a parameter's own
  ``ParamAttr(regularizer=)`` wins) and ``grad_clip=`` (clip.py) act on
  the gradients first, in the reference's order: regularize, clip, update
  (``paddle_tpu/optimizer.py`` ``_dygraph_minimize``), leaving ``p.grad``
  as it was. ``state_dict``/``set_dict`` carry the slots by parameter name.
- Static graph: ``minimize`` of a framework ``Variable`` appends the
  backward marker (backward.append_backward), then one update op per
  parameter (``sgd``, ``momentum``, ``adam``) with its slot variables and
  the learning-rate variable, named as the JAX package names them
  (``<param>_moment1_0``, ``learning_rate_0``, ...), each with a Constant
  init op in the startup program. It takes a number as the rate, or a
  static schedule's Variable (layers/learning_rate_scheduler.py). The
  regularizers' and clips' ops go between the backward marker and the
  updates, as the reference appends them; without ``grad_clip=``, a clip
  that ``clip.set_gradient_clip`` recorded on the program applies.

``RecomputeOptimizer`` wraps a static optimizer: its checkpoints go on the
backward marker, and the executor recomputes the forward between them in
the backward.

A ParamAttr ``learning_rate`` other than 1.0 raises (ROADMAP A.4b): the
reference stores it and never applies it (ROADMAP C.4).
"""
from __future__ import annotations

import numpy as np
import torch

from .backward import append_backward
from .clip import append_gradient_clip_ops
from .core import unique_name
from .framework import (Variable, default_main_program,
                        default_startup_program)
from .initializer import ConstantInitializer
from .dygraph.learning_rate_scheduler import LearningRateDecay
from .layers.tensor import create_global_var
from .ops.optimizer_ops import multi_tensor_adam, multi_tensor_momentum
from .ops.registry import get_op
from .regularizer import append_regularization_ops

__all__ = ['SGDOptimizer', 'SGD', 'MomentumOptimizer', 'Momentum',
           'AdamOptimizer', 'Adam', 'RecomputeOptimizer']


def _zeros_like(param):
    """An f32 slot of ``param``'s shape and strides (a transposed Linear
    weight, a channels_last conv weight), so the multi-tensor updates see
    one layout across parameter, gradient and slot and take their fused
    path."""
    return torch.zeros_like(param, dtype=torch.float32,
                            memory_format=torch.preserve_format)


class _Optimizer:
    """What the ported optimizers share: the constructor's checks, the
    slots (made at a parameter's first update, f32 on its device), and
    :meth:`apply_gradients`, which regularizes and clips the gradients of
    the parameters that have a ``.grad`` and updates them in groups of one
    device and one type through the subclass's multi-tensor update."""

    _op_type = None           # the static graph's update op
    _slot_names = ()

    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, grad_clip=None):
        if isinstance(learning_rate, (LearningRateDecay, Variable)):
            self._learning_rate = learning_rate
        elif isinstance(learning_rate, (int, float)):
            self._learning_rate = float(learning_rate)
        else:
            raise NotImplementedError(
                f'learning_rate must be a number, a static schedule '
                f'Variable or one of the dygraph learning-rate schedules; '
                f'a {type(learning_rate).__name__} is not ported yet '
                f'(ROADMAP A.4)')
        self._parameter_list = (list(parameter_list) if parameter_list
                                is not None else None)
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._slots = {}          # id(param) -> {slot name: tensor}
        self._updates = {}        # id(param) -> updates applied so far
        self._lr_tensors = {}     # device -> 0-d f32 rate of a schedule
        self._global_step = 0
        self._lr_var = None       # the static graph's learning_rate_n

    def _new_slots(self, param):
        raise NotImplementedError

    def _update(self, params, grads, slots, lr):
        """One update of ``params`` (one device, one type, as many updates
        behind each) by ``grads`` with their ``slots`` ({name: [tensor per
        param]}) at rate ``lr`` (a float, or a 0-d tensor on their
        device)."""
        raise NotImplementedError

    def slots(self, param):
        """The slots of ``param``, made at first use."""
        s = self._slots.get(id(param))
        if s is None:
            s = self._slots[id(param)] = self._new_slots(param)
        return s

    @property
    def current_step_lr(self):
        """The rate the next update takes, as a float."""
        lr = self._learning_rate
        return float(lr()) if isinstance(lr, LearningRateDecay) else lr

    def _lr(self, device):
        if isinstance(self._learning_rate, Variable):
            raise TypeError(
                f'the learning rate is the static-graph Variable '
                f'{self._learning_rate.name!r}: a dygraph update takes a '
                f'number or a dygraph schedule')
        if not isinstance(self._learning_rate, LearningRateDecay):
            return self._learning_rate
        t = self._lr_tensors.get(device)
        if t is None:
            t = self._lr_tensors[device] = torch.zeros(
                (), dtype=torch.float32, device=device)
        return t.fill_(self.current_step_lr)

    def apply_gradients(self, params):
        """One update of every parameter in ``params`` that has a gradient
        and is trainable, in place; then a schedule steps. The gradients
        are regularized and clipped on the way, ``p.grad`` left as it
        was. In the static graph ``params`` is ``append_backward``'s
        ``[(param, grad_var)]``, and the regularizers', clips' and update
        ops are appended to the current block instead."""
        if params and isinstance(params[0], tuple) \
                and isinstance(params[0][0], Variable):
            return self._append_static_updates(params)
        params = [p for p in params
                  if p.grad is not None and p.requires_grad]
        for p in params:
            if getattr(p, 'optimize_attr', {}).get('learning_rate',
                                                   1.0) != 1.0:
                raise NotImplementedError(
                    f'{p.name}: a ParamAttr learning rate is not ported '
                    f'yet (ROADMAP A.4b)')
        with torch.no_grad():
            grads = self._regularize(params, [p.grad for p in params])
            if self._grad_clip is not None and grads:
                grads = self._grad_clip.apply_group(grads)
            groups = {}
            for p, g in zip(params, grads):
                key = (p.device, p.dtype, self._updates.get(id(p), 0))
                groups.setdefault(key, []).append((p, g))
            for (device, _, _), group in groups.items():
                ps = [p for p, _ in group]
                slots = [self.slots(p) for p in ps]
                self._update(ps, [g for _, g in group],
                             {n: [s[n] for s in slots]
                              for n in self._slot_names},
                             self._lr(device))
                for p in ps:
                    self._updates[id(p)] = self._updates.get(id(p), 0) + 1
        self._global_step += 1
        self._step_schedule()

    def _step_schedule(self):
        """Step the learning-rate schedule, if the rate is one: after every
        update, and on each call of a gradient merge that makes none
        (``TrainStep``)."""
        if isinstance(self._learning_rate, LearningRateDecay):
            self._learning_rate.step()

    def _regularize(self, params, grads):
        """``grads`` with each parameter's regularizer (its own, else
        ``regularization``) applied, a group of one regularizer at a
        time."""
        groups = {}
        for i, p in enumerate(params):
            reg = getattr(p, 'regularizer', None) or self.regularization
            if reg is not None:
                groups.setdefault(id(reg), (reg, []))[1].append(i)
        grads = list(grads)
        for reg, idx in groups.values():
            out = reg.apply_group([params[i] for i in idx],
                                  [grads[i] for i in idx])
            for i, g in zip(idx, out):
                grads[i] = g
        return grads

    def step(self):
        if self._parameter_list is None:
            raise ValueError('no parameter_list: pass one to the '
                             'constructor or call apply_gradients(params)')
        self.apply_gradients(self._parameter_list)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Static graph (``loss`` a framework Variable): append the
        backward marker and the update ops; returns ``(None,
        [(param, grad_var)])``. Dygraph (``loss`` a tensor whose
        ``backward()`` has run): one update of ``parameter_list`` (the
        constructor's if None); returns ``(None, [(param, grad)])``."""
        if isinstance(loss, Variable):
            return self._static_minimize(loss, parameter_list, no_grad_set)
        params = (list(parameter_list) if parameter_list is not None
                  else self._parameter_list)
        if params is None:
            raise ValueError('no parameter_list: pass one to the '
                             'constructor or to minimize (dygraph '
                             'optimizers take model.parameters())')
        self.apply_gradients(params)
        return None, [(p, p.grad) for p in params if p.grad is not None]

    def clear_gradients(self):
        for p in self._parameter_list or ():
            p.grad = None

    def _named_params(self):
        """(name, param) of the parameter list, a parameter's ``name`` or
        its position."""
        return [(getattr(p, 'name', None) or f'param_{i}', p)
                for i, p in enumerate(self._parameter_list or ())]

    def state_dict(self):
        """``{<param name>_<slot>: tensor}`` of every parameter with slots,
        and ``global_step`` (a (1,) int64 tensor)."""
        state = {}
        for name, p in self._named_params():
            for slot, t in self._slots.get(id(p), {}).items():
                state[f'{name}_{slot}'] = t
        state['global_step'] = torch.tensor([self._global_step])
        return state

    def set_dict(self, state):
        """Load slots (tensors or arrays) by ``state_dict``'s names."""
        step = int(np.asarray(state.get('global_step', [0])).reshape(-1)[0])
        self._global_step = step
        for name, p in self._named_params():
            keys = [f'{name}_{s}' for s in self._slot_names]
            if self._slot_names and all(k in state for k in keys):
                slots = self._new_slots(p)
                for s, k in zip(self._slot_names, keys):
                    slots[s].copy_(torch.as_tensor(state[k]).reshape(
                        slots[s].shape))
                self._slots[id(p)] = slots
                self._updates[id(p)] = step

    set_state_dict = set_dict

    # ---------------------------------------------------------- static graph
    def _hypers(self):
        """The attrs of the update op."""
        return {}

    def _slot_init(self, param_shape):
        """{slot name: (shape, fill value)}: zeros like the parameter."""
        return {s: (param_shape, 0.0) for s in self._slot_names}

    def _parameter_names(self):
        if self._parameter_list is None:
            return None
        return [p if isinstance(p, str) else p.name
                for p in self._parameter_list]

    def _static_minimize(self, loss, parameter_list, no_grad_set):
        names = parameter_list or self._parameter_list
        if names is not None:
            names = [p if isinstance(p, str) else p.name for p in names]
        params_grads = append_backward(loss, names, no_grad_set)
        self._append_static_updates(params_grads)
        return None, params_grads

    def _append_static_updates(self, params_grads):
        """The regularizers' and clips' ops, then one update op a
        parameter, appended to the current block."""
        updates = append_regularization_ops(params_grads,
                                            self.regularization)
        if self._grad_clip is not None:
            updates = self._grad_clip.process(updates)
        else:
            updates = append_gradient_clip_ops(updates)
        lr = self._get_lr_var()
        for p, g in updates:
            self._append_optimize_op(p, g, lr)
        return []

    def _get_lr_var(self):
        """The static graph's rate: the schedule Variable given as
        ``learning_rate``, else a persistable ``learning_rate_n`` holding
        the number."""
        if isinstance(self._learning_rate, Variable):
            return self._learning_rate
        if isinstance(self._learning_rate, LearningRateDecay):
            raise NotImplementedError('a dygraph learning-rate schedule in '
                                      'the static graph is not ported yet '
                                      '(ROADMAP A.4)')
        if self._lr_var is None:
            self._lr_var = create_global_var(
                [1], self._learning_rate, 'float32', persistable=True,
                name=unique_name.generate('learning_rate'))
            self._lr_var.belong_to_optimizer = True
        return self._lr_var

    get_lr_var = _get_lr_var

    def _make_slot_var(self, param, slot, shape, fill):
        name = unique_name.generate(f'{param.name}_{slot}')
        v = default_main_program().global_block().create_var(
            name=name, shape=list(shape), dtype='float32', persistable=True,
            stop_gradient=True)
        sb = default_startup_program().global_block()
        sv = sb.create_var(name=name, shape=list(shape), dtype='float32',
                           persistable=True, stop_gradient=True)
        v.belong_to_optimizer = sv.belong_to_optimizer = True
        ConstantInitializer(fill)(sv, sb)
        return v

    def _append_optimize_op(self, param, grad, lr):
        slots = self._slot_init(list(param.shape))
        slot_vars = [self._make_slot_var(param, s, shp, fill)
                     for s, (shp, fill) in slots.items()]
        inputs = {'param': param.name, 'grad': grad.name}
        for s, v in zip(slots, slot_vars):
            inputs[s] = v.name
        inputs['lr'] = lr.name
        outputs = {'ParamOut': param.name}
        out_slots = get_op(self._op_type).output_slots
        for oslot, v in zip(out_slots[1:], slot_vars):
            outputs[oslot] = v.name
        default_main_program().current_block().append_op(
            type=self._op_type, inputs=inputs, outputs=outputs,
            attrs=self._hypers())


class SGDOptimizer(_Optimizer):
    """``SGDOptimizer(learning_rate, parameter_list=)``: ``p -= lr * g``,
    no slots."""

    _op_type = 'sgd'

    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)

    def _new_slots(self, param):
        return {}

    def _update(self, params, grads, slots, lr):
        torch._foreach_sub_(params, torch._foreach_mul(grads, lr))


class MomentumOptimizer(_Optimizer):
    """``MomentumOptimizer(learning_rate, momentum=0.9, use_nesterov=False,
    parameter_list=)``: Paddle's momentum (ops/optimizer_ops.py:momentum)
    with the slot ``velocity`` (zeros like the parameter, f32), updated by
    ``multi_tensor_momentum``, which gives each parameter the bits
    ``momentum`` would."""

    _op_type = 'momentum'
    _slot_names = ('velocity',)

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 parameter_list=None, regularization=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)

    def _hypers(self):
        return {'mu': self._momentum, 'use_nesterov': self._use_nesterov}

    def _new_slots(self, param):
        return {'velocity': _zeros_like(param)}

    def _update(self, params, grads, slots, lr):
        multi_tensor_momentum(params, grads,
                              slots['velocity'], lr,
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

    _op_type = 'adam'
    _slot_names = ('moment1', 'moment2', 'beta1_pow', 'beta2_pow')

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameter_list=None, regularization=None,
                 grad_clip=None, name=None, lazy_mode=False):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        if lazy_mode:
            raise NotImplementedError('lazy_mode=True is not ported yet '
                                      '(ROADMAP A.4b)')
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)

    def _hypers(self):
        return {'beta1': self._beta1, 'beta2': self._beta2,
                'epsilon': self._epsilon}

    def _slot_init(self, param_shape):
        return {'moment1': (param_shape, 0.0), 'moment2': (param_shape, 0.0),
                'beta1_pow': ([1], self._beta1),
                'beta2_pow': ([1], self._beta2)}

    def _new_slots(self, param):
        f32 = {'dtype': torch.float32, 'device': param.device}
        return {'moment1': _zeros_like(param),
                'moment2': _zeros_like(param),
                'beta1_pow': torch.full((1,), self._beta1, **f32),
                'beta2_pow': torch.full((1,), self._beta2, **f32)}

    def _update(self, params, grads, slots, lr):
        multi_tensor_adam(params, grads,
                          *(slots[n] for n in self._slot_names),
                          lr, beta1=self._beta1,
                          beta2=self._beta2, epsilon=self._epsilon)


class RecomputeOptimizer:
    """``RecomputeOptimizer(optimizer)`` of the static graph: after
    ``_set_checkpoints(names)``, ``minimize`` records the checkpoints on
    the backward marker, and the executor runs the forward in segments
    that end at the ops producing them, each recomputed in the backward
    (executor.py), then appends ``optimizer``'s updates. Every attribute it
    does not define is the inner optimizer's."""

    def __init__(self, optimizer):
        self._inner = optimizer
        self._checkpoints = None

    def __getattr__(self, item):
        if item == '_inner':      # not set yet (copy, unpickling)
            raise AttributeError(item)
        return getattr(self._inner, item)

    def _set_checkpoints(self, checkpoints):
        """Checkpoints as a list or tuple of Variables or names, each name
        once; None clears them."""
        if checkpoints is None:
            self._checkpoints = None
            return
        if not isinstance(checkpoints, (list, tuple)):
            raise ValueError(
                f'RecomputeOptimizer checkpoints must be a list/tuple of '
                f'Variables or var names, got '
                f'{type(checkpoints).__name__}')
        names = []
        for c in checkpoints:
            n = c.name if hasattr(c, 'name') else c
            if not isinstance(n, str):
                raise ValueError(
                    f'RecomputeOptimizer checkpoint entries must be '
                    f'Variables or var names, got {type(c).__name__}: '
                    f'{c!r}')
            names.append(n)
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise ValueError(
                f'RecomputeOptimizer checkpoints contain duplicate '
                f'name(s): {dupes}')
        self._checkpoints = list(checkpoints)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """The backward marker with the checkpoints (each must be a
        variable the program declares), then the inner optimizer's
        updates; returns ``(None, [(param, grad_var)])``."""
        if self._checkpoints:
            names = [c.name if hasattr(c, 'name') else c
                     for c in self._checkpoints]
            program = loss.block.program
            unknown = sorted(
                n for n in names
                if not any(n in b.vars for b in program.blocks))
            if unknown:
                raise ValueError(
                    f'RecomputeOptimizer checkpoints name var(s) the '
                    f'program does not declare: {unknown} (typo, or a '
                    f'var from a different Program?)')
        params_grads = append_backward(
            loss, parameter_list or self._inner._parameter_names(),
            no_grad_set, checkpoints=self._checkpoints)
        self._inner.apply_gradients(params_grads)
        return None, params_grads


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
