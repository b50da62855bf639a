"""Optimizers of the port (counterpart of paddle_tpu/optimizer.py): every
class and alias of the JAX package's, in the modes it runs them in.

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
  as it was. Parameters are updated in groups of one device, one type,
  as many updates behind them and the same hyperparameters
  (``_hypers_for``: LARS and Lamb give the parameters their
  ``exclude_from_weight_decay_fn`` matches a weight decay of 0).
  ``state_dict``/``set_dict`` carry the slots by parameter name, under the
  JAX package's slot names (``_slot_names``).
- Static graph: ``minimize`` of a framework ``Variable`` appends the
  backward marker (backward.append_backward), then one update op per
  parameter (``sgd``, ``momentum``, ``lars_momentum``, ``adam``,
  ``adamax``, ``adagrad``, ``decayed_adagrad``, ``rmsprop``,
  ``adadelta``, ``ftrl``, ``lamb``, ``dpsgd``, ``dgc_momentum``) with its
  slot variables and the learning-rate variable, named as the JAX package
  names them (``<param>_moment1_0``, ``learning_rate_0``, ...), each with a
  Constant init op in the startup program, and the parameter's own
  hyperparameters as its attrs. It takes a number as the rate, or a
  static schedule's Variable (layers/learning_rate_scheduler.py). The
  regularizers' and clips' ops go between the backward marker and the
  updates, as the reference appends them; without ``grad_clip=``, a clip
  that ``clip.set_gradient_clip`` recorded on the program applies.

``RecomputeOptimizer`` wraps a static optimizer: its checkpoints go on the
backward marker, and the executor recomputes the forward between them in
the backward. ``GradientMergeOptimizer`` wraps one too: the gradients add
into persistable accumulators each run, and the inner updates run in a
``cond`` sub-block every ``k_steps``-th. ``LookaheadOptimizer``,
``ModelAverage`` and ``ExponentialMovingAverage`` act on dygraph
parameters, as in the JAX package. ``PipelineOptimizer`` raises naming
ROADMAP A.9.

A ParamAttr ``learning_rate`` other than 1.0 raises: the reference stores
it and never applies it (ROADMAP C.4 item 7).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import _not_ported
from .backward import append_backward
from .clip import append_gradient_clip_ops
from .core import unique_name
from .core.random import default_generator
from .framework import (Variable, default_main_program,
                        default_startup_program)
from .initializer import ConstantInitializer
from .dygraph.learning_rate_scheduler import LearningRateDecay
from .layers.tensor import create_global_var
from .ops import optimizer_ops as _ops
from .ops.registry import get_op
from .regularizer import append_regularization_ops

__all__ = ['SGDOptimizer', 'SGD', 'MomentumOptimizer', 'Momentum',
           'LarsMomentumOptimizer', 'LarsMomentum', 'AdamOptimizer', 'Adam',
           'AdamaxOptimizer', 'Adamax', 'AdagradOptimizer', 'Adagrad',
           'DecayedAdagradOptimizer', 'DecayedAdagrad', 'RMSPropOptimizer',
           'RMSProp', 'AdadeltaOptimizer', 'Adadelta', 'FtrlOptimizer',
           'Ftrl', 'LambOptimizer', 'Lamb', 'DpsgdOptimizer', 'Dpsgd',
           'DGCMomentumOptimizer', 'RecomputeOptimizer', 'ModelAverage',
           'ExponentialMovingAverage', 'LookaheadOptimizer',
           'GradientMergeOptimizer', 'PipelineOptimizer', 'Optimizer']


def _param_key(p):
    """A parameter's name, or its id where it has none (a plain
    ``nn.Parameter``)."""
    return getattr(p, 'name', None) or id(p)


class _Optimizer:
    """What the ported optimizers share: the constructor's checks, the
    slots (made at a parameter's first update, f32 on its device, filled
    as ``_slot_init`` says), and :meth:`apply_gradients`, which
    regularizes and clips the gradients of the parameters that have a
    ``.grad`` and updates them in groups through the subclass's
    multi-tensor update (``_multi_tensor``, ops/optimizer_ops.py)."""

    _op_type = None           # the static graph's update op
    _slot_names = ()          # the slots, in the update op's order
    _has_lr_input = True      # the update reads the rate
    _multi_tensor = None      # the dygraph update over lists, in place

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

    def _hypers(self):
        """The attrs of the update op, and the keywords of its multi-tensor
        form."""
        return {}

    def _hypers_for(self, param):
        """``param``'s own hyperparameters (LARS and Lamb exclude some
        parameters from weight decay); by default the shared ones."""
        return self._hypers()

    def _slot_init(self, param_shape):
        """{slot name: (shape, fill value)}: zeros like the parameter."""
        return {s: (param_shape, 0.0) for s in self._slot_names}

    def _new_slots(self, param):
        """``param``'s slots as ``_slot_init`` makes them, f32 on its
        device; a slot of the parameter's shape takes its strides (a
        transposed Linear weight, a channels_last conv weight), so the
        multi-tensor updates see one layout across parameter, gradient and
        slot and take their fused path."""
        out = {}
        for s, (shape, fill) in self._slot_init(list(param.shape)).items():
            if list(shape) == list(param.shape):
                out[s] = torch.full_like(param, fill, dtype=torch.float32,
                                         memory_format=torch.preserve_format)
            else:
                out[s] = torch.full(shape, fill, dtype=torch.float32,
                                    device=param.device)
        return out

    def _update(self, params, grads, slots, lr, hypers):
        """One update of ``params`` (one device, one type, as many updates
        behind each, the same ``hypers``) by ``grads`` with their ``slots``
        ({name: [tensor per param]}) at rate ``lr`` (a float, or a 0-d
        tensor on their device)."""
        args = [params, grads] + [slots[n] for n in self._slot_names]
        if self._has_lr_input:
            args.append(lr)
        kw = dict(hypers)
        if get_op(self._op_type).needs_rng:
            kw['key'] = default_generator.generator(params[0].device)
        type(self)._multi_tensor(*args, **kw)

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
                    f'{p.name}: a ParamAttr learning rate is not applied: '
                    f'the reference stores it and never applies it '
                    f'(ROADMAP C.4 item 7)')
        with torch.no_grad():
            grads = self._regularize(params, [p.grad for p in params])
            if self._grad_clip is not None and grads:
                grads = self._grad_clip.apply_group(grads)
            groups = {}
            for p, g in zip(params, grads):
                hypers = self._hypers_for(p)
                key = (p.device, p.dtype, self._updates.get(id(p), 0),
                       tuple(sorted(hypers.items())))
                groups.setdefault(key, (hypers, []))[1].append((p, g))
            for (device, _, _, _), (hypers, group) in groups.items():
                ps = [p for p, _ in group]
                slots = [self.slots(p) for p in ps]
                self._update(ps, [g for _, g in group],
                             {n: [s[n] for s in slots]
                              for n in self._slot_names},
                             self._lr(device), hypers)
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
    def _parameter_names(self):
        if self._parameter_list is None:
            return None
        return [p if isinstance(p, str) else p.name
                for p in self._parameter_list]

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        """The backward marker: ``[(param, grad_var)]``."""
        names = parameter_list or self._parameter_list
        if names is not None:
            names = [p if isinstance(p, str) else p.name for p in names]
        return append_backward(loss, names, no_grad_set, callbacks)

    def _static_minimize(self, loss, parameter_list, no_grad_set):
        params_grads = self.backward(loss, None, parameter_list,
                                     no_grad_set)
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

    def _append_optimize_op(self, param, grad, lr, block=None):
        """``param``'s update op in ``block`` (the current one: a gradient
        merge's sub-block puts it in its ``cond``)."""
        slots = self._slot_init(list(param.shape))
        slot_vars = [self._make_slot_var(param, s, shp, fill)
                     for s, (shp, fill) in slots.items()]
        inputs = {'param': param.name, 'grad': grad.name}
        for s, v in zip(slots, slot_vars):
            inputs[s] = v.name
        if self._has_lr_input:
            inputs['lr'] = lr.name
        outputs = {'ParamOut': param.name}
        out_slots = get_op(self._op_type).output_slots
        for oslot, v in zip(out_slots[1:], slot_vars):
            outputs[oslot] = v.name
        block = block or default_main_program().current_block()
        block.append_op(type=self._op_type, inputs=inputs, outputs=outputs,
                        attrs=self._hypers_for(param))


def _excluding_weight_decay(opt, param, key):
    """``opt``'s hyperparameters for ``param``, with ``key`` 0.0 where its
    ``exclude_from_weight_decay_fn`` matches ``param``."""
    h = opt._hypers()
    if opt._exclude_fn is not None and opt._exclude_fn(param):
        h[key] = 0.0
    return h


class SGDOptimizer(_Optimizer):
    """``SGDOptimizer(learning_rate, parameter_list=)``: ``p -= lr * g``,
    no slots."""

    _op_type = 'sgd'

    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)

    def _update(self, params, grads, slots, lr, hypers):
        torch._foreach_sub_(params, torch._foreach_mul(grads, lr))


class MomentumOptimizer(_Optimizer):
    """``MomentumOptimizer(learning_rate, momentum=0.9, use_nesterov=False,
    parameter_list=)``: Paddle's momentum (ops/optimizer_ops.py:momentum)
    with the slot ``velocity`` (zeros like the parameter, f32), updated by
    ``multi_tensor_momentum``, which gives each parameter the bits
    ``momentum`` would."""

    _op_type = 'momentum'
    _slot_names = ('velocity',)
    _multi_tensor = staticmethod(_ops.multi_tensor_momentum)

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 parameter_list=None, regularization=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)

    def _hypers(self):
        return {'mu': self._momentum, 'use_nesterov': self._use_nesterov}


class LarsMomentumOptimizer(_Optimizer):
    """``LarsMomentumOptimizer(learning_rate, momentum=0.9,
    lars_coeff=0.001, lars_weight_decay=0.0005, epsilon=0.0,
    exclude_from_weight_decay_fn=None, parameter_list=)``: LARS
    (ops/optimizer_ops.py:lars_momentum), each parameter's step scaled by
    the ratio of its own norms, with the slot ``velocity``. The parameters
    ``exclude_from_weight_decay_fn`` matches (biases, BatchNorm's scale
    and shift in the ResNet recipe) take ``lars_weight_decay`` 0 in their
    own update, in both modes (the fuse pass groups them apart)."""

    _op_type = 'lars_momentum'
    _slot_names = ('velocity',)
    _multi_tensor = staticmethod(_ops.multi_tensor_lars_momentum)

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=0.0,
                 exclude_from_weight_decay_fn=None, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _hypers(self):
        return {'mu': self._momentum, 'lars_coeff': self._lars_coeff,
                'lars_weight_decay': self._lars_weight_decay,
                'epsilon': self._epsilon}

    def _hypers_for(self, param):
        return _excluding_weight_decay(self, param, 'lars_weight_decay')


class AdamOptimizer(_Optimizer):
    """``AdamOptimizer(learning_rate, beta1, beta2, epsilon,
    parameter_list=)``: Paddle's Adam (ops/optimizer_ops.py:adam) with the
    slots ``moment1``, ``moment2`` (zeros like the parameter, f32) and
    ``beta1_pow``, ``beta2_pow`` ((1,) f32, starting at beta1 and beta2).
    Parameters with as many updates behind them are updated together by
    ``multi_tensor_adam``, which gives each the bits ``adam`` would.
    ``lazy_mode`` is accepted and ignored, as in the JAX package: the port
    has no sparse gradient yet (ROADMAP A.10), and for a dense gradient
    the lazy update is this one."""

    _op_type = 'adam'
    _slot_names = ('moment1', 'moment2', 'beta1_pow', 'beta2_pow')
    _multi_tensor = staticmethod(_ops.multi_tensor_adam)

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameter_list=None, regularization=None,
                 grad_clip=None, name=None, lazy_mode=False):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)

    def _hypers(self):
        return {'beta1': self._beta1, 'beta2': self._beta2,
                'epsilon': self._epsilon}

    def _slot_init(self, param_shape):
        return {'moment1': (param_shape, 0.0), 'moment2': (param_shape, 0.0),
                'beta1_pow': ([1], self._beta1),
                'beta2_pow': ([1], self._beta2)}


class AdamaxOptimizer(_Optimizer):
    """``AdamaxOptimizer(learning_rate=0.001, beta1=0.9, beta2=0.999,
    epsilon=1e-8)``: slots ``moment``, ``inf_norm`` and ``beta1_pow``."""

    _op_type = 'adamax'
    _slot_names = ('moment', 'inf_norm', 'beta1_pow')
    _multi_tensor = staticmethod(_ops.multi_tensor_adamax)

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameter_list=None, regularization=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _hypers(self):
        return {'beta1': self._beta1, 'beta2': self._beta2,
                'epsilon': self._epsilon}

    def _slot_init(self, param_shape):
        return {'moment': (param_shape, 0.0), 'inf_norm': (param_shape, 0.0),
                'beta1_pow': ([1], self._beta1)}


class AdagradOptimizer(_Optimizer):
    """``AdagradOptimizer(learning_rate, epsilon=1e-6,
    initial_accumulator_value=0.0)``: slot ``moment``, filled with
    ``initial_accumulator_value``."""

    _op_type = 'adagrad'
    _slot_names = ('moment',)
    _multi_tensor = staticmethod(_ops.multi_tensor_adagrad)

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _hypers(self):
        return {'epsilon': self._epsilon}

    def _slot_init(self, param_shape):
        return {'moment': (param_shape, self._init_acc)}


class DecayedAdagradOptimizer(_Optimizer):
    """``DecayedAdagradOptimizer(learning_rate, decay=0.95,
    epsilon=1e-6)``: slot ``moment``."""

    _op_type = 'decayed_adagrad'
    _slot_names = ('moment',)
    _multi_tensor = staticmethod(_ops.multi_tensor_decayed_adagrad)

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 parameter_list=None, regularization=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        self._decay, self._epsilon = decay, epsilon

    def _hypers(self):
        return {'decay': self._decay, 'epsilon': self._epsilon}


class RMSPropOptimizer(_Optimizer):
    """``RMSPropOptimizer(learning_rate, rho=0.95, epsilon=1e-6,
    momentum=0.0, centered=False)``: slots ``mean_square``, ``moment`` and
    ``mean_grad``."""

    _op_type = 'rmsprop'
    _slot_names = ('mean_square', 'moment', 'mean_grad')
    _multi_tensor = staticmethod(_ops.multi_tensor_rmsprop)

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameter_list=None, regularization=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _hypers(self):
        return {'rho': self._rho, 'epsilon': self._epsilon,
                'momentum': self._momentum, 'centered': self._centered}


class AdadeltaOptimizer(_Optimizer):
    """``AdadeltaOptimizer(learning_rate=1.0, epsilon=1e-6, rho=0.95)``:
    slots ``avg_squared_grad`` and ``avg_squared_update``; the update
    reads no rate (the reference's op has no ``lr`` input)."""

    _op_type = 'adadelta'
    _slot_names = ('avg_squared_grad', 'avg_squared_update')
    _has_lr_input = False
    _multi_tensor = staticmethod(_ops.multi_tensor_adadelta)

    def __init__(self, learning_rate=1.0, epsilon=1e-6, rho=0.95,
                 parameter_list=None, regularization=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        self._rho, self._epsilon = rho, epsilon

    def _hypers(self):
        return {'rho': self._rho, 'epsilon': self._epsilon}


class FtrlOptimizer(_Optimizer):
    """``FtrlOptimizer(learning_rate, l1=0.0, l2=0.0, lr_power=-0.5)``:
    slots ``squared_accum`` and ``linear_accum``."""

    _op_type = 'ftrl'
    _slot_names = ('squared_accum', 'linear_accum')
    _multi_tensor = staticmethod(_ops.multi_tensor_ftrl)

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameter_list=None, regularization=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _hypers(self):
        return {'l1': self._l1, 'l2': self._l2, 'lr_power': self._lr_power}


class LambOptimizer(_Optimizer):
    """``LambOptimizer(learning_rate=0.001, lamb_weight_decay=0.01,
    beta1=0.9, beta2=0.999, epsilon=1e-6,
    exclude_from_weight_decay_fn=None)``: LAMB
    (ops/optimizer_ops.py:lamb), Adam's slots; the parameters
    ``exclude_from_weight_decay_fn`` matches (LayerNorm's and the biases,
    as the LAMB paper trains BERT) take a weight decay of 0 in their own
    update, in both modes. Under ``TrainStep(amp_dtype=)`` the trust
    ratio's norms are the f32 masters'."""

    _op_type = 'lamb'
    _slot_names = ('moment1', 'moment2', 'beta1_pow', 'beta2_pow')
    _multi_tensor = staticmethod(_ops.multi_tensor_lamb)

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        self._wd, self._beta1, self._beta2, self._epsilon = \
            lamb_weight_decay, beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _hypers(self):
        return {'weight_decay': self._wd, 'beta1': self._beta1,
                'beta2': self._beta2, 'epsilon': self._epsilon}

    def _hypers_for(self, param):
        return _excluding_weight_decay(self, param, 'weight_decay')

    def _slot_init(self, param_shape):
        return {'moment1': (param_shape, 0.0), 'moment2': (param_shape, 0.0),
                'beta1_pow': ([1], self._beta1),
                'beta2_pow': ([1], self._beta2)}


class DpsgdOptimizer(_Optimizer):
    """``DpsgdOptimizer(learning_rate, clip=10.0, batch_size=16.0,
    sigma=1.0)``: differentially private SGD, no slots; the noise draws
    from the parameters' device generator (core/random.py), in the static
    graph from the executor's."""

    _op_type = 'dpsgd'
    _multi_tensor = staticmethod(_ops.multi_tensor_dpsgd)

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0, sigma=1.0,
                 parameter_list=None, regularization=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _hypers(self):
        return {'clip': self._clip, 'batch_size': self._batch_size,
                'sigma': self._sigma}

    def _append_optimize_op(self, param, grad, lr, block=None):
        # the JAX package appends dpsgd to the global block
        super()._append_optimize_op(
            param, grad, lr, default_main_program().global_block())


class DGCMomentumOptimizer(_Optimizer):
    """``DGCMomentumOptimizer(learning_rate, momentum=0.9,
    rampup_begin_step=0, rampup_step=1, sparsity=(0.999,), ...)``: Deep
    Gradient Compression momentum (ops/optimizer_ops.py:dgc_momentum),
    slots ``velocity`` and ``error``. As in the JAX package the rampup
    arguments are accepted and the sparsity is the list's last value; the
    kept gradient stays dense with zeros."""

    _op_type = 'dgc_momentum'
    _slot_names = ('velocity', 'error')
    _multi_tensor = staticmethod(_ops.multi_tensor_dgc_momentum)

    def __init__(self, learning_rate, momentum=0.9, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 local_grad_clip_norm=None, num_trainers=None,
                 regularization=None, grad_clip=None, name=None,
                 parameter_list=None):
        super().__init__(learning_rate, parameter_list, regularization,
                         grad_clip)
        self._momentum = momentum
        self._sparsity = list(sparsity)[-1] if sparsity else 0.999
        self._use_nesterov = use_nesterov

    def _hypers(self):
        return {'mu': self._momentum, 'sparsity': self._sparsity,
                'use_nesterov': self._use_nesterov}


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


class ModelAverage(_Optimizer):
    """``ModelAverage(average_window_rate=0.15, min_average_window=10000,
    max_average_window=10000)``: a running mean of the parameters, as the
    JAX package keeps it: :meth:`accumulate` after a step folds each
    parameter in (``avg += (p - avg) / n``), :meth:`apply_params` swaps the
    means in (keeping the weights) and :meth:`restore_params` swaps them
    back. The window arguments are accepted and not used, and
    :meth:`apply` is a context that does nothing, as in the JAX package.
    It has no update of its own."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        super().__init__(0.0, parameter_list, regularization, grad_clip)
        self._avgs = {}
        self._n = 0
        self._backup = None

    @torch.no_grad()
    def accumulate(self, parameters):
        self._n += 1
        for p in parameters:
            a = self._avgs.get(_param_key(p))
            self._avgs[_param_key(p)] = (p.detach().clone() if a is None
                                         else a + (p.detach() - a) / self._n)

    def apply(self, executor=None, need_restore=True):
        return contextlib.nullcontext()

    @torch.no_grad()
    def apply_params(self, parameters):
        self._backup = {_param_key(p): p.detach().clone()
                        for p in parameters}
        for p in parameters:
            a = self._avgs.get(_param_key(p))
            if a is not None:
                p.copy_(a)

    @torch.no_grad()
    def restore_params(self, parameters):
        for p in parameters:
            if self._backup and _param_key(p) in self._backup:
                p.copy_(self._backup[_param_key(p)])


class ExponentialMovingAverage:
    """``ExponentialMovingAverage(decay=0.999, thres_steps=None)``: after
    each :meth:`update`, ``ema = d * ema + (1 - d) * p`` with ``d =
    min(decay, (1 + t) / (10 + t))`` at update t (the first update starts
    from the parameter itself); :meth:`apply` swaps the averages in and
    :meth:`restore` swaps the weights back. ``thres_steps`` is accepted
    and not used, as in the JAX package."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._ema = {}
        self._step = 0
        self._backup = None

    @torch.no_grad()
    def update(self, parameters):
        self._step += 1
        d = min(self._decay, (1 + self._step) / (10 + self._step))
        params = list(parameters)
        prev = [self._ema.get(_param_key(p), p.detach()) for p in params]
        new = torch._foreach_mul(prev, d)
        torch._foreach_add_(new, torch._foreach_mul(
            [p.detach() for p in params], 1 - d))
        for p, e in zip(params, new):
            self._ema[_param_key(p)] = e

    @torch.no_grad()
    def apply(self, parameters):
        self._backup = {_param_key(p): p.detach().clone()
                        for p in parameters}
        for p in parameters:
            e = self._ema.get(_param_key(p))
            if e is not None:
                p.copy_(e)

    @torch.no_grad()
    def restore(self, parameters):
        for p in parameters:
            if self._backup and _param_key(p) in self._backup:
                p.copy_(self._backup[_param_key(p)])


class LookaheadOptimizer:
    """``LookaheadOptimizer(inner_optimizer, alpha=0.5, k=5)``: in dygraph,
    every k-th ``minimize`` pulls each parameter to ``slow + alpha * (p -
    slow)`` and keeps that as its slow weight; the slow weight starts at
    the parameter's value at the first pull, as in the JAX package. In a
    static program ``minimize`` is the inner optimizer's."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._slow = {}
        self._step = 0

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        result = self.inner_optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        if not isinstance(loss, Variable):
            self._step += 1
            params = parameter_list or self.inner_optimizer._parameter_list
            if self._step % self.k == 0 and params:
                self._pull(list(params))
        return result

    @torch.no_grad()
    def _pull(self, params):
        slow = [self._slow.get(_param_key(p), p.detach()) for p in params]
        diff = torch._foreach_sub([p.detach() for p in params], slow)
        torch._foreach_mul_(diff, self.alpha)
        new = torch._foreach_add(slow, diff)
        for p, s in zip(params, new):
            self._slow[_param_key(p)] = s
            p.copy_(s)


class GradientMergeOptimizer:
    """``GradientMergeOptimizer(inner_optimizer, k_steps=1, avg=True)`` of
    the static graph: each run adds the gradients into persistable f32
    accumulators (``<param>_grad_merge_n``) and counts the run
    (``grad_merge_counter_n``, from -1); on every ``k_steps``-th run a
    ``cond`` sub-block applies the inner optimizer to the accumulators
    (their mean with ``avg``) and zeroes them, as the JAX package lowers
    it. The passes leave the sub-block's update ops as they are (the fuse
    pass reads the global block alone). In dygraph ``minimize`` raises, as
    in the JAX package; ``TrainStep(accum_steps=)`` is the dygraph merge.
    Every attribute it does not define is the inner optimizer's."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self._inner = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg

    def __getattr__(self, item):
        if item == '_inner':      # not set yet (copy, unpickling)
            raise AttributeError(item)
        return getattr(self._inner, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if not isinstance(loss, Variable):
            raise RuntimeError('GradientMergeOptimizer is a static-graph '
                               'construct (use dygraph grad accumulation)')
        params_grads = self._inner.backward(loss, startup_program,
                                            parameter_list, no_grad_set)
        self.apply_gradients(params_grads)
        return None, params_grads

    def apply_gradients(self, params_grads):
        from .layer_helper import LayerHelper
        from .layers import control_flow as cf
        from .layers import tensor as T
        from .layers.common import apply_op_layer
        k = self.k_steps
        counter = T.create_global_var(
            [1], -1, 'int64', persistable=True,
            name=unique_name.generate('grad_merge_counter'))
        cf.increment(counter, value=1, in_place=True)
        helper = LayerHelper('grad_merge')
        merged = []
        for p, g in params_grads:
            acc = helper.create_global_variable(
                list(p.shape), 'float32', persistable=True,
                name=unique_name.generate(f'{p.name}_grad_merge'))
            sb = helper.startup_program.global_block()
            sv = sb.create_var(name=acc.name, shape=list(p.shape),
                               dtype='float32', persistable=True,
                               stop_gradient=True)
            ConstantInitializer(0.0)(sv, sb)
            helper.append_op(type='elementwise_add',
                             inputs={'x': acc.name, 'y': g.name},
                             outputs={'Out': acc.name}, attrs={})
            merged.append((p, acc))
        mod = apply_op_layer('elementwise_mod',
                             {'x': counter,
                              'y': T.fill_constant([1], 'int64', k)})
        pred = cf.equal(mod, T.fill_constant([1], 'int64', k - 1))

        def apply_block():
            scaled = [(p, apply_op_layer('scale', {'x': acc},
                                         {'scale': 1.0 / k})
                       if self.avg else acc) for p, acc in merged]
            self._inner.apply_gradients(scaled)
            for _, acc in merged:
                helper.append_op(type='scale', inputs={'x': acc.name},
                                 outputs={'Out': acc.name},
                                 attrs={'scale': 0.0})

        cf.cond(pred, apply_block, None)
        return []


# the JAX package's name for the base class
Optimizer = _Optimizer

PipelineOptimizer = _not_ported.stand_in_class('optimizer.PipelineOptimizer',
                                               'A.9')

SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
RMSProp = RMSPropOptimizer
Adadelta = AdadeltaOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
Dpsgd = DpsgdOptimizer
