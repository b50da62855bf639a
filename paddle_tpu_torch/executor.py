"""Executor: runs a static-graph Program with torch (counterpart of
paddle_tpu/executor.py).

A Program is lowered once per (program, version, feed names, shapes and
types): each op's registered function, input and output names and attrs
are resolved into a plan, and the plan is cached, where the JAX package
traces the program into one jitted function. A program edit or a new feed
shape lowers again; a repeat run lowers nothing, whatever it fetches
(:meth:`Executor.lowering_count` counts the lowerings).

Running a plan:

- the persistables come from the scope, and each must already lie on the
  executor's device: a value elsewhere raises and names the variable;
- feeds are coerced to their variables' types and put on the device;
- with a backward marker (backward.append_backward), the ops before it run
  with the parameters (or fed variables) it names as leaf tensors that
  require grad; at the marker ``torch.autograd.grad`` of the summed loss
  gives every ``<name>@GRAD`` (zeros for a parameter the loss does not
  reach, as ``jax.value_and_grad`` gives), and the ops after it (the
  optimizer's) run under ``no_grad``. A program with no marker runs under
  ``no_grad`` throughout;
- ops that draw random numbers get the device's ``torch.Generator``
  (core/random.py);
- every persistable an op wrote goes back to the scope.

A program holding ``__init__`` ops is a startup program: it runs op by op,
unlowered, and writes every persistable it made.

A ``__constant__`` op (``layers.assign`` of a numpy array) is made on the
device once a lowering and read from there on every run. An op that
writes a persistable under its own input's name (``increment`` of a
schedule's step counter) updates the scope through the plan's new state,
so one lowering serves every step. ``run`` takes a
:class:`~paddle_tpu_torch.compiler.CompiledProgram` and runs its program
on this executor's one device, after refusing the strategy knobs the port
does not act on (compiler.py).

Not ported yet, and each raises ``NotImplementedError`` naming its ROADMAP
item: the control-flow ops (A.8a), an AMP program config and
rematerialisation (A.8e), in-place state updates in place of the JAX
package's buffer donation (A.8f), pipeline plans and the fleet mesh (A.9),
the dataset runs and asynchronous fetches (A.11).
"""
from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch

from .compiler import CompiledProgram
from .core.dtypes import to_numpy_dtype, to_torch_dtype
from .core.places import get_device
from .core.random import default_generator
from .core.scope import global_scope
from .framework import BACKWARD_OP_TYPE, Variable, default_main_program
from .ops.registry import NON_KERNEL_ATTRS, get_op

__all__ = ['Executor']

_CONTROL_FLOW_OPS = frozenset({'__create_array__', '__cond__', '__switch__',
                               '__while__', '__while_legacy__', '__scan__'})


def _check_ported(program):
    """Raise on what a program may ask of the JAX package's executor that
    the port does not do yet."""
    for b in program.blocks:
        for op in b.ops:
            if op.type in _CONTROL_FLOW_OPS:
                raise NotImplementedError(
                    f'control-flow op {op.type!r} is not ported yet '
                    f'(ROADMAP A.8a)')
            if op.type == BACKWARD_OP_TYPE:
                if op.attrs.get('checkpoints'):
                    raise NotImplementedError(
                        'rematerialisation (checkpoints) is not ported yet '
                        '(ROADMAP A.8e)')
                if op.attrs.get('pipeline'):
                    raise NotImplementedError(
                        'pipeline plans are not ported yet (ROADMAP A.9)')
                if op.attrs.get('sparse_params'):
                    raise NotImplementedError(
                        'rows-only embedding gradients are not ported yet '
                        '(ROADMAP A.10)')
    if getattr(program, '_amp_config', None) is not None:
        raise NotImplementedError('AMP in the static executor is not ported '
                                  'yet (ROADMAP A.8e)')
    if (getattr(program, '_fsdp_axis', None) is not None
            or getattr(program, '_partition_params', False)):
        raise NotImplementedError('the fleet mesh (partitioned state) is '
                                  'not ported yet (ROADMAP A.9)')


def _check_env():
    if os.environ.get('PADDLE_TPU_ASYNC', '0') not in ('', '0'):
        raise NotImplementedError('asynchronous fetches (PADDLE_TPU_ASYNC) '
                                  'are not ported yet (ROADMAP A.11)')
    if os.environ.get('PADDLE_TPU_DONATE', '0') not in ('', '0'):
        raise NotImplementedError(
            'buffer donation (PADDLE_TPU_DONATE) is not ported yet: the '
            'plan writes new tensors for the state it updates (ROADMAP '
            'A.8f)')


class _Step:
    """One op, resolved: its function, the names it reads (one entry an
    input slot: None, a name, or a list for a variadic slot), its attrs
    and the names it writes (one list an output slot)."""

    __slots__ = ('type', 'fn', 'args', 'attrs', 'outs', 'needs_rng',
                 'no_inputs', 'single', 'atomic')

    def __init__(self, op):
        opdef = get_op(op.type)
        self.type = op.type
        self.fn = opdef.fn
        self.args = []
        for slot in opdef.input_slots:
            names = op.inputs.get(slot, [])
            if not names:
                self.args.append(None)
            elif slot in opdef.variadic:
                self.args.append(list(names))
            else:
                self.args.append(names[0])
        self.attrs = {k: v for k, v in op.attrs.items()
                      if k not in NON_KERNEL_ATTRS}
        self.outs = [op.outputs.get(s, []) for s in opdef.output_slots]
        self.needs_rng = opdef.needs_rng
        self.no_inputs = not opdef.input_slots
        self.single = len(opdef.output_slots) == 1
        self.atomic = opdef.atomic_output

    def run(self, read, env, device, generator):
        args = [None if a is None else
                [read(n) for n in a] if isinstance(a, list) else read(a)
                for a in self.args]
        attrs = ({**self.attrs, 'key': generator} if self.needs_rng
                 else self.attrs)
        try:
            if self.no_inputs:
                # nothing to take a device from: make it on ours
                with torch.device(device):
                    result = self.fn(*args, **attrs)
            else:
                result = self.fn(*args, **attrs)
        except Exception as e:
            e.add_note(f"[while running op '{self.type}']")
            raise
        if self.atomic:
            env[self.outs[0][0]] = result
            return
        for names, res in zip(self.outs,
                              [result] if self.single else result):
            if len(names) == 1:
                env[names[0]] = res
            else:
                for n, r in zip(names, res):
                    env[n] = r


class _Constant:
    """A ``__constant__`` op, resolved: its value, made on the device at
    its first run and kept."""

    __slots__ = ('out', 'value', 'tensor')

    def __init__(self, op):
        self.out = op.outputs['Out'][0]
        self.value = np.asarray(op.attrs['value'])
        self.tensor = None

    def run(self, read, env, device, generator):
        if self.tensor is None:
            self.tensor = torch.from_numpy(
                np.ascontiguousarray(self.value)).to(device)
        env[self.out] = self.tensor


def _step(op):
    return _Constant(op) if op.type == '__constant__' else _Step(op)


class _Plan:
    """A lowered program: the ops before the backward marker, the marker's
    loss, targets and gradient names, and the ops after it."""

    def __init__(self, program, state_names):
        ops = list(program.global_block().ops)
        bwd = next((i for i, op in enumerate(ops)
                    if op.type == BACKWARD_OP_TYPE), None)
        self.state_names = list(state_names)
        if bwd is None:
            self.fwd = [_step(op) for op in ops]
            self.marker = None
            self.post = []
        else:
            marker = ops[bwd]
            self.fwd = [_step(op) for op in ops[:bwd]]
            self.marker = (marker.attrs['loss'], list(marker.attrs['params']),
                           list(marker.outputs['Grads']))
            self.post = [_step(op) for op in ops[bwd + 1:]]

    def run(self, state, feeds, fetch_names, device, generator):
        """-> (new state {name: tensor}, [fetched tensor])."""
        env = dict(feeds)

        def read(name):
            v = env.get(name)
            if v is None:
                v = state.get(name)
                if v is None:
                    raise KeyError(
                        f"variable '{name}' has no value: not a feed, not "
                        f"in scope (did you run the startup program?)")
            return v

        if self.marker is None:
            with torch.no_grad():
                for s in self.fwd:
                    s.run(read, env, device, generator)
        else:
            loss_name, targets, grad_names = self.marker
            leaves = []
            for n in targets:
                src = env.get(n)
                if src is None:
                    src = state.get(n)
                if src is None:
                    raise KeyError(f"gradient target '{n}' is neither a "
                                   f"persistable parameter nor a fed "
                                   f"variable")
                leaf = src.detach().requires_grad_(True)
                env[n] = leaf
                leaves.append(leaf)
            with torch.enable_grad():
                for s in self.fwd:
                    s.run(read, env, device, generator)
                grads = torch.autograd.grad(env[loss_name].sum(), leaves,
                                            allow_unused=True)
            for n, leaf in zip(targets, leaves):
                env[n] = leaf.detach()
            for gname, leaf, g in zip(grad_names, leaves, grads):
                env[gname] = torch.zeros_like(leaf) if g is None else g
            with torch.no_grad():
                for s in self.post:
                    s.run(read, env, device, generator)
        new_state = {n: env[n].detach() for n in self.state_names
                     if n in env}
        fetches = [read(n).detach() for n in fetch_names]
        return new_state, fetches


class Executor:
    """``Executor(place)``: runs programs on the place's device.
    ``CUDAPlace(i)``, ``TPUPlace(i)``, ``XLAPlace(i)`` and ``None`` are the
    card (``None`` the current one), and raise without one; ``CPUPlace()``
    is the CPU, asked for explicitly."""

    def __init__(self, place=None):
        self._device = get_device(place)
        self.place = place
        self._cache = {}
        self._lowerings = Counter()

    @property
    def device(self):
        return self._device

    def lowering_count(self, program=None):
        """How many times ``program`` (every program, if None) was lowered
        by this executor."""
        if program is None:
            return sum(self._lowerings.values())
        return self._lowerings[program._id]

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True, feed_var_name='feed',
            fetch_var_name='fetch'):
        """Run ``program`` (a Program or a ``CompiledProgram``; the
        default main program if None) once on ``feed`` ({name: array});
        returns the values of ``fetch_list`` (Variables or names), numpy
        arrays by default. With ``return_numpy=False`` they are the tensors
        on the device, detached (the JAX package returns ``FetchHandle`` s
        there). ``use_program_cache``, ``feed_var_name`` and
        ``fetch_var_name`` are accepted and ignored, as the JAX package
        ignores them: lowered plans are always cached."""
        _check_env()
        if isinstance(program, CompiledProgram):
            program = program._program_to_run()
        program = program if program is not None else default_main_program()
        if not hasattr(program, 'global_block'):
            raise TypeError(f'Executor.run takes a Program or a '
                            f'CompiledProgram, not a '
                            f'{type(program).__name__}')
        scope = scope if scope is not None else global_scope()
        _check_ported(program)
        block = program.global_block()
        if any(op.type == '__init__' for op in block.ops):
            self._run_startup(program, scope)
            return []
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        state_names = sorted({v.name for v in program.list_vars()
                              if v.persistable})
        state = {n: self._state_value(scope, n) for n in state_names}
        feeds = {n: self._feed_value(block, n, v)
                 for n, v in (feed or {}).items()}
        key = (program._id, program._version,
               tuple(sorted((n, tuple(v.shape), v.dtype)
                            for n, v in feeds.items())))
        plan = self._cache.get(key)
        if plan is None:
            plan = self._cache[key] = _Plan(program, state_names)
            self._lowerings[program._id] += 1
        new_state, fetches = plan.run(
            state, feeds, fetch_names, self._device,
            default_generator.generator(self._device))
        for n, v in new_state.items():
            scope.set(n, v)
        if return_numpy:
            return [f.cpu().numpy() for f in fetches]
        return fetches

    def _state_value(self, scope, name):
        val = scope.find(name)
        if val is None:
            raise RuntimeError(
                f"persistable var '{name}' is uninitialized; run the startup "
                f"program first (exe.run(fluid.default_startup_program()))")
        if not isinstance(val, torch.Tensor):
            raise TypeError(
                f"persistable var '{name}' holds a {type(val).__name__}, not "
                f"a tensor on {self._device}; carry host values in with "
                f"convert.scope_from_paddle")
        if val.device != self._device:
            raise ValueError(
                f"persistable var '{name}' lies on {val.device}, not on the "
                f"executor's {self._device}; nothing is moved between "
                f"devices in silence")
        return val

    def _feed_value(self, block, name, value):
        dtype = block.var(name).dtype if block.has_var(name) else None
        if isinstance(value, torch.Tensor):
            if value.device != self._device:
                raise ValueError(
                    f"feed '{name}' lies on {value.device}, not on the "
                    f"executor's {self._device}")
            return value if dtype is None else value.to(to_torch_dtype(dtype))
        arr = np.asarray(value, None if dtype is None
                         else to_numpy_dtype(dtype))
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self._device)
        return t if dtype is None else t.to(to_torch_dtype(dtype))

    def _run_startup(self, program, scope):
        """Run an init program op by op, on the device, and write every
        persistable it made."""
        gen = default_generator.generator(self._device)
        env = {}

        def read(name):
            v = env.get(name)
            if v is None:
                v = scope.find(name)
                if v is None:
                    raise KeyError(f"startup: uninitialized input '{name}'")
            return v

        with torch.no_grad():
            for op in program.global_block().ops:
                if op.type == '__init__':
                    a = op.attrs
                    env[op.outputs['Out'][0]] = a['initializer'].compute(
                        a['shape'], a['dtype'], self._device, gen)
                else:
                    _step(op).run(read, env, self._device, gen)
        for v in program.list_vars():
            if v.persistable and v.name in env:
                scope.set(v.name, env[v.name])

    def train_from_dataset(self, *args, **kwargs):
        raise NotImplementedError('dataset runs are not ported yet '
                                  '(ROADMAP A.11)')

    infer_from_dataset = train_from_dataset

    def close(self):
        self._cache.clear()
