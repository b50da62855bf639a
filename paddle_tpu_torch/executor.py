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

The control-flow ops run their sub-blocks in Python (counterparts of the
JAX package's ``lax.cond``/``switch``/``while_loop``/``scan`` lowerings,
``paddle_tpu/executor.py:166-358``). Each sub-block's ops are resolved
once a lowering, as the plan's own are, and run over a local env chained
onto the outer one, so a branch or a step reads the outer variables
undeclared:

- ``__cond__`` and ``__switch__`` read the predicate or the index on the
  host (one sync each on the card) and run one branch; the ``writes`` it
  made to outer variables merge out of it, an outer value passing
  through where the branch left it alone;
- ``__while__`` and ``__while_legacy__`` read their condition on the host
  each trip. With ``max_trip_count`` a ``__while__`` stops at the first
  false or at the bound and autograd records its trips, which equals the
  JAX package's masked scan in values and gradients; without one, a loop
  whose carry requires grad raises, as ``jax.grad`` of a ``while_loop``
  does;
- ``__scan__`` (``StaticRNN``) is a Python loop over the leading dim of
  its sequence inputs: the memories are carried, each step's outputs
  collected and stacked once at the end, and autograd records the loop,
  so a weight the step reads accumulates its gradient across steps;
- every loop carry keeps its shape and type or raises ``TypeError``;
- an op that draws random numbers draws anew each trip from the plan's
  generator (a dropout mask a step);
- a tensor array (``__create_array__``) is a Python list in the env.

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

Before a plan is built, the IR pass pipeline (ir/) rewrites a clone of the
program: constant folding and dead-op elimination always, the fused
(add, activation) op and the multi-tensor optimizer ops where the
``BuildStrategy`` asks for them, all of it as ``PADDLE_TPU_PASSES``
selects (``0`` turns it off). The plan key holds the selection
(``ir.pipeline_signature``), so a flipped knob builds a new plan. The
passes keep what the run fetches; a later run that fetches a value they
removed builds the plan again, for the fetches of both runs.

A plan frees what it no longer needs (ROADMAP A.8f): when it is built it
finds each name's last reader (sub-block reads counted, as DCE counts
them), and a run drops the name from its env after that op, except the
fetches, the state, the marker's loss and targets and the recompute
checkpoints. Autograd keeps what it saved; only the plan's own references
go, so the forward's values can be freed as the backward consumes them.

The new value of a persistable is written into the tensor the scope holds
(one ``torch._foreach_copy_`` a type), where shape, type and device
agree, so the state keeps its memory from step to step, unless
``PADDLE_TPU_DONATE=0``, or the program is a ``CompiledProgram`` with
``enable_inplace=False`` or ``memory_optimize=False`` (the JAX package's
switches for its buffer donation). A value that left the executor keeps
its contents, as the JAX package's arrays do: a tensor the scope's public
accessors handed out (core/scope.py), a fetched one, a feed, and any
tensor sharing memory with one of them or with another state name is
never written in place; its successor is a new tensor, as before.

A program that static AMP decorated (``program._amp_config``,
contrib/mixed_precision.py) runs under the reference's casts
(``_amp_cast_args``), each op's resolved once a lowering, in sub-blocks
too: a white-list op's floating inputs are cast to the AMP type, a
black-list op's to f32, and any other op whose floating inputs differ in
type computes in their promoted type, as ``jnp`` promotes (torch keeps a
bf16 tensor's type against an f32 0-d tensor, and its products refuse
mixed types). Integer inputs are never cast; the master parameters stay
f32 in the scope, and their gradients come back f32 through the casts.

A backward marker with ``checkpoints`` (``RecomputeOptimizer``) splits
the forward at the ops that produce them, as the JAX package's
``_remat_segments`` does: each segment runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` over a local
env, from a snapshot of the outer values it reads, and passes out only
what later ops, the loss, the fetches, the state writes and the
checkpoints read (the JAX package's ``live_after``). Its recompute in the
backward restores the plan's generator to where the segment first drew,
so it draws the same dropout masks, and puts it back afterwards.

With ``FLAGS_check_nan_inf`` (debugging.py), ``run`` tests each fetched
float tensor with one ``isfinite().all()`` on the device, all of them read
in one copy, before any fetch goes to the host; a non-finite one raises
``FloatingPointError`` naming it, after the step's state is written, as
the JAX package's fetch scan does. With the check off nothing more runs.

Not ported yet, and each raises ``NotImplementedError`` naming its ROADMAP
item: pipeline plans and the fleet mesh (A.9), the dataset runs and
asynchronous fetches (A.11).
"""
from __future__ import annotations

import functools
import os
from collections import Counter

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import ir
from . import observability as _obs
from .compiler import CompiledProgram
from .core.dtypes import to_numpy_dtype, to_torch_dtype
from .core.places import get_device
from .core.random import default_generator
from .core.scope import global_scope, handed_out, mark_handed_out
from .debugging import check_nan_inf_enabled, check_numerics
from .framework import (BACKWARD_OP_TYPE, Variable, default_main_program,
                        op_read_names)
from .ops.registry import NON_KERNEL_ATTRS, get_op

__all__ = ['Executor']

def _check_ported(program):
    """Raise on what a program may ask of the JAX package's executor that
    the port does not do yet."""
    for b in program.blocks:
        for op in b.ops:
            if op.type == BACKWARD_OP_TYPE:
                if op.attrs.get('pipeline'):
                    raise NotImplementedError(
                        'pipeline plans are not ported yet (ROADMAP A.9)')
                if op.attrs.get('sparse_params'):
                    raise NotImplementedError(
                        'rows-only embedding gradients are not ported yet '
                        '(ROADMAP A.10)')
    if (getattr(program, '_fsdp_axis', None) is not None
            or getattr(program, '_partition_params', False)):
        raise NotImplementedError('the fleet mesh (partitioned state) is '
                                  'not ported yet (ROADMAP A.9)')


def _check_env():
    if os.environ.get('PADDLE_TPU_ASYNC', '0') not in ('', '0'):
        raise NotImplementedError('asynchronous fetches (PADDLE_TPU_ASYNC) '
                                  'are not ported yet (ROADMAP A.11)')


def _check_fetches_finite(fetch_names, fetches):
    """``FLAGS_check_nan_inf``: raise ``FloatingPointError`` naming each
    fetched float tensor that holds NaN or Inf."""
    floats = [(n, f) for n, f in zip(fetch_names, fetches)
              if f.is_floating_point()]
    if not floats:
        return
    finite = torch.stack([torch.isfinite(f).all() for _, f in floats])
    bad = {n: f for (n, f), ok in zip(floats, finite.tolist()) if not ok}
    if bad:
        # the detections land in telemetry before the raise, so a NaN
        # storm is a series and not only the first traceback
        _obs.inc('nonfinite_detections', len(bad),
                 help='fetched variables containing NaN/Inf '
                      '(FLAGS_check_nan_inf)')
        _obs.instant('nonfinite_detected', variables=','.join(bad))
        check_numerics(bad, 'fetches')


# the cast of an AMP program's op in neither list: its floating inputs to
# their promoted type, where they differ
_PROMOTE = 'promote'


def _amp_target(op_type, amp):
    """What an AMP program casts ``op_type``'s floating inputs to: the AMP
    type (white list), f32 (black list) or their promoted type; None
    without AMP."""
    if amp is None:
        return None
    if op_type in amp['white']:
        return amp['dtype']
    if op_type in amp['black']:
        return torch.float32
    return _PROMOTE


def _amp_cast_args(args, target):
    """``args`` (tensors, lists of them, None) with every floating tensor
    cast to ``target``; for ``_PROMOTE``, to the promoted type of the
    floating tensors, where they differ."""
    if target is _PROMOTE:
        types = {t.dtype for a in args
                 for t in (a if isinstance(a, list) else (a,))
                 if isinstance(t, torch.Tensor) and t.is_floating_point()}
        if len(types) < 2:
            return args
        target = functools.reduce(torch.promote_types, types)

    def cast(a):
        if isinstance(a, list):
            return [cast(x) for x in a]
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.to(target)
        return a

    return [cast(a) for a in args]


class _Step:
    """One op, resolved: its function, the names it reads (one entry an
    input slot: None, a name, or a list for a variadic slot), its attrs,
    the names it writes (one list an output slot) and, in an AMP program,
    what its floating inputs are cast to."""

    __slots__ = ('type', 'fn', 'args', 'attrs', 'outs', 'needs_rng',
                 'no_inputs', 'single', 'atomic', 'amp')

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
        self.amp = _amp_target(op.type,
                               getattr(op.block.program, '_amp_config', None))

    def run(self, read, env, device, generator):
        args = [None if a is None else
                [read(n) for n in a] if isinstance(a, list) else read(a)
                for a in self.args]
        if self.amp is not None:
            args = _amp_cast_args(args, self.amp)
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
            # every run hands out this one tensor: never written in place
            self.tensor = mark_handed_out(torch.from_numpy(
                np.ascontiguousarray(self.value)).to(device))
        env[self.out] = self.tensor


def _step(op):
    if op.type == '__constant__':
        return _Constant(op)
    cf = _CONTROL_FLOW.get(op.type)
    return _Step(op) if cf is None else cf(op)


def _block_steps(op, idx):
    """The ops of ``op``'s sub-block ``idx``, resolved."""
    return [_step(o) for o in op.block.program.block(idx).ops]


def _run_block(steps, overrides, read, device, generator):
    """Run resolved ops over a local env that starts from ``overrides``
    and reads on into the outer ``read``; returns the chained read."""
    local = dict(overrides)

    def read2(name):
        v = local.get(name)
        return read(name) if v is None else v

    for s in steps:
        s.run(read2, local, device, generator)
    return read2


def _run_branch(branch, outs, read, env, device, generator):
    """Run a branch, ``(resolved ops, the names it gives out)``, and
    write what it gives out under ``outs``: its outputs, then the outer
    variables it may have written (their outer values where it did
    not)."""
    steps, names = branch
    read2 = _run_block(steps, {}, read, device, generator)
    for n, src in zip(outs, names):
        env[n] = read2(src)


def _as_bool(x):
    return bool(x.reshape(()).item())


def _check_carry(new, init, name):
    """Loop carries keep their shape and type: raise rather than cast
    (a silent cast would floor a float update into an int carry)."""
    if new.shape != init.shape or new.dtype != init.dtype:
        raise TypeError(
            f"while loop carry '{name}' changed from "
            f"{tuple(init.shape)}/{init.dtype} to "
            f"{tuple(new.shape)}/{new.dtype}; loop variables must keep a "
            f"fixed shape and dtype across iterations")
    return new


def _check_differentiable(carry, names):
    """An unbounded loop has no reverse pass: refuse a carry that
    requires grad, as ``jax.grad`` of a ``lax.while_loop`` does."""
    if torch.is_grad_enabled():
        for n, c in zip(names, carry):
            if c.requires_grad:
                raise ValueError(
                    f"reverse-mode differentiation through a while loop "
                    f"without a trip bound: carry '{n}' requires grad; "
                    f"give while_loop a maximum_trip_count")


class _Cond:
    """``__cond__``: one of two branches, chosen on the host."""

    __slots__ = ('pred', 'branches', 'outs')

    def __init__(self, op):
        a = op.attrs
        writes = list(a.get('writes', []))
        self.pred = op.inputs['Cond'][0]
        self.branches = {
            True: (_block_steps(op, a['true_block']),
                   list(a['true_outs']) + writes),
            False: (_block_steps(op, a['false_block']),
                    list(a['false_outs']) + writes)}
        self.outs = op.outputs['Out']

    def run(self, read, env, device, generator):
        _run_branch(self.branches[_as_bool(read(self.pred))], self.outs,
                    read, env, device, generator)


class _Switch:
    """``__switch__``: the branch whose key equals the index, else the
    default (the last branch)."""

    __slots__ = ('index', 'position', 'branches', 'outs')

    def __init__(self, op):
        a = op.attrs
        writes = list(a.get('writes', []))
        self.index = op.inputs['Index'][0]
        self.position = {int(k): i for i, k in enumerate(a['keys'])}
        self.branches = [(_block_steps(op, b), list(outs) + writes)
                         for b, outs in zip(a['blocks'], a['branch_outs'])]
        self.outs = op.outputs['Out']

    def run(self, read, env, device, generator):
        i = int(read(self.index).reshape(()).item())
        _run_branch(self.branches[self.position.get(i, len(self.position))],
                    self.outs, read, env, device, generator)


class _While:
    """``__while__`` (``while_loop``): the condition block and the body
    block, each over the carry, until the condition reads false or the
    trip bound is reached."""

    __slots__ = ('carry', 'cond', 'cond_out', 'body', 'body_outs',
                 'max_trips', 'outs')

    def __init__(self, op):
        a = op.attrs
        writes = list(a.get('writes', []))
        self.carry = list(a['loop_vars']) + writes
        self.cond = _block_steps(op, a['cond_block'])
        self.cond_out = a['cond_out']
        self.body = _block_steps(op, a['body_block'])
        self.body_outs = list(a['body_outs']) + writes
        self.max_trips = a.get('max_trip_count')
        self.outs = op.outputs['Out']

    def run(self, read, env, device, generator):
        carry = [read(n) for n in self.carry]
        bounded = self.max_trips is not None
        if not bounded:
            _check_differentiable(carry, self.carry)
        trips = 0
        while not bounded or trips < self.max_trips:
            mems = dict(zip(self.carry, carry))
            if not _as_bool(_run_block(self.cond, mems, read, device,
                                       generator)(self.cond_out)):
                break
            read2 = _run_block(self.body, mems, read, device, generator)
            carry = [_check_carry(read2(src), c, n) for src, c, n in
                     zip(self.body_outs, carry, self.carry)]
            if not bounded:
                _check_differentiable(carry, self.carry)
            trips += 1
        for n, v in zip(self.outs, carry):
            env[n] = v


class _WhileLegacy:
    """``__while_legacy__`` (``While``): the body over the carry while
    its first entry, the condition variable, reads true."""

    __slots__ = ('carry', 'body')

    def __init__(self, op):
        self.carry = list(op.attrs['carry'])
        self.body = _block_steps(op, op.attrs['body_block'])

    def run(self, read, env, device, generator):
        carry = [read(n) for n in self.carry]
        _check_differentiable(carry, self.carry)
        while _as_bool(carry[0]):
            read2 = _run_block(self.body, dict(zip(self.carry, carry)),
                               read, device, generator)
            carry = [_check_carry(read2(n), c, n)
                     for n, c in zip(self.carry, carry)]
            _check_differentiable(carry, self.carry)
        for n, v in zip(self.carry, carry):
            env[n] = v


class _Scan:
    """``__scan__`` (``StaticRNN``): the step block once per slice of the
    sequence inputs' leading dim, carrying the memories; each step output
    stacked along a new leading dim."""

    __slots__ = ('xs', 'init', 'step', 'slice_names', 'pre_names',
                 'new_names', 'out_names', 'outs')

    def __init__(self, op):
        a = op.attrs
        self.xs = op.inputs.get('X', [])
        self.init = op.inputs.get('Init', [])
        self.step = _block_steps(op, a['block'])
        self.slice_names = list(a['slice_names'])
        self.pre_names = list(a['pre_names'])
        self.new_names = list(a['new_names'])
        self.out_names = list(a['out_names'])
        self.outs = op.outputs['Out']

    def run(self, read, env, device, generator):
        xs = [torch.unbind(read(n), 0) for n in self.xs]
        mems = [read(n) for n in self.init]
        ys = [[] for _ in self.out_names]
        for t in range(len(xs[0])):
            overrides = dict(zip(self.pre_names, mems))
            overrides.update((n, x[t]) for n, x in zip(self.slice_names, xs))
            read2 = _run_block(self.step, overrides, read, device, generator)
            mems = [_check_carry(read2(n), m, p) for n, m, p in
                    zip(self.new_names, mems, self.pre_names)]
            for y, n in zip(ys, self.out_names):
                y.append(read2(n))
        for n, y in zip(self.outs, ys):
            env[n] = torch.stack(y)


class _CreateArray:
    """``__create_array__``: an empty tensor array."""

    __slots__ = ('out',)

    def __init__(self, op):
        self.out = op.outputs['Out'][0]

    def run(self, read, env, device, generator):
        env[self.out] = []


_CONTROL_FLOW = {'__cond__': _Cond, '__switch__': _Switch,
                 '__while__': _While, '__while_legacy__': _WhileLegacy,
                 '__scan__': _Scan, '__create_array__': _CreateArray}


def _remat_segments(fwd_ops, checkpoints):
    """The forward's ``(lo, hi)`` op ranges, each ending at an op that
    produces a checkpoint (the JAX package's ``_remat_segments``)."""
    ckpt = set(checkpoints)
    bounds = sorted({i + 1 for i, o in enumerate(fwd_ops)
                     if set(o.output_names()) & ckpt})
    segs, prev = [], 0
    for b in bounds:
        if b > prev:
            segs.append((prev, b))
            prev = b
    if prev < len(fwd_ops):
        segs.append((prev, len(fwd_ops)))
    return segs


class _Segment:
    """A recomputed range of the forward: its ops, the names they read
    (snapshotted at entry from the env and the state, so the recompute
    reads what the first run read even where a later op overwrites a
    name), and the names live after it (without the fetches)."""

    __slots__ = ('steps', 'reads', 'live')

    def __init__(self, steps, reads, live):
        self.steps, self.reads, self.live = steps, reads, live

    def run(self, read, env, state, keep, device, generator):
        """Run under ``checkpoint`` and leave in ``env`` only the names of
        ``keep``; the recompute restores ``generator`` to where the first
        run started and puts it back afterwards."""
        inputs = {}
        for n in self.reads:
            v = env.get(n)
            if v is None:
                v = state.get(n)
            if v is not None:
                inputs[n] = v
        first_state = []

        def body():
            local = {}

            def read2(name):
                v = local.get(name)
                if v is None:
                    v = inputs.get(name)
                return read(name) if v is None else v

            for s in self.steps:
                s.run(read2, local, device, generator)
            return {n: v for n, v in local.items() if n in keep}

        def seg():
            if not first_state:
                first_state.append(generator.get_state())
                return body()
            now = generator.get_state()
            generator.set_state(first_state[0])
            try:
                return body()
            finally:
                generator.set_state(now)

        out = checkpoint(seg, use_reentrant=False, preserve_rng_state=False)
        for n in [n for n in env if n not in keep]:
            del env[n]
        env.update(out)


def _env_bytes(env):
    """The bytes of the memory the env's tensors hold, each storage once."""
    seen = {}
    for v in env.values():
        for t in (v if isinstance(v, list) else (v,)):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _free_lists(touched, keep):
    """For each position of ``touched`` (the names each op reads and
    writes, in run order), the names to drop from the env after it: those
    it touches that no later position reads, but ``keep``."""
    last_read = {}
    for k, (reads, _) in enumerate(touched):
        for n in reads:
            last_read[n] = k
    return [tuple(sorted(n for n in reads | writes
                         if last_read.get(n, -1) <= k and n not in keep))
            for k, (reads, writes) in enumerate(touched)]


class _Plan:
    """A lowered program: the ops before the backward marker (with
    checkpoints, as recomputed segments), the marker's loss, targets and
    gradient names, the ops after it, and what to free after each op.
    ``fetch_roots`` are the fetches the passes kept; ``removed`` the names
    the original program writes and this one does not."""

    def __init__(self, program, state_names, fetch_roots=(), removed=()):
        ops = list(program.global_block().ops)
        bwd = next((i for i, op in enumerate(ops)
                    if op.type == BACKWARD_OP_TYPE), None)
        self.state_names = list(state_names)
        self.fetch_roots = frozenset(fetch_roots)
        self.removed = frozenset(removed)
        self.segments = None
        self.env_high_water = None
        keep = set(self.state_names)
        touched = [(op_read_names(op), set(op.output_names())) for op in ops]
        if bwd is None:
            self.fwd = [_step(op) for op in ops]
            self.marker = None
            self.post = []
            self.free_fwd, self.free_post = _free_lists(touched, keep), []
            return
        marker = ops[bwd]
        self.fwd = [_step(op) for op in ops[:bwd]]
        self.marker = (marker.attrs['loss'], list(marker.attrs['params']),
                       list(marker.outputs['Grads']))
        self.post = [_step(op) for op in ops[bwd + 1:]]
        checkpoints = list(marker.attrs.get('checkpoints') or [])
        keep |= {self.marker[0], *self.marker[1], *checkpoints}
        touched[bwd] = ({self.marker[0], *self.marker[1]},
                        set(self.marker[1]) | set(self.marker[2]))
        free = _free_lists(touched, keep)
        self.free_fwd, self.free_post = free[:bwd + 1], free[bwd + 1:]
        if checkpoints:
            self.segments = self._segments(ops[:bwd], ops[bwd + 1:],
                                           checkpoints)

    def _segments(self, fwd_ops, post_ops, checkpoints):
        downstream = set().union(*(op_read_names(o) for o in post_ops))
        downstream |= {self.marker[0], *self.state_names, *checkpoints}
        segments = []
        for lo, hi in _remat_segments(fwd_ops, checkpoints):
            live = set(downstream)
            for o in fwd_ops[hi:]:
                live |= op_read_names(o)
            reads = set().union(*(op_read_names(o) for o in fwd_ops[lo:hi]))
            segments.append(_Segment(self.fwd[lo:hi], reads, live))
        return segments

    def serves(self, fetch_names):
        """Whether the passes kept every name of ``fetch_names``."""
        return not self.removed.intersection(fetch_names)

    def run(self, state, feeds, fetch_names, device, generator,
            watch=False):
        """-> (new state {name: tensor}, [fetched tensor]). With
        ``watch``, ``env_high_water`` is set to the most bytes the env
        held between two ops."""
        env = dict(feeds)
        fetched = set(fetch_names)
        high = [_env_bytes(env)] if watch else None

        def read(name):
            v = env.get(name)
            if v is None:
                v = state.get(name)
                if v is None:
                    raise KeyError(
                        f"variable '{name}' has no value: not a feed, not "
                        f"in scope (did you run the startup program?)")
            return v

        def run_steps(steps, free):
            for s, names in zip(steps, free):
                s.run(read, env, device, generator)
                for n in names:
                    if n not in fetched:
                        env.pop(n, None)
                if watch:
                    high.append(_env_bytes(env))

        if self.marker is None:
            with torch.no_grad():
                run_steps(self.fwd, self.free_fwd)
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
                if self.segments is None:
                    run_steps(self.fwd, self.free_fwd)
                else:
                    pinned = set(feeds) | set(targets) | fetched
                    for seg in self.segments:
                        seg.run(read, env, state, seg.live | pinned,
                                device, generator)
                grads = torch.autograd.grad(env[loss_name].sum(), leaves,
                                            allow_unused=True)
            for n, leaf in zip(targets, leaves):
                env[n] = leaf.detach()
            for gname, leaf, g in zip(grad_names, leaves, grads):
                env[gname] = torch.zeros_like(leaf) if g is None else g
            del leaves, grads
            for n in self.free_fwd[-1]:         # the marker's
                if n not in fetched:
                    env.pop(n, None)
            if watch:
                high.append(_env_bytes(env))
            with torch.no_grad():
                run_steps(self.post, self.free_post)
        if watch:
            self.env_high_water = max(high)
        new_state = {}
        for n in self.state_names:
            v = env.get(n)
            if v is not None:
                new_state[n] = v.detach() if v.requires_grad else v
        fetches = [new_state[n] if n in new_state else read(n).detach()
                   for n in fetch_names]
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
        # set True to record each plan's env high-water (``_Plan.run``'s
        # ``watch``); read with :meth:`_env_high_water`
        self._watch_env = False
        self._step_counter = 0

    @property
    def device(self):
        return self._device

    def lowering_count(self, program=None):
        """How many times ``program`` (every program, if None) was lowered
        by this executor."""
        if program is None:
            return sum(self._lowerings.values())
        return self._lowerings[program._id]

    def _env_high_water(self, program, build_strategy=None):
        """The most bytes the env of ``program``'s plan (under
        ``build_strategy``'s pipeline) held between two ops in its last
        run with ``_watch_env`` on; None if there was none."""
        sig = ir.pipeline_signature(build_strategy)
        plans = [p for k, p in self._cache.items()
                 if k[:2] == (program._id, program._version) and k[3] == sig]
        return plans[-1].env_high_water if plans else None

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True, feed_var_name='feed',
            fetch_var_name='fetch'):
        """Run ``program`` (a Program or a ``CompiledProgram``; the
        default main program if None) once on ``feed`` ({name: array});
        returns the values of ``fetch_list`` (Variables or names), numpy
        arrays by default (a bf16 value as f32, exactly: numpy has no
        bf16). With ``return_numpy=False`` they are the tensors
        on the device, detached (the JAX package returns ``FetchHandle`` s
        there). ``use_program_cache``, ``feed_var_name`` and
        ``fetch_var_name`` are accepted and ignored, as the JAX package
        ignores them: lowered plans are always cached.

        With telemetry on (``PADDLE_TPU_TELEMETRY``, ``observability``) each
        run is one span tree, ``executor/run`` over ``prepare``, ``lower``
        (a plan built), ``execute``, ``fetch`` and ``check_nan_inf``, and
        counts ``executor_steps`` and the feed and fetch bytes. The spans
        time the host: ``execute`` is the dispatch of the plan's kernels,
        and ``fetch`` waits for the device when it copies to numpy."""
        if not _obs._ENABLED:
            return self._run_impl(program, feed, fetch_list, scope,
                                  return_numpy)
        with _obs.span('executor/run', step=self._step_counter + 1):
            return self._run_impl(program, feed, fetch_list, scope,
                                  return_numpy)

    def _run_impl(self, program, feed, fetch_list, scope, return_numpy):
        _check_env()
        build_strategy = None
        inplace = os.environ.get('PADDLE_TPU_DONATE', '1') != '0'
        if isinstance(program, CompiledProgram):
            build_strategy = program._build_strategy
            inplace = inplace and program._inplace()
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
            with _obs.span('executor/startup'):
                self._run_startup(program, scope)
            return []
        prep_span = _obs.span('executor/prepare')
        prep_span.__enter__()
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        state_names = sorted({v.name for v in program.list_vars()
                              if v.persistable})
        state = {n: self._state_value(scope, n) for n in state_names}
        feeds = {n: self._feed_value(block, n, v)
                 for n, v in (feed or {}).items()}
        key = (program._id, program._version,
               tuple(sorted((n, tuple(v.shape), v.dtype)
                            for n, v in feeds.items())),
               ir.pipeline_signature(build_strategy))
        prep_span.__exit__(None, None, None)
        plan = self._cache.get(key)
        compiled_now = plan is None or not plan.serves(fetch_names)
        lower_span = _obs.span('executor/lower', program=program._id)
        if compiled_now:
            with lower_span:
                roots = set(fetch_names) | (plan.fetch_roots if plan
                                            else set())
                plan = self._cache[key] = self._lower(
                    program, state_names, roots, list(feeds),
                    build_strategy)
            self._lowerings[program._id] += 1
        self._step_counter += 1
        exec_span = _obs.span('executor/execute', compile=compiled_now)
        with exec_span:
            new_state, fetches = plan.run(
                state, feeds, fetch_names, self._device,
                default_generator.generator(self._device),
                watch=self._watch_env)
        fetch_span = _obs.span('executor/fetch')
        with fetch_span:
            self._write_state(scope, state, new_state, feeds, fetch_names,
                              fetches, inplace)
            for f in fetches:
                mark_handed_out(f)
            if return_numpy:
                # numpy has no bf16: such a value comes back as f32, exactly
                result = [(f.float() if f.dtype == torch.bfloat16 else f)
                          .cpu().numpy() for f in fetches]
            else:
                result = fetches
        if fetches and check_nan_inf_enabled():
            with _obs.span('executor/check_nan_inf'):
                _check_fetches_finite(fetch_names, fetches)
        if _obs._ENABLED:
            feed_bytes = sum(v.numel() * v.element_size()
                             for v in feeds.values())
            fetch_bytes = sum(f.numel() * f.element_size() for f in fetches)
            _obs.inc('executor_steps',
                     help='completed Executor.run training/eval steps')
            _obs.inc('executor_feed_bytes', feed_bytes,
                     help='bytes fed into Executor.run')
            _obs.inc('executor_fetch_bytes', fetch_bytes,
                     help='bytes fetched out of Executor.run')
            if compiled_now:
                _obs.observe(
                    'executor_compile_seconds',
                    lower_span.duration + exec_span.duration,
                    help='lower + first-execution time per program+shape '
                         'plan built')
            _obs.log_step(
                kind='executor', step=self._step_counter,
                compiled=compiled_now, feed_bytes=feed_bytes,
                fetch_bytes=fetch_bytes,
                prepare_s=round(prep_span.duration, 6),
                lower_s=round(lower_span.duration, 6),
                execute_s=round(exec_span.duration, 6),
                fetch_s=round(fetch_span.duration, 6))
        return result

    @staticmethod
    def _lower(program, state_names, fetch_roots, feed_names,
               build_strategy):
        """The IR pipeline on a clone of ``program``, then its plan."""
        opt, _ = ir.apply_pipeline(program, fetch_names=sorted(fetch_roots),
                                   feed_names=feed_names,
                                   build_strategy=build_strategy)
        removed = ()
        if opt is not program:
            def written(p):
                return {n for op in p.global_block().ops
                        for n in op.output_names()}
            removed = written(program) - written(opt)
        return _Plan(opt, state_names, fetch_roots, removed)

    @staticmethod
    def _write_state(scope, state, new_state, feeds, fetch_names, fetches,
                     inplace):
        """Give the scope the run's new state: into the tensor it holds
        (``inplace``) where no value outside the scope's one name can see
        that tensor's memory, else as the new tensor. A tensor the scope
        keeps whose memory a fetch or a feed shares is marked as handed
        out, and so is a new one that is fetched or shares the memory of
        one handed out."""
        def mem(t):
            return t.untyped_storage().data_ptr()

        outside = {mem(t) for t in (*feeds.values(), *fetches)}
        old_mem = {n: mem(v) for n, v in state.items()}
        shared = Counter(old_mem.values())
        marked = outside | {old_mem[n] for n, v in state.items()
                            if handed_out(v)}
        held = marked | {mem(v) for v in new_state.values()}
        fetched = set(fetch_names)
        kept = [n for n in state if n not in new_state]
        # (type, device) -> (the scope's tensors, their new values): one
        # multi-tensor copy a type, as a list of mixed types (a schedule's
        # int64 counter among f32 state) copies one tensor at a time
        into = {}
        for n, v in new_state.items():
            old = state[n]
            if v is old or (mem(v) == old_mem[n] and v.shape == old.shape
                            and v.stride() == old.stride()
                            and v.storage_offset() == old.storage_offset()):
                kept.append(n)          # the same tensor's memory
            elif (inplace and n not in fetched and old_mem[n] not in held
                  and shared[old_mem[n]] == 1 and v.shape == old.shape
                  and v.dtype == old.dtype and v.device == old.device):
                dst, src = into.setdefault((old.dtype, old.device), ([], []))
                dst.append(old)
                src.append(v)
            else:
                if n in fetched or mem(v) in marked:
                    mark_handed_out(v)
                scope._put(n, v)
        for dst, src in into.values():
            torch._foreach_copy_(dst, src)
        for n in kept:
            if old_mem[n] in outside:
                mark_handed_out(state[n])

    def _state_value(self, scope, name):
        val = scope._find(name)
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
                v = scope._find(name)
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
                scope._put(v.name, env[v.name])

    def train_from_dataset(self, *args, **kwargs):
        raise NotImplementedError('dataset runs are not ported yet '
                                  '(ROADMAP A.11)')

    infer_from_dataset = train_from_dataset

    def close(self):
        self._cache.clear()
