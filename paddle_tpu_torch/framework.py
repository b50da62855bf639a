"""Static-graph IR of the port: Program / Block / Operator / Variable
(counterpart of paddle_tpu/framework.py).

A Program is a list of ops over named variables. Each op names a function
registered in ops/registry.py; the Executor (executor.py) resolves a
program's ops into a plan once per program version and feed shapes and runs
the plan with torch, autograd taking the place of the JAX package's
``jax.value_and_grad`` at the one backward marker (``BACKWARD_OP_TYPE``)
that backward.append_backward inserts.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Dict, List

from .core import unique_name
from .core.dtypes import convert_dtype
from .core.random import seed as manual_seed

__all__ = ['Variable', 'Parameter', 'Operator', 'Block', 'Program',
           'program_guard', 'default_main_program', 'default_startup_program',
           'switch_main_program', 'switch_startup_program', 'name_scope',
           'in_dygraph_mode', 'manual_seed', 'shape_to_concrete',
           'shape_from_concrete', 'BACKWARD_OP_TYPE']

# the size that stands in for a -1 dim while shapes are inferred on meta
# tensors; an inferred dim equal to it reads back as -1
_DYNAMIC_DIM_SENTINEL = 1999

BACKWARD_OP_TYPE = '__backward__'


# the dygraph Tracer (dygraph/base.py) while a ``dygraph.guard`` is open
_dygraph_tracer_ = None


def in_dygraph_mode():
    """Whether a ``dygraph.guard`` is open: layer functions then run their
    ops eagerly instead of appending them to a program."""
    return _dygraph_tracer_ is not None


def _dygraph_tracer():
    return _dygraph_tracer_


class Variable:
    """A named tensor of a Block."""

    def __init__(self, block, name, shape=None, dtype='float32',
                 persistable=False, stop_gradient=False, is_data=False,
                 lod_level=0, trainable=False, **kwargs):
        self.block = block
        self.name = name
        self.shape = (tuple(int(s) for s in shape) if shape is not None
                      else None)
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.lod_level = lod_level
        self.trainable = trainable

    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    def __repr__(self):
        return (f'Variable(name={self.name}, shape={self.shape}, '
                f'dtype={self.dtype}, persistable={self.persistable})')

    __str__ = __repr__


class Parameter(Variable):
    """A trainable persistable Variable."""

    def __init__(self, block, name, shape, dtype='float32', trainable=True,
                 regularizer=None, learning_rate=1.0, do_model_average=False,
                 **kwargs):
        super().__init__(block, name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=not trainable,
                         trainable=trainable)
        self.regularizer = regularizer
        self.optimize_attr = {'learning_rate': learning_rate}
        self.do_model_average = do_model_average


class Operator:
    """One node of the IR: ``type`` names a registered function;
    ``inputs``/``outputs`` map slot names to lists of variable names."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = {
            k: ([v] if isinstance(v, str) else list(v))
            for k, v in (inputs or {}).items()}
        self.outputs: Dict[str, List[str]] = {
            k: ([v] if isinstance(v, str) else list(v))
            for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name):
        return self.attrs[name]

    def _set_attr(self, name, val):
        self.attrs[name] = val
        self.block.program._bump_version()

    def has_attr(self, name):
        return name in self.attrs

    def __repr__(self):
        return f'{{{self.type}: {self.inputs} -> {self.outputs}}}'


class Block:
    """A list of ops and a dict of vars."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    def create_var(self, name=None, **kwargs):
        if name is None:
            name = unique_name.generate('_generated_var')
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kwargs)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype, **kwargs):
        p = Parameter(self, name, shape, dtype=dtype, **kwargs)
        self.vars[name] = p
        return p

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError(f'var {name} not in block {self.idx}')
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name):
        if name in self.vars:
            return self.vars[name]
        if self.parent_idx >= 0:
            return self.program.block(
                self.parent_idx)._find_var_recursive(name)
        return None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def __repr__(self):
        lines = [f'Block[{self.idx}]']
        lines += ['  ' + repr(v) for v in self.vars.values()]
        lines += ['  ' + repr(op) for op in self.ops]
        return '\n'.join(lines)


class Program:
    """A sequence of blocks, the unit the Executor lowers and runs.

    ``_version`` moves on every edit, so the Executor's cache of lowered
    plans never serves a stale one. ``clone(for_test=True)`` drops the
    backward marker and every op after it and sets ``is_test`` attrs."""

    _COUNTER = 0

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0
        Program._COUNTER += 1
        self._id = Program._COUNTER
        self.random_seed = None

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _bump_version(self):
        self._version += 1

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self):
        return [p for b in self.blocks for p in b.all_parameters()]

    def clone(self, for_test=False):
        p = Program()
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for name, v in b.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            for op in b.ops:
                if for_test and op.type == BACKWARD_OP_TYPE:
                    break           # the marker and everything after it
                nop = Operator(nb, op.type,
                               {k: list(v) for k, v in op.inputs.items()},
                               {k: list(v) for k, v in op.outputs.items()},
                               copy.deepcopy(op.attrs))
                if for_test and 'is_test' in nop.attrs:
                    nop.attrs['is_test'] = True
                nb.ops.append(nop)
            p.blocks.append(nb)
        p.current_block_idx = 0
        p.random_seed = self.random_seed
        if for_test:
            # the dropped tail's vars (@GRAD, optimizer temporaries) go too
            referenced = set()
            for b in p.blocks:
                for op in b.ops:
                    referenced |= set(op.input_names())
                    referenced |= set(op.output_names())
                    for a in ('loss', 'params'):
                        v = op.attrs.get(a)
                        if isinstance(v, str):
                            referenced.add(v)
                        elif isinstance(v, (list, tuple)):
                            referenced.update(x for x in v
                                              if isinstance(x, str))
            for b in p.blocks:
                b.vars = {n: v for n, v in b.vars.items()
                          if n in referenced or v.persistable or v.is_data}
        return p

    def _prune(self, targets):
        """A clone that keeps only the ops needed to compute ``targets``
        (Variables or names)."""
        target_names = {t.name if isinstance(t, Variable) else t
                        for t in targets}
        blk = self.global_block()
        needed = set(target_names)
        kept_idx = set()
        for i in range(len(blk.ops) - 1, -1, -1):
            op = blk.ops[i]
            if op.type == BACKWARD_OP_TYPE:
                continue
            if set(op.output_names()) & needed:
                kept_idx.add(i)
                needed |= set(op.input_names())
        p = self.clone()
        nb = p.global_block()
        # clone() keeps op order 1:1, so positions name the kept ops
        nb.ops = [op for i, op in enumerate(nb.ops) if i in kept_idx]
        used = set(target_names)
        for op in nb.ops:
            used |= set(op.input_names()) | set(op.output_names())
        nb.vars = {k: v for k, v in nb.vars.items()
                   if k in used or v.is_data}
        return p

    def __repr__(self):
        return '\n'.join(repr(b) for b in self.blocks)

    __str__ = __repr__

    def to_string(self, throw_on_error=False, with_details=False):
        return repr(self)


_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program):
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_start = None
    if startup_program is not None:
        old_start = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_start is not None:
            switch_startup_program(old_start)


def shape_to_concrete(shape):
    """-1 dims as the sentinel size, for shape inference on meta tensors."""
    return tuple(_DYNAMIC_DIM_SENTINEL if s == -1 else s for s in shape)


def shape_from_concrete(shape):
    """Sentinel-sized dims back to -1."""
    return tuple(-1 if s == _DYNAMIC_DIM_SENTINEL else s for s in shape)


@contextlib.contextmanager
def name_scope(prefix=None):
    """Fluid's debugging name scope: names in the IR are already unique,
    so nothing is renamed and nothing is recorded."""
    yield
