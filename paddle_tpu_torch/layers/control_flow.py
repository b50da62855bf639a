"""Control-flow layers of the static graph (counterpart of
paddle_tpu/layers/control_flow.py): the comparisons and ``increment``,
``cond``, ``case``, ``switch_case``, ``while_loop``, ``While``,
``StaticRNN``, the tensor arrays, ``is_empty``, and the legacy ``Switch``,
``IfElse`` and ``DynamicRNN``.

Each construct builds its branches or its body into sub-blocks of the
program (``Program._create_block``) and appends one control-flow op that
names them, the JAX package's program op for op: ``__cond__`` (``cond``,
``case``, ``Switch``), ``__switch__``, ``__while__`` (``while_loop``),
``__while_legacy__`` (``While``), ``__scan__`` (``StaticRNN``,
``DynamicRNN``) and ``__create_array__``. The executor runs them
(executor.py). Under a ``dygraph.guard`` the functional forms run as
Python control flow on the tensors.

``IfElse`` computes both branches over the whole batch and merges them
row by row with ``where``; ``DynamicRNN`` runs a ``StaticRNN`` over the
padded batch and freezes each row's memories past its length, as the JAX
package formulates them. ``Print``, ``lod_rank_table`` and
``reorder_lod_tensor_by_rank`` are not ported (ROADMAP A.11, A.10): they
are set on this module from layers/__init__.py's table.
"""
from __future__ import annotations

import contextlib

import numpy as np

from ..framework import default_main_program, in_dygraph_mode
from ..layer_helper import LayerHelper
from .common import apply_op_layer, generate_layer_fn
from .utils import flatten as _flatten
from .utils import pack_sequence_as as _pack_like

__all__ = ['increment', 'less_than', 'less_equal', 'greater_than',
           'greater_equal', 'equal', 'not_equal', 'cond', 'case',
           'switch_case', 'while_loop', 'While', 'StaticRNN', 'array_write',
           'array_read', 'array_length', 'create_array', 'is_empty', 'Switch',
           'IfElse', 'DynamicRNN']


def _compare(op_type):
    base = generate_layer_fn(op_type, in_slots=['x', 'y'])

    def layer(x, y, cond=None, name=None):
        out = base(x, y, name=name)
        if cond is not None:
            from .tensor import assign
            return assign(out, output=cond)
        return out

    layer.__name__ = op_type
    layer.__doc__ = (f'``{op_type}(x, y)`` as a bool Variable, written into '
                     f'``cond`` if given.')
    return layer


less_than = _compare('less_than')
less_equal = _compare('less_equal')
greater_than = _compare('greater_than')
greater_equal = _compare('greater_equal')
equal = _compare('equal')
not_equal = _compare('not_equal')


def increment(x, value=1.0, in_place=True):
    """``x + value``; ``in_place`` writes it back under ``x``'s name (a
    persistable counter then moves once a run)."""
    if in_dygraph_mode():
        from ..dygraph.tape import dispatch_op
        out = dispatch_op('increment', {'x': x}, {'value': float(value)})
        if in_place:
            x.set_value(out)
            return x
        return out
    helper = LayerHelper('increment')
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op(type='increment', inputs={'x': x.name},
                     outputs={'Out': out.name},
                     attrs={'value': float(value)})
    return out


def _host_bool(t):
    return bool(t.reshape(()).item())


def _host_int(t):
    return int(t.reshape(()).item()) if hasattr(t, 'reshape') else int(t)


@contextlib.contextmanager
def _sub_block(program):
    blk = program._create_block()
    try:
        yield blk
    finally:
        program._rollback()


@contextlib.contextmanager
def _in_block(idx):
    """Append ops to block ``idx`` of the default main program for a
    while."""
    program = default_main_program()
    cur = program.current_block_idx
    program.current_block_idx = idx
    try:
        yield
    finally:
        program.current_block_idx = cur


def _parent_writes(blk):
    """The outer variables the ops of ``blk`` write (``assign(x,
    output=outer)``): they merge out of a branch, or join a loop's
    carry."""
    written = []
    for op in blk.ops:
        for n in op.output_names():
            if n not in blk.vars and n not in written:
                written.append(n)
    return written


def _outputs_like(helper, templates):
    outs = []
    for tv in templates:
        o = helper.create_variable_for_type_inference(tv.dtype)
        o.shape = tv.shape
        outs.append(o)
    return outs


# ------------------------------------------------- cond, case, switch_case

def cond(pred, true_fn=None, false_fn=None, name=None):
    """``true_fn()`` if ``pred`` else ``false_fn()``: both built into
    sub-blocks, one run (a ``__cond__`` op). Outer variables a branch
    writes merge out of it."""
    if in_dygraph_mode():
        fn = true_fn if _host_bool(pred) else false_fn
        return fn() if fn is not None else None
    program = default_main_program()
    helper = LayerHelper('cond', name=name)
    with _sub_block(program) as tblk:
        t_out = true_fn() if true_fn is not None else None
    with _sub_block(program) as fblk:
        f_out = false_fn() if false_fn is not None else None
    writes = _parent_writes(tblk)
    writes += [w for w in _parent_writes(fblk) if w not in writes]
    if (t_out is None) != (f_out is None):
        raise ValueError(
            "cond: one branch returned a value and the other returned None; "
            "both branches must return the same structure")
    if t_out is None and not writes:
        return None
    t_flat, f_flat = _flatten(t_out), _flatten(f_out)
    if t_out is None:
        t_flat = f_flat = []
    if len(t_flat) != len(f_flat):
        raise ValueError(
            f"cond: true_fn returned {len(t_flat)} outputs but false_fn "
            f"returned {len(f_flat)}; both branches must match")
    outs = _outputs_like(helper, t_flat)
    helper.append_op(
        type='__cond__', inputs={'Cond': pred.name},
        outputs={'Out': [o.name for o in outs] + writes},
        attrs={'true_block': tblk.idx, 'false_block': fblk.idx,
               'true_outs': [v.name for v in t_flat],
               'false_outs': [v.name for v in f_flat], 'writes': writes})
    return _pack_like(t_out, outs) if t_out is not None else None


def case(pred_fn_pairs, default=None, name=None):
    """The function of the first true predicate, else ``default`` (the
    last pair's function without one): nested ``cond`` s."""
    if not pred_fn_pairs:
        raise ValueError("case: pred_fn_pairs must be non-empty")

    def build(pairs):
        pred, fn = pairs[0]
        if len(pairs) == 1:
            return cond(pred, fn, default if default is not None else fn)
        return cond(pred, fn, lambda: build(pairs[1:]))

    return build(list(pred_fn_pairs))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """The branch whose key equals ``branch_index`` (a dict of key ->
    function, or a list of functions or of (key, function)), else
    ``default`` (the last branch without one): a ``__switch__`` op."""
    if isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    else:
        pairs = [(i, kv) if callable(kv) else (kv[0], kv[1])
                 for i, kv in enumerate(branch_fns)]
    keys = [int(k) for k, _ in pairs]
    fns = [fn for _, fn in pairs]
    if default is None:
        default = fns[-1]
    if in_dygraph_mode():
        idx = _host_int(branch_index)
        return dict(zip(keys, fns)).get(idx, default)()
    program = default_main_program()
    helper = LayerHelper('switch_case', name=name)
    reuse_last_as_default = default is fns[-1]
    blocks, returns, sub_blks = [], [], []
    for fn in (fns if reuse_last_as_default else fns + [default]):
        with _sub_block(program) as blk:
            out = fn()
        blocks.append(blk.idx)
        sub_blks.append(blk)
        returns.append(out)
    if reuse_last_as_default:
        blocks.append(blocks[-1])
        returns.append(returns[-1])
    writes = []
    for blk in sub_blks:
        writes += [w for w in _parent_writes(blk) if w not in writes]
    if any((r is None) != (returns[0] is None) for r in returns):
        raise ValueError("switch_case: some branches returned a value and "
                         "others returned None; all must match")
    branch_outs = [[] if r is None else _flatten(r) for r in returns]
    if returns[0] is None and not writes:
        return None
    n_out = len(branch_outs[0])
    if any(len(b) != n_out for b in branch_outs):
        raise ValueError("switch_case: all branches must return the same "
                         "number of outputs")
    outs = _outputs_like(helper, branch_outs[0])
    helper.append_op(
        type='__switch__', inputs={'Index': branch_index.name},
        outputs={'Out': [o.name for o in outs] + writes},
        attrs={'blocks': blocks, 'keys': keys,
               'branch_outs': [[v.name for v in b] for b in branch_outs],
               'writes': writes})
    if returns[0] is None:
        return None
    return outs[0] if n_out == 1 else outs


# ------------------------------------------------- while_loop and While

def while_loop(cond, body, loop_vars, is_test=False, name=None,
               maximum_trip_count=None):
    """``loop_vars = body(*loop_vars)`` while ``cond(*loop_vars)``: a
    ``__while__`` op over a condition block and a body block. With
    ``maximum_trip_count`` the loop stops there at the latest and is
    differentiable; without one a gradient through it raises."""
    if in_dygraph_mode():
        args = list(loop_vars)
        while _host_bool(cond(*args)):
            out = body(*args)
            args = list(out) if isinstance(out, (list, tuple)) else [out]
        return args
    program = default_main_program()
    helper = LayerHelper('while_loop', name=name)
    flat_vars = _flatten(loop_vars)
    with _sub_block(program) as cond_blk:
        c = cond(*loop_vars)
    with _sub_block(program) as body_blk:
        b_out = body(*loop_vars)
    b_flat = _flatten(b_out)
    if len(b_flat) != len(flat_vars):
        raise ValueError(
            f"while_loop: body returned {len(b_flat)} values for "
            f"{len(flat_vars)} loop_vars")
    loop_names = [v.name for v in flat_vars]
    # outer variables the body writes join the carry
    writes = [w for w in _parent_writes(body_blk) if w not in loop_names]
    outs = _outputs_like(helper, flat_vars)
    helper.append_op(
        type='__while__', inputs={'X': loop_names + writes},
        outputs={'Out': [o.name for o in outs] + writes},
        attrs={'cond_block': cond_blk.idx, 'body_block': body_blk.idx,
               'cond_out': c.name, 'body_outs': [v.name for v in b_flat],
               'loop_vars': loop_names, 'writes': writes,
               'max_trip_count': (None if maximum_trip_count is None
                                  else int(maximum_trip_count))})
    return _pack_like(b_out if isinstance(b_out, (list, tuple))
                      else loop_vars, outs)


class While:
    """The block form: ``with While(cond_var).block(): ...`` runs the body
    while ``cond_var`` holds; the body updates the condition itself
    (``less_than(i, n, cond=cond_var)``). Its carry is ``cond_var`` and
    every outer variable the body writes (a ``__while_legacy__`` op)."""

    def __init__(self, cond, is_test=False, name=None):
        if in_dygraph_mode():
            raise RuntimeError("While is a static-graph construct; use a "
                               "python loop in dygraph mode")
        self.cond_var = cond
        self.helper = LayerHelper('while', name=name)

    @contextlib.contextmanager
    def block(self):
        program = default_main_program()
        with _sub_block(program) as blk:
            yield
        carry = [self.cond_var.name]
        carry += [n for n in _parent_writes(blk) if n != self.cond_var.name]
        program.current_block().append_op(
            type='__while_legacy__', inputs={'X': carry},
            outputs={'Out': carry},
            attrs={'body_block': blk.idx, 'carry': carry})


# ------------------------------------------------- StaticRNN

class StaticRNN:
    """A recurrence over the leading (time) dim: ``step_input`` slices a
    sequence, ``memory`` carries a state (``update_memory`` sets its next
    value), ``step_output`` collects a value a step, stacked on a new
    leading dim; one ``__scan__`` op."""

    def __init__(self, name=None):
        if in_dygraph_mode():
            raise RuntimeError("StaticRNN is a static-graph construct")
        self.helper = LayerHelper('static_rnn', name=name)
        self._block = None
        self._seq_inputs = []   # (slice name, source name)
        self._memories = []     # {'pre', 'init', 'new'}
        self._outputs = []
        self._out_vars = None
        self._seq_len = None

    @contextlib.contextmanager
    def step(self):
        program = default_main_program()
        self._block = program._create_block()
        try:
            yield
        finally:
            program._rollback()
            self._complete()

    def step_input(self, x):
        if self._seq_len is None:
            self._seq_len = x.shape[0]
        v = self._block.create_var(
            name=self.helper.name + f'.in{len(self._seq_inputs)}',
            shape=x.shape[1:], dtype=x.dtype)
        self._seq_inputs.append((v.name, x.name))
        return v

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1, dtype='float32'):
        from . import tensor as tensor_layers
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory needs `init` or (`shape`+"
                                 "`batch_ref`)")
            mshape = [batch_ref.shape[ref_batch_dim_idx] if s == -1 else s
                      for s in shape]
            with _in_block(self._block.parent_idx):
                init = tensor_layers.fill_constant(mshape, dtype,
                                                   float(init_value))
        pre = self._block.create_var(
            name=self.helper.name + f'.mem{len(self._memories)}',
            shape=init.shape, dtype=init.dtype)
        self._memories.append({'pre': pre.name, 'init': init.name,
                               'new': None})
        return pre

    def update_memory(self, mem, var):
        for m in self._memories:
            if m['pre'] == mem.name:
                m['new'] = var.name
                return
        raise ValueError(f"update_memory: {mem.name} is not a memory")

    def step_output(self, o):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        for m in self._memories:
            if m['new'] is None:
                m['new'] = m['pre']
        outs = []
        for ov in self._outputs:
            o = self.helper.create_variable_for_type_inference(ov.dtype)
            if ov.shape is not None and self._seq_len is not None:
                o.shape = (self._seq_len,) + tuple(ov.shape)
            outs.append(o)
        self.helper.append_op(
            type='__scan__',
            inputs={'X': [src for _, src in self._seq_inputs],
                    'Init': [m['init'] for m in self._memories]},
            outputs={'Out': [o.name for o in outs]},
            attrs={'block': self._block.idx,
                   'slice_names': [s for s, _ in self._seq_inputs],
                   'pre_names': [m['pre'] for m in self._memories],
                   'new_names': [m['new'] for m in self._memories],
                   'out_names': [o.name for o in self._outputs]})
        self._out_vars = outs

    def __call__(self):
        if not self._out_vars:
            raise ValueError("StaticRNN has no step_output")
        return (self._out_vars[0] if len(self._out_vars) == 1
                else self._out_vars)


# ------------------------------------------------- tensor arrays

class _DygraphTensorArray(list):
    pass


def create_array(dtype='float32'):
    """An empty tensor array (a list of tensors at run time)."""
    if in_dygraph_mode():
        return _DygraphTensorArray()
    helper = LayerHelper('array')
    v = helper.main_program.current_block().create_var(
        name=helper.name, dtype=dtype, shape=(0,))
    v.is_tensor_array = True
    helper.append_op(type='__create_array__', inputs={},
                     outputs={'Out': v.name}, attrs={})
    return v


def array_write(x, i, array=None):
    """``array`` with ``x`` at index ``i`` (a new array if None); the
    index is read on the host."""
    if in_dygraph_mode():
        if array is None:
            array = _DygraphTensorArray()
        idx = _host_int(i)
        while len(array) <= idx:
            array.append(None)
        array[idx] = x
        return array
    helper = LayerHelper('array_write')
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(
        type='__array_write__',
        inputs={'array': array.name, 'x': x.name, 'i': i.name},
        outputs={'Out': array.name})
    return array


def array_read(array, i):
    if in_dygraph_mode():
        return array[_host_int(i)]
    helper = LayerHelper('array_read')
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(type='__array_read__',
                     inputs={'array': array.name, 'i': i.name},
                     outputs={'Out': out.name})
    return out


def array_length(array):
    if in_dygraph_mode():
        from ..dygraph.tape import Tensor
        return Tensor(len(array), dtype='int64', stop_gradient=True)
    helper = LayerHelper('array_length')
    out = helper.create_variable_for_type_inference('int32')
    out.shape = ()
    helper.append_op(type='__array_length__', inputs={'array': array.name},
                     outputs={'Out': out.name})
    return out


def is_empty(x, cond=None):
    """Whether ``x`` has no element, a bool scalar (written into ``cond``
    if given)."""
    out = apply_op_layer('is_empty', {'x': x}, {})
    if cond is not None:
        from .tensor import assign
        return assign(out, output=cond)
    return out


# ------------------------------------------------- Switch, IfElse, DynamicRNN

class Switch:
    """``with Switch() as s: with s.case(c): ...; with s.default(): ...``:
    the first case whose condition holds runs, else the default; nested
    ``__cond__`` ops that merge the outer variables the cases write."""

    def __init__(self, name=None):
        self._cases = []          # [(condition, block)]
        self._default = None
        self._inside = False

    def __enter__(self):
        self._inside = True
        return self

    @contextlib.contextmanager
    def case(self, condition):
        if not self._inside:
            raise ValueError("Switch.case must be used inside 'with switch'")
        with _sub_block(default_main_program()) as blk:
            yield
        self._cases.append((condition, blk))

    @contextlib.contextmanager
    def default(self):
        with _sub_block(default_main_program()) as blk:
            yield
        self._default = blk

    def __exit__(self, exc_type, exc_val, exc_tb):
        self._inside = False
        if exc_type is not None:
            return False
        if not self._cases:
            if self._default is not None:
                raise ValueError(
                    "Switch: a default block requires at least one case")
            return False
        program = default_main_program()
        helper = LayerHelper('switch')

        def emit(i):
            cvar, tblk = self._cases[i]
            if i == len(self._cases) - 1:
                if self._default is not None:
                    fblk = self._default
                else:
                    with _sub_block(program) as fblk:
                        pass
            else:
                with _sub_block(program) as fblk:
                    emit(i + 1)
            writes = _parent_writes(tblk)
            writes += [w for w in _parent_writes(fblk) if w not in writes]
            helper.append_op(
                type='__cond__', inputs={'Cond': cvar.name},
                outputs={'Out': writes},
                attrs={'true_block': tblk.idx, 'false_block': fblk.idx,
                       'true_outs': [], 'false_outs': [], 'writes': writes})

        emit(0)
        return False


class IfElse:
    """Row-wise branching on a (B, 1) bool ``cond``: both blocks compute
    over the whole batch and ``ie()`` merges each output pair with
    ``where`` (never a blend, so a NaN of the row not taken stays out and
    integer types survive)."""

    def __init__(self, cond, name=None):
        self._cond = cond
        self._in_true = None
        self._outs = {True: [], False: []}

    @contextlib.contextmanager
    def true_block(self):
        self._in_true = True
        yield
        self._in_true = None

    @contextlib.contextmanager
    def false_block(self):
        self._in_true = False
        yield
        self._in_true = None

    def input(self, x):
        return x

    def output(self, *outs):
        if self._in_true is None:
            raise ValueError("IfElse.output must be called inside a block")
        self._outs[self._in_true].extend(outs)

    def __call__(self):
        t, f = self._outs[True], self._outs[False]
        if len(t) != len(f):
            raise ValueError(
                f"IfElse: true block produced {len(t)} outputs, false block "
                f"{len(f)}; they must match")
        from .nn import reshape, where
        merged = []
        for tv, fv in zip(t, f):
            m = self._cond
            extra = len(tv.shape) - len(m.shape)
            if extra > 0:
                m = reshape(m, shape=list(m.shape) + [1] * extra)
            merged.append(where(m, tv, fv))
        return merged


class DynamicRNN:
    """An RNN over a padded (B, T, ...) batch with per-row lengths: a
    ``StaticRNN`` over the time-major batch whose memories stop moving
    past each row's length (``step_input(x, sequence_length=lens)``);
    ``drnn()`` gives the outputs batch-major again."""

    def __init__(self, name=None):
        self._srnn = StaticRNN()
        self._lens = None
        self._t = None
        self._T = None
        self._B = None
        self._x_ref = None

    @contextlib.contextmanager
    def block(self):
        with self._srnn.step():
            yield

    def _parent_block(self):
        """Sequence inputs of the scan must be variables of the block
        around the step."""
        return _in_block(self._srnn._block.parent_idx)

    def step_input(self, x, level=0, sequence_length=None):
        from .nn import transpose
        if self._lens is None:
            self._lens = (sequence_length if sequence_length is not None
                          else getattr(x, 'sequence_length', None))
        self._x_ref = x
        with self._parent_block():
            xt = transpose(x, perm=[1, 0] + list(range(2, len(x.shape))))
            self._T = xt.shape[0]
            self._B = xt.shape[1]
            if self._t is None:
                from .tensor import fill_constant_array
                times = fill_constant_array(np.arange(self._T,
                                                      dtype=np.int64))
        if self._t is None:
            self._t = self._srnn.step_input(times)
        return self._srnn.step_input(xt)

    def static_input(self, x):
        return x

    @property
    def step_idx(self):
        return self._t

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype='float32'):
        if init is None:
            if shape is None or self._x_ref is None:
                raise ValueError("DynamicRNN.memory(shape=...) must follow "
                                 "step_input (batch size comes from it)")
            from .tensor import fill_constant, fill_constant_batch_size_like
            with self._parent_block():
                if isinstance(self._B, int) and self._B > 0:
                    init = fill_constant([self._B] + list(shape), dtype,
                                         float(value))
                else:   # a batch of -1: its size comes from the input
                    init = fill_constant_batch_size_like(
                        self._x_ref, [-1] + list(shape), dtype, float(value))
            if getattr(init, 'shape', None) is None:
                init.shape = tuple([-1] + list(shape))
        return self._srnn.memory(init=init)

    def update_memory(self, mem, new):
        if self._lens is not None and self._t is not None:
            from .nn import reshape
            from .tensor import cast
            alive = cast(
                apply_op_layer('less_than',
                               {'x': self._t,
                                'y': cast(self._lens, 'int64')}), new.dtype)
            rank = len(new.shape if new.shape is not None else mem.shape)
            alive = reshape(alive, shape=[-1] + [1] * (rank - 1))
            new = new * alive + mem * (1.0 - alive)
        self._srnn.update_memory(mem, new)

    def output(self, *outputs):
        for o in outputs:
            self._srnn.step_output(o)

    def __call__(self):
        from .nn import transpose
        res = self._srnn()
        outs = res if isinstance(res, list) else [res]
        outs = [transpose(o, perm=[1, 0] + list(range(2, len(o.shape))))
                for o in outs]
        for o in outs:
            if self._lens is not None:
                o.sequence_length = self._lens
        return outs[0] if len(outs) == 1 else outs
