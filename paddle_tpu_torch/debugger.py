"""Program debugger: graphviz drawing and a pretty printer (counterpart
of paddle_tpu/debugger.py).

``draw_block_graphviz`` writes a ``.dot`` file of a block's op and
variable graph; ``pprint_program_codes`` prints a program as pseudo-code.
No graphviz is needed: the ``.dot`` text stands alone (render it with
``dot -Tpng`` or any viewer). ``run_fast_nan_inf_debug`` fetches every
op's output in one run and names the first op whose output is not
finite.
"""
from __future__ import annotations

from .framework import BACKWARD_OP_TYPE, Parameter, Program, Variable

__all__ = ['draw_block_graphviz', 'pprint_program_codes',
           'pprint_block_codes', 'repr_var', 'repr_op', 'repr_attr',
           'repr_tensor', 'repr_lodtensor', 'repr_selected_rows',
           'repr_tensor_array', 'repr_data_type',
           'prepare_fast_nan_inf_debug', 'run_fast_nan_inf_debug']


# -------------------------------------------------- reprs over the op list

def repr_data_type(dtype):
    """A type's printable name (the IR's types are strings)."""
    return str(dtype)


def repr_tensor(var):
    """A dense variable."""
    return f'tensor(type={var.dtype}, shape={list(var.shape or [])})'


def repr_lodtensor(var):
    """A ragged variable (``lod_level`` > 0), else None."""
    if not getattr(var, 'lod_level', 0):
        return None
    return (f'LoDTensor(lod_level={var.lod_level}, type={var.dtype}, '
            f'shape={list(var.shape or [])})')


def repr_selected_rows(var):
    """A variable as SelectedRows (the port's sparse rows are dense; the
    printed form is Fluid's)."""
    return f'SelectedRows(type={var.dtype}, shape={list(var.shape or [])})'


def repr_tensor_array(var):
    """A tensor array."""
    return (f'TensorArray(type={var.dtype}, '
            f'shape={list(var.shape or [])})')


def repr_var(var):
    """A Variable's printed form: its kind, name and tensor."""
    kind = 'param' if isinstance(var, Parameter) else (
        'data' if var.is_data else 'var')
    body = repr_lodtensor(var) or repr_tensor(var)
    return f'{kind} {var.name}: {body}'


def repr_attr(name, value):
    """An attr as ``name=value``."""
    return f'{name}={value!r}'


def repr_op(op):
    """An op as ``outs = type(ins, attrs)``."""
    from .ops.registry import NON_KERNEL_ATTRS
    attrs = ', '.join(repr_attr(k, v) for k, v in sorted(op.attrs.items())
                      if k not in NON_KERNEL_ATTRS)
    outs = ', '.join(op.output_names()) or '_'
    ins = ', '.join(op.input_names())
    return f'{outs} = {op.type}({ins}{", " + attrs if attrs else ""})'


def _esc(s):
    return str(s).replace('"', '\\"')


def draw_block_graphviz(block, highlights=None, path='./temp.dot'):
    """Write a graphviz dot file for ``block``: ellipse nodes for vars (bold
    for Parameters), box nodes for ops, edges for dataflow. ``highlights``
    holds var names drawn filled red. Returns the text."""
    highlights = set(highlights or ())
    lines = ['digraph G {', '  rankdir=TB;']
    var_ids, op_ids = {}, {}
    for i, (name, var) in enumerate(sorted(block.vars.items())):
        var_ids[name] = f'var_{i}'
        style = 'style=filled, fillcolor=red,' if name in highlights else (
            'style=bold,' if isinstance(var, Parameter) else '')
        shape = getattr(var, 'shape', None)
        lines.append(
            f'  var_{i} [shape=ellipse, {style} '
            f'label="{_esc(name)}\\n{_esc(shape)}"];')
    for j, op in enumerate(block.ops):
        op_ids[j] = f'op_{j}'
        color = 'fillcolor=lightblue, style=filled' \
            if op.type != BACKWARD_OP_TYPE else \
            'fillcolor=orange, style=filled'
        lines.append(f'  op_{j} [shape=box, {color}, '
                     f'label="{_esc(op.type)}"];')
        for n in op.input_names():
            if n in var_ids:
                lines.append(f'  {var_ids[n]} -> op_{j};')
        for n in op.output_names():
            if n in var_ids:
                lines.append(f'  op_{j} -> {var_ids[n]};')
    lines.append('}')
    text = '\n'.join(lines)
    with open(path, 'w') as f:
        f.write(text)
    return text


def pprint_block_codes(block, show_backward=True):
    """One block as pseudo-code."""
    out = [f"# block {block.idx} (parent {block.parent_idx})"]
    for name, var in sorted(block.vars.items()):
        kind = 'param' if isinstance(var, Parameter) else (
            'data' if var.is_data else 'var')
        out.append(f"{kind} {name}: {var.dtype}{list(var.shape or [])}"
                   f"{' persistable' if var.persistable else ''}")
    for op in block.ops:
        if not show_backward and op.type == BACKWARD_OP_TYPE:
            continue
        outs = ', '.join(op.output_names()) or '_'
        ins = ', '.join(op.input_names())
        from .ops.registry import NON_KERNEL_ATTRS
        attrs = {k: v for k, v in op.attrs.items()
                 if k not in NON_KERNEL_ATTRS}
        out.append(f"{outs} = {op.type}({ins})"
                   f"{'  # ' + repr(attrs) if attrs else ''}")
    return '\n'.join(out)


def pprint_program_codes(program, show_backward=True):
    """Print and return every block of ``program`` as pseudo-code."""
    assert isinstance(program, Program)
    text = '\n\n'.join(pprint_block_codes(b, show_backward)
                       for b in program.blocks)
    print(text)
    return text


# ------------------------------------------------- finding a NaN's source

def prepare_fast_nan_inf_debug(_program):
    """Mark ``_program`` for :func:`run_fast_nan_inf_debug`: record every
    op output's name, so that one run can fetch them all (Fluid appends an
    isfinite op a variable instead)."""
    names = []
    for op in _program.global_block().ops:
        for n in op.output_names():
            if not n.endswith('@LEN'):
                names.append(n)
    _program._nan_inf_watch = names
    return _program


def run_fast_nan_inf_debug(executor, program=None, feed=None,
                           fetch_list=None, scope=None, return_numpy=True,
                           use_program_cache=False):
    """Run ``program`` once fetching every op output: raise RuntimeError
    naming the first op whose output holds NaN or Inf, else return the
    values of ``fetch_list``."""
    from .debugging import nonfinite_summary
    if program is None:
        from .framework import default_main_program
        program = default_main_program()
    watch = getattr(program, '_nan_inf_watch', None)
    if watch is None:
        prepare_fast_nan_inf_debug(program)
        watch = program._nan_inf_watch
    fetch_names = [getattr(f, 'name', f) for f in (fetch_list or [])]
    vals = executor.run(program, feed=feed,
                        fetch_list=list(watch) + fetch_names,
                        scope=scope, return_numpy=return_numpy)
    producer = {}
    for op in program.global_block().ops:
        for n in op.output_names():
            producer.setdefault(n, op)
    for name, val in zip(watch, vals):
        if nonfinite_summary(val) is not None:
            op = producer[name]
            raise RuntimeError(
                f'NaN/Inf first appears in var {name!r} produced by '
                f'{repr_op(op)}')
    return vals[len(watch):]
