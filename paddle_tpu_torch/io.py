"""Model save and load (counterpart of paddle_tpu/io.py), in the JAX
package's own file format, so a model saved by either package loads in the
other:

- values: one ``.npz`` (``params.npz`` by default) of numpy arrays by
  variable name;
- a program: JSON (``__model__.json`` for an inference model,
  ``<path>.pdmodel`` for ``save``), each block's vars (name, shape, dtype,
  persistable, is_data, stop_gradient, is_parameter, trainable,
  lod_level, belong_to_optimizer) and ops (type, inputs, outputs, attrs),
  where an op's ``initializer`` attr and array-valued attrs are left out
  and a ``__constant__`` op's array travels as ``constant_value`` and
  ``constant_dtype``;
- ``save_inference_model``: ``clone(for_test=True)`` then ``_prune`` to
  the targets, the JSON with ``feed_names``/``fetch_names``, and the
  pruned program's persistables.

Values are read from the global scope (``scope_guard`` picks another) and
loaded onto the executor's device (the card when no executor is given), as
``Executor.run`` wants them. Files are written to a temporary name in the
target directory and renamed over it, so a killed save leaves no torn file.

``DataLoader`` raises (ROADMAP A.11).
"""
from __future__ import annotations

import io as _io
import json
import os
import tempfile

import numpy as np
import torch

from .core.dtypes import to_numpy_dtype, to_torch_dtype
from .core.places import get_device
from .core.scope import global_scope
from .dygraph.checkpoint import load_dygraph, save_dygraph
from .framework import (Block, Operator, Parameter, Program, Variable,
                        default_main_program)

__all__ = ['save_params', 'save_persistables', 'load_params',
           'load_persistables', 'save_inference_model', 'load_inference_model',
           'save_dygraph', 'load_dygraph', 'save_vars', 'load_vars',
           'is_parameter', 'is_persistable', 'is_belong_to_optimizer',
           'get_program_parameter', 'get_program_persistable_vars',
           'get_parameter_value', 'get_parameter_value_by_name',
           'prepend_feed_ops', 'append_fetch_ops',
           'save', 'load', 'load_program_state', 'set_program_state',
           'DataLoader']


def _atomic_write(path, data):
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix='.tmp_')
    try:
        with os.fdopen(fd, 'wb') as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _atomic_savez(path, arrays):
    """np.savez through a buffer, under ``path`` exactly (np.savez given a
    name would append '.npz')."""
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    _atomic_write(path, buf.getvalue())


def _numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _device(executor):
    return executor.device if executor is not None else get_device(None)


def _tensor(arr, dtype, device):
    return torch.from_numpy(np.array(arr, to_numpy_dtype(dtype))).to(
        device, to_torch_dtype(dtype))


def is_parameter(var):
    return isinstance(var, Parameter)


def is_persistable(var):
    """Persistable and not a fed variable."""
    return bool(var.persistable) and not var.is_data


def is_belong_to_optimizer(var):
    """An optimizer's persistable (slots, the rate, a schedule's counter),
    as its ``belong_to_optimizer`` tag says."""
    return (bool(var.persistable) and not isinstance(var, Parameter)
            and bool(getattr(var, 'belong_to_optimizer', False)))


def get_program_parameter(program):
    return [v for v in program.list_vars() if is_parameter(v)]


def get_program_persistable_vars(program):
    return [v for v in program.list_vars() if is_persistable(v)]


def get_parameter_value(para, executor=None):
    """A parameter's value in the global scope, as numpy."""
    val = global_scope().find(para.name if isinstance(para, Variable)
                              else para)
    if val is None:
        raise ValueError(f'parameter {para} has no value in the scope; '
                         'run the startup program first')
    return _numpy(val)


def get_parameter_value_by_name(name, executor=None, program=None):
    program = program or default_main_program()
    var = program.global_block().var(name)
    if not is_parameter(var):
        raise TypeError(f'{name} is not a Parameter')
    return get_parameter_value(var, executor)


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """Save ``vars`` (Variables or names), else the program's variables
    that ``predicate`` picks and that have a value, into
    ``dirname/filename`` (``params.npz``)."""
    program = main_program or default_main_program()
    scope = global_scope()
    data = {}
    if vars is not None:
        for v in vars:
            name = v.name if isinstance(v, Variable) else v
            val = scope.find(name)
            if val is None:
                raise ValueError(
                    f"save_vars: variable '{name}' has no value in the "
                    f'scope (run the startup program, or drop it from '
                    f'vars=)')
            data[name] = _numpy(val)
    else:
        for v in program.list_vars():
            if predicate(v):
                val = scope.find(v.name)
                if val is not None:
                    data[v.name] = _numpy(val)
    os.makedirs(dirname, exist_ok=True)
    _atomic_savez(os.path.join(dirname, filename or 'params.npz'), data)


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program,
              predicate=lambda v: isinstance(v, Parameter), filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program,
              predicate=lambda v: v.persistable and not v.is_data,
              filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """Load the program's variables named in ``vars`` or picked by
    ``predicate`` from ``dirname/filename`` into the global scope, on the
    executor's device; a name in ``vars`` that the file lacks raises."""
    program = main_program or default_main_program()
    scope = global_scope()
    path = os.path.join(dirname, filename or 'params.npz')
    dev = _device(executor)
    with np.load(path) as data:
        names = set(data.files)
        wanted = None
        if vars is not None:
            wanted = {x.name if isinstance(x, Variable) else x for x in vars}
            missing = sorted(wanted - names)
            if missing:
                raise ValueError(f'load_vars: requested vars not found in '
                                 f'{path}: {missing}')
        for v in program.list_vars():
            want = (v.name in wanted if wanted is not None
                    else predicate is not None and predicate(v))
            if want and v.name in names:
                scope.set(v.name, _tensor(data[v.name], v.dtype, dev))


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program,
              predicate=lambda v: isinstance(v, Parameter), filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program,
              predicate=lambda v: v.persistable and not v.is_data,
              filename=filename)


# ------------------------------------------------- program serialisation

def _program_to_dict(program):
    blocks = []
    for b in program.blocks:
        vars_ = [{'name': v.name,
                  'shape': list(v.shape) if v.shape else None,
                  'dtype': v.dtype, 'persistable': v.persistable,
                  'is_data': v.is_data, 'stop_gradient': v.stop_gradient,
                  'is_parameter': isinstance(v, Parameter),
                  'trainable': v.trainable, 'lod_level': v.lod_level,
                  'belong_to_optimizer': bool(
                      getattr(v, 'belong_to_optimizer', False))}
                 for v in b.vars.values()]
        ops = []
        for op in b.ops:
            attrs = {k: val for k, val in op.attrs.items()
                     if k != 'initializer'
                     and not isinstance(val, np.ndarray)}
            entry = {'type': op.type, 'inputs': op.inputs,
                     'outputs': op.outputs, 'attrs': attrs}
            if op.type == '__constant__':
                value = np.asarray(op.attrs['value'])
                entry['constant_value'] = value.tolist()
                entry['constant_dtype'] = str(value.dtype)
            ops.append(entry)
        blocks.append({'idx': b.idx, 'parent_idx': b.parent_idx,
                       'vars': vars_, 'ops': ops})
    return {'blocks': blocks, 'version': 1}


def _program_from_dict(d):
    p = Program()
    p.blocks = []
    for bd in d['blocks']:
        b = Block(p, bd['idx'], bd['parent_idx'])
        for vd in bd['vars']:
            vd = dict(vd)
            belong = vd.pop('belong_to_optimizer', False)
            if vd.pop('is_parameter', False):
                v = b.create_parameter(vd['name'], vd['shape'], vd['dtype'],
                                       trainable=vd.get('trainable', True))
            else:
                v = b.create_var(**vd)
            if belong:
                v.belong_to_optimizer = True
        for od in bd['ops']:
            attrs = dict(od['attrs'])
            if 'constant_value' in od:
                attrs['value'] = np.asarray(od['constant_value'],
                                            od['constant_dtype'])
            b.ops.append(Operator(b, od['type'], od['inputs'],
                                  od['outputs'], attrs))
        p.blocks.append(b)
    p.current_block_idx = 0
    return p


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False):
    """The program's inference slice (the ``for_test`` clone pruned to
    ``target_vars``) as JSON, and its persistables unless
    ``program_only``; returns the fetch names."""
    program = main_program or default_main_program()
    inference_program = program.clone(for_test=True)._prune(target_vars)
    os.makedirs(dirname, exist_ok=True)
    meta = _program_to_dict(inference_program)
    meta['feed_names'] = list(feeded_var_names)
    meta['fetch_names'] = [t.name if isinstance(t, Variable) else t
                           for t in target_vars]
    _atomic_write(os.path.join(dirname, model_filename or '__model__.json'),
                  json.dumps(meta).encode())
    if not program_only:
        save_persistables(executor, dirname, inference_program,
                          params_filename or 'params.npz')
    return meta['fetch_names']


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """-> (program, feed names, fetch Variables), the saved values in the
    global scope on the executor's device. A persistable with neither a
    saved value nor one in the scope raises (``program_only=True`` wants
    the values set first)."""
    with open(os.path.join(dirname, model_filename or '__model__.json')) as f:
        meta = json.load(f)
    program = _program_from_dict(meta)
    scope = global_scope()
    path = os.path.join(dirname, params_filename or 'params.npz')
    dev = _device(executor)
    saved = set()
    if os.path.exists(path):
        with np.load(path) as data:
            saved = set(data.files)
            for v in program.list_vars():
                if v.persistable and v.name in saved:
                    scope.set(v.name, _tensor(data[v.name], v.dtype, dev))
    missing = sorted(v.name for v in program.list_vars()
                     if v.persistable and v.name not in saved
                     and scope.find(v.name) is None)
    if missing:
        raise RuntimeError(
            f'load_inference_model: persistable vars have no saved value in '
            f'{path} and no value in the current scope: {missing} (saved '
            f'with program_only=True? load/set the parameters first)')
    fetch_vars = [program.global_block().var(n) for n in meta['fetch_names']]
    return program, meta['feed_names'], fetch_vars


def prepend_feed_ops(inference_program, feed_target_names,
                     feed_holder_name='feed'):
    """Record the feed names on the program (the executor binds feeds by
    name; there are no feed ops)."""
    inference_program._feed_names = list(feed_target_names)
    return inference_program


def append_fetch_ops(inference_program, fetch_target_names,
                     fetch_holder_name='fetch'):
    """Record the fetch names on the program (see prepend_feed_ops)."""
    inference_program._fetch_names = list(fetch_target_names)
    return inference_program


# --------------------------------------------- fluid.save / fluid.load

def save(program, model_path):
    """``<model_path>.pdparams`` (parameters), ``.pdopt`` (the other
    persistables) and ``.pdmodel`` (the program's JSON)."""
    d = os.path.dirname(model_path)
    if d:
        os.makedirs(d, exist_ok=True)
    scope = global_scope()
    params, opt = {}, {}
    for v in program.list_vars():
        val = scope.find(v.name) if is_persistable(v) else None
        if val is not None:
            (params if is_parameter(v) else opt)[v.name] = _numpy(val)
    _atomic_savez(model_path + '.pdparams', params)
    _atomic_savez(model_path + '.pdopt', opt)
    _atomic_write(model_path + '.pdmodel',
                  json.dumps(_program_to_dict(program)).encode())


def load(program, model_path, executor=None, var_list=None):
    """Restore what :func:`save` wrote into the global scope, on the
    executor's device."""
    set_program_state(program, load_program_state(model_path, var_list),
                      device=_device(executor))


def load_program_state(model_path, var_list=None):
    """``{name: ndarray}`` from ``<model_path>.pdparams`` and ``.pdopt``."""
    state = {}
    for ext in ('.pdparams', '.pdopt'):
        p = model_path + ext
        if not os.path.exists(p) and os.path.exists(p + '.npz'):
            p = p + '.npz'
        if os.path.exists(p):
            with np.load(p) as data:
                state.update({k: data[k] for k in data.files})
    if not state:
        raise FileNotFoundError(f'no saved state at {model_path}.pdparams')
    if var_list is not None:
        want = {v.name if isinstance(v, Variable) else v for v in var_list}
        missing = want - set(state)
        if missing:
            raise ValueError(f'vars not found in {model_path}: '
                             f'{sorted(missing)}')
        state = {k: v for k, v in state.items() if k in want}
    return state


def set_program_state(program, state_dict, *, device=None):
    """Write a :func:`load_program_state` dict into the global scope on
    ``device`` (the card if None), checking shape and kind against the
    program's vars; returns how many it wrote."""
    scope = global_scope()
    dev = device if device is not None else get_device(None)
    by_name = {v.name: v for v in program.list_vars() if is_persistable(v)}
    used = 0
    for name, arr in state_dict.items():
        v = by_name.get(name)
        if v is None:
            continue
        if (v.shape and -1 not in v.shape
                and tuple(np.shape(arr)) != tuple(v.shape)):
            raise ValueError(
                f'shape mismatch for {name}: program has {tuple(v.shape)}, '
                f'state has {np.shape(arr)}')
        want = np.dtype(to_numpy_dtype(v.dtype))
        have = np.asarray(arr).dtype
        if have.kind != want.kind:
            raise ValueError(f'dtype mismatch for {name}: program has '
                             f'{want}, state has {have}')
        scope.set(name, _tensor(arr, v.dtype, dev))
        used += 1
    return used


def _save_jit_model(dirname, layer, params, buffers):
    """A traced layer's values (dygraph/jit.py's ``TracedLayer``) as
    ``jit_params.npz`` and ``jit_buffers.npz`` under ``dirname``, by the
    structured names the JAX package's ``named_parameters`` and
    ``named_buffers`` give them, each in Paddle's layout (an NHWC
    Conv2D's weight as HWIO, as ``state_dict`` gives it)."""
    from .dygraph.layers import Layer
    perms = {}
    for mname, mod in layer.named_modules(remove_duplicate=False):
        if isinstance(mod, Layer):
            for pname, perm in mod._paddle_layouts().items():
                if perm is not None:
                    perms[f'{mname}.{pname}' if mname else pname] = perm
    os.makedirs(dirname, exist_ok=True)
    _atomic_savez(os.path.join(dirname, 'jit_params.npz'),
                  {k: _numpy(v.permute(perms[k]) if k in perms else v)
                   for k, v in params.items()})
    _atomic_savez(os.path.join(dirname, 'jit_buffers.npz'),
                  {k: _numpy(v) for k, v in buffers.items()})


def DataLoader(*args, **kwargs):
    """fluid.io.DataLoader: not ported yet (ROADMAP A.11)."""
    raise NotImplementedError('fluid.io.DataLoader is not ported yet '
                              '(ROADMAP A.11, the readers)')
