"""Tensor layers of the static graph (counterpart of
paddle_tpu/layers/tensor.py): ``create_tensor``, ``create_parameter``,
``create_global_var``, ``cast``, ``concat``, ``sums``, ``assign``,
``fill_constant``, ``fill_constant_batch_size_like``, ``zeros``, ``ones``,
``zeros_like``, ``ones_like``, ``range``, ``reverse`` and
``tensor_array_to_tensor``. ``reshape`` is the generated
layer of layers/nn.py, as in the JAX package. ``assign`` of a numpy array
(or list or number) appends a ``__constant__`` op holding the array, which
the executor makes on its device once a lowering."""
from __future__ import annotations

import copy

import numpy as np

from ..core.dtypes import convert_dtype
from ..framework import in_dygraph_mode
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .common import apply_op_layer

__all__ = ['create_tensor', 'create_parameter', 'create_global_var', 'cast',
           'concat', 'sums', 'assign', 'fill_constant',
           'fill_constant_batch_size_like', 'ones', 'zeros', 'range',
           'zeros_like', 'ones_like', 'reverse', 'tensor_array_to_tensor']


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper('create_tensor', name=name)
    return helper.main_program.current_block().create_var(
        name=name, dtype=convert_dtype(dtype), persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper('create_parameter', name=name)
    attr = copy.copy(ParamAttr._to_attr(attr))
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global variable of the main program, filled with ``value`` by a
    Constant init op in the startup program."""
    helper = LayerHelper('global_var', name=name)
    v = helper.create_global_variable(shape, dtype, persistable=persistable,
                                      name=name)
    sb = helper.startup_program.global_block()
    sv = sb.create_var(name=v.name, shape=list(shape),
                       dtype=convert_dtype(dtype), persistable=persistable,
                       stop_gradient=True)
    ConstantInitializer(float(value))(sv, sb)
    return v


def cast(x, dtype):
    return apply_op_layer('cast', {'x': x}, {'dtype': convert_dtype(dtype)},
                          dtype=convert_dtype(dtype))


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    v = apply_op_layer('fill_constant', {},
                       {'shape': list(shape),
                        'value': (float(value)
                                  if convert_dtype(dtype).startswith('float')
                                  else value),
                        'dtype': convert_dtype(dtype)},
                       dtype=convert_dtype(dtype))
    if v.shape is None:
        v.shape = tuple(shape)
    return v


def concat(input, axis=0, name=None):
    return apply_op_layer('concat', {'xs': list(input)}, {'axis': axis},
                          name=name)


def sums(input, out=None):
    return apply_op_layer('sum', {'xs': list(input)})


def assign(input, output=None):
    """A copy of ``input`` (a Variable, or a numpy array, list or number,
    which becomes a ``__constant__`` op), into ``output`` if given."""
    if isinstance(input, (np.ndarray, list, tuple, float, int)):
        if in_dygraph_mode():
            from ..dygraph.base import to_variable
            input = to_variable(np.asarray(input))
        else:
            input = fill_constant_array(np.asarray(input))
    if output is None:
        return apply_op_layer('assign', {'x': input})
    if in_dygraph_mode():
        output.set_value(input)
        return output
    helper = LayerHelper('assign')
    helper.append_op(type='assign', inputs={'x': input.name},
                     outputs={'Out': output.name})
    return output


def fill_constant_array(arr):
    """A ``__constant__`` op holding ``arr``; returns its output. Under a
    ``dygraph.guard``, ``arr`` as a Tensor of its type on the guard's
    device."""
    if in_dygraph_mode():
        from ..dygraph.tape import Tensor
        return Tensor(np.asarray(arr), stop_gradient=True)
    helper = LayerHelper('constant')
    out = helper.create_variable_for_type_inference(str(arr.dtype))
    helper.append_op(type='__constant__', inputs={},
                     outputs={'Out': out.name},
                     attrs={'value': np.asarray(arr)})
    out.shape = tuple(arr.shape)
    out.dtype = convert_dtype(str(arr.dtype))
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    return apply_op_layer('fill_constant_batch_size_like', {'ref': input},
                          {'shape': list(shape), 'value': value,
                           'dtype': convert_dtype(dtype),
                           'input_dim_idx': input_dim_idx,
                           'output_dim_idx': output_dim_idx})


def ones(shape, dtype='float32', force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype='float32', force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def range(start, end, step, dtype):
    return apply_op_layer('range', {},
                          {'start': start, 'end': end, 'step': step,
                           'dtype': convert_dtype(dtype)},
                          dtype=convert_dtype(dtype))


def zeros_like(x, out=None):
    return apply_op_layer('fill_zeros_like', {'x': x})


def ones_like(x, out=None):
    return apply_op_layer('fill_any_like', {'x': x}, {'value': 1.0})


def reverse(x, axis):
    return apply_op_layer('reverse', {'x': x}, {'axis': axis})


def tensor_array_to_tensor(input, axis=1, name=None):
    """The tensors of ``input`` (a list, or a dygraph tensor array)
    stacked along ``axis``; returns ``(tensor, None)``, as the JAX package
    does."""
    out = apply_op_layer('stack', {'xs': list(input)}, {'axis': axis})
    return out, None
