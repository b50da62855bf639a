"""Tensor layers of the static graph (counterpart of
paddle_tpu/layers/tensor.py): ``create_parameter``, ``create_global_var``,
``cast`` and ``fill_constant``. ``reshape`` is the
generated layer of layers/nn.py, as in the JAX package."""
from __future__ import annotations

import copy

from ..core.dtypes import convert_dtype
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .common import apply_op_layer

__all__ = ['create_parameter', 'create_global_var', 'cast', 'fill_constant']


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
