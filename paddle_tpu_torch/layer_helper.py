"""LayerHelper: what the static-graph layer functions share (counterpart of
paddle_tpu/layer_helper.py): it creates parameters with their init ops in
the startup program, output variables, and appends ops.

An appended op's unknown output shapes are inferred by running its
registered function on ``device='meta'`` tensors of the inputs' shapes and
types (a -1 dim stands as ``framework._DYNAMIC_DIM_SENTINEL`` and reads back
as -1), where the JAX package runs ``jax.eval_shape``. Meta tensors hold no
data, so nothing is computed or launched at build time: a kernel wrapper
refuses a meta tensor, and an op that needs data (``.item()``, a
data-dependent shape) raises on one. Then, as the JAX package does where
it cannot trace, the shape stays unknown.
"""
from __future__ import annotations

import copy

import torch

from .core import unique_name
from .core.dtypes import convert_dtype, to_torch_dtype
from .framework import (default_main_program, default_startup_program,
                        shape_from_concrete, shape_to_concrete)
from .initializer import ConstantInitializer, XavierInitializer
from .ops.registry import NON_KERNEL_ATTRS, get_op
from .param_attr import ParamAttr

__all__ = ['LayerHelper', 'infer_shapes']

# the op types the executor runs itself: constants and control flow
_UNREGISTERED_OPS = frozenset({'__constant__', '__create_array__',
                               '__cond__', '__switch__', '__while__',
                               '__while_legacy__', '__scan__'})


def _meta(var):
    if var.shape is None:
        return None
    return torch.empty(shape_to_concrete(var.shape),
                       dtype=to_torch_dtype(var.dtype), device='meta')


def infer_shapes(op):
    """Fill in the shapes and types of ``op``'s outputs that are still
    unknown, from its function run on meta tensors; leave them unknown
    where that cannot run. ``__constant__`` and the control-flow ops are no
    registered ops: the layers that append them set their outputs
    themselves."""
    if op.type in _UNREGISTERED_OPS:
        return
    opdef = get_op(op.type)
    block = op.block
    args = []
    for slot in opdef.input_slots:
        names = op.inputs.get(slot, [])
        if not names:
            args.append(None)
            continue
        metas = [_meta(block.var(n)) for n in names]
        if any(m is None for m in metas):
            return
        args.append(metas if slot in opdef.variadic else metas[0])
    attrs = {k: v for k, v in op.attrs.items() if k not in NON_KERNEL_ATTRS}
    try:
        with torch.no_grad(), torch.device('meta'):
            out = opdef.fn(*args, **attrs)
    except Exception:
        return
    outs = [out] if len(opdef.output_slots) == 1 else list(out)
    for slot, res in zip(opdef.output_slots, outs):
        res_list = res if isinstance(res, (list, tuple)) else [res]
        for n, r in zip(op.outputs.get(slot, []), res_list):
            v = block.var(n)
            if v.shape is None and isinstance(r, torch.Tensor):
                v.shape = shape_from_concrete(tuple(r.shape))
                v.dtype = convert_dtype(r.dtype)


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get('name')
        self.name = (name if name is not None
                     else unique_name.generate(layer_type))

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get('param_attr'))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get('bias_attr'))

    def create_parameter(self, attr, shape, dtype='float32', is_bias=False,
                         default_initializer=None):
        """The parameter ``attr`` names (or ``<layer>.w_n`` / ``.b_n``) in
        the main program, and its twin with an init op in the startup
        program; None for ``attr=False``."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        # a copy, so one unnamed ParamAttr used twice makes two parameters
        attr = copy.copy(attr)
        if attr.name is None:
            attr.name = unique_name.generate(
                '.'.join([self.name, 'b' if is_bias else 'w']))
        init = attr.initializer or default_initializer or (
            ConstantInitializer(0.0) if is_bias else XavierInitializer())
        block = self.main_program.global_block()
        if block.has_var(attr.name):
            return block.var(attr.name)
        shape = [int(s) for s in shape]
        p = block.create_parameter(
            attr.name, shape, convert_dtype(dtype), trainable=attr.trainable,
            regularizer=attr.regularizer, learning_rate=attr.learning_rate,
            do_model_average=attr.do_model_average)
        sblock = self.startup_program.global_block()
        sp = sblock.create_parameter(attr.name, shape, convert_dtype(dtype),
                                     trainable=attr.trainable)
        init(sp, sblock)
        return p

    def create_variable_for_type_inference(self, dtype='float32', name=None):
        return self.main_program.current_block().create_var(
            name=name or unique_name.generate('.'.join([self.name, 'tmp'])),
            dtype=convert_dtype(dtype), shape=None)

    def create_global_variable(self, shape, dtype='float32', persistable=True,
                               name=None, stop_gradient=True):
        return self.main_program.global_block().create_var(
            name=name or unique_name.generate('.'.join([self.name,
                                                        'global'])),
            shape=[int(s) for s in shape], dtype=convert_dtype(dtype),
            persistable=persistable, stop_gradient=stop_gradient)

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = self.main_program.current_block().append_op(
            type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        infer_shapes(op)
        return op
