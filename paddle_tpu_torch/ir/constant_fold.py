"""Constant folding of ``fill_constant`` -> ``scale`` / ``cast`` chains
(counterpart of paddle_tpu/ir/constant_fold.py).

A ``scale`` or ``cast`` of a live uniform constant is itself a uniform
constant: the op becomes an equivalent ``fill_constant``, and the
producer is left for DCE to sweep once nothing reads it. A later write of
the same name by another op ends the constant (forward dataflow over the
global block), so a name with several writers folds only where the
constant is the live value.

The folded value is the port's own op run once on a one-element CPU
tensor of the constant (``scale`` rounds its factor and bias to the
tensor's type, as the op does on the card), so folded and unfolded
programs give the same bits.
"""
from __future__ import annotations

import torch

from ..core.dtypes import to_torch_dtype
from ..framework import Operator
from ..ops.registry import NON_KERNEL_ATTRS, get_op
from .pass_base import Pass, register_pass


@register_pass
class ConstantFoldingPass(Pass):
    name = 'constant_fold'
    order = 100          # first: the fusion passes see folded constants

    def apply_impl(self, program, ctx):
        blk = program.global_block()
        consts = {}      # var name -> (value, dtype, shape), live now
        folded = 0
        for i, op in enumerate(blk.ops):
            new = self._fold_op(op, consts)
            if new is not None:
                blk.ops[i] = new
                op = new
                folded += 1
            if op.type == 'fill_constant':
                a = op.attrs
                consts[op.outputs['Out'][0]] = (
                    a['value'], a.get('dtype', 'float32'), tuple(a['shape']))
            else:
                for out in op.output_names():
                    consts.pop(out, None)
        ctx.record(self.name, folded_ops=folded)
        return bool(folded)

    @staticmethod
    def _fold_op(op, consts):
        """A scale or cast of a live constant -> the equivalent
        fill_constant op, else None."""
        if op.type not in ('scale', 'cast'):
            return None
        src = op.inputs.get('x', [None])[0]
        if src not in consts:
            return None
        value, dtype, shape = consts[src]
        x = torch.full((1,), value, dtype=to_torch_dtype(dtype))
        out = get_op(op.type).fn(x, **{k: v for k, v in op.attrs.items()
                                       if k not in NON_KERNEL_ATTRS})
        out_dtype = dtype if op.type == 'scale' else op.attrs['dtype']
        return Operator(op.block, 'fill_constant', inputs={},
                        outputs={'Out': list(op.outputs['Out'])},
                        attrs={'shape': list(shape), 'value': out.item(),
                               'dtype': out_dtype})
