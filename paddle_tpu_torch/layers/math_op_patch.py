"""Operators on static Variables (counterpart of
paddle_tpu/layers/math_op_patch.py): ``v + w``, ``v * 2``, ``v > w``, ...
append the elementwise, scale and comparison ops, so the static
learning-rate schedules are written as arithmetic.

``==`` and ``!=`` append ``equal``/``not_equal`` ops and return a
Variable, as in the reference, so no code of the port compares Variables
with ``==``, ``in`` or ``.index``; ``__hash__`` stays the object's
identity."""
from __future__ import annotations

from ..framework import Variable
from .common import apply_op_layer

__all__ = ['monkey_patch_variable']


def _to_var(other, ref):
    if isinstance(other, Variable):
        return other
    from .tensor import fill_constant
    return fill_constant([1], ref.dtype, float(other))


def _binary(op_type, reverse=False):
    def impl(self, other):
        other = _to_var(other, self)
        x, y = (other, self) if reverse else (self, other)
        return apply_op_layer(op_type, {'x': x, 'y': y})
    return impl


def monkey_patch_variable():
    V = Variable
    V.__add__ = _binary('elementwise_add')
    V.__radd__ = _binary('elementwise_add', reverse=True)
    V.__sub__ = _binary('elementwise_sub')
    V.__rsub__ = _binary('elementwise_sub', reverse=True)
    V.__mul__ = _binary('elementwise_mul')
    V.__rmul__ = _binary('elementwise_mul', reverse=True)
    V.__truediv__ = _binary('elementwise_div')
    V.__rtruediv__ = _binary('elementwise_div', reverse=True)
    V.__pow__ = _binary('elementwise_pow')
    V.__mod__ = _binary('elementwise_mod')
    V.__floordiv__ = _binary('elementwise_floordiv')
    V.__neg__ = lambda self: apply_op_layer('scale', {'x': self},
                                            {'scale': -1.0})
    V.__eq__ = _binary('equal')
    V.__ne__ = _binary('not_equal')
    V.__lt__ = _binary('less_than')
    V.__le__ = _binary('less_equal')
    V.__gt__ = _binary('greater_than')
    V.__ge__ = _binary('greater_equal')
    V.__hash__ = lambda self: hash(id(self))
    V.astype = lambda self, dtype: apply_op_layer(
        'cast', {'x': self}, {'dtype': dtype})
