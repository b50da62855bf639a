"""Comparisons and ``increment`` of the static graph (counterpart of the
first part of paddle_tpu/layers/control_flow.py), what the static
learning-rate schedules need.

The control-flow constructs (``cond``, ``case``, ``switch_case``,
``while_loop``, ``While``, ``Switch``, ``IfElse``, ``StaticRNN``,
``DynamicRNN``, the tensor arrays, ``is_empty``) are not ported: each is
a callable that raises ``NotImplementedError`` naming ROADMAP A.8a,
set on this module and on ``layers`` from layers/__init__.py's table, and
the executor refuses their ops."""
from __future__ import annotations

from ..framework import in_dygraph_mode
from ..layer_helper import LayerHelper
from .common import generate_layer_fn

__all__ = ['increment', 'less_than', 'less_equal', 'greater_than',
           'greater_equal', 'equal', 'not_equal']


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
