"""What the layer functions share (counterpart of
paddle_tpu/layers/common.py): :func:`apply_op_layer` appends a registered op
to the current program and returns its output Variables, or under a
``dygraph.guard`` runs it eagerly, and :func:`generate_layer_fn` makes a
layer function of an op."""
from __future__ import annotations

from ..framework import Variable, in_dygraph_mode
from ..layer_helper import LayerHelper
from ..ops.registry import get_op

__all__ = ['apply_op_layer', 'generate_layer_fn']


def _var_name(x):
    return x.name if isinstance(x, Variable) else x


def apply_op_layer(op_type, inputs, attrs=None, name=None, n_outputs=None,
                   dtype=None):
    """Append ``op_type`` to the current program; ``inputs`` maps slots to
    a Variable or a list of them. Returns the output Variable, or a tuple of
    them, one a slot (a list where ``n_outputs`` asks a slot for several).
    Under a ``dygraph.guard`` the op runs at once through ``dispatch_op``
    on tensors, which it returns."""
    if in_dygraph_mode():
        from ..dygraph.tape import dispatch_op
        return dispatch_op(op_type, inputs, attrs or {})
    opdef = get_op(op_type)
    helper = LayerHelper(op_type, name=name)
    in_names = {}
    first_dtype = dtype
    for slot, v in inputs.items():
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            in_names[slot] = [_var_name(x) for x in v]
            if first_dtype is None and v and isinstance(v[0], Variable):
                first_dtype = v[0].dtype
        else:
            in_names[slot] = _var_name(v)
            if first_dtype is None and isinstance(v, Variable):
                first_dtype = v.dtype
    outs = {}
    out_vars = []
    for slot in opdef.output_slots:
        k = n_outputs.get(slot, 1) if isinstance(n_outputs, dict) else 1
        vs = [helper.create_variable_for_type_inference(
            first_dtype or 'float32') for _ in range(k)]
        outs[slot] = [v.name for v in vs]
        out_vars.append(vs if k > 1 else vs[0])
    helper.append_op(type=op_type, inputs=in_names, outputs=outs,
                     attrs=attrs or {})
    return out_vars[0] if len(out_vars) == 1 else tuple(out_vars)


def generate_layer_fn(op_type, in_slots=None, doc='', attr_order=()):
    """A ``fn(x, ..., *attr_order, name=None, **attrs) -> Variable`` layer
    of an op. Positional arguments fill the input slots, then the names of
    ``attr_order`` in turn (Paddle's documented order of the layer's
    parameters: the op's attrs, and ``name`` where Paddle takes it there);
    one that has no place raises ``TypeError`` naming the layer."""
    opdef = get_op(op_type)
    slots = list(in_slots or opdef.input_slots)
    order = slots + list(attr_order)

    def layer(*args, name=None, **kwargs):
        if len(args) > len(order):
            raise TypeError(
                f'layers.{layer.__name__}() takes at most {len(order)} '
                f'positional arguments ({", ".join(order)}), '
                f'{len(args)} given')
        inputs = {}
        for key, v in zip(order, args):
            if key in kwargs or (key == 'name' and name is not None):
                raise TypeError(f'layers.{layer.__name__}() got multiple '
                                f'values for {key!r}')
            if key == 'name':
                name = v
            elif key in slots:
                inputs[key] = v
            else:
                kwargs[key] = v
        for slot in slots[len(args):]:
            if slot in kwargs:
                inputs[slot] = kwargs.pop(slot)
        return apply_op_layer(op_type, inputs, kwargs, name=name)

    layer.__name__ = op_type
    layer.__doc__ = doc or f'Layer of the op `{op_type}`.'
    return layer
