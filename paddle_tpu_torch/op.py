"""Op introspection (counterpart of paddle_tpu/op.py).

Fluid builds OpDesc protobufs from C++ op protos; here the registry of
torch functions (ops/registry.py) is the set of ops, so a "proto" is read
from a registered OpDef: its input and output slots, and its attrs from
the function's keyword-only parameters (the generator ``key`` left out).
"""
import inspect

from .ops.registry import all_ops, get_op, has_op

__all__ = ['get_all_op_protos', 'OpInfo', 'OpDescCreationMethod',
           'OperatorFactory', 'create_op_creation_method', 'is_str',
           'Operator']


def is_str(s):
    return isinstance(s, str)


class OpProto:
    """An op's slots and attrs, in the place of Fluid's OpProto."""

    def __init__(self, opdef):
        self.type = opdef.name
        self.inputs = list(opdef.input_slots)
        self.outputs = list(opdef.output_slots)
        sig = inspect.signature(opdef.fn)
        self.attrs = [p.name for p in sig.parameters.values()
                      if p.kind == inspect.Parameter.KEYWORD_ONLY
                      and p.name != 'key']

    def __repr__(self):
        return (f'OpProto({self.type}, inputs={self.inputs}, '
                f'outputs={self.outputs}, attrs={self.attrs})')


def get_all_op_protos():
    """One proto for each registered op, by name."""
    return [OpProto(get_op(name)) for name in sorted(all_ops())]


class OpInfo:
    """An op type's function and proto."""

    def __init__(self, name):
        if not has_op(name):
            raise ValueError(f'unknown op type {name!r}')
        self.name = name
        self.op_def = get_op(name)
        self.proto = OpProto(self.op_def)
        self.method = self.op_def.fn


class OpDescCreationMethod:
    """A callable making an op descriptor dict (what an OpDesc protobuf
    holds) from keyword arguments."""

    def __init__(self, op_proto):
        self.proto = op_proto

    def __call__(self, **kwargs):
        inputs = {k: kwargs[k] for k in self.proto.inputs if k in kwargs}
        attrs = {k: kwargs[k] for k in self.proto.attrs if k in kwargs}
        outputs = {k: kwargs.get(k) for k in self.proto.outputs}
        return {'type': self.proto.type, 'inputs': inputs,
                'outputs': outputs, 'attrs': attrs}


def create_op_creation_method(op_proto):
    """A function making ``op_proto``'s descriptor dicts."""
    method = OpDescCreationMethod(op_proto)

    def creator(**kwargs):
        return method(**kwargs)
    creator.__name__ = op_proto.type
    return creator


class OperatorFactory:
    """Op type -> its creation method, made at first use."""

    def __init__(self):
        self.op_methods = {}

    def __call__(self, *args, **kwargs):
        if 'type' in kwargs:
            if args:
                raise ValueError("all parameters should be keyword when "
                                 "'type' is given")
            t = kwargs.pop('type')
        else:
            if len(args) != 1:
                raise ValueError('the first positional argument must be '
                                 'the op type')
            t = args[0]
        return self.get_op_creation_info(t)(**kwargs)

    def get_op_creation_info(self, t):
        if t not in self.op_methods:
            info = OpInfo(t)
            self.op_methods[t] = create_op_creation_method(info.proto)
        return self.op_methods[t]

    def types(self):
        return sorted(all_ops())


Operator = OperatorFactory()
