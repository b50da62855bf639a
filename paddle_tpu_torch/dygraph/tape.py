"""Paddle's VarBase API on torch tensors (counterpart of
paddle_tpu/dygraph/tape.py).

The JAX package records a tape of ``jax.vjp`` nodes and walks it in
``backward()``. Here torch's autograd is the tape, so what is left to port is
the API: :class:`Tensor` and :class:`Parameter` carry Paddle's methods
(``numpy``, ``backward``, ``gradient``, ``clear_gradient``, ``detach``,
``set_value``, ``astype``, ``stop_gradient``, ``name``), and
:func:`dispatch_op` runs a registered op eagerly.

Design: :class:`Tensor` is a ``torch.Tensor`` subclass with torch's
``__torch_function__`` turned off (``_disabled_torch_function_impl``, as
``nn.Parameter`` has it), so a torch op on it costs what it costs on a plain
tensor and returns a plain tensor. Paddle's methods are put back where the
Fluid API hands a value to the user: ``to_variable``, :func:`dispatch_op`
(and with it every ``fluid.layers`` call under ``guard``), the outermost
``Layer`` call, parameters, ``state_dict`` values, and Python arithmetic
(``+``, ``*``, ``@``, indexing, ...) on a Tensor. Each of those wraps its
result with ``as_subclass``, which aliases the tensor and keeps its autograd
history. Torch functions (``torch.matmul``, ``F.linear``) called inside a
layer's ``forward`` return plain tensors and pay nothing; that is where the
work is.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..core import unique_name
from ..core.dtypes import to_torch_dtype
from ..core.random import default_generator
from ..ops.registry import NON_KERNEL_ATTRS, get_op

__all__ = ['Tensor', 'Parameter', 'no_grad', 'no_grad_guard', 'grad',
           'dispatch_op', 'grad_enabled']


def _wrap(out):
    """``out`` with every plain tensor in it viewed as a :class:`Tensor`
    (a tuple or list keeps its kind)."""
    if type(out) is torch.Tensor:
        return out.as_subclass(Tensor)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o) for o in out)
    return out


def _new(cls, data, requires_grad):
    return torch.Tensor._make_subclass(cls, data, requires_grad)


class _VarBase:
    """Paddle's VarBase methods, shared by :class:`Tensor` and
    :class:`Parameter`."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    # torch.Tensor has a read-only ``name``; Paddle's is a settable string
    @property
    def name(self):
        return self.__dict__.get('_paddle_name')

    @name.setter
    def name(self, value):
        self.__dict__['_paddle_name'] = value

    @property
    def persistable(self):
        return self.__dict__.get('_persistable', False)

    @persistable.setter
    def persistable(self, value):
        self.__dict__['_persistable'] = bool(value)

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        if self.is_leaf:
            self.requires_grad_(not value)
        elif value:
            raise RuntimeError(
                f'stop_gradient=True on {self.name or "a tensor"} that an '
                f'op made: autograd cannot cut it in place; use detach()')

    def numpy(self):
        """A host copy as an ndarray (bfloat16 as float32, which numpy
        lacks), whatever the device and whether it requires grad."""
        t = torch.Tensor.detach(self)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return torch.Tensor.numpy(t.cpu())

    def backward(self, retain_graph=False, backward_strategy=None):
        torch.autograd.backward(self, retain_graph=retain_graph)

    def gradient(self):
        """The gradient as an ndarray, or None before any backward."""
        g = self.grad
        if g is None:
            return None
        if g.dtype == torch.bfloat16:
            g = g.float()
        return g.detach().cpu().numpy()

    def clear_gradient(self):
        self.grad = None

    def detach(self):
        return torch.Tensor.detach(self).as_subclass(Tensor)

    def set_value(self, value):
        """Overwrite in place, keeping this tensor's type and shape."""
        src = (value if isinstance(value, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(value)))
        with torch.no_grad():
            self.copy_(src.reshape(self.shape).to(self.device, self.dtype))

    def astype(self, dtype):
        return _wrap(torch.Tensor.to(self, to_torch_dtype(dtype)))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        with torch.no_grad():
            data = torch.Tensor.clone(torch.Tensor.detach(self))
        out = _new(type(self), data, self.requires_grad)
        memo[id(self)] = out
        for k, v in self.__dict__.items():
            out.__dict__[k] = v
        return out


def _arith(name):
    base = getattr(torch.Tensor, name)

    def op(self, *args):
        return _wrap(base(self, *args))
    op.__name__ = name
    return op


for _name in ('__add__', '__radd__', '__sub__', '__rsub__', '__mul__',
              '__rmul__', '__truediv__', '__rtruediv__', '__floordiv__',
              '__mod__', '__pow__', '__rpow__', '__matmul__', '__rmatmul__',
              '__neg__', '__getitem__'):
    setattr(_VarBase, _name, _arith(_name))


class Tensor(_VarBase, torch.Tensor):
    """Paddle's VarBase: ``Tensor(value, name=None, stop_gradient=False,
    persistable=False, dtype=None)`` builds one from an array on the
    dygraph device (dygraph/base.py); ``to_variable`` is the usual way."""

    def __new__(cls, value, name=None, stop_gradient=False,
                persistable=False, dtype=None):
        from .base import _current_device
        if isinstance(value, torch.Tensor):
            data = value.detach()
        else:
            data = torch.from_numpy(np.array(value)).to(_current_device())
        if dtype is not None:
            data = data.to(to_torch_dtype(dtype))
        t = _new(cls, data, not stop_gradient and data.is_floating_point())
        t.name = name or unique_name.generate('tensor')
        t.persistable = persistable
        return t


class Parameter(_VarBase, nn.Parameter):
    """A trainable tensor of a Layer: an ``nn.Parameter`` with Paddle's
    ``name``, ``trainable`` (``requires_grad``), ``regularizer`` and
    ``optimize_attr``. ``Parameter(value, name=None, trainable=True,
    regularizer=None, learning_rate=1.0)`` builds one on the dygraph
    device; Layer.create_parameter is the usual way."""

    def __new__(cls, value=None, name=None, trainable=True, regularizer=None,
                **kw):
        from .base import _current_device
        if isinstance(value, torch.Tensor):
            data = value.detach()
        else:
            data = torch.from_numpy(np.array(value)).to(_current_device())
        p = _new(cls, data, bool(trainable))
        p.name = name or unique_name.generate('parameter')
        p.regularizer = regularizer
        p.optimize_attr = {'learning_rate': kw.get('learning_rate', 1.0)}
        return p

    @property
    def persistable(self):
        return True

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))


def grad_enabled():
    """Whether ops on this thread record gradients (torch's grad mode,
    which is thread-local)."""
    return torch.is_grad_enabled()


def no_grad_guard():
    """A context in which ops record no gradients (``torch.no_grad``)."""
    return torch.no_grad()


def no_grad(fn=None):
    """``with no_grad():`` or ``@no_grad`` on a function."""
    if fn is None:
        return torch.no_grad()

    @functools.wraps(fn)
    def wrapper(*a, **k):
        with torch.no_grad():
            return fn(*a, **k)
    return wrapper


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """Partial gradients d(outputs)/d(inputs), through
    ``torch.autograd.grad``; with ``create_graph=True`` they carry history
    and differentiate again. Unlike the JAX package's replay, the graph is
    freed unless ``retain_graph`` (which defaults to ``create_graph``).
    ``no_grad_vars`` is not ported and raises (ROADMAP A.4)."""
    if no_grad_vars is not None:
        raise NotImplementedError('grad(no_grad_vars=...) is not ported yet '
                                  '(ROADMAP A.4)')
    outputs = [outputs] if isinstance(outputs, torch.Tensor) \
        else list(outputs)
    inputs = [inputs] if isinstance(inputs, torch.Tensor) else list(inputs)
    if not outputs or not inputs:
        raise ValueError('grad(): outputs and inputs must be non-empty')
    if grad_outputs is not None:
        grad_outputs = ([grad_outputs] if isinstance(grad_outputs,
                                                     torch.Tensor)
                        else list(grad_outputs))
    gs = torch.autograd.grad(outputs, inputs, grad_outputs=grad_outputs,
                             retain_graph=retain_graph,
                             create_graph=create_graph,
                             allow_unused=allow_unused)
    return [None if g is None else _wrap(g) for g in gs]


def _as_input(v, device):
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.array(v)).to(device)


def dispatch_op(op_type, inputs, attrs):
    """Run the registered op ``op_type`` eagerly: ``inputs`` maps its input
    slots to a tensor, a list of them or None (an array or number becomes a
    constant tensor on the device of the other inputs), ``attrs`` its
    attributes. Returns its output as :class:`Tensor` (a tuple of them,
    one a slot, for an op with several). Autograd records it when grad
    mode is on and an input requires grad."""
    from .base import _current_device
    opdef = get_op(op_type)
    device = next((v.device for v in inputs.values()
                   if isinstance(v, torch.Tensor)), None)
    if device is None:
        device = _current_device()
    args = []
    for slot in opdef.input_slots:
        v = inputs.get(slot)
        if v is None:
            args.append(None)
        elif isinstance(v, (list, tuple)):
            args.append([_as_input(x, device) for x in v])
        else:
            args.append(_as_input(v, device))
    kw = {k: v for k, v in attrs.items() if k not in NON_KERNEL_ATTRS}
    if opdef.needs_rng and kw.get('key') is None:
        kw['key'] = default_generator.generator(device)
    if not any(isinstance(a, (torch.Tensor, list)) for a in args):
        # an op with no input (fill_constant) makes its output on torch's
        # default device: make it the dygraph device
        with torch.device(device):
            return _wrap(opdef.fn(*args, **kw))
    return _wrap(opdef.fn(*args, **kw))
