"""``dygraph.Layer`` (counterpart of paddle_tpu/dygraph/layers.py): Paddle's
Layer API on ``torch.nn.Module``.

A Layer is an ``nn.Module``, so torch's machinery works on it as it is
(``functional_call`` in ``TrainStep``, ``.to()``, ``load_state_dict``,
hooks), and it adds Paddle's names on top:

- ``create_parameter`` makes a :class:`~.tape.Parameter` with the port's
  initializers (Xavier for weights, zero for biases, as the reference), named
  ``<full_name>.w_<n>`` by ``core.unique_name``, on the Layer's device: the
  ``device=`` a port layer was given, else the open ``guard``'s, else the
  card (dygraph/base.py);
- ``parameters``, ``named_parameters``, ``buffers``, ``named_buffers`` and
  ``state_dict`` take Paddle's arguments and keep taking torch's as
  keywords, which torch itself passes (``recurse``, ``remove_duplicate``,
  ``keep_vars``). ``named_parameters`` lists a shared parameter once, as
  Paddle and torch both do; ``state_dict`` lists it under every name it
  has, as both do too (the Transformer's shared embedding appears as
  ``src_emb.weight`` and ``trg_emb.weight``);
- ``register_forward_pre_hook`` / ``register_forward_post_hook`` are
  torch's forward hooks, whose handles ``remove()``.

The outermost Layer call returns its tensors as :class:`~.tape.Tensor`,
so ``model(x).numpy()`` works; calls nested inside it return what their
``forward`` returns, at no cost.
"""
from __future__ import annotations

import threading

import torch
from torch import nn

from ..core import unique_name
from ..core.dtypes import convert_dtype, to_torch_dtype
from ..initializer import ConstantInitializer, XavierInitializer
from ..param_attr import ParamAttr
from .tape import Parameter, _new, _wrap

__all__ = ['Layer']

_calls = threading.local()


class Layer(nn.Module):
    """``Layer(name_scope=None, dtype='float32')``; the port's own layers
    also take a keyword-only ``device``."""

    def __init__(self, name_scope=None, dtype='float32', *, device=None):
        super().__init__()
        self._full_name = unique_name.generate(
            name_scope or type(self).__name__.lower())
        self._dtype = convert_dtype(dtype)
        self._device = device

    def full_name(self):
        return self._full_name

    def _param_device(self):
        if self._device is not None:
            from ..core.places import get_device
            return get_device(self._device)
        from .base import _current_device
        return _current_device()

    # ------------------------------------------------ parameters / buffers
    def create_parameter(self, shape, attr=None, dtype='float32',
                         is_bias=False, default_initializer=None):
        """A new Parameter of ``shape``, or None for ``attr=False``."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer or default_initializer or (
            ConstantInitializer(0.0) if is_bias else XavierInitializer())
        value = init.compute([int(s) for s in shape], convert_dtype(dtype),
                             self._param_device())
        name = attr.name or unique_name.generate(self._full_name + '.w')
        return Parameter(value, name=name, trainable=attr.trainable,
                         regularizer=attr.regularizer,
                         learning_rate=attr.learning_rate)

    def create_buffer(self, shape, dtype='float32', fill=0.0):
        """A persistable constant tensor (not registered: see
        ``register_buffer``)."""
        data = torch.full(tuple(shape), fill, dtype=to_torch_dtype(dtype),
                          device=self._param_device())
        from .tape import Tensor
        t = _new(Tensor, data, False)
        t.persistable = True
        return t

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name, tensor, *torch_args, **torch_kwargs):
        """Paddle's ``register_buffer(name, tensor)``, returning the tensor;
        torch's ``persistent`` still works."""
        super().register_buffer(name, tensor, *torch_args, **torch_kwargs)
        return tensor

    # ------------------------------------------------------------ traversal
    def parameters(self, include_sublayers=True, **torch_kwargs):
        """A list of the parameters, each once."""
        recurse = torch_kwargs.pop('recurse', include_sublayers)
        return list(super().parameters(recurse, **torch_kwargs))

    def named_parameters(self, prefix='', **torch_kwargs):
        return super().named_parameters(prefix, **torch_kwargs)

    def sublayers(self, include_sublayers=True):
        """The direct sublayers, then (``include_sublayers``) theirs."""
        out = list(self.children())
        if include_sublayers:
            for child in self.children():
                out.extend(child.sublayers() if isinstance(child, Layer)
                           else list(child.modules())[1:])
        return out

    def named_sublayers(self, prefix=''):
        for name, m in self.named_modules(prefix=prefix):
            if m is not self:
                yield name, m

    def buffers(self, include_sublayers=True, **torch_kwargs):
        recurse = torch_kwargs.pop('recurse', include_sublayers)
        return list(super().buffers(recurse))

    def named_buffers(self, prefix='', **torch_kwargs):
        return super().named_buffers(prefix, **torch_kwargs)

    # ---------------------------------------------------------------- modes
    def train(self, *torch_args, **torch_kwargs):
        """Training mode here and in every sublayer (torch's ``mode``
        still works)."""
        mode = bool(torch_args[0] if torch_args
                    else torch_kwargs.get('mode', True))
        for m in self.modules():
            m.training = mode
        return self

    def eval(self):
        return self.train(False)

    # ---------------------------------------------------------------- state
    def state_dict(self, destination=None, include_sublayers=True,
                   prefix='', **torch_kwargs):
        """{structured name: tensor} of the parameters and persistable
        buffers, every name of a shared one included."""
        if include_sublayers:
            return super().state_dict(destination=destination,
                                      prefix=prefix, **torch_kwargs)
        dest = {} if destination is None else destination
        self._save_to_state_dict(dest, prefix,
                                 torch_kwargs.get('keep_vars', False))
        return dest

    def set_dict(self, state, include_sublayers=True,
                 use_structured_name=True):
        """Copy the values of ``state`` (tensors or arrays, by structured
        name) into the parameters and buffers of the same name, in their
        types and shapes; names that are missing on either side are
        skipped, as the reference skips them."""
        own = self.state_dict(include_sublayers=include_sublayers,
                              keep_vars=True)
        with torch.no_grad():
            for name, t in own.items():
                if name in state:
                    src = state[name]
                    src = (src if isinstance(src, torch.Tensor)
                           else torch.as_tensor(src))
                    t.copy_(src.reshape(t.shape).to(t.device, t.dtype))

    load_dict = set_dict
    set_state_dict = set_dict

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    # ---------------------------------------------------------------- hooks
    def register_forward_pre_hook(self, hook):
        """``hook(layer, inputs)`` before ``forward``; what it returns
        (other than None) replaces the inputs."""
        return super().register_forward_pre_hook(hook)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)`` after ``forward``; what it
        returns (other than None) replaces the output."""
        return super().register_forward_hook(hook)

    # ----------------------------------------------------------------- call
    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        depth = getattr(_calls, 'depth', 0)
        _calls.depth = depth + 1
        try:
            out = super().__call__(*args, **kwargs)
        finally:
            _calls.depth = depth
        return out if depth else _wrap(out)
