"""``Sequential``, ``LayerList`` and ``ParameterList`` (counterpart of
paddle_tpu/dygraph/container.py), as Layers whose sublayers or parameters
are named ``0``, ``1``, ... (or by the names ``Sequential`` is given)."""
from __future__ import annotations

from .layers import Layer

__all__ = ['Sequential', 'LayerList', 'ParameterList']


class Sequential(Layer):
    """``Sequential(layer, ...)`` or ``Sequential([(name, layer), ...])``:
    ``forward`` runs the layers in turn."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], (list, tuple)):
            layers = layers[0]
        for i, layer in enumerate(layers):
            if isinstance(layer, (list, tuple)):
                name, sub = layer
                self.add_sublayer(str(name), sub)
            else:
                self.add_sublayer(str(i), layer)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    """A list of sublayers: indexing, ``len``, iteration, ``append``,
    ``insert`` and ``extend``."""

    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or ()):
            self.add_sublayer(str(i), layer)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self._modules.values())[i]
        return self._modules[str(i if i >= 0 else len(self) + i)]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, sublayer):
        self.add_sublayer(str(len(self._modules)), sublayer)
        return self

    def insert(self, index, sublayer):
        layers = list(self._modules.values())
        layers.insert(index, sublayer)
        self._modules.clear()
        for i, layer in enumerate(layers):
            self._modules[str(i)] = layer

    def extend(self, sublayers):
        for layer in sublayers:
            self.append(layer)
        return self


class ParameterList(Layer):
    """A list of parameters: indexing, ``len``, iteration and
    ``append``."""

    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def __getitem__(self, i):
        return self._parameters[str(i if i >= 0 else len(self) + i)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self
