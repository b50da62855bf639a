"""Parameter initializers of the static graph (counterpart of
paddle_tpu/initializer.py): Constant, Uniform, Normal, TruncatedNormal,
Xavier, MSRA and NumpyArray.

Calling an initializer on a startup-program variable appends an
``__init__`` op; when the Executor runs the startup program it calls
:meth:`Initializer.compute` on its own device with that device's generator
(core/random.py), or with a generator of the initializer's own ``seed``
when that is not 0. The values differ from the JAX package's PRNG by design:
the distributions are the same, and parity tests carry weights across by
name (convert.scope_from_paddle).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .core.dtypes import to_torch_dtype

__all__ = ['Initializer', 'ConstantInitializer', 'UniformInitializer',
           'NormalInitializer', 'TruncatedNormalInitializer',
           'XavierInitializer', 'MSRAInitializer', 'NumpyArrayInitializer',
           'Constant', 'Uniform', 'Normal', 'TruncatedNormal', 'Xavier',
           'MSRA', 'NumpyArray']


class Initializer:
    def __call__(self, var, block):
        """Append the init op of ``var`` to ``block`` (a startup program's)."""
        block.append_op('__init__', inputs={}, outputs={'Out': var.name},
                        attrs={'initializer': self, 'shape': list(var.shape),
                               'dtype': var.dtype})
        return var

    def compute(self, shape, dtype, device, generator=None):
        """A new tensor of ``shape`` and ``dtype`` on ``device``."""
        raise NotImplementedError

    def _generator(self, device, generator):
        # a nonzero seed pins this initializer's stream; 0 defers to the
        # device's generator
        seed = getattr(self, 'seed', 0)
        if seed:
            g = torch.Generator(device=device)
            g.manual_seed(int(seed))
            return g
        if generator is None:
            from .core.random import default_generator
            generator = default_generator.generator(device)
        return generator

    def _uniform(self, shape, dtype, device, generator, low, high):
        out = torch.empty(tuple(shape), dtype=to_torch_dtype(dtype),
                          device=device)
        return out.uniform_(low, high,
                            generator=self._generator(device, generator))

    def _normal(self, shape, dtype, device, generator, loc, std):
        out = torch.empty(tuple(shape), dtype=to_torch_dtype(dtype),
                          device=device)
        return out.normal_(loc, std,
                           generator=self._generator(device, generator))


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def compute(self, shape, dtype, device, generator=None):
        return torch.full(tuple(shape), self.value,
                          dtype=to_torch_dtype(dtype), device=device)


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high = low, high
        self.seed = seed

    def compute(self, shape, dtype, device, generator=None):
        return self._uniform(shape, dtype, device, generator, self.low,
                             self.high)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale = loc, scale
        self.seed = seed

    def compute(self, shape, dtype, device, generator=None):
        return self._normal(shape, dtype, device, generator, self.loc,
                            self.scale)


class TruncatedNormalInitializer(Initializer):
    """Normal(loc, scale) cut at two standard deviations, as the JAX
    package's ``truncated_normal(-2, 2)``: drawn by the inverse CDF of a
    uniform on (Phi(-2), Phi(2)), in f32."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale = loc, scale
        self.seed = seed

    def compute(self, shape, dtype, device, generator=None):
        lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
        u = self._uniform(shape, 'float32', device, generator, lo, 1 - lo)
        z = math.sqrt(2) * torch.erfinv(2 * u - 1)
        return (self.loc + self.scale * z.clamp(-2.0, 2.0)).to(
            to_torch_dtype(dtype))


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels OIHW: fan_in = I * k, fan_out = O * k
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    """Glorot: uniform in +-sqrt(6 / (fan_in + fan_out)), or normal with
    std sqrt(2 / (fan_in + fan_out))."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out
        self.seed = seed

    def compute(self, shape, dtype, device, generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return self._uniform(shape, dtype, device, generator, -limit,
                                 limit)
        return self._normal(shape, dtype, device, generator, 0.0,
                            math.sqrt(2.0 / (fi + fo)))


class MSRAInitializer(Initializer):
    """He/Kaiming: uniform in +-sqrt(6 / fan_in), or normal with std
    sqrt(2 / fan_in)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in = uniform, fan_in
        self.seed = seed

    def compute(self, shape, dtype, device, generator=None):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            return self._uniform(shape, dtype, device, generator, -limit,
                                 limit)
        return self._normal(shape, dtype, device, generator, 0.0,
                            math.sqrt(2.0 / fi))


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def compute(self, shape, dtype, device, generator=None):
        return torch.as_tensor(self.value, device=device).to(
            to_torch_dtype(dtype)).reshape(tuple(shape))


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
NumpyArray = NumpyArrayInitializer
