"""Random streams (counterpart of paddle_tpu/core/random.py): one seeded
``torch.Generator`` per device in place of the JAX package's PRNG key tree.
Initializers and random ops draw from the generator of the device they
compute on, in program order, so a run is reproducible from its seed; the
values differ from the JAX package's by design."""
from __future__ import annotations

import torch

__all__ = ['GeneratorPool', 'default_generator', 'seed']


class GeneratorPool:
    """Generators made lazily, one per device, all seeded from ``seed``:
    nothing touches a device until a generator is asked for."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._gens = {}

    def seed(self, seed: int):
        self._seed = int(seed)
        self._gens.clear()

    def generator(self, device):
        device = torch.device(device)
        if device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        g = self._gens.get(device)
        if g is None:
            g = self._gens[device] = torch.Generator(device=device)
            g.manual_seed(self._seed)
        return g


default_generator = GeneratorPool(0)


def seed(s: int):
    """The global seed: reseeds every device's generator."""
    default_generator.seed(s)
    return default_generator
