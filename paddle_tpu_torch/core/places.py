"""Places (counterpart of paddle_tpu/core/places.py): ``CPUPlace`` is the
CPU; ``CUDAPlace(i)``, and the JAX package's ``TPUPlace(i)`` and
``XLAPlace(i)``, are the CUDA card ``cuda:i``; ``CUDAPinnedPlace`` is
host memory, a CPU place. :meth:`Place.device` resolves
a place through ``device.resolve_device``, so a card place with no card
raises instead of running on the CPU."""
from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ['Place', 'CPUPlace', 'CUDAPlace', 'TPUPlace', 'XLAPlace',
           'CUDAPinnedPlace', 'is_compiled_with_cuda', 'cuda_places',
           'cpu_places', 'tpu_places', 'cuda_pinned_places', 'get_device']


class Place:
    """Base class of the places."""

    _device_kind = None          # 'cpu' | 'accel'

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f'{type(self).__name__}({self.device_id})'

    def device(self):
        """The ``torch.device`` of this place."""
        if self._device_kind == 'cpu':
            return resolve_device('cpu')
        return resolve_device(f'cuda:{self.device_id}')


class CPUPlace(Place):
    _device_kind = 'cpu'

    def __init__(self):
        super().__init__(0)


class TPUPlace(Place):
    """The JAX package's accelerator place: here the CUDA card."""
    _device_kind = 'accel'


class CUDAPlace(TPUPlace):
    pass


class XLAPlace(TPUPlace):
    pass


class CUDAPinnedPlace(Place):
    """Pinned host memory: the port stages feeds on the host, so this is a
    CPU place."""
    _device_kind = 'cpu'

    def __init__(self):
        super().__init__(0)


def is_compiled_with_cuda():
    return torch.cuda.is_available()


def cuda_places(device_ids=None):
    ids = (range(torch.cuda.device_count()) if device_ids is None
           else device_ids)
    return [CUDAPlace(i) for i in ids]


def cpu_places(device_count=1):
    return [CPUPlace() for _ in range(device_count)]


def tpu_places(device_ids=None):
    """The JAX package's accelerator places: here the cards, as
    :func:`cuda_places`."""
    return cuda_places(device_ids)


def cuda_pinned_places(device_count=None):
    """``device_count`` (1 if None) pinned host places."""
    n = 1 if device_count is None else int(device_count)
    return [CUDAPinnedPlace() for _ in range(n)]


def get_device(place):
    """``None`` | Place | str | ``torch.device`` -> ``torch.device`` with
    its index; ``None`` is the current card (and raises without one)."""
    if isinstance(place, Place):
        return place.device()
    if isinstance(place, str):
        s = place.lower()
        for prefix in ('tpu', 'gpu', 'xla'):
            if s.startswith(prefix):
                rest = s[len(prefix):].lstrip(':')
                return resolve_device(f'cuda:{int(rest) if rest else 0}')
    dev = resolve_device(place)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    return dev
