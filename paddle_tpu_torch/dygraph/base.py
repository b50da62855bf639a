"""Dygraph mode switches (counterpart of paddle_tpu/dygraph/base.py):
``guard``, ``enable_dygraph``, ``disable_dygraph``, ``enabled``,
``to_variable`` and the ``Tracer`` that ``guard`` installs.

``guard(place)`` resolves ``place`` through ``device.resolve_device``:
``None`` is the card, and with no card it raises; ``CPUPlace()`` is the CPU,
asked for explicitly (the tests' way in). The guard's device is where
``to_variable`` puts tensors and where ``Layer.create_parameter`` puts
parameters. Outside a guard both resolve ``None``, so they too run on the
card or raise.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import framework
from ..core import unique_name
from ..core.places import get_device
from ..device import resolve_device
from .tape import Tensor, _new

__all__ = ['Tracer', 'enabled', 'enable_dygraph', 'disable_dygraph', 'guard',
           'to_variable', 'set_eager_kernel_cache',
           'eager_kernel_cache_guard']


class Tracer:
    """The tracer an open ``guard`` holds in ``framework._dygraph_tracer_``:
    its device and the reference's train/eval flag. Torch's autograd does
    the tracing; ``trace_op`` runs one registered op through
    ``dispatch_op``."""

    def __init__(self, block=None, device=None):
        self._device = device
        self._train_mode = True

    def train_mode(self):
        self._train_mode = True

    def eval_mode(self):
        self._train_mode = False

    def trace_op(self, type, inputs, outputs=None, attrs=None,
                 stop_gradient=False):
        from .tape import dispatch_op
        if stop_gradient:
            with torch.no_grad():
                return dispatch_op(type, inputs, attrs or {})
        return dispatch_op(type, inputs, attrs or {})



def _current_device():
    """The open guard's device, else the card (raises without one)."""
    tracer = framework._dygraph_tracer_
    if tracer is not None:
        return tracer._device
    return resolve_device(None)


def enabled():
    return framework.in_dygraph_mode()


def enable_dygraph(place=None):
    framework._dygraph_tracer_ = Tracer(device=get_device(place))


def disable_dygraph():
    framework._dygraph_tracer_ = None


@contextlib.contextmanager
def guard(place=None):
    """Dygraph mode on ``place``'s device for the ``with`` body; the mode
    that was on before comes back after it."""
    tracer = Tracer(device=get_device(place))
    old = framework._dygraph_tracer_
    framework._dygraph_tracer_ = tracer
    try:
        yield
    finally:
        framework._dygraph_tracer_ = old


def set_eager_kernel_cache(enabled, maxsize=None):
    """Accepted for the reference's API and does nothing: the JAX package
    caches one jitted kernel an op and shape; torch runs its ops eagerly
    with nothing to cache."""


@contextlib.contextmanager
def eager_kernel_cache_guard(enabled):
    """Accepted for the reference's API and does nothing (see
    :func:`set_eager_kernel_cache`)."""
    yield


def to_variable(value, name=None, zero_copy=None):
    """``value`` (an ndarray, a number or a list of them, or a tensor) as a
    :class:`Tensor` on the dygraph device, with ``stop_gradient=True`` (a
    Tensor is returned as it is). A float64 array becomes float32, as the
    reference computes it with JAX's 64-bit types off; a torch tensor keeps
    its type. Integer arrays stay int64: the JAX package checks int64 ids
    against int32's range because JAX computes them in int32, torch does
    not (ROADMAP C.5)."""
    if isinstance(value, Tensor):
        return value
    if isinstance(value, torch.Tensor):
        return value.to(_current_device()).as_subclass(Tensor)
    value = np.array(value)
    if value.dtype == np.float64:
        value = value.astype(np.float32)
    data = torch.from_numpy(value).to(_current_device())
    t = _new(Tensor, data, False)
    t.name = name or unique_name.generate('tensor')
    return t
