"""The training step (counterpart of paddle_tpu/dygraph/jit.py's
``TrainStep``).

The JAX step traces forward, backward and the optimizer update into one
jitted XLA program with donated state. PyTorch runs eagerly, so here a call
runs the three in turn on the model's own parameters: ``loss.backward()``
lands the gradients on them and the optimizer updates them in place.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ['TrainStep']


@contextlib.contextmanager
def _cast_parameters(layer, dtype):
    """Bind each floating parameter of ``layer`` to a ``dtype`` copy of it
    inside the autograd graph, once per parameter however many modules or
    names share it, for the ``with`` body; the parameters come back after
    it. (``torch.func.functional_call`` binds by name, and restores a
    module that sits under two names, such as the Transformer's shared
    embedding, to the copy instead of the parameter.)"""
    casts, swapped = {}, []
    try:
        for mod in layer.modules():
            for name, p in mod._parameters.items():
                if p is None or not p.is_floating_point():
                    continue
                c = casts.get(id(p))
                if c is None:
                    c = casts[id(p)] = p.to(dtype)
                swapped.append((mod, name, p))
                mod._parameters[name] = c
        yield
    finally:
        for mod, name, p in reversed(swapped):
            mod._parameters[name] = p


class TrainStep:
    """``TrainStep(layer, loss_fn, optimizer, amp_dtype=None, donate=True)``;
    ``step(*batch)`` runs ``loss_fn(layer, *batch)``, its backward and one
    ``optimizer`` update of every parameter of ``layer`` that requires a
    gradient, and returns the summed loss as a detached 0-d tensor.

    Batch entries may be numpy arrays or tensors; they are moved to the
    layer's device (integers as int64).

    ``amp_dtype`` (e.g. ``torch.bfloat16``) follows the JAX step's rule: the
    parameters stay f32 masters; inside the autograd graph each floating
    parameter is cast to ``amp_dtype`` and bound to the layer in its place,
    once however many names share it (the counterpart of ``_bind``), so the
    forward and backward run in ``amp_dtype`` (LayerNorm and softmax
    included), the gradients land on the f32 masters through the casts,
    and the optimizer updates in f32. This is not ``torch.autocast``,
    which would keep LayerNorm and softmax in f32 where the reference does
    not. Buffers are not cast: BatchNorm's running statistics stay f32 and
    move during the step, in place on the layer's own buffers (dygraph/
    nn.py:BatchNorm), as the JAX step returns its new buffers; ``state()``
    returns them.

    The optimizer's learning rate may be a dygraph schedule: it is read
    each call, reaches the update as a device scalar (optimizer.py) and
    steps after it, as in the JAX step.

    ``donate`` is accepted for the reference's signature: the update is in
    place either way. ``accum_steps > 1``, ``remat``, ``async_fetch``,
    ``supervisor`` and ``data_sharding`` are not ported and raise."""

    def __init__(self, layer, loss_fn, optimizer, data_sharding=None,
                 remat=False, donate=True, amp_dtype=None, accum_steps=1,
                 async_fetch=False, num_inflight_steps=None, supervisor=None):
        unported = {'data_sharding': data_sharding is not None,
                    'remat': bool(remat), 'accum_steps': int(accum_steps) > 1,
                    'async_fetch': bool(async_fetch),
                    'num_inflight_steps': num_inflight_steps is not None,
                    'supervisor': supervisor is not None}
        for name, asked in unported.items():
            if asked:
                raise NotImplementedError(f'TrainStep({name}=...) is not '
                                          f'ported yet (ROADMAP A.4)')
        if amp_dtype is not None and not amp_dtype.is_floating_point:
            raise ValueError(f'amp_dtype must be a floating type, got '
                             f'{amp_dtype}')
        self._layer = layer
        self._loss_fn = loss_fn
        self._opt = optimizer
        self._amp_dtype = amp_dtype

    def _device(self):
        for p in self._layer.parameters():
            return p.device
        return torch.device('cpu')

    def _tensorize(self, batch):
        dev = self._device()
        out = []
        for b in batch:
            t = b if isinstance(b, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(b))
            if not t.is_floating_point() and t.dtype != torch.bool:
                t = t.long()
            out.append(t.to(dev))
        return out

    def __call__(self, *batch):
        batch = self._tensorize(batch)
        params = [p for p in self._layer.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        if self._amp_dtype is None:
            loss = self._loss_fn(self._layer, *batch)
        else:
            with _cast_parameters(self._layer, self._amp_dtype):
                loss = self._loss_fn(self._layer, *batch)
        loss = loss.sum()
        loss.backward()
        self._opt.apply_gradients(params)
        for p in params:
            p.grad = None
        return loss.detach()

    def state(self):
        """({name: parameter}, {name: buffer}) of the layer, detached."""
        return ({n: p.detach() for n, p in self._layer.named_parameters()},
                {n: b.detach() for n, b in self._layer.named_buffers()})
