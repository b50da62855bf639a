"""The training step (counterpart of paddle_tpu/dygraph/jit.py's
``TrainStep``).

The JAX step traces forward, backward and the optimizer update into one
jitted XLA program with donated state. PyTorch runs eagerly, so here a call
runs the three in turn on the model's own parameters: ``loss.backward()``
lands the gradients on them and the optimizer updates them in place.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

__all__ = ['TrainStep']


class _LossModule(nn.Module):
    """``loss_fn(layer, *batch)`` as a module over ``layer``'s parameters,
    so that ``functional_call`` can bind other values to them."""

    def __init__(self, layer, loss_fn):
        super().__init__()
        self.layer = layer
        self.loss_fn = loss_fn

    def forward(self, *batch):
        return self.loss_fn(self.layer, *batch)


class TrainStep:
    """``TrainStep(layer, loss_fn, optimizer, amp_dtype=None, donate=True)``;
    ``step(*batch)`` runs ``loss_fn(layer, *batch)``, its backward and one
    ``optimizer`` update of every parameter of ``layer`` that requires a
    gradient, and returns the summed loss as a detached 0-d tensor.

    Batch entries may be numpy arrays or tensors; they are moved to the
    layer's device (integers as int64).

    ``amp_dtype`` (e.g. ``torch.bfloat16``) follows the JAX step's rule: the
    parameters stay f32 masters; inside the autograd graph each floating
    parameter is cast to ``amp_dtype`` and bound to the layer with
    ``torch.func.functional_call`` (the counterpart of ``_bind``), so the
    forward and backward run in ``amp_dtype`` (LayerNorm and softmax
    included), the gradients land on the f32 masters through the casts,
    and the optimizer updates in f32. This is not ``torch.autocast``,
    which would keep LayerNorm and softmax in f32 where the reference does
    not. Buffers are not cast: BatchNorm's running statistics stay f32 and
    move during the step, in place on the layer's own buffers (dygraph/
    nn.py:BatchNorm), as the JAX step returns its new buffers; ``state()``
    returns them.

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
        self._loss = _LossModule(layer, loss_fn)
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
            loss = self._loss(*batch)
        else:
            cast = {f'layer.{n}': (p.to(self._amp_dtype)
                                   if p.is_floating_point() else p)
                    for n, p in self._layer.named_parameters()}
            loss = functional_call(self._loss, cast, tuple(batch))
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
