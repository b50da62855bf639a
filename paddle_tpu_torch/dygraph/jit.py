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
from torch.utils.checkpoint import checkpoint

from ..core.random import default_generator

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
    steps after it, as in the JAX step. The optimizer's regularizer and
    gradient clip act on the step's gradients.

    ``accum_steps=k > 1`` is gradient merge, as the JAX step does it:
    each call's gradients add into the parameters' ``.grad`` (the
    accumulators, in the gradient's type: f32 masters under AMP), and
    every k-th call the optimizer runs once on their mean, regularizer and
    clip acting on the merged gradient; then the accumulators are cleared.
    The schedule steps on every call. The call count is a host integer, so
    no call waits on the card.

    ``remat=True`` recomputes the forward in the backward, as
    ``jax.checkpoint(forward)`` does, one repeated block at a time: each
    module of an ``nn.ModuleList`` or ``LayerList`` (BERT's encoder
    layers; the outermost lists only) runs under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps its inputs and
    nothing inside it, and runs again when the backward reaches it; a
    model without such a list is recomputed whole. Each op of the forward
    runs twice and the gradients are those of the step without remat.
    Keeping the blocks' inputs is what lowers the peak: one checkpoint
    around the whole forward rebuilds every activation before the first
    op of the backward, so its peak is the plain step's. A recompute draws
    the same dropout masks: the generators the forward draws from (the
    device's of core/random.py, every ``torch.Generator`` a module holds,
    a seeded ``Dropout``'s) are set back to where the block's first run
    started and put back afterwards, as are torch's global streams
    (``preserve_rng_state``); the block's buffers (running statistics)
    are put back after it, so they move once a step. Under ``amp_dtype``
    the backward runs with the parameters still bound to their casts, so
    a recompute reads the casts the first run read.

    :meth:`snapshot` and :meth:`set_state` save and restore the step's
    state under the JAX package's keys, mid-merge included.

    An optimizer that ``contrib.mixed_precision.decorate`` wrapped runs its
    inner optimizer here, with no overflow gate, as in the JAX step.

    ``donate`` is accepted for the reference's signature: the update is in
    place either way. ``async_fetch``, ``num_inflight_steps`` and
    ``supervisor`` are not ported and raise (ROADMAP A.11), as does
    ``data_sharding`` (ROADMAP A.9)."""

    def __init__(self, layer, loss_fn, optimizer, data_sharding=None,
                 remat=False, donate=True, amp_dtype=None, accum_steps=1,
                 async_fetch=False, num_inflight_steps=None, supervisor=None):
        unported = {'data_sharding': (data_sharding is not None, 'A.9'),
                    'async_fetch': (bool(async_fetch), 'A.11'),
                    'num_inflight_steps': (num_inflight_steps is not None,
                                           'A.11'),
                    'supervisor': (supervisor is not None, 'A.11')}
        for name, (asked, item) in unported.items():
            if asked:
                raise NotImplementedError(f'TrainStep({name}=...) is not '
                                          f'ported yet (ROADMAP {item})')
        if int(accum_steps) < 1:
            raise ValueError(f'accum_steps must be at least 1, got '
                             f'{accum_steps}')
        if amp_dtype is not None and not amp_dtype.is_floating_point:
            raise ValueError(f'amp_dtype must be a floating type, got '
                             f'{amp_dtype}')
        self._layer = layer
        self._loss_fn = loss_fn
        self._opt = optimizer
        self._amp_dtype = amp_dtype
        self._remat = bool(remat)
        self._accum_steps = int(accum_steps)
        self._count = 0           # calls so far

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

    def _generators(self):
        """Every generator the forward may draw from: the device's, each
        seeded ``Dropout``'s (made now if it is not yet) and every
        ``torch.Generator`` a module holds."""
        from .nn import Dropout
        dev = self._device()
        gens = {}
        for g in [default_generator.generator(dev)] + [
                v for m in self._layer.modules()
                for v in ([m._key(dev)] if isinstance(m, Dropout) else [])
                + list(vars(m).values())]:
            if isinstance(g, torch.Generator):
                gens[id(g)] = g
        return list(gens.values())

    def _blocks(self):
        """The modules of the outermost ``nn.ModuleList``s and
        ``LayerList``s of the layer, each checkpointed on its own."""
        from .container import LayerList
        lists, blocks = [], []
        for name, m in self._layer.named_modules():
            if any(name.startswith(p) for p in lists):
                continue
            if isinstance(m, (torch.nn.ModuleList, LayerList)):
                lists.append(f'{name}.' if name else '')
                blocks.extend(m.children())
        return blocks

    @staticmethod
    def _checkpointed(fn, gens, buffers):
        """``fn`` under ``checkpoint``: its recompute starts from the
        generator states of its first run, puts back the states it found
        and the ``buffers`` it moved."""
        start = []

        def run(*args, **kwargs):
            if not start:
                start.append([g.get_state() for g in gens])
                return fn(*args, **kwargs)
            now = [g.get_state() for g in gens]
            kept = [b.detach().clone() for b in buffers]
            for g, st in zip(gens, start[0]):
                g.set_state(st)
            try:
                return fn(*args, **kwargs)
            finally:
                for g, st in zip(gens, now):
                    g.set_state(st)
                with torch.no_grad():
                    for b, k in zip(buffers, kept):
                        b.copy_(k)

        def call(*args, **kwargs):
            return checkpoint(run, *args, use_reentrant=False,
                              preserve_rng_state=True, **kwargs)
        return call

    def _remat_forward(self, batch):
        gens = self._generators()
        blocks = self._blocks()
        if not blocks:
            return self._checkpointed(
                lambda *b: self._loss_fn(self._layer, *b), gens,
                list(self._layer.buffers()))(*batch)
        for m in blocks:
            m.forward = self._checkpointed(m.forward, gens,
                                           list(m.buffers()))
        try:
            return self._loss_fn(self._layer, *batch)
        finally:
            for m in blocks:
                del m.forward

    def __call__(self, *batch):
        batch = self._tensorize(batch)
        params = [p for p in self._layer.parameters() if p.requires_grad]
        k = self._accum_steps
        if self._count % k == 0:
            for p in params:
                p.grad = None
        with (contextlib.nullcontext() if self._amp_dtype is None
              else _cast_parameters(self._layer, self._amp_dtype)):
            loss = (self._remat_forward(batch) if self._remat
                    else self._loss_fn(self._layer, *batch))
            loss = loss.sum()
            loss.backward()        # adds into .grad within a merge
        self._count += 1
        if self._count % k == 0:
            if k > 1:
                with torch.no_grad():
                    torch._foreach_div_(
                        [p.grad for p in params if p.grad is not None], k)
            self._opt.apply_gradients(params)
            for p in params:
                p.grad = None
        else:
            self._opt._step_schedule()
        return loss.detach()

    def state(self):
        """({name: parameter}, {name: buffer}) of the layer, detached."""
        return ({n: p.detach() for n, p in self._layer.named_parameters()},
                {n: b.detach() for n, b in self._layer.named_buffers()})

    def _inner_opt(self):
        """The optimizer that holds the slots (a decorated one's inner)."""
        opt = self._opt
        while not hasattr(opt, '_slots') and hasattr(opt, '_inner'):
            opt = opt._inner
        return opt

    def snapshot(self):
        """The step's state as ``({key: tensor}, meta)``, under the JAX
        package's keys: ``param/<n>``, ``buffer/<n>``, ``slot/<slot>/<n>``
        (the parameters the optimizer has updated), and within a gradient
        merge (``accum_steps > 1``, after the first call) ``acc/<n>`` (the
        merged gradient so far, zeros between merges) and ``accum_count``
        (the calls so far, an int32 tensor); ``meta`` holds ``step`` (the
        calls so far), ``accum_steps`` and, for a schedule,
        ``lr_step_num``. The tensors are clones on the layer's device,
        made without a host sync."""
        opt = self._inner_opt()
        arrays = {}
        for n, p in self._layer.named_parameters():
            arrays[f'param/{n}'] = p.detach().clone()
        for n, b in self._layer.named_buffers():
            arrays[f'buffer/{n}'] = b.detach().clone()
        for n, p in self._layer.named_parameters():
            for s, v in opt._slots.get(id(p), {}).items():
                arrays[f'slot/{s}/{n}'] = v.clone()
        if self._accum_steps > 1 and self._count:
            for n, p in self._layer.named_parameters():
                if p.requires_grad:
                    arrays[f'acc/{n}'] = (
                        torch.zeros_like(p) if p.grad is None
                        else p.grad.detach().clone())
            arrays['accum_count'] = torch.full(
                (), self._count, dtype=torch.int32, device=self._device())
        meta = {'step': self._count, 'accum_steps': self._accum_steps}
        lr = opt._learning_rate
        if hasattr(lr, 'step_num'):
            meta['lr_step_num'] = int(lr.step_num)
        return arrays, meta

    def set_state(self, arrays, meta=None):
        """Restore a :meth:`snapshot` (tensors or arrays), before or after
        the first call; keys it does not know are ignored. The optimizer's
        slots are made where the snapshot has them, and counted as
        ``step // accum_steps`` updates."""
        meta = dict(meta or {})
        opt = self._inner_opt()
        params = dict(self._layer.named_parameters())
        buffers = dict(self._layer.named_buffers())
        if 'step' in meta:
            self._count = int(meta['step'])
        if 'accum_count' in arrays:
            self._count = int(np.asarray(torch.as_tensor(
                arrays['accum_count']).cpu()))
        with torch.no_grad():
            for key, arr in arrays.items():
                kind, _, n = key.partition('/')
                if kind == 'param' and n in params:
                    params[n].copy_(torch.as_tensor(arr))
                elif kind == 'buffer' and n in buffers:
                    buffers[n].copy_(torch.as_tensor(arr))
                elif kind == 'slot':
                    s, _, n = n.partition('/')
                    if n in params and s in opt._slot_names:
                        opt.slots(params[n])[s].copy_(torch.as_tensor(arr))
                        opt._updates[id(params[n])] = \
                            self._count // self._accum_steps
                elif kind == 'acc' and n in params:
                    params[n].grad = torch.as_tensor(arr).to(
                        params[n].device, params[n].dtype).clone()
        lr = opt._learning_rate
        if 'lr_step_num' in meta and hasattr(lr, 'step_num'):
            lr.step_num = meta['lr_step_num']
