"""Dygraph-to-static and the training step (counterpart of
paddle_tpu/dygraph/jit.py).

``to_static`` / ``declarative`` (:class:`StaticFunction`). The JAX package
traces the eager function once per input signature into one jitted XLA
program. PyTorch has no such compiler on this path, so here an entry of the
cache keeps what the JAX entry keys and counts, and a call runs the
function eagerly, through torch's autograd:

- the cache key is the JAX one: ``(signature, grad mode, which arguments
  require grad)``; the signature holds the shape and type of each array
  argument, ``repr`` of each other one, and the keyword arguments sorted;
- ``_compile_count`` rises once a new key, and the bound copies that
  ``__get__`` makes for a method share it; each instance has its own
  cache in a ``WeakKeyDictionary``, which dies with the instance;
- an entry holds the parameters and buffers of the layers found for it
  (:func:`_find_layers`: the bound instance, layer arguments, closure
  cells and module globals one container deep).

A call then runs on the device its tensors are on. In grad mode the
gradients reach the parameters and every tensor argument that requires
one, keyword arguments included; outside it the outputs come back with
``stop_gradient=True``. Random ops draw fresh values on every call (the
JAX entry takes a new key a call), and buffers such as BatchNorm's running
statistics move as in eager mode. ``ProgramTranslator().enable(False)``
runs the plain function and counts nothing. An :class:`InputSpec` casts its
argument to its type; ``int64`` data outside the int32 range raises
``OverflowError``, as the JAX package's ``check_int32_bounds`` would,
though the port keeps int64 (the JAX entry never reaches that check and
wraps: ROADMAP C.19).

Where eager execution departs from the trace (ROADMAP C.17): a module
global rebound to a new Layer after the first call is read anew by each
call here, where the JAX entry keeps the parameters of the layer it found.

:class:`TracedLayer` snapshots the layer's parameters and buffers when it
traces (copies, as the JAX package's arrays are values) and the train or
eval mode of each module (the JAX function is traced once, in that mode),
so a later update of the layer does not change what the traced layer
returns; ``save_inference_model`` writes them as ``jit_params.npz`` and
``jit_buffers.npz`` under the JAX package's names (io.py).

:class:`TrainStep` traces forward, backward and the optimizer update into
one jitted XLA program with donated state in the JAX package. Here a call
runs the three in turn on the model's own parameters: ``loss.backward()``
lands the gradients on them and the optimizer updates them in place.
"""
from __future__ import annotations

import contextlib
import functools
import weakref

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.dtypes import to_torch_dtype
from ..core.random import default_generator
from .tape import Tensor, _wrap

__all__ = ['TrainStep', 'functionalize', 'TracedLayer', 'InputSpec',
           'ProgramTranslator', 'StaticFunction', 'declarative',
           'to_static']

_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def _module_slots(layer, kind):
    """{structured name: (the module's ``kind`` dict, key)} of every
    parameter (``kind`` '_parameters') or buffer ('_buffers') of
    ``layer``, each name of a shared one included, as the JAX package's
    ``named_parameters`` lists them."""
    out = {}
    for mname, mod in layer.named_modules(remove_duplicate=False):
        store = getattr(mod, kind)
        for name, t in store.items():
            if t is not None:
                out[f'{mname}.{name}' if mname else name] = (store, name)
    return out


@contextlib.contextmanager
def _bind(slots, values):
    """Bind ``values`` by structured name in place of the tensors at
    ``slots`` for the ``with`` body; the tensors come back after it."""
    saved = [(store, name, store[name]) for store, name in slots.values()]
    try:
        for n, (store, name) in slots.items():
            if n in values:
                store[name] = values[n]
        yield
    finally:
        for store, name, t in saved:
            store[name] = t


def _devalue(out):
    """``out`` with every tensor detached (a list or tuple keeps its
    kind)."""
    if isinstance(out, torch.Tensor):
        return torch.Tensor.detach(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_devalue(o) for o in out)
    return out


def _snapshot(slots):
    return {n: torch.Tensor.detach(store[name]).clone()
            for n, (store, name) in slots.items()}


def functionalize(layer):
    """``layer`` -> ``(apply_fn, params, buffers)``:
    ``apply_fn(params, buffers, *args)`` returns ``(outputs,
    new_buffers)`` and changes nothing it was given (the buffers are
    bound as copies, which the layer's in-place updates move); ``params``
    and ``buffers`` are copies of the layer's values by structured name,
    taken now."""
    pslots = _module_slots(layer, '_parameters')
    bslots = _module_slots(layer, '_buffers')

    def apply_fn(param_vals, buffer_vals, *args):
        bufs = {n: v.clone() for n, v in buffer_vals.items()}
        with _bind(pslots, param_vals), _bind(bslots, bufs), \
                torch.no_grad():
            out = layer(*args)
            new_buffers = {n: store[name]
                           for n, (store, name) in bslots.items()}
        return _devalue(out), new_buffers

    return apply_fn, _snapshot(pslots), _snapshot(bslots)


def _layer_device(layer):
    for t in layer.parameters():
        return t.device
    for t in layer.buffers():
        return t.device
    from .base import _current_device
    return _current_device()


class TracedLayer:
    """A layer's forward over the parameter and buffer values it had when
    :meth:`trace` ran (``jit.py:73-92`` of the JAX package, where they are
    the arguments of one jitted function), in the train or eval mode each
    of its modules had then (the JAX function is traced once, in that
    mode). ``TracedLayer.trace(layer, inputs)`` returns ``(outputs,
    traced)``; ``traced(*inputs)`` runs without gradients and returns
    tensors with ``stop_gradient=True``."""

    def __init__(self, layer, apply_fn, params, buffers):
        self._layer = layer
        self._apply = apply_fn
        self._params = params
        self._buffers = buffers
        self._modes = [(m, m.training) for m in layer.modules()]

    @staticmethod
    def trace(layer, inputs):
        apply_fn, params, buffers = functionalize(layer)
        traced = TracedLayer(layer, apply_fn, params, buffers)
        out = traced(*inputs)
        return out, traced

    def __call__(self, *args):
        dev = _layer_device(self._layer)
        vals = [a if isinstance(a, torch.Tensor)
                else torch.as_tensor(np.asarray(a), device=dev)
                for a in args]
        now = [(m, m.training) for m, _ in self._modes]
        try:
            for m, mode in self._modes:
                m.training = mode
            out, _ = self._apply(self._params, self._buffers, *vals)
        finally:
            for m, mode in now:
                m.training = mode
        return _wrap(out)

    def save_inference_model(self, dirname, feed=None, fetch=None):
        """``jit_params.npz`` and ``jit_buffers.npz`` of the traced values
        under ``dirname`` (io.py's ``_save_jit_model``)."""
        from ..io import _save_jit_model
        _save_jit_model(dirname, self._layer, self._params, self._buffers)


class InputSpec:
    """Declared input signature for ``to_static``: ``shape`` entries of
    None mean any size (each distinct size is one entry); ``dtype`` casts
    the argument."""

    def __init__(self, shape, dtype='float32', name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name


class ProgramTranslator:
    """The process-wide switch: ``enable(False)`` makes every
    :class:`StaticFunction` run its plain function. ``get_output(fn,
    *args, **kwargs)`` calls ``fn`` through a :class:`StaticFunction`
    kept for it."""

    _instance = None
    enabled = True

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def enable(self, flag: bool):
        ProgramTranslator.enabled = bool(flag)

    _fn_cache = {}

    def get_output(self, fn, *args, **kwargs):
        if isinstance(fn, StaticFunction):
            sf = fn
        else:
            sf = ProgramTranslator._fn_cache.get(fn)
            if sf is None:
                sf = ProgramTranslator._fn_cache.setdefault(
                    fn, StaticFunction(fn))
        return sf(*args, **kwargs)


def _find_layers(fn, instance, args, kwargs):
    """The layers a call of ``fn`` may read: the bound instance, layer
    arguments, layers in the function's closure cells and in its module
    globals, each also one list, tuple or dict deep."""
    layers = []
    seen = set()

    def add(obj, depth=0):
        if isinstance(obj, nn.Module):
            if id(obj) not in seen:
                seen.add(id(obj))
                layers.append(obj)
        elif depth < 1:
            if isinstance(obj, (list, tuple)):
                for v in obj:
                    add(v, depth + 1)
            elif isinstance(obj, dict):
                for v in obj.values():
                    add(v, depth + 1)

    add(instance)
    for a in args:
        add(a)
    for a in kwargs.values():
        add(a)
    raw = getattr(fn, '__wrapped__', fn)
    for cell in (getattr(raw, '__closure__', None) or ()):
        try:
            add(cell.cell_contents)
        except ValueError:
            pass
    for v in getattr(raw, '__globals__', {}).values():
        add(v)
    return layers


def _is_array_like(x):
    return isinstance(x, (torch.Tensor, np.ndarray)) or (
        hasattr(x, 'shape') and hasattr(x, 'dtype'))


def _check_int32_bounds(value, name):
    """The JAX package's check of int64 data that int32 cannot hold; the
    port keeps int64, and raises all the same so that both packages take
    the same inputs."""
    if value.dtype == torch.int64 and value.numel():
        if int(value.max()) > _INT32_MAX or int(value.min()) < _INT32_MIN:
            raise OverflowError(
                f'int64 feed {name!r} holds values outside int32 range '
                f'[{_INT32_MIN}, {_INT32_MAX}]; the JAX package computes '
                f'int64 as int32 and the port takes the same inputs')


class _Entry:
    """What one cache key holds: the parameters and buffers of the layers
    found for it, by ``'<layer index>.<name>'`` (not the layers: an entry
    that held its instance would keep the instance's cache alive)."""

    __slots__ = ('params', 'buffers')

    def __init__(self, layers):
        self.params, self.buffers = {}, {}
        for li, layer in enumerate(layers):
            for n, p in layer.named_parameters():
                self.params[f'{li}.{n}'] = p
            for n, b in layer.named_buffers():
                self.buffers[f'{li}.{n}'] = b


class StaticFunction:
    """``@to_static`` on a function or a method (see the module
    docstring): a cache of entries by input signature, grad mode and the
    arguments that require grad, and an eager call."""

    def __init__(self, fn, input_spec=None):
        functools.update_wrapper(self, fn)
        self._fn = fn
        self._input_spec = input_spec
        self._instance = None
        self._cache = {}
        self._instance_caches = weakref.WeakKeyDictionary()
        # shared with the bound copies __get__ makes
        self._stats = {'compiles': 0}
        self._is_declarative = True

    @property
    def _compile_count(self):
        return self._stats['compiles']

    def __get__(self, instance, owner):
        if instance is None:
            return self
        bound = StaticFunction.__new__(StaticFunction)
        bound.__dict__ = dict(self.__dict__)
        bound._instance = instance
        return bound

    def _split_args(self, args, kwargs):
        """-> (positional, keyword, signature): array arguments become
        tensors (numpy ones on the dygraph device, taking no gradient),
        cast to their :class:`InputSpec`'s type; the rest pass as they
        are and enter the signature by ``repr``."""
        spec = self._input_spec
        sig = []

        def classify(x, spec_i=None):
            if not _is_array_like(x):
                sig.append(('static', repr(x)))
                return x
            if not isinstance(x, torch.Tensor):
                x = Tensor(np.asarray(x), stop_gradient=True)
            if spec_i is not None and spec_i.dtype is not None:
                if str(spec_i.dtype) == 'int64':
                    _check_int32_bounds(x, 'InputSpec')
                x = _wrap(torch.Tensor.to(x, to_torch_dtype(spec_i.dtype)))
            sig.append(('arr', tuple(x.shape), str(x.dtype)))
            return x

        pos = [classify(a, spec[i] if spec is not None and i < len(spec)
                        else None) for i, a in enumerate(args)]
        kw = {}
        for k in sorted(kwargs):
            sig.append(('kw', k))
            kw[k] = classify(kwargs[k])
        return pos, kw, tuple(sig)

    def _entry_cache(self):
        if self._instance is None:
            return self._cache
        cache = self._instance_caches.get(self._instance)
        if cache is None:
            cache = self._instance_caches.setdefault(self._instance, {})
        return cache

    def __call__(self, *args, **kwargs):
        if self._instance is not None:
            call = functools.partial(self._fn, self._instance)
        else:
            call = self._fn
        if not ProgramTranslator.enabled:
            return call(*args, **kwargs)
        pos, kw, sig = self._split_args(args, kwargs)
        ordered = list(args) + [kwargs[k] for k in sorted(kwargs)]
        arg_req = tuple(isinstance(a, torch.Tensor) and a.requires_grad
                        for a in ordered)
        key = (sig, torch.is_grad_enabled(), arg_req)
        cache = self._entry_cache()
        if key not in cache:
            cache[key] = _Entry(_find_layers(self._fn, self._instance,
                                             args, kwargs))
            self._stats['compiles'] += 1
        return _wrap(call(*pos, **kw))


def declarative(fn=None, input_spec=None):
    """``@declarative`` / ``@to_static``, with or without ``input_spec``:
    a :class:`StaticFunction` of ``fn``."""
    if fn is None:
        return lambda f: StaticFunction(f, input_spec=input_spec)
    return StaticFunction(fn, input_spec=input_spec)


to_static = declarative


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
