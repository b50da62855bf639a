"""Op registry of the port: name -> torch function (counterpart of
paddle_tpu/ops/registry.py).

Conventions, as in the JAX package, so a program names the same slots in
both:

- positional parameters of the function are the input slots, in order; a
  slot whose default is ``None`` is optional;
- keyword-only parameters are attrs;
- an op that draws random numbers takes a keyword-only ``key`` and is
  registered with ``needs_rng=True``: here ``key`` is the
  ``torch.Generator`` of the device it runs on (core/random.py), where the
  JAX package passes a PRNG key;
- the output slots default to ``['Out']``; an op with several returns a
  tuple, one value a slot;
- a slot named in ``variadic`` receives a list of tensors.

Gradients come from autograd and shapes from running the function on meta
tensors (layer_helper.py), so an op is its function and nothing else.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ['OpDef', 'register_op', 'find_op', 'get_op', 'has_op', 'all_ops',
           'NON_KERNEL_ATTRS']

_REGISTRY: Dict[str, 'OpDef'] = {}

# program bookkeeping attrs that never reach an op's function
NON_KERNEL_ATTRS = frozenset({'initializer', 'op_device', '_rng_salt'})


class OpDef:
    def __init__(self, name: str, fn: Callable, input_slots: List[str],
                 output_slots: List[str], variadic: frozenset,
                 needs_rng: bool, optional: frozenset,
                 atomic_output: bool = False):
        self.name = name
        self.fn = fn
        self.input_slots = input_slots
        self.output_slots = output_slots
        self.variadic = variadic
        self.needs_rng = needs_rng
        self.optional = optional
        # the single 'Out' result is one value even if it is a list
        self.atomic_output = atomic_output

    def __repr__(self):
        return (f'OpDef({self.name}, in={self.input_slots}, '
                f'out={self.output_slots})')


def register_op(name: str, outputs: Sequence[str] = ('Out',),
                variadic: Sequence[str] = (), needs_rng: bool = False,
                atomic_output: bool = False, optional: Sequence[str] = ()):
    """Decorator registering a torch function as the graph op ``name``;
    returns the function unchanged."""

    def deco(fn):
        sig = inspect.signature(fn)
        input_slots, opt = [], set(optional)
        for pname, p in sig.parameters.items():
            if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                          inspect.Parameter.POSITIONAL_OR_KEYWORD):
                input_slots.append(pname)
                if p.default is None:
                    opt.add(pname)
        unknown = opt - set(input_slots)
        if unknown:
            raise ValueError(
                f'op {name!r}: optional={sorted(unknown)} are not input '
                f'slots (slots: {input_slots})')
        if name in _REGISTRY:
            raise ValueError(f'op {name!r} registered twice')
        _REGISTRY[name] = OpDef(name, fn, input_slots, list(outputs),
                                frozenset(variadic), needs_rng,
                                frozenset(opt), atomic_output)
        return fn

    return deco


def _load_ops():
    """Import every module that registers ops (they import nothing that
    builds a kernel)."""
    from . import (extra_ops, fused_ops, loss_ops,  # noqa: F401
                   math_ops, nn_ops, optimizer_ops, pallas_conv, random_ops,
                   rnn_ops, sequence_ops, tensor_ops)


def find_op(name: str) -> Optional[OpDef]:
    """The op registered as ``name``, None if there is none."""
    if name not in _REGISTRY:
        _load_ops()
    return _REGISTRY.get(name)


def get_op(name: str) -> OpDef:
    op = find_op(name)
    if op is None:
        raise NotImplementedError(
            f'op {name!r} is not ported yet (ROADMAP A.10); ported: '
            f'{sorted(_REGISTRY)}')
    return op


def has_op(name: str) -> bool:
    return find_op(name) is not None


def all_ops():
    _load_ops()
    return dict(_REGISTRY)
