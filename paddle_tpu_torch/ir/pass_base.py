"""Program-level IR passes: the Pass base class, its registry and the
manager (counterpart of paddle_tpu/ir/pass_base.py).

A pass rewrites a ``Program``'s global-block op list before the executor
resolves it into a plan (executor.py ``_Plan``). Every op a pass removes
is one dispatch less a step, and every group of optimizer ops it fuses
runs as a few multi-tensor launches (ops/fused_ops.py).

The contract, as in the JAX package:

- passes run in ascending ``order``, ties broken by name, so a pipeline
  built from the same knobs always rewrites the same way;
- a pass never changes the caller's Program: :meth:`PassManager.apply`
  clones it and the passes rewrite the clone.

One rule differs. The JAX package stamps every op with its original
position (``_rng_salt``) and folds it into the op's PRNG key, so no
rewrite can move another op's random stream. The port's random ops draw
in turn from one ``torch.Generator`` (executor.py ``_Step.run``), so the
rule is kept by not touching them: no pass removes, fuses or reorders an
op whose definition ``needs_rng`` (ir/dce.py), and a run with the passes
on draws what a run with them off draws.

Each manager counts, by pass name, how often it applied the pass
(``applied``) and the seconds it took (``elapsed``); with telemetry on
(``observability``) each application also counts into the registry's
``ir_pass_applied_total`` and ``ir_pass_seconds`` by pass, as the JAX
package's do. The verifier hook between passes (``PADDLE_TPU_VERIFY``)
waits for ROADMAP A.11's ``analysis/``.
"""
from __future__ import annotations

import time
from collections import Counter, defaultdict
from typing import Dict, List, Optional

from .. import observability as _obs

__all__ = ['Pass', 'PassContext', 'PassManager', 'register_pass',
           'get_pass', 'all_passes']

_PASS_REGISTRY: Dict[str, 'Pass'] = {}


class PassContext:
    """What a pass may consult (the run's fetches and feeds, the
    ``BuildStrategy``) and the counts the passes record."""

    def __init__(self, fetch_names=(), feed_names=(), build_strategy=None):
        self.fetch_names = tuple(fetch_names)
        self.feed_names = tuple(feed_names)
        self.build_strategy = build_strategy
        # pass name -> {'removed_ops': n, 'fused_pairs': n, ...}
        self.stats: Dict[str, Dict[str, int]] = {}

    def record(self, pass_name, **counts):
        d = self.stats.setdefault(pass_name, {})
        for k, v in counts.items():
            d[k] = d.get(k, 0) + int(v)


class Pass:
    """One deterministic Program rewrite. A subclass sets ``name`` and
    ``order`` and implements :meth:`apply_impl`, which returns True if it
    changed the program."""

    name: str = None
    # folding runs before fusion so fused patterns see folded constants;
    # DCE runs last to sweep what the others orphaned
    order: int = 100

    def apply(self, program, ctx: PassContext) -> bool:
        return self.apply_impl(program, ctx)

    def apply_impl(self, program, ctx: PassContext) -> bool:
        raise NotImplementedError


def register_pass(cls):
    """Class decorator: add a Pass subclass to the registry (one name,
    one pass)."""
    if not cls.name:
        raise ValueError(f'{cls.__name__} has no pass name')
    if cls.name in _PASS_REGISTRY:
        raise ValueError(f'IR pass {cls.name!r} registered twice')
    _PASS_REGISTRY[cls.name] = cls()
    return cls


def get_pass(name: str) -> Pass:
    if name not in _PASS_REGISTRY:
        raise KeyError(f'unknown IR pass {name!r}; registered: '
                       f'{sorted(_PASS_REGISTRY)}')
    return _PASS_REGISTRY[name]


def all_passes():
    return dict(_PASS_REGISTRY)


class PassManager:
    """Applies a fixed sequence of passes to a clone of a Program."""

    def __init__(self, passes: List[Pass]):
        self.passes = sorted(passes, key=lambda p: (p.order, p.name))
        self.applied = Counter()
        self.elapsed = defaultdict(float)

    def apply(self, program, ctx: Optional[PassContext] = None):
        """Returns ``(the rewritten clone, ctx)``; ``program`` is left as
        it was. The clone is returned even where no pass changed it."""
        ctx = ctx or PassContext()
        opt = program.clone()
        for p in self.passes:
            t0 = time.perf_counter()
            p.apply(opt, ctx)
            dt = time.perf_counter() - t0
            self.elapsed[p.name] += dt
            self.applied[p.name] += 1
            if _obs._ENABLED:
                _obs.inc('ir_pass_applied_total', 1,
                         help='IR pass executions by pass name',
                         **{'pass': p.name})
                _obs.observe('ir_pass_seconds', dt,
                             help='wall time per IR pass application',
                             **{'pass': p.name})
        return opt, ctx

    def names(self):
        return tuple(p.name for p in self.passes)
