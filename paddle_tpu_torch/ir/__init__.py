"""Program-level IR pass pipeline (counterpart of paddle_tpu/ir/; the
design notes are in pass_base.py).

- :func:`apply_pipeline` is what ``Executor.run`` calls when it builds a
  plan: the pipeline for the run's ``BuildStrategy``, applied to a clone,
  and the rewritten clone returned.
- :func:`pipeline_signature` is the hashable list of the passes that
  would change something; it is part of the executor's plan key, so a
  flipped knob or ``PADDLE_TPU_PASSES`` builds a new plan.

``PADDLE_TPU_PASSES``, as in the JAX package: unset or ``1`` runs the
default pipeline (``constant_fold`` and ``dce`` always, the fuse passes
where their ``BuildStrategy`` knob is set); ``0`` or empty runs none; a
comma list (``dce,fuse_all_optimizer_ops``) runs exactly those passes,
knobs ignored.

The JAX package's default pipeline also holds ``bucket_allreduce``
(waits for the mesh, ROADMAP A.9) and ``auto_remat`` (waits for the
static memory plan of ``analysis/``, A.11); naming either raises.
"""
from __future__ import annotations

import os

from .pass_base import (Pass, PassContext, PassManager, all_passes,  # noqa: F401
                        get_pass, register_pass)
from . import constant_fold, dce, fuse_act, fuse_optimizer  # noqa: F401

__all__ = ['Pass', 'PassContext', 'PassManager', 'register_pass',
           'get_pass', 'all_passes', 'apply_pipeline', 'build_pipeline',
           'pipeline_signature', 'passes_env']

_DEFAULT_PASSES = ('constant_fold', 'fuse_elewise_add_act',
                   'fuse_all_optimizer_ops', 'dce')

# the JAX package's passes the port does not have yet
_WAITING = {'bucket_allreduce': 'A.9', 'auto_remat': 'A.11'}

_FLAG_GATED = {'fuse_elewise_add_act': 'fuse_elewise_add_act_ops',
               'fuse_all_optimizer_ops': 'fuse_all_optimizer_ops'}


def passes_env():
    return os.environ.get('PADDLE_TPU_PASSES', '1')


def _selected_names():
    env = passes_env().strip()
    if env in ('0', ''):
        return ()
    if env == '1':
        return _DEFAULT_PASSES
    names = tuple(n.strip() for n in env.split(',') if n.strip())
    for n in names:
        if n in _WAITING:
            raise NotImplementedError(
                f'PADDLE_TPU_PASSES names {n!r}, which is not ported yet '
                f'(ROADMAP {_WAITING[n]})')
    return names


def build_pipeline():
    """The PassManager of the current selection (may hold no pass)."""
    return PassManager([get_pass(n) for n in _selected_names()])


def pipeline_signature(build_strategy=None):
    """The passes that would change something, for the plan key."""
    names = _selected_names()
    if passes_env().strip() == '1':
        # a knob-gated pass counts only where its knob is set
        bs = build_strategy
        names = tuple(
            n for n in names
            if n not in _FLAG_GATED
            or (bs is not None and getattr(bs, _FLAG_GATED[n], False)))
    return names


def apply_pipeline(program, fetch_names=(), feed_names=(),
                   build_strategy=None):
    """``(the rewritten clone of program, the PassContext)``, or
    ``(program, ctx)`` itself where no pass is selected."""
    mgr = build_pipeline()
    ctx = PassContext(fetch_names=fetch_names, feed_names=feed_names,
                      build_strategy=build_strategy)
    if not mgr.passes:
        return program, ctx
    return mgr.apply(program, ctx)
