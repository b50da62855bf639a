"""Dead-op and dead-variable elimination (counterpart of
paddle_tpu/ir/dce.py).

An op none of whose outputs is read by a later op, fetched or persisted
does nothing for the step, yet the plan would dispatch it every run. The
liveness roots are the JAX package's:

- the run's fetches;
- the persistables (the state the scope gets back);
- the backward marker, whose ``Loss`` input keeps the forward alive.

A reverse walk keeps an op if one of its outputs is live, then marks
everything it reads as live, sub-block reads included
(``framework.op_read_names``), so a branch or a loop body reading an
outer variable keeps its producer.

One rule is the port's own: an op that draws random numbers (its
definition ``needs_rng``, or an op of one of its sub-blocks does) is never
dropped. The port's random ops draw in turn from one generator, so
dropping a dead ``dropout`` would move the draws of every random op after
it; the JAX package drops it, since its ops draw from keys salted with
their original positions (pass_base.py).
"""
from __future__ import annotations

from ..framework import BACKWARD_OP_TYPE, op_read_names, sub_blocks
from ..ops.registry import get_op, has_op
from .pass_base import Pass, register_pass


def draws_random(op):
    """Whether running ``op`` draws from the plan's generator."""
    blocks = sub_blocks(op)
    if blocks:
        program = op.block.program
        return any(draws_random(o) for b in blocks
                   for o in program.block(b).ops)
    return has_op(op.type) and get_op(op.type).needs_rng


@register_pass
class DeadCodeEliminationPass(Pass):
    name = 'dce'
    order = 900          # last: sweeps what the other passes orphaned

    def apply_impl(self, program, ctx):
        blk = program.global_block()
        persist = {v.name for v in program.list_vars() if v.persistable}
        live = set(ctx.fetch_names)
        kept_rev = []
        removed = 0
        for op in reversed(blk.ops):
            if (op.type == BACKWARD_OP_TYPE or draws_random(op)
                    or any(o in live or o in persist
                           for o in op.output_names())):
                kept_rev.append(op)
                live |= op_read_names(op)
            else:
                removed += 1
        if removed:
            blk.ops = kept_rev[::-1]
        dropped_vars = self._drop_dead_vars(blk, persist, ctx)
        ctx.record(self.name, removed_ops=removed, removed_vars=dropped_vars)
        return bool(removed or dropped_vars)

    @staticmethod
    def _drop_dead_vars(blk, persist, ctx):
        """Remove the global-block variables nothing names. Persistables,
        data variables and fetch targets stay."""
        used = set(ctx.fetch_names)
        for op in blk.ops:
            used |= op_read_names(op)
            used |= set(op.output_names())
            # the marker's attrs name variables the executor looks up
            for attr in ('loss', 'params', 'checkpoints'):
                v = op.attrs.get(attr)
                if isinstance(v, str):
                    used.add(v)
                elif isinstance(v, (list, tuple)):
                    used.update(x for x in v if isinstance(x, str))
        dead = [n for n, v in blk.vars.items()
                if n not in used and n not in persist and not v.is_data]
        for n in dead:
            del blk.vars[n]
        return len(dead)
