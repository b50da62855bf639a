"""``fuse_elewise_add_act``: ``elementwise_add`` + activation -> one
``fused_elemwise_add_activation`` op (counterpart of
paddle_tpu/ir/fuse_act.py, the reference's fuse_elewise_add_act_pass.cc),
on ``BuildStrategy.fuse_elewise_add_act_ops``.

A pair (the add at i, the activation at j > i) fuses only where, as in
the JAX package:

- the sum is read by the activation alone (sub-block reads counted), is
  not fetched, not persistable, not a recompute checkpoint, and has no
  other writer;
- nothing between i and j writes the add's inputs (the fused op reads
  them at j).

The pass is off under static AMP: the casts key on op types
(executor.py ``_amp_target``), and a fused op would be cast otherwise.
"""
from __future__ import annotations

from ..framework import Operator, op_read_names
from .pass_base import Pass, register_pass

# the activations ops/fused_ops.py implements
FUSABLE_ACTS = ('relu', 'sigmoid', 'tanh')


@register_pass
class FuseElewiseAddActPass(Pass):
    name = 'fuse_elewise_add_act'
    order = 200

    def enabled(self, ctx):
        bs = ctx.build_strategy
        return bs is not None and getattr(bs, 'fuse_elewise_add_act_ops',
                                          False)

    def apply_impl(self, program, ctx):
        if not self.enabled(ctx) or getattr(program, '_amp_config', None):
            return False
        blk = program.global_block()
        ops = blk.ops
        fetch = set(ctx.fetch_names)
        persist = {v.name for v in program.list_vars() if v.persistable}
        # names the executor reads through the marker's attrs
        protected = set()
        for op in ops:
            protected.update(op.attrs.get('checkpoints') or [])

        readers, writers = {}, {}        # var -> [op index]
        for idx, op in enumerate(ops):
            for n in op_read_names(op):
                readers.setdefault(n, []).append(idx)
            for n in op.output_names():
                writers.setdefault(n, []).append(idx)

        replaced = {}                    # activation index -> fused op
        dead = set()                     # add indices to drop
        for i, add in enumerate(ops):
            if add.type != 'elementwise_add':
                continue
            mid = add.outputs['Out'][0]
            if (mid in fetch or mid in persist or mid in protected
                    or writers.get(mid, []) != [i]):
                continue
            cons = readers.get(mid, [])
            if len(cons) != 1:
                continue
            j = cons[0]
            act = ops[j]
            if (j <= i or j in replaced or act.type not in FUSABLE_ACTS
                    or act.inputs.get('x', [None])[0] != mid):
                continue
            x, y = add.inputs['x'][0], add.inputs['y'][0]
            if any(i < k < j for n in (x, y) for k in writers.get(n, [])):
                continue
            replaced[j] = Operator(
                blk, 'fused_elemwise_add_activation',
                inputs={'x': x, 'y': y},
                outputs={'Out': list(act.outputs['Out'])},
                attrs={'functor': act.type,
                       'axis': add.attrs.get('axis', -1)})
            dead.add(i)
        if not replaced:
            return False
        blk.ops = [replaced.get(idx, op) for idx, op in enumerate(ops)
                   if idx not in dead]
        ctx.record(self.name, fused_pairs=len(replaced))
        return True
