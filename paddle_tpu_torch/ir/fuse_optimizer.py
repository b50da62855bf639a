"""``fuse_all_optimizer_ops``: the per-parameter ``sgd`` / ``momentum`` /
``adam`` ops -> one multi-tensor op a group (counterpart of
paddle_tpu/ir/fuse_optimizer.py, the reference's fuse_optimizer_ops_pass),
on ``BuildStrategy.fuse_all_optimizer_ops``.

After ``minimize`` the global block ends in one update op a parameter,
each a handful of launches. Ops fuse into one group where, as in the JAX
package, they agree on the op type, the hyperparameters, the
learning-rate variable and the type (f32 alone), and the group is
independent of every op between its first and last member: no member
reads what another writes, and no op between them reads or writes what
the group touches. The fused op runs at the first member's position
(ops/fused_ops.py), so each parameter gets the bits its own op gives.
Updates inside a ``cond`` sub-block (gradient merge, fp16 loss scaling)
are not touched.

The JAX package also fuses ``lars_momentum``, which waits for
``LarsMomentum`` (ROADMAP A.4b).
"""
from __future__ import annotations

from ..framework import Operator, op_read_names
from ..ops.registry import NON_KERNEL_ATTRS
from .pass_base import Pass, register_pass

# per-parameter op -> (fused op, (its input slot, the fused list slot),
#                      the output slots, shared)
FUSE_SPECS = {
    'sgd': ('fused_sgd',
            (('param', 'params'), ('grad', 'grads')),
            ('ParamOut',)),
    'momentum': ('fused_momentum',
                 (('param', 'params'), ('grad', 'grads'),
                  ('velocity', 'velocities')),
                 ('ParamOut', 'VelocityOut')),
    'adam': ('fused_adam',
             (('param', 'params'), ('grad', 'grads'),
              ('moment1', 'moment1s'), ('moment2', 'moment2s'),
              ('beta1_pow', 'beta1_pows'), ('beta2_pow', 'beta2_pows')),
             ('ParamOut', 'Moment1Out', 'Moment2Out', 'Beta1PowOut',
              'Beta2PowOut')),
}


def _attr_sig(op):
    return tuple(sorted((k, repr(v)) for k, v in op.attrs.items()
                        if k not in NON_KERNEL_ATTRS))


def _is_f32(blk, name):
    return (not blk.has_var(name)) or blk.var(name).dtype == 'float32'


@register_pass
class FuseAllOptimizerOpsPass(Pass):
    name = 'fuse_all_optimizer_ops'
    order = 300

    def enabled(self, ctx):
        bs = ctx.build_strategy
        return bs is not None and getattr(bs, 'fuse_all_optimizer_ops',
                                          False)

    def apply_impl(self, program, ctx):
        if not self.enabled(ctx):
            return False
        blk = program.global_block()
        ops = blk.ops
        groups = {}          # (type, attr sig, lr name) -> [op index]
        for i, op in enumerate(ops):
            if op.type not in FUSE_SPECS:
                continue
            if not all(_is_f32(blk, n) for n in op.input_names()):
                continue
            lr = op.inputs.get('lr', [None])[0]
            groups.setdefault((op.type, _attr_sig(op), lr), []).append(i)

        fused_groups = fused_ops = 0
        dead, replaced = set(), {}
        for (op_type, _, lr), idxs in sorted(groups.items(),
                                             key=lambda kv: kv[1][0]):
            if len(idxs) < 2 or not self._independent(ops, idxs, lr):
                continue
            fused_type, slot_map, out_slots = FUSE_SPECS[op_type]
            members = [ops[i] for i in idxs]
            inputs = {fused: [m.inputs[per][0] for m in members]
                      for per, fused in slot_map}
            if lr is not None:
                inputs['lr'] = lr
            outputs = {s: [m.outputs[s][0] for m in members]
                       for s in out_slots}
            replaced[idxs[0]] = Operator(blk, fused_type, inputs=inputs,
                                         outputs=outputs,
                                         attrs=dict(members[0].attrs))
            dead.update(idxs[1:])
            fused_groups += 1
            fused_ops += len(idxs)
        if not fused_groups:
            return False
        blk.ops = [replaced.get(i, op) for i, op in enumerate(ops)
                   if i not in dead]
        ctx.record(self.name, fused_groups=fused_groups,
                   fused_update_ops=fused_ops)
        return True

    @staticmethod
    def _independent(ops, idxs, lr):
        """Members update only their own parameter and slots, and nothing
        between the first and the last touches the group's variables (the
        fused op runs at the first member's position)."""
        member = set(idxs)
        reads, writes = set(), set()
        for i in idxs:
            ins, outs = set(ops[i].input_names()), set(ops[i].output_names())
            if (ins - {lr}) & reads or outs & writes:
                return False
            reads |= ins          # lr stays: a write of it in between
            writes |= outs        # would give members different rates
        for k in range(idxs[0], idxs[-1] + 1):
            if k in member:
                continue
            o_reads, o_writes = op_read_names(ops[k]), set(
                ops[k].output_names())
            if (o_reads & writes) or (o_writes & (reads | writes)):
                return False
        return True
