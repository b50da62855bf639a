"""CompiledProgram (counterpart of paddle_tpu/compiler.py) on one card.

``CompiledProgram(program).with_data_parallel(loss_name=...)`` is what a
Fluid training script runs its step through. The port runs the program
as it is on the executor's one device: the JAX package shards the feed
batch over its device mesh, and a mesh of several cards is ROADMAP A.9.

What each strategy knob does here:

- the knobs that rewrite the program before it runs
  (``BuildStrategy.fuse_elewise_add_act_ops``, ``fuse_all_optimizer_ops``,
  ``fuse_bn_act_ops`` set True) raise at run time, naming ROADMAP A.8d
  (the IR passes);
- ``places`` of more than one device, ``num_trainers`` above 1 and
  ``sync_batch_norm`` across them raise, naming A.9;
- ``ExecutionStrategy.num_inflight_steps`` above 1 (the asynchronous
  pipeline) raises at run time, naming A.11;
- the knobs that only touch memory or scheduling (``enable_inplace``,
  ``memory_optimize``, ``reduce_strategy``, ``gradient_scale_strategy``,
  ``fuse_all_reduce_ops``, ``num_threads``,
  ``num_iteration_per_drop_scope``, ``use_experimental_executor``) are
  accepted, and the port does not act on them: the plan frees nothing
  early and updates no buffer in place (ROADMAP A.8f).
"""
from __future__ import annotations

__all__ = ['BuildStrategy', 'ExecutionStrategy', 'CompiledProgram']

# BuildStrategy knobs that rewrite the program (the JAX package's IR passes)
_PROGRAM_REWRITES = ('fuse_elewise_add_act_ops', 'fuse_all_optimizer_ops',
                     'fuse_bn_act_ops')


class BuildStrategy:
    """The reference's build knobs, with its defaults (see the module's
    docstring for what the port does with each)."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.fuse_all_optimizer_ops = False
        self.memory_optimize = None
        self.enable_inplace = None
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """The reference's execution knobs, with its defaults (see the
    module's docstring)."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 100
        self.use_experimental_executor = False
        self.num_inflight_steps = 1


class CompiledProgram:
    """A Program and the strategies to run it with; ``Executor.run``
    takes it where it takes a Program."""

    def __init__(self, program_or_graph, build_strategy=None,
                 exec_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = exec_strategy

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        """Data parallelism over ``places``: on one card, the program as
        it is. More than one place raises (ROADMAP A.9)."""
        if places is not None and len(list(places)) > 1:
            raise NotImplementedError(
                f'with_data_parallel over {len(list(places))} places: '
                f'data parallelism across cards is not ported yet (ROADMAP '
                f'A.9)')
        if build_strategy is not None:
            self._build_strategy = build_strategy
        if exec_strategy is not None:
            self._exec_strategy = exec_strategy
        return self

    def _program_to_run(self):
        """The program, once the strategies have been checked against
        what the port does."""
        bs, es = self._build_strategy, self._exec_strategy
        on = [k for k in _PROGRAM_REWRITES if getattr(bs, k, False)]
        if on:
            raise NotImplementedError(
                f'BuildStrategy {", ".join(on)}: the program-rewriting '
                f'passes are not ported yet (ROADMAP A.8d)')
        if bs.num_trainers > 1 or bs.sync_batch_norm:
            raise NotImplementedError(
                'num_trainers > 1 and sync_batch_norm need several cards, '
                'not ported yet (ROADMAP A.9)')
        if es is not None and es.num_inflight_steps > 1:
            raise NotImplementedError(
                f'num_inflight_steps={es.num_inflight_steps}: the '
                f'asynchronous step pipeline is not ported yet (ROADMAP '
                f'A.11)')
        return self._program
