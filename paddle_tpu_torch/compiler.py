"""CompiledProgram (counterpart of paddle_tpu/compiler.py) on one card.

``CompiledProgram(program).with_data_parallel(loss_name=...)`` is what a
Fluid training script runs its step through. The port runs the program
on the executor's one device: the JAX package shards the feed batch over
its device mesh, and a mesh of several cards is ROADMAP A.9.

What each strategy knob does here:

- ``BuildStrategy.fuse_elewise_add_act_ops`` and
  ``fuse_all_optimizer_ops`` turn on their IR passes (ir/fuse_act.py,
  ir/fuse_optimizer.py), which rewrite a clone of the program before the
  executor builds its plan, as in the JAX package;
- ``fuse_bn_act_ops`` set True raises, naming ROADMAP A.8d: the JAX
  package has no pass for it and ignores it, and the port does not
  ignore a knob in silence;
- ``enable_inplace=False`` or ``memory_optimize=False`` turns off the
  executor's in-place state writes (executor.py), as either turns off
  the JAX package's buffer donation; unset (None) or True leaves them on;
- ``places`` of more than one device, ``num_trainers`` above 1 and
  ``sync_batch_norm`` across them raise, naming A.9;
- ``ExecutionStrategy.num_inflight_steps`` above 1 (the asynchronous
  pipeline) raises at run time, naming A.11;
- the knobs that only touch scheduling across devices or threads
  (``reduce_strategy``, ``gradient_scale_strategy``,
  ``fuse_all_reduce_ops``, ``num_threads``,
  ``num_iteration_per_drop_scope``, ``use_experimental_executor``) are
  accepted, and there is nothing on one card for them to act on.
"""
from __future__ import annotations

__all__ = ['BuildStrategy', 'ExecutionStrategy', 'CompiledProgram']

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
        it is. More than one place raises (ROADMAP A.9: the static
        multi-card path; the dygraph one is dygraph/parallel.py's
        ``DataParallel``)."""
        if places is not None and len(list(places)) > 1:
            raise NotImplementedError(
                f'with_data_parallel over {len(list(places))} places: '
                f'the static multi-card path is not ported yet (ROADMAP '
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
        if bs.fuse_bn_act_ops:
            raise NotImplementedError(
                'BuildStrategy fuse_bn_act_ops: the JAX package has no pass '
                'for it and ignores it; the port has none either and does '
                'not ignore a knob in silence (ROADMAP A.8d)')
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

    def _inplace(self):
        """Whether the executor may write the new state into the scope's
        tensors: not where ``enable_inplace`` or ``memory_optimize`` is
        False (the JAX package's mapping onto its buffer donation)."""
        bs = self._build_strategy
        return not (bs.enable_inplace is False or bs.memory_optimize is False)
