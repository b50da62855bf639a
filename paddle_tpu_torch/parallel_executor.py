"""``ParallelExecutor`` (counterpart of paddle_tpu/parallel_executor.py):
``CompiledProgram(main_program).with_data_parallel(...)`` run on the port's
``Executor``, on the card by default (``use_cuda=True``; ``False`` is the
CPU). One process drives one card here; data parallelism across processes
in a static program (``num_trainers > 1``, the static fleet path) is not
ported yet and raises naming ROADMAP A.9, where the JAX package ignores
it."""
from __future__ import annotations

from .compiler import CompiledProgram
from .core.places import CPUPlace, CUDAPlace
from .core.scope import global_scope
from .executor import Executor
from .framework import default_main_program

__all__ = ['ParallelExecutor']


class ParallelExecutor:
    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None, build_strategy=None,
                 num_trainers=1, trainer_id=0, scope=None):
        if num_trainers > 1:
            raise NotImplementedError(
                f'ParallelExecutor(num_trainers={num_trainers}): data '
                f'parallelism across processes in a static program is not '
                f'ported yet (ROADMAP A.9)')
        self._program = main_program or default_main_program()
        self._compiled = CompiledProgram(
            self._program, build_strategy).with_data_parallel(
                loss_name=loss_name, exec_strategy=exec_strategy)
        self._exe = Executor(CUDAPlace(0) if use_cuda else CPUPlace())
        self._scope = scope or global_scope()

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._exe.run(self._compiled, feed=feed, fetch_list=fetch_list,
                             scope=self._scope, return_numpy=return_numpy)

    def drop_local_exe_scopes(self):
        pass
