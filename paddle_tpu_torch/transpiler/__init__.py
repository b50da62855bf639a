"""``fluid.transpiler`` (counterpart of paddle_tpu/transpiler/__init__.py):
``memory_optimize`` and ``release_memory``, no-ops as in the JAX package
(the port reuses memory by its plan's early freeing and in-place state,
executor.py). The distribute transpilers (``DistributeTranspiler``,
``DistributeTranspilerConfig``, ``GeoSgdTranspiler`` and the parameter
server dispatchers) are ROADMAP A.9: each raises naming it."""
from .._not_ported import message

__all__ = ['memory_optimize', 'release_memory']

# the JAX package's names of this module that wait for ROADMAP A.9
NOT_PORTED = ('DistributeTranspiler', 'DistributeTranspilerConfig',
              'GeoSgdTranspiler', 'PSDispatcher', 'HashName', 'RoundRobin')


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=True):
    """No-op: the Executor's plan frees each value after its last reader."""
    return None


def release_memory(input_program, skip_opt_set=None):
    """No-op, as :func:`memory_optimize`."""
    return None


def __getattr__(name):
    if name in NOT_PORTED:
        raise NotImplementedError(message(f'transpiler.{name}', 'A.9'))
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
