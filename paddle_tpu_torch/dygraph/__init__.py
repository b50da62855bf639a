"""Imperative (dygraph) mode of the port (counterpart of
paddle_tpu/dygraph/): ``guard``, ``to_variable``, the VarBase API on torch
tensors (tape.py), ``Layer`` and its containers, the layers (nn.py),
learning-rate schedules, ``save_dygraph``/``load_dygraph`` and the fused
training step (jit.py), under the JAX package's names.

The names the JAX package exports that are not ported yet raise
``NotImplementedError`` naming their ROADMAP item when used:
``DataParallel``, ``ParallelEnv`` and ``prepare_context`` (A.9);
``TracedLayer``, ``declarative``, ``to_static`` and its aliases,
``ProgramTranslator``, ``StaticFunction``, ``InputSpec`` and the gperf
profiler hooks (A.4).
"""
from . import jit
from .base import (Tracer, disable_dygraph, eager_kernel_cache_guard,
                   enable_dygraph, enabled, guard, set_eager_kernel_cache,
                   to_variable)
from .checkpoint import load_dygraph, save_dygraph
from .container import LayerList, ParameterList, Sequential
from .jit import TrainStep
from .layers import Layer
from .learning_rate_scheduler import (CosineDecay, ExponentialDecay,
                                      InverseTimeDecay, LearningRateDecay,
                                      LinearLrWarmup, NaturalExpDecay,
                                      NoamDecay, PiecewiseDecay,
                                      PolynomialDecay)
from .nn import (NCE, BatchNorm, BilinearTensorProduct, Conv2D,
                 Conv2DTranspose, Conv3D, Conv3DTranspose, Dropout,
                 Embedding, GroupNorm, GRUUnit, LayerNorm, Linear, Pool2D,
                 PRelu, SpectralNorm, TreeConv)
from .tape import (Parameter, Tensor, dispatch_op, grad, no_grad,
                   no_grad_guard)
from ..layer_helper import LayerHelper as LayerObjectHelper


class BackwardStrategy:
    """Accepted for the reference's API: ``sort_sum_gradient`` changes
    nothing, torch's autograd accumulates in one fixed order."""

    def __init__(self):
        self.sort_sum_gradient = False


def monkey_patch_varbase():
    """Nothing to do: Tensor and Parameter carry the VarBase methods."""


monkey_patch_math_varbase = monkey_patch_varbase


def _unported(name, item, kind='function'):
    msg = f'dygraph.{name} is not ported yet (ROADMAP {item})'

    def raise_(*args, **kwargs):
        raise NotImplementedError(msg)

    if kind == 'class':
        return type(name, (), {'__init__': raise_, '__doc__': msg,
                               '__module__': __name__})
    raise_.__name__ = name
    raise_.__doc__ = msg
    return raise_


DataParallel = _unported('DataParallel', 'A.9', 'class')
ParallelEnv = _unported('ParallelEnv', 'A.9', 'class')
prepare_context = _unported('prepare_context', 'A.9')
TracedLayer = _unported('TracedLayer', 'A.4', 'class')
ProgramTranslator = _unported('ProgramTranslator', 'A.4', 'class')
StaticFunction = _unported('StaticFunction', 'A.4', 'class')
InputSpec = _unported('InputSpec', 'A.4', 'class')
declarative = _unported('declarative', 'A.4')
to_static = _unported('to_static', 'A.4')
dygraph_to_static_graph = _unported('dygraph_to_static_graph', 'A.4')
dygraph_to_static_output = _unported('dygraph_to_static_output', 'A.4')
start_gperf_profiler = _unported('start_gperf_profiler', 'A.4')
stop_gperf_profiler = _unported('stop_gperf_profiler', 'A.4')

__all__ = ['guard', 'enable_dygraph', 'disable_dygraph', 'enabled',
           'to_variable', 'set_eager_kernel_cache',
           'eager_kernel_cache_guard', 'Tracer', 'Tensor', 'Parameter',
           'no_grad', 'no_grad_guard', 'dispatch_op', 'grad', 'Layer',
           'Sequential', 'LayerList', 'ParameterList', 'Conv2D', 'Conv3D',
           'Pool2D', 'Linear', 'BatchNorm', 'Embedding', 'GRUUnit',
           'LayerNorm', 'NCE', 'PRelu', 'BilinearTensorProduct',
           'Conv2DTranspose', 'Conv3DTranspose', 'GroupNorm',
           'SpectralNorm', 'TreeConv', 'Dropout', 'jit', 'TrainStep',
           'save_dygraph', 'load_dygraph', 'LearningRateDecay',
           'PiecewiseDecay', 'NaturalExpDecay', 'ExponentialDecay',
           'InverseTimeDecay', 'PolynomialDecay', 'CosineDecay',
           'LinearLrWarmup', 'NoamDecay', 'BackwardStrategy',
           'LayerObjectHelper', 'monkey_patch_varbase',
           'monkey_patch_math_varbase', 'DataParallel', 'ParallelEnv',
           'prepare_context', 'TracedLayer', 'declarative', 'to_static',
           'ProgramTranslator', 'StaticFunction', 'InputSpec',
           'dygraph_to_static_graph', 'dygraph_to_static_output',
           'start_gperf_profiler', 'stop_gperf_profiler']
