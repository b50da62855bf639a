"""Imperative (dygraph) mode of the port (counterpart of
paddle_tpu/dygraph/): ``guard``, ``to_variable``, the VarBase API on torch
tensors (tape.py), ``Layer`` and its containers, the layers (nn.py),
learning-rate schedules, ``save_dygraph``/``load_dygraph``, the training
step and dygraph-to-static (jit.py: ``to_static``/``declarative``,
``TracedLayer``, ``ProgramTranslator``, ``StaticFunction``, ``InputSpec``;
``dygraph_to_static_graph`` and ``dygraph_to_static_output`` are aliases of
``to_static``, as in the JAX package) and data parallelism (parallel.py:
``DataParallel``, ``ParallelEnv``, ``prepare_context``), under the JAX
package's names. Every layer of the JAX package's dygraph/nn.py runs.

The gperf profiler hooks are not ported yet and raise
``NotImplementedError`` naming ROADMAP A.11 when used.
"""
from . import jit
from .base import (Tracer, disable_dygraph, eager_kernel_cache_guard,
                   enable_dygraph, enabled, guard, set_eager_kernel_cache,
                   to_variable)
from .checkpoint import load_dygraph, save_dygraph
from .container import LayerList, ParameterList, Sequential
from .jit import (InputSpec, ProgramTranslator, StaticFunction, TracedLayer,
                  TrainStep, declarative, to_static)
from .layers import Layer
from .learning_rate_scheduler import (CosineDecay, ExponentialDecay,
                                      InverseTimeDecay, LearningRateDecay,
                                      LinearLrWarmup, NaturalExpDecay,
                                      NoamDecay, PiecewiseDecay,
                                      PolynomialDecay)
from .parallel import DataParallel, ParallelEnv, prepare_context
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


def _unported(name, item):
    msg = f'dygraph.{name} is not ported yet (ROADMAP {item})'

    def raise_(*args, **kwargs):
        raise NotImplementedError(msg)

    raise_.__name__ = name
    raise_.__doc__ = msg
    return raise_


dygraph_to_static_graph = to_static
dygraph_to_static_output = to_static
start_gperf_profiler = _unported('start_gperf_profiler', 'A.11')
stop_gperf_profiler = _unported('stop_gperf_profiler', 'A.11')

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
