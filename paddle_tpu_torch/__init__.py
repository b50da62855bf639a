"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, slice by slice.

The JAX package, ``paddle_tpu``, stays the reference; this package never
imports it or ``jax``. Each module mirrors its counterpart's path and names
(``models/causal_lm.py``, ``serving/decode/kv_cache.py``, ...). Where the JAX
package reaches a Pallas kernel for the TPU, the port runs a kernel written
by hand for Hopper (``csrc/``, built with ``nvcc`` at first use); on CPU
tensors the same ops run their plain PyTorch versions.

Entry points run on the CUDA card unless the caller passes ``device='cpu'``
(device.py) or ``CPUPlace()``. The first slice is the decode-serving path
(``python -m paddle_tpu_torch.serving.tier.replica``); the second is BERT
pretraining (``models/bert.py``, ``optimizer.py``, ``dygraph/jit.py``
``TrainStep``); the third is ResNet training (``models/resnet.py``,
``dygraph/nn.py``, Momentum) with the fused 1x1 conv + BN + act op
(``ops/pallas_conv.py``); the fourth is Fluid's static graph
(``framework.py``, ``layers/``, ``backward.py``, ``optimizer.py``,
``executor.py``), so that a Fluid script runs with
``import paddle_tpu_torch as fluid``; the fifth is the dygraph API
(``dygraph/``: ``guard``, ``to_variable``, ``Layer``, schedules,
checkpoints) with the NMT Transformer (``models/transformer.py``); the
sixth is ERNIE finetuning (``models/ernie.py``) with the optimizers'
regularizers (``regularizer.py``), gradient clips (``clip.py``), AMP's
``contrib.mixed_precision.decorate`` and ``TrainStep``'s gradient merge;
the seventh is the rest of a static script's surface (the static layers'
schedules, losses and tensor layers, ``compiler.CompiledProgram``,
``io``'s save and load, ``inference.Predictor``) around PaddleCV's static
ResNet-50 recipe (``tools/static_resnet.py``); later slices added static
control flow, seq2seq decoding, static AMP and recompute, the IR passes,
speculative decoding, quantized KV pools and the serving tier. The
fifteenth is the Fluid top-level surface (ROADMAP A.13): ``DataFeeder``,
``metrics``, ``average``, ``evaluator``, ``debugging`` with the Executor's
``FLAGS_check_nan_inf`` fetch scan, ``install_check``, ``debugger``,
``net_drawer``, ``op``, ``utils``, ``transpiler``'s no-ops,
``contrib.Trainer`` and ``Inferencer``, and the ``fluid`` alias, so that
``import paddle_tpu_torch.fluid as fluid`` runs PaddleBook's scripts
(``tools/recognize_digits.py``). The sixteenth is the stateless serving
path (``serving/engine.py``'s ``InferenceEngine``, ``serving/batcher.py``,
``POST /predict``) with the observability core (``observability/``: the
metrics registry behind ``GET /metrics``, the tracer, trace contexts, the
fleet merge behind the router's ``GET /metrics/fleet``, windowed series
and SLOs). The seventeenth is the rest of the optimizer surface: LARS,
Lamb and the other rules of ``optimizer.py`` in both modes,
``dygraph_grad_clip``, ``contrib.extend_optimizer``, ``dygraph.grad``'s
``no_grad_vars`` and ``TrainStep``'s ``remat``, ``snapshot`` and
``set_state``. Every other public top-level name of the
JAX package is a stand-in that raises ``NotImplementedError`` naming its
ROADMAP item (``NOT_PORTED`` below); a name the JAX package lacks is not
an attribute. A static script::

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data('img', [1, 28, 28], dtype='float32')
        label = fluid.layers.data('label', [1], dtype='int64')
        loss, acc, _ = build_static_lenet(img, label)
        fluid.optimizer.Adam(learning_rate=0.001).minimize(loss)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup)
    l, a = exe.run(main, feed={'img': x, 'label': y},
                   fetch_list=[loss, acc])

Importing the package builds no kernel and touches no device.
"""
from . import core
from .core import (CPUPlace, CUDAPinnedPlace, CUDAPlace, Scope, TPUPlace,
                   XLAPlace, cpu_places, cuda_pinned_places, cuda_places,
                   global_scope, is_compiled_with_cuda, scope_guard,
                   tpu_places, unique_name)
from .core.random import seed
from .device import resolve_device
from . import framework
from .framework import (Program, Variable, default_main_program,
                        default_startup_program, device_guard,
                        in_dygraph_mode, load_op_library, manual_seed,
                        name_scope, program_guard, require_version)
from . import ops
from . import initializer
from .param_attr import ParamAttr, WeightNormParamAttr
from . import regularizer
from . import clip
from . import layers
from .layers.io import fluid_data as data
from . import backward
from .backward import append_backward, gradients
from . import optimizer
from . import dygraph_grad_clip
from .executor import Executor
from . import compiler
from .compiler import CompiledProgram
from . import nets
from . import dygraph
from .dygraph import (disable_dygraph, enable_dygraph, load_dygraph,
                      save_dygraph)
from .dygraph.base import enabled
from . import contrib
from . import io
from .io import (load, load_inference_model, load_params, load_persistables,
                 load_program_state, save, save_inference_model, save_params,
                 save_persistables, set_program_state)
from . import data_feeder
from .data_feeder import DataFeeder
from . import metrics
from . import average
from . import evaluator
from . import log_helper
from . import annotations
from . import debugging
from . import install_check
from . import debugger
from . import net_drawer
from . import op
from . import input
from . import default_scope_funcs
from . import transpiler
from .transpiler import memory_optimize, release_memory
from . import utils
from . import inference
from . import parallel
from . import parallel_executor
from .parallel_executor import ParallelExecutor
from . import distributed
from . import observability
from . import serving
from . import _not_ported

# `import paddle_tpu_torch.fluid as fluid`: fluid is this package itself
import sys as _sys
fluid = _sys.modules[__name__]
_sys.modules[__name__ + '.fluid'] = fluid

__version__ = '1.7.0'     # the Fluid API level the port follows

# the JAX package's public top-level names the port does not run yet:
# name -> (ROADMAP item, 'module' | 'class' | 'function')
NOT_PORTED = {
    'DistributeTranspiler': ('A.9', 'class'),
    'DistributeTranspilerConfig': ('A.9', 'class'),
    'partition': ('A.9', 'module'),
    'communicator': ('A.9', 'module'),
    'Communicator': ('A.9', 'class'),
    'distribute_lookup_table': ('A.9', 'module'),
    'LoDTensor': ('A.10', 'class'),
    'create_lod_tensor': ('A.10', 'function'),
    'create_random_int_lodtensor': ('A.10', 'function'),
    'reader': ('A.11', 'module'),
    'DataLoader': ('A.11', 'class'),
    'FetchHandle': ('A.11', 'class'),
    'profiler': ('A.11', 'module'),
    'resilience': ('A.11', 'module'),
    'analysis': ('A.11', 'module'),
    'dataset': ('A.11', 'module'),
    'datasets': ('A.11', 'module'),
    'DatasetFactory': ('A.11', 'class'),
    'InMemoryDataset': ('A.11', 'class'),
    'QueueDataset': ('A.11', 'class'),
    'data_feed_desc': ('A.11', 'module'),
    'DataFeedDesc': ('A.11', 'class'),
    'device_worker': ('A.11', 'module'),
    'trainer_desc': ('A.11', 'module'),
    'trainer_factory': ('A.11', 'module'),
    'incubate': ('A.11', 'module'),
}
globals().update({
    name: {'module': _not_ported.stand_in_module,
           'class': _not_ported.stand_in_class,
           'function': _not_ported.stand_in}[kind](name, item)
    for name, (item, kind) in NOT_PORTED.items()})
