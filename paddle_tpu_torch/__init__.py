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
checkpoints) with the NMT Transformer (``models/transformer.py``). A static
script::

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
from .core import (CPUPlace, CUDAPlace, Scope, TPUPlace, XLAPlace,
                   cpu_places, cuda_places, global_scope,
                   is_compiled_with_cuda, scope_guard, unique_name)
from .core.random import seed
from .device import resolve_device
from . import framework
from .framework import (Program, Variable, default_main_program,
                        default_startup_program, in_dygraph_mode,
                        manual_seed, name_scope, program_guard)
from . import ops
from . import initializer
from .param_attr import ParamAttr
from . import layers
from .layers.io import fluid_data as data
from . import backward
from .backward import append_backward, gradients
from . import optimizer
from .executor import Executor
from . import nets
from . import dygraph
from .dygraph import (disable_dygraph, enable_dygraph, load_dygraph,
                      save_dygraph)

__all__ = ['resolve_device', 'core', 'CPUPlace', 'CUDAPlace', 'TPUPlace',
           'XLAPlace', 'cpu_places', 'cuda_places', 'is_compiled_with_cuda',
           'Scope', 'global_scope',
           'scope_guard', 'unique_name', 'seed', 'framework', 'Program',
           'Variable', 'default_main_program', 'default_startup_program',
           'in_dygraph_mode', 'manual_seed', 'name_scope', 'program_guard',
           'ops', 'initializer', 'ParamAttr', 'layers', 'data', 'backward',
           'append_backward', 'gradients', 'optimizer', 'Executor', 'nets',
           'dygraph', 'enable_dygraph', 'disable_dygraph', 'save_dygraph',
           'load_dygraph']
