"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, slice by slice.

The JAX package, ``paddle_tpu``, stays the reference; this package never
imports it or ``jax``. Each module mirrors its counterpart's path and names
(``models/causal_lm.py``, ``serving/decode/kv_cache.py``, ...). Where the JAX
package reaches a Pallas kernel for the TPU, the port runs a kernel written
by hand for Hopper (``csrc/``, built with ``nvcc`` at first use); on CPU
tensors the same ops run their plain PyTorch versions.

Entry points run on the CUDA card unless the caller passes ``device='cpu'``
(device.py). The first slice is the decode-serving path
(``python -m paddle_tpu_torch.serving.tier.replica``); the second is BERT
pretraining (``models/bert.py``, ``optimizer.py``, ``dygraph/jit.py``
``TrainStep``); the third is ResNet training (``models/resnet.py``,
``dygraph/nn.py``, Momentum) with the fused 1x1 conv + BN + act op
(``ops/pallas_conv.py``).
"""
from .device import resolve_device

__all__ = ['resolve_device']
