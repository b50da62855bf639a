"""Dygraph-mode layers (nn.py) and training of the port (the fused
training step, jit.py)."""
from .jit import TrainStep
from .nn import BatchNorm, Conv2D, Dropout, LayerNorm, Linear, Pool2D

__all__ = ['TrainStep', 'Conv2D', 'Pool2D', 'BatchNorm', 'Linear',
           'LayerNorm', 'Dropout']
