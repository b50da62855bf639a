"""Dygraph-mode training of the port: the fused training step (jit.py)."""
from .jit import TrainStep

__all__ = ['TrainStep']
