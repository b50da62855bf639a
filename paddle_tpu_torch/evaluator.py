"""The deprecated ``fluid.evaluator`` classes (counterpart of
paddle_tpu/evaluator.py): aliases of ``fluid.metrics``' that warn once
constructed."""
import warnings

from .metrics import ChunkEvaluator as _ChunkEvaluator
from .metrics import DetectionMAP as _DetectionMAP
from .metrics import EditDistance as _EditDistance

__all__ = ['ChunkEvaluator', 'EditDistance', 'DetectionMAP']


def _deprecated(cls, name):
    class Wrapped(cls):
        def __init__(self, *args, **kwargs):
            warnings.warn(
                f'fluid.evaluator.{name} is deprecated; '
                f'use fluid.metrics.{name}', DeprecationWarning, stacklevel=2)
            super().__init__(*args, **kwargs)
    Wrapped.__name__ = name
    Wrapped.__qualname__ = name
    return Wrapped


ChunkEvaluator = _deprecated(_ChunkEvaluator, 'ChunkEvaluator')
EditDistance = _deprecated(_EditDistance, 'EditDistance')
DetectionMAP = _deprecated(_DetectionMAP, 'DetectionMAP')
