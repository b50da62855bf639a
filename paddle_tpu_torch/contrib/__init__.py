"""Contributed modules of the port (counterpart of paddle_tpu/contrib/):
so far ``mixed_precision`` (``decorate``, ``AutoMixedPrecisionLists``).
The rest of the reference's contrib is ROADMAP A.11."""
from . import mixed_precision
from .mixed_precision import AutoMixedPrecisionLists, decorate

__all__ = ['mixed_precision', 'decorate', 'AutoMixedPrecisionLists']
