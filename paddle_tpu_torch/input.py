"""``fluid.input`` (counterpart of paddle_tpu/input.py): Fluid 1.7's
new-style ``embedding`` and ``one_hot``, the layers' own functions (their
ops take ids of any rank, so no trailing [.., 1] dim is required)."""
from .layers.nn import embedding, one_hot

__all__ = ['embedding', 'one_hot']
