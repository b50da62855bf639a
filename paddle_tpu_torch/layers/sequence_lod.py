"""layers.sequence_lod of the port (counterpart of
paddle_tpu/layers/sequence_lod.py): ``sequence_mask``, which the seq2seq
recipe's loss needs. Every other attribute raises
``NotImplementedError`` naming ROADMAP A.10 (the padded-batch sequence
layers over ops the port has not registered)."""
from __future__ import annotations

from .common import apply_op_layer

__all__ = ['sequence_mask']


def sequence_mask(x, maxlen=None, dtype='int64', name=None):
    """(B,) lengths -> (B, maxlen) of 1 below each row's length, in
    ``dtype``. Without ``maxlen`` the width is the largest length, as the
    reference documents (read on the host when the op runs; the JAX
    package raises for a missing ``maxlen``)."""
    return apply_op_layer('sequence_mask', {'x': x},
                          {'maxlen': -1 if maxlen is None else int(maxlen),
                           'dtype': dtype}, name=name)


def __getattr__(attr):
    if attr.startswith('__'):
        raise AttributeError(attr)
    raise NotImplementedError(f'layers.sequence_lod.{attr} is not ported '
                              f'yet (ROADMAP A.10)')
