"""Sequence ops (counterpart of one op of
paddle_tpu/ops/sequence_ops.py): ``sequence_mask``, which the seq2seq
recipe's loss needs. The JAX package's other padded-batch sequence ops
are not ported (ROADMAP A.10)."""
from __future__ import annotations

import torch

from ..core.dtypes import to_torch_dtype
from .registry import register_op

__all__ = ['sequence_mask']


@register_op('sequence_mask')
def sequence_mask(x, *, maxlen=-1, dtype='int64'):
    """``x``: (B,) lengths -> (B, maxlen) with 1 where the position is
    below the row's length. A negative ``maxlen`` is the largest length,
    as the reference's op takes it (one host read on the card); the JAX
    package's op needs it given."""
    x = x.reshape(-1)
    maxlen = int(maxlen)
    if maxlen < 0:
        maxlen = int(x.max()) if x.numel() else 0
    pos = torch.arange(maxlen, device=x.device)
    return (pos[None, :] < x[:, None]).to(to_torch_dtype(dtype))
