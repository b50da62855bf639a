"""Row-wise int8 quantization (counterpart of the codec half of
paddle_tpu/parallel/quant_collectives.py).

``rowwise_quantize`` is the int8 KV pool's codec (serving/decode/kv_cache.py):
one symmetric int8 row and one f32 scale per row, the reference's op order
kept so that the two packages round alike. The block-quantized collectives
of the reference module come with ROADMAP A.9.
"""
from __future__ import annotations

import torch

__all__ = ['rowwise_quantize', 'rowwise_dequantize']


def rowwise_quantize(vals):
    """``(q, scale)``: ``vals`` (..., D) f32 as int8 rows of symmetric
    round-to-nearest values and one f32 scale (...,) per row, absmax / 127.
    An all-zero row gets scale 0 and decodes to exact zeros. The reference's
    order: the scale, its reciprocal (0 for a zero row), the product,
    ``torch.round`` (half to even, as ``jnp.round``), the clip to ±127, the
    cast."""
    v = torch.as_tensor(vals, dtype=torch.float32)
    scale = v.abs().amax(dim=-1) / 127.0
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale,
                                             torch.ones_like(scale)),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(v * inv[..., None]), -127, 127)
    return q.to(torch.int8), scale


def rowwise_dequantize(q, scales):
    """f32 rows of ``q`` (..., D) int8 times their ``scales`` (...,)."""
    return q.to(torch.float32) * scales.to(torch.float32)[..., None]
