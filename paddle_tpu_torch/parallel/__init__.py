"""Parallel and quantized-communication helpers (counterpart of
paddle_tpu/parallel/). Only the row-wise int8 codec is ported
(quant_collectives.py), for the int8 KV pool; the collectives, FSDP, tensor
and pipeline parallelism come with ROADMAP A.9."""
from .quant_collectives import rowwise_dequantize, rowwise_quantize

__all__ = ['rowwise_quantize', 'rowwise_dequantize']
