"""Stateful decode: paged KV cache + slot-based continuous batching +
streaming generation (counterpart of paddle_tpu/serving/decode/).

- :class:`KVCachePool` (kv_cache.py): fixed-size cache blocks on the
  device (f32, bf16 or int8 with row scales), free-list allocator,
  per-request :class:`BlockTable`s.
- :class:`DecodeEngine` (engine.py): prefill over a prompt bucket ladder
  writes K/V into cache blocks; decode steps all S slots in lockstep through
  the paged attention kernels.
- :class:`DecodeScheduler` (scheduler.py): continuous batching, bounded
  queue, waiting deadlines, graceful drain; per-request
  :class:`GenerationStream` token streams; speculative verify rounds over
  a drafter's guesses (drafter.py: :class:`NGramDrafter`,
  :class:`DraftModelDrafter`).
"""
from .kv_cache import (BlockAllocator, BlockTable, CacheContext, KVCachePool,
                       DEFAULT_BLOCK_SIZE, DEFAULT_MAX_BLOCKS, DEFAULT_SLOTS)
from .engine import DecodeEngine
from .sampling import SamplingParams, TokenSampler, derive_stream_seed
from .drafter import NGramDrafter, DraftModelDrafter, build_drafter
from .scheduler import DecodeScheduler, GenerationStream

__all__ = ['BlockAllocator', 'BlockTable', 'CacheContext', 'KVCachePool',
           'DecodeEngine', 'DecodeScheduler', 'GenerationStream',
           'SamplingParams', 'TokenSampler', 'derive_stream_seed',
           'NGramDrafter', 'DraftModelDrafter', 'build_drafter',
           'DEFAULT_SLOTS', 'DEFAULT_BLOCK_SIZE', 'DEFAULT_MAX_BLOCKS']
