"""Paged KV-cache pool: fixed-size blocks, free-list allocator, per-request
block tables (counterpart of paddle_tpu/serving/decode/kv_cache.py).

Layout per layer: ``k_pages`` / ``v_pages`` (H, num_blocks, block_size, D)
on the engine's device, at the pool's ``kv_dtype``. A request holds ``ceil(context / block_size)``
blocks (plus its reservation); the free list recycles them the moment a slot
finishes, and the attention ops read through the block table so the cache
never moves.

Block 0 is the **scratch block**: never allocated, the padding target for
inactive decode slots and short block tables. Writes to it are harmless
(masked by context lengths; masked keys get exactly zero weight in the plain
version and are never read by the kernels).

Writes are in-place ``index_put_`` into the pool tensors: one scatter per
layer per step, no copy of the pool per token.

Storage (``kv_dtype``): ``f32`` (exact, the default), ``bf16`` (half the
bytes; the reads widen it back to f32, exact for every stored value) or
``int8`` (a quarter of the bytes: one symmetric int8 row and one f32 scale
per (head, position) row, parallel/quant_collectives.py's
``rowwise_quantize``). Rows are quantized where they are written (prefill
block scatter, decode and verify token scatter) and dequantized where the
attention ops read them, inside the kernels, so the resident pool never
exists at f32. Scales start at 0, so unwritten rows and the scratch block
dequantize to exact zeros.

Whole-block transfer (the disaggregated handoff and the prefix cache's
host tier): ``read_blocks`` / ``read_block_scales`` copy blocks to host
tensors (the copy waits for the writes before it), ``write_whole_blocks``
scatters them into other block ids with one ``index_put_`` a layer; a
payload at the pool's own storage (int8 with its scales) lands byte for
byte.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ...ops import nn_ops
from ...parallel.quant_collectives import rowwise_dequantize, rowwise_quantize
from ..errors import InvalidRequest, OutOfBlocks

__all__ = ['BlockAllocator', 'BlockTable', 'KVCachePool', 'CacheContext',
           'DEFAULT_SLOTS', 'DEFAULT_BLOCK_SIZE', 'DEFAULT_MAX_BLOCKS',
           'SCRATCH_BLOCK', 'KV_PAYLOAD_DTYPES', 'KV_DTYPE_CODES',
           'kv_row_bytes']

DEFAULT_SLOTS = 8
DEFAULT_BLOCK_SIZE = 16
DEFAULT_MAX_BLOCKS = 256

SCRATCH_BLOCK = 0

# storage payload per element, by kv_dtype; int8 also keeps one f32 scale
# per (head, position) row
KV_PAYLOAD_DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16,
                     'int8': torch.int8}
_KV_PAYLOAD_BYTES = {'f32': 4, 'bf16': 2, 'int8': 1}
# the reference's stable codes (its kv_cache_dtype gauge and handoff wire
# meta), also the payload codes of the paged kernels' launchers
KV_DTYPE_CODES = {'f32': 0, 'bf16': 1, 'int8': 2}


def _check_kv_dtype(kv_dtype):
    if kv_dtype not in KV_PAYLOAD_DTYPES:
        raise ValueError(
            f'kv_dtype={kv_dtype!r} is not supported; supported values: '
            + ', '.join(repr(c) for c in KV_PAYLOAD_DTYPES))


def kv_row_bytes(head_dim, kv_dtype):
    """Bytes of ONE cached K or V row (one head, one token position) at
    ``kv_dtype``: the payload, plus its f32 row scale for int8."""
    _check_kv_dtype(kv_dtype)
    return (int(head_dim) * _KV_PAYLOAD_BYTES[kv_dtype]
            + (4 if kv_dtype == 'int8' else 0))


class BlockAllocator:
    """Refcounted free-list block allocator. Block 0 (scratch) is never
    handed out.

    Refcounts make prefix sharing (serving/tier/prefix_cache.py) safe: a
    block holding a shared prompt's K/V carries the cache's own reference
    plus one per live request reading it, and returns to the free list
    when the last reference is released. ``allocate`` hands blocks out at
    refcount 1; ``free`` and ``release`` are the same operation (drop one
    reference, recycle at zero), and releasing a block that is not live
    raises (a double free)."""

    def __init__(self, num_blocks):
        if num_blocks < 2:
            raise ValueError(f'need >= 2 blocks (1 scratch), got '
                             f'{num_blocks}')
        self.num_blocks = int(num_blocks)
        self._free = list(range(self.num_blocks - 1, 0, -1))  # pop() -> 1..
        self._refs = {}               # live block id -> refcount >= 1
        self._lock = threading.Lock()

    @property
    def capacity(self):
        return self.num_blocks - 1

    @property
    def available(self):
        with self._lock:
            return len(self._free)

    @property
    def used(self):
        return self.capacity - self.available

    def refcount(self, block_id):
        """Live references on ``block_id`` (0: on the free list)."""
        with self._lock:
            return self._refs.get(int(block_id), 0)

    def allocate(self, n):
        """n block ids at refcount 1, or raise :class:`OutOfBlocks`
        (nothing allocated)."""
        n = int(n)
        with self._lock:
            if n > len(self._free):
                raise OutOfBlocks(n, len(self._free))
            ids = [self._free.pop() for _ in range(n)]
            for b in ids:
                self._refs[b] = 1
            return ids

    def retain(self, block_ids):
        """Add one reference per block (sharing a live block)."""
        with self._lock:
            for b in block_ids:
                b = int(b)
                if b not in self._refs:
                    raise ValueError(f'retain of non-live block {b}')
                self._refs[b] += 1

    def release(self, block_ids):
        """Drop one reference per block; a block reaching zero returns to
        the free list. Releasing the scratch block or a block that is not
        live raises."""
        with self._lock:
            for b in block_ids:
                b = int(b)
                if b == SCRATCH_BLOCK:
                    raise ValueError('freeing the scratch block')
                if b not in self._refs:
                    raise ValueError(f'double free of block {b}')
                self._refs[b] -= 1
                if self._refs[b] == 0:
                    del self._refs[b]
                    self._free.append(b)

    free = release


class BlockTable:
    """One request's cache blocks, in sequence order. ``context_len`` is the
    number of cached tokens (prompt + generated so far)."""

    __slots__ = ('blocks', 'block_size', 'context_len', 'cached_len')

    def __init__(self, blocks, block_size, cached_len=0):
        self.blocks = list(blocks)
        self.block_size = int(block_size)
        self.context_len = 0
        # tokens at the front of the table held by shared prefix-cache
        # blocks (a whole number of blocks): this request never writes a
        # position below it, the other requests sharing them read them
        self.cached_len = int(cached_len)

    @property
    def capacity_tokens(self):
        return len(self.blocks) * self.block_size

    def slot_for(self, position):
        """(block_id, offset) holding token ``position``."""
        if position >= self.capacity_tokens:
            raise IndexError(
                f'position {position} beyond the table\'s '
                f'{self.capacity_tokens} reserved token slots')
        return (self.blocks[position // self.block_size],
                position % self.block_size)

    def padded(self, max_blocks_per_seq):
        """Block ids padded to the engine-wide table width with scratch."""
        if len(self.blocks) > max_blocks_per_seq:
            raise ValueError(
                f'{len(self.blocks)} blocks exceed max_blocks_per_seq='
                f'{max_blocks_per_seq}')
        return self.blocks + [SCRATCH_BLOCK] * (max_blocks_per_seq
                                                - len(self.blocks))


class KVCachePool:
    """Per-layer paged K/V tensors + the shared allocator.

    ``max_blocks_per_seq`` fixes the batched block-table width, and with it
    ``padded_context = max_blocks_per_seq * block_size``, the key extent of
    every attention read. Per-layer tensors are allocated on the first
    prefill (head count and head dim come from the model's K projection).
    """

    def __init__(self, block_size=None, num_blocks=None,
                 max_blocks_per_seq=None, kv_dtype=None, device='cpu'):
        self.block_size = int(block_size or DEFAULT_BLOCK_SIZE)
        self.num_blocks = int(num_blocks or DEFAULT_MAX_BLOCKS)
        self.max_blocks_per_seq = int(max_blocks_per_seq or 8)
        kv_dtype = kv_dtype or 'f32'
        _check_kv_dtype(kv_dtype)
        self.kv_dtype = kv_dtype
        self.dtype = KV_PAYLOAD_DTYPES[kv_dtype]
        self.device = torch.device(device)
        self.allocator = BlockAllocator(self.num_blocks)
        self._layers = {}          # layer idx -> [k_pages, v_pages]
        self._scales = {}          # int8 only: layer -> [k_scales, v_scales]

    @property
    def padded_context(self):
        return self.max_blocks_per_seq * self.block_size

    @property
    def num_layers(self):
        return len(self._layers)

    def new_table(self, total_tokens):
        """Allocate a table holding ``total_tokens`` (prompt + budget).
        Raises OutOfBlocks when the pool cannot cover it right now."""
        nb = -(-int(total_tokens) // self.block_size)
        if nb > self.max_blocks_per_seq:
            raise InvalidRequest(
                f'{total_tokens} tokens need {nb} blocks > '
                f'max_blocks_per_seq={self.max_blocks_per_seq}')
        return BlockTable(self.allocator.allocate(nb), self.block_size)

    def free_table(self, table):
        if table.blocks:
            self.allocator.free(table.blocks)
            table.blocks = []

    def ensure_layer(self, layer, n_heads, head_dim):
        if layer not in self._layers:
            shape = (n_heads, self.num_blocks, self.block_size, head_dim)
            self._layers[layer] = [
                torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device)]
            if self.kv_dtype == 'int8':
                # zero scales: unwritten rows (the scratch block's too)
                # dequantize to exact zeros
                self._scales[layer] = [
                    torch.zeros(shape[:3], dtype=torch.float32,
                                device=self.device),
                    torch.zeros(shape[:3], dtype=torch.float32,
                                device=self.device)]
        return self._layers[layer]

    def pages(self, layer):
        return self._layers[layer]

    def scales(self, layer):
        """int8 pools: [k_scales, v_scales], each (H, NB, BS) f32; None for
        f32 and bf16 pools."""
        return self._scales.get(layer)

    def _encode_rows(self, vals):
        """f32 rows (H, ..., D) -> (payload at the storage type, row scales
        (H, ...) f32 or None). The f32 pool returns ``vals`` itself."""
        if self.kv_dtype == 'f32':
            return vals, None
        if self.kv_dtype == 'bf16':
            return vals.to(torch.bfloat16), None
        return rowwise_quantize(vals)

    def bytes_in_hbm(self):
        """Resident pool bytes over the allocated layers: payload tensors
        and, for int8, their scale tensors."""
        return sum(t.numel() * t.element_size()
                   for tensors in (*self._layers.values(),
                                   *self._scales.values())
                   for t in tensors)

    def write_prefill(self, layer, table, k, v):
        """Write the prompt's K/V rows. ``k``/``v``: (H, L, D), the bucket-
        padded projections; rows are written for ``ceil(context / bs)``
        whole blocks (tail rows inside the last block are masked garbage
        until decode overwrites them)."""
        h, length, d = k.shape
        pages = self.ensure_layer(layer, h, d)
        nb_w = min(-(-table.context_len // self.block_size),
                   len(table.blocks))
        target = nb_w * self.block_size
        if length < target:
            k = torch.nn.functional.pad(k, (0, 0, 0, target - length))
            v = torch.nn.functional.pad(v, (0, 0, 0, target - length))
        ids = torch.as_tensor(table.blocks[:nb_w], dtype=torch.long,
                              device=self.device)
        heads = torch.arange(h, device=self.device)[:, None]
        idx = (heads, ids[None, :])
        kb, ks = self._encode_rows(
            k[:, :target].reshape(h, nb_w, self.block_size, d))
        vb, vs = self._encode_rows(
            v[:, :target].reshape(h, nb_w, self.block_size, d))
        pages[0].index_put_(idx, kb)
        pages[1].index_put_(idx, vb)
        if ks is not None:
            scales = self._scales[layer]
            scales[0].index_put_(idx, ks)
            scales[1].index_put_(idx, vs)

    def write_tokens(self, layer, block_ids, offsets, k, v):
        """One decode step's K/V: ``k``/``v`` (H, N, D) written at
        (block_ids[i], offsets[i]), ``block_ids``/``offsets`` (N,) integer
        tensors on the pool's device (N = S, or S * K for a verify step,
        slot-major). Inactive slots and padded lanes point at the scratch
        block."""
        h, _, d = k.shape
        pages = self.ensure_layer(layer, h, d)
        heads = torch.arange(h, device=self.device)[:, None]
        idx = (heads, block_ids[None, :], offsets[None, :])
        k, ks = self._encode_rows(k)
        v, vs = self._encode_rows(v)
        pages[0].index_put_(idx, k)
        pages[1].index_put_(idx, v)
        if ks is not None:
            scales = self._scales[layer]
            scales[0].index_put_(idx, ks)
            scales[1].index_put_(idx, vs)

    # -- whole-block transfer (tier/disagg.py, tier/prefix_cache.py) --------
    def _block_index(self, h, block_ids):
        ids = torch.as_tensor([int(b) for b in block_ids], dtype=torch.long,
                              device=self.device)
        return torch.arange(h, device=self.device)[:, None], ids[None, :]

    def read_blocks(self, layer, block_ids):
        """Whole blocks as host tensors: ``(k, v)``, each (H, nb,
        block_size, D) at the pool's storage type, the handoff payload's
        layout."""
        k_pages, v_pages = self._layers[layer]
        idx = self._block_index(k_pages.shape[0], block_ids)
        return k_pages[idx].cpu(), v_pages[idx].cpu()

    def read_block_scales(self, layer, block_ids):
        """int8 pools: the blocks' row scales as host tensors ``(k_scales,
        v_scales)``, each (H, nb, block_size) f32, shipped beside
        :meth:`read_blocks`; None for f32 and bf16 pools."""
        if layer not in self._scales:
            return None
        ks, vs = self._scales[layer]
        idx = self._block_index(ks.shape[0], block_ids)
        return ks[idx].cpu(), vs[idx].cpu()

    def write_whole_blocks(self, layer, block_ids, k, v, k_scale=None,
                           v_scale=None):
        """Scatter whole blocks (the :meth:`read_blocks` shapes, torch
        tensors or numpy arrays) into this pool at ``block_ids``: the
        receiving half of a handoff or a host-tier reinjection.

        A payload at this pool's storage type (int8 with its scales)
        lands byte for byte; any other is decoded to f32 (with
        ``k_scale``/``v_scale`` when the sender was int8) and encoded at
        this pool's type, as the reference does."""
        k, v = torch.as_tensor(k), torch.as_tensor(v)
        h, _, bs, d = k.shape
        if bs != self.block_size:
            raise InvalidRequest(
                f'handoff block_size {bs} != pool block_size '
                f'{self.block_size}')
        pages = self.ensure_layer(layer, h, d)
        idx = self._block_index(h, block_ids)
        k, v = k.to(self.device), v.to(self.device)
        if k_scale is not None:
            k_scale = torch.as_tensor(k_scale).to(self.device)
            v_scale = torch.as_tensor(v_scale).to(self.device)
        if not (k.dtype == self.dtype
                and (self.kv_dtype != 'int8' or k_scale is not None)):
            if k_scale is not None:          # an int8 sender: decode first
                k = rowwise_dequantize(k, k_scale)
                v = rowwise_dequantize(v, v_scale)
            k, k_scale = self._encode_rows(k.float())
            v, v_scale = self._encode_rows(v.float())
        pages[0].index_put_(idx, k)
        pages[1].index_put_(idx, v)
        if self.kv_dtype == 'int8':
            scales = self._scales[layer]
            scales[0].index_put_(idx, k_scale)
            scales[1].index_put_(idx, v_scale)

    # -- observability -----------------------------------------------------
    def utilization(self):
        return self.allocator.used / max(self.allocator.capacity, 1)


class CacheContext:
    """The ``cache=`` object MultiHeadAttention calls into (models/bert.py).
    One context per model forward; each attention layer's
    ``attend(q, k, v, sm_scale=)`` call consumes the next layer index.

    mode='prefill': q/k/v are (1, H, Lb, D) for one bucket-padded prompt;
    K/V are written into the request's blocks and attention runs causal over
    the paged view (``paged_prefill_attention``).

    mode='decode': q/k/v are (S, H, 1, D), one token per slot; K/V land at
    each slot's next position and attention reads through the batched block
    tables (``paged_attention``).

    mode='decode' with ``window`` K > 1 (the speculative verify step):
    q/k/v are (S, H, K, D); slot s feeds ``fed_counts[s]`` <= K real tokens
    at positions context_lens[s] - 1 onwards, and its other lanes write to
    the scratch block. ``context_lens[s]`` is the extent of fed row 0;
    ``paged_attention``'s (S, H, K, D) read gives row j the extent
    context_lens + j.

    The step's tables, context lengths and write coordinates go to the
    device in one copy, shared by every layer.
    """

    def __init__(self, pool, mode, tables, context_lens=None,
                 fed_counts=None, window=1):
        self.pool = pool
        self.mode = mode
        self.tables = tables          # prefill: [BlockTable]; decode: list
        self.window = int(window)
        self._layer = 0
        width = pool.max_blocks_per_seq
        if mode == 'prefill':
            self._tables = torch.as_tensor(
                np.asarray([tables[0].padded(width)], np.int32),
                device=pool.device)
            return
        if mode != 'decode':
            raise ValueError(f"mode must be 'prefill' or 'decode', got "
                             f"{mode!r}")
        s, kw = len(tables), self.window
        if fed_counts is None:
            fed_counts = [int(t is not None) for t in tables]
        # one int32 buffer: tables (S, width) | ctx (S) | write blocks
        # (S * K) | write offsets (S * K)
        packed = np.zeros(s * (width + 1 + 2 * kw), np.int32)
        tab = packed[:s * width].reshape(s, width)
        ctx = packed[s * width:s * (width + 1)]
        ids, offs = packed[s * (width + 1):].reshape(2, s, kw)
        for i, (t, c, f) in enumerate(zip(tables, context_lens, fed_counts)):
            ctx[i] = max(int(c), 1)
            if t is None:                     # inactive: scratch
                continue
            tab[i] = t.padded(width)
            for j in range(int(f)):           # other lanes: scratch
                ids[i, j], offs[i, j] = t.slot_for(int(c) - 1 + j)
        meta = torch.as_tensor(packed, device=pool.device)
        self._tables = meta[:s * width].view(s, width)
        self._ctx = meta[s * width:s * (width + 1)]
        ids, offs = meta[s * (width + 1):].view(2, s * kw)
        self._write_ids = ids.long()
        self._write_offs = offs.long()

    def _scale_inputs(self, layer):
        """The row scales an int8 pool's reads take; nothing for f32 and
        bf16 pools."""
        scales = self.pool.scales(layer)
        if scales is None:
            return {}
        return {'k_scales': scales[0], 'v_scales': scales[1]}

    def attend(self, q, k, v, sm_scale=1.0):
        layer = self._layer
        self._layer += 1
        if self.mode == 'prefill':
            # (1, H, L, D) -> (H, L, D) rows for the block scatter
            self.pool.write_prefill(layer, self.tables[0], k[0], v[0])
            k_pages, v_pages = self.pool.pages(layer)
            return nn_ops.paged_prefill_attention(
                q.contiguous(), k, v, k_pages, v_pages, self._tables,
                sm_scale=float(sm_scale), **self._scale_inputs(layer))
        # decode: (S, H, K, D) -> (H, S * K, D) token rows, slot-major as
        # the write coordinates
        s, h, kw, d = q.shape
        self.pool.write_tokens(layer, self._write_ids, self._write_offs,
                               k.transpose(0, 1).reshape(h, s * kw, d),
                               v.transpose(0, 1).reshape(h, s * kw, d))
        k_pages, v_pages = self.pool.pages(layer)
        q_in = q.contiguous() if kw > 1 else q.reshape(s, h, d).contiguous()
        out = nn_ops.paged_attention(
            q_in, k_pages, v_pages, self._tables, self._ctx,
            sm_scale=float(sm_scale), **self._scale_inputs(layer))
        return out.reshape(s, h, kw, d)
