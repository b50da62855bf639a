"""Radix prefix cache over the paged KV pool (counterpart of
paddle_tpu/serving/tier/prefix_cache.py): shared prompt prefixes resolve to
already-filled, refcounted cache blocks, so only the uncached suffix of a
prompt runs through the model.

The trie is keyed at BLOCK granularity: K/V rows at position ``p`` depend
on the whole prefix ``[0..p]``, so a cached block is reusable only by a
prompt that matches every token leading to it. An edge is one
``block_size``-token chunk, and the node it reaches holds a block id valid
for any prompt sharing that prefix; a hit plugs the ids into the request's
:class:`~..decode.kv_cache.BlockTable` without a copy.

The uncached suffix is not run through a second prefill: the scheduler
feeds it through the lockstep decode step (or the speculative verify step,
up to k prompt tokens a round), the rows of which the decode tests hold to
the whole-sequence forward. On the card a hit's suffix rows come from the
decode step's S-row GEMMs and K1, not from the prefill's Lb-row GEMMs and
K2, so a hit's stream equals the cold stream token for token, or parts at
a near tie (ROADMAP C1); the reference's bitwise contract is a JAX one.

Host spill tier: with ``host_mb`` (``PADDLE_TPU_PREFIX_CACHE_HOST_MB``) >
0, an idle block that would be evicted is SPILLED instead: copied to host
memory as the pool's own tensors (``KVCachePool.read_blocks`` and, for
int8, ``read_block_scales``) while its trie node stays with
``block=None``. A later hit through spilled nodes reinjects them: blocks
are allocated again and the run lands with one
``KVCachePool.write_whole_blocks`` a layer, byte for byte. The
host tier is an LRU under the byte cap; an entry it drops takes its fully
spilled subtree with it. A spilled node never has a resident descendant:
victims have none, and ``match`` (reinjection) and ``insert`` (promotion
from the publishing request's identical private copy) restore residency
top-down along the paths they walk.

Invariants:

- only WHOLE blocks of prompt tokens are published (a block also holding
  generated or padded rows stays private to its request);
- the last prompt token is never served from cache (``match`` stops at
  ``(P - 1) // block_size`` blocks): one token must run through the model
  to give the first generated token's logits. So every decode or verify
  write lands in a private block, and a shared block (its int8 scales too)
  is never written;
- a resident block carries the cache's own reference plus one per live
  request sharing it. Spill or eviction takes the least recently used
  refcount-idle node with no resident children, under pool pressure (an
  allocation that would raise OutOfBlocks) and under the
  ``PADDLE_TPU_PREFIX_CACHE_MAX_BLOCKS`` cap at publication; nodes of the
  walk that triggered it are never victims.

Counters: the registry's ``prefix_cache_*`` and ``kv_cache_*`` families
(serving/metrics.py, ``GET /metrics``), recorded at the reference's sites,
and ``stats``, this cache's own view under the same names:
``prefix_cache_hits``, ``_misses``,
``_tokens_saved``, ``_inserted_blocks``, ``_evicted_blocks``,
``_evictions`` by cause ('pressure', 'cap'), and the spill tier's
``kv_cache_spill_count``, ``kv_cache_bytes_spilled``,
``kv_cache_reinject_count`` and ``kv_cache_reinject_seconds`` (the
wall time of each of the last 4096 reinjections).
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

from .. import metrics as _m
from ..errors import InvalidRequest, OutOfBlocks
from ..decode.kv_cache import BlockTable
from .knobs import (ENV_PREFIX_CACHE_HOST_MB, ENV_PREFIX_CACHE_MAX_BLOCKS,
                    parse_int_env)

__all__ = ['PrefixCache']

_TIMING_WINDOW = 4096


class _Node:
    __slots__ = ('block', 'children', 'parent', 'chunk', 'last_use')

    def __init__(self, block, parent=None, chunk=None):
        self.block = block            # pool block id; None: spilled (or root)
        self.children = {}            # chunk tuple -> _Node
        self.parent = parent
        self.chunk = chunk            # this node's edge key in its parent
        self.last_use = 0


class _HostTier:
    """Byte-bounded LRU of spilled blocks, keyed by trie node. An entry is
    one block's host tensors, ``[(k, v, (k_scales, v_scales) or None)]`` a
    layer, and its byte count. ``put`` returns the nodes it dropped, so
    the cache can unlink their (fully spilled) subtrees."""

    def __init__(self, cap_bytes):
        self.cap = int(cap_bytes)
        self.bytes = 0
        self._entries = collections.OrderedDict()   # _Node -> (layers, n)

    def __len__(self):
        return len(self._entries)

    def __contains__(self, node):
        return node in self._entries

    def put(self, node, layers, nbytes):
        self._entries[node] = (layers, nbytes)
        self._entries.move_to_end(node)
        self.bytes += nbytes
        dropped = []
        while self.bytes > self.cap and self._entries:
            n, (_, b) = self._entries.popitem(last=False)
            self.bytes -= b
            dropped.append(n)
        return dropped

    def pop(self, node):
        layers, nbytes = self._entries.pop(node)
        self.bytes -= nbytes
        return layers

    def touch(self, node):
        if node in self._entries:
            self._entries.move_to_end(node)


class PrefixCache:
    """Token-trie prefix cache bound to one :class:`KVCachePool`.

    Its owner is a :class:`~..decode.engine.DecodeEngine`
    (``DecodeEngine(prefix_cache=True)`` or ``PADDLE_TPU_PREFIX_CACHE=1``);
    calls come from the scheduler's worker thread, and a lock keeps direct
    use from several threads correct.

    ``max_blocks``: resident-block cap (0 = uncapped, bounded by pool
    pressure only), default ``PADDLE_TPU_PREFIX_CACHE_MAX_BLOCKS``.
    ``host_mb``: the host spill tier's byte cap (0 = no spill tier: idle
    blocks are dropped), default ``PADDLE_TPU_PREFIX_CACHE_HOST_MB``.
    """

    def __init__(self, pool, max_blocks=None, host_mb=None):
        self.pool = pool
        self.block_size = pool.block_size
        self.max_blocks = (parse_int_env(ENV_PREFIX_CACHE_MAX_BLOCKS, 0,
                                         minimum=0)
                           if max_blocks is None else int(max_blocks))
        host_mb = (parse_int_env(ENV_PREFIX_CACHE_HOST_MB, 0, minimum=0)
                   if host_mb is None else int(host_mb))
        self._host = _HostTier(host_mb << 20) if host_mb else None
        self._root = _Node(None)
        self._resident = 0
        self._clock = itertools.count(1)
        self._lock = threading.RLock()
        self.reset_stats()

    def reset_stats(self):
        self.stats = {
            'prefix_cache_hits': 0, 'prefix_cache_misses': 0,
            'prefix_cache_tokens_saved': 0,
            'prefix_cache_inserted_blocks': 0,
            'prefix_cache_evicted_blocks': 0,
            'prefix_cache_evictions': {'pressure': 0, 'cap': 0},
            'kv_cache_spill_count': 0, 'kv_cache_bytes_spilled': 0,
            'kv_cache_reinject_count': 0,
            'kv_cache_reinject_seconds': collections.deque(
                maxlen=_TIMING_WINDOW)}

    # -- introspection -----------------------------------------------------
    @property
    def resident_blocks(self):
        return self._resident

    @property
    def spilled_blocks(self):
        """Blocks in the host tier (0 when it is off)."""
        return len(self._host) if self._host is not None else 0

    @property
    def host_bytes(self):
        return self._host.bytes if self._host is not None else 0

    def resident_block_ids(self):
        with self._lock:
            out = []
            stack = list(self._root.children.values())
            while stack:
                n = stack.pop()
                if n.block is not None:
                    out.append(n.block)
                stack.extend(n.children.values())
            return out

    # -- lookup ------------------------------------------------------------
    def match(self, prompt):
        """The longest cached whole-block prefix of ``prompt``, RETAINED for
        the caller (one reference a block): its block ids, at most
        ``(len(prompt) - 1) // block_size`` of them. Spilled nodes on the
        path are reinjected from the host tier (the path stops at the first
        one the pool cannot make room for)."""
        bs = self.block_size
        usable = max(len(prompt) - 1, 0) // bs
        with self._lock:
            node, path = self._root, []
            for i in range(usable):
                child = node.children.get(
                    tuple(int(t) for t in prompt[i * bs:(i + 1) * bs]))
                if child is None:
                    break
                path.append(child)
                node = child
            path = self._reinject_path(path)
            blocks = [n.block for n in path]
            # the hit path is one recency unit: leaf-first LRU then evicts
            # the deepest, least shared nodes first
            tick = next(self._clock)
            n = path[-1] if path else self._root
            while n is not None and n is not self._root:
                n.last_use = tick
                n = n.parent
            if blocks:
                self.pool.allocator.retain(blocks)
                self.stats['prefix_cache_hits'] += 1
                self.stats['prefix_cache_tokens_saved'] += len(blocks) * bs
                _m.prefix_cache_hits.inc()
                _m.prefix_cache_tokens_saved.inc(len(blocks) * bs)
            else:
                self.stats['prefix_cache_misses'] += 1
                _m.prefix_cache_misses.inc()
        return blocks

    def _reinject_path(self, path):
        """Make a hit path's spilled nodes resident again: a block each
        (spilling or evicting idle nodes off the path under pressure),
        then one ``write_whole_blocks`` a layer for all of them. Returns
        the usable (possibly shorter) path."""
        if not any(n.block is None for n in path):
            return path
        t0 = time.perf_counter()
        exclude = set(map(id, path))
        pending = []                       # (node, new block id, layers)
        try:
            for idx, n in enumerate(path):
                if n.block is not None:
                    continue
                # ``exclude`` keeps path nodes from being victims, not from
                # the host LRU's byte-cap drop: a pressure spill can drop a
                # later path node (this one too), so check before and after
                bid = None
                if n in self._host:
                    try:
                        bid = self._allocate_evicting(1, exclude=exclude)[0]
                    except OutOfBlocks:
                        bid = None
                    if bid is not None and n not in self._host:
                        self.pool.allocator.release([bid])
                        bid = None
                if bid is None:
                    # stop here; the still-spilled tail was just matched
                    # (hot), so refresh its host-LRU recency
                    for m in path[idx:]:
                        if m.block is None and m in self._host:
                            self._host.touch(m)
                    path = path[:idx]
                    break
                pending.append((n, bid, self._host.pop(n)))
            if not pending:
                return path
            ids = [bid for _, bid, _ in pending]
            for layer in range(len(pending[0][2])):
                rows = [p[layer] for _, _, p in pending]
                k = torch.cat([r[0] for r in rows], 1)
                v = torch.cat([r[1] for r in rows], 1)
                ks = vs = None
                if rows[0][2] is not None:
                    ks = torch.cat([r[2][0] for r in rows], 1)
                    vs = torch.cat([r[2][1] for r in rows], 1)
                self.pool.write_whole_blocks(layer, ids, k, v, k_scale=ks,
                                             v_scale=vs)
        except BaseException:
            # the pending payloads left the host tier: return their blocks
            # and drop the nodes, so no later match dangles on them
            self.pool.allocator.release([bid for _, bid, _ in pending])
            for m, _, _ in pending:
                self._drop_spilled(m)
            raise
        for n, bid, _ in pending:
            # the allocation's reference becomes the cache's own
            n.block = bid
            self._resident += 1
        dt = time.perf_counter() - t0
        self.stats['kv_cache_reinject_count'] += len(pending)
        self.stats['kv_cache_reinject_seconds'].append(dt)
        _m.prefix_cache_blocks_resident.set(self._resident)
        _m.kv_cache_reinject_count.inc(len(pending))
        _m.kv_cache_reinject_seconds.observe(dt)
        return path

    # -- admission ---------------------------------------------------------
    def acquire_table(self, prompt, total_tokens):
        """A request's :class:`BlockTable` for ``total_tokens`` (prompt +
        budget): shared cached-prefix blocks first, fresh blocks for the
        rest. Pool pressure spills (or evicts) idle cached blocks before
        giving up; the OutOfBlocks it then raises is the scheduler's wait
        signal, as without the cache."""
        bs = self.block_size
        nb = -(-int(total_tokens) // bs)
        if nb > self.pool.max_blocks_per_seq:
            raise InvalidRequest(
                f'{total_tokens} tokens need {nb} blocks > '
                f'max_blocks_per_seq={self.pool.max_blocks_per_seq}')
        with self._lock:
            shared = self.match(prompt) if prompt else []
            try:
                fresh = self._allocate_evicting(nb - len(shared))
            except OutOfBlocks:
                if shared:
                    self.pool.allocator.release(shared)
                raise
        return BlockTable(shared + fresh, bs, cached_len=len(shared) * bs)

    def _allocate_evicting(self, n, exclude=frozenset()):
        while True:
            try:
                return self.pool.allocator.allocate(n)
            except OutOfBlocks:
                if not self._spill_or_evict_one(exclude=exclude,
                                                cause='pressure'):
                    raise

    # -- publication -------------------------------------------------------
    def insert(self, prompt, table):
        """Publish ``table``'s whole prompt blocks into the trie. Blocks
        already cached on the path are skipped (the request keeps its
        identical private copy); a new node retains its block so it
        outlives the request, and a spilled node on the path becomes
        resident again on the request's copy. The cap is enforced here too
        (cause 'cap'), the walked path excluded from the victims."""
        bs = self.block_size
        full = len(prompt) // bs
        tick = next(self._clock)
        with self._lock:
            node = self._root
            walked = {id(self._root)}
            for i in range(full):
                chunk = tuple(int(t) for t in prompt[i * bs:(i + 1) * bs])
                child = node.children.get(chunk)
                if child is None or child.block is None:
                    if self.max_blocks and self._resident >= self.max_blocks:
                        if not self._spill_or_evict_one(exclude=walked,
                                                        cause='cap'):
                            break     # at the cap, nothing idle to move
                    bid = table.blocks[i]
                    self.pool.allocator.retain([bid])
                    if child is None:
                        child = _Node(bid, parent=node, chunk=chunk)
                        node.children[chunk] = child
                    else:             # promote the spilled node in place
                        child.block = bid
                        if self._host is not None and child in self._host:
                            self._host.pop(child)
                    self._resident += 1
                    self.stats['prefix_cache_inserted_blocks'] += 1
                    _m.prefix_cache_inserted_blocks.inc()
                child.last_use = tick
                walked.add(id(child))
                node = child
            _m.prefix_cache_blocks_resident.set(self._resident)

    # -- spill / eviction --------------------------------------------------
    def _spill_or_evict_one(self, exclude=frozenset(), cause='pressure',
                            allow_spill=True):
        """Move the least recently used idle node (refcount 1, no resident
        children) out of the pool: into the host tier when there is one and
        ``allow_spill``, else dropped. ``exclude`` holds the ``id()`` of
        nodes the caller's walk stands on. False when nothing can move."""
        victim = None
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if (n.block is not None and id(n) not in exclude
                    and all(c.block is None for c in n.children.values())
                    and self.pool.allocator.refcount(n.block) == 1):
                if victim is None or n.last_use < victim.last_use:
                    victim = n
        if victim is None:
            return False
        bid = victim.block
        if self._host is not None and allow_spill:
            self._spill(victim)         # sets victim.block = None
        else:
            self._unlink(victim)
        self.pool.allocator.release([bid])
        self._resident -= 1
        self.stats['prefix_cache_evicted_blocks'] += 1
        self.stats['prefix_cache_evictions'][cause] += 1
        _m.prefix_cache_evicted_blocks.inc()
        _m.prefix_cache_evictions.labels(cause=cause).inc()
        _m.prefix_cache_blocks_resident.set(self._resident)
        return True

    def _spill(self, node):
        """Copy ``node``'s block to the host tier (every layer's K, V and
        int8 scales, at the pool's storage type) and leave the node with
        ``block=None``; the caller releases the block."""
        pool, bid = self.pool, node.block
        layers = [(*pool.read_blocks(layer, [bid]),
                   pool.read_block_scales(layer, [bid]))
                  for layer in range(pool.num_layers)]
        nbytes = sum(t.nbytes for k, v, sc in layers
                     for t in (k, v, *(sc or ())))
        node.block = None
        for dropped in self._host.put(node, layers, nbytes):
            # the LRU let this payload go: its (fully spilled) trie path
            # goes with it, or match would dangle
            self._drop_spilled(dropped)
        self.stats['kv_cache_spill_count'] += 1
        self.stats['kv_cache_bytes_spilled'] += nbytes
        _m.kv_cache_spill_count.inc()
        _m.kv_cache_bytes_spilled.inc(nbytes)

    def _unlink(self, node):
        """Remove ``node`` from the trie; its children (all spilled, by the
        victim rule) become unreachable and leave the host tier too."""
        if node.parent is not None:
            del node.parent.children[node.chunk]
        for child in list(node.children.values()):
            self._drop_spilled(child)

    def _drop_spilled(self, node):
        """Discard a spilled node and its (spilled) subtree."""
        if node.parent is not None and node.parent.children.get(
                node.chunk) is node:
            del node.parent.children[node.chunk]
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if self._host is not None and n in self._host:
                self._host.pop(n)

    def evict_idle(self):
        """Drop every idle cached block for real, no spilling, and drain
        the host tier's fully spilled subtrees. Returns the blocks
        dropped from the pool."""
        with self._lock:
            n = 0
            while self._spill_or_evict_one(allow_spill=False):
                n += 1
            if self._host is not None:
                stack = [self._root]
                while stack:
                    node = stack.pop()
                    for child in list(node.children.values()):
                        if child.block is None:
                            self._drop_spilled(child)
                        else:
                            stack.append(child)
            return n
