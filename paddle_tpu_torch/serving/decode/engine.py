"""DecodeEngine: phase-split stateful generation over a paged KV cache
(counterpart of paddle_tpu/serving/decode/engine.py).

- **prefill** runs the prompt once at a bucket-ladder length (powers of two
  up to ``max_prompt_len``), writing its K/V into cache blocks; attention
  goes through the ``paged_prefill_attention`` kernel.
- **decode** steps all S slots in lockstep at ONE fixed shape ((S, 1)
  tokens + (S, max_blocks_per_seq) tables + (S,) context lengths); attention
  goes through the ``paged_attention`` kernel.

- **spec_step** (speculative decoding) feeds up to ``spec_k`` tokens a
  slot in one (S, K) step; attention reads through the ``paged_attention``
  kernel's verify form, row j of a slot at context ``c + 1 + j``.

Each decode step copies the (S, V) logits rows to the host, where the
scheduler picks tokens (greedy argmax or the request's sampler).

With a prefix cache (serving/tier/prefix_cache.py), ``reserve_table(...,
prompt=)`` starts a table with shared cached blocks and
:meth:`DecodeEngine.publish_prefix` publishes a filled prompt; under
disaggregated prefill (serving/tier/disagg.py) :meth:`DecodeEngine.
inject_prefill` writes a prefill engine's blocks into this pool.

The engine is single-threaded by design (one scheduler worker owns it); it
holds no queueing or lifecycle logic, that is scheduler.py.
"""
from __future__ import annotations

import collections
import os
import time

import numpy as np
import torch

from .. import metrics as _m
from ..engine import bucket_ladder
from ..errors import InvalidRequest
from ...observability import distributed as _dobs
from ..tier.knobs import (ENV_DECODE_HBM_MB, ENV_KV_DTYPE, ENV_PREFIX_CACHE,
                          ENV_SPEC_DECODE, ENV_SPEC_K, KV_DTYPE_CHOICES,
                          parse_choice_env, parse_flag_env, parse_int_env)
from .kv_cache import (CacheContext, KVCachePool, DEFAULT_BLOCK_SIZE,
                       DEFAULT_MAX_BLOCKS, DEFAULT_SLOTS, KV_DTYPE_CODES)

__all__ = ['DecodeEngine', 'TIMING_WINDOW']

# timings kept per series, so a long-running replica's stats stay bounded
TIMING_WINDOW = 4096


class DecodeEngine:
    """Stateful generation over ``model`` (the models/causal_lm.py forward
    contract: ``model(ids, pos_ids=None, cache=None) -> logits``). The pool
    lives on the model's device.

    - ``slots``: fixed lockstep decode batch size S.
    - ``block_size`` / ``max_blocks``: KV-cache pool geometry.
    - ``max_prompt_len``: top rung of the prefill bucket ladder.
    - ``max_new_tokens_cap``: per-request generation budget cap (block
      reservations are taken against prompt + budget at admission).
    - ``spec_decode`` / ``spec_k``: speculative decoding, the (S, k) verify
      step :meth:`spec_step` (``spec_k`` default 4, at least 2). The
      argument wins, else ``PADDLE_TPU_SPEC_DECODE``, default off; an
      explicit ``PADDLE_TPU_SPEC_DECODE=0`` wins over the argument too (the
      operator's escape hatch).
    - ``kv_dtype``: the pool's storage, 'f32', 'bf16' or 'int8'; the
      argument, else ``PADDLE_TPU_KV_DTYPE``, else f32.
    - ``prefix_cache``: True (a :class:`PrefixCache` over this pool, its
      cap and host tier from their knobs), False, a ``PrefixCache``, or
      None for ``PADDLE_TPU_PREFIX_CACHE`` (default off).

    The reference serializes the forwards of a decode and a prefill engine
    under one model lock because its dygraph no-grad flag is process-wide.
    The port takes no lock: torch's grad mode is per thread and the
    model's forward mutates nothing, so two engines on one model run their
    forwards from two threads as they are.

    Counters (``stats``, cleared by :meth:`reset_stats`): ``prefills``,
    ``decode_steps`` (lockstep steps and verify rounds), ``step_seconds``
    (the wall time of each of the last :data:`TIMING_WINDOW` decode steps
    and verify rounds, the host copy of the logits included),
    ``prefill_seconds`` (the same, by rung), and speculative decoding's
    ``spec_rounds``, ``spec_drafted`` and ``spec_accepted`` (draft tokens
    fed and confirmed; the scheduler counts them). They are this engine's
    own view; the registry's ``decode_*``, ``decode_spec_*`` and
    ``kv_cache_*`` metrics (serving/metrics.py, ``GET /metrics``) and the
    ``occupancy`` and ``decode_step`` windowed series are recorded always,
    at the reference's sites.
    """

    def __init__(self, model, slots=None, block_size=None, max_blocks=None,
                 max_prompt_len=64, max_new_tokens_cap=64, eos_id=None,
                 prefix_cache=None, spec_decode=None,
                 spec_k=None, kv_dtype=None):
        self.model = model
        model.eval()               # generation is inference: no dropout
        self.device = next(model.parameters()).device
        self.slots = int(slots or DEFAULT_SLOTS)
        self.max_prompt_len = int(max_prompt_len)
        self.max_new_tokens_cap = int(max_new_tokens_cap)
        self.eos_id = eos_id
        self.prompt_buckets = bucket_ladder(self.max_prompt_len)
        block_size = int(block_size or DEFAULT_BLOCK_SIZE)
        max_total = self.max_prompt_len + self.max_new_tokens_cap
        max_bps = -(-max_total // block_size)
        if kv_dtype is None:
            kv_dtype = parse_choice_env(ENV_KV_DTYPE, KV_DTYPE_CHOICES, 'f32')
        self.pool = KVCachePool(block_size=block_size,
                                num_blocks=self._resolve_num_blocks(
                                    max_blocks),
                                max_blocks_per_seq=max_bps,
                                kv_dtype=kv_dtype, device=self.device)
        if self.pool.allocator.capacity < max_bps:
            # an empty pool must always cover one maximal request, or the
            # scheduler's FIFO head could wait forever
            raise ValueError(
                f'max_blocks={self.pool.num_blocks} cannot hold one '
                f'maximal request ({max_bps} blocks for '
                f'{max_total} tokens at block_size={block_size})')
        _m.decode_slots_total.set(self.slots)
        _m.decode_cache_blocks_total.set(self.pool.allocator.capacity)
        _m.kv_cache_dtype.set(KV_DTYPE_CODES[self.pool.kv_dtype])
        positions = model.cfg.max_position_embeddings
        if self.pool.padded_context > positions:
            # a position id past the table faults on the card
            raise ValueError(
                f'padded_context {self.pool.padded_context} exceeds the '
                f'model\'s {positions} position embeddings')
        # env '0' is the escape hatch and wins over the argument; else the
        # argument, else the env, default off
        if os.environ.get(ENV_SPEC_DECODE, '').strip() == '0':
            self.spec_enabled = False
        elif spec_decode is not None:
            self.spec_enabled = bool(spec_decode)
        else:
            self.spec_enabled = parse_flag_env(ENV_SPEC_DECODE, False)
        self.spec_k = int(spec_k if spec_k is not None
                          else parse_int_env(ENV_SPEC_K, 4, minimum=2))
        if self.spec_k < 2:
            raise ValueError(f'spec_k must be >= 2, got {self.spec_k}')
        if prefix_cache is None:
            prefix_cache = parse_flag_env(ENV_PREFIX_CACHE, False)
        if prefix_cache is True:
            from ..tier.prefix_cache import PrefixCache
            prefix_cache = PrefixCache(self.pool)
        self.prefix_cache = prefix_cache or None
        self._prefilled_buckets = set()
        self._stepped = False
        self._spec_stepped = False
        self.reset_stats()

    @staticmethod
    def _resolve_num_blocks(max_blocks):
        """The pool's block count: the argument, then an explicitly set
        ``PADDLE_TPU_DECODE_MAX_BLOCKS``, else the module default.
        ``PADDLE_TPU_DECODE_HBM_MB`` (a budget solved into a block count)
        raises: its solve is analysis/plan.py's, ROADMAP A.11."""
        if max_blocks:
            return int(max_blocks)
        raw = os.environ.get('PADDLE_TPU_DECODE_MAX_BLOCKS', '').strip()
        if raw:
            return int(raw)
        if parse_int_env(ENV_DECODE_HBM_MB, 0, minimum=1):
            raise NotImplementedError(
                f'{ENV_DECODE_HBM_MB}: the pool-size solve over a device '
                f'memory budget (analysis/plan.py) comes with ROADMAP A.11; '
                f'set max_blocks or PADDLE_TPU_DECODE_MAX_BLOCKS')
        return DEFAULT_MAX_BLOCKS

    def reset_stats(self):
        self.stats = {'prefills': 0, 'decode_steps': 0,
                      'step_seconds': collections.deque(maxlen=TIMING_WINDOW),
                      'prefill_seconds': collections.defaultdict(
                          lambda: collections.deque(maxlen=TIMING_WINDOW)),
                      'spec_rounds': 0, 'spec_drafted': 0,
                      'spec_accepted': 0}

    # -- geometry ----------------------------------------------------------
    @property
    def block_size(self):
        return self.pool.block_size

    @property
    def padded_context(self):
        """The key extent every attention read pads to: run the uncached
        reference (models/causal_lm.greedy_generate) at this pad_len."""
        return self.pool.padded_context

    def validate(self, prompt_ids, max_new_tokens):
        """Typed admission checks; returns (prompt list, max_new int)."""
        try:
            prompt = [int(t) for t in prompt_ids]
        except (TypeError, ValueError) as e:
            raise InvalidRequest(f'prompt must be a sequence of ints: {e}')
        if not prompt:
            raise InvalidRequest('empty prompt')
        if len(prompt) > self.max_prompt_len:
            raise InvalidRequest(
                f'prompt of {len(prompt)} tokens exceeds max_prompt_len='
                f'{self.max_prompt_len}')
        vocab = self.model.cfg.vocab_size
        if min(prompt) < 0 or max(prompt) >= vocab:
            raise InvalidRequest(f'prompt token ids must be in [0, {vocab})')
        try:
            max_new = int(max_new_tokens)
        except (TypeError, ValueError) as e:
            raise InvalidRequest(f'max_new_tokens must be an integer: {e}')
        if max_new < 1:
            raise InvalidRequest(f'max_new_tokens must be >= 1, got '
                                 f'{max_new}')
        if max_new > self.max_new_tokens_cap:
            raise InvalidRequest(
                f'max_new_tokens={max_new} exceeds the engine cap '
                f'{self.max_new_tokens_cap}')
        return prompt, max_new

    def reserve_table(self, prompt_len, max_new_tokens, prompt=None):
        """Block reservation for prompt + budget (raises OutOfBlocks, which
        the scheduler treats as 'wait for a finishing slot'). With the
        prefix cache on and ``prompt`` given, the table's front blocks are
        shared cached-prefix blocks (``table.cached_len`` > 0) and only the
        rest is allocated."""
        total = int(prompt_len) + int(max_new_tokens)
        if self.prefix_cache is not None:
            return self.prefix_cache.acquire_table(prompt or [], total)
        return self.pool.new_table(total)

    def publish_prefix(self, prompt, table):
        """Publish ``table``'s whole prompt blocks into the prefix cache (a
        no-op without one), once the whole prompt's K/V is cached: after a
        cold prefill, a suffix fill or an injected handoff."""
        if self.prefix_cache is not None:
            self.prefix_cache.insert(prompt, table)

    def release_table(self, table):
        self.pool.free_table(table)
        _m.decode_cache_blocks_used.set(self.pool.allocator.used)

    # -- phases ------------------------------------------------------------
    def prefill(self, prompt, table, sampler=None):
        """Run the bucket-padded prompt once, writing K/V into ``table``'s
        blocks, and return the FIRST generated token: greedy, or drawn by
        ``sampler(logits_row)`` for sampled requests. Sets
        ``table.context_len = len(prompt)``."""
        n = len(prompt)
        bucket = next(b for b in self.prompt_buckets if n <= b)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = prompt
        table.context_len = n
        ctx = CacheContext(self.pool, 'prefill', [table])
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = self.model(torch.as_tensor(ids, device=self.device),
                                cache=ctx)
            row = logits[0, n - 1].cpu().numpy()
        dt = time.perf_counter() - t0
        _m.decode_prefill_seconds.observe(dt)
        if bucket not in self._prefilled_buckets:
            self._prefilled_buckets.add(bucket)
            _m.decode_prefill_compiles.inc()
        _m.decode_cache_blocks_used.set(self.pool.allocator.used)
        _m.kv_cache_bytes_in_hbm.set(self.pool.bytes_in_hbm())
        self.stats['prefills'] += 1
        self.stats['prefill_seconds'][bucket].append(dt)
        if sampler is not None:
            return int(sampler(row))
        return int(row.argmax())

    def decode_step(self, tokens, tables, return_rows=False):
        """One lockstep step over all S slots at fixed shape.

        ``tokens``: length-S list, the token to feed per slot (None =
        inactive). ``tables``: length-S list of BlockTables (None =
        inactive). For an active slot with context c, the fed token is the
        one at position c; its K/V are written and attended this step.
        Returns (S,) next-token ids (greedy; garbage on inactive slots) and
        advances each active table's context_len by 1. With
        ``return_rows=True`` the (S, V) logits rows come back too
        (``(ids, rows)``) so the scheduler can sample non-greedy slots."""
        s_count = self.slots
        if len(tokens) != s_count or len(tables) != s_count:
            raise ValueError(f'decode_step needs {s_count} tokens and '
                             f'tables, got {len(tokens)} and {len(tables)}')
        ids = np.zeros((s_count, 1), np.int64)
        pos = np.zeros((s_count, 1), np.int64)
        ctx_lens = []
        for s in range(s_count):
            if tables[s] is None:
                ctx_lens.append(1)          # scratch read, masked + ignored
                continue
            c = tables[s].context_len
            ids[s, 0] = tokens[s]
            pos[s, 0] = c
            tables[s].context_len = c + 1   # the fed token becomes cached
            ctx_lens.append(c + 1)
        ctx = CacheContext(self.pool, 'decode', tables, ctx_lens)
        t0 = time.perf_counter()
        with torch.no_grad():
            both = torch.as_tensor(np.concatenate([ids, pos], 1),
                                   device=self.device)
            logits = self.model(both[:, :1], pos_ids=both[:, 1:], cache=ctx)
            rows = logits[:, 0].cpu().numpy()
            out = rows.argmax(-1)
        dt = time.perf_counter() - t0
        self._stepped = True
        self.stats['decode_steps'] += 1
        self.stats['step_seconds'].append(dt)
        _m.decode_step_seconds.observe(dt)
        _m.decode_steps.inc()
        active = sum(t is not None for t in tables)
        _m.decode_slots_active.set(active)
        _m.decode_slot_occupancy.observe(active / max(s_count, 1))
        # sliding-window views for /healthz and the SLO monitor
        _dobs.series('occupancy').observe(active / max(s_count, 1))
        _dobs.series('decode_step').observe(dt)
        if return_rows:
            return out, rows
        return out

    def spec_step(self, token_lists, tables):
        """One (S, k) speculative verify step over all S slots.

        ``token_lists``: length-S list; None or [] for an inactive slot,
        else up to ``spec_k`` tokens to feed, the slot's pending token
        first, then its drafts. Their K/V are written at positions
        context_len .. context_len + f - 1 and each table's
        ``context_len`` advances by f; the caller rolls a rejected tail
        back with one store, ``table.context_len = base + accepted`` (the
        blocks stay; the stale positions are masked until rewritten).

        Returns (S, k, V) logits rows: row j of a slot is the model's
        distribution after fed tokens 0..j, the row the lockstep step
        would give at that context. Padded lanes (j >= f) are garbage and
        must be ignored."""
        s_count, kw = self.slots, self.spec_k
        if len(token_lists) != s_count or len(tables) != s_count:
            raise ValueError(f'spec_step needs {s_count} token lists and '
                             f'tables, got {len(token_lists)} and '
                             f'{len(tables)}')
        ids = np.zeros((s_count, kw), np.int64)
        pos = np.zeros((s_count, kw), np.int64)
        ctx_lens, fed_counts = [], []
        for s in range(s_count):
            toks = token_lists[s]
            if tables[s] is None or not toks:
                ctx_lens.append(1)      # scratch read, masked + ignored
                fed_counts.append(0)
                continue
            f = min(len(toks), kw)
            c = tables[s].context_len
            ids[s, :f] = toks[:f]
            pos[s, :f] = np.arange(c, c + f)
            pos[s, f:] = c + f - 1      # padded lanes: an in-range position
            tables[s].context_len = c + f
            ctx_lens.append(c + 1)
            fed_counts.append(f)
        ctx = CacheContext(self.pool, 'decode', tables, ctx_lens,
                           fed_counts=fed_counts, window=kw)
        t0 = time.perf_counter()
        with torch.no_grad():
            both = torch.as_tensor(np.concatenate([ids, pos], 1),
                                   device=self.device)
            logits = self.model(both[:, :kw], pos_ids=both[:, kw:],
                                cache=ctx)
            rows = logits.cpu().numpy()
        dt = time.perf_counter() - t0
        self._spec_stepped = True
        self.stats['decode_steps'] += 1
        self.stats['spec_rounds'] += 1
        self.stats['step_seconds'].append(dt)
        _m.decode_step_seconds.observe(dt)      # it IS the decode step
        _m.decode_spec_verify_seconds.observe(dt)
        _m.decode_steps.inc()
        _m.decode_spec_rounds.inc()
        active = sum(t is not None for t in tables)
        _m.decode_slots_active.set(active)
        _m.decode_slot_occupancy.observe(active / max(s_count, 1))
        _dobs.series('occupancy').observe(active / max(s_count, 1))
        _dobs.series('decode_step').observe(dt)
        return rows

    def inject_prefill(self, table, payload):
        """Receive a disaggregated prefill (serving/tier/disagg.py): write
        the payload's whole K/V blocks into ``table``'s first blocks of this
        pool, one scatter a layer, and mark the prompt cached. Blocks below
        ``table.cached_len`` (shared prefix-cache blocks) are filled
        already and skipped. Returns the payload's first greedy token."""
        bs = self.pool.block_size
        if payload.block_size != bs:
            raise InvalidRequest(
                f'handoff block_size {payload.block_size} != engine '
                f'block_size {bs}')
        skip = table.cached_len // bs
        nb = payload.num_blocks
        if nb > len(table.blocks):
            raise InvalidRequest(
                f'handoff carries {nb} blocks but the table reserves only '
                f'{len(table.blocks)}')
        for layer, (k, v) in enumerate(payload.layers):
            ks = vs = None
            if payload.scales is not None:
                ks, vs = payload.scales[layer]
            if skip:
                k, v = k[:, skip:], v[:, skip:]
                if ks is not None:
                    ks, vs = ks[:, skip:], vs[:, skip:]
            if k.shape[1]:
                self.pool.write_whole_blocks(layer, table.blocks[skip:nb],
                                             k, v, k_scale=ks, v_scale=vs)
        table.context_len = payload.context_len
        _m.decode_cache_blocks_used.set(self.pool.allocator.used)
        _m.kv_cache_bytes_in_hbm.set(self.pool.bytes_in_hbm())
        return int(payload.first_token)

    # -- warmup ------------------------------------------------------------
    @property
    def warmed(self):
        """True once every prefill rung, the decode step and (with
        speculative decoding) the verify step have run (via :meth:`warmup`
        or traffic): the kernels are built and loaded and the allocator has
        seen every shape. Surfaced through ``/healthz``."""
        return (self._stepped
                and (self._spec_stepped or not self.spec_enabled)
                and all(b in self._prefilled_buckets
                        for b in self.prompt_buckets))

    def warmup(self):
        """Run every prefill rung, one decode step and, with speculative
        decoding, one verify step before traffic arrives. Returns {phase:
        seconds}. Uses temporary blocks; the pool ends unchanged."""
        timings = {}
        for bucket in self.prompt_buckets:
            # spec_k tokens of headroom for the verify step's window
            table = self.reserve_table(
                bucket, self.spec_k if self.spec_enabled else 1)
            t0 = time.perf_counter()
            tok = self.prefill([1] * bucket, table)
            timings[f'prefill_{bucket}'] = time.perf_counter() - t0
            tokens = [tok] + [None] * (self.slots - 1)
            tables = [table] + [None] * (self.slots - 1)
            t0 = time.perf_counter()
            self.decode_step(tokens, tables)
            timings.setdefault('decode_step', time.perf_counter() - t0)
            if self.spec_enabled and 'spec_step' not in timings:
                base = table.context_len
                feed = [[tok] * (self.spec_k - 1)] + [None] * (self.slots - 1)
                t0 = time.perf_counter()
                self.spec_step(feed, tables)
                timings['spec_step'] = time.perf_counter() - t0
                table.context_len = base      # roll the warm-up feed back
            self.release_table(table)
        return timings
