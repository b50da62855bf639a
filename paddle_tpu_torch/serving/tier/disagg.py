"""Disaggregated prefill and decode (counterpart of
paddle_tpu/serving/tier/disagg.py): a prefill-role engine runs the bucket
ladder and ships the finished KV blocks and the first greedy token to the
decode engine, so a long prompt no longer stalls the lockstep decode step.

Colocated, each admission's prefill runs between decode steps and every
active stream's next token waits behind it. Disaggregated, the scheduler
marks the admitted slot handoff-pending and keeps stepping; a prefill
worker runs the prompt on its OWN engine and pool (K2) and hands back a
:class:`KVPayload`; the decode worker scatters the whole blocks into its
pool (one ``index_put_`` a layer) and the stream starts.

The handoff interface is the seam: :class:`LocalPrefillWorker` is the
in-process transport (a thread a prefill engine, and queues);
:meth:`KVPayload.to_bytes` / :meth:`KVPayload.from_bytes` write and read
the reference's npz wire format (``meta`` of 4 int64: context length,
first token, block size, the KV storage code; ``k{i}``/``v{i}`` a layer,
bf16 widened to f32; ``ks{i}``/``vs{i}`` the int8 row scales), so a
cross-host transport can sit behind the same ``submit`` /
``drain_completed`` contract.

Threads: the prefill worker and the decode worker launch onto the current
stream of their own threads. The payload leaves the prefill pool through
``.cpu()`` (``KVCachePool.read_blocks``), which waits for the prefill's
writes, and enters the decode pool from host tensors, so no event is
needed between the two threads.

The prefill engine runs the same weights through the same bucket-padded
prefill (the same GEMM shapes and K2), so the shipped K/V are the bytes a
colocated prefill writes, on the CPU and on the card; a handoff's stream
equals the colocated one token for token.

Counters: the registry's ``disagg_*`` family (serving/metrics.py), at the
reference's sites, and ``LocalPrefillWorker.stats``, the worker's own view
under the same names: ``disagg_handoffs``,
``disagg_handoff_failures``, ``disagg_kv_bytes`` and
``disagg_handoff_seconds`` (submit to completion, the last 4096);
``pending`` is the ``disagg_pending`` gauge.
"""
from __future__ import annotations

import collections
import io
import queue
import threading
import time

import numpy as np
import torch

from .. import metrics as _m
from ..errors import ServingError
from ..decode.kv_cache import KV_DTYPE_CODES

__all__ = ['KVPayload', 'PrefillReplica', 'LocalPrefillWorker']

_TIMING_WINDOW = 4096


def _host(t):
    """A host tensor of ``t`` (a torch tensor, or a numpy array, copied)."""
    return t.cpu() if isinstance(t, torch.Tensor) else torch.from_numpy(
        np.array(t))


def _wire(t):
    """``t`` as the numpy array the wire carries: bf16 widened to f32 (npz
    has no portable bf16; the receiving pool narrows it back exactly)."""
    t = _host(t)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class KVPayload:
    """One finished prefill (or one spilled prefix-cache block): whole KV
    blocks of every layer and the first greedy token. ``layers[i]`` is
    ``(k, v)``, each (H, num_blocks, block_size, D) host tensors, the
    :meth:`KVCachePool.read_blocks` layout. ``kv_dtype`` is the sender
    pool's storage; for int8 pools ``scales[i]`` is the ``(k_scales,
    v_scales)`` pair of (H, num_blocks, block_size) f32 row scales, so a
    receiver at the same storage scatters them byte for byte."""

    __slots__ = ('layers', 'context_len', 'first_token', 'block_size',
                 'kv_dtype', 'scales')

    def __init__(self, layers, context_len, first_token, block_size,
                 kv_dtype='f32', scales=None):
        self.layers = [(_host(k), _host(v)) for k, v in layers]
        self.context_len = int(context_len)
        self.first_token = int(first_token)
        self.block_size = int(block_size)
        self.kv_dtype = kv_dtype
        self.scales = (None if scales is None else
                       [None if sc is None else (_host(sc[0]), _host(sc[1]))
                        for sc in scales])

    @property
    def num_blocks(self):
        return self.layers[0][0].shape[1] if self.layers else 0

    @property
    def nbytes(self):
        tensors = [t for pair in self.layers for t in pair]
        if self.scales is not None:
            tensors += [t for pair in self.scales if pair is not None
                        for t in pair]
        return sum(t.numel() * t.element_size() for t in tensors)

    # -- wire format (the cross-host seam) ---------------------------------
    def to_bytes(self):
        arrays = {'meta': np.asarray(
            [self.context_len, self.first_token, self.block_size,
             KV_DTYPE_CODES[self.kv_dtype]], np.int64)}
        for i, (k, v) in enumerate(self.layers):
            arrays[f'k{i}'] = _wire(k)
            arrays[f'v{i}'] = _wire(v)
            if self.scales is not None and self.scales[i] is not None:
                arrays[f'ks{i}'] = _wire(self.scales[i][0])
                arrays[f'vs{i}'] = _wire(self.scales[i][1])
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data):
        codes = {v: k for k, v in KV_DTYPE_CODES.items()}
        with np.load(io.BytesIO(data)) as z:
            meta = [int(x) for x in z['meta']]
            ctx, first, bs = meta[:3]
            # a 3-int meta (an older sender) means an f32 payload
            kv_dtype = codes[meta[3]] if len(meta) > 3 else 'f32'
            layers, scales = [], []
            i = 0
            while f'k{i}' in z:
                layers.append((z[f'k{i}'], z[f'v{i}']))
                scales.append((z[f'ks{i}'], z[f'vs{i}'])
                              if f'ks{i}' in z else None)
                i += 1
        return cls(layers, ctx, first, bs, kv_dtype=kv_dtype,
                   scales=scales if any(s is not None for s in scales)
                   else None)


class PrefillReplica:
    """Prefill-role wrapper around a :class:`DecodeEngine`: its pool is
    scratch space, blocks live from the prefill to the payload's read.
    One worker thread owns it (:class:`LocalPrefillWorker`)."""

    def __init__(self, engine):
        self.engine = engine

    def prefill_to_payload(self, prompt, max_new_tokens=0):
        """Run the bucket-padded prompt on the prefill engine, read the
        finished blocks out, free them, return the :class:`KVPayload`."""
        eng = self.engine
        bs = eng.pool.block_size
        table = eng.pool.new_table(len(prompt))   # the prompt only
        try:
            first = eng.prefill(prompt, table)
            blocks = table.blocks[:-(-len(prompt) // bs)]
            layers, scales = [], []
            for layer in range(eng.pool.num_layers):
                layers.append(eng.pool.read_blocks(layer, blocks))
                scales.append(eng.pool.read_block_scales(layer, blocks))
        finally:
            eng.release_table(table)
        return KVPayload(layers, len(prompt), first, bs,
                         kv_dtype=eng.pool.kv_dtype,
                         scales=None if all(s is None for s in scales)
                         else scales)


class LocalPrefillWorker:
    """In-process handoff transport: one worker thread running a
    :class:`PrefillReplica`'s prefills, feeding a completion queue the
    decode scheduler drains between steps.

    The contract ``DecodeScheduler(disagg=...)`` uses:

    - ``submit(key, prompt, max_new_tokens)``: enqueue one prefill; never
      blocks.
    - ``drain_completed(timeout)``: every finished ``(key, payload, exc)``;
      ``exc`` is a typed ServingError when the prefill failed (that
      request fails, the decode loop keeps serving).

    The reference also takes a list of replicas, one thread each; the port
    takes the one replica ``build_replica_stack`` builds.
    """

    def __init__(self, prefill_replica, start=True):
        self.replica = prefill_replica
        self._jobs = queue.Queue()
        self._done = queue.Queue()
        self._pending = 0
        self._lock = threading.Lock()
        self.reset_stats()
        self._thread = threading.Thread(target=self._run,
                                        name='paddle-tpu-torch-prefill',
                                        daemon=True)
        if start:
            self._thread.start()

    def reset_stats(self):
        with self._lock:
            self.stats = {'disagg_handoffs': 0, 'disagg_handoff_failures': 0,
                          'disagg_kv_bytes': 0,
                          'disagg_handoff_seconds': collections.deque(
                              maxlen=_TIMING_WINDOW)}

    @property
    def pending(self):
        with self._lock:
            return self._pending

    def submit(self, key, prompt, max_new_tokens=0):
        with self._lock:
            self._pending += 1
            _m.disagg_pending.set(self._pending)
        self._jobs.put((key, list(prompt), int(max_new_tokens),
                        time.perf_counter()))

    def drain_completed(self, timeout=0.0):
        out = []
        deadline = time.monotonic() + timeout
        while True:
            try:
                remaining = deadline - time.monotonic()
                if out or remaining <= 0:
                    out.append(self._done.get_nowait())
                else:
                    out.append(self._done.get(timeout=remaining))
            except queue.Empty:
                return out

    def _run(self):
        replica = self.replica
        while True:
            job = self._jobs.get()
            if job is None:
                return
            key, prompt, max_new, t0 = job
            payload, exc = None, None
            try:
                payload = replica.prefill_to_payload(prompt, max_new)
            except Exception as e:
                exc = e if isinstance(e, ServingError) else ServingError(
                    f'disaggregated prefill failed: '
                    f'{type(e).__name__}: {e}')
            dt = time.perf_counter() - t0
            with self._lock:
                self._pending -= 1
                _m.disagg_pending.set(self._pending)
                if payload is None:
                    self.stats['disagg_handoff_failures'] += 1
                else:
                    self.stats['disagg_handoffs'] += 1
                    self.stats['disagg_kv_bytes'] += payload.nbytes
                    self.stats['disagg_handoff_seconds'].append(dt)
            if payload is None:
                _m.disagg_handoff_failures.inc()
            else:
                _m.disagg_handoffs.inc()
                _m.disagg_kv_bytes.inc(payload.nbytes)
                _m.disagg_handoff_seconds.observe(dt)
            self._done.put((key, payload, exc))

    def close(self):
        self._jobs.put(None)
        if self._thread.is_alive():
            self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
