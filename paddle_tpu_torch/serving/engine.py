"""InferenceEngine: bucketed-batch inference over a saved model
(counterpart of paddle_tpu/serving/engine.py).

The single-request :class:`~paddle_tpu_torch.inference.Predictor` lowers one
plan per feed-shape set, and on the card cuDNN and cuBLAS pick (and, with
benchmarking on, time) their algorithms per shape: fine for a script, a
stall for a server where every distinct batch size would be a first run.
The engine pads the batch dimension up to a small **bucket ladder** (1, 2,
4, ..., max_batch_size by default), so

- the number of lowered plans is bounded by ``len(buckets)`` forever,
- :meth:`warmup` runs the whole ladder once before traffic arrives.

Padding replicates the last real row so pad lanes stay inside the data
distribution (no log(0)/NaN surprises in models with row-local
nonlinearities), and the padding is sliced off before the rows go back.

Row independence: per-row ops (matmul rows, row-wise activations,
inference-mode norm) do not mix rows, so a row served in any bucket is the
row a single-request ``Predictor.run`` gives. The JAX package promises
bitwise equality. The port promises equality within round-off, since
cuDNN and cuBLAS may choose another algorithm for another batch size and
sum a row's products in another order; on an H100, PaddleCV's ResNet-50
gave every row bit for bit at every rung of 1-32, in f32 and with bf16
feeds (``chip_smoke.py`` phase 19), and on the CPU rows differ from their
single-row runs by round-off (tests/test_torch_inference_engine.py).

The request contract is the JAX package's, 400 for 400: int64 feeds
outside the int32 range are rejected (the port computes int64 as it is,
but a client must see the same answers from both), and so are
out-of-range embedding ids unless ``PADDLE_TPU_EMBED_OOB=clip`` (the
port's ``lookup_table`` clamps them into the table, as the reference's
kernel clips them).

Thread-safety: :meth:`run_batch` serializes on an internal lock. The
intended topology is ONE caller, the micro-batcher worker thread
(batcher.py); the lock only keeps direct multi-threaded use correct, not
fast.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np

from . import metrics as _m
from .errors import InvalidRequest
from ..inference import Predictor

__all__ = ['InferenceEngine', 'bucket_ladder', 'DEFAULT_MAX_BATCH']

DEFAULT_MAX_BATCH = int(os.environ.get('PADDLE_TPU_SERVING_MAX_BATCH', '16'))

# the out-of-range embedding-id policy of the reference's
# ops/sparse_ops.py, whose sparse paths the port has not taken over yet
ENV_EMBED_OOB = 'PADDLE_TPU_EMBED_OOB'

_INT32_MAX = 2 ** 31 - 1
_INT32_MIN = -2 ** 31


def oob_policy():
    """Out-of-range embedding-id policy of the serving validation:
    'error' rejects the request, 'clip' is the legacy escape hatch (ids
    clamp to row V-1 on the device)."""
    v = os.environ.get(ENV_EMBED_OOB, 'error')
    if v not in ('error', 'clip'):
        raise ValueError(
            f"{ENV_EMBED_OOB}={v!r} invalid (supported: error, clip)")
    return v


def bucket_ladder(max_batch_size, buckets=None):
    """The padded batch sizes the engine compiles. Default: powers of two up
    to ``max_batch_size``, with ``max_batch_size`` always the top rung (e.g.
    max 12 → [1, 2, 4, 8, 12]). A custom ladder is validated: positive,
    strictly increasing, topped by ``max_batch_size``."""
    max_batch_size = int(max_batch_size)
    if max_batch_size < 1:
        raise ValueError(f'max_batch_size must be >= 1, got {max_batch_size}')
    if buckets is None:
        ladder, b = [], 1
        while b < max_batch_size:
            ladder.append(b)
            b *= 2
        ladder.append(max_batch_size)
        return ladder
    ladder = [int(b) for b in buckets]
    if not ladder or sorted(set(ladder)) != ladder:
        raise ValueError(f'buckets must be strictly increasing, got {buckets}')
    if ladder[0] < 1 or ladder[-1] != max_batch_size:
        raise ValueError(
            f'buckets must start >= 1 and end at max_batch_size='
            f'{max_batch_size}, got {buckets}')
    return ladder


class InferenceEngine:
    """Bucketed-batch wrapper around a saved inference model.

    ``config_or_dir``: a model directory or :class:`inference.Config` (so the
    bf16 feed path works unchanged). The model loads into a private Scope
    through the Predictor, on ``executor``'s device: the card by default,
    ``Executor(CPUPlace())`` for the CPU.
    """

    def __init__(self, config_or_dir, executor=None, max_batch_size=None,
                 buckets=None):
        self.max_batch_size = int(max_batch_size or DEFAULT_MAX_BATCH)
        self.buckets = bucket_ladder(self.max_batch_size, buckets)
        self._predictor = Predictor(config_or_dir, executor)
        self.config = self._predictor.config
        self.program = self._predictor.program
        self.feed_names = list(self._predictor.feed_names)
        self.fetch_vars = self._predictor.fetch_vars
        self._exe = self._predictor._exe
        self._scope = self._predictor._scope
        self._lock = threading.Lock()
        self._compiled_buckets = set()
        block = self.program.global_block()
        # {feed name: (per-row tail shape with None for free dims, np.dtype)}
        self.input_spec = {}
        for name in self.feed_names:
            v = block.var(name)
            tail = tuple(None if d == -1 else int(d) for d in v.shape[1:])
            self.input_spec[name] = (tail, np.dtype(v.dtype))
        # {feed name: (vocab, table name)} for feeds that index an
        # embedding table directly: validate() rejects an out-of-range id
        # at the door unless PADDLE_TPU_EMBED_OOB=clip
        self.id_bounds = {}
        for op in block.ops:
            if op.type not in ('lookup_table', 'fused_embedding_seq_pool'):
                continue
            ids = (op.inputs.get('ids') or [None])[0]
            w = (op.inputs.get('w') or [None])[0]
            if ids in self.input_spec and w and block.has_var(w):
                shape = block.var(w).shape or ()
                if shape and isinstance(shape[0], int) and shape[0] > 0:
                    self.id_bounds[ids] = (int(shape[0]), w)

    @property
    def device(self):
        return self._exe.device

    # -- request validation (BEFORE enqueue — batcher.py calls this) -------
    def validate(self, inputs):
        """Normalize ``inputs`` (dict name→array, or list in feed order) to
        ``(feed dict of np arrays with a leading batch dim, nrows)``.
        Raises :class:`InvalidRequest` on anything that could fail inside
        the step, so one bad request can never poison a batch."""
        if isinstance(inputs, (list, tuple)):
            if len(inputs) != len(self.feed_names):
                raise InvalidRequest(
                    f'expected {len(self.feed_names)} inputs '
                    f'{self.feed_names}, got {len(inputs)}')
            inputs = dict(zip(self.feed_names, inputs))
        if not isinstance(inputs, dict):
            raise InvalidRequest(
                f'inputs must be a dict or list, got {type(inputs).__name__}')
        missing = set(self.feed_names) - set(inputs)
        extra = set(inputs) - set(self.feed_names)
        if missing or extra:
            raise InvalidRequest(
                f'feed-name mismatch: missing {sorted(missing)}, '
                f'unknown {sorted(extra)} (expected {self.feed_names})')
        feed, nrows = {}, None
        for name in self.feed_names:
            tail, dtype = self.input_spec[name]
            try:
                arr = np.asarray(inputs[name])
            except Exception as e:
                raise InvalidRequest(f"input '{name}' is not array-like: {e}")
            if arr.dtype == object:
                raise InvalidRequest(
                    f"input '{name}' is not numeric (object array)")
            if arr.ndim != len(tail) + 1:
                raise InvalidRequest(
                    f"input '{name}' must have rank {len(tail) + 1} "
                    f"(batch dim + per-row shape {tail}), got shape "
                    f"{arr.shape}")
            for i, (want, have) in enumerate(zip(tail, arr.shape[1:])):
                if want is not None and want != have:
                    raise InvalidRequest(
                        f"input '{name}' dim {i + 1} must be {want}, got "
                        f"{have} (shape {arr.shape})")
            try:
                arr = arr.astype(dtype, copy=False)
            except (TypeError, ValueError) as e:
                raise InvalidRequest(
                    f"input '{name}' does not cast to {dtype}: {e}")
            if dtype == np.int64 and arr.size and (
                    arr.max(initial=0) > _INT32_MAX
                    or arr.min(initial=0) < _INT32_MIN):
                raise InvalidRequest(
                    f"int64 feed {name!r} holds values outside int32 range "
                    f"[{_INT32_MIN}, {_INT32_MAX}]; serving keeps the "
                    f"reference's int32 id contract")
            if name in self.id_bounds and arr.size:
                vocab, table = self.id_bounds[name]
                if oob_policy() == 'error' \
                        and (arr.min() < 0 or arr.max() >= vocab):
                    raise InvalidRequest(
                        f"input '{name}' holds ids outside [0, {vocab}) "
                        f"for embedding table '{table}' (min {arr.min()}, "
                        f"max {arr.max()}); on device they would silently "
                        f"clip to row {vocab - 1}. Set "
                        f"PADDLE_TPU_EMBED_OOB=clip for the legacy "
                        f"clipping behavior.")
            if nrows is None:
                nrows = arr.shape[0]
            elif arr.shape[0] != nrows:
                raise InvalidRequest(
                    f"inconsistent batch dims: '{name}' has {arr.shape[0]} "
                    f'rows, earlier inputs have {nrows}')
            feed[name] = arr
        if nrows == 0:
            raise InvalidRequest('empty request (0 rows)')
        if nrows > self.max_batch_size:
            raise InvalidRequest(
                f'request has {nrows} rows > max_batch_size='
                f'{self.max_batch_size}; split it client-side')
        return feed, nrows

    def bucket_for(self, nrows):
        """Smallest ladder rung that fits ``nrows``."""
        for b in self.buckets:
            if nrows <= b:
                return b
        raise InvalidRequest(
            f'{nrows} rows exceed the top bucket {self.buckets[-1]}')

    # -- execution ---------------------------------------------------------
    def run_batch(self, feed, nrows=None):
        """Run one coalesced batch: pad the batch dim up to the bucket, one
        executor run, slice the padding back off. ``feed``: validated dict
        of np arrays sharing a leading batch dim. Returns a list of np
        arrays (fetch order), each with ``nrows`` rows. The fetch copies
        the outputs to the host, so the timing it records is the device's
        too."""
        if nrows is None:
            nrows = next(iter(feed.values())).shape[0]
        bucket = self.bucket_for(nrows)
        pad = bucket - nrows
        if pad:
            # replicate the last real row: keeps pad lanes on-distribution
            # (an all-zeros row can hit log(0)/0-division in real models)
            feed = {n: np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                    for n, a in feed.items()}
        if self.config.precision == 'bfloat16':
            feed = {k: self._predictor._to_bf16(v) for k, v in feed.items()}
        with self._lock:
            first = bucket not in self._compiled_buckets
            t0 = time.perf_counter()
            outs = self._exe.run(self.program, feed=feed,
                                 fetch_list=self.fetch_vars,
                                 scope=self._scope)
            dt = time.perf_counter() - t0
            if first:
                self._compiled_buckets.add(bucket)
                _m.bucket_compiled.labels(bucket=bucket).set(1)
                _m.bucket_compile_seconds.labels(bucket=bucket).set(dt)
        _m.bucket_runs.labels(bucket=bucket).inc()
        _m.compute_seconds.labels(bucket=bucket).observe(dt)
        _m.batch_rows.observe(nrows)
        _m.padding_waste_ratio.observe(pad / bucket)
        return [np.asarray(o)[:nrows] for o in outs]

    def infer(self, inputs):
        """Validate + run one request directly (no batcher). The convenience
        path for scripts; servers go through :class:`batcher.MicroBatcher`."""
        feed, nrows = self.validate(inputs)
        return self.run_batch(feed, nrows)

    def warmup(self, example=None):
        """Run every bucket once before traffic arrives. ``example``: a
        one-row feed dict to tile (required when an input has free non-batch
        dims — the engine cannot invent those sizes). Returns
        {bucket: first-run seconds}; re-running is cheap (the plans are
        cached)."""
        if example is not None:
            row, _ = self.validate(example)
            row = {n: a[:1] for n, a in row.items()}
        else:
            row = {}
            for name, (tail, dtype) in self.input_spec.items():
                if any(d is None for d in tail):
                    raise ValueError(
                        f"input '{name}' has free dims {tail}; pass "
                        f'warmup(example={{...}}) with a representative row')
                row[name] = np.zeros((1,) + tail, dtype)
        timings = {}
        for bucket in self.buckets:
            feed = {n: np.repeat(a, bucket, axis=0) for n, a in row.items()}
            t0 = time.perf_counter()
            self.run_batch(feed, nrows=bucket)
            timings[bucket] = time.perf_counter() - t0
        return timings

    @property
    def compiled_buckets(self):
        return sorted(self._compiled_buckets)

    @property
    def warmed(self):
        """True once every ladder rung has run (warmup or traffic) —
        surfaced through /healthz for the serving-tier router's cold-replica
        gate."""
        return all(b in self._compiled_buckets for b in self.buckets)

    def get_input_names(self):
        return list(self.feed_names)

    def get_output_names(self):
        return [v.name if hasattr(v, 'name') else v for v in self.fetch_vars]
