"""Dynamic micro-batcher: coalesce concurrent requests into bucketed batches
(counterpart of paddle_tpu/serving/batcher.py).

The throughput problem with per-request dispatch is fixed cost: one
device call costs roughly the same whether it carries 1 row or 16, so a
server that dispatches per request wastes most of the card. The batcher
turns N concurrent small requests into one bucketed device call:

    submit() ─ validate ─▶ bounded queue ─▶ worker thread ─▶ engine.run_batch
                 │              │               │ coalesce ≤ max_batch rows
          InvalidRequest    Overloaded          │ or wait ≤ batch_timeout_ms
          (never enqueued)  (queue full)        ▼
                                          per-request futures

Robustness invariants, each held against the JAX package's batcher by
tests/test_torch_batcher.py:

- **validation before enqueue**: a malformed request raises at submit() and
  never reaches a batch — co-batched requests cannot be poisoned;
- **bounded queue**: a full queue raises the typed ``Overloaded`` instead of
  growing latency without bound (backpressure, not buffering);
- **per-request deadlines**: a request whose deadline expires while queued
  is dropped (``DeadlineExceeded``) before it wastes device time;
- **failure isolation**: an engine error fails exactly the requests in that
  batch — the worker survives and keeps serving;
- **circuit breaker** (breaker.py): `breaker_failures` CONSECUTIVE
  engine-failure batches trip the breaker — queued requests fail
  immediately and new ones are rejected in O(µs) with the typed
  ``EngineUnhealthy`` instead of waiting out their deadlines against a
  broken engine; after the cooldown a half-open probe batch re-admits
  traffic once the engine answers again (no restart);
- **graceful shutdown**: ``close(drain=True)`` stops admission, drains every
  queued request, then joins the worker. ``drain=False`` fails the queue
  fast with ``EngineClosed``.
"""
from __future__ import annotations

import collections
import os
import threading
import time

import numpy as np

from . import metrics as _m
from .breaker import CircuitBreaker
from .errors import (DeadlineExceeded, EngineClosed, EngineUnhealthy,
                     Overloaded, ServingError)

__all__ = ['MicroBatcher', 'PredictionFuture', 'DEFAULT_BATCH_TIMEOUT_MS',
           'DEFAULT_QUEUE_DEPTH']

DEFAULT_BATCH_TIMEOUT_MS = float(
    os.environ.get('PADDLE_TPU_SERVING_TIMEOUT_MS', '2'))
DEFAULT_QUEUE_DEPTH = int(
    os.environ.get('PADDLE_TPU_SERVING_QUEUE_DEPTH', '128'))


class PredictionFuture:
    """Completion handle for one submitted request."""

    def __init__(self):
        self._done = threading.Event()
        self._value = None
        self._exc = None
        self._callbacks = []
        self._cb_lock = threading.Lock()

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """Block for the outcome. Raises the request's failure
        (DeadlineExceeded / EngineClosed / ServingError) or TimeoutError if
        the outcome itself does not arrive within ``timeout`` seconds."""
        if not self._done.wait(timeout):
            raise TimeoutError('prediction not completed in time')
        if self._exc is not None:
            raise self._exc
        return self._value

    def add_done_callback(self, fn):
        """``fn(future)`` runs when the outcome lands — on the completing
        (batcher worker) thread, or immediately on the caller if already
        done. Open-loop load generators use this to timestamp completions
        without a waiter thread per in-flight request. Keep callbacks
        cheap: they
        run on the serving hot path. Callback exceptions are swallowed."""
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    def _run_callback(self, fn):
        try:
            fn(self)
        except Exception:
            pass                     # a bench/observer bug must not poison
                                     # the batch that completed this future

    # -- batcher-side completion (exactly once) ---------------------------
    def _finish(self):
        with self._cb_lock:
            self._done.set()
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            self._run_callback(fn)

    def _set_result(self, value):
        self._value = value
        self._finish()

    def _set_exception(self, exc):
        self._exc = exc
        self._finish()


class _Request:
    __slots__ = ('feed', 'nrows', 'future', 'enqueued_at', 'deadline')

    def __init__(self, feed, nrows, deadline):
        self.feed = feed
        self.nrows = nrows
        self.future = PredictionFuture()
        self.enqueued_at = time.monotonic()
        self.deadline = deadline            # absolute monotonic, or None

    def expired(self, now):
        return self.deadline is not None and now > self.deadline


class MicroBatcher:
    """Bounded-queue micro-batcher in front of an :class:`InferenceEngine`
    (or anything duck-typed with validate / run_batch / max_batch_size).

    - ``max_batch_size``: row budget per device call (default: engine's).
    - ``batch_timeout_ms``: how long a non-full batch waits for company.
      0 disables coalescing-by-time (batch = whatever is already queued).
    - ``queue_depth``: admission bound, in requests. Full → ``Overloaded``.
    - ``default_timeout_ms``: per-request deadline applied when submit()
      gets none. None = requests wait forever.
    """

    def __init__(self, engine, max_batch_size=None,
                 batch_timeout_ms=DEFAULT_BATCH_TIMEOUT_MS,
                 queue_depth=DEFAULT_QUEUE_DEPTH, default_timeout_ms=None,
                 breaker_failures=None, breaker_reset_s=None, start=True):
        self.engine = engine
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_failures, reset_after_s=breaker_reset_s,
            metrics=_m.PREDICT_BREAKER_METRICS, name='predict engine')
        engine_max = int(getattr(engine, 'max_batch_size', 0) or 0)
        self.max_batch_size = int(max_batch_size or engine_max or 16)
        if engine_max:
            # never coalesce more rows than the engine's top bucket holds —
            # such a batch could only fail wholesale at bucket_for()
            self.max_batch_size = min(self.max_batch_size, engine_max)
        self.batch_timeout = float(batch_timeout_ms) / 1e3
        self.queue_depth = int(queue_depth)
        self.default_timeout_ms = default_timeout_ms
        self._queue = collections.deque()
        self._carry = None                   # dequeued but didn't fit
        self._cv = threading.Condition()
        self._closing = False
        self._closed = False
        self._drain = True
        self._worker = threading.Thread(target=self._worker_loop,
                                        name='paddle-tpu-torch-batcher',
                                        daemon=True)
        if start:
            self._worker.start()

    # -- client side -------------------------------------------------------
    def submit(self, inputs, timeout_ms=None):
        """Validate and enqueue one request; returns a
        :class:`PredictionFuture`. Raises InvalidRequest (bad request, not
        enqueued), Overloaded (queue full, not enqueued), EngineUnhealthy
        (circuit breaker open — reject BEFORE validation so clients fail
        over in O(µs) regardless of payload size), or EngineClosed
        (shutdown begun)."""
        if not self.breaker.allow():
            raise EngineUnhealthy('predict engine',
                                  self.breaker.consecutive_failures)
        try:
            feed, nrows = self.engine.validate(inputs)
        except Exception:
            _m.requests_rejected_invalid.inc()
            raise
        if timeout_ms is None:
            timeout_ms = self.default_timeout_ms
        deadline = None if timeout_ms is None \
            else time.monotonic() + float(timeout_ms) / 1e3
        req = _Request(feed, nrows, deadline)
        with self._cv:
            if self._closing:
                raise EngineClosed('serving engine is shutting down')
            if len(self._queue) >= self.queue_depth:
                _m.requests_rejected_overload.inc()
                raise Overloaded(len(self._queue))
            self._queue.append(req)
            _m.requests_accepted.inc()
            _m.queue_depth.set(len(self._queue))
            self._cv.notify()
        return req.future

    def predict(self, inputs, timeout_ms=None):
        """Synchronous convenience: submit + wait. The wait is bounded by the
        request deadline (plus compute slack) when one is set."""
        fut = self.submit(inputs, timeout_ms)
        ms = timeout_ms if timeout_ms is not None else self.default_timeout_ms
        wait = None if ms is None else float(ms) / 1e3 + 60.0
        return fut.result(wait)

    def pending(self):
        with self._cv:
            return len(self._queue) + (1 if self._carry is not None else 0)

    # -- worker side -------------------------------------------------------
    def _take_first(self):
        """Block for the request that opens the next batch; None = shut
        down. The carry-over (dequeued last round but over the row budget)
        goes first — FIFO is preserved."""
        with self._cv:
            while True:
                if self._carry is not None:
                    req, self._carry = self._carry, None
                    return req
                if self._queue:
                    req = self._queue.popleft()
                    _m.queue_depth.set(len(self._queue))
                    return req
                if self._closing:
                    return None
                self._cv.wait(timeout=0.1)

    def _fill_batch(self, first):
        """Coalesce: after ``first``, keep taking requests until the row
        budget fills or the batch window closes."""
        batch, rows = [first], first.nrows
        window_ends = time.monotonic() + self.batch_timeout
        while rows < self.max_batch_size:
            with self._cv:
                if not self._queue:
                    if self._closing:
                        break               # draining: never wait for more
                    remaining = window_ends - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                    if not self._queue:
                        continue
                if self._queue[0].nrows + rows > self.max_batch_size:
                    # would overflow: hold it as the opener of the next batch
                    self._carry = self._queue.popleft()
                    _m.queue_depth.set(len(self._queue))
                    break
                req = self._queue.popleft()
                _m.queue_depth.set(len(self._queue))
            batch.append(req)
            rows += req.nrows
        return batch

    def _execute(self, batch):
        now = time.monotonic()
        live = []
        for req in batch:
            if req.expired(now):
                _m.requests_deadline_missed.inc()
                req.future._set_exception(DeadlineExceeded(
                    'deadline expired after '
                    f'{now - req.enqueued_at:.3f}s in queue'))
            else:
                live.append(req)
        if not live:
            return
        for req in live:
            _m.queue_wait_seconds.observe(now - req.enqueued_at)
        nrows = sum(r.nrows for r in live)
        feed = {name: np.concatenate([r.feed[name] for r in live])
                for name in live[0].feed}
        try:
            outs = self.engine.run_batch(feed, nrows)
        except Exception as e:
            # engine failure poisons exactly this batch; the worker survives
            _m.requests_failed.inc(len(live))
            err = e if isinstance(e, ServingError) else ServingError(
                f'inference failed: {type(e).__name__}: {e}')
            for req in live:
                req.future._set_exception(err)
            if self.breaker.record_failure():
                # just tripped: everything still queued would only wait out
                # its deadline against a broken engine — fail it all NOW
                self._fail_queued(EngineUnhealthy(
                    'predict engine', self.breaker.consecutive_failures))
            return
        self.breaker.record_success()
        off = 0
        for req in live:
            req.future._set_result([o[off:off + req.nrows] for o in outs])
            off += req.nrows
        _m.requests_completed.inc(len(live))

    def _fail_queued(self, exc):
        """Fail every queued (and carried-over) request with `exc`."""
        with self._cv:
            failed = 0
            if self._carry is not None:
                self._carry.future._set_exception(exc)
                self._carry = None
                failed += 1
            while self._queue:
                self._queue.popleft().future._set_exception(exc)
                failed += 1
            _m.queue_depth.set(0)
        if failed:
            _m.requests_failed.inc(failed)

    def _worker_loop(self):
        while True:
            first = self._take_first()
            if first is None:
                break
            self._execute(self._fill_batch(first))

    # -- lifecycle ---------------------------------------------------------
    def close(self, drain=True, timeout=None):
        """Stop admission, then either drain queued requests (default) or
        fail them fast with EngineClosed. Idempotent; joins the worker.
        A later ``close(drain=False)`` while a drain is still running
        ESCALATES it: remaining queued requests fail fast (the SIGTERM
        drain-timeout path in server.py)."""
        with self._cv:
            self._closing = True
            if not drain:
                while self._queue:
                    req = self._queue.popleft()
                    req.future._set_exception(
                        EngineClosed('serving engine shut down before '
                                     'this request ran'))
                _m.queue_depth.set(0)
            self._cv.notify_all()
        if self._worker.is_alive():
            self._worker.join(timeout)
        self._closed = True

    @property
    def closed(self):
        return self._closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
