"""Slot-based continuous-batching scheduler + per-request token streams
(counterpart of paddle_tpu/serving/decode/scheduler.py).

The scheduling model is S fixed decode slots stepped in lockstep:

    submit() - validate -> bounded waiting queue -> worker loop, per step:
                  |               |                  1. expire deadlines
           InvalidRequest     Overloaded             2. admit waiting ->
           (never queued)    (queue full)               free slots (prefill)
                                                     3. ONE decode step,
                                                        all S slots
                                                     4. emit tokens, free
                                                        finished slots
                                                     v
                                         per-request GenerationStream

Admission is continuous: waiting requests enter freed slots every step, so
the batch never drains.

Admission takes the request's full block reservation (prompt + token budget)
up front, so a generation never dies of OutOfBlocks mid-flight; when the
pool cannot cover the next waiting request the scheduler keeps stepping
until a finishing slot frees blocks (FIFO, no starvation).

Deadlines bound WAITING only: once a request holds a slot it runs to
completion.

With speculative decoding on (``engine.spec_enabled``) step 3 is one (S, k)
verify round: each greedy slot feeds its pending token and up to k - 1
drafter guesses, and emits the longest prefix the model agrees with.

With the engine's prefix cache, a hit's admission takes the shared blocks
and its uncached suffix is fed through step 3 (one prompt token a
lockstep step, up to k a verify round) before its first token; the filled
prompt is published. With ``disagg=`` (a ``LocalPrefillWorker``) a greedy
miss is handed to the prefill engine instead of prefilled inline: its slot
waits, inactive, while the step goes on, and the returned blocks are
injected between steps. Sampled requests prefill inline, as in the
reference (the handoff carries a greedy first token, not logits).

Metrics, recorded always at the reference's sites: the ``decode_*`` and
``decode_spec_*`` families of serving/metrics.py and the ``queue_depth``,
``tokens`` and ``ttft`` windowed series. A request submitted with a
sampled ``TraceContext`` (the ``X-PaddleTPU-Trace`` header) records its
``replica/queue_wait``, ``replica/prefill``, ``replica/handoff_wait``,
``replica/token`` and ``replica/verify_round`` spans under it.
"""
from __future__ import annotations

import collections
import logging
import os
import queue
import threading
import time
import uuid

from .. import metrics as _m
from ..breaker import CircuitBreaker
from ..errors import (DeadlineExceeded, EngineClosed, EngineUnhealthy,
                      InvalidRequest, Overloaded, OutOfBlocks, ServingError)
from ..tier.knobs import ENV_SPEC_DRAFTER, parse_choice_env
from ...observability import distributed as _dobs
from .drafter import DRAFTER_CHOICES, build_drafter
from .sampling import SamplingParams, TokenSampler

__all__ = ['DecodeScheduler', 'GenerationStream', 'DEFAULT_QUEUE_DEPTH']

_logger = logging.getLogger(__name__)

DEFAULT_QUEUE_DEPTH = 128

_END = object()


class GenerationStream:
    """Per-request handle: iterate tokens as they decode, or block for the
    full result.

        for tok in stream:            # per-token streaming
            ...
        toks = stream.result(30)      # or: block until done

    ``finish_reason``: 'stop' (eos) | 'length' (budget) | None while
    running. Failures (engine error, deadline, shutdown) raise from both
    the iterator and ``result()``. ``meta`` carries the ``request_id``
    (client-pinned or random; for sampled requests also the stream seed)
    and the ``replica_id`` of the serving process, and for a request with a
    sampled trace its ``trace_id``."""

    def __init__(self, prompt_len, max_new_tokens, replica_id=None,
                 request_id=None, trace_id=None):
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.replica_id = replica_id
        self.request_id = request_id or uuid.uuid4().hex[:16]
        self.trace_id = trace_id
        self._q = queue.Queue()
        self._tokens = []
        self._done = threading.Event()
        self._exc = None
        self.finish_reason = None

    @property
    def meta(self):
        meta = {'request_id': self.request_id, 'replica_id': self.replica_id}
        if self.trace_id is not None:
            meta['trace_id'] = self.trace_id
        return meta

    # -- consumer side -----------------------------------------------------
    def __iter__(self):
        return self.iter_tokens()

    def iter_tokens(self, timeout=None):
        """Yield token ids as they decode. ``timeout`` bounds the wait for
        EACH token (TimeoutError), so a stuck stream cannot pin a
        connection thread forever."""
        while True:
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f'no token within {timeout}s (generated '
                    f'{len(self._tokens)} so far)')
            if item is _END:
                if self._exc is not None:
                    raise self._exc
                return
            yield item

    def result(self, timeout=None):
        """All generated token ids; raises the request's failure."""
        if not self._done.wait(timeout):
            raise TimeoutError('generation not completed in time')
        if self._exc is not None:
            raise self._exc
        return list(self._tokens)

    def done(self):
        return self._done.is_set()

    @property
    def tokens(self):
        """Snapshot of tokens emitted so far."""
        return list(self._tokens)

    # -- scheduler side ----------------------------------------------------
    def _emit(self, token):
        self._tokens.append(int(token))
        self._q.put(int(token))

    def _finish(self, reason):
        self.finish_reason = reason
        self._done.set()
        self._q.put(_END)

    def _fail(self, exc):
        self._exc = exc
        self._done.set()
        self._q.put(_END)


class _Request:
    __slots__ = ('prompt', 'max_new_tokens', 'eos_id', 'stream', 'deadline',
                 'enqueued_at', 'table', 'next_token', 'generated',
                 'sampling', 'sampler', 'history', 'pending_prompt',
                 'prefilling', 'handoff_pending', 'trace', 'enqueued_perf',
                 'handoff_t0')

    def __init__(self, prompt, max_new_tokens, eos_id, deadline,
                 replica_id=None, sampling=None, request_id=None,
                 trace=None):
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        # distributed trace carrier (observability.TraceContext or None):
        # spans recorded here parent under the router's dispatch span
        self.trace = trace if (trace is not None and trace.sampled) else None
        self.stream = GenerationStream(
            len(prompt), max_new_tokens, replica_id=replica_id,
            request_id=request_id,
            trace_id=self.trace.trace_id if self.trace else None)
        self.deadline = deadline
        self.enqueued_at = time.monotonic()
        self.enqueued_perf = time.perf_counter()
        self.handoff_t0 = None
        self.table = None
        self.next_token = None        # picked but not yet cached
        self.generated = 0
        # sampler is None on the greedy path (exact argmax); sampled draws
        # are keyed off the stream's request_id, so they replay
        self.sampling = sampling or SamplingParams()
        self.sampler = (None if self.sampling.greedy else
                        TokenSampler(self.sampling, self.stream.request_id))
        # prompt + emitted tokens: what the drafter continues (its last
        # element is the pending, uncached token)
        self.history = list(prompt)
        # a prefix-cache hit's suffix fill: the prompt tokens still to feed
        # through the step; while prefilling, the step's rows are not
        # emitted (the next fed token is the prompt's)
        self.pending_prompt = None
        self.prefilling = False
        # disaggregated: admitted, blocks reserved, waiting for the prefill
        # engine's payload; an inactive lane of the step until then
        self.handoff_pending = False

    def expired(self, now):
        return self.deadline is not None and now > self.deadline


class DecodeScheduler:
    """Continuous-batching front end over a :class:`DecodeEngine`.

    - ``queue_depth``: waiting-queue bound -> typed ``Overloaded``.
    - ``start``: start the worker thread now (False leaves it stopped).
    - ``drafter``: with speculative decoding on, a name ('ngram',
      'draft_model', 'off'), an object with ``propose(history, n)``, or
      None for the ``PADDLE_TPU_SPEC_DRAFTER`` knob (default 'ngram');
      unused otherwise.
    - ``disagg``: a handoff transport (``submit`` / ``drain_completed``,
      tier/disagg.py's ``LocalPrefillWorker``) that prefills greedy cache
      misses on another engine, or None to prefill inline.
    """

    def __init__(self, engine, queue_depth=DEFAULT_QUEUE_DEPTH, start=True,
                 replica_id=None, disagg=None, drafter=None):
        self.disagg = disagg
        self.drafter = None
        if engine.spec_enabled:
            if drafter is None:
                drafter = parse_choice_env(ENV_SPEC_DRAFTER, DRAFTER_CHOICES,
                                           'ngram')
            self.drafter = build_drafter(drafter, engine.padded_context,
                                         device=engine.device)
        self.engine = engine
        self.replica_id = (replica_id
                           or os.environ.get('PADDLE_TPU_REPLICA_ID')
                           or f'replica-{os.getpid()}')
        # consecutive engine failures (prefill or lockstep step) trip the
        # breaker: waiting requests fail fast with EngineUnhealthy and
        # /healthz reports degraded until a half-open probe succeeds
        self.breaker = CircuitBreaker(metrics=_m.DECODE_BREAKER_METRICS,
                                      name='decode engine')
        self.queue_depth = int(queue_depth)
        # lifetime draft totals behind the decode_spec_acceptance gauge
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._waiting = collections.deque()
        self._slots = [None] * engine.slots      # _Request | None
        self._cv = threading.Condition()
        self._closing = False
        self._abort = False
        self._closed = False
        self._worker = threading.Thread(target=self._worker_loop,
                                        name='paddle-tpu-torch-decode',
                                        daemon=True)
        if start:
            self._worker.start()

    # -- client side -------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=16, eos_id=None,
               timeout_ms=None, sampling=None, request_id=None, trace=None):
        """Validate and enqueue one generation; returns its
        :class:`GenerationStream`. Raises InvalidRequest / Overloaded /
        EngineUnhealthy (breaker open) / EngineClosed (all pre-enqueue).

        ``sampling``: None (greedy) | dict | SamplingParams, validated here.
        ``request_id``: optional client-pinned id; for sampled requests it
        seeds the stream, so resubmitting the same id + params replays the
        same token sequence. ``trace``: an optional
        :class:`observability.TraceContext` from the HTTP front end; this
        generation's spans are recorded under it."""
        if not self.breaker.allow():
            raise EngineUnhealthy('decode engine',
                                  self.breaker.consecutive_failures)
        try:
            prompt, max_new = self.engine.validate(prompt_ids,
                                                   max_new_tokens)
            params = SamplingParams.validate(sampling)
            if request_id is not None:
                request_id = str(request_id)
                if not 0 < len(request_id) <= 128 or any(
                        c in request_id for c in '\r\n'):
                    raise InvalidRequest(
                        'request_id must be 1-128 characters with no '
                        'newlines')
            if timeout_ms is not None and (
                    isinstance(timeout_ms, bool)
                    or not isinstance(timeout_ms, (int, float))):
                raise InvalidRequest(f'timeout_ms must be a number, got '
                                     f'{timeout_ms!r}')
        except Exception:
            _m.decode_requests_rejected_invalid.inc()
            raise
        deadline = None if timeout_ms is None \
            else time.monotonic() + float(timeout_ms) / 1e3
        req = _Request(prompt, max_new,
                       self.engine.eos_id if eos_id is None else eos_id,
                       deadline, replica_id=self.replica_id,
                       sampling=params, request_id=request_id, trace=trace)
        if req.trace is not None:
            _m.trace_requests_sampled.inc()
        with self._cv:
            if self._closing:
                raise EngineClosed('decode scheduler is shutting down')
            if len(self._waiting) >= self.queue_depth:
                _m.decode_requests_rejected_overload.inc()
                raise Overloaded(len(self._waiting))
            self._waiting.append(req)
            _m.decode_requests_accepted.inc()
            _m.decode_queue_depth.set(len(self._waiting))
            _dobs.series('queue_depth').observe(len(self._waiting))
            self._cv.notify()
        return req.stream

    def generate(self, prompt_ids, max_new_tokens=16, eos_id=None,
                 timeout_ms=None, result_timeout=120.0):
        """Synchronous convenience: submit + wait for the full token list."""
        return self.submit(prompt_ids, max_new_tokens, eos_id,
                           timeout_ms).result(result_timeout)

    def pending(self):
        with self._cv:
            return len(self._waiting)

    def active(self):
        with self._cv:
            return sum(r is not None for r in self._slots)

    # -- worker side -------------------------------------------------------
    def _expire_waiting(self, now):
        kept = collections.deque()
        for req in self._waiting:
            if req.expired(now):
                _m.decode_requests_deadline_missed.inc()
                req.stream._fail(DeadlineExceeded(
                    f'deadline expired after {now - req.enqueued_at:.3f}s '
                    f'waiting for a decode slot'))
            else:
                kept.append(req)
        self._waiting = kept
        _m.decode_queue_depth.set(len(self._waiting))

    def _admit_locked(self):
        """Move waiting requests into free slots (FIFO; stops at the first
        one the pool cannot cover). Returns the admitted requests; their
        prefill runs OUTSIDE the lock."""
        admitted = []
        for i, slot in enumerate(self._slots):
            if slot is not None or not self._waiting:
                continue
            req = self._waiting[0]
            try:
                req.table = self.engine.reserve_table(
                    len(req.prompt), req.max_new_tokens, prompt=req.prompt)
            except OutOfBlocks:
                break                 # FIFO: wait for blocks, don't skip
            self._waiting.popleft()
            self._slots[i] = req
            admitted.append(req)
        _m.decode_queue_depth.set(len(self._waiting))
        return admitted

    def _publish(self, req):
        """Publish the request's fully cached prompt into the engine's
        prefix cache (a no-op without one)."""
        self.engine.publish_prefix(req.prompt, req.table)

    def _trace_span(self, req, name, start_perf, end_perf, **args):
        """Record one replica-side span of a traced request (no-op when the
        request carries no sampled trace: one None check)."""
        if req.trace is None:
            return
        _m.trace_spans_recorded.inc()
        _dobs.record_span(req.trace.child(), name, start_perf, end_perf,
                          request_id=req.stream.request_id,
                          replica_id=self.replica_id, **args)

    def _prefill(self, req):
        self._trace_span(req, 'replica/queue_wait', req.enqueued_perf,
                         time.perf_counter())
        cached = req.table.cached_len
        if cached:
            # a prefix-cache hit: the table's front is shared filled blocks;
            # the suffix rides the step like every slot's generation
            req.table.context_len = cached
            req.next_token = req.prompt[cached]
            req.pending_prompt = collections.deque(req.prompt[cached + 1:])
            req.prefilling = True
            return
        if self.disagg is not None and req.sampler is None:
            # a miss under disaggregation: the prefill engine runs it; the
            # slot waits, inactive, while the step goes on
            req.handoff_pending = True
            req.handoff_t0 = time.perf_counter()
            self.disagg.submit(req, req.prompt, req.max_new_tokens)
            return
        t0 = time.perf_counter()
        try:
            if req.sampler is None:
                first = self.engine.prefill(req.prompt, req.table)
            else:
                first = self.engine.prefill(
                    req.prompt, req.table,
                    sampler=lambda row: self._pick_token(req, row))
        except Exception as e:     # engine failure: fail this request only
            _logger.exception('prefill failed')
            self._fail_request(req, e)
            self._record_engine_failure()
            return
        self._trace_span(req, 'replica/prefill', t0, time.perf_counter(),
                         prompt_len=len(req.prompt))
        self.breaker.record_success()
        self._publish(req)
        self._emit_token(req, first)

    def _drain_handoffs(self, timeout=0.0):
        """Apply finished handoffs: inject the payload into the decode pool
        (on this worker thread, the engine's one owner), publish the prompt
        and emit the first token. A failed handoff fails its request only;
        payloads of requests failed or closed meanwhile are dropped."""
        if self.disagg is None:
            return
        for req, payload, exc in self.disagg.drain_completed(timeout):
            if req not in self._slots or req.table is None:
                continue              # failed or closed while in flight
            req.handoff_pending = False
            if exc is not None:
                self._fail_request(req, exc)
                self._record_engine_failure()
                continue
            try:
                first = self.engine.inject_prefill(req.table, payload)
            except Exception as e:
                _logger.exception('handoff injection failed')
                self._fail_request(req, e)
                self._record_engine_failure()
                continue
            if req.handoff_t0 is not None:
                self._trace_span(req, 'replica/handoff_wait',
                                 req.handoff_t0, time.perf_counter(),
                                 prompt_len=len(req.prompt))
            self.breaker.record_success()
            self._publish(req)
            self._emit_token(req, first)

    def _record_engine_failure(self):
        """Book one engine-failure batch with the breaker; on a trip, fail
        everything still waiting (in-flight slots were already failed)."""
        if not self.breaker.record_failure():
            return
        exc = EngineUnhealthy('decode engine',
                              self.breaker.consecutive_failures)
        with self._cv:
            failed = len(self._waiting)
            while self._waiting:
                self._waiting.popleft().stream._fail(exc)
            _m.decode_queue_depth.set(0)
        if failed:
            _m.decode_requests_failed.inc(failed)

    def _pick_token(self, req, row):
        """Next token from a logits row: the request's deterministic
        sampler (indexed by tokens generated so far) or exact argmax."""
        if req.sampler is not None:
            tok = req.sampler.sample(row, req.generated)
            _m.decode_tokens_sampled.inc()
            return int(tok)
        return int(row.argmax())

    def _emit_token(self, req, token):
        """Account one picked token; retires the request when it hits eos
        or its budget. Otherwise the token is fed to the next decode step
        (its K/V are not cached yet)."""
        req.generated += 1
        req.history.append(int(token))
        req.stream._emit(token)
        _m.decode_tokens_generated.inc()
        _dobs.series('tokens').observe(1.0)
        if req.generated == 1:
            ttft = time.perf_counter() - req.enqueued_perf
            _m.decode_ttft_seconds.observe(ttft)
            _dobs.series('ttft').observe(ttft)
        if req.eos_id is not None and int(token) == int(req.eos_id):
            self._retire(req, 'stop')
        elif req.generated >= req.max_new_tokens:
            self._retire(req, 'length')
        else:
            req.next_token = int(token)

    def _retire(self, req, reason):
        self.engine.release_table(req.table)
        req.table = None
        self._slots[self._slots.index(req)] = None
        req.stream._finish(reason)
        _m.decode_requests_completed.inc()

    def _fail_request(self, req, exc):
        if req.table is not None:
            self.engine.release_table(req.table)
            req.table = None
        if req in self._slots:
            self._slots[self._slots.index(req)] = None
        _m.decode_requests_failed.inc()
        req.stream._fail(exc if isinstance(exc, ServingError)
                         else ServingError(
                             f'generation failed: '
                             f'{type(exc).__name__}: {exc}'))

    def _lanes(self):
        """(live requests, the requests the step feeds): a handoff-pending
        slot is live but an inactive lane."""
        live = [r for r in self._slots if r is not None]
        return live, [r for r in live if not r.handoff_pending]

    def _step(self):
        """One lockstep decode step over the current slots; returns whether
        any slot was live. A suffix-filling slot feeds its next prompt
        token and emits nothing until the prompt is exhausted: the step
        after its last prompt token gives its first generated token."""
        live, active = self._lanes()
        if not active:
            return bool(live)         # only pending handoffs: work remains
        tokens = [r.next_token if r in active else None for r in self._slots]
        tables = [r.table if r in active else None for r in self._slots]
        # rows for every sampled slot that emits this step (a suffix fill
        # emits once its prompt is out)
        need_rows = any(r.sampler is not None
                        and not (r.prefilling and r.pending_prompt)
                        for r in active)
        traced = any(r.trace is not None for r in active)
        t0 = time.perf_counter() if traced else 0.0
        try:
            if need_rows:
                out, rows = self.engine.decode_step(tokens, tables,
                                                    return_rows=True)
            else:
                out = self.engine.decode_step(tokens, tables)
        except Exception as e:     # isolate: fail the batch, keep serving
            _logger.exception('decode step failed')
            for req in active:
                self._fail_request(req, e)
            self._record_engine_failure()
            return True
        t1 = time.perf_counter() if traced else 0.0
        self.breaker.record_success()
        for i, req in enumerate(self._slots):
            if req is None or req.handoff_pending:
                continue
            if req.prefilling:
                if req.pending_prompt:
                    req.next_token = req.pending_prompt.popleft()
                    continue          # still feeding the prompt's suffix
                # the step consumed the last prompt token: the whole
                # prompt is cached, publish it and emit the first token
                req.prefilling = False
                self._publish(req)
            if req.sampler is not None:
                self._emit_token(req, self._pick_token(req, rows[i]))
            else:
                self._emit_token(req, int(out[i]))
            if req.trace is not None:
                self._trace_span(req, 'replica/token', t0, t1,
                                 index=req.generated - 1)
        return True

    def _spec_step(self):
        """One speculative (S, k) verify round; returns whether any slot was
        live.

        A greedy slot feeds its pending token and up to k - 1 drafts, never
        more than its remaining budget; the verify rows confirm drafts in
        order, and the slot emits every confirmed token and the model's own
        at the first miss. The rejected tail rolls back with one store,
        ``table.context_len = base + emitted`` (its K/V positions stay,
        masked until rewritten). A sampled slot feeds one token, so its
        draws are the lockstep stream's. A suffix-filling slot feeds up to
        k prompt tokens a round, all of which stay cached."""
        live, active = self._lanes()
        if not active:
            return bool(live)
        kw = self.engine.spec_k
        fed = [None] * len(self._slots)
        tables = [None] * len(self._slots)
        for i, req in enumerate(self._slots):
            if req not in active:
                continue
            tables[i] = req.table
            if req.prefilling:
                fed[i] = [req.next_token]
                while len(fed[i]) < kw and req.pending_prompt:
                    fed[i].append(req.pending_prompt.popleft())
                continue
            drafts = []
            if req.sampler is None and self.drafter is not None:
                n = min(kw, req.max_new_tokens - req.generated) - 1
                if n > 0:
                    drafts = [int(t) for t in
                              self.drafter.propose(req.history, n)][:n]
            fed[i] = [req.next_token] + drafts
        bases = [t.context_len if t is not None else 0 for t in tables]
        traced = any(r.trace is not None for r in active)
        t0 = time.perf_counter() if traced else 0.0
        try:
            rows = self.engine.spec_step(fed, tables)
        except Exception as e:     # isolate: fail the batch, keep serving
            _logger.exception('verify step failed')
            for req in active:
                self._fail_request(req, e)
            self._record_engine_failure()
            return True
        t1 = time.perf_counter() if traced else 0.0
        self.breaker.record_success()
        stats = self.engine.stats
        for i, req in enumerate(self._slots):
            if req is None or req.handoff_pending:
                continue
            toks = fed[i]
            if req.prefilling:
                if req.pending_prompt:
                    req.next_token = req.pending_prompt.popleft()
                    continue          # every fed prompt token stays cached
                req.prefilling = False
                self._publish(req)
                self._emit_token(req, self._pick_token(req,
                                                       rows[i, len(toks) - 1]))
                continue
            emitted = 0
            for j in range(len(toks)):
                tok = self._pick_token(req, rows[i, j])
                self._emit_token(req, tok)
                emitted += 1
                if (req.table is None or j + 1 == len(toks)
                        or int(toks[j + 1]) != tok):
                    break          # retired, window end or first miss
            if req.table is not None:
                # commit the accepted prefix, roll back the rejected tail
                req.table.context_len = bases[i] + emitted
            drafted = len(toks) - 1
            stats['spec_drafted'] += drafted
            stats['spec_accepted'] += emitted - 1
            self._trace_span(req, 'replica/verify_round', t0, t1,
                             fed=len(toks), emitted=emitted)
            _m.decode_spec_accept_len.observe(emitted)
            if drafted:
                self._spec_drafted += drafted
                self._spec_accepted += emitted - 1
                _m.decode_spec_draft_tokens.inc(drafted)
                if emitted > 1:
                    _m.decode_spec_accepted_tokens.inc(emitted - 1)
                _m.decode_spec_acceptance.set(
                    self._spec_accepted / max(self._spec_drafted, 1))
        return True

    def _fail_all_locked(self):
        """Fail-fast shutdown: error every waiting and in-flight request.
        Runs on the WORKER thread (slot state is worker-owned)."""
        while self._waiting:
            self._waiting.popleft().stream._fail(EngineClosed(
                'decode scheduler shut down before this request ran'))
        _m.decode_queue_depth.set(0)
        for i, req in enumerate(self._slots):
            if req is not None:
                self.engine.release_table(req.table)
                req.table = None
                self._slots[i] = None
                req.stream._fail(EngineClosed(
                    'decode scheduler shut down mid-generation'))
        _m.decode_slots_active.set(0)

    def _worker_loop(self):
        while True:
            with self._cv:
                if self._closing and self._abort:
                    self._fail_all_locked()
                    break
                self._expire_waiting(time.monotonic())
                admitted = self._admit_locked()
            for req in admitted:
                self._prefill(req)
            # finished handoffs join before the step; when only handoffs
            # are in flight, wait briefly on their queue instead of spinning
            live, active = self._lanes()
            self._drain_handoffs(0.01 if live and not active else 0.0)
            stepped = (self._spec_step() if self.engine.spec_enabled
                       else self._step())
            if not stepped and not admitted:
                with self._cv:
                    if self._closing:
                        if self._abort:
                            self._fail_all_locked()
                        if not self._waiting:
                            break
                    else:
                        self._cv.wait(timeout=0.05)

    # -- lifecycle ---------------------------------------------------------
    def close(self, drain=True, timeout=None):
        """Stop admission; ``drain=True`` runs every admitted AND waiting
        generation to completion, ``drain=False`` fails waiting requests
        and in-flight generations fast with EngineClosed."""
        with self._cv:
            first = not self._closing
            self._closing = True
            if first:
                self._abort = not drain
            elif not drain:
                self._abort = True    # escalate a drain to fail-fast
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
