"""Serving metric handles, always on, unlike training telemetry
(counterpart of paddle_tpu/serving/metrics.py: every family under the same
name, help string and histogram bounds).

Training instrumentation guards on ``observability._ENABLED`` because the
eager dispatch path is ~10 µs/op; the serving path runs one device call per
*batch* (ms-scale), so a handful of counter increments per request is noise.
More importantly the HTTP ``/metrics`` endpoint must work out of the box —
an operator scraping a serving box should not need PADDLE_TPU_TELEMETRY=1.
So serving records straight into :data:`observability.registry` and shows up
in both its exports alongside whatever the training-side telemetry collected.

Every handle here is a :class:`_LazyMetric` proxy that re-resolves through
the registry ON EACH USE rather than capturing the metric object at import:
``registry.reset()`` (tests, telemetry teardown) drops all metric objects,
and a captured handle would keep counting into an orphan that no longer
appears in any export. The resolve is one dict lookup — noise at ms-scale.

Metric catalog:

- request lifecycle counters: accepted / rejected_overload / rejected_invalid
  / completed / failed / deadline_missed
- serving_queue_depth gauge (sampled at submit/dequeue)
- serving_queue_wait_seconds / serving_compute_seconds histograms — the
  queue-wait vs compute split is THE batching-knob tuning signal
- serving_batch_rows / serving_padding_waste_ratio histograms — how full the
  coalesced batches are and how much of each padded bucket is thrown away
- per-bucket gauges/counters: serving_bucket_runs (label bucket),
  serving_bucket_compiled, serving_bucket_compile_seconds (warmup/first-use)
"""
from __future__ import annotations

from ..observability import registry

# padding waste is a ratio in [0, 1): linear buckets
_WASTE_BOUNDS = tuple(i / 10.0 for i in range(1, 10))
# batch row counts: powers of two cover any sane bucket ladder
_ROWS_BOUNDS = tuple(float(2 ** i) for i in range(11))


class _LazyMetric:
    """Registry-resolving proxy: same call surface as Counter/Gauge/Histogram
    (inc/set/observe/labels/value), but survives registry.reset()."""

    __slots__ = ('_kind', '_name', '_help', '_bounds')

    def __init__(self, kind, name, help, bounds=None):
        self._kind = kind
        self._name = name
        self._help = help
        self._bounds = bounds

    def _metric(self):
        if self._kind == 'counter':
            return registry.counter(self._name, self._help)
        if self._kind == 'gauge':
            return registry.gauge(self._name, self._help)
        if self._bounds is not None:
            return registry.histogram(self._name, self._help, self._bounds)
        return registry.histogram(self._name, self._help)

    def inc(self, amount=1.0):
        self._metric().inc(amount)

    def set(self, value):
        self._metric().set(value)

    def observe(self, value):
        self._metric().observe(value)

    def labels(self, **labels):
        return self._metric().labels(**labels)

    @property
    def value(self):
        return self._metric().value


requests_accepted = _LazyMetric(
    'counter', 'serving_requests_accepted',
    'requests admitted to the serving queue')
requests_rejected_overload = _LazyMetric(
    'counter', 'serving_requests_rejected_overload',
    'requests rejected by bounded-queue backpressure (Overloaded)')
requests_rejected_invalid = _LazyMetric(
    'counter', 'serving_requests_rejected_invalid',
    'requests rejected by pre-enqueue validation (InvalidRequest)')
requests_completed = _LazyMetric(
    'counter', 'serving_requests_completed',
    'requests answered with results')
requests_failed = _LazyMetric(
    'counter', 'serving_requests_failed',
    'requests failed by an engine/runtime error after admission')
requests_deadline_missed = _LazyMetric(
    'counter', 'serving_requests_deadline_missed',
    'requests dropped because their deadline expired in the queue')

queue_depth = _LazyMetric(
    'gauge', 'serving_queue_depth',
    'requests waiting in the micro-batcher queue')

queue_wait_seconds = _LazyMetric(
    'histogram', 'serving_queue_wait_seconds',
    'enqueue → batch-execution wait per request')
compute_seconds = _LazyMetric(
    'histogram', 'serving_compute_seconds',
    'device call duration per coalesced batch (by padded bucket)')
batch_rows = _LazyMetric(
    'histogram', 'serving_batch_rows',
    'real (unpadded) rows per executed batch', bounds=_ROWS_BOUNDS)
padding_waste_ratio = _LazyMetric(
    'histogram', 'serving_padding_waste_ratio',
    'fraction of the padded bucket that was padding, per executed batch',
    bounds=_WASTE_BOUNDS)

bucket_runs = _LazyMetric(
    'counter', 'serving_bucket_runs', 'executed batches per bucket size')
bucket_compiled = _LazyMetric(
    'gauge', 'serving_bucket_compiled',
    '1 once the bucket shape has been compiled (warmup or first use)')
bucket_compile_seconds = _LazyMetric(
    'gauge', 'serving_bucket_compile_seconds',
    'wall seconds of the bucket\'s first (compiling) run')
http_responses = _LazyMetric(
    'counter', 'serving_http_responses',
    'HTTP front-end responses by status code')

# -- circuit breaker (serving/breaker.py) ----------------------------------
# state encoding: 0 = closed, 1 = half-open (probing), 2 = open (tripped)

breaker_state = _LazyMetric(
    'gauge', 'serving_breaker_state',
    'predict-path circuit breaker state (0 closed / 1 half-open / 2 open)')
breaker_trips = _LazyMetric(
    'counter', 'serving_breaker_trips',
    'predict-path breaker trips (consecutive-failure threshold or failed '
    'probe)')
breaker_rejected = _LazyMetric(
    'counter', 'serving_breaker_rejected',
    'requests rejected fast with EngineUnhealthy while the breaker was open')
breaker_probes = _LazyMetric(
    'counter', 'serving_breaker_probes',
    'half-open probe windows opened after the breaker cooldown')

PREDICT_BREAKER_METRICS = {'state': breaker_state, 'trips': breaker_trips,
                           'rejected': breaker_rejected,
                           'probes': breaker_probes}


# -- stateful decode engine (serving/decode/) ------------------------------
# Same always-on discipline as the rest of serving: decode steps are
# ms-scale device calls, and /metrics on a generation server must work
# without PADDLE_TPU_TELEMETRY.

# slot occupancy is a ratio in [0, 1]: linear buckets
_OCCUPANCY_BOUNDS = tuple(i / 10.0 for i in range(1, 10))

decode_requests_accepted = _LazyMetric(
    'counter', 'decode_requests_accepted',
    'generation requests admitted to the decode queue')
decode_requests_completed = _LazyMetric(
    'counter', 'decode_requests_completed',
    'generations finished (eos or token budget)')
decode_requests_failed = _LazyMetric(
    'counter', 'decode_requests_failed',
    'generations failed by an engine/runtime error after admission')
decode_requests_rejected_overload = _LazyMetric(
    'counter', 'decode_requests_rejected_overload',
    'generation requests rejected by bounded-queue backpressure')
decode_requests_rejected_invalid = _LazyMetric(
    'counter', 'decode_requests_rejected_invalid',
    'generation requests rejected by pre-enqueue validation')
decode_requests_deadline_missed = _LazyMetric(
    'counter', 'decode_requests_deadline_missed',
    'generation requests dropped because their deadline expired while '
    'waiting for a slot')
decode_queue_depth = _LazyMetric(
    'gauge', 'decode_queue_depth',
    'generation requests waiting for a decode slot')

decode_slots_total = _LazyMetric(
    'gauge', 'decode_slots_total', 'configured lockstep decode slots (S)')
decode_slots_active = _LazyMetric(
    'gauge', 'decode_slots_active',
    'slots holding a live generation, sampled each decode step')
decode_slot_occupancy = _LazyMetric(
    'histogram', 'decode_slot_occupancy',
    'active/total slot ratio per decode step — the continuous-batching '
    'efficiency signal', bounds=_OCCUPANCY_BOUNDS)

decode_cache_blocks_total = _LazyMetric(
    'gauge', 'decode_cache_blocks_total',
    'allocatable KV-cache blocks (pool size minus the scratch block)')
decode_cache_blocks_used = _LazyMetric(
    'gauge', 'decode_cache_blocks_used',
    'KV-cache blocks currently reserved by live generations')

decode_prefill_seconds = _LazyMetric(
    'histogram', 'decode_prefill_seconds',
    'wall seconds per prompt prefill (bucket-padded, one per admission)')
decode_step_seconds = _LazyMetric(
    'histogram', 'decode_step_seconds',
    'wall seconds per lockstep decode step (all S slots) — with '
    'decode_prefill_seconds this is the prefill-vs-decode time split')
decode_steps = _LazyMetric(
    'counter', 'decode_steps', 'lockstep decode steps executed')
decode_tokens_generated = _LazyMetric(
    'counter', 'decode_tokens_generated',
    'tokens emitted to generation streams (rate = tokens/s)')
decode_prefill_compiles = _LazyMetric(
    'counter', 'decode_prefill_compiles',
    'prefill bucket shapes compiled (bounded by the prompt ladder length)')

# speculative decoding (engine.spec_step + scheduler verify loop); accept
# length per round is a small integer — linear buckets up to the window
_ACCEPT_BOUNDS = tuple(float(i) for i in range(9))

decode_spec_rounds = _LazyMetric(
    'counter', 'decode_spec_rounds',
    'speculative (S, k) verify steps executed (each replaces up to k '
    'lockstep steps)')
decode_spec_draft_tokens = _LazyMetric(
    'counter', 'decode_spec_draft_tokens',
    'draft tokens proposed to verify rounds across all slots')
decode_spec_accepted_tokens = _LazyMetric(
    'counter', 'decode_spec_accepted_tokens',
    'draft tokens accepted by the target model (longest matching prefix); '
    'accepted/draft is the acceptance rate')
decode_spec_acceptance = _LazyMetric(
    'gauge', 'decode_spec_acceptance',
    'cumulative draft-token acceptance rate (accepted / proposed)')
decode_spec_verify_seconds = _LazyMetric(
    'histogram', 'decode_spec_verify_seconds',
    'wall seconds per batched (S, k) verify step — the verify-step split '
    'of decode time')
decode_spec_accept_len = _LazyMetric(
    'histogram', 'decode_spec_accept_len',
    'tokens emitted per slot per verify round (1 = all drafts rejected)',
    bounds=_ACCEPT_BOUNDS)
decode_tokens_sampled = _LazyMetric(
    'counter', 'decode_tokens_sampled',
    'tokens drawn through per-request sampling (temperature > 0) rather '
    'than greedy argmax')

decode_breaker_state = _LazyMetric(
    'gauge', 'decode_breaker_state',
    'decode-path circuit breaker state (0 closed / 1 half-open / 2 open)')
decode_breaker_trips = _LazyMetric(
    'counter', 'decode_breaker_trips',
    'decode-path breaker trips (consecutive-failure threshold or failed '
    'probe)')
decode_breaker_rejected = _LazyMetric(
    'counter', 'decode_breaker_rejected',
    'generation requests rejected fast with EngineUnhealthy while the '
    'decode breaker was open')
decode_breaker_probes = _LazyMetric(
    'counter', 'decode_breaker_probes',
    'half-open probe windows opened after the decode breaker cooldown')

DECODE_BREAKER_METRICS = {'state': decode_breaker_state,
                          'trips': decode_breaker_trips,
                          'rejected': decode_breaker_rejected,
                          'probes': decode_breaker_probes}


# -- serving tier (serving/tier/) ------------------------------------------
# Same always-on discipline: the router/cache/handoff paths run per-request
# (ms-scale), and an operator scraping a router box must see these without
# PADDLE_TPU_TELEMETRY.

# radix prefix cache over the paged KV pool (tier/prefix_cache.py)
prefix_cache_hits = _LazyMetric(
    'counter', 'prefix_cache_hits',
    'admissions that matched >= 1 whole cached block of their prompt')
prefix_cache_misses = _LazyMetric(
    'counter', 'prefix_cache_misses',
    'admissions with no cached prefix (cold prompts)')
prefix_cache_tokens_saved = _LazyMetric(
    'counter', 'prefix_cache_tokens_saved',
    'prompt tokens served from cached KV blocks instead of prefill '
    'compute — the prefill-compute-saved signal')
prefix_cache_blocks_resident = _LazyMetric(
    'gauge', 'prefix_cache_blocks_resident',
    'KV blocks currently held resident by the prefix-cache trie')
prefix_cache_inserted_blocks = _LazyMetric(
    'counter', 'prefix_cache_inserted_blocks',
    'whole prompt blocks published into the trie')
prefix_cache_evicted_blocks = _LazyMetric(
    'counter', 'prefix_cache_evicted_blocks',
    'cached blocks evicted (LRU over refcount-idle leaves) under pool or '
    'cap pressure')
prefix_cache_evictions = _LazyMetric(
    'counter', 'prefix_cache_evictions',
    'blocks leaving HBM residency (spilled or dropped), labeled by cause: '
    'pressure = allocation ran dry, cap = publish hit '
    'PADDLE_TPU_PREFIX_CACHE_MAX_BLOCKS')

# quantized + tiered KV cache (PADDLE_TPU_KV_DTYPE storage dtype + the
# PADDLE_TPU_PREFIX_CACHE_HOST_MB host spill tier)
kv_cache_dtype = _LazyMetric(
    'gauge', 'kv_cache_dtype',
    'KV pool storage dtype code (0 = f32, 1 = bf16, 2 = int8)')
kv_cache_bytes_in_hbm = _LazyMetric(
    'gauge', 'kv_cache_bytes_in_hbm',
    'resident KV pool bytes across allocated layers (payload arrays plus '
    'int8 row-scale arrays), sampled after pool writes')
kv_cache_bytes_spilled = _LazyMetric(
    'counter', 'kv_cache_bytes_spilled',
    'serialized KV payload bytes moved from HBM to the host spill tier')
kv_cache_spill_count = _LazyMetric(
    'counter', 'kv_cache_spill_count',
    'prefix-cache blocks spilled to host RAM instead of being dropped')
kv_cache_reinject_count = _LazyMetric(
    'counter', 'kv_cache_reinject_count',
    'spilled blocks re-scattered into HBM on a later radix hit')
kv_cache_reinject_seconds = _LazyMetric(
    'histogram', 'kv_cache_reinject_seconds',
    'wall seconds per host->HBM reinjection (deserialize + one block '
    'scatter per layer for the whole reinjected run)')

# multi-replica router (tier/router.py)
router_requests = _LazyMetric(
    'counter', 'router_requests', 'generation requests entering the router')
router_requests_completed = _LazyMetric(
    'counter', 'router_requests_completed',
    'routed requests that finished (done line / full reply)')
router_requests_failed = _LazyMetric(
    'counter', 'router_requests_failed',
    'routed requests that failed after streaming began (in-flight on a '
    'dying replica) or exhausted every replica')
router_requests_rerouted = _LazyMetric(
    'counter', 'router_requests_rerouted',
    'dispatch attempts moved to another replica before first byte '
    '(connection refused / 503 / replica died pre-stream) — the '
    'zero-drop failover counter')
router_no_replica = _LazyMetric(
    'counter', 'router_no_replica',
    'pick attempts that found no routable replica (all cold, draining, '
    'degraded, or dead)')
router_replicas_routable = _LazyMetric(
    'gauge', 'router_replicas_routable',
    'replicas currently healthy + warm + not draining')
router_replica_inflight = _LazyMetric(
    'gauge', 'router_replica_inflight',
    'router-side in-flight requests per replica (label replica)')
router_dispatch_seconds = _LazyMetric(
    'histogram', 'router_dispatch_seconds',
    'submit -> replica response headers per dispatch attempt')
router_health_polls = _LazyMetric(
    'counter', 'router_health_polls', 'replica /healthz polls issued')
router_probes = _LazyMetric(
    'counter', 'router_probes',
    'requests routed to a half-open (probing) replica to re-admit it')
router_rolling_restarts = _LazyMetric(
    'counter', 'router_rolling_restarts',
    'replicas restarted behind a drain by rolling_restart()')

# elastic autoscaler (elastic/autoscaler.py, ROADMAP A.11): the handles
# exist as in the JAX package, and nothing in the port records into them yet
autoscale_decisions = _LazyMetric(
    'counter', 'autoscale_decisions',
    'autoscaler decisions taken (labels action=up|down, trigger='
    'queue_depth|ttft_p99|occupancy|min_replicas)')
autoscale_replicas = _LazyMetric(
    'gauge', 'autoscale_replicas',
    'replicas under autoscaler management (including cold pending ones, '
    'excluding draining-for-retirement ones)')
autoscale_replicas_routable = _LazyMetric(
    'gauge', 'autoscale_replicas_routable',
    'managed replicas currently healthy + warm + not draining')
autoscale_time_to_routable_seconds = _LazyMetric(
    'histogram', 'autoscale_time_to_routable_seconds',
    'scale-up launch -> replica routable (spawn + warmup gate + fast '
    'initial health poll)')
autoscale_drain_seconds = _LazyMetric(
    'histogram', 'autoscale_drain_seconds',
    'scale-down drain start -> replica idle (router in-flight 0 and '
    'replica queue empty) and retired')

# fleet-wide observability (observability/distributed.py)
decode_ttft_seconds = _LazyMetric(
    'histogram', 'decode_ttft_seconds',
    'submit -> first emitted token per generation (time-to-first-token)')
router_scrape_failures = _LazyMetric(
    'counter', 'router_scrape_failures',
    'replica /metrics scrapes that failed or timed out during a '
    '/metrics/fleet aggregation (label replica)')
router_fleet_scrapes = _LazyMetric(
    'counter', 'router_fleet_scrapes',
    '/metrics/fleet aggregations served')
trace_requests_sampled = _LazyMetric(
    'counter', 'trace_requests_sampled',
    'requests that carried (router) or received (replica) a sampled '
    'trace context')
trace_spans_recorded = _LazyMetric(
    'counter', 'trace_spans_recorded',
    'distributed-trace spans recorded by this process')
trace_clock_offset_seconds = _LazyMetric(
    'gauge', 'trace_clock_offset_seconds',
    'estimated replica-minus-router wall-clock offset from the health '
    'handshake (label replica) — the trace-merge alignment input')

# disaggregated prefill/decode (tier/disagg.py)
disagg_handoffs = _LazyMetric(
    'counter', 'disagg_handoffs',
    'prefill->decode KV handoffs completed')
disagg_handoff_failures = _LazyMetric(
    'counter', 'disagg_handoff_failures',
    'handoffs that failed (prefill error); the request fails typed, the '
    'decode loop keeps stepping')
disagg_handoff_seconds = _LazyMetric(
    'histogram', 'disagg_handoff_seconds',
    'admission -> KV blocks injected into the decode pool, per handoff')
disagg_kv_bytes = _LazyMetric(
    'counter', 'disagg_kv_bytes',
    'KV payload bytes shipped from prefill to decode replicas')
disagg_pending = _LazyMetric(
    'gauge', 'disagg_pending',
    'admitted requests waiting on a prefill handoff right now')
