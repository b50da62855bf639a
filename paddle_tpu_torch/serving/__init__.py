"""Serving (counterpart of paddle_tpu/serving/__init__.py):

- :class:`InferenceEngine` (engine.py) — a saved model behind a bucketed
  batch ladder (1/2/4/.../max), so the number of lowered plans is bounded;
  ``warmup()`` runs the ladder.
- :class:`MicroBatcher` (batcher.py) — bounded request queue + worker
  thread coalescing requests into one device call per batch, with
  pre-enqueue validation, per-request deadlines, ``Overloaded``
  backpressure, a circuit breaker and graceful draining shutdown.
- :class:`ServingServer` (server.py) — stdlib ThreadingHTTPServer front
  end: ``/predict`` (JSON), ``/generate`` (chunked per-token streaming),
  ``/healthz``, ``/metrics`` (Prometheus text).
- stateful decode (decode/): :class:`DecodeEngine` + :class:`DecodeScheduler`
  over a paged KV cache with slot-based continuous batching.
- the serving tier (tier/): :class:`Router` over N replicas,
  :class:`PrefixCache` and disaggregated prefill.

Quick start::

    from paddle_tpu_torch import serving
    engine = serving.InferenceEngine('/path/to/saved_model',
                                     max_batch_size=16)
    engine.warmup()
    with serving.MicroBatcher(engine, batch_timeout_ms=2) as batcher:
        out, = batcher.predict({'x': one_row})           # sync
        fut = batcher.submit({'x': rows}, timeout_ms=50)  # async + deadline

or the whole stack: ``python -m paddle_tpu_torch.serving.server
--model-dir ...``.
"""
from .errors import (DeadlineExceeded, EngineClosed, EngineUnhealthy,
                     InvalidRequest, NoReplicaAvailable, OutOfBlocks,
                     Overloaded, ServingError)
from .engine import DEFAULT_MAX_BATCH, InferenceEngine, bucket_ladder
from .batcher import (DEFAULT_BATCH_TIMEOUT_MS, DEFAULT_QUEUE_DEPTH,
                      MicroBatcher, PredictionFuture)
from .breaker import CircuitBreaker
from .server import ServingServer, create_server
from .decode import (DecodeEngine, DecodeScheduler, GenerationStream,
                     KVCachePool, NGramDrafter, SamplingParams, TokenSampler)
from .tier import (KVPayload, LocalPrefillWorker, PrefillReplica,
                   PrefixCache, Router, RouterServer)

__all__ = ['InferenceEngine', 'MicroBatcher', 'PredictionFuture',
           'ServingServer', 'create_server', 'bucket_ladder',
           'CircuitBreaker',
           'DecodeEngine', 'DecodeScheduler', 'GenerationStream',
           'KVCachePool', 'SamplingParams', 'NGramDrafter', 'TokenSampler',
           'Router', 'RouterServer', 'PrefixCache', 'KVPayload',
           'LocalPrefillWorker', 'PrefillReplica',
           'ServingError', 'InvalidRequest', 'Overloaded', 'DeadlineExceeded',
           'EngineClosed', 'EngineUnhealthy', 'OutOfBlocks',
           'NoReplicaAvailable',
           'DEFAULT_MAX_BATCH', 'DEFAULT_BATCH_TIMEOUT_MS',
           'DEFAULT_QUEUE_DEPTH']
