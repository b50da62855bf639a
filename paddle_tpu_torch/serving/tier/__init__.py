"""Serving tier (counterpart of paddle_tpu/serving/tier/): the layer in
front of N decode replicas.

- :class:`Router` / :class:`RouterServer` (router.py): least-loaded
  dispatch over replicas by their ``/healthz`` load, breaker awareness
  (degraded drained, half-open probed), the cold-replica gate on
  ``warmup``, failover before the first event, rolling restarts behind a
  drain.
- :class:`PrefixCache` (prefix_cache.py): a radix trie at block
  granularity over the paged KV pool; shared prompt prefixes resolve to
  filled, refcounted blocks and only the suffix runs, through the decode
  step; LRU eviction over idle blocks and a host spill tier
  (``DecodeEngine(prefix_cache=True)`` / ``PADDLE_TPU_PREFIX_CACHE=1``).
- disaggregated prefill (disagg.py): :class:`PrefillReplica` runs the
  bucket ladder on a prefill-role engine and ships :class:`KVPayload`
  (whole KV blocks and the first token) to the decode engine through the
  :class:`LocalPrefillWorker` seam (``DecodeScheduler(disagg=...)`` /
  ``PADDLE_TPU_DISAGG=1``).

The decode replica process is replica.py; the strict-parse environment
knobs are knobs.py. Quick start::

    python -m paddle_tpu_torch.serving.tier.replica --port 8081
    python -m paddle_tpu_torch.serving.tier.replica --port 8082
    python -m paddle_tpu_torch.serving.tier.router \\
        --replica http://127.0.0.1:8081 --replica http://127.0.0.1:8082
"""
from .knobs import (parse_choice_env, parse_flag_env, parse_float_env,
                    parse_int_env, parse_replicas_env)
from .prefix_cache import PrefixCache
from .disagg import KVPayload, LocalPrefillWorker, PrefillReplica
from .router import Replica, RoutedGeneration, Router, RouterServer

__all__ = ['Router', 'RouterServer', 'RoutedGeneration', 'Replica',
           'PrefixCache', 'KVPayload', 'LocalPrefillWorker',
           'PrefillReplica', 'parse_flag_env', 'parse_float_env',
           'parse_int_env', 'parse_replicas_env', 'parse_choice_env']
