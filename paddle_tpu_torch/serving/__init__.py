"""Serving: the decode engine, its scheduler, the HTTP front end and the
serving tier (router, prefix cache, disaggregated prefill)."""
from .decode import (DecodeEngine, DecodeScheduler, GenerationStream,
                     KVCachePool, NGramDrafter, SamplingParams, TokenSampler)
from .errors import (DeadlineExceeded, EngineClosed, EngineUnhealthy,
                     InvalidRequest, NoReplicaAvailable, OutOfBlocks,
                     Overloaded, ServingError)
from .server import ServingServer
from .tier import (KVPayload, LocalPrefillWorker, PrefillReplica,
                   PrefixCache, Router, RouterServer)

__all__ = ['DecodeEngine', 'DecodeScheduler', 'GenerationStream',
           'KVCachePool', 'NGramDrafter', 'SamplingParams', 'TokenSampler',
           'ServingServer', 'Router', 'RouterServer', 'PrefixCache',
           'KVPayload', 'LocalPrefillWorker', 'PrefillReplica',
           'DeadlineExceeded', 'EngineClosed', 'EngineUnhealthy',
           'InvalidRequest', 'NoReplicaAvailable', 'OutOfBlocks',
           'Overloaded', 'ServingError']
