"""Serving: the decode engine, its scheduler and the HTTP front end."""
from .decode import (DecodeEngine, DecodeScheduler, GenerationStream,
                     KVCachePool, NGramDrafter, SamplingParams, TokenSampler)
from .errors import (DeadlineExceeded, EngineClosed, EngineUnhealthy,
                     InvalidRequest, OutOfBlocks, Overloaded, ServingError)
from .server import ServingServer

__all__ = ['DecodeEngine', 'DecodeScheduler', 'GenerationStream',
           'KVCachePool', 'NGramDrafter', 'SamplingParams', 'TokenSampler',
           'ServingServer',
           'DeadlineExceeded', 'EngineClosed', 'EngineUnhealthy',
           'InvalidRequest', 'OutOfBlocks', 'Overloaded', 'ServingError']
