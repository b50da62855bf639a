"""Strict-parse environment knobs of the decode-serving path (counterpart of
paddle_tpu/serving/tier/knobs.py): a malformed value raises ``ValueError``
naming the knob and the supported set, instead of falling back in silence
while the operator believes the knob took effect.

Parsed when used (constructors, CLI mains), never at import, so a bad
environment fails the component that reads it.

| knob | form | used by |
|---|---|---|
| ``PADDLE_TPU_SPEC_DECODE`` | ``0`` / ``1`` | DecodeEngine (``0`` wins over the constructor argument) |
| ``PADDLE_TPU_SPEC_K`` | int >= 2 | DecodeEngine (the verify window) |
| ``PADDLE_TPU_SPEC_DRAFTER`` | ``ngram`` / ``draft_model`` / ``off`` | DecodeScheduler |
| ``PADDLE_TPU_KV_DTYPE`` | ``f32`` / ``bf16`` / ``int8`` | KVCachePool storage |
| ``PADDLE_TPU_DECODE_HBM_MB`` | int >= 1 | DecodeEngine pool sizing (its solve is ROADMAP A.11's) |
| ``PADDLE_TPU_PREFIX_CACHE`` | ``0`` / ``1`` | DecodeEngine (the argument wins) |
| ``PADDLE_TPU_PREFIX_CACHE_MAX_BLOCKS`` | int >= 0 (0 = uncapped) | PrefixCache resident-block cap |
| ``PADDLE_TPU_PREFIX_CACHE_HOST_MB`` | int >= 0 (0 = no spill tier) | PrefixCache host spill tier byte cap |
| ``PADDLE_TPU_DISAGG`` | ``0`` / ``1`` | tier/replica.py (a prefill engine and its worker beside the decode engine) |
| ``PADDLE_TPU_ROUTER_REPLICAS`` | comma list of http URLs | tier/router.py CLI |
| ``PADDLE_TPU_ROUTER_PORT`` | int in [0, 65535] | tier/router.py CLI |
| ``PADDLE_TPU_ROUTER_HEALTH_POLL_S`` | float > 0 | Router |

The autoscaler's knobs come with ``elastic/`` (ROADMAP A.11).
"""
from __future__ import annotations

import os

__all__ = ['parse_flag_env', 'parse_int_env', 'parse_float_env',
           'parse_replicas_env', 'parse_choice_env', 'ENV_PREFIX_CACHE',
           'ENV_PREFIX_CACHE_MAX_BLOCKS', 'ENV_PREFIX_CACHE_HOST_MB',
           'ENV_DISAGG', 'ENV_ROUTER_REPLICAS', 'ENV_ROUTER_PORT',
           'ENV_ROUTER_HEALTH_POLL_S', 'ENV_SPEC_DECODE', 'ENV_SPEC_K',
           'ENV_SPEC_DRAFTER', 'ENV_KV_DTYPE', 'ENV_DECODE_HBM_MB',
           'KV_DTYPE_CHOICES']

ENV_PREFIX_CACHE = 'PADDLE_TPU_PREFIX_CACHE'
ENV_PREFIX_CACHE_MAX_BLOCKS = 'PADDLE_TPU_PREFIX_CACHE_MAX_BLOCKS'
ENV_PREFIX_CACHE_HOST_MB = 'PADDLE_TPU_PREFIX_CACHE_HOST_MB'
ENV_DISAGG = 'PADDLE_TPU_DISAGG'
ENV_ROUTER_REPLICAS = 'PADDLE_TPU_ROUTER_REPLICAS'
ENV_ROUTER_PORT = 'PADDLE_TPU_ROUTER_PORT'
ENV_ROUTER_HEALTH_POLL_S = 'PADDLE_TPU_ROUTER_HEALTH_POLL_S'

ENV_SPEC_DECODE = 'PADDLE_TPU_SPEC_DECODE'
ENV_SPEC_K = 'PADDLE_TPU_SPEC_K'
ENV_SPEC_DRAFTER = 'PADDLE_TPU_SPEC_DRAFTER'
ENV_KV_DTYPE = 'PADDLE_TPU_KV_DTYPE'
ENV_DECODE_HBM_MB = 'PADDLE_TPU_DECODE_HBM_MB'

# the KV-cache storage types KVCachePool takes, best first: f32 exact, bf16
# half the bytes, int8 a quarter behind one f32 scale a (head, position) row
KV_DTYPE_CHOICES = ('f32', 'bf16', 'int8')


def _raw(name, environ):
    return (environ if environ is not None else os.environ).get(
        name, '').strip()


def parse_flag_env(name, default=False, environ=None):
    """``0``/``1`` boolean knob; anything else raises listing the set."""
    raw = _raw(name, environ)
    if not raw:
        return bool(default)
    if raw not in ('0', '1'):
        raise ValueError(
            f"{name}={raw!r} is not supported; supported values: '0', '1'")
    return raw == '1'


def parse_int_env(name, default, minimum=0, maximum=None, environ=None):
    """Integer knob in [minimum, maximum]; anything else raises."""
    raw = _raw(name, environ)
    if not raw:
        return int(default)
    allowed = (f'integers >= {minimum}'
               + (f' and <= {maximum}' if maximum is not None else ''))
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(f'{name}={raw!r} is not supported; supported '
                         f'values: {allowed}') from None
    if val < minimum or (maximum is not None and val > maximum):
        raise ValueError(f'{name}={val} out of range; supported values: '
                         f'{allowed}')
    return val


def parse_float_env(name, default, minimum_exclusive=0.0, environ=None):
    """Number knob above ``minimum_exclusive``; anything else raises."""
    raw = _raw(name, environ)
    if not raw:
        return float(default)
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(f'{name}={raw!r} is not supported; supported '
                         f'values: numbers > {minimum_exclusive}') from None
    if not val > minimum_exclusive:
        raise ValueError(f'{name}={val} out of range; supported values: '
                         f'numbers > {minimum_exclusive}')
    return val


def parse_replicas_env(name=ENV_ROUTER_REPLICAS, default=None, environ=None):
    """Comma list of replica base URLs: ``http://host:port`` (or a bare
    ``host:port``, given the scheme); a malformed entry raises."""
    raw = _raw(name, environ)
    if not raw:
        return list(default) if default else []
    urls = []
    for entry in raw.split(','):
        entry = entry.strip()
        if not entry:
            raise ValueError(f'{name} has an empty entry; supported values: '
                             f'comma list of http://host:port replica URLs')
        if not entry.startswith(('http://', 'https://')):
            if ':' not in entry:
                raise ValueError(
                    f'{name} entry {entry!r} is not supported; supported '
                    f'values: http://host:port URLs or host:port pairs')
            entry = 'http://' + entry
        urls.append(entry.rstrip('/'))
    return urls


def parse_choice_env(name, choices, default, environ=None):
    """Enumerated string knob; a value outside ``choices`` raises listing
    the supported set."""
    raw = _raw(name, environ)
    if not raw:
        return default
    if raw not in choices:
        raise ValueError(f'{name}={raw!r} is not supported; supported '
                         f'values: ' + ', '.join(repr(c) for c in choices))
    return raw
