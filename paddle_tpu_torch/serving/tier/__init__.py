"""Serving tier: the decode replica process (replica.py) and the strict-parse
environment knobs of the decode path (knobs.py). The router, the prefix
cache and disaggregated prefill come with ROADMAP A.7."""
from .knobs import parse_choice_env, parse_flag_env, parse_int_env

__all__ = ['parse_flag_env', 'parse_int_env', 'parse_choice_env']
