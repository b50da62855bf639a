"""Unique names (counterpart of paddle_tpu/core/unique_name.py):
``generate``, ``guard`` and ``switch``. A key's n-th name is ``key_n``, as in
the JAX package, so a program built by both packages names every variable
alike and weights carry across by name."""
from __future__ import annotations

import contextlib
from collections import defaultdict

__all__ = ['UniqueNameGenerator', 'generate', 'switch', 'guard']


class UniqueNameGenerator:
    def __init__(self, prefix=''):
        self.prefix = prefix
        self.ids = defaultdict(int)

    def __call__(self, key):
        tmp = self.ids[key]
        self.ids[key] += 1
        return f'{self.prefix}{key}_{tmp}'


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = (new_generator if new_generator is not None
                 else UniqueNameGenerator())
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
