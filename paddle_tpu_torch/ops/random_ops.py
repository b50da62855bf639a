"""Random ops (counterpart of one op of paddle_tpu/ops/random_ops.py):
``sampling_id``. It draws from the port's explicit generator (``key``,
the device's ``torch.Generator`` of core/random.py) or, for a nonzero
``seed``, from a generator of its own seeded with it; the draws differ
from the JAX package's PRNG by design. The JAX package's other random
ops are not ported (ROADMAP A.10)."""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = ['sampling_id']


@register_op('sampling_id', needs_rng=True)
def sampling_id(x, *, seed=0, key=None):
    """One category id a row of the probability rows ``x`` (..., C),
    drawn with those probabilities: int64 of shape ``x.shape[:-1]``."""
    if x.device.type == 'meta':
        return torch.empty(x.shape[:-1], dtype=torch.int64, device='meta')
    if seed:
        key = torch.Generator(device=x.device)
        key.manual_seed(int(seed))
    rows = x.reshape(-1, x.shape[-1]).clamp_min(0)
    ids = torch.multinomial(rows, 1, generator=key)
    return ids.reshape(x.shape[:-1])
