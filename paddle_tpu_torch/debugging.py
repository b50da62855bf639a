"""Failure detection: NaN/Inf checks and the device report (counterpart of
paddle_tpu/debugging.py).

``FLAGS_check_nan_inf`` (read when this module is imported) or
:func:`enable_check_nan_inf` arms the Executor's scan of fetched values:
each fetched float tensor is tested on its device before the copy to the
host, and a non-finite one raises ``FloatingPointError`` naming the fetch,
as the JAX package's fetch scan does. The JAX package also turns on
``jax_debug_nans``, which raises at the eager op that produced the value;
torch has no such switch, so the port raises at the fetch only (ROADMAP,
"Recorded, not faults")."""
from __future__ import annotations

import logging
import os

import numpy as np
import torch

from .log_helper import get_logger

__all__ = ['enable_check_nan_inf', 'check_nan_inf_enabled',
           'nonfinite_summary', 'check_numerics', 'assert_all_finite',
           'device_report', 'install_check']

_logger = get_logger(__name__, logging.INFO,
                     fmt='%(asctime)s-%(levelname)s: %(message)s')

_check_enabled = os.environ.get('FLAGS_check_nan_inf', '0') not in ('0', '')


def enable_check_nan_inf(enable=True):
    """Arm (or disarm) the Executor's scan of fetched values."""
    global _check_enabled
    _check_enabled = enable


def check_nan_inf_enabled():
    return _check_enabled


def _host(value):
    """``value`` as a host numpy array (a bf16 or fp16 tensor as f32)."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype in (torch.bfloat16, torch.float16):
            value = value.float()
        return value.cpu().numpy()
    return np.asarray(value)


def nonfinite_summary(value):
    """``{'nan': n, 'inf': n, 'size': n}`` of an array or tensor, or None
    when every element is finite or its type is not floating."""
    arr = _host(value)
    if arr.dtype.kind != 'f' or np.isfinite(arr).all():
        return None
    return {'nan': int(np.isnan(arr).sum()),
            'inf': int(np.isinf(arr).sum()),
            'size': int(arr.size)}


def _leaves(value, path=()):
    """(path, leaf) of a nested dict / list / tuple, keys in sorted order;
    a path step reads ``['key']`` or ``[index]``, as the JAX package's
    tree paths print."""
    if isinstance(value, dict):
        for k in sorted(value):
            yield from _leaves(value[k], path + (f'[{k!r}]',))
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            yield from _leaves(v, path + (f'[{i}]',))
    elif value is not None:
        yield path, value


def check_numerics(value, name='tensor'):
    """Raise ``FloatingPointError`` if ``value`` (a tensor, an array, or a
    nested dict, list or tuple of them) holds NaN or Inf; returns
    ``value``."""
    leaves = ([((name,), value)] if hasattr(value, 'shape')
              else _leaves(value))
    bad = []
    for path, v in leaves:
        summary = nonfinite_summary(v)
        if summary is not None:
            bad.append(f"{'/'.join(path) or name}: {summary['nan']} NaN, "
                       f"{summary['inf']} Inf (shape {_host(v).shape})")
    if bad:
        raise FloatingPointError(
            f"check_nan_inf: non-finite values in {name}:\n  "
            + "\n  ".join(bad))
    return value


def assert_all_finite(x, message='tensor'):
    """``x``, or ``x`` made all NaN where any value is not finite, so that
    the failure cannot be missed when fetched (no host sync)."""
    return torch.where(torch.isfinite(x).all(), x,
                       torch.full_like(x, float('nan')))


def device_report():
    """The torch and CUDA versions, the cards and TF32's state."""
    cuda = torch.cuda.is_available()
    names = ([torch.cuda.get_device_name(i)
              for i in range(torch.cuda.device_count())] if cuda else [])
    return '\n'.join([
        f'torch {torch.__version__}, cuda {torch.version.cuda}, '
        f'available {cuda}',
        f'devices: {names} (count {len(names)})',
        f'tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn '
        f'{torch.backends.cudnn.allow_tf32}',
    ])


def install_check(place=None):
    """Self-test: build and run one small training step end to end on
    ``place`` (the card if None, which raises without one)."""
    from . import Executor, Program, Scope, layers, optimizer
    from . import program_guard, scope_guard
    main, start = Program(), Program()
    with program_guard(main, start):
        x = layers.data('x', shape=[4], dtype='float32')
        y = layers.data('y', shape=[1], dtype='float32')
        loss = layers.mean(layers.square_error_cost(layers.fc(x, 1), y))
        optimizer.SGDOptimizer(0.1).minimize(loss)
    exe = Executor(place)
    with scope_guard(Scope()):
        exe.run(start)
        l0, = exe.run(main, feed={'x': np.ones((8, 4), 'float32'),
                                  'y': np.zeros((8, 1), 'float32')},
                      fetch_list=[loss])
        check_numerics(l0, 'install_check loss')
    _logger.info('paddle_tpu_torch install check passed on %s — %s',
                 exe.device, device_report().split('\n')[0])
    return True
