"""``save_dygraph`` / ``load_dygraph`` (counterpart of
paddle_tpu/dygraph/checkpoint.py), in the JAX package's format, so files
carry across between the packages both ways:

- ``<path>.pdparams.npz``: one array a state-dict name (numpy's ``savez``);
- ``<path>.pdparams.json``: ``{name: {"shape": [...], "dtype": "..."}}``.

An optimizer's state (``Optimizer.state_dict()``, which holds
``global_step``) goes to ``<path>.pdopt.npz`` and ``.pdopt.json`` instead,
as the reference picks ``.pdopt`` for a state with no parameter in it.
Each file is written to a temporary file in its directory and moved into
place with ``os.replace``, so a kill during a save never leaves a torn file.
bfloat16 tensors are saved as float32 (numpy has no bfloat16).
"""
from __future__ import annotations

import io
import json
import os
import tempfile

import numpy as np
import torch

__all__ = ['save_dygraph', 'load_dygraph']


def _atomic_write(path, data):
    d = os.path.dirname(path) or '.'
    fd, tmp = tempfile.mkstemp(dir=d, prefix='.tmp_', suffix='.part')
    try:
        with os.fdopen(fd, 'wb') as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return torch.Tensor.numpy(t.cpu())
    return np.asarray(v)


def save_dygraph(state_dict, model_path):
    """Write ``state_dict`` ({name: tensor or array}) to
    ``<model_path>.pdparams.npz`` (``.pdopt.npz`` for an optimizer's) and
    its ``.json`` manifest."""
    if not state_dict:
        raise ValueError('save_dygraph: the state dict is empty')
    suffix = '.pdopt' if 'global_step' in state_dict else '.pdparams'
    os.makedirs(os.path.dirname(model_path) or '.', exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in state_dict.items()}
    meta = {k: {'shape': list(a.shape), 'dtype': str(a.dtype)}
            for k, a in arrays.items()}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    _atomic_write(model_path + suffix + '.npz', buf.getvalue())
    _atomic_write(model_path + suffix + '.json', json.dumps(meta).encode())


def load_dygraph(model_path, keep_name_table=False):
    """``(params, optimizer_state)``: the ``{name: ndarray}`` of
    ``<model_path>.pdparams.npz`` and of ``.pdopt.npz`` (None when there is
    none). Raises ValueError when there is no ``.pdparams.npz``."""
    path = model_path + '.pdparams.npz'
    if not os.path.exists(path):
        raise ValueError(f'no checkpoint at {model_path}')
    with np.load(path) as data:
        state = {k: data[k] for k in data.files}
    opt_state = None
    if os.path.exists(model_path + '.pdopt.npz'):
        with np.load(model_path + '.pdopt.npz') as od:
            opt_state = {k: od[k] for k in od.files}
    return state, opt_state
