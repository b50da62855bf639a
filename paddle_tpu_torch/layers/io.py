"""Data-layer declarations (counterpart of paddle_tpu/layers/io.py):
``data`` (fluid.layers.data) and ``fluid_data`` (fluid.data)."""
from __future__ import annotations

from ..core.dtypes import convert_dtype
from ..framework import default_main_program

__all__ = ['data', 'fluid_data']


def data(name, shape, dtype='float32', lod_level=0, append_batch_size=True,
         type=None, stop_gradient=True):
    """A fed variable; a -1 batch dim goes in front unless
    ``append_batch_size=False``. Ragged (``lod_level > 0``) feeds are not
    ported and raise."""
    if lod_level:
        raise NotImplementedError('lod_level > 0 (ragged feeds) is not '
                                  'ported yet (ROADMAP A.10)')
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return default_main_program().global_block().create_var(
        name=name, shape=shape, dtype=convert_dtype(dtype), is_data=True,
        stop_gradient=stop_gradient, lod_level=lod_level)


def fluid_data(name, shape, dtype='float32', lod_level=0):
    """fluid.data: ``shape`` as it is, None or -1 for an unknown dim."""
    shape = [-1 if s is None else s for s in shape]
    return data(name, shape, dtype, lod_level, append_batch_size=False)
