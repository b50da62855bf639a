"""A float64 witness for a static program's f32 runs: the same program
cloned to float64 (``as_float64``), run from the same values, against
which two f32 runs are each measured (``rel_l2``). Neither f32 run is
then the yardstick of the other."""
from __future__ import annotations

import numpy as np

__all__ = ['as_float64', 'rel_l2']


def as_float64(program):
    """A clone of ``program`` that computes in float64: every float32
    variable, dtype attr and constant table made float64, and no AMP
    casts."""
    p = program.clone()
    p.__dict__.pop('_amp_config', None)
    for block in p.blocks:
        for var in block.vars.values():
            if var.dtype == 'float32':
                var.dtype = 'float64'
        for op in block.ops:
            for k, a in op.attrs.items():
                if 'dtype' in k and a == 'float32':
                    op.attrs[k] = 'float64'
                elif isinstance(a, np.ndarray) and a.dtype == np.float32:
                    op.attrs[k] = a.astype(np.float64)
    return p


def rel_l2(got, ref):
    """|got - ref| / |ref| in L2 norm, in f64."""
    return float(np.linalg.norm(got.astype(np.float64) - ref)
                 / np.linalg.norm(ref))
