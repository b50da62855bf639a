"""Types of the port's static graph (counterpart of
paddle_tpu/core/dtypes.py): a variable's type is a canonical name, and
:func:`to_torch_dtype` gives the torch type it computes in. Unlike the JAX
package, ``int64`` stays 64-bit (torch has no x64 switch)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ['convert_dtype', 'to_torch_dtype', 'to_numpy_dtype']

_NAME_TO_DTYPE = {
    'bool': torch.bool,
    'int8': torch.int8,
    'uint8': torch.uint8,
    'int16': torch.int16,
    'int32': torch.int32,
    'int64': torch.int64,
    'float16': torch.float16,
    'bfloat16': torch.bfloat16,
    'float32': torch.float32,
    'float64': torch.float64,
    'complex64': torch.complex64,
}
_TORCH_TO_NAME = {v: k for k, v in _NAME_TO_DTYPE.items()}
_ALIASES = {'float': 'float32', 'fp32': 'float32', 'double': 'float64',
            'half': 'float16', 'fp16': 'float16', 'bf16': 'bfloat16',
            'int': 'int32', 'long': 'int64'}


def convert_dtype(dtype):
    """A type (str | numpy type | torch type | None) as its canonical name;
    ``None`` is float32."""
    if dtype is None:
        return 'float32'
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype.lower(), dtype.lower())
    elif isinstance(dtype, torch.dtype):
        name = _TORCH_TO_NAME.get(dtype, str(dtype))
    else:
        name = getattr(dtype, 'name', None) or np.dtype(dtype).name
    if name not in _NAME_TO_DTYPE:
        raise TypeError(f'unsupported dtype: {dtype!r}')
    return name


def to_torch_dtype(dtype):
    return _NAME_TO_DTYPE[convert_dtype(dtype)]


def to_numpy_dtype(dtype):
    """The numpy type a host value of ``dtype`` is made in (bfloat16, which
    numpy lacks, is staged as float32)."""
    name = convert_dtype(dtype)
    return np.dtype('float32' if name == 'bfloat16' else name)
