"""Core of the port's static graph (counterpart of paddle_tpu/core/): names,
types, the scope of persistable values, places and random generators."""
from . import dtypes, places, random, scope, unique_name
from .dtypes import convert_dtype, to_torch_dtype
from .places import (CPUPlace, CUDAPinnedPlace, CUDAPlace, Place, TPUPlace,
                     XLAPlace, cpu_places, cuda_pinned_places, cuda_places,
                     is_compiled_with_cuda, tpu_places)
from .scope import Scope, global_scope, scope_guard
