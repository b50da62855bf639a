"""Memory introspection (counterpart of
paddle_tpu/contrib/memory_usage_calc.py).

- ``memory_usage(program, batch_size)``: a static estimate from the
  program's variable shapes, Fluid's (lower, upper, unit) contract.
- ``device_memory_stats()``: the caching allocator's live counters for each
  card (``torch.cuda.memory_stats``), under the JAX package's keys
  (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``) beside
  torch's own. With no card it reports ``{}``, as the JAX package does on
  its CPU mesh.
"""
from __future__ import annotations

from ..framework import Program

__all__ = ['memory_usage', 'device_memory_stats', 'print_memory_report']

_DTYPE_BYTES = {
    'float16': 2, 'bfloat16': 2, 'float32': 4, 'float64': 8,
    'int8': 1, 'uint8': 1, 'int16': 2, 'int32': 4, 'int64': 8, 'bool': 1,
}

# the upper estimate's factor for workspace and fragmentation: a two-sided
# estimate, as Fluid's, not an exact count
_UPPER_FACTOR = 1.7


def memory_usage(program, batch_size):
    """Estimate (lower, upper, unit) of the memory ``program`` uses at
    ``batch_size``: -1 and None dims are the batch dim."""
    if not isinstance(program, Program):
        raise TypeError(
            "Calculating Memory Usage requires Program as its Parameter. "
            "But you passed in %s" % type(program))
    if batch_size <= 0:
        raise ValueError("The batch size need to be positive.")

    total = 0.0
    for var in program.list_vars():
        shape = var.shape
        if shape is None:
            continue
        numel = 1
        for s in shape:
            numel *= batch_size if s in (-1, None) else int(s)
        total += numel * _DTYPE_BYTES.get(str(var.dtype), 4)

    lower, upper = total, total * _UPPER_FACTOR
    for unit in ('B', 'KB', 'MB', 'GB'):
        if upper < 1024 or unit == 'GB':
            return lower, upper, unit
        lower /= 1024.0
        upper /= 1024.0


def device_memory_stats(device=None):
    """{device: {bytes_in_use, peak_bytes_in_use, bytes_limit, and
    torch's ``memory_stats`` keys}} for ``device`` (every card if None);
    ``{}`` with no card."""
    import torch
    if not torch.cuda.is_available():
        return {}
    devices = ([torch.device(device)] if device is not None else
               [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())])
    report = {}
    for d in devices:
        stats = torch.cuda.memory_stats(d)
        report[str(d)] = {
            'bytes_in_use': stats.get('allocated_bytes.all.current', 0),
            'peak_bytes_in_use': stats.get('allocated_bytes.all.peak', 0),
            'bytes_limit': torch.cuda.get_device_properties(d).total_memory,
            **stats}
    return report


def print_memory_report():
    """One line for each card: in use, peak and limit (MB)."""
    report = device_memory_stats()
    if not report:
        print('[paddle_tpu_torch.memory] no allocator stats: no CUDA device')
        return report
    for dev, st in report.items():
        in_use = st['bytes_in_use'] / 2**20
        peak = st['peak_bytes_in_use'] / 2**20
        limit = st['bytes_limit'] / 2**20
        print(f'[paddle_tpu_torch.memory] {dev}: in_use={in_use:.1f}MB '
              f'peak={peak:.1f}MB limit={limit:.1f}MB')
    return report
