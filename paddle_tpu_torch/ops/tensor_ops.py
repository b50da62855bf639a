"""Tensor ops (counterpart of paddle_tpu/ops/tensor_ops.py): ``cast``,
``reshape``, ``transpose``, ``fill_constant``, ``one_hot``, and the ops of
the static layers a Fluid script calls around a net (``concat``,
``split``, ``stack``, ``unstack``, ``squeeze``, ``unsqueeze``,
``gather``, ``expand``, ``assign``, the ``fill_*`` ops, ``top_k``,
``range``), the ``slice``, ``reverse`` and ``where`` that the recurrent
layers use, ``arg_max`` and ``transpose_batch_time`` that the decoders
use, ``temporal_shift`` that TSM runs, and ``is_empty`` and the
tensor-array ops. ``assign`` of a
numpy array emits the ``__constant__`` op, which is no registered op in
either package: the executors make its value themselves (executor.py).

A tensor array is a Python list in the executor's env, as the JAX package
keeps it in its traced env; ``__array_write__`` and ``__array_read__`` read
their index on the host (one sync each on the card), where the JAX package
needs a trace-time constant."""
from __future__ import annotations

import torch

from ..core.dtypes import to_torch_dtype
from .registry import register_op

__all__ = ['cast', 'reshape', 'transpose', 'fill_constant', 'one_hot',
           'concat', 'split', 'stack', 'unstack', 'squeeze', 'unsqueeze',
           'gather', 'expand', 'assign', 'fill_constant_batch_size_like',
           'fill_zeros_like', 'fill_any_like', 'top_k', 'arange', 'slice_op',
           'reverse', 'where', 'arg_max', 'transpose_batch_time',
           'temporal_shift']


@register_op('cast')
def cast(x, *, dtype):
    """``x`` in ``dtype``. ``int64`` stays 64-bit here; the JAX package
    computes it in int32 unless x64 is on."""
    return x.to(to_torch_dtype(dtype))


@register_op('reshape')
def reshape(x, *, shape):
    """Paddle's reshape: a 0 in ``shape`` copies ``x``'s dim there, one -1
    is inferred."""
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


@register_op('transpose')
def transpose(x, *, perm):
    return x.permute(*perm)


@register_op('fill_constant')
def fill_constant(*, shape, value, dtype='float32'):
    """A tensor of ``shape`` filled with ``value``. It has no input to take
    a device from: it lands on torch's default device, which the executor
    sets to its own around this op."""
    return torch.full(tuple(shape), value, dtype=to_torch_dtype(dtype))


@register_op('one_hot')
def one_hot(x, *, depth, allow_out_of_range=False):
    """f32 one-hot rows of ``depth`` for the ids ``x`` (a trailing dim of 1
    squeezed); an id outside [0, depth) gives a row of zeros, as
    ``jax.nn.one_hot`` gives it."""
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x[..., 0]
    return (x[..., None] == torch.arange(depth, device=x.device)).to(
        torch.float32)


@register_op('concat', variadic=['xs'])
def concat(xs, *, axis=0):
    xs = xs if isinstance(xs, (list, tuple)) else [xs]
    return torch.cat(list(xs), dim=axis)


@register_op('split', outputs=['Out'], variadic=[])
def split(x, *, num_or_sections, dim=-1):
    """``x`` cut along ``dim`` into ``num_or_sections`` equal parts, or
    into parts of the listed sizes (one -1 or None takes the rest); a
    list of tensors."""
    dim = dim % x.dim()
    if isinstance(num_or_sections, int):
        sizes = x.shape[dim] // num_or_sections
    else:
        sizes = list(num_or_sections)
        known = sum(s for s in sizes if s not in (-1, None))
        sizes = [x.shape[dim] - known if s in (-1, None) else s
                 for s in sizes]
    return list(torch.split(x, sizes, dim=dim))


@register_op('stack', variadic=['xs'])
def stack(xs, *, axis=0):
    xs = xs if isinstance(xs, (list, tuple)) else [xs]
    return torch.stack(list(xs), dim=axis)


@register_op('unstack', outputs=['Y'])
def unstack(x, *, axis=0, num=None):
    """The slices of ``x`` along ``axis``, a list (``num`` is their count,
    as the reference takes it)."""
    return list(torch.unbind(x, dim=axis))


@register_op('squeeze')
def squeeze(x, *, axes=None):
    if not axes:
        return x.squeeze()
    return x.squeeze(tuple(a % x.dim() for a in axes))


@register_op('unsqueeze')
def unsqueeze(x, *, axes):
    axes = [axes] if isinstance(axes, int) else list(axes)
    for a in sorted(axes):
        x = x.unsqueeze(a)
    return x


@register_op('gather')
def gather(x, index, *, overwrite=True):
    """Rows of ``x`` at ``index`` (a trailing index dim of 1 squeezed)."""
    if index.dim() == 2 and index.shape[1] == 1:
        index = index[:, 0]
    return torch.index_select(x, 0, index.long())


@register_op('expand')
def expand(x, *, expand_times):
    """``x`` tiled ``expand_times`` along each dim (``jnp.tile``'s rule)."""
    return torch.tile(x, tuple(expand_times))


@register_op('fill_constant_batch_size_like')
def fill_constant_batch_size_like(ref, *, shape, value, dtype='float32',
                                  input_dim_idx=0, output_dim_idx=0):
    shape = list(shape)
    shape[output_dim_idx] = ref.shape[input_dim_idx]
    return torch.full(tuple(shape), value, dtype=to_torch_dtype(dtype),
                      device=ref.device)


@register_op('fill_zeros_like')
def fill_zeros_like(x):
    return torch.zeros_like(x)


@register_op('fill_any_like')
def fill_any_like(x, *, value, dtype=None):
    return torch.full_like(x, value, dtype=(None if dtype is None
                                            else to_torch_dtype(dtype)))


@register_op('assign')
def assign(x):
    return x.clone()


@register_op('top_k', outputs=['Out', 'Indices'])
def top_k(x, *, k):
    """The ``k`` largest entries of each last-dim row, largest first, and
    their int64 indices (the JAX package computes them in int32 unless x64
    is on)."""
    vals, idx = torch.topk(x, k, dim=-1)
    return vals, idx


@register_op('arg_max')
def arg_max(x, *, axis=0, dtype='int64', keepdims=False):
    """The index of the largest entry along ``axis`` (the first of equal
    ones), in ``dtype``."""
    return torch.argmax(x, dim=axis, keepdim=keepdims).to(
        to_torch_dtype(dtype))


@register_op('transpose_batch_time')
def transpose_batch_time(x):
    """(T, B, ...) <-> (B, T, ...); a tensor of rank below 2 passes
    through."""
    return x.transpose(0, 1) if x.dim() >= 2 else x


@register_op('range')
def arange(*, start, end, step, dtype='float32'):
    """``[start, end)`` by ``step``, made on torch's default device, which
    the executor sets to its own around an op with no input."""
    return torch.arange(start, end, step, dtype=to_torch_dtype(dtype))


@register_op('slice')
def slice_op(x, *, axes, starts, ends):
    """``x[starts:ends]`` on each of ``axes`` (Python's slice rules), a
    view."""
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = slice(st, en)
    return x[tuple(idx)]


@register_op('reverse')
def reverse(x, *, axis):
    axis = [axis] if isinstance(axis, int) else axis
    return torch.flip(x, tuple(a % x.dim() for a in axis))


@register_op('where')
def where(cond, x, y):
    """``x`` where ``cond`` (nonzero) holds, else ``y``."""
    return torch.where(cond if cond.dtype == torch.bool else cond != 0,
                       x, y)


@register_op('temporal_shift')
def temporal_shift(x, *, seg_num, shift_ratio=0.25):
    """TSM's shift of an (N * seg_num, C, H, W) batch of clips: in frame t
    the first ``int(C * shift_ratio)`` channels come from frame t + 1 and
    the next as many from frame t - 1 (zeros past a clip's ends); the rest
    stay. That is the JAX op's direction; Paddle 1.7 documents the first
    run from t - 1 and the second from t + 1 (ROADMAP C.4 item 18)."""
    nt, c, h, w = x.shape
    x = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1 = int(c * shift_ratio)
    fwd = torch.cat([x[:, 1:, :c1], torch.zeros_like(x[:, :1, :c1])], 1)
    bwd = torch.cat([torch.zeros_like(x[:, :1, c1:2 * c1]),
                     x[:, :-1, c1:2 * c1]], 1)
    return torch.cat([fwd, bwd, x[:, :, 2 * c1:]], 2).reshape(nt, c, h, w)


@register_op('is_empty')
def _is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


def _index(i):
    return int(i.reshape(()).item()) if isinstance(i, torch.Tensor) \
        else int(i)


@register_op('__array_write__', atomic_output=True)
def _array_write(array, x, i):
    """The list ``array`` with ``x`` at ``i`` (None in any gap before
    it)."""
    idx = _index(i)
    new = list(array) if array is not None else []
    while len(new) <= idx:
        new.append(None)
    new[idx] = x
    return new


@register_op('__array_read__')
def _array_read(array, i):
    return array[_index(i)]


@register_op('__array_length__')
def _array_length(array):
    """The length of ``array``, an int32 scalar on its tensors' device."""
    dev = next((a.device for a in array if a is not None), None)
    return torch.tensor(len(array), dtype=torch.int32, device=dev)
