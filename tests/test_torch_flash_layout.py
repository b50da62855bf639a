"""The port's C interfaces against their Python mirrors, read from the CUDA
sources on the CPU (no compiler, no card).

The flash kernels take one ``struct FlashParams`` by pointer; the wrappers
fill a ctypes mirror of it (``nn_ops._FlashParams``), and the card checks
only its size. These tests hold the field order, names and types of the two
to each other, and every ``extern "C"`` function that ``ops/_build.py``
declares to its definition in the source, so a layout or signature that
drifts fails here rather than as wrong numbers on the card. They also hold
the launch wrappers' and ``flash_kernel_info``'s argument checks, and the
plain versions' answer for a row whose every key a ``finfo.min`` bias
masks, which the kernels are held to on the card.
"""
import ctypes
import math
import re

import pytest
import torch

from paddle_tpu_torch.ops import _build, nn_ops

# C declaration -> ctypes type, for what the interfaces use; every other
# pointer is a c_void_p
C_TYPES = {'char*': ctypes.c_char_p, 'int': ctypes.c_int,
           'float': ctypes.c_float, 'long long': ctypes.c_longlong}


def source(name):
    return (_build.CSRC_DIR / f'{name}.cu').read_text()


def strip_comments(text):
    return re.sub(r'//[^\n]*', '', text)


def c_type(decl):
    """ctypes type of a C type as written (``const`` and spaces dropped,
    pointers kept)."""
    t = re.sub(r'\bconst\b', '', decl)
    t = re.sub(r'\s*\*\s*', '*', t).strip()
    t = re.sub(r'\s+', ' ', t)
    if t.endswith('*') and t not in C_TYPES:
        return ctypes.c_void_p
    return C_TYPES[t]


def struct_fields(text, name):
    """[(field, ctypes type)] of ``struct name { ... };`` in ``text``, arrays
    as ctypes arrays, ``int a, b;`` as two fields."""
    body = re.search(r'struct\s+' + name + r'\s*\{(.*?)\};',
                     strip_comments(text), re.S).group(1)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(';'))):
        m = re.match(r'(.*?)(\w+(?:\s*\[\d+\])?(?:\s*,\s*\w+)*)$', decl)
        base, names = m.group(1), m.group(2)
        if not base.strip():
            raise AssertionError(f'unparsed field declaration {decl!r}')
        for n in (x.strip() for x in names.split(',')):
            arr = re.match(r'(\w+)\s*\[(\d+)\]', n)
            if arr:
                fields.append((arr.group(1), c_type(base) * int(arr.group(2))))
            else:
                fields.append((n, c_type(base)))
    return fields


def c_functions(text):
    """{name: (return ctypes type, [argument ctypes types])} of the
    functions defined inside the source's ``extern "C"`` block."""
    block = strip_comments(text).split('extern "C" {', 1)[1]
    out = {}
    for m in re.finditer(r'^((?:const\s+)?[\w ]+?\*?)\s*(\w+)\(([^)]*)\)\s*\{',
                         block, re.M):
        ret, fn, args = m.groups()
        types = []
        for a in filter(None, (x.strip() for x in args.split(','))):
            types.append(c_type(re.sub(r'\w+$', '', a)))
        out[fn] = (c_type(ret), types)
    return out


def ctypes_layout(fields):
    return [(n, ctypes.sizeof(t), getattr(t, '_type_', t),
             getattr(t, '_length_', None)) for n, t in fields]


def test_flash_params_struct_matches_the_ctypes_mirror():
    fields = struct_fields(source('flash_attention'), 'FlashParams')
    mirror = nn_ops._FlashParams._fields_
    assert [n for n, _ in fields] == [n for n, _ in mirror]
    assert ctypes_layout(fields) == ctypes_layout(mirror)

    class FromSource(ctypes.Structure):
        _fields_ = fields

    assert ctypes.sizeof(FromSource) == ctypes.sizeof(nn_ops._FlashParams)
    for n, _ in fields:
        assert (getattr(FromSource, n).offset
                == getattr(nn_ops._FlashParams, n).offset), n


@pytest.mark.parametrize('name', sorted(_build.SOURCES))
def test_every_declared_c_function_matches_its_definition(name):
    defined = c_functions(source(name))
    for fn, (restype, argtypes) in _build.SOURCES[name].items():
        assert fn in defined, f'{fn} is not defined in {name}.cu'
        ret, args = defined[fn]
        assert ret is restype, fn
        assert args == list(argtypes), fn


def test_flash_kernel_info_rejects_what_no_body_was_built_for():
    with pytest.raises(ValueError, match='no flash body'):
        nn_ops.flash_kernel_info('flash_attention_fwd', 48, torch.bfloat16)
    with pytest.raises(ValueError, match='no flash body'):
        nn_ops.flash_kernel_info('flash_attention_fwd', 64, torch.float16)


def test_flash_kernel_info_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match='no flash body'):
        nn_ops.flash_kernel_info('flash_attention_bwd', 64, torch.bfloat16)


def cpu_operands(seed=0, b=1, h=2, s=6, d=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, s, d, generator=g).to(dtype) for _ in range(4)]


@pytest.mark.parametrize('wrapper', nn_ops.FLASH_KINDS)
def test_flash_launch_wrappers_take_only_cuda_tensors(wrapper):
    """The launching wrappers never fall back to the plain version: given
    CPU tensors they raise (the autograd Function picks the plain version
    on the CPU instead)."""
    q, k, v, do = cpu_operands()
    stats = torch.zeros((2,) + q.shape[:3])
    args = (q, k, v, None) + ((stats, stats[0], do) if 'bwd' in wrapper
                              else ())
    with pytest.raises(ValueError, match='run on CUDA tensors'):
        getattr(nn_ops, wrapper)(*args, sm_scale=0.25)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_plain_versions_keep_a_row_masked_by_finfo_min_finite(dtype):
    """A (B, 1, 1, S) bias of finfo.min on every key of batch row 1: the
    plain forward gives that row the max score finfo.min and log l = log S,
    so the weight 1 / S on every key, as the softmax gives it
    (``fused_attention_ref``), and the plain backward from it stays finite.
    The kernels are held to the same rows on the card
    (tests/test_torch_gpu.py)."""
    q, k, v, do = cpu_operands(b=2, dtype=dtype)
    s = q.shape[2]
    tol = {'atol': 1e-5, 'rtol': 1e-5} if dtype == torch.float32 else \
        {'atol': 8e-3, 'rtol': 8e-3}
    bias = torch.zeros(2, 1, 1, s)
    bias[1] = torch.finfo(torch.float32).min
    kw = {'sm_scale': 0.25}
    o, stats = nn_ops.fused_attention_fwd_ref(q, k, v, bias, **kw)
    assert torch.isfinite(o).all() and torch.isfinite(stats).all()
    assert (stats[0, 1] == torch.finfo(torch.float32).min).all()
    torch.testing.assert_close(stats[1, 1],
                               torch.full_like(stats[1, 1], math.log(s)))
    torch.testing.assert_close(o[1].float(),
                               v[1].float().mean(-2, keepdim=True)
                               .expand_as(o[1]), **tol)
    soft = nn_ops.fused_attention_ref(q, k, v, bias, **kw)
    torch.testing.assert_close(soft[1].float(),
                               v[1].float().mean(-2, keepdim=True)
                               .expand_as(soft[1]), atol=1e-2, rtol=1e-2)
    for out in (o, soft.to(dtype)):
        grads = nn_ops.fused_attention_bwd_ref(q, k, v, bias, out, stats, do,
                                               **kw)
        assert all(torch.isfinite(g).all() for g in grads)




def test_paged_decode_ranges_are_the_ones_its_tests_assume():
    """The split-context decode kernel's 64-key ranges and its at most 8
    CTAs (one cluster) of a slot and head, which tests/test_torch_gpu.py's
    range-edge contexts are built from; 8 is the portable cluster size (a
    larger cluster needs an opt-in attribute the launcher does not set)."""
    text = strip_comments(source('paged_attention'))
    consts = dict(re.findall(r'constexpr int (kSplitKeys|kMaxCluster) = '
                             r'(\d+);', text))
    assert consts == {'kSplitKeys': '64', 'kMaxCluster': '8'}
