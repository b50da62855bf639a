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


def test_paged_prefill_split_is_the_one_its_tests_assume():
    """The key-split prefill kernel's 16-row query tiles and 32-key chunks
    (one key a lane), which tests/test_torch_gpu.py's prompt lengths are
    chosen around (Lq 1, 16, 33, 255, 256: warps without keys, a split past
    one key a warp, the top rung with and without a ragged tile)."""
    text = strip_comments(source('paged_attention'))
    consts = dict(re.findall(r'constexpr int (kPrefillRows|kKeyChunk) = '
                             r'(\d+);', text))
    assert consts == {'kPrefillRows': '16', 'kKeyChunk': '32'}


def test_conv1x1_tile_widths_match_the_wrapper():
    """The wgmma body's tile widths that ``conv1x1_kernel_info`` and the
    side-by-side timing tool name exist in the source's launcher."""
    from paddle_tpu_torch.ops import pallas_conv
    text = strip_comments(source('conv1x1_bn_act'))
    launched = sorted(int(n) for n in re.findall(r'launch_wgmma<(\d+)>\(',
                                                 text))
    assert tuple(launched) == pallas_conv.K4_WGMMA_TILES


@pytest.mark.parametrize('bn', [64, 128])
def test_conv1x1_tile_rule_is_the_one_the_timing_tool_edits(bn):
    """bench_conv_tiles times K4 at each tile width through copies of the
    source with the launcher's tile rule replaced; the shipped source holds
    that rule once, and a copy holds the width in its place."""
    from paddle_tpu_torch.ops import pallas_conv
    from paddle_tpu_torch.tools import bench_conv_tiles
    assert bn in pallas_conv.K4_WGMMA_TILES
    text = source('conv1x1_bn_act')
    copy = bench_conv_tiles.width_copy(text, bn)
    assert bench_conv_tiles.TILE_RULE not in copy
    assert copy.count(f'const int bn = {bn};') == 1
    assert len(copy) == len(text) - len(bench_conv_tiles.TILE_RULE) + len(
        f'const int bn = {bn};')


def test_every_kernel_info_entry_fills_the_shared_layout():
    """Each source's *_kernel_info entry point reports through the one
    helper of csrc/kernel_info.cuh, whose six ints are the keys
    ``_build.kernel_info`` reads."""
    header = strip_comments(
        (_build.CSRC_DIR / 'kernel_info.cuh').read_text())
    filled = sorted(int(i) for i in re.findall(r'out\[(\d+)\] =', header))
    assert filled == list(range(len(_build.KERNEL_INFO_KEYS)))
    for name, fns in _build.SOURCES.items():
        infos = [fn for fn in fns if fn.endswith('_kernel_info')]
        text = strip_comments(source(name))
        assert len(infos) == 1, name
        assert '#include "kernel_info.cuh"' in text, name
        assert 'describe_kernel(' in text, name
        assert 'cudaOccupancyMaxActiveBlocksPerMultiprocessor' not in text


def test_a_library_name_changes_with_a_shared_header(tmp_path, monkeypatch):
    """An edited csrc/*.cuh gives every source a new library name, so a
    build made before the edit is never loaded."""
    import shutil
    csrc = tmp_path / 'csrc'
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, 'CSRC_DIR', csrc)
    before = {name: _build._so_path(name) for name in _build.SOURCES}
    header = csrc / 'kernel_info.cuh'
    header.write_text(header.read_text() + '\n')
    after = {name: _build._so_path(name) for name in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
