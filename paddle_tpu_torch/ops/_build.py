"""Build the port's CUDA sources with ``nvcc`` at first use and load them
through ``ctypes``.

Each source under ``paddle_tpu_torch/csrc/`` becomes one shared library with
a plain C interface, compiled for Hopper (``sm_90a``) into
``paddle_tpu_torch/build/`` (git-ignored). The library's file name carries a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and a stale build is never loaded. A
build writes to a temporary name and renames it into place, so concurrent
processes never load a half-written library.

Nothing here runs at import: the CPU tests import every module of the
package, and this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ['CSRC_DIR', 'BUILD_DIR', 'SOURCES', 'KERNEL_INFO_KEYS', 'build',
           'build_info', 'kernel_info', 'library', 'nvcc_command',
           'nvcc_path', 'use_build']

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / 'build'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# source name -> {C function: (restype, argtypes)}; every pointer and the
# stream are c_void_p so ctypes never truncates them to 32 bits
SOURCES = {
    # the launchers take q, the pages, the two row-scale pointers (int8
    # pools; else null), ..., the payload code (0 f32, 1 bf16, 2 int8)
    'paged_attention': {
        'paged_decode_attention': (
            _I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                 _F, _P]),
        'paged_prefill_attention': (
            _I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                 _F, _P]),
        # kind (0 decode, 1 prefill), head dim, payload code, int[6] out
        'paged_attention_kernel_info': (_I, [_I, _I, _I, _P]),
        'paged_attention_error_string': (ctypes.c_char_p, [_I]),
    },
    # each launcher takes a pointer to a FlashParams block (ops/nn_ops.py
    # mirrors it as a ctypes Structure) and the stream
    'flash_attention': {
        'flash_attention_fwd': (_I, [_P, _P]),
        'flash_attention_bwd_dkv': (_I, [_P, _P]),
        'flash_attention_bwd_dq': (_I, [_P, _P]),
        'flash_attention_params_size': (_I, []),
        # kind (0 fwd, 1 dK/dV, 2 dQ), head dim, bf16, int[6] out
        'flash_attention_kernel_info': (_I, [_I, _I, _I, _P]),
        'flash_attention_error_string': (ctypes.c_char_p, [_I]),
    },
    # K4: x, w, scale, shift, y, M, N, K, is_bf16, relu, stream
    'conv1x1_bn_act': {
        'conv1x1_bn_act': (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
        # M, N, K, is_bf16, x, w, scale, shift, y, int[4] out
        'conv1x1_bn_act_plan': (_I, [_I, _I, _I, _I, _P, _P, _P, _P, _P,
                                     _P]),
        # body, tile columns, int[6] out
        'conv1x1_bn_act_kernel_info': (_I, [_I, _I, _P]),
        'conv1x1_bn_act_error_string': (ctypes.c_char_p, [_I]),
    },
}

_lock = threading.Lock()
_libs = {}
# source name -> {'seconds', 'cached', 'ptxas'}: what the last build did
# ('ptxas': the compiler's -Xptxas -v lines, spill lines included)
build_info = {}


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location. Raises if none exists."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    candidates += [shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                       'machine with the CUDA toolkit (set CUDA_HOME)')


def nvcc_command(src, out):
    """The ``nvcc`` command that builds source ``src`` into library ``out``
    with the package's flags; the package's headers (``csrc/*.cuh``) are
    found from a copy of a source elsewhere too."""
    return [nvcc_path(), *NVCC_FLAGS, '-I', str(CSRC_DIR), '-o', str(out),
            str(src)]


def _so_path(name):
    digest = hashlib.sha256()
    for f in [CSRC_DIR / f'{name}.cu', *sorted(CSRC_DIR.glob('*.cuh'))]:
        digest.update(f.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}_{digest.hexdigest()[:16]}.so'


def build(names=None):
    """Compile every named source (default: all) that has no current build,
    starting one ``nvcc`` per source together and waiting for all of them.
    Returns :data:`build_info`. Raises with the compiler's output when a
    build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            so = _so_path(name)
            if so.exists():
                build_info[name] = {'seconds': 0.0, 'cached': True,
                                    'ptxas': []}
                continue
            tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
            cmd = nvcc_command(CSRC_DIR / f'{name}.cu', tmp)
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so)
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed for {name}.cu '
                                   f'(exit {proc.returncode}):\n{out}')
            os.replace(tmp, so)
            build_info[name] = {
                'seconds': time.perf_counter() - t0, 'cached': False,
                'ptxas': [ln.strip() for ln in out.splitlines()
                          if 'ptxas' in ln or 'bytes stack frame' in ln]}
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return build_info


def _load(so, name):
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in SOURCES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib


def library(name):
    """The loaded ``ctypes`` library for source ``name``, built first if
    needed, with every function's argtypes and restype declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = _so_path(name)
            if not so.exists():
                build([name])
            lib = _libs[name] = _load(so, name)
        return lib


KERNEL_INFO_KEYS = ('registers', 'spill_bytes', 'static_smem',
                    'dynamic_smem', 'ctas_per_sm', 'threads')


def kernel_info(name, fn, *args):
    """What a body of source ``name`` was built with, read from its loaded
    library on the current card through the C function ``fn`` (``args``,
    then an int[6] out; kernel_info.cuh's layout): ``{'registers',
    'spill_bytes', 'static_smem', 'dynamic_smem', 'ctas_per_sm',
    'threads'}`` (``spill_bytes``: the local memory a thread uses)."""
    lib = library(name)
    out = (ctypes.c_int * len(KERNEL_INFO_KEYS))()
    err = getattr(lib, fn)(*args, out)
    if err != 0:
        msg = getattr(lib, f'{name}_error_string')(err).decode()
        raise RuntimeError(f'{fn} failed: CUDA error {err} ({msg})')
    return dict(zip(KERNEL_INFO_KEYS, out))


def use_build(name, so=None):
    """Make :func:`library` (and so every wrapper) use the library at
    ``so`` for source ``name``: another build of that source, compiled
    elsewhere (a parent commit's copy, say), for timing side by side.
    ``so=None`` goes back to the package's own build."""
    with _lock:
        if so is None:
            _libs.pop(name, None)
        else:
            _libs[name] = _load(so, name)
