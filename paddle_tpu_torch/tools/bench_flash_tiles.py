"""Time builds of the flash-attention source side by side on one CUDA card:
the package's own ``csrc/flash_attention.cu`` and copies of it (a parent
commit's, or one with other CTA-shape constants), the bf16 forward (K3),
dK/dV (K3b-dkv) and dQ (K3b-dq) at BERT-base's shape (B 128, H 12, S 128,
D 64, no bias). A copy must share the package's ``FlashParams`` layout (the
wrappers check its size).

    python3 -m paddle_tpu_torch.tools.bench_flash_tiles [NAME=SOURCE ...]

Run it from the repo root: it reuses ``chip_smoke.py``'s inputs, tolerances
and timer. Every build compiles in parallel into
``paddle_tpu_torch/build/variants/`` with the package's nvcc flags. Each is
held against the plain versions with the smoke's bf16 tolerances and its
three bodies' registers, local (spill) bytes, shared memory and CTAs an SM
are printed; then the three kernels are timed (``chip_smoke.timed``:
torch.profiler device time per launch, and CUDA events) in the order given
and again in reverse, so drift shows. The card's name and power limit come
first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def build_all(sources):
    """{name: library path}, every source compiled in parallel."""
    from paddle_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR / 'variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        so = out_dir / f'libflash_attention_{name}.so'
        procs[name] = (subprocess.Popen(_build.nvcc_command(src, so),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    built = {}
    for name, (proc, so) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}:\n{text}')
        built[name] = so
    return built


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('builds', nargs='*', metavar='NAME=SOURCE',
                    help='a copy of csrc/flash_attention.cu to time beside '
                         'the package\'s own ("shipped")')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('bench_flash_tiles: no CUDA device')
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from paddle_tpu_torch.ops import _build, nn_ops
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sources = {'shipped': _build.CSRC_DIR / 'flash_attention.cu'}
    for spec in args.builds:
        name, _, src = spec.partition('=')
        if not name or not src or name in sources:
            ap.error(f'bad or repeated build {spec!r}')
        sources[name] = Path(src).resolve()
    built = build_all(sources)

    dev = torch.device('cuda')
    rng = np.random.default_rng(args.seed)
    q, k, v, do, _ = chip_smoke.flash_inputs(rng, dev, chip_smoke.BERT_SHAPE,
                                             torch.bfloat16)
    kw = {'sm_scale': q.shape[-1] ** -0.5}
    o_ref, _ = nn_ops.fused_attention_fwd_ref(q, k, v, **kw)
    tol = chip_smoke.FLASH_TOL['bf16']
    try:
        for name, so in built.items():
            _build.use_build('flash_attention', so)
            for kind in nn_ops.FLASH_KINDS:
                print(f'{name}: {kind} D 64 bf16 '
                      f'{nn_ops.flash_kernel_info(kind, 64, torch.bfloat16)}',
                      flush=True)
            o, stats = nn_ops.flash_attention_fwd(q, k, v, **kw)
            e_o = chip_smoke.compare(f'{name} O', o, o_ref, *tol['o'])
            di = nn_ops._row_dot(o, do)
            dq_ref, dk_ref, dv_ref, _ = nn_ops.fused_attention_bwd_ref(
                q, k, v, None, o, stats, do, **kw)
            dk, dv = nn_ops.flash_attention_bwd_dkv(q, k, v, None, stats, di,
                                                    do, **kw)
            dq, _ = nn_ops.flash_attention_bwd_dq(q, k, v, None, stats, di,
                                                  do, **kw)
            e_g = max(
                chip_smoke.compare(f'{name} dK', dk, dk_ref, *tol['grad']),
                chip_smoke.compare(f'{name} dV', dv, dv_ref, *tol['grad']))
            e_q = chip_smoke.compare(f'{name} dQ', dq, dq_ref, *tol['grad'])
            print(f'{name}: max|diff| O {e_o:.3e}, dK/dV {e_g:.3e}, dQ '
                  f'{e_q:.3e}', flush=True)

        order = list(built)
        for name in order + order[::-1]:
            _build.use_build('flash_attention', built[name])
            o, stats = nn_ops.flash_attention_fwd(q, k, v, **kw)
            di = nn_ops._row_dot(o, do)
            fwd = chip_smoke.timed(
                lambda: nn_ops.flash_attention_fwd(q, k, v, **kw))
            dkv = chip_smoke.timed(lambda: nn_ops.flash_attention_bwd_dkv(
                q, k, v, None, stats, di, do, **kw))
            dq = chip_smoke.timed(lambda: nn_ops.flash_attention_bwd_dq(
                q, k, v, None, stats, di, do, **kw))
            print(f'{name} [{smi}]: forward {fwd[0]!r} ms (events '
                  f'{fwd[1]!r}), dK/dV {dkv[0]!r} ms (events {dkv[1]!r}), '
                  f'dQ {dq[0]!r} ms (events {dq[1]!r})', flush=True)
    finally:
        _build.use_build('flash_attention')
    return 0


if __name__ == '__main__':
    sys.exit(main())
