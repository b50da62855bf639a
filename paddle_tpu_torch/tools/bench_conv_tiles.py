"""Time builds of K4's source side by side on one CUDA card, the bf16
body at ResNet-50's 12 stride-1 1x1 shapes (batch 128, 224x224, NHWC): the
package's own ``csrc/conv1x1_bn_act.cu`` (its launcher picks the tile
columns), one copy of it for each tile width the wgmma body has, with the
launcher's tile rule replaced by that width (written to
``paddle_tpu_torch/build/variants/``), and any other copies named on the
command line (a parent commit's, say).

    python3 -m paddle_tpu_torch.tools.bench_conv_tiles [NAME=SOURCE ...]

Run it from the repo root: it reuses ``chip_smoke.py``'s inputs, one-ulp
check and timer. Every build compiles in parallel into
``paddle_tpu_torch/build/variants/`` with the package's nvcc flags. Each
is held against the plain version (act relu, within one bf16 ulp) at every
shape, then timed (``chip_smoke.timed``: torch.profiler device time per
launch), in the order given and again in reverse, so drift shows; a row
per shape, with the body and tile each build ran. The card's name and
power limit come first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# (B, H, W, K, N) of ResNet-50's stride-1 1x1 layers at batch 128
PATH_SHAPES = [(128, 56, 56, 64, 64), (128, 56, 56, 64, 256),
               (128, 56, 56, 256, 64), (128, 56, 56, 256, 128),
               (128, 28, 28, 128, 512), (128, 28, 28, 512, 128),
               (128, 28, 28, 512, 256), (128, 14, 14, 256, 1024),
               (128, 14, 14, 1024, 256), (128, 14, 14, 1024, 512),
               (128, 7, 7, 512, 2048), (128, 7, 7, 2048, 512)]


# the launcher's tile rule in csrc/conv1x1_bn_act.cu (make_plan); a width
# copy replaces it with a constant
TILE_RULE = 'const int bn = N <= 64 ? 64 : 128;'


def width_copy(text, bn):
    """K4's source ``text`` with the launcher's tile rule replaced by ``bn``
    tile columns at every shape."""
    if text.count(TILE_RULE) != 1:
        raise ValueError(f'the source does not hold the tile rule '
                         f'{TILE_RULE!r} once')
    return text.replace(TILE_RULE, f'const int bn = {bn};')


def build_all(sources):
    """{name: library path}, every source compiled in parallel."""
    from paddle_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR / 'variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        so = out_dir / f'libconv1x1_bn_act_{name}.so'
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
                    help='a copy of csrc/conv1x1_bn_act.cu to time beside '
                         'the package\'s own ("shipped") and the width '
                         'copies ("bn64", "bn128")')
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit('bench_conv_tiles: no CUDA device')
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from paddle_tpu_torch.ops import _build, pallas_conv
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    shipped = _build.CSRC_DIR / 'conv1x1_bn_act.cu'
    sources = {'shipped': shipped}
    (_build.BUILD_DIR / 'variants').mkdir(parents=True, exist_ok=True)
    for bn in pallas_conv.K4_WGMMA_TILES:
        copy = _build.BUILD_DIR / 'variants' / f'conv1x1_bn_act_bn{bn}.cu'
        copy.write_text(width_copy(shipped.read_text(), bn))
        sources[f'bn{bn}'] = copy
    for spec in args.builds:
        name, _, src = spec.partition('=')
        if not name or not src or name in sources:
            ap.error(f'bad or repeated build {spec!r}')
        sources[name] = Path(src).resolve()
    built = build_all(sources)

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    order = list(built)
    try:
        for shape in PATH_SHAPES:
            b, h, w, k, n = shape
            gen.manual_seed(0)
            x, wt, sc, sh = chip_smoke.k4_inputs(shape, torch.bfloat16, dev,
                                                 gen)
            want = pallas_conv.fused_conv1x1_bn_act_ref(x, wt, sc, sh,
                                                        act='relu')
            times = {name: [] for name in order}
            plans = {}
            for name in order + order[::-1]:
                _build.use_build('conv1x1_bn_act', built[name])
                if name not in plans:
                    plans[name] = pallas_conv.conv1x1_plan(x, wt, sc, sh)
                    got = pallas_conv.conv1x1_bn_act(x, wt, sc, sh,
                                                     act='relu')
                    torch.cuda.synchronize()
                    over = chip_smoke.bf16_ulp_err(got, want)
                    if over > 0:
                        raise AssertionError(f'{name} {shape}: beyond one '
                                             f'bf16 ulp by {over:.3e}')
                dev_ms, event_ms = chip_smoke.timed(
                    lambda: pallas_conv.conv1x1_bn_act(x, wt, sc, sh,
                                                       act='relu'),
                    iters=50)
                times[name].append(dev_ms if dev_ms is not None
                                   else event_ms)
            print(f'{k}->{n} @{h}: ' + '; '.join(
                f'{name} {plans[name]["body"]} 128x{plans[name]["bn"]} '
                + ' '.join(f'{t:.5f}' for t in times[name])
                for name in order), flush=True)
            del x, wt, sc, sh, want
            torch.cuda.empty_cache()
    finally:
        _build.use_build('conv1x1_bn_act')
    return 0


if __name__ == '__main__':
    sys.exit(main())
