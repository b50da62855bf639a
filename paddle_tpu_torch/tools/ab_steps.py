"""Device-busy A/B of whole steps between checkouts, on one CUDA card.

    python3 -m paddle_tpu_torch.tools.ab_steps NAME=DIR [NAME=DIR ...]

Each DIR is a checkout of the repository (a parent commit unpacked into a
git-ignored directory with ``git archive``, and ``.`` for this one). In the
order given and then in reverse (so ``parent=P change=.`` runs parent,
change, change, parent), a fresh process in DIR builds that checkout's
kernels and runs its own ``chip_smoke.py`` phases:

- ``train``: BERT-base at full width, 22 bf16-AMP steps, and one profiled
  step: device busy ms, idle share and the flash kernels' share;
- ``profile_decode_steps``: the served LM (``CausalLMConfig()``) on the
  replica's engine, 8 active slots at contexts 128-188: host ms and device
  busy ms per decode step and the kernels that take it;
- one profiled prefill of a 256-token prompt (the top rung) on the same
  engine: device busy ms and the paged prefill kernel's (K2) ms.

Each run's lines go to standard output prefixed with its NAME; the card's
name and power limit come first. Run it from the repo root.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

RUN = '''
import sys
import numpy as np
sys.path.insert(0, '.')
import chip_smoke
from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.serving.tier.replica import build_lm, build_replica_stack
_build.build()
card = sys.argv[1]
chip_smoke.train(0, resolve_device('cuda'), card)
engine = build_replica_stack(build_lm('default', 0, 'cuda'))[0]
chip_smoke.profile_decode_steps(engine, np.random.RandomState(0), card)
prompt = [int(t) for t in np.random.RandomState(1).randint(
    0, engine.model.cfg.vocab_size, 256)]


def prefill():
    table = engine.reserve_table(len(prompt), 1)
    engine.prefill(prompt, table)
    engine.release_table(table)


prof = chip_smoke.profiled(prefill)
k2 = [e for e in prof.key_averages() if 'paged_prefill' in e.key]
print(f'prefill of {len(prompt)} tokens [{card}]: device busy '
      f'{chip_smoke.device_us(prof) / 1e3:.4f} ms, K2 '
      f'{sum(e.self_device_time_total for e in k2) / 1e3:.4f} ms in '
      f'{sum(e.count for e in k2)} launches')
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('checkouts', nargs='+', metavar='NAME=DIR')
    args = ap.parse_args(argv)
    runs = []
    for spec in args.checkouts:
        name, _, path = spec.partition('=')
        if not name or not path or not (Path(path) / 'chip_smoke.py').exists():
            ap.error(f'{spec!r}: expected NAME=DIR, DIR a checkout')
        runs.append((name, Path(path).resolve()))
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for name, path in runs + runs[::-1]:
        proc = subprocess.run([sys.executable, '-c', RUN, smi], cwd=path,
                              capture_output=True, text=True)
        for line in (proc.stdout + proc.stderr).splitlines():
            print(f'[{name}] {line}', flush=True)
        if proc.returncode != 0:
            print(f'[{name}] exit {proc.returncode}', flush=True)
            return proc.returncode
    return 0


if __name__ == '__main__':
    sys.exit(main())
