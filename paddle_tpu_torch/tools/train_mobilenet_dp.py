"""PaddleCV's MobileNetV2 under data parallelism: one rank of the eager loop
of its dygraph ``train.py --use_data_parallel 1`` (forward, ``scale_loss``,
``backward``, ``apply_collective_grads``, ``minimize``,
``clear_gradients``; ``vision_recipes.data_parallel_step``), at PaddleCV's
widths and recipe. Started once a rank, e.g. two ranks on this machine::

    from paddle_tpu_torch.distributed import launch
    launch('paddle_tpu_torch/tools/train_mobilenet_dp.py',
           ['--out', DIR], nproc_per_node=2)

Each rank joins through ``init_parallel_env()`` (NCCL where every rank has
a card, else gloo: two ranks on one card share it over gloo), draws the
global batch from ``--seed`` on its device and trains on its share of it.
It runs, each from a fresh model built from ``--seed``:

- one run a ``--comm`` payload (``PADDLE_TPU_COMM_DTYPE`` set for it) of
  ``--steps`` steps, keeping the first step's local and reduced gradient
  bundles and the wire bytes a step that ``record_collective`` counted;
- with ``--sync-bn``, a run of ``--steps`` f32 steps with every
  BatchNorm's ``sync_stats`` turned on (the flag flipped on the built
  layers), keeping the first step's reduced bundle (the gradient of the
  whole batch's mean loss);
- with ``--timed N``, 2 warm-up and N timed f32 steps, each synchronised.

It writes ``OUT/rank<r>.npz`` (each run's parameters and buffers, the
bundles) and ``OUT/rank<r>.json`` (the step times, the wire bytes).
``--deterministic`` asks cuDNN for its deterministic algorithms, so the
rank can be held bit for bit to a replica in another process.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

if __package__ in (None, ''):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.distributed import (get_rank, get_world_size,  # noqa
                                          init_parallel_env)
from paddle_tpu_torch.dygraph import BatchNorm, DataParallel  # noqa: E402
from paddle_tpu_torch.dygraph import parallel as dp  # noqa: E402
from paddle_tpu_torch.models import MobileNetV2  # noqa: E402
from paddle_tpu_torch.parallel import quant_collectives as qc  # noqa: E402
from paddle_tpu_torch.tools import vision_recipes as vr  # noqa: E402


def global_batch(seed, batch, classes, img, dev):
    """(batch, 3, img, img) f32 images and (batch, 1) int64 labels drawn
    on ``dev`` from ``seed``: every rank draws the same, then takes its
    share."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(batch, 3, img, img, device=dev, generator=gen)
    y = torch.randint(0, classes, (batch, 1), device=dev, generator=gen)
    return x, y


def shard(t, rank, world):
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n]


def build(args, dev, sync_bn=False):
    model = MobileNetV2(args.classes, device=dev, seed=args.seed)
    if sync_bn:
        for m in model.sublayers():
            if isinstance(m, BatchNorm):
                m._attrs['sync_stats'] = True
    model = DataParallel(model)
    return model, vr.mobilenet_v2_optimizer(model, args.batch)


def train(args, dev, x, y, steps, sync_bn=False, keep_bundles=False):
    """``steps`` steps of a fresh model; (its state, the first step's
    bundles)."""
    model, opt = build(args, dev, sync_bn)
    bundles = []
    inner = dp._cross_process_allreduce

    def recorded(flat, n, comm):
        red = inner(flat, n, comm)
        if keep_bundles and not bundles:
            bundles.append((flat.clone(), red.clone()))
        return red
    dp._cross_process_allreduce = recorded
    try:
        for _ in range(steps):
            vr.data_parallel_step(model, opt, x, y)
    finally:
        dp._cross_process_allreduce = inner
    state = {f'param/{n}': p.detach()
             for n, p in model.named_parameters()}
    state.update({f'buffer/{n}': b for n, b in model._layers.named_buffers()})
    return state, bundles


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', required=True)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--batch', type=int, default=128,
                    help='the global batch, shared by the ranks')
    ap.add_argument('--classes', type=int, default=1000)
    ap.add_argument('--img', type=int, default=224)
    ap.add_argument('--steps', type=int, default=3)
    ap.add_argument('--comm', default='f32',
                    help='comma list of payloads, one run each')
    ap.add_argument('--sync-bn', action='store_true')
    ap.add_argument('--timed', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--deterministic', action='store_true')
    args = ap.parse_args(argv)
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    init_parallel_env()
    rank, world = get_rank(), get_world_size()
    dev = torch.device(args.device)
    sync = (torch.cuda.synchronize if dev.type == 'cuda'
            else lambda: None)
    x, y = global_batch(args.seed, args.batch, args.classes, args.img, dev)
    x, y = shard(x, rank, world), shard(y, rank, world)
    out, numbers = {}, {'rank': rank, 'world': world, 'wire_bytes': {}}
    for comm in args.comm.split(','):
        os.environ[qc.ENV_COMM_DTYPE] = comm
        with obs.telemetry_guard(True):
            obs.reset()
            state, bundles = train(args, dev, x, y, args.steps,
                                   keep_bundles=True)
            wire = obs.registry.counter('collective_bytes_on_wire').labels(
                path='dygraph_dp', dtype=comm).value
        numbers['wire_bytes'][comm] = wire / args.steps
        out.update({f'{comm}/{k}': v for k, v in state.items()})
        if bundles:
            out[f'{comm}/local'], out[f'{comm}/reduced'] = bundles[0]
    os.environ[qc.ENV_COMM_DTYPE] = 'f32'
    if args.sync_bn:
        state, bundles = train(args, dev, x, y, args.steps, sync_bn=True,
                               keep_bundles=True)
        out.update({f'sync_bn/{k}': v for k, v in state.items()})
        out['sync_bn/reduced'] = bundles[0][1]
    if args.timed:
        model, opt = build(args, dev)
        secs = []
        for _ in range(2 + args.timed):
            t0 = time.perf_counter()
            vr.data_parallel_step(model, opt, x, y)
            sync()
            secs.append(time.perf_counter() - t0)
        timed = secs[2:]
        numbers['step_ms'] = {'p50': statistics.median(timed) * 1e3,
                              'min': min(timed) * 1e3,
                              'max': max(timed) * 1e3}
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, f'rank{rank}.npz'),
             **{k: v.detach().cpu().numpy() for k, v in out.items()})
    with open(os.path.join(args.out, f'rank{rank}.json'), 'w') as f:
        json.dump(numbers, f)


if __name__ == '__main__':
    main()
