"""One rank of the port's multi-process tests
(tests/test_torch_data_parallel.py): ``python tests/torch_dp_worker.py
MODE OUTDIR``, started by
``fleet_runtime.local_fleet`` with the fleet env wired; the rank joins
through ``distributed.init_parallel_env()`` (gloo on the CPU) and writes
what it computed to ``OUTDIR/rank<r>.npz``. Imports no JAX.

Modes:

- ``collectives``: every eager collective, the quantized ones and the
  ``c_*`` ops on rank-dependent inputs;
- ``dp``: three steps of ``vision_recipes.data_parallel_step`` on a small
  conv net with BatchNorm under ``DataParallel``, each rank on its half
  of a seeded batch (``PADDLE_TPU_COMM_DTYPE`` picks the payload); each
  step's local bundle and reduced bundle are kept;
- ``syncbn``: ``BatchNorm(sync_stats=True)`` forward and backward on the
  rank's half of a seeded batch.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import distributed, dygraph  # noqa: E402
from paddle_tpu_torch.dygraph import parallel  # noqa: E402
from paddle_tpu_torch.parallel import collective  # noqa: E402
from paddle_tpu_torch.parallel import quant_collectives as qc  # noqa: E402

WORLD = 2
BATCH = 16          # the global batch; each rank takes half
CLASSES = 10
STEPS = 3
IMG = 8
CHANNELS = 3
BN_SHAPE = (8, 4, 5, 5)        # the sync-BN test's global batch


def rank_input(rank, shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed + rank).standard_normal(
        shape).astype(np.float32))


def run_collectives(rank, out):
    x = rank_input(rank, (WORLD, 6))
    out['allreduce_sum'] = collective.allreduce_sum(x)
    out['allreduce_mean'] = collective.allreduce_mean(x)
    out['allreduce_max'] = collective.allreduce_max(x)
    out['allreduce_min'] = collective.allreduce_min(x)
    out['allgather'] = collective.allgather(x)
    out['reduce_scatter'] = collective.reduce_scatter(x)
    out['broadcast'] = collective.broadcast(x, root=1)
    out['alltoall'] = collective.alltoall(x)
    out['ppermute'] = collective.ppermute(x, [(0, 1)])
    out['barrier'] = collective.barrier()
    out['allgather_bf16'] = collective.allgather(
        x.to(torch.bfloat16)).float()
    big = rank_input(rank, (3, 700), seed=10)
    for comm in ('f32', 'bf16', 'int8'):
        out[f'qallreduce_sum_{comm}'] = qc.qallreduce_sum(big, comm_dtype=comm)
        out[f'qallreduce_mean_{comm}'] = qc.qallreduce_mean(
            big, comm_dtype=comm)
        out[f'qreduce_scatter_sum_{comm}'] = qc.qreduce_scatter_sum(
            rank_input(rank, (4, 300), seed=20), comm_dtype=comm,
            scattered_dimension=0)
    for op in ('c_allreduce_max', 'c_allreduce_min', 'c_allreduce_prod',
               'c_allgather', 'c_broadcast', 'c_reducescatter'):
        out[op] = getattr(collective, op)(x)
    out['c_allreduce_sum'] = collective.c_allreduce_sum(x, comm_dtype='int8')
    out['c_allreduce_sum_bucket'] = torch.cat([
        t.reshape(-1) for t in collective.c_allreduce_sum_bucket(
            [x, big], comm_dtype='bf16')])
    out['world'] = torch.tensor([distributed.get_rank(),
                                 distributed.get_world_size(),
                                 parallel.ParallelEnv().nranks])


def small_net(dy=dygraph, layers=fluid.layers):
    """Conv 3->8, BatchNorm, relu, global average pool, Linear 8->10, from
    seeded numpy weights (every rank the same), built by the dygraph
    package ``dy`` (the port's, or the JAX package's in the tests)."""

    class Net(dy.Layer):
        def __init__(self):
            super().__init__()
            self.conv = dy.Conv2D(CHANNELS, 8, 3, padding=1)
            self.bn = dy.BatchNorm(8)
            self.fc = dy.Linear(8, CLASSES)

        def forward(self, x):
            y = layers.pool2d(layers.relu(self.bn(self.conv(x))),
                              pool_type='avg', global_pooling=True)
            return self.fc(layers.reshape(y, shape=[-1, 8]))

    net = Net()
    rng = np.random.RandomState(7)
    net.set_dict({n: (rng.standard_normal(tuple(p.shape)) * 0.3).astype(
        np.float32) for n, p in net.named_parameters()})
    return net


def batch():
    rng = np.random.RandomState(11)
    x = rng.standard_normal((BATCH, CHANNELS, IMG, IMG)).astype(np.float32)
    y = rng.randint(0, CLASSES, (BATCH, 1)).astype(np.int64)
    return x, y


def run_dp(rank, out):
    from paddle_tpu_torch.tools import vision_recipes as vr
    net = small_net()
    model = dygraph.DataParallel(net, dygraph.prepare_context())
    opt = vr.mobilenet_v2_optimizer(model, BATCH)
    seen = []
    inner = parallel._cross_process_allreduce

    def recorded(flat, n, comm):
        red = inner(flat, n, comm)
        seen.append((flat.clone(), red.clone()))
        return red
    parallel._cross_process_allreduce = recorded
    x, y = batch()
    half = BATCH // WORLD
    xs = torch.from_numpy(x[rank * half:(rank + 1) * half])
    ys = torch.from_numpy(y[rank * half:(rank + 1) * half])
    for _ in range(STEPS):
        vr.data_parallel_step(model, opt, xs, ys)
    for i, (flat, red) in enumerate(seen):
        out[f'local{i}'] = flat
        out[f'reduced{i}'] = red
    for n, p in model.named_parameters():
        out[f'param/{n}'] = p.detach()
    for n, b in net.named_buffers():
        out[f'buffer/{n}'] = b


def run_syncbn(rank, out):
    half = BN_SHAPE[0] // WORLD
    x = rank_input(0, BN_SHAPE, seed=30)[rank * half:(rank + 1) * half].clone()
    cot = rank_input(0, BN_SHAPE, seed=31)[rank * half:(rank + 1) * half]
    bn = dygraph.BatchNorm(BN_SHAPE[1], sync_stats=True)
    with torch.no_grad():
        bn.weight.copy_(rank_input(0, (BN_SHAPE[1],), seed=32))
        bn.bias.copy_(rank_input(0, (BN_SHAPE[1],), seed=33))
    x.requires_grad_(True)
    y = bn(x)
    (y * cot).sum().backward()
    out['y'] = y.detach()
    out['dx'] = x.grad
    out['dscale'] = bn.weight.grad
    out['dbias'] = bn.bias.grad
    out['mean'] = bn._mean_buf
    out['variance'] = bn._variance_buf


def main():
    torch.set_num_threads(1)
    mode, outdir = sys.argv[1], sys.argv[2]
    with dygraph.guard(fluid.CPUPlace()):
        distributed.init_parallel_env()
        rank = distributed.get_rank()
        out = {}
        {'collectives': run_collectives, 'dp': run_dp,
         'syncbn': run_syncbn}[mode](rank, out)
    np.savez(os.path.join(outdir, f'rank{rank}.npz'),
             **{k: v.detach().float().numpy() if v.is_floating_point()
                else v.numpy() for k, v in out.items()})


if __name__ == '__main__':
    main()
