"""paddle.distributed's namespace (counterpart of paddle_tpu/distributed/):
the launch utilities and the eager collectives over the default process
group. The fleet, the mesh and the topology names stay stand-ins naming
ROADMAP A.9."""
from .._not_ported import stand_in, stand_in_class, stand_in_module
from ..parallel.collective import (allgather, allreduce_max, allreduce_mean,
                                   allreduce_min, allreduce_sum, alltoall,
                                   barrier, broadcast, ppermute,
                                   reduce_scatter)
from .launch import get_rank, get_world_size, init_parallel_env, launch

fleet = stand_in_module('paddle_tpu_torch.distributed.fleet', 'A.9')
Fleet = stand_in_class('paddle_tpu_torch.distributed.Fleet', 'A.9')
DistributedStrategy = stand_in_class(
    'paddle_tpu_torch.distributed.DistributedStrategy', 'A.9')
make_mesh = stand_in('paddle_tpu_torch.distributed.make_mesh', 'A.9')
set_default_mesh = stand_in('paddle_tpu_torch.distributed.set_default_mesh',
                            'A.9')
get_default_mesh = stand_in('paddle_tpu_torch.distributed.get_default_mesh',
                            'A.9')
topology = stand_in('paddle_tpu_torch.distributed.topology', 'A.9')

__all__ = ['launch', 'init_parallel_env', 'get_rank', 'get_world_size',
           'allreduce_sum', 'allreduce_mean', 'allreduce_max',
           'allreduce_min', 'allgather', 'reduce_scatter', 'broadcast',
           'alltoall', 'ppermute', 'barrier', 'fleet', 'Fleet',
           'DistributedStrategy', 'make_mesh', 'set_default_mesh',
           'get_default_mesh', 'topology']
