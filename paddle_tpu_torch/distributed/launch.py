"""Multi-process launch (counterpart of paddle_tpu/distributed/launch.py).

``init_parallel_env`` starts the default process group through
fleet_runtime/bootstrap.py from the fleet env or its arguments.
``launch(script, args, nproc_per_node)`` runs the script in this process
for ``nproc_per_node`` None or 1, as the JAX package does, and otherwise
spawns that many ranks with the fleet env wired (``local_fleet``), the
reference's one process a GPU; each rank calls ``init_parallel_env``.
"""
from __future__ import annotations

import os

import torch.distributed as dist

__all__ = ['init_parallel_env', 'get_rank', 'get_world_size', 'launch']


def init_parallel_env(coordinator_address=None, num_processes=None,
                      process_id=None):
    """Start the default process group (fleet_runtime/bootstrap.py's
    ``bootstrap``): the fleet env, overridden by the arguments given.
    Returns the spec, or None with neither."""
    from ..fleet_runtime.bootstrap import FleetSpec, bootstrap
    spec = None
    if num_processes is not None or coordinator_address is not None:
        if num_processes is None:
            num_processes = int(os.environ.get('PADDLE_TRAINERS_NUM', '1'))
        spec = FleetSpec(
            num_processes,
            process_id if process_id is not None
            else int(os.environ.get('PADDLE_TRAINER_ID', '0')),
            coordinator_address=coordinator_address)
    return bootstrap(spec=spec)


def get_rank():
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def launch(training_script, args=(), nproc_per_node=None):
    """Run ``training_script`` with ``args``: in this process for
    ``nproc_per_node`` None or 1; else as that many ranks
    (``local_fleet``), waiting for all of them. A rank that fails has
    its peers killed, and ``RuntimeError`` names the return codes."""
    if nproc_per_node is None or int(nproc_per_node) == 1:
        import runpy
        import sys
        old_argv = sys.argv
        sys.argv = [training_script] + list(args)
        try:
            runpy.run_path(training_script, run_name='__main__')
        finally:
            sys.argv = old_argv
        return
    from ..fleet_runtime.bootstrap import local_fleet
    rcs = local_fleet(int(nproc_per_node), training_script, args).wait()
    if any(rc != 0 for rc in rcs):
        raise RuntimeError(f'launch({training_script!r}, nproc_per_node='
                           f'{nproc_per_node}): rank return codes {rcs}')
