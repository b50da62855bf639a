"""Multi-process bring-up on torch.distributed (counterpart of
paddle_tpu/fleet_runtime/): :mod:`bootstrap` only. The coordinator KV store,
the fleet sentinel and the sharded checkpoints stay with ROADMAP A.9."""
from .bootstrap import (FleetSpec, LocalFleet, all_hosts_agree, bootstrap,
                        broadcast_from_host0, discover_fleet_env,
                        fleet_allreduce_scalars, fleet_barrier, is_host0,
                        local_fleet, process_count, process_index)

__all__ = ['FleetSpec', 'discover_fleet_env', 'bootstrap', 'process_index',
           'process_count', 'is_host0', 'local_fleet', 'LocalFleet',
           'fleet_barrier', 'broadcast_from_host0', 'all_hosts_agree',
           'fleet_allreduce_scalars']
