"""Multi-process bring-up on ``torch.distributed``: fleet-env discovery,
the default process group, the cross-rank primitives and a local spawner
(counterpart of paddle_tpu/fleet_runtime/bootstrap.py).

A rank is one process, driving one card or the CPU. The reference's
``distributed/launch.py`` spawns one process per GPU and wires the
trainer env vars; :func:`discover_fleet_env` reads them as the JAX
package does, **strictly**: a malformed or contradictory environment
raises at once, listing every expected variable, instead of training
alone while the other ranks wait in a collective.

Recognized variables::

    PADDLE_TRAINERS_NUM        world size (int >= 1)
    PADDLE_TRAINER_ID          this rank in [0, num)
    PADDLE_TRAINER_ENDPOINTS   comma list "host:port,..." (len == num)
    PADDLE_CURRENT_ENDPOINT    this rank's entry of the list
    PADDLE_TPU_FLEET_COORDINATOR  the rendezvous address (defaults to
                               endpoint[0]); a URL such as
                               ``file:///path`` is used as it is, a
                               ``host:port`` as ``tcp://host:port``

:func:`bootstrap` starts the default process group from that spec. The
backend follows one rule: NCCL when CUDA is available and the world is no
larger than the visible cards (rank r drives card r mod the count), gloo
otherwise (the CPU, and more ranks than cards, which share them). A world
of one rendezvous through an in-process store. The JAX bootstrap also
wires the partitioner's mesh and arms the fleet sentinel
(``coordinator.py``); both stay with ROADMAP A.9: the port has no
partitioner yet (the default group is the data-parallel group), and a
rank that dies surfaces in its peers as a failed collective, not as the
sentinel's poison flag.

``local_fleet(nproc, script)`` spawns ``nproc`` real worker processes
with the fleet env wired (endpoints on free localhost ports), for the
tests and ``distributed.launch``.
"""
from __future__ import annotations

import atexit
import json
import logging
import os
import socket
import subprocess
import sys
import time
import zlib

import torch
import torch.distributed as dist

from ..log_helper import get_logger

__all__ = ['FleetSpec', 'discover_fleet_env', 'bootstrap', 'process_index',
           'process_count', 'is_host0', 'local_fleet', 'LocalFleet',
           'fleet_barrier', 'broadcast_from_host0', 'all_hosts_agree',
           'fleet_allreduce_scalars', 'free_port', 'choose_backend',
           'ENV_NUM', 'ENV_ID', 'ENV_ENDPOINTS', 'ENV_CURRENT',
           'ENV_COORDINATOR']

_logger = get_logger(
    __name__, logging.INFO,
    fmt='%(asctime)s-%(levelname)s: [fleet] %(message)s')

ENV_NUM = 'PADDLE_TRAINERS_NUM'
ENV_ID = 'PADDLE_TRAINER_ID'
ENV_ENDPOINTS = 'PADDLE_TRAINER_ENDPOINTS'
ENV_CURRENT = 'PADDLE_CURRENT_ENDPOINT'
ENV_COORDINATOR = 'PADDLE_TPU_FLEET_COORDINATOR'

def _fail(problem):
    raise ValueError(
        f'fleet env: {problem}. Expected variables: '
        f'{ENV_NUM} (int >= 1), {ENV_ID} (int in [0, {ENV_NUM})), '
        f'{ENV_ENDPOINTS} (comma list of host:port, one per trainer), '
        f'{ENV_CURRENT} (this host\'s endpoint, member of the list), '
        f'{ENV_COORDINATOR} (optional coordinator host:port; defaults to '
        f'the first endpoint)')


def _parse_int(environ, name):
    raw = environ.get(name, '').strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        _fail(f'{name} must be an integer, got {raw!r}')


class FleetSpec:
    """Parsed and checked fleet topology. ``num_trainers == 1`` is a
    valid fleet of one rank (:func:`bootstrap` starts a group of one)."""

    __slots__ = ('num_trainers', 'trainer_id', 'endpoints',
                 'coordinator_address')

    def __init__(self, num_trainers, trainer_id, endpoints=None,
                 coordinator_address=None):
        num_trainers = int(num_trainers)
        trainer_id = int(trainer_id)
        if num_trainers < 1:
            _fail(f'{ENV_NUM} must be >= 1, got {num_trainers}')
        if not (0 <= trainer_id < num_trainers):
            _fail(f'{ENV_ID}={trainer_id} outside [0, '
                  f'{ENV_NUM}={num_trainers})')
        if endpoints is not None:
            if len(endpoints) != num_trainers:
                _fail(f'{ENV_ENDPOINTS} lists {len(endpoints)} endpoints '
                      f'but {ENV_NUM}={num_trainers}')
            if len(set(endpoints)) != len(endpoints):
                _fail(f'{ENV_ENDPOINTS} has duplicate entries')
        if coordinator_address is None and endpoints:
            coordinator_address = endpoints[0]
        if num_trainers > 1 and not coordinator_address:
            _fail(f'{ENV_NUM}={num_trainers} > 1 but neither '
                  f'{ENV_COORDINATOR} nor {ENV_ENDPOINTS} is set (no way '
                  f'to rendezvous)')
        self.num_trainers = num_trainers
        self.trainer_id = trainer_id
        self.endpoints = list(endpoints) if endpoints else None
        self.coordinator_address = coordinator_address

    def __repr__(self):
        return (f'FleetSpec(num={self.num_trainers}, id={self.trainer_id}, '
                f'coordinator={self.coordinator_address!r})')


def discover_fleet_env(environ=None):
    """→ :class:`FleetSpec` from the environment, or None when NO fleet
    vars are set (plain single-process run). A partially/contradictorily
    set environment raises (strict parse — see module docstring)."""
    environ = environ if environ is not None else os.environ
    num = _parse_int(environ, ENV_NUM)
    tid = _parse_int(environ, ENV_ID)
    eps_raw = environ.get(ENV_ENDPOINTS, '').strip()
    cur = environ.get(ENV_CURRENT, '').strip()
    coord = environ.get(ENV_COORDINATOR, '').strip() or None
    if num is None and tid is None and not eps_raw and not cur \
            and coord is None:
        return None
    if num is None:
        _fail(f'{ENV_ID}/{ENV_ENDPOINTS} set but {ENV_NUM} is missing')
    if tid is None:
        tid = 0 if num == 1 else _fail(
            f'{ENV_NUM}={num} set but {ENV_ID} is missing')
    endpoints = None
    if eps_raw:
        endpoints = [e.strip() for e in eps_raw.split(',') if e.strip()]
        for e in endpoints:
            if ':' not in e:
                _fail(f'{ENV_ENDPOINTS} entry {e!r} is not host:port')
    spec = FleetSpec(num, tid, endpoints, coord)
    if cur:
        if spec.endpoints is None:
            _fail(f'{ENV_CURRENT} set but {ENV_ENDPOINTS} is missing')
        if cur not in spec.endpoints:
            _fail(f'{ENV_CURRENT}={cur!r} not in {ENV_ENDPOINTS}')
        if spec.endpoints.index(cur) != spec.trainer_id:
            _fail(f'{ENV_CURRENT}={cur!r} is endpoint '
                  f'#{spec.endpoints.index(cur)} but {ENV_ID}='
                  f'{spec.trainer_id} (contradictory rank)')
    return spec


def choose_backend(world_size):
    """'nccl' when CUDA is available and ``world_size`` is no larger than
    the visible cards, else 'gloo'."""
    if torch.cuda.is_available() and \
            world_size <= torch.cuda.device_count():
        return 'nccl'
    return 'gloo'


def _init_method(address):
    return address if '://' in address else f'tcp://{address}'


def bootstrap(spec=None, configure_mesh=True, install_sentinel_flag=True):
    """Start the default process group (idempotent):

    1. parse and check the fleet env (strictly) unless ``spec`` is given;
    2. ``torch.distributed.init_process_group`` with the backend of
       :func:`choose_backend` against the coordinator (an in-process
       store for a world of one); under NCCL, rank r takes card r mod the
       visible count;
    3. a barrier, so no rank runs ahead of the rendezvous.

    ``configure_mesh=True`` is the JAX default, the data-parallel mesh of
    every device, which here is the default group itself;
    ``install_sentinel_flag`` is accepted and arms nothing (module
    docstring). A mesh shape in ``configure_mesh`` raises naming ROADMAP
    A.9. Returns the spec, or None for a plain single-process run with no
    fleet env, which starts no group."""
    if configure_mesh not in (True, False):
        raise NotImplementedError(
            f'bootstrap(configure_mesh={configure_mesh!r}): a mesh shape '
            f'needs the partitioner, not ported yet (ROADMAP A.9)')
    spec = spec if spec is not None else discover_fleet_env()
    if spec is None or dist.is_initialized():
        return spec
    n, rank = spec.num_trainers, spec.trainer_id
    backend = choose_backend(n)
    if backend == 'nccl':
        torch.cuda.set_device(rank % torch.cuda.device_count())
    t0 = time.perf_counter()
    if n == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        where = 'an in-process store'
    else:
        where = _init_method(spec.coordinator_address)
        dist.init_process_group(backend, init_method=where, rank=rank,
                                world_size=n)
    # a script that never destroys the group (the reference's train.py
    # does not) would otherwise tear gloo's threads down under the
    # interpreter's exit, which aborts the process now and then
    atexit.register(_destroy_group)
    if n > 1:
        dist.barrier()
    _logger.info('torch.distributed up: backend %s, rank %d/%d, '
                 'rendezvous %s, %.2fs', backend, rank, n, where,
                 time.perf_counter() - t0)
    from .. import observability as _obs
    _obs.distributed.set_process_label('host%d' % rank)
    if _obs._ENABLED:
        _obs.set_gauge('fleet_world_size', n,
                       help='number of trainer processes in the fleet')
        _obs.set_gauge('fleet_process_index', rank,
                       help='this process\'s trainer id')
    return spec


def _destroy_group():
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def is_host0():
    return process_index() == 0


# ---------------------------------------------------------------------------
# cross-rank primitives
# ---------------------------------------------------------------------------

def fleet_barrier(tag='fleet_barrier'):
    """Block until every rank reached this barrier (no-op alone)."""
    if process_count() > 1:
        dist.barrier()


def broadcast_from_host0(value):
    """Rank 0's ``value`` (any picklable structure: arrays, tensors,
    numbers) on every rank (no-op alone)."""
    if process_count() <= 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _gather_objects(value):
    out = [None] * process_count()
    dist.all_gather_object(out, value)
    return out


def all_hosts_agree(value, tag='fleet_agree'):
    """True iff every rank passed an identical ``value`` (its JSON's
    CRC-32, compared). Alone: True."""
    if process_count() <= 1:
        return True
    digest = zlib.crc32(
        json.dumps(value, sort_keys=True, default=str).encode()) \
        & 0xFFFFFFFF
    return all(d == digest for d in _gather_objects(digest))


def fleet_allreduce_scalars(values, op='sum'):
    """A list of host scalars reduced over the ranks (identity alone);
    ``op`` in {'sum', 'mean', 'max', 'min'}, over float64."""
    import numpy as np
    ops = {'sum': np.sum, 'mean': np.mean, 'max': np.max, 'min': np.min}
    if op not in ops:
        raise ValueError(f'fleet_allreduce_scalars: unknown op {op!r} '
                         f'(supported: {", ".join(sorted(ops))})')
    vals = [float(v) for v in values]
    if process_count() <= 1:
        return vals
    gathered = np.asarray(_gather_objects(vals), np.float64)
    return [float(v) for v in ops[op](gathered, axis=0)]


# ---------------------------------------------------------------------------
# local_fleet: the spawner of real worker processes
# ---------------------------------------------------------------------------

class LocalFleet:
    """Handle on a spawned local fleet: one subprocess a rank."""

    def __init__(self, procs, spec_envs):
        self.procs = procs
        self.spec_envs = spec_envs

    def wait(self, timeout=600):
        """-> the return code of each rank (None for one killed at the
        ``timeout``). A rank that fails gets its peers killed, which would
        otherwise wait in a collective for it."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            rcs = self.poll()
            if all(rc is not None for rc in rcs):
                return rcs
            if any(rc not in (None, 0) for rc in rcs):
                break
            time.sleep(0.05)
        rcs = self.poll()
        self.terminate()
        return rcs

    def poll(self):
        return [p.poll() for p in self.procs]

    def terminate(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def local_fleet(nproc, script, args=(), env=None, rank_env=None,
                stdout=None, cwd=None):
    """Spawn ``nproc`` workers running ``python script args...`` with the
    fleet env wired: endpoints on free localhost ports, the coordinator
    endpoint 0 (``env`` may set ``PADDLE_TPU_FLEET_COORDINATOR`` to
    another, a ``file://`` URL for one). ``env`` merges into every rank,
    ``rank_env`` is ``{rank: {var: value}}``, ``stdout`` a file or a
    callable ``rank -> file``. Returns a :class:`LocalFleet`."""
    endpoints = [f'localhost:{free_port()}' for _ in range(nproc)]
    procs, envs = [], []
    for r in range(nproc):
        e = dict(os.environ)
        e.pop('PADDLE_TPU_FAULT_INJECT', None)
        e[ENV_NUM] = str(nproc)
        e[ENV_ID] = str(r)
        e[ENV_ENDPOINTS] = ','.join(endpoints)
        e[ENV_CURRENT] = endpoints[r]
        if env:
            e.update(env)
        if rank_env and r in rank_env:
            e.update(rank_env[r])
        out = stdout(r) if callable(stdout) else stdout
        procs.append(subprocess.Popen(
            [sys.executable, str(script)] + [str(a) for a in args],
            env=e, cwd=cwd, stdout=out,
            stderr=subprocess.STDOUT if out is not None else None))
        envs.append(e)
    return LocalFleet(procs, envs)
