"""The port's data parallelism on torch.distributed (fleet_runtime/
bootstrap.py, distributed/, parallel/collective.py,
parallel/quant_collectives.py, dygraph/parallel.py, sync BatchNorm,
parallel_executor.py, vision_recipes.data_parallel_step) against the JAX
package's and against in-process witnesses, on the CPU.

- ``discover_fleet_env`` over a table of environments (valid, missing,
  malformed, contradictory): the JAX package's ``FleetSpec`` fields or its
  error text, exactly.
- ``block_quantize``/``block_dequantize`` bit for bit the JAX codec's;
  ``wire_bytes``, ``resolve_comm_dtype`` and ``quant_error_stats`` equal
  to the JAX functions.
- At a world of one, ``DataParallel`` around a small conv net with
  BatchNorm: three steps of PaddleCV's loop equal the plain loop bit for
  bit, and the JAX ``DataParallel``'s at atol 1e-5 (f32, batch 16).
- The ``c_*`` ops without a group: the identity, as the JAX package's
  ``c_allreduce_sum``, its bucket and the syncs are; the JAX package's
  others raise on the unbound axis, as its eager collectives do (ROADMAP
  C.18).
- Multi-process, two gloo ranks on the CPU spawned by ``local_fleet``
  (``tests/torch_dp_worker.py``), a ``file://`` rendezvous under
  ``tmp_path`` and a 60 s limit on the join that kills the ranks and fails
  the test: (i) every eager collective against its single-process meaning
  and the quantized ones bit for bit against an in-process replay with the
  JAX codec; (ii) ``DataParallel`` steps held to two replicas in one
  process (parameters atol 1e-6, each rank's BatchNorm buffers its
  replica's at atol 1e-6, the ranks bit for bit equal); (iii) the same at
  bf16 and int8 ``comm_dtype``, each reduced bundle bit for bit the
  in-process sum of the JAX codec's dequantized payloads in rank order;
  (iv) ``BatchNorm(sync_stats=True)`` held to the JAX ``batch_norm`` on the
  concatenated batch (outputs, running statistics, input gradients and
  the ranks' summed scale and bias gradients at atol 1e-5).
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.parallel import collective as jcoll
from paddle_tpu.parallel import quant_collectives as jqc
from paddle_tpu_torch import distributed, dygraph
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.parallel import collective
from paddle_tpu_torch.parallel import quant_collectives as qc
from paddle_tpu_torch.tools import vision_recipes as vr
import torch_dp_worker as worker
import torch_jax_seed  # noqa: F401  (caps torch's threads)

# the modules (each package's fleet_runtime exports a function of the name)
jboot = importlib.import_module('paddle_tpu.fleet_runtime.bootstrap')
bootstrap = importlib.import_module('paddle_tpu_torch.fleet_runtime.bootstrap')

CPU = fluid.CPUPlace()
JOIN_TIMEOUT_S = 60
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'torch_dp_worker.py')


@pytest.fixture(autouse=True)
def fresh_port_names(monkeypatch):
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.random import default_generator
    old = unique_name.generator
    unique_name.generator = unique_name.UniqueNameGenerator()
    default_generator.seed(0)
    monkeypatch.delenv(qc.ENV_COMM_DTYPE, raising=False)
    for var in (bootstrap.ENV_NUM, bootstrap.ENV_ID, bootstrap.ENV_ENDPOINTS,
                bootstrap.ENV_CURRENT, bootstrap.ENV_COORDINATOR):
        monkeypatch.delenv(var, raising=False)
    yield
    unique_name.generator = old


# ------------------------------------------------------ the fleet env

ENVS = {
    'none': {},
    'one': {'PADDLE_TRAINERS_NUM': '1'},
    'two': {'PADDLE_TRAINERS_NUM': '2', 'PADDLE_TRAINER_ID': '1',
            'PADDLE_TRAINER_ENDPOINTS': 'a:1, b:2',
            'PADDLE_CURRENT_ENDPOINT': 'b:2'},
    'coordinator': {'PADDLE_TRAINERS_NUM': '2', 'PADDLE_TRAINER_ID': '0',
                    'PADDLE_TPU_FLEET_COORDINATOR': 'file:///tmp/rdv'},
    'coordinator_over_endpoints': {
        'PADDLE_TRAINERS_NUM': '2', 'PADDLE_TRAINER_ID': '0',
        'PADDLE_TRAINER_ENDPOINTS': 'a:1,b:2',
        'PADDLE_TPU_FLEET_COORDINATOR': 'c:3'},
    'missing_num': {'PADDLE_TRAINER_ID': '1'},
    'missing_id': {'PADDLE_TRAINERS_NUM': '2',
                   'PADDLE_TRAINER_ENDPOINTS': 'a:1,b:2'},
    'malformed_num': {'PADDLE_TRAINERS_NUM': 'two'},
    'malformed_id': {'PADDLE_TRAINERS_NUM': '2', 'PADDLE_TRAINER_ID': 'x'},
    'zero': {'PADDLE_TRAINERS_NUM': '0'},
    'id_out_of_range': {'PADDLE_TRAINERS_NUM': '2',
                        'PADDLE_TRAINER_ID': '2',
                        'PADDLE_TRAINER_ENDPOINTS': 'a:1,b:2'},
    'endpoint_not_host_port': {'PADDLE_TRAINERS_NUM': '2',
                               'PADDLE_TRAINER_ID': '0',
                               'PADDLE_TRAINER_ENDPOINTS': 'a:1,b'},
    'endpoint_count': {'PADDLE_TRAINERS_NUM': '3', 'PADDLE_TRAINER_ID': '0',
                       'PADDLE_TRAINER_ENDPOINTS': 'a:1,b:2'},
    'duplicate_endpoints': {'PADDLE_TRAINERS_NUM': '2',
                            'PADDLE_TRAINER_ID': '0',
                            'PADDLE_TRAINER_ENDPOINTS': 'a:1,a:1'},
    'no_rendezvous': {'PADDLE_TRAINERS_NUM': '2', 'PADDLE_TRAINER_ID': '0'},
    'current_without_list': {'PADDLE_TRAINERS_NUM': '1',
                             'PADDLE_CURRENT_ENDPOINT': 'a:1'},
    'current_not_listed': {'PADDLE_TRAINERS_NUM': '2',
                           'PADDLE_TRAINER_ID': '0',
                           'PADDLE_TRAINER_ENDPOINTS': 'a:1,b:2',
                           'PADDLE_CURRENT_ENDPOINT': 'c:3'},
    'contradictory_rank': {'PADDLE_TRAINERS_NUM': '2',
                           'PADDLE_TRAINER_ID': '0',
                           'PADDLE_TRAINER_ENDPOINTS': 'a:1,b:2',
                           'PADDLE_CURRENT_ENDPOINT': 'b:2'},
}


def _parse(fn, env):
    try:
        spec = fn(env)
    except ValueError as e:
        return 'error', str(e)
    if spec is None:
        return None
    return (spec.num_trainers, spec.trainer_id, spec.endpoints,
            spec.coordinator_address, repr(spec))


@pytest.mark.parametrize('case', list(ENVS))
def test_discover_fleet_env_matches_jax(case):
    got = _parse(bootstrap.discover_fleet_env, ENVS[case])
    assert got == _parse(jboot.discover_fleet_env, ENVS[case])
    if case.startswith(('missing', 'malformed', 'zero', 'id_', 'endpoint',
                        'duplicate', 'no_', 'current', 'contradictory')):
        assert got[0] == 'error'


def test_backend_rule_and_plain_runs(monkeypatch):
    assert bootstrap.choose_backend(2) == 'gloo'      # no card here
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert bootstrap.choose_backend(1) == 'nccl'
    assert bootstrap.choose_backend(2) == 'gloo'
    monkeypatch.undo()
    assert bootstrap.bootstrap() is None             # no fleet env
    assert not torch.distributed.is_initialized()
    assert (distributed.get_rank(), distributed.get_world_size()) == (0, 1)
    assert distributed.init_parallel_env() is None
    assert (bootstrap.process_index(), bootstrap.process_count()) == (0, 1)
    assert bootstrap.is_host0() and bootstrap.all_hosts_agree({'a': 1})
    assert bootstrap.fleet_allreduce_scalars([1, 2.5]) == [1.0, 2.5]
    assert bootstrap.broadcast_from_host0([3]) == [3]
    with pytest.raises(ValueError, match='unknown op'):
        bootstrap.fleet_allreduce_scalars([1], op='prod')
    with pytest.raises(NotImplementedError, match='A.9'):
        bootstrap.bootstrap(configure_mesh={'dp': 2})


def test_parallel_env_matches_jax_at_world_one():
    ours, theirs = dygraph.ParallelEnv(), jdy.ParallelEnv()
    for attr in ('nranks', 'local_rank', 'rank', 'world_size', 'dev_id',
                 'current_endpoint', 'trainer_endpoints'):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert dygraph.parallel.Env is dygraph.ParallelEnv
    assert isinstance(dygraph.prepare_context(), dygraph.ParallelEnv)


@pytest.mark.parametrize('name', ['fleet.init', 'Fleet', 'DistributedStrategy',
                                  'make_mesh', 'set_default_mesh',
                                  'get_default_mesh', 'topology'])
def test_distributed_mesh_names_raise_naming_a9(name):
    with pytest.raises(NotImplementedError, match='A.9'):
        obj = distributed
        for part in name.split('.'):
            obj = getattr(obj, part)
        obj()


# ------------------------------------------------------------ the codec

CODEC_SIZES = {'one': (1,), 'block': (256,), 'ragged': (3, 100),
               'zeros': (512,), 'wide': (7, 97)}


@pytest.mark.parametrize('case', list(CODEC_SIZES))
def test_block_codec_is_the_jax_codec_bit_for_bit(case):
    shape = CODEC_SIZES[case]
    x = (np.random.RandomState(len(case)).standard_normal(shape) * 3).astype(
        np.float32)
    if case == 'zeros':
        x[:256] = 0.0
    q, s = qc.block_quantize(torch.from_numpy(x))
    jq, js = jqc.block_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    back = qc.block_dequantize(q, s, shape=shape)
    jback = jqc.block_dequantize(jq, js, shape=shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    for comm in ('f32', 'bf16', 'int8'):
        got = qc.quant_error_stats(torch.from_numpy(x), comm)
        want = jqc.quant_error_stats(jnp.asarray(x), comm)
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


@pytest.mark.parametrize('comm', ['f32', 'bf16', 'int8'])
def test_wire_bytes_match_jax(comm):
    for n in (0, 1, 255, 256, 257, 3504872):
        for axis in (1, 2, 8):
            for phases in (1, 2):
                assert qc.wire_bytes(n, comm, axis, phases=phases) == \
                    jqc.wire_bytes(n, comm, axis, phases=phases)
        assert qc.wire_bytes(n, comm, 2, block_size=128) == \
            jqc.wire_bytes(n, comm, 2, block_size=128)


@pytest.mark.parametrize('env,arg', [(None, None), (None, 'bf16'),
                                     ('int8', 'bf16'), ('', 'f32'),
                                     ('fp8', None), (None, 'fp16')])
def test_resolve_comm_dtype_matches_jax(monkeypatch, env, arg):
    if env is not None:
        monkeypatch.setenv('PADDLE_TPU_COMM_DTYPE', env)

    def resolve(fn):
        try:
            return fn(arg)
        except ValueError as e:
            return str(e)
    assert resolve(qc.resolve_comm_dtype) == resolve(jqc.resolve_comm_dtype)


def test_record_collective_counts_in_the_registry():
    from paddle_tpu_torch import observability as obs
    with obs.telemetry_guard(True):
        obs.reset()
        qc.record_collective('dygraph_dp', 1000, 'int8', 2)
        qc.record_quant_error('dygraph_dp', torch.linspace(-1, 1, 600),
                              'int8')
        text = obs.registry.prometheus_text()
    assert 'collective_sync_calls' in text
    assert 'collective_bytes_on_wire' in text
    assert str(qc.wire_bytes(1000, 'int8', 2)) in text
    assert 'collective_quant_rel_error' in text


# --------------------------------------------------------- world of one

def _jax_loop(steps, x, y):
    """The JAX package's DataParallel loop, PaddleCV's recipe."""
    with jdy.guard():
        net = worker.small_net(jdy, jfluid.layers)
        model = jdy.DataParallel(net, jdy.prepare_context())
        opt = jfluid.optimizer.Momentum(
            jdy.CosineDecay(0.1, vr.IMAGENET_TRAIN_IMAGES // worker.BATCH,
                            vr.MOBILENET_V2_EPOCHS),
            momentum=0.9, parameter_list=model.parameters(),
            regularization=jfluid.regularizer.L2Decay(4e-5))
        for _ in range(steps):
            loss, _ = jfluid.layers.softmax_with_cross_entropy(
                model(jdy.to_variable(x)), jdy.to_variable(y),
                return_softmax=True)
            loss = model.scale_loss(jfluid.layers.mean(loss))
            loss.backward()
            model.apply_collective_grads()
            opt.minimize(loss)
            model.clear_gradients()
        return ({n: np.asarray(p.value) for n, p in model.named_parameters()},
                {n: np.asarray(b.value) for n, b in net.named_buffers()})


def _port_loop(steps, x, y, wrap):
    with dygraph.guard(CPU):
        net = worker.small_net()
        model = dygraph.DataParallel(net) if wrap else net
        opt = vr.mobilenet_v2_optimizer(model, worker.BATCH)
        xs, ys = torch.from_numpy(x), torch.from_numpy(y)
        for _ in range(steps):
            vr.data_parallel_step(model, opt, xs, ys)
        return ({n: p.detach().numpy().copy()
                 for n, p in model.named_parameters()},
                {n: b.numpy().copy() for n, b in net.named_buffers()})


def test_data_parallel_at_world_one_is_the_plain_loop_and_jax():
    x, y = worker.batch()
    dp = _port_loop(worker.STEPS, x, y, wrap=True)
    plain = _port_loop(worker.STEPS, x, y, wrap=False)
    jax_params, jax_bufs = _jax_loop(worker.STEPS, x, y)
    for got, want in zip(dp, plain):
        assert set(got) == set(want)
        for n in got:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert set(dp[0]) == set(jax_params) and set(dp[1]) == set(jax_bufs)
    for got, want in ((dp[0], jax_params), (dp[1], jax_bufs)):
        for n in got:
            np.testing.assert_allclose(got[n], want[n], atol=1e-5, rtol=0,
                                       err_msg=n)


def test_data_parallel_delegates_to_the_wrapped_layer():
    with dygraph.guard(CPU):
        net = worker.small_net()
        model = dygraph.DataParallel(net)
        assert model.parameters() == net.parameters()
        assert [n for n, _ in model.named_parameters()] == \
            [n for n, _ in net.named_parameters()]
        assert list(model.state_dict()) == list(net.state_dict())
        state = {k: v.numpy() * 0 for k, v in net.state_dict().items()}
        model.set_dict(state)
        assert all(float(p.abs().sum()) == 0 for p in net.parameters())
        assert model.load_dict == model.set_dict or \
            type(model).load_dict is type(model).set_dict
        loss = torch.tensor(3.0)
        assert model.scale_loss(loss) is loss
        assert model.apply_collective_grads() is None


def test_allreduce_bundles_one_call_per_gradient_type():
    from paddle_tpu_torch.dygraph.parallel import _allreduce_bundles
    ps = [torch.zeros(3, requires_grad=True), torch.zeros(2, 2,
                                                          requires_grad=True),
          torch.zeros(4, dtype=torch.float64, requires_grad=True),
          torch.zeros(1, requires_grad=True)]
    for i, p in enumerate(ps[:3]):
        p.grad = torch.full_like(p, float(i + 1))
    weird = ps[1].grad.t()                 # a transposed layout keeps it
    ps[1].grad = weird
    calls = _allreduce_bundles(ps, lambda flat: flat * 2, record=False)
    assert calls == 2
    assert ps[0].grad.tolist() == [2.0] * 3
    assert ps[1].grad is weird and ps[1].grad.stride() == (1, 2)
    assert torch.equal(ps[1].grad, torch.full((2, 2), 4.0))
    assert ps[2].grad.dtype == torch.float64
    assert ps[2].grad.tolist() == [6.0] * 4
    assert ps[3].grad is None


# ------------------------------------------ collectives without a group

def _x():
    return np.random.RandomState(5).standard_normal((1, 4)).astype(np.float32)


SINGLE = {
    'allreduce_sum': (lambda m, x: m.allreduce_sum(x), lambda x: x),
    'allreduce_mean': (lambda m, x: m.allreduce_mean(x), lambda x: x),
    'allreduce_max': (lambda m, x: m.allreduce_max(x), lambda x: x),
    'allreduce_min': (lambda m, x: m.allreduce_min(x), lambda x: x),
    'allgather': (lambda m, x: m.allgather(x), lambda x: x[None]),
    'reduce_scatter': (lambda m, x: m.reduce_scatter(x), lambda x: x[0]),
    'broadcast': (lambda m, x: m.broadcast(x, 0), lambda x: x),
    'alltoall': (lambda m, x: m.alltoall(x), lambda x: x),
    'ppermute': (lambda m, x: m.ppermute(x, [(0, 0)]), lambda x: x),
    'ppermute_none': (lambda m, x: m.ppermute(x, [(1, 2)]),
                      lambda x: 0 * x),
    'barrier': (lambda m, x: m.barrier(), lambda x: np.float32(0.0)),
}


@pytest.mark.parametrize('name', list(SINGLE))
def test_eager_collectives_without_a_group_c18(name):
    """The port's world-of-one meaning; the JAX eager collectives raise
    outside a ``shard_map`` (ROADMAP C.18)."""
    call, meaning = SINGLE[name]
    x = _x()
    got = call(collective, torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(got), meaning(x))
    with pytest.raises((NameError, NotImplementedError)):
        call(jcoll, jnp.asarray(x))


C_OPS = {
    'c_allreduce_sum': {'comm_dtype': 'int8'},
    'c_allreduce_max': {}, 'c_allreduce_min': {}, 'c_allreduce_prod': {},
    'c_allgather': {}, 'c_broadcast': {'root': 0}, 'c_reducescatter': {},
    'c_sync_calc_stream': None, 'c_sync_comm_stream': None}
JAX_IDENTITY = {'c_allreduce_sum', 'c_sync_calc_stream',
                'c_sync_comm_stream'}


@pytest.mark.parametrize('op', list(C_OPS) + ['c_allreduce_sum_bucket'])
def test_c_ops_are_the_identity_without_a_group(op):
    x = _x()
    if op == 'c_allreduce_sum_bucket':
        y = np.arange(5, dtype=np.float32)
        got = collective.c_allreduce_sum_bucket(
            [torch.from_numpy(x), torch.from_numpy(y)])
        want = jcoll.c_allreduce_sum_bucket([jnp.asarray(x), jnp.asarray(y)])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return
    attrs = C_OPS[op] or {}
    got = getattr(collective, op)(torch.from_numpy(x), **attrs)
    np.testing.assert_array_equal(got.numpy(), x)
    if op in JAX_IDENTITY:
        np.testing.assert_array_equal(
            np.asarray(getattr(jcoll, op)(jnp.asarray(x), **attrs)), x)
    else:
        with pytest.raises(NameError):
            getattr(jcoll, op)(jnp.asarray(x), **attrs)


def test_c_allreduce_sum_runs_in_a_static_program():
    from paddle_tpu_torch.layers.common import apply_op_layer
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        v = fluid.data('cx', [2, 3], 'float32')
        out = apply_op_layer('c_allreduce_sum', {'x': v}, {})
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = fluid.Executor(CPU).run(main, feed={'cx': x}, fetch_list=[out])[0]
    np.testing.assert_array_equal(got, x)


def test_sync_stats_at_world_one_is_the_plain_path():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.standard_normal((4, 3, 5, 5)).astype(np.float32))
    w, b = torch.rand(3), torch.rand(3)
    outs = []
    for sync in (False, True):
        xi = x.clone().requires_grad_(True)
        y, m, v = nn_ops.batch_norm(xi, w, b, torch.zeros(3), torch.ones(3),
                                    sync_stats=sync)
        y.backward(torch.ones_like(y))
        outs.append((y, m, v, xi.grad))
    for a, c in zip(*outs):
        assert torch.equal(a, c)


def test_parallel_executor_runs_a_program_and_refuses_trainers():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        v = fluid.data('px', [None, 3], 'float32')
        loss = fluid.layers.mean(fluid.layers.fc(v, 2))
        fluid.optimizer.SGD(0.1).minimize(loss)
    exe = fluid.Executor(CPU)
    exe.run(startup)
    pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                main_program=main)
    feed = {'px': np.ones((4, 3), np.float32)}
    first = pe.run([loss], feed=feed)[0]
    second = pe.run([loss.name], feed_dict=feed)[0]
    assert second < first
    pe.drop_local_exe_scopes()
    with pytest.raises(NotImplementedError, match='A.9'):
        fluid.ParallelExecutor(use_cuda=False, main_program=main,
                               num_trainers=2)


# ------------------------------------------------- two ranks on gloo

def run_fleet(mode, tmp_path, comm=None):
    env = {bootstrap.ENV_COORDINATOR: f'file://{tmp_path}/rendezvous'}
    if comm is not None:
        env[qc.ENV_COMM_DTYPE] = comm
    log = open(tmp_path / 'ranks.log', 'wb')
    try:
        fleet = bootstrap.local_fleet(worker.WORLD, WORKER,
                                      [mode, str(tmp_path)], env=env,
                                      stdout=log)
        rcs = fleet.wait(timeout=JOIN_TIMEOUT_S)
    finally:
        log.close()
    assert rcs == [0] * worker.WORLD, (
        rcs, (tmp_path / 'ranks.log').read_text()[-4000:])
    return [dict(np.load(tmp_path / f'rank{r}.npz'))
            for r in range(worker.WORLD)]


def _replay_qallreduce(xs, comm, bs=qc.DEFAULT_BLOCK_SIZE):
    """The two-phase quantized all-reduce of the ranks' ``xs``, replayed
    in one process with the JAX codec."""
    n = len(xs)
    size = xs[0].size
    chunk = -(-(-(-size // n)) // bs) * bs
    padded = chunk * n

    def enc(f):
        if comm == 'int8':
            q, s = jqc.block_quantize(jnp.asarray(f), bs)
            return np.asarray(jqc.block_dequantize(q, s, block_size=bs))
        return np.asarray(jnp.asarray(f).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    flats = [np.pad(x.reshape(-1), (0, padded - size)) for x in xs]
    # each rank encodes its whole padded copy (block scales per chunk)
    decoded = [enc(f).reshape(n, chunk) for f in flats]
    reduced = []
    for d in range(n):
        acc = decoded[0][d].copy()
        for r in range(1, n):
            acc = acc + decoded[r][d]
        reduced.append(enc(acc))
    return np.concatenate(reduced)[:size].reshape(xs[0].shape)


def _replay_qreduce_scatter(xs, comm, rank, bs=qc.DEFAULT_BLOCK_SIZE):
    n = len(xs)
    k = xs[0].shape[0] // n
    piece = xs[0][:k].size
    padded = -(-piece // bs) * bs

    def enc(f):
        if comm == 'int8':
            q, s = jqc.block_quantize(jnp.asarray(f), bs)
            return np.asarray(jqc.block_dequantize(q, s, block_size=bs))
        return np.asarray(jnp.asarray(f).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    rows = [enc(np.pad(x.reshape(n, piece), ((0, 0), (0, padded - piece)))
                .reshape(-1)).reshape(n, padded) for x in xs]
    acc = rows[0][rank].copy()
    for r in range(1, n):
        acc = acc + rows[r][rank]
    return acc[:piece].reshape((k,) + xs[0].shape[1:])


def test_two_ranks_eager_collectives(tmp_path):
    outs = run_fleet('collectives', tmp_path)
    xs = [worker.rank_input(r, (worker.WORLD, 6)).numpy()
          for r in range(worker.WORLD)]
    big = [worker.rank_input(r, (3, 700), seed=10).numpy()
           for r in range(worker.WORLD)]
    rs = [worker.rank_input(r, (4, 300), seed=20).numpy()
          for r in range(worker.WORLD)]
    total = xs[0] + xs[1]
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out['world'], [r, 2, 2])
        np.testing.assert_array_equal(out['allreduce_sum'], total)
        np.testing.assert_array_equal(out['allreduce_mean'], total / 2)
        np.testing.assert_array_equal(out['allreduce_max'],
                                      np.maximum(xs[0], xs[1]))
        np.testing.assert_array_equal(out['allreduce_min'],
                                      np.minimum(xs[0], xs[1]))
        np.testing.assert_array_equal(out['allgather'], np.stack(xs))
        np.testing.assert_array_equal(out['reduce_scatter'], total[r])
        np.testing.assert_array_equal(out['broadcast'], xs[1])
        np.testing.assert_array_equal(
            out['alltoall'], np.stack([xs[0][r], xs[1][r]]))
        np.testing.assert_array_equal(
            out['ppermute'], xs[0] if r == 1 else np.zeros_like(xs[0]))
        assert float(out['barrier']) == 0.0
        bf = np.stack([np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                                  .astype(jnp.float32)) for x in xs])
        np.testing.assert_array_equal(out['allgather_bf16'], bf)
        np.testing.assert_array_equal(out['qallreduce_sum_f32'],
                                      big[0] + big[1])
        np.testing.assert_array_equal(out['qallreduce_mean_f32'],
                                      (big[0] + big[1]) / 2)
        tile = (rs[0] + rs[1])[2 * r:2 * r + 2]
        np.testing.assert_array_equal(out['qreduce_scatter_sum_f32'], tile)
        for comm in ('bf16', 'int8'):
            want = _replay_qallreduce(big, comm)
            np.testing.assert_array_equal(out[f'qallreduce_sum_{comm}'],
                                          want, err_msg=comm)
            np.testing.assert_array_equal(out[f'qallreduce_mean_{comm}'],
                                          want / 2, err_msg=comm)
            np.testing.assert_array_equal(
                out[f'qreduce_scatter_sum_{comm}'],
                _replay_qreduce_scatter(rs, comm, r), err_msg=comm)
        np.testing.assert_array_equal(out['c_allreduce_max'],
                                      np.maximum(xs[0], xs[1]))
        np.testing.assert_array_equal(out['c_allreduce_min'],
                                      np.minimum(xs[0], xs[1]))
        np.testing.assert_array_equal(out['c_allreduce_prod'],
                                      xs[0] * xs[1])
        np.testing.assert_array_equal(out['c_allgather'],
                                      np.concatenate(xs))
        np.testing.assert_array_equal(out['c_broadcast'], xs[0])
        np.testing.assert_array_equal(out['c_reducescatter'], total[r])
        np.testing.assert_array_equal(out['c_allreduce_sum'],
                                      _replay_qallreduce(xs, 'int8'))
        bucket = [np.concatenate([x.reshape(-1), b.reshape(-1)])
                  for x, b in zip(xs, big)]
        np.testing.assert_array_equal(out['c_allreduce_sum_bucket'],
                                      _replay_qallreduce(bucket, 'bf16'))


def _replicas(comm):
    """Two replicas in one process: each its own batch half and BatchNorm
    buffers; the gradients summed (after the 1/2 loss scale) in rank
    order through the JAX codec at ``comm``, the same update on both."""
    x, y = worker.batch()
    half = worker.BATCH // worker.WORLD

    def codec(g):
        if comm == 'int8':
            q, s = jqc.block_quantize(jnp.asarray(g))
            return np.asarray(jqc.block_dequantize(q, s))[:g.size]
        if comm == 'bf16':
            return np.asarray(jnp.asarray(g).astype(jnp.bfloat16)
                              .astype(jnp.float32))
        return g
    with dygraph.guard(CPU):
        nets = [worker.small_net() for _ in range(worker.WORLD)]
        opts = [vr.mobilenet_v2_optimizer(n, worker.BATCH) for n in nets]
        for _ in range(worker.STEPS):
            for r, net in enumerate(nets):
                loss = vr.classification_loss(
                    net, torch.from_numpy(x[r * half:(r + 1) * half]),
                    torch.from_numpy(y[r * half:(r + 1) * half]))
                (loss * 0.5).backward()
            params = [list(net.parameters()) for net in nets]
            flats = [codec(torch.cat([p.grad.reshape(-1) for p in ps])
                           .numpy()) for ps in params]
            total = torch.from_numpy(flats[0] + flats[1])
            for ps in params:
                off = 0
                for p in ps:
                    p.grad = total[off:off + p.numel()].reshape(
                        p.shape).clone()
                    off += p.numel()
            for net, opt in zip(nets, opts):
                opt.minimize(None)
                net.clear_gradients()
        return [({n: p.detach().numpy().copy()
                  for n, p in net.named_parameters()},
                 {n: b.numpy().copy() for n, b in net.named_buffers()})
                for net in nets]


def _hold_to_replicas(outs, comm):
    witness = _replicas(comm)
    for r, out in enumerate(outs):
        params, bufs = witness[r]
        for n, v in params.items():
            np.testing.assert_allclose(out[f'param/{n}'], v, atol=1e-6,
                                       rtol=0, err_msg=f'rank {r} {n}')
        for n, v in bufs.items():
            np.testing.assert_allclose(out[f'buffer/{n}'], v, atol=1e-6,
                                       rtol=0, err_msg=f'rank {r} {n}')
    for k in outs[0]:
        if k.startswith(('param/', 'reduced')):
            np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
    assert not np.array_equal(outs[0]['buffer/bn._mean_buf'],
                              outs[1]['buffer/bn._mean_buf'])


def test_two_ranks_data_parallel_f32(tmp_path):
    outs = run_fleet('dp', tmp_path)
    for i in range(worker.STEPS):
        np.testing.assert_array_equal(
            outs[0][f'reduced{i}'],
            outs[0][f'local{i}'] + outs[1][f'local{i}'])
    _hold_to_replicas(outs, 'f32')


def test_two_ranks_data_parallel_quantized(tmp_path):
    for comm in ('bf16', 'int8'):
        (tmp_path / comm).mkdir()
        outs = run_fleet('dp', tmp_path / comm, comm)
        for i in range(worker.STEPS):
            locals_ = [out[f'local{i}'] for out in outs]
            if comm == 'int8':
                rows = []
                for f in locals_:
                    q, s = jqc.block_quantize(jnp.asarray(f))
                    rows.append(np.asarray(jqc.block_dequantize(q, s)))
                want = (rows[0] + rows[1])[:locals_[0].size]
            else:
                rows = [np.asarray(jnp.asarray(f).astype(jnp.bfloat16)
                                   .astype(jnp.float32)) for f in locals_]
                want = rows[0] + rows[1]
            for out in outs:
                np.testing.assert_array_equal(out[f'reduced{i}'], want,
                                              err_msg=f'{comm} step {i}')
        _hold_to_replicas(outs, comm)


def test_two_ranks_sync_batch_norm(tmp_path):
    outs = run_fleet('syncbn', tmp_path)
    from paddle_tpu.ops import nn_ops as jnn_ops
    x = worker.rank_input(0, worker.BN_SHAPE, seed=30).numpy()
    cot = worker.rank_input(0, worker.BN_SHAPE, seed=31).numpy()
    c = worker.BN_SHAPE[1]
    scale = worker.rank_input(0, (c,), seed=32).numpy()
    bias = worker.rank_input(0, (c,), seed=33).numpy()

    zeros, ones = jnp.zeros(c), jnp.ones(c)
    y, vjp = jax.vjp(
        lambda a, s, b: jnn_ops.batch_norm(a, s, b, zeros, ones,
                                           sync_stats=True)[0],
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    _, m, v = jnn_ops.batch_norm(jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), zeros, ones,
                                 sync_stats=True)
    dx, dscale, dbias = vjp(jnp.asarray(cot))
    half = worker.BN_SHAPE[0] // worker.WORLD
    for r, out in enumerate(outs):
        sl = slice(r * half, (r + 1) * half)
        np.testing.assert_allclose(out['y'], np.asarray(y)[sl], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(out['dx'], np.asarray(dx)[sl], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(out['mean'], np.asarray(m), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(out['variance'], np.asarray(v),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(outs[0]['dscale'] + outs[1]['dscale'],
                               np.asarray(dscale), atol=1e-5, rtol=0)
    np.testing.assert_allclose(outs[0]['dbias'] + outs[1]['dbias'],
                               np.asarray(dbias), atol=1e-5, rtol=0)


def test_static_batch_norm_sync_stats_runs_at_world_one():
    """The static layer's ``sync_stats`` reaches the op, which with no
    process group is the plain path."""
    x = np.random.RandomState(4).standard_normal((4, 3, 2, 2)).astype(
        np.float32)
    outs = []
    for sync in (False, True):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            v = fluid.data('bx', [4, 3, 2, 2], 'float32')
            y = fluid.layers.batch_norm(v, sync_stats=sync)
        exe = fluid.Executor(CPU)
        exe.run(startup)
        outs.append(exe.run(main, feed={'bx': x}, fetch_list=[y])[0])
    np.testing.assert_array_equal(outs[0], outs[1])


def test_launch_runs_in_process_or_spawns_ranks(tmp_path):
    script = tmp_path / 'rank.py'
    script.write_text(
        'import os, sys\n'
        'out = sys.argv[1]\n'
        'rank = os.environ.get("PADDLE_TRAINER_ID", "inproc")\n'
        'open(os.path.join(out, "r" + rank), "w").write(\n'
        '    os.environ.get("PADDLE_TRAINERS_NUM", "-"))\n')
    distributed.launch(str(script), [str(tmp_path)])
    assert (tmp_path / 'rinproc').read_text() == '-'
    distributed.launch(str(script), [str(tmp_path)], nproc_per_node=2)
    assert [(tmp_path / f'r{r}').read_text() for r in (0, 1)] == ['2', '2']


def test_local_fleet_kills_the_peers_of_a_failed_rank(tmp_path):
    script = tmp_path / 'fail.py'
    script.write_text(
        'import os, sys, time\n'
        'if os.environ["PADDLE_TRAINER_ID"] == "0":\n'
        '    sys.exit(3)\n'
        'time.sleep(60)\n')
    fleet = bootstrap.local_fleet(2, script)
    rcs = fleet.wait(timeout=JOIN_TIMEOUT_S)
    assert rcs[0] == 3 and rcs[1] != 0
    assert all(p.poll() is not None for p in fleet.procs)
    with pytest.raises(RuntimeError, match='return codes'):
        distributed.launch(str(script), [], nproc_per_node=2)
