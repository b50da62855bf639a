"""The port's static graph (paddle_tpu_torch/{framework, layers, nets,
backward, optimizer, executor}.py) against the JAX package's, on the CPU
(``CPUPlace`` in both), and the port's Executor semantics.

- The MNIST LeNet programs (``models/lenet.py:build_static_lenet``) built by
  both packages under SGD, Momentum and Adam hold the same ops, in order,
  with the same slots, and the same variables: names, shapes, types and
  persistability; the startup programs the same ``__init__`` ops.
- From the JAX startup values carried across by
  ``convert.scope_from_paddle`` (batch 8, ``numpy.random.RandomState``
  inputs): logits and loss within atol 1e-5 / rtol 1e-4 (f32 convolutions
  and products summed in another order); every ``@GRAD`` within atol 1e-6
  / rtol 1e-4; three steps of SGD(0.01), Momentum(0.01, 0.9) and
  Adam(0.001) with losses within rtol 1e-4, the persistables after the
  first step within atol 1e-5 for SGD and Momentum and 1e-4 for Adam
  (Adam steps each entry by about lr * m / sqrt(v), so where a gradient
  is near zero a difference of 1e-7 between the packages' gradients
  turns into a step of up to lr (1e-3) in either direction), and after
  every step each persistable no further (max |diff|) from a float64
  witness, the port's program cloned by ``tools/witness.as_float64`` and
  run from the same values, than twice the JAX package's distance from
  it plus a tenth of that atol after the first step, or plus what the
  witness moved in the step after a later one: a max pool near tie can
  route one f32 run's gradient elsewhere (ROADMAP C.11). Over JAX seeds
  0-9 the port reads at most 0.59 of these bounds, a first step 0.9x
  the port's at least 385x.
- ``gradients`` with respect to a fed input against the JAX package's.
- Initializers: shapes, types, bounds and moments (their values come from
  torch's generator, not the JAX PRNG).
- Executor semantics, mirroring tests/framework/test_executor_semantics.py
  on the port, plus the port's own rules: ``Executor()`` with no card
  raises, a scope value on another device raises and names the variable,
  and what is not ported raises ``NotImplementedError`` naming its ROADMAP
  item.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.models.lenet import build_static_lenet as jax_lenet
from paddle_tpu_torch.convert import scope_from_paddle
from paddle_tpu_torch.models.lenet import LeNet, build_static_lenet
from paddle_tpu_torch.tools.witness import as_float64
from torch_jax_seed import jax_seed_pinned  # noqa: F401

BATCH = 8


@pytest.fixture(autouse=True)
def fresh_port_programs():
    """Fresh default programs, scope and name counter of the port, as
    tests/conftest.py gives the JAX package's, so both packages name a
    program's variables alike."""
    import paddle_tpu_torch.core.scope as scope_mod
    from paddle_tpu_torch import framework
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.random import default_generator
    old = (framework._main_program_, framework._startup_program_,
           scope_mod._global_scope, unique_name.generator)
    framework._main_program_ = framework.Program()
    framework._startup_program_ = framework.Program()
    scope_mod._global_scope = scope_mod.Scope()
    unique_name.generator = unique_name.UniqueNameGenerator()
    default_generator.seed(0)
    yield
    (framework._main_program_, framework._startup_program_,
     scope_mod._global_scope, unique_name.generator) = old


OPTIMIZERS = {
    'sgd': lambda f: f.optimizer.SGD(learning_rate=0.01),
    'momentum': lambda f: f.optimizer.Momentum(learning_rate=0.01,
                                               momentum=0.9),
    'adam': lambda f: f.optimizer.Adam(learning_rate=0.001),
}


def build(pkg, builder, opt=None):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = pkg.layers.data('img', [1, 28, 28], dtype='float32')
        label = pkg.layers.data('label', [1], dtype='int64')
        loss, acc, logits = builder(img, label)
        if opt is not None:
            OPTIMIZERS[opt](pkg).minimize(loss)
    return main, startup, loss, acc, logits


def batch(seed=0, n=BATCH):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 1, 28, 28).astype(np.float32),
            rng.randint(0, 10, (n, 1)).astype(np.int64))


def persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


def carried_across(opt):
    """Both packages' LeNet under ``opt``, the JAX startup run on the CPU
    and its persistables copied into a port scope. Returns (jax side, port
    side), each (executor, scope, main, loss, acc, logits)."""
    jm, js, jl, ja, jlog = build(jfluid, jax_lenet, opt)
    tm, ts, tl, ta, tlog = build(fluid, build_static_lenet, opt)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    scope_from_paddle({n: np.asarray(jscope.find(n))
                       for n in persistables(jm)}, tscope, fluid.CPUPlace(),
                      program=tm)
    return ((jexe, jscope, jm, jl, ja, jlog),
            (texe, tscope, tm, tl, ta, tlog))


# ----------------------------------------------------------- program parity

def _ops(program):
    return [(op.type, op.inputs, op.outputs)
            for op in program.global_block().ops]


def _vars(program):
    return [(v.name, v.shape, v.dtype, v.persistable, v.is_data,
             type(v).__name__) for v in program.list_vars()]


@pytest.mark.parametrize('opt', sorted(OPTIMIZERS))
def test_lenet_main_program_matches_jax(opt):
    jm = build(jfluid, jax_lenet, opt)[0]
    tm = build(fluid, build_static_lenet, opt)[0]
    assert _ops(tm) == _ops(jm)
    assert _vars(tm) == _vars(jm)
    types = [op.type for op in tm.global_block().ops]
    assert types[:18] == [
        'conv2d', 'elementwise_add', 'relu', 'pool2d', 'conv2d',
        'elementwise_add', 'relu', 'pool2d', 'mul', 'elementwise_add',
        'relu', 'mul', 'elementwise_add', 'softmax_with_cross_entropy',
        'reduce_mean', 'softmax', 'accuracy', '__backward__']
    assert types[18:] == [opt] * 8


@pytest.mark.parametrize('opt', sorted(OPTIMIZERS))
def test_lenet_startup_program_matches_jax(opt):
    js = build(jfluid, jax_lenet, opt)[1]
    ts = build(fluid, build_static_lenet, opt)[1]
    assert _ops(ts) == _ops(js)
    assert _vars(ts) == _vars(js)
    assert {op.type for op in ts.global_block().ops} == {'__init__'}
    for jop, top in zip(js.global_block().ops, ts.global_block().ops):
        assert (type(top.attrs['initializer']).__name__
                == type(jop.attrs['initializer']).__name__)
        assert top.attrs['shape'] == jop.attrs['shape']
        assert top.attrs['dtype'] == jop.attrs['dtype']


def test_lenet_has_the_published_width():
    main = build(fluid, build_static_lenet)[0]
    n = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    assert n == 431080
    assert [p.name for p in main.all_parameters()] == [
        'conv2d_0.w_0', 'conv2d_0.b_0', 'conv2d_2.w_0', 'conv2d_2.b_0',
        'fc_0.w_0', 'fc_0.b_0', 'fc_1.w_0', 'fc_1.b_0']


# ----------------------------------------------------------- numeric parity

def test_lenet_forward_and_gradients_match_jax():
    (jexe, jscope, jm, jl, ja, jlog), (texe, tscope, tm, tl, ta, tlog) = \
        carried_across('sgd')
    x, y = batch(1)
    params = [p.name for p in tm.all_parameters()]
    fetch = [jlog.name, jl.name, ja.name] + [p + '@GRAD' for p in params]
    want = jexe.run(jm, feed={'img': x, 'label': y}, fetch_list=fetch,
                    scope=jscope)
    got = texe.run(tm, feed={'img': x, 'label': y}, fetch_list=fetch,
                   scope=tscope)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2])
    for name, g, w in zip(params, got[3:], want[3:]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-4,
                                   err_msg=name)


def lenet_witness(tm, start):
    """The port's LeNet program cloned to float64 (``as_float64``) in a
    scope of the same startup values: (executor, program, scope)."""
    m64 = as_float64(tm)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    scope_from_paddle({n: a.astype(m64.global_block().var(n).dtype)
                       for n, a in start.items()}, scope, fluid.CPUPlace(),
                      program=m64)
    return exe, m64, scope


def lenet_readings(got, want, wit, start, first_floor):
    """(step, name, port's max |diff| from the witness, bound) of each
    persistable after each step: twice the JAX package's distance from
    the witness plus a floor, ``first_floor`` after the first step and,
    after a later one, what the witness itself moved in that step (a max
    pool or ReLU near tie that one f32 run crosses and the other does not
    turns a step's gradient; JAX seed 1 under Momentum: one pool window of
    the second conv with a float64 margin of 1.8e-6, crossed in the port's
    third step)."""
    out = []
    prev = start
    for s, (g, w, x) in enumerate(zip(got, want, wit)):
        for n in x:
            floor = first_floor if s == 0 else np.abs(x[n] - prev[n]).max()
            out.append((s, n, np.abs(g[n] - x[n]).max(),
                        2 * np.abs(w[n] - x[n]).max() + floor))
        prev = x
    return out


@pytest.mark.parametrize('opt,param_atol', [('sgd', 1e-5),
                                            ('momentum', 1e-5),
                                            ('adam', 1e-4)])
def test_lenet_three_steps_match_jax(opt, param_atol):
    (jexe, jscope, jm, jl, _, _), (texe, tscope, tm, tl, _, _) = \
        carried_across(opt)
    names = persistables(tm)
    start = {n: tscope.find(n).numpy() for n in names}
    wexe, wm, wscope = lenet_witness(tm, start)
    want, got = [], []
    states = {'jax': [], 'port': [], 'witness': []}
    for step in range(3):
        x, y = batch(10 + step)
        want.append(jexe.run(jm, feed={'img': x, 'label': y},
                             fetch_list=[jl], scope=jscope)[0])
        got.append(texe.run(tm, feed={'img': x, 'label': y},
                            fetch_list=[tl], scope=tscope)[0])
        wexe.run(wm, feed={'img': x, 'label': y}, fetch_list=[tl.name],
                 scope=wscope)
        states['jax'].append({n: np.asarray(jscope.find(n)) for n in names})
        states['port'].append({n: tscope.find(n).numpy() for n in names})
        states['witness'].append({n: wscope.find(n).numpy()
                                  for n in names})
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the first step: each persistable within param_atol of the JAX
    # package's
    for name in names:
        np.testing.assert_allclose(
            states['port'][0][name], states['jax'][0][name],
            atol=param_atol, rtol=0, err_msg=name)
    # every step: against the float64 witness
    for s, name, reading, bound in lenet_readings(
            states['port'], states['jax'], states['witness'], start,
            param_atol / 10):
        assert reading <= bound, (s, name, reading, bound)
    assert texe.lowering_count(tm) == 1


def test_gradients_wrt_a_fed_input_match_jax():
    def build_grad(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data('x', [6], dtype='float32')
            h = pkg.layers.fc(x, 4, act='relu')
            out = pkg.layers.reduce_mean(pkg.layers.fc(h, 1))
            gx, = pkg.backward.gradients(out, [x])
        return main, startup, gx

    jm, js, jgx = build_grad(jfluid)
    tm, ts, tgx = build_grad(fluid)
    assert tgx.name == jgx.name == 'x@GRAD'
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    scope_from_paddle({n: np.asarray(jscope.find(n))
                       for n in persistables(jm)}, tscope, fluid.CPUPlace())
    x = np.random.RandomState(2).standard_normal((5, 6)).astype(np.float32)
    want = jexe.run(jm, feed={'x': x}, fetch_list=[jgx], scope=jscope)[0]
    got = texe.run(tm, feed={'x': x}, fetch_list=[tgx], scope=tscope)[0]
    assert got.shape == (5, 6)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_dygraph_lenet_matches_the_static_program():
    """The dygraph module on the static program's weights (fc weights
    (in, out) in both) gives the same logits."""
    main, startup, loss, acc, logits = build(fluid, build_static_lenet)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    x, y = batch(3)
    want = exe.run(main, feed={'img': x, 'label': y},
                   fetch_list=[logits])[0]
    s = fluid.global_scope()
    model = LeNet(device='cpu')
    with torch.no_grad():
        for mod, w, b in ((model.conv1, 'conv2d_0.w_0', 'conv2d_0.b_0'),
                          (model.conv2, 'conv2d_2.w_0', 'conv2d_2.b_0'),
                          (model.fc1, 'fc_0.w_0', 'fc_0.b_0'),
                          (model.fc2, 'fc_1.w_0', 'fc_1.b_0')):
            wt = s.find(w)
            mod.weight.copy_(wt)
            mod.bias.copy_(s.find(b))
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


# ----------------------------------------------------------- initializers

def _init(initializer, shape, dtype='float32'):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        fluid.layers.create_parameter(shape, dtype, name='w',
                                      default_initializer=initializer)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    w = fluid.global_scope().find('w')
    assert tuple(w.shape) == tuple(shape)
    assert w.device.type == 'cpu'
    return w


@pytest.mark.parametrize('dtype', ['float32', 'float64', 'int32'])
def test_constant_initializer(dtype):
    w = _init(fluid.initializer.Constant(3.0), [4, 5], dtype)
    assert w.dtype == getattr(torch, dtype)
    assert torch.all(w == 3)


def test_uniform_initializer_bounds_and_moments():
    w = _init(fluid.initializer.Uniform(-0.5, 1.5), [200, 300]).double()
    assert w.min() >= -0.5 and w.max() < 1.5
    assert abs(w.mean().item() - 0.5) < 0.01
    assert abs(w.var().item() - 4 / 12) < 0.01


def test_normal_initializer_moments():
    w = _init(fluid.initializer.Normal(1.0, 2.0), [200, 300]).double()
    assert abs(w.mean().item() - 1.0) < 0.03
    assert abs(w.std().item() - 2.0) < 0.03


def test_truncated_normal_initializer_bounds_and_moments():
    w = _init(fluid.initializer.TruncatedNormal(0.0, 1.0), [200, 300])
    w = w.double()
    assert w.min() >= -2.0 and w.max() <= 2.0
    assert abs(w.mean().item()) < 0.01
    # the variance of N(0, 1) cut at +-2
    assert abs(w.var().item() - 0.7737) < 0.01


@pytest.mark.parametrize('uniform', [True, False])
def test_xavier_initializer(uniform):
    shape = [300, 500]
    w = _init(fluid.initializer.Xavier(uniform=uniform), shape).double()
    std = np.sqrt(2.0 / (300 + 500))
    if uniform:
        assert w.abs().max() <= np.sqrt(6.0 / 800)
    assert abs(w.std().item() - std) < 0.02 * std


@pytest.mark.parametrize('uniform', [True, False])
def test_msra_initializer(uniform):
    shape = [64, 32, 3, 3]           # fan_in 32 * 9
    w = _init(fluid.initializer.MSRA(uniform=uniform), shape).double()
    std = np.sqrt(2.0 / (32 * 9))
    if uniform:
        assert w.abs().max() <= np.sqrt(6.0 / (32 * 9))
    assert abs(w.std().item() - std) < 0.02 * std


def test_numpy_array_initializer_and_seeded_streams():
    v = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(
        _init(fluid.initializer.NumpyArray(v), [2, 3]).numpy(), v)
    a = _init(fluid.initializer.Normal(seed=7), [50])
    b = _init(fluid.initializer.Normal(seed=7), [50])
    assert torch.equal(a, b)         # a nonzero seed pins the stream


# ----------------------------------------------------------- executor

def _linear_prog(name):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data(f'{name}_x', [-1, 3], 'float32')
        out = fluid.layers.fc(x, 2, param_attr=fluid.ParamAttr(
            name=f'{name}_w',
            initializer=fluid.initializer.ConstantInitializer(1.0)),
            bias_attr=False)
    return main, startup, out


def cpu_exe():
    return fluid.Executor(fluid.CPUPlace())


def test_scope_isolation():
    main, startup, out = _linear_prog('si')
    exe = cpu_exe()
    s1, s2 = fluid.Scope(), fluid.Scope()
    x = np.ones((2, 3), 'float32')
    with fluid.scope_guard(s1):
        exe.run(startup)
        r1 = exe.run(main, feed={'si_x': x}, fetch_list=[out])[0]
        fluid.global_scope().set('si_w', torch.zeros(3, 2))
        r1z = exe.run(main, feed={'si_x': x}, fetch_list=[out])[0]
    with fluid.scope_guard(s2):
        exe.run(startup)
        r2 = exe.run(main, feed={'si_x': x}, fetch_list=[out])[0]
    np.testing.assert_allclose(r1, 3.0)
    np.testing.assert_allclose(r1z, 0.0)     # s1 was mutated
    np.testing.assert_allclose(r2, 3.0)      # s2 unaffected


def test_a_new_feed_shape_lowers_again():
    main, startup, out = _linear_prog('vs')
    exe = cpu_exe()
    exe.run(startup)
    counts = []
    for b in (1, 4, 7, 4):
        r = exe.run(main, feed={'vs_x': np.ones((b, 3), 'float32')},
                    fetch_list=[out])[0]
        assert r.shape == (b, 2)
        np.testing.assert_allclose(r, 3.0)
        counts.append(exe.lowering_count(main))
    assert counts == [1, 2, 3, 3]


def test_program_edit_invalidates_cache():
    main, startup, out = _linear_prog('pe')
    exe = cpu_exe()
    exe.run(startup)
    x = np.ones((2, 3), 'float32')
    r1 = exe.run(main, feed={'pe_x': x}, fetch_list=[out])[0]
    with fluid.program_guard(main, startup):
        out2 = fluid.layers.scale(out, scale=10.0)
    r2 = exe.run(main, feed={'pe_x': x}, fetch_list=[out2])[0]
    np.testing.assert_allclose(r1, 3.0)
    np.testing.assert_allclose(r2, 30.0)
    assert exe.lowering_count(main) == 2


def test_two_programs_interleaved_shared_scope():
    m1, s1, o1 = _linear_prog('tp1')
    m2, s2, o2 = _linear_prog('tp2')
    exe = cpu_exe()
    exe.run(s1)
    exe.run(s2)
    x = np.ones((2, 3), 'float32')
    for _ in range(2):
        r1 = exe.run(m1, feed={'tp1_x': x}, fetch_list=[o1])[0]
        r2 = exe.run(m2, feed={'tp2_x': 2 * x}, fetch_list=[o2])[0]
    np.testing.assert_allclose(r1, 3.0)
    np.testing.assert_allclose(r2, 6.0)
    assert exe.lowering_count(m1) == exe.lowering_count(m2) == 1


def test_fetch_by_name_and_by_var_and_empty():
    main, startup, out = _linear_prog('fn')
    exe = cpu_exe()
    exe.run(startup)
    x = np.ones((2, 3), 'float32')
    by_var = exe.run(main, feed={'fn_x': x}, fetch_list=[out])[0]
    by_name = exe.run(main, feed={'fn_x': x}, fetch_list=[out.name])[0]
    np.testing.assert_allclose(by_var, by_name)
    assert exe.run(main, feed={'fn_x': x}) == []
    t = exe.run(main, feed={'fn_x': x}, fetch_list=[out],
                return_numpy=False)[0]
    assert isinstance(t, torch.Tensor) and not t.requires_grad


def test_feed_dtype_coercion():
    """float64 and int feeds take the declared variable's type."""
    main, startup, out = _linear_prog('dc')
    exe = cpu_exe()
    exe.run(startup)
    for x in (np.ones((2, 3), 'float64'), np.ones((2, 3), 'int64'),
              [[1, 1, 1], [1, 1, 1]]):
        r = exe.run(main, feed={'dc_x': x}, fetch_list=[out])[0]
        assert r.dtype == np.float32
        np.testing.assert_allclose(r, 3.0)


def test_uninitialized_persistable_raises():
    main, startup, out = _linear_prog('up')
    exe = cpu_exe()
    with fluid.scope_guard(fluid.Scope()):
        with pytest.raises(RuntimeError, match='uninitialized'):
            exe.run(main, feed={'up_x': np.ones((2, 3), 'float32')},
                    fetch_list=[out])


def test_startup_runs_idempotent():
    main, startup, out = _linear_prog('ip')
    exe = cpu_exe()
    exe.run(startup)
    w1 = fluid.global_scope().find('ip_w').clone()
    exe.run(startup)      # re-init: constant init -> same values
    assert torch.equal(w1, fluid.global_scope().find('ip_w'))


def test_clone_for_test_shares_params():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data('cl_x', [4, 3], 'float32')
        h = fluid.layers.fc(x, 4, name='cl_fc')
        h = fluid.layers.dropout(h, 0.5)
        loss = fluid.layers.reduce_mean(h)
        fluid.optimizer.SGD(0.1).minimize(loss)
    test_prog = main.clone(for_test=True)
    types = [op.type for op in test_prog.global_block().ops]
    assert '__backward__' not in types and 'sgd' not in types
    assert test_prog.global_block().ops[-2].attrs['is_test'] is True
    exe = cpu_exe()
    exe.run(startup)
    x = np.ones((4, 3), 'float32')
    # deterministic in test mode: two runs agree
    r1 = exe.run(test_prog, feed={'cl_x': x}, fetch_list=[loss])[0]
    r2 = exe.run(test_prog, feed={'cl_x': x}, fetch_list=[loss])[0]
    np.testing.assert_allclose(r1, r2)
    # training updates the shared parameter; the test program sees it
    exe.run(main, feed={'cl_x': x}, fetch_list=[loss])
    r3 = exe.run(test_prog, feed={'cl_x': x}, fetch_list=[loss])[0]
    assert not np.allclose(r1, r3)


def test_prune_keeps_only_needed_ops():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data('pr_x', [2, 3], 'float32')
        a = fluid.layers.scale(x, scale=2.0)
        fluid.layers.scale(x, scale=3.0)     # dead for fetch=a
    pruned = main._prune([a])
    assert [op.type for op in pruned.global_block().ops] == ['scale']
    exe = cpu_exe()
    exe.run(startup)
    r = exe.run(pruned, feed={'pr_x': np.ones((2, 3), 'float32')},
                fetch_list=[a])[0]
    np.testing.assert_allclose(r, 2.0)


def test_executor_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for place in (None, fluid.CUDAPlace(0), fluid.TPUPlace(0),
                  fluid.XLAPlace(0)):
        with pytest.raises(RuntimeError, match='CUDA'):
            fluid.Executor(place)
    assert cpu_exe().device == torch.device('cpu')


def test_a_scope_value_on_another_device_raises():
    main, startup, out = _linear_prog('od')
    exe = cpu_exe()
    exe.run(startup)
    fluid.global_scope().set('od_w', torch.empty(3, 2, device='meta'))
    with pytest.raises(ValueError, match="'od_w' lies on meta"):
        exe.run(main, feed={'od_x': np.ones((2, 3), 'float32')},
                fetch_list=[out])


def test_what_is_not_ported_raises_naming_its_roadmap_item():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data('np_x', [2, 3], 'float32')
        with pytest.raises(NotImplementedError, match='A.10'):
            fluid.layers.logsumexp(x)      # its op is not registered
        with pytest.raises(NotImplementedError, match='A.10'):
            fluid.layers.common.apply_op_layer('lstm', {'x': x})
        main.global_block().append_op('__backward__',
                                      attrs={'pipeline': {'stages': 2}})
    with pytest.raises(NotImplementedError, match='A.9'):
        cpu_exe().run(main, feed={'np_x': np.ones((2, 3), 'float32')})
    with pytest.raises(NotImplementedError, match='A.9'):
        fluid.optimizer.PipelineOptimizer(fluid.optimizer.Adam(0.001))
    with pytest.raises(NotImplementedError, match='A.11'):
        cpu_exe().train_from_dataset(main)
