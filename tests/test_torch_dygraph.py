"""The port's dygraph API (paddle_tpu_torch/dygraph/{base, tape, layers,
container, nn, learning_rate_scheduler, checkpoint}.py, layers/common.py's
eager branch, optimizer.py's dygraph path and the Transformer's ops)
against the JAX package's, on the CPU (``guard(CPUPlace())`` in the port,
the JAX package's CPU backend).

- ``guard()`` with no card raises; ``guard(CPUPlace())`` runs;
  ``in_dygraph_mode()`` follows the guard, nested ones too.
- ``fluid.layers.*`` run eagerly under ``guard`` and give the JAX
  package's values: atol 1e-6 (one f32 op each).
- The VarBase API: the JAX package's tests/dygraph/test_tape.py cases on
  the port (backward, accumulation, ``stop_gradient``, ``no_grad``,
  convergence of a Linear under SGD and Adam, a finite-difference check at
  rtol/atol 1e-2 as there), and ``numpy`` on a tensor that requires grad,
  ``gradient``, ``clear_gradient``, ``detach``, ``astype``, ``grad``.
- The Layer API: the JAX package's test_layers_api.py cases (hooks in
  order and silenced by ``remove()``, containers, ``train``/``eval``,
  ``state_dict`` round trips), parameter names equal to the JAX package's
  for the same construction, and torch's own machinery (``.to``,
  ``load_state_dict``, ``copy.deepcopy``) on a Layer.
- The nine learning-rate schedules equal the JAX package's over 50 steps
  (rtol 1e-12: the same float arithmetic), and drive an optimizer.
- ``save_dygraph``/``load_dygraph`` files carry across both ways, exactly.
- Each op the Transformer adds (``lookup_table`` with ``padding_idx``,
  ``layer_norm``, ``log_softmax``, ``transpose``, ``one_hot``,
  ``not_equal``, ``reduce_sum``) against the JAX op: values and gradients
  at atol 1e-6.
- What is not ported raises ``NotImplementedError`` naming its ROADMAP
  item.
"""
import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import dygraph as jdy
from paddle_tpu import layers as jlayers
from paddle_tpu_torch import dygraph, layers
from paddle_tpu_torch.dygraph import to_variable
import torch_jax_seed  # noqa: F401  (caps torch's threads)

CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_port_names():
    """A fresh name counter and seed for the port, as tests/conftest.py
    gives the JAX package, so both name parameters alike."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.random import default_generator
    old = unique_name.generator
    unique_name.generator = unique_name.UniqueNameGenerator()
    default_generator.seed(0)
    yield
    unique_name.generator = old


# ------------------------------------------------------------------ guard

def test_guard_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        with dygraph.guard():
            pass
    with pytest.raises(RuntimeError, match='no CUDA device'):
        to_variable(np.ones(2, np.float32))
    assert not fluid.in_dygraph_mode()


def test_guard_on_the_cpu_runs_and_sets_the_mode():
    assert not fluid.in_dygraph_mode() and not dygraph.enabled()
    with dygraph.guard(CPU):
        assert fluid.in_dygraph_mode() and dygraph.enabled()
        with dygraph.guard('cpu'):
            assert fluid.in_dygraph_mode()
        assert fluid.in_dygraph_mode()
        t = to_variable(np.arange(6, dtype=np.int64).reshape(2, 3))
        assert t.device.type == 'cpu' and t.dtype == torch.int64
        assert t.stop_gradient and isinstance(t, dygraph.Tensor)
    assert not fluid.in_dygraph_mode()
    fluid.enable_dygraph(CPU)
    assert fluid.in_dygraph_mode()
    fluid.disable_dygraph()
    assert not fluid.in_dygraph_mode()


def test_eager_kernel_cache_hatches_are_no_ops():
    with dygraph.guard(CPU):
        dygraph.set_eager_kernel_cache(False, maxsize=4)
        with dygraph.eager_kernel_cache_guard(True):
            x = to_variable(np.ones(3, np.float32))
        assert float(layers.reduce_sum(x).numpy()) == 3.0


# (name, port call, JAX call) of layer functions run eagerly
_A = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
_B = np.random.default_rng(1).standard_normal((4, 5)).astype(np.float32)
EAGER_LAYERS = {
    'reduce_mean': lambda L, v: L.reduce_mean(v(_A)),
    'reduce_sum_dim': lambda L, v: L.reduce_sum(v(_A), dim=1),
    'softmax': lambda L, v: L.softmax(v(_A)),
    'matmul': lambda L, v: L.matmul(v(_A), v(_B), alpha=0.5),
    'elementwise_add': lambda L, v: L.elementwise_add(v(_A), v(_A[0])),
    'scale': lambda L, v: L.scale(v(_A), scale=2.0, bias=1.0),
    'cast': lambda L, v: L.cast(v(_A), 'int32'),
    'fill_constant': lambda L, v: L.fill_constant([2, 3], 'float32', 1.5),
    'transpose': lambda L, v: L.transpose(v(_A), perm=[1, 0]),
    'log_softmax': lambda L, v: L.log_softmax(v(_A)),
}


@pytest.mark.parametrize('name', list(EAGER_LAYERS))
def test_layer_functions_run_eagerly_and_match_jax(name):
    fn = EAGER_LAYERS[name]
    with jdy.guard():
        want = np.asarray(fn(jlayers, jdy.to_variable).numpy())
    with dygraph.guard(CPU):
        got = fn(layers, to_variable)
        assert isinstance(got, dygraph.Tensor)
        got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ------------------------------------------------------------- the tape

def test_basic_backward():
    with dygraph.guard(CPU):
        x = dygraph.Parameter(np.array([2.0, 3.0], np.float32))
        y = x * x + x
        assert isinstance(y, dygraph.Tensor)
        loss = dygraph.dispatch_op('reduce_sum', {'x': y}, {})
        loss.backward()
        np.testing.assert_allclose(x.gradient(), [5.0, 7.0], rtol=1e-6)
        x.clear_gradient()
        assert x.gradient() is None and x.grad is None


def test_grad_accumulation_two_uses():
    with dygraph.guard(CPU):
        x = dygraph.Parameter(np.array([1.0], np.float32))
        loss = dygraph.dispatch_op('reduce_sum', {'x': x * 3.0 + x * 4.0},
                                   {})
        loss.backward()
        np.testing.assert_allclose(x.gradient(), [7.0], rtol=1e-6)


def test_stop_gradient_blocks_and_is_settable():
    with dygraph.guard(CPU):
        x = dygraph.Parameter(np.array([1.0], np.float32))
        y = to_variable(np.array([2.0], np.float32))
        assert y.stop_gradient and not x.stop_gradient
        loss = dygraph.dispatch_op('reduce_sum', {'x': x * y}, {})
        loss.backward()
        np.testing.assert_allclose(x.gradient(), [2.0])
        assert y.grad is None
        y.stop_gradient = False
        assert y.requires_grad
        x.trainable = False
        assert x.stop_gradient and not x.trainable
        with pytest.raises(RuntimeError, match='detach'):
            (y * 2.0).stop_gradient = True


def test_no_grad_context_and_decorator():
    with dygraph.guard(CPU):
        x = dygraph.Parameter(np.array([1.0], np.float32))
        with dygraph.no_grad_guard():
            y = x * 2.0
        assert y.grad_fn is None and y.stop_gradient
        with dygraph.no_grad():
            assert not dygraph.tape.grad_enabled()

        @dygraph.no_grad
        def f(t):
            return t * 3.0
        assert f(x).stop_gradient


def test_no_grad_guard_is_thread_local():
    entered, release = threading.Event(), threading.Event()

    def worker():
        with dygraph.no_grad_guard():
            entered.set()
            release.wait(timeout=10)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    assert entered.wait(timeout=10)
    try:
        with dygraph.guard(CPU):
            w = dygraph.Parameter(np.ones((3, 2), np.float32))
            out = dygraph.dispatch_op(
                'matmul', {'x': to_variable(np.ones((2, 3), np.float32)),
                           'y': w}, {})
            dygraph.dispatch_op('reduce_sum', {'x': out}, {}).backward()
            assert w.gradient() is not None
    finally:
        release.set()
        t.join(timeout=10)


def test_tensor_methods():
    with dygraph.guard(CPU):
        p = dygraph.Parameter(np.array([[1.5, -2.0]], np.float32),
                              name='p0')
        assert p.name == 'p0' and p.persistable and p.trainable
        np.testing.assert_array_equal(p.numpy(), [[1.5, -2.0]])
        out = p * 2.0
        assert out.requires_grad
        np.testing.assert_array_equal(out.numpy(), [[3.0, -4.0]])
        d = out.detach()
        assert isinstance(d, dygraph.Tensor) and d.stop_gradient
        i = out.astype('int32')
        assert i.dtype == torch.int32 and isinstance(i, dygraph.Tensor)
        b = p.astype('bfloat16')
        assert b.numpy().dtype == np.float32
        p.set_value(np.array([[0.5, 0.25]], np.float32))
        np.testing.assert_array_equal(p.numpy(), [[0.5, 0.25]])
        np.testing.assert_array_equal(np.asarray(out.detach()),
                                      [[3.0, -4.0]])
        t = dygraph.Tensor(np.zeros(3, np.float32), name='t0')
        assert t.name == 't0' and not t.stop_gradient
        c = copy.deepcopy(p)
        assert type(c) is dygraph.Parameter and c.name == 'p0'
        assert c is not p and torch.equal(c, p)


def test_partial_grad_with_create_graph():
    with dygraph.guard(CPU):
        x = dygraph.Parameter(np.array([3.0], np.float32))
        y = x * x * x
        (g,) = dygraph.grad(y, x, create_graph=True)
        np.testing.assert_allclose(g.numpy(), [27.0])
        (g2,) = dygraph.grad(g, x)
        np.testing.assert_allclose(g2.numpy(), [18.0])
    # no_grad_vars stops the path through x * x (and through x itself),
    # as the JAX package's grad does: exact
    got = {}
    for pkg, place in ((dygraph, CPU), (jdy, None)):
        with pkg.guard(place):
            x = pkg.Parameter(np.array([3.0], np.float32)) \
                if pkg is dygraph else pkg.to_variable(
                    np.array([3.0], np.float32))
            x.stop_gradient = False
            sq = x * x
            y = sq * x
            got[pkg] = [pkg.grad(y, x, retain_graph=True,
                                 no_grad_vars=v)[0].numpy()
                        for v in ([sq], sq, [x], None)]
    for a, b in zip(got[dygraph], got[jdy]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(got[dygraph]),
                                  [9.0, 9.0, 0.0, 27.0])


def test_finite_difference_matmul_grad():
    with dygraph.guard(CPU):
        rng = np.random.default_rng(3)
        w = dygraph.Parameter(rng.standard_normal((3, 2)).astype(np.float32))
        x = to_variable(rng.standard_normal((4, 3)).astype(np.float32))
        out = dygraph.dispatch_op('matmul', {'x': x, 'y': w}, {})
        dygraph.dispatch_op('reduce_sum', {'x': out}, {}).backward()
        g = w.gradient()
        eps = 1e-3
        for i in range(3):
            for j in range(2):
                wp, wm = w.numpy().copy(), w.numpy().copy()
                wp[i, j] += eps
                wm[i, j] -= eps
                fd = (np.sum(x.numpy() @ wp) - np.sum(x.numpy() @ wm)) \
                    / (2 * eps)
                np.testing.assert_allclose(g[i, j], fd, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize('opt', ['sgd', 'adam'])
def test_linear_training_converges(opt):
    rng = np.random.default_rng(1)
    with dygraph.guard(CPU):
        model = dygraph.Linear(8, 1)
        params = model.parameters()
        optimizer = (fluid.optimizer.SGD(0.1, parameter_list=params)
                     if opt == 'sgd' else
                     fluid.optimizer.Adam(0.05, parameter_list=params))
        w_true = rng.standard_normal((8, 1)).astype(np.float32)
        losses = []
        for _ in range(60):
            xv = rng.standard_normal((16, 8)).astype(np.float32)
            diff = model(to_variable(xv)) - to_variable(xv @ w_true)
            loss = layers.reduce_mean(diff * diff)
            loss.backward()
            optimizer.minimize(loss)
            model.clear_gradients()
            losses.append(float(loss.numpy()))
        assert losses[-1] < losses[0] * 0.1


def test_conv_bn_pool_shapes_and_batchnorm_eval():
    rng = np.random.default_rng(4)
    with dygraph.guard(CPU):
        conv = dygraph.Conv2D(3, 8, 3, padding=1)
        bn = dygraph.BatchNorm(8)
        pool = dygraph.Pool2D(2, 'max', 2)
        x = to_variable(rng.standard_normal((2, 3, 16, 16)).astype(
            np.float32) + 3.0)
        y = pool(bn(conv(x)))
        assert y.shape == (2, 8, 8, 8)
        trained = bn._mean.numpy().copy()
        assert not np.array_equal(trained, np.zeros(8))
        bn.eval()
        bn(conv(x))
        np.testing.assert_array_equal(bn._mean.numpy(), trained)
        assert sorted(bn.state_dict()) == ['_mean_buf', '_variance_buf',
                                           'bias', 'weight']


# ------------------------------------------------------------ Layer API

def test_forward_hooks_fire_in_order_and_remove_silences_them():
    events = []
    with dygraph.guard(CPU):
        fc = dygraph.nn.Linear(3, 2)

        def pre(layer, inputs):
            events.append('pre')

        def post(layer, inputs, output):
            events.append('post')
            return output * 2.0

        h1 = fc.register_forward_pre_hook(pre)
        h2 = fc.register_forward_post_hook(post)
        x = to_variable(np.ones((1, 3), np.float32))
        doubled = fc(x).numpy()
        assert events == ['pre', 'post']
        h1.remove()
        h2.remove()
        np.testing.assert_allclose(fc(x).numpy() * 2.0, doubled)
        assert events == ['pre', 'post']


def test_containers():
    with dygraph.guard(CPU):
        seq = dygraph.Sequential(dygraph.nn.Linear(4, 8, act='relu'),
                                 dygraph.nn.Linear(8, 2))
        out = seq(to_variable(np.ones((2, 4), np.float32)))
        assert out.shape == (2, 2) and len(seq) == 2
        assert len(seq.parameters()) == 4
        named = dygraph.Sequential([('a', dygraph.Linear(2, 2)),
                                    ('b', dygraph.Linear(2, 2))])
        assert [n for n, _ in named.named_sublayers()] == ['a', 'b']
        ll = dygraph.LayerList([dygraph.nn.Linear(2, 2) for _ in range(3)])
        ll.append(dygraph.nn.Linear(2, 2))
        ll.insert(0, dygraph.nn.Linear(2, 2))
        assert len(ll) == 5 and len(ll.parameters()) == 10
        assert ll[-1] is list(ll)[-1] and len(ll[1:3]) == 2
        m = dygraph.Layer()
        pl = dygraph.ParameterList([m.create_parameter([2, 2])
                                    for _ in range(2)])
        pl.append(m.create_parameter([3], is_bias=True))
        assert len(pl.parameters()) == 3 and pl[-1].shape == (3,)
        assert not pl[-1].numpy().any()


def test_train_eval_propagate():
    with dygraph.guard(CPU):
        m = dygraph.Sequential(dygraph.Linear(2, 2),
                               dygraph.Sequential(dygraph.Dropout(0.5)))
        m.eval()
        assert all(not s.training for _, s in m.named_sublayers())
        m.train()
        assert all(s.training for _, s in m.named_sublayers())
        m.train(False)
        assert not m.training and not m[1][0].training


def _build_layers(dy):
    """The same layers built by either package's dygraph."""
    return [dy.Linear(3, 2), dy.Conv2D(2, 4, 3), dy.BatchNorm(4),
            dy.Embedding([10, 3], padding_idx=0), dy.LayerNorm([3]),
            dy.Linear(2, 2, bias_attr=False)]


def test_parameter_names_and_shapes_equal_the_jax_packages():
    with jdy.guard():
        want = [[(n, p.name, tuple(p.shape)) for n, p in
                 layer.named_parameters()] for layer in _build_layers(jdy)]
    with dygraph.guard(CPU):
        got = [[(n, p.name, tuple(p.shape)) for n, p in
                layer.named_parameters()] for layer in _build_layers(dygraph)]
    assert got == want


def test_state_dict_round_trips_and_torch_machinery():
    with dygraph.guard(CPU):
        m = dygraph.Sequential(dygraph.Linear(3, 4), dygraph.BatchNorm(4))
        m2 = dygraph.Sequential(dygraph.Linear(3, 4), dygraph.BatchNorm(4))
        sd = m.state_dict()
        assert list(sd) == ['0.weight', '0.bias', '1.weight', '1.bias',
                            '1._mean_buf', '1._variance_buf']
        assert isinstance(sd['0.weight'], dygraph.Tensor)
        m2.set_dict({k: v.numpy() for k, v in sd.items()})
        for (k1, v1), (k2, v2) in zip(m.state_dict().items(),
                                      m2.state_dict().items()):
            assert k1 == k2 and torch.equal(v1, v2)
        assert list(m.state_dict(include_sublayers=False)) == []
        m3 = copy.deepcopy(m)
        m3.load_state_dict(m.state_dict())
        assert torch.equal(m3[0].weight, m[0].weight)
        assert type(m3[0].weight) is dygraph.Parameter
        m.to(torch.float64)
        assert m[0].weight.dtype == torch.float64
        assert type(m[0].weight) is dygraph.Parameter
        m.clear_gradients()


def test_layer_outputs_carry_the_paddle_methods():
    with dygraph.guard(CPU):
        fc = dygraph.Linear(3, 2)
        out = fc(to_variable(np.ones((1, 3), np.float32)))
        assert isinstance(out, dygraph.Tensor) and out.requires_grad
        assert out.numpy().shape == (1, 2)


# ------------------------------------------------------------ schedules

SCHEDULES = {
    'PiecewiseDecay': dict(boundaries=[3, 10, 30],
                           values=[0.1, 0.05, 0.01, 0.001]),
    'NaturalExpDecay': dict(learning_rate=0.1, decay_steps=5,
                            decay_rate=0.5, staircase=True),
    'ExponentialDecay': dict(learning_rate=0.1, decay_steps=4,
                             decay_rate=0.9),
    'InverseTimeDecay': dict(learning_rate=0.1, decay_steps=3,
                             decay_rate=0.5),
    'PolynomialDecay': dict(learning_rate=0.1, decay_steps=20,
                            end_learning_rate=0.001, power=2.0, cycle=True),
    'CosineDecay': dict(learning_rate=0.1, step_each_epoch=7, epochs=5),
    'LinearLrWarmup': dict(learning_rate=0.05, warmup_steps=10,
                           start_lr=0.0, end_lr=0.05),
    'NoamDecay': dict(d_model=64, warmup_steps=8),
    'LearningRateDecay': None,
}


@pytest.mark.parametrize('name', list(SCHEDULES))
def test_schedule_values_equal_the_jax_packages(name):
    from paddle_tpu.dygraph import learning_rate_scheduler as jsched
    from paddle_tpu_torch.dygraph import learning_rate_scheduler as psched
    kw = SCHEDULES[name]
    if kw is None:       # the base class: a subclass's create_lr_var
        def make(mod):
            cls = type('Halving', (mod.LearningRateDecay,),
                       {'create_lr_var': lambda self, n: 0.5 ** n})
            return cls(begin=2, step=3)
    else:
        def make(mod):
            return getattr(mod, name)(**kw)
    want_s, got_s = make(jsched), make(psched)
    want, got = [], []
    for _ in range(50):
        want.append(want_s())
        got.append(got_s())
        want_s.step()
        got_s.step()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert len(set(got)) > 1


def test_linear_warmup_steps_the_schedule_it_wraps():
    s = dygraph.LinearLrWarmup(dygraph.NoamDecay(64, 4), 3, 0.0, 0.01)
    for _ in range(5):
        s.step()
    assert s.lr.step_num == 6 and s() == s.lr()


def test_optimizer_reads_then_steps_the_schedule():
    with dygraph.guard(CPU):
        sched = dygraph.PiecewiseDecay([2, 4], [0.1, 0.01, 0.001], 0)
        fc = dygraph.Linear(2, 1)
        opt = fluid.optimizer.SGD(learning_rate=sched,
                                  parameter_list=fc.parameters())
        seen = []
        for _ in range(5):
            before = fc.weight.numpy().copy()
            loss = layers.reduce_mean(fc(to_variable(np.ones((1, 2),
                                                             np.float32))))
            loss.backward()
            lr = opt.current_step_lr
            seen.append(round(lr, 6))
            g = fc.weight.gradient()
            opt.minimize(loss)
            opt.clear_gradients()
            np.testing.assert_allclose(fc.weight.numpy(), before - lr * g,
                                       rtol=1e-6)
        assert seen == [0.1, 0.1, 0.01, 0.01, 0.001]


def test_optimizer_state_dict_round_trips():
    rng = np.random.default_rng(5)
    with dygraph.guard(CPU):
        fc = dygraph.Linear(4, 3)
        opt = fluid.optimizer.Adam(0.01, parameter_list=fc.parameters())
        x = to_variable(rng.standard_normal((5, 4)).astype(np.float32))
        for _ in range(2):
            layers.reduce_mean(fc(x)).backward()
            opt.minimize(None)
            fc.clear_gradients()
        state = opt.state_dict()
        assert int(state['global_step'][0]) == 2
        assert f'{fc.weight.name}_moment1' in state
        fc2 = copy.deepcopy(fc)
        opt2 = fluid.optimizer.Adam(0.01, parameter_list=fc2.parameters())
        opt2.set_dict({k: v.numpy() for k, v in state.items()})
        for m, o in ((fc, opt), (fc2, opt2)):
            layers.reduce_mean(m(x)).backward()
            o.minimize(None)
        assert torch.equal(fc.weight, fc2.weight)


@pytest.mark.parametrize('kw', [
    {'regularization': ('regularizer', 'L2Decay', 0.01)},
    {'grad_clip': ('clip', 'GradientClipByGlobalNorm', 1.0)},
    {'lazy_mode': True}], ids=['regularization', 'grad_clip', 'lazy_mode'])
def test_unported_optimizer_options_raise(kw):
    """``regularization``, ``grad_clip`` and ``lazy_mode`` (accepted and
    ignored, as in the JAX package: a dense gradient's lazy update is the
    plain one) are ported: one ``minimize`` of a Linear with ``Adam(0.1,
    ...)`` equals the JAX package's, atol 1e-6."""
    (name, value), = kw.items()

    def option(pkg):
        if not isinstance(value, tuple):
            return {name: value}
        module, cls, arg = value
        return {name: getattr(getattr(pkg, module), cls)(arg)}

    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 2)).astype(np.float32)
    x = rng.standard_normal((4, 3)).astype(np.float32) * 10
    out = []
    for pkg, dy, lay in ((fluid, dygraph, layers), (jfluid, jdy, jlayers)):
        with dy.guard(CPU if pkg is fluid else None):
            fc = dy.Linear(3, 2)
            fc.weight.set_value(w)
            opt = pkg.optimizer.Adam(
                0.1, parameter_list=fc.parameters(), **option(pkg))
            loss = lay.reduce_sum(fc(dy.to_variable(x)))
            loss.backward()
            opt.minimize(loss)
            out.append((fc.weight.numpy(), fc.bias.numpy()))
    for got, want in zip(*out):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert not np.allclose(out[0][0], w, atol=0.05)


# --------------------------------------------------------- checkpoints

def _sd_numpy(sd):
    return {k: np.asarray(v.numpy()) for k, v in sd.items()}


def test_save_dygraph_files_load_in_the_jax_package(tmp_path):
    with dygraph.guard(CPU):
        m = dygraph.Sequential(dygraph.Linear(3, 4), dygraph.BatchNorm(4))
        want = _sd_numpy(m.state_dict())
        dygraph.save_dygraph(m.state_dict(), str(tmp_path / 'ck' / 'm'))
    assert sorted(p.name for p in (tmp_path / 'ck').iterdir()) == [
        'm.pdparams.json', 'm.pdparams.npz']
    state, opt = jfluid.load_dygraph(str(tmp_path / 'ck' / 'm'))
    assert opt is None and list(state) == list(want)
    with jdy.guard():
        jm = jdy.Sequential(jdy.Linear(3, 4), jdy.BatchNorm(4))
        jm.set_dict(state)
        for k, v in jm.state_dict().items():
            np.testing.assert_array_equal(np.asarray(v.value), want[k])


def test_jax_package_files_load_in_the_port(tmp_path):
    with jdy.guard():
        jm = jdy.Sequential(jdy.Linear(3, 4), jdy.BatchNorm(4))
        want = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
        jfluid.save_dygraph(jm.state_dict(), str(tmp_path / 'm'))
    state, opt = dygraph.load_dygraph(str(tmp_path / 'm'))
    assert opt is None
    with dygraph.guard(CPU):
        m = dygraph.Sequential(dygraph.Linear(3, 4), dygraph.BatchNorm(4))
        m.set_dict(state)
        got = _sd_numpy(m.state_dict())
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_optimizer_state_goes_to_pdopt(tmp_path):
    with dygraph.guard(CPU):
        fc = dygraph.Linear(2, 2)
        opt = fluid.optimizer.Adam(0.01, parameter_list=fc.parameters())
        layers.reduce_mean(fc(to_variable(np.ones((1, 2),
                                                  np.float32)))).backward()
        opt.minimize(None)
        path = str(tmp_path / 'm')
        dygraph.save_dygraph(fc.state_dict(), path)
        dygraph.save_dygraph(opt.state_dict(), path)
    params, opt_state = dygraph.load_dygraph(path)
    assert sorted(params) == ['bias', 'weight']
    assert int(opt_state['global_step'][0]) == 1
    assert not [p for p in tmp_path.iterdir() if p.name.startswith('.tmp')]
    with pytest.raises(ValueError, match='no checkpoint'):
        dygraph.load_dygraph(str(tmp_path / 'missing'))


# ------------------------------------------------------------------ ops

def _rng_array(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


_IDS = np.array([[1, 0, 5], [7, 2, 0]], np.int64)
# name -> (registered op, float inputs by slot, other inputs, attrs)
OP_CASES = {
    'lookup_table_pad0': ('lookup_table', {'w': _rng_array((8, 4), 0)},
                          {'ids': _IDS}, {'padding_idx': 0}),
    'lookup_table_column': ('lookup_table', {'w': _rng_array((8, 4), 1)},
                            {'ids': _IDS.reshape(6, 1)}, {}),
    'layer_norm': ('layer_norm', {'x': _rng_array((2, 3, 6), 2),
                                  'scale': _rng_array((6,), 3),
                                  'bias': _rng_array((6,), 4)},
                   {}, {'begin_norm_axis': 2, 'epsilon': 1e-5}),
    'layer_norm_two_axes': ('layer_norm', {'x': _rng_array((2, 3, 4), 5),
                                           'scale': _rng_array((12,), 6)},
                            {}, {'begin_norm_axis': 1}),
    'log_softmax': ('log_softmax', {'x': _rng_array((3, 7), 7) * 3}, {},
                    {}),
    'log_softmax_axis0': ('log_softmax', {'x': _rng_array((3, 7), 8)}, {},
                          {'axis': 0}),
    'transpose': ('transpose', {'x': _rng_array((2, 3, 4, 5), 9)}, {},
                  {'perm': [0, 2, 1, 3]}),
    'one_hot': ('one_hot', {}, {'x': np.array([[3], [0], [9], [-1]])},
                {'depth': 5}),
    'not_equal': ('not_equal', {}, {'x': _IDS, 'y': np.array([0])}, {}),
    'reduce_sum': ('reduce_sum', {'x': _rng_array((3, 4, 5), 10)}, {},
                   {'dim': [0, 2], 'keep_dim': True}),
    'reduce_sum_all': ('reduce_sum', {'x': _rng_array((3, 4), 11)}, {}, {}),
}


@pytest.mark.parametrize('case', list(OP_CASES))
def test_op_matches_the_jax_op_with_gradients(case):
    from paddle_tpu.ops.registry import get_op as jget
    from paddle_tpu_torch.ops.registry import get_op as pget
    op, floats, others, attrs = OP_CASES[case]
    jdef, pdef = jget(op), pget(op)
    assert pdef.input_slots == jdef.input_slots
    assert pdef.output_slots == jdef.output_slots
    inputs = {**floats, **others}
    jargs = [inputs.get(s) for s in jdef.input_slots]
    want = np.asarray(jdef.fn(*jargs, **attrs))
    leaves = {s: torch.tensor(v, requires_grad=True)
              for s, v in floats.items()}
    targs = [leaves[s] if s in leaves else
             (None if inputs.get(s) is None else torch.from_numpy(inputs[s]))
             for s in pdef.input_slots]
    got = pdef.fn(*targs, **attrs)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(),
                               want.astype(np.float32), atol=1e-6, rtol=0)
    if not floats:
        return
    cot = _rng_array(want.shape, 12)
    names = list(floats)

    def f(*vals):
        kw = dict(inputs, **dict(zip(names, vals)))
        return jnp.sum(jdef.fn(*[kw.get(s) for s in jdef.input_slots],
                               **attrs) * cot)

    jgrads = jax.grad(f, argnums=tuple(range(len(names))))(
        *[floats[n] for n in names])
    (got * torch.from_numpy(cot)).sum().backward()
    for n, jg in zip(names, jgrads):
        np.testing.assert_allclose(leaves[n].grad.numpy(), np.asarray(jg),
                                   atol=1e-6, rtol=1e-5, err_msg=n)


def test_dispatch_op_runs_a_registered_op_on_the_guard_device():
    with dygraph.guard(CPU):
        out = dygraph.dispatch_op('fill_constant', {},
                                  {'shape': [2], 'value': 3.0})
        assert out.device.type == 'cpu' and out.tolist() == [3.0, 3.0]
        y = dygraph.dispatch_op('elementwise_add',
                                {'x': out, 'y': np.float32(1.0)}, {})
        assert y.tolist() == [4.0, 4.0]
        d = dygraph.dispatch_op('dropout', {'x': to_variable(np.ones(
            (64,), np.float32))}, {'dropout_prob': 0.5,
                                   'dropout_implementation':
                                   'upscale_in_train'})
        assert set(d.numpy().tolist()) == {0.0, 2.0}


# ------------------------------------------------------- what raises

@pytest.mark.parametrize('name,item', [
    ('DataParallel', 'A.9'), ('ParallelEnv', 'A.9'),
    ('prepare_context', 'A.9'), ('TracedLayer', 'A.4'),
    ('declarative', 'A.4'), ('to_static', 'A.4'),
    ('ProgramTranslator', 'A.4'), ('StaticFunction', 'A.4'),
    ('InputSpec', 'A.4'), ('dygraph_to_static_graph', 'A.4'),
    ('Conv3D', 'A.4'), ('Conv2DTranspose', 'A.4'),
    ('Conv3DTranspose', 'A.4'), ('GroupNorm', 'A.4'),
    ('SpectralNorm', 'A.4'), ('PRelu', 'A.4'),
    ('BilinearTensorProduct', 'A.4'), ('GRUUnit', 'A.4'), ('NCE', 'A.4'),
    ('TreeConv', 'A.4')])
def test_unported_names_raise_naming_their_item(name, item):
    """The names not ported raise naming their item; the ten layers of
    A.4c build and run (tests/test_torch_dygraph_layers.py holds their
    values to the JAX layers'), and so do dygraph-to-static's (A.4d,
    tests/test_torch_to_static.py) and data parallelism's names (A.9a,
    tests/test_torch_data_parallel.py)."""
    import paddle_tpu.dygraph as jdygraph
    assert hasattr(jdygraph, name)
    runs = {**A4C_RUNS, **A4D_A9A_RUNS}
    if name in runs:
        with dygraph.guard(CPU):
            out, shape = runs[name]()
        outs = out if isinstance(out, tuple) else (out,)
        assert tuple(outs[0].shape) == shape
        assert all(torch.isfinite(o).all() for o in outs)
        return
    with pytest.raises(NotImplementedError, match=item):
        getattr(dygraph, name)(1, 2, 3)


def _a4c(shape, *arrays):
    return [to_variable(np.random.RandomState(i).rand(*a).astype(np.float32))
            for i, a in enumerate(arrays)], shape


def _run(layer, arrays, shape):
    return layer(*arrays), shape


# each A.4c layer built and run: (output, its expected shape)
A4C_RUNS = {
    'Conv3D': lambda: _run(dygraph.Conv3D(2, 3, 3),
                           *_a4c((1, 3, 2, 2, 2), (1, 2, 4, 4, 4))),
    'Conv2DTranspose': lambda: _run(dygraph.Conv2DTranspose(2, 3, 3),
                                    *_a4c((1, 3, 6, 6), (1, 2, 4, 4))),
    'Conv3DTranspose': lambda: _run(dygraph.Conv3DTranspose(2, 3, 3),
                                    *_a4c((1, 3, 4, 4, 4), (1, 2, 2, 2, 2))),
    'GroupNorm': lambda: _run(dygraph.GroupNorm(4, 2),
                              *_a4c((2, 4, 3, 3), (2, 4, 3, 3))),
    'SpectralNorm': lambda: (dygraph.SpectralNorm([3, 4])(), (3, 4)),
    'PRelu': lambda: _run(dygraph.PRelu('channel', channel=3),
                          *_a4c((2, 3, 4, 4), (2, 3, 4, 4))),
    'BilinearTensorProduct': lambda: _run(
        dygraph.BilinearTensorProduct(2, 3, 4), *_a4c((5, 4), (5, 2),
                                                       (5, 3))),
    'GRUUnit': lambda: _run(dygraph.GRUUnit(6),
                            *_a4c((3, 2), (3, 6), (3, 2))),
    'NCE': lambda: (dygraph.NCE(7, 4)(
        to_variable(np.ones((3, 4), np.float32)),
        to_variable(np.array([[1], [2], [3]], np.int64))), (3, 1)),
    'TreeConv': lambda: _run(dygraph.TreeConv(4, 5, num_filters=2),
                             *_a4c((2, 3, 5, 2), (2, 3, 4), (2, 3, 2))),
}


def _lin_x():
    return dygraph.Linear(4, 3), to_variable(
        np.random.RandomState(0).rand(2, 4).astype(np.float32))


def _static_run(make):
    lin, x = _lin_x()
    return make(lambda v: lin(v))(x), (2, 3)


def _env_run(env):
    return torch.tensor([env.nranks, env.world_size, env.local_rank,
                         env.rank, env.dev_id], dtype=torch.float32), (5,)


# each name of dygraph-to-static (A.4d) and data parallelism (A.9a) built
# and run at a world of one: (output, its expected shape)
A4D_A9A_RUNS = {
    'DataParallel': lambda: (lambda lx: (dygraph.DataParallel(lx[0])(lx[1]),
                                         (2, 3)))(_lin_x()),
    'ParallelEnv': lambda: _env_run(dygraph.ParallelEnv()),
    'prepare_context': lambda: _env_run(dygraph.prepare_context()),
    'TracedLayer': lambda: (lambda lx: (dygraph.TracedLayer.trace(
        lx[0], [lx[1]])[0], (2, 3)))(_lin_x()),
    'declarative': lambda: _static_run(dygraph.declarative),
    'to_static': lambda: _static_run(dygraph.to_static),
    'ProgramTranslator': lambda: _static_run(
        lambda f: lambda v: dygraph.ProgramTranslator().get_output(f, v)),
    'StaticFunction': lambda: _static_run(dygraph.StaticFunction),
    'InputSpec': lambda: _static_run(lambda f: dygraph.StaticFunction(
        f, input_spec=[dygraph.InputSpec([None, 4], 'float32')])),
    'dygraph_to_static_graph': lambda: _static_run(
        dygraph.dygraph_to_static_graph),
}


def test_every_jax_dygraph_name_exists_in_the_port():
    import paddle_tpu.dygraph as jdygraph
    public = {n for n in dir(jdygraph) if not n.startswith('_')}
    modules = {'base', 'tape', 'layers', 'container', 'nn', 'parallel',
               'checkpoint', 'learning_rate_scheduler', 'jit'}
    missing = sorted(n for n in public - modules if not hasattr(dygraph, n))
    assert missing == []


def test_embedding_is_sparse_and_conv_act_raise():
    with dygraph.guard(CPU):
        with pytest.raises(NotImplementedError, match='A.10'):
            dygraph.Embedding([4, 2], is_sparse=True)
        # any registered op is an act (A.4c); one that names no op raises
        # the JAX package's KeyError when the layer runs, as there
        x = np.array([[1.0, -2.0]], np.float32)
        lin = dygraph.Linear(2, 2, act='sigmoid')
        np.testing.assert_allclose(
            lin(to_variable(x)).numpy(),
            1 / (1 + np.exp(-(x @ lin.weight.numpy() + lin.bias.numpy()))),
            rtol=1e-6)
        with pytest.raises(KeyError, match='no_such_act'):
            dygraph.Linear(2, 2, act='no_such_act')(to_variable(x))
    with jdy.guard():
        with pytest.raises(KeyError, match='no_such_act'):
            jdy.Linear(2, 2, act='no_such_act')(jdy.to_variable(x))
    with dygraph.guard(CPU):
        with pytest.raises(NotImplementedError, match='A.10'):
            fluid.ops.nn_ops.lookup_table(torch.ones(3, 2),
                                          torch.zeros(2, dtype=torch.long),
                                          is_sparse=True)
