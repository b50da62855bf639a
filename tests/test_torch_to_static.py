"""The port's dygraph-to-static (paddle_tpu_torch/dygraph/jit.py:
``to_static``/``declarative``, ``StaticFunction``, ``InputSpec``,
``ProgramTranslator``, ``TracedLayer``, ``functionalize``; io.py's
``_save_jit_model``) against the JAX package's, on the CPU.

- Each of the nine cases of tests/dygraph/test_to_static.py runs in both
  packages on the same weights and inputs: outputs and gradients at f32
  atol 1e-5 (the JAX package compiles the function into one XLA program,
  the port runs it eagerly: the same f32 arithmetic, fused or not), and
  equal compile counts.
- ``ProgramTranslator().get_output`` in both.
- ``TracedLayer``: outputs equal to the JAX traced layer's (atol 1e-5),
  the values and the train/eval mode taken at trace time in both (a later
  update of the layer, or ``eval()``, changes nothing), and
  ``save_inference_model``'s two ``.npz`` files equal to the JAX
  package's, key for key and array for array.
- ROADMAP C.17: a module global rebound to a new layer after the first
  call; the JAX entry keeps the first layer's parameters, the port reads
  the new layer. ROADMAP C.19: an ``int64`` InputSpec given a value past
  int32 wraps in the JAX package and raises in the port.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.dygraph import jit as jjit
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.dygraph import jit
import torch_jax_seed  # noqa: F401  (caps torch's threads)

CPU = fluid.CPUPlace()
ATOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_port_names():
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.core.random import default_generator
    old = unique_name.generator
    unique_name.generator = unique_name.UniqueNameGenerator()
    default_generator.seed(0)
    yield
    unique_name.generator = old
    jit.ProgramTranslator().enable(True)
    jjit.ProgramTranslator().enable(True)


def _rand(*shape):
    return np.random.RandomState(sum(shape)).randn(*shape).astype('float32')


def copy_layer(jlayer, player):
    """The JAX layer's parameters and buffers into the port's."""
    vals = {n: np.asarray(p.value) for n, p in jlayer.named_parameters()}
    vals.update({n: np.asarray(b.value) for n, b in jlayer.named_buffers()})
    player.set_dict(vals)


def close(got, want, atol=ATOL):
    got = got.numpy() if hasattr(got, 'numpy') else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


# ------------------------------------------------ the nine JAX cases

def test_function_parity_and_single_compile():
    x = _rand(2, 4)
    with jdy.guard():
        jl = jdy.Linear(4, 3)

        @jjit.to_static
        def jf(v):
            return jfluid.layers.relu(jl(v))
        jout = jf(jdy.to_variable(x)).numpy()
        for _ in range(2):
            jf(jdy.to_variable(x))
    with dygraph.guard(CPU):
        pl = dygraph.Linear(4, 3)
        copy_layer(jl, pl)

        @jit.to_static
        def pf(v):
            return fluid.layers.relu(pl(v))
        out = pf(dygraph.to_variable(x))
        jit.ProgramTranslator().enable(False)
        ref = pf(dygraph.to_variable(x))
        jit.ProgramTranslator().enable(True)
        assert torch.equal(out, ref)
        for _ in range(2):
            pf(dygraph.to_variable(x))
    close(out, jout)
    assert pf._compile_count == jf._compile_count == 1


def _net(pkg):
    class Net(pkg.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = pkg.Linear(4, 8, act='relu')
            self.l2 = pkg.Linear(8, 2)

        @(jjit if pkg is jdy else jit).declarative
        def forward(self, x):
            return self.l2(self.l1(x))
    return Net()


def test_method_decoration_grad_parity():
    x = _rand(5, 4)
    with jdy.guard():
        jnet = _net(jdy)
        jloss = jfluid.layers.reduce_sum(jnet.forward(jdy.to_variable(x)))
        jloss.backward()
        jgrads = {n: np.asarray(p.grad) for n, p in jnet.named_parameters()}
        jcount = jnet.forward._compile_count
    with dygraph.guard(CPU):
        net = _net(dygraph)
        copy_layer(jnet, net)
        loss = fluid.layers.reduce_sum(net.forward(dygraph.to_variable(x)))
        loss.backward()
        grads = {n: p.gradient() for n, p in net.named_parameters()}
        net.clear_gradients()
        jit.ProgramTranslator().enable(False)
        fluid.layers.reduce_sum(net(dygraph.to_variable(x))).backward()
        jit.ProgramTranslator().enable(True)
        eager = {n: p.gradient() for n, p in net.named_parameters()}
        count = net.forward._compile_count
    close(loss, jloss.numpy())
    assert set(grads) == set(jgrads)
    for n in grads:
        close(grads[n], jgrads[n])
        np.testing.assert_array_equal(grads[n], eager[n])
    assert count == jcount == 1


def test_buffer_mutation_batchnorm():
    x = _rand(8, 3)
    with jdy.guard():
        jbn = jdy.BatchNorm(3)
        with dygraph.guard(CPU):
            bn = dygraph.BatchNorm(3)
            copy_layer(jbn, bn)
        jbn.train()
        jf = jjit.to_static(lambda v: jbn(v))
        jout = jf(jdy.to_variable(x)).numpy()
        jbufs = {n: np.asarray(b.value) for n, b in jbn.named_buffers()}
    with dygraph.guard(CPU):
        before = {n: b.numpy().copy() for n, b in bn.named_buffers()}
        bn.train()
        pf = jit.to_static(lambda v: bn(v))
        out = pf(dygraph.to_variable(x))
        bufs = {n: b.numpy() for n, b in bn.named_buffers()}
    close(out, jout)
    assert set(bufs) == set(jbufs)
    assert any(not np.allclose(before[n], bufs[n]) for n in bufs)
    for n in bufs:
        close(bufs[n], jbufs[n])
    assert pf._compile_count == jf._compile_count == 1


def test_recompile_on_new_shape():
    with jdy.guard():
        jl = jdy.Linear(4, 3)
        jf = jjit.to_static(lambda v: jl(v))
        jf(jdy.to_variable(_rand(2, 4)))
        jc1 = jf._compile_count
        jout = jf(jdy.to_variable(_rand(7, 4))).numpy()
    with dygraph.guard(CPU):
        pl = dygraph.Linear(4, 3)
        copy_layer(jl, pl)
        pf = jit.to_static(lambda v: pl(v))
        pf(dygraph.to_variable(_rand(2, 4)))
        c1 = pf._compile_count
        out = pf(dygraph.to_variable(_rand(7, 4)))
    assert c1 == jc1 == 1
    assert pf._compile_count == jf._compile_count == 2
    assert tuple(out.shape) == jout.shape == (7, 3)
    close(out, jout)


def test_input_spec_dtype_cast():
    x = np.random.RandomState(3).randn(2, 4)           # float64
    with jdy.guard():
        jl = jdy.Linear(4, 3)
        jsf = jjit.StaticFunction(
            lambda v: jl(v), input_spec=[jjit.InputSpec([None, 4],
                                                        'float32')])
        jout = jsf(x)
    with dygraph.guard(CPU):
        pl = dygraph.Linear(4, 3)
        copy_layer(jl, pl)
        sf = jit.StaticFunction(
            lambda v: pl(v), input_spec=[jit.InputSpec([None, 4],
                                                       'float32')])
        out = sf(x)
    assert jout.dtype == 'float32' and out.dtype == torch.float32
    close(out, jout.numpy())
    assert sf._compile_count == jsf._compile_count == 1


def test_input_spec_int64_outside_int32_c19():
    """ROADMAP C.19: the JAX entry turns the array into a JAX one before
    its ``check_int32_bounds``, which then never runs, and an int64 value
    past int32 wraps; the port keeps int64 and raises as that check
    would."""
    ids = np.array([[1, 2 ** 31]], np.int64)
    with jdy.guard():
        spec = [jjit.InputSpec([None, 2], 'int64')]
        wrapped = jjit.StaticFunction(lambda v: v, input_spec=spec)(ids)
    np.testing.assert_array_equal(wrapped.numpy(), [[1, -2 ** 31]])
    with dygraph.guard(CPU):
        spec = [jit.InputSpec([None, 2], 'int64')]
        with pytest.raises(OverflowError, match='int32'):
            jit.StaticFunction(lambda v: v, input_spec=spec)(ids)
        ok = jit.StaticFunction(lambda v: v, input_spec=spec)(ids - 1)
    assert ok.dtype == torch.int64
    np.testing.assert_array_equal(ok.numpy(), ids - 1)


def test_dropout_randomness_not_baked():
    x = np.ones((64, 64), np.float32)

    def drop(layers_mod):
        return lambda v: layers_mod.dropout(
            v, dropout_prob=0.5, dropout_implementation='upscale_in_train')
    with jdy.guard():
        jf = jjit.to_static(drop(jfluid.layers))
        ja, jb = (jf(jdy.to_variable(x)).numpy() for _ in range(2))
    with dygraph.guard(CPU):
        pf = jit.to_static(drop(fluid.layers))
        a, b = (pf(dygraph.to_variable(x)).numpy() for _ in range(2))
    for u, v in ((a, b), (ja, jb)):
        assert set(np.unique(u)) <= {0.0, 2.0}
        assert not np.array_equal(u, v)
    assert pf._compile_count == jf._compile_count == 1


def test_program_translator_disable():
    x = _rand(3, 2)
    with jdy.guard():
        jl = jdy.Linear(2, 2)
        jf = jjit.to_static(lambda v: jl(v))
        jjit.ProgramTranslator().enable(False)
        jout = jf(jdy.to_variable(x)).numpy()
        jjit.ProgramTranslator().enable(True)
    with dygraph.guard(CPU):
        pl = dygraph.Linear(2, 2)
        copy_layer(jl, pl)
        pf = jit.to_static(lambda v: pl(v))
        jit.ProgramTranslator().enable(False)
        out = pf(dygraph.to_variable(x))
        jit.ProgramTranslator().enable(True)
    assert pf._compile_count == jf._compile_count == 0
    close(out, jout)


def test_kwarg_tensor_gets_grad():
    v = np.array([2.0, 3.0], np.float32)
    with jdy.guard():
        jf = jjit.to_static(lambda x: jfluid.layers.reduce_sum(x * x))
        jt = jdy.Parameter(v)
        jf(x=jt).backward()
        jgrad = jt.gradient()
    with dygraph.guard(CPU):
        pf = jit.to_static(lambda x: fluid.layers.reduce_sum(x * x))
        t = dygraph.Parameter(v)
        pf(x=t).backward()
        grad = t.gradient()
    close(grad, jgrad)
    np.testing.assert_allclose(grad, [4.0, 6.0], rtol=1e-6)
    assert pf._compile_count == jf._compile_count == 1


def test_static_args_in_cache_key():
    x = _rand(2, 2)
    with jdy.guard():
        jf = jjit.to_static(lambda v, s: jfluid.layers.scale(v, scale=s))
        ja, jb = (jf(jdy.to_variable(x), s).numpy() for s in (2.0, 3.0))
    with dygraph.guard(CPU):
        pf = jit.to_static(lambda v, s: fluid.layers.scale(v, scale=s))
        a, b = (pf(dygraph.to_variable(x), s) for s in (2.0, 3.0))
    close(a, ja)
    close(b, jb)
    np.testing.assert_allclose(b.numpy(), 1.5 * a.numpy(), rtol=1e-6)
    assert pf._compile_count == jf._compile_count == 2


# ------------------------------------------------- beyond the nine cases

def test_no_grad_outputs_stop_gradient_and_count_a_new_key():
    x = _rand(2, 4)
    with dygraph.guard(CPU):
        pl = dygraph.Linear(4, 3)
        pf = jit.to_static(lambda v: pl(v))
        assert not pf(dygraph.to_variable(x)).stop_gradient
        with dygraph.no_grad():
            out = pf(dygraph.to_variable(x))
        assert out.stop_gradient
        assert pf._compile_count == 2


def test_bound_copies_share_the_count_and_instances_keep_own_caches():
    class Net(dygraph.Layer):
        def __init__(self):
            super().__init__()
            self.fc = dygraph.Linear(4, 2)

        @jit.to_static
        def forward(self, x):
            return self.fc(x)
    with dygraph.guard(CPU):
        a, b = Net(), Net()
        x = dygraph.to_variable(_rand(5, 4))
        a(x)
        a.forward(x)
        b(x)
        assert a.forward._compile_count == 2
        assert Net.forward._compile_count == 2
        assert len(Net.forward._instance_caches) == 2
        del b
        import gc
        gc.collect()
        assert len(Net.forward._instance_caches) == 1


def test_get_output_matches_jax_and_keeps_one_function():
    x = _rand(3, 4)
    with jdy.guard():
        jl = jdy.Linear(4, 2)

        def jfn(v):
            return jfluid.layers.tanh(jl(v))
        jout = jjit.ProgramTranslator().get_output(jfn, jdy.to_variable(x))
    with dygraph.guard(CPU):
        pl = dygraph.Linear(4, 2)
        copy_layer(jl, pl)

        def pfn(v):
            return fluid.layers.tanh(pl(v))
        pt = jit.ProgramTranslator()
        assert pt is jit.ProgramTranslator()
        out = pt.get_output(pfn, dygraph.to_variable(x))
        pt.get_output(pfn, dygraph.to_variable(x))
        sf = jit.ProgramTranslator._fn_cache[pfn]
    close(out, jout.numpy())
    assert sf._compile_count == 1


def _conv_bn(pkg, layers_mod):
    class ConvBN(pkg.Layer):
        def __init__(self):
            super().__init__()
            self.conv = pkg.Conv2D(3, 4, 3, padding=1)
            self.bn = pkg.BatchNorm(4)
            self.fc = pkg.Linear(4 * 6 * 6, 5)

        def forward(self, x):
            y = layers_mod.relu(self.bn(self.conv(x)))
            return self.fc(layers_mod.reshape(y, shape=[-1, 4 * 6 * 6]))
    return ConvBN()


def test_traced_layer_matches_jax_and_holds_its_snapshot(tmp_path):
    x = _rand(2, 3, 6, 6)
    with jdy.guard():
        jnet = _conv_bn(jdy, jfluid.layers)
        jnet.train()
        with dygraph.guard(CPU):
            net = _conv_bn(dygraph, fluid.layers)
            copy_layer(jnet, net)
        jout, jtraced = jjit.TracedLayer.trace(jnet, [jdy.to_variable(x)])
        for p in jnet.parameters():
            p.value = p.value * 2.0
        jnet.eval()
        jagain = jtraced(jdy.to_variable(x))
        jtraced.save_inference_model(str(tmp_path / 'jax'))
    with dygraph.guard(CPU):
        net.train()
        out, traced = jit.TracedLayer.trace(net, [dygraph.to_variable(x)])
        bufs = {n: b.numpy().copy() for n, b in net.named_buffers()}
        with torch.no_grad():
            for p in net.parameters():
                p.mul_(2.0)
        net.eval()
        again = traced(dygraph.to_variable(x))
        assert not net.training and not net.bn.training
        after = {n: b.numpy().copy() for n, b in net.named_buffers()}
        live = net.train()(dygraph.to_variable(x))
        traced.save_inference_model(str(tmp_path / 'port'))
    close(out, jout.numpy())
    close(again, jagain.numpy())
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    assert out.stop_gradient and again.stop_gradient
    assert not torch.allclose(live, out)
    for n, b in bufs.items():          # a traced call moves no buffer
        np.testing.assert_array_equal(after[n], b)
    for name in ('jit_params.npz', 'jit_buffers.npz'):
        got = np.load(tmp_path / 'port' / name)
        want = np.load(tmp_path / 'jax' / name)
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_traced_npz_are_the_layer_state_in_paddle_layout(tmp_path):
    """An NHWC Conv2D's weight goes to the file as HWIO, as the JAX
    package holds it and ``state_dict`` gives it."""
    with dygraph.guard(CPU):
        conv = dygraph.Conv2D(3, 4, 3, data_format='NHWC')
        _, traced = jit.TracedLayer.trace(
            conv, [dygraph.to_variable(_rand(1, 5, 5, 3))])
        traced.save_inference_model(str(tmp_path))
        state = conv.state_dict()
    got = np.load(tmp_path / 'jit_params.npz')
    assert got['weight'].shape == (3, 3, 3, 4)
    np.testing.assert_array_equal(got['weight'], state['weight'].numpy())


# ROADMAP C.17: a module global rebound after the first call
_J_NET = None
_P_NET = None


def _j_global_forward(v):
    return _J_NET(v)


def _p_global_forward(v):
    return _P_NET(v)


def test_rebound_global_layer_c17():
    """The JAX entry keeps the parameters of the layer it found when it
    traced; the port's eager call reads the module global anew."""
    global _J_NET, _P_NET
    x = _rand(2, 4)
    try:
        with jdy.guard():
            first, second = jdy.Linear(4, 3), jdy.Linear(4, 3)
            _J_NET = first
            jf = jjit.to_static(_j_global_forward)
            jf(jdy.to_variable(x))
            _J_NET = second
            jout = jf(jdy.to_variable(x)).numpy()
            jfirst = first(jdy.to_variable(x)).numpy()
        with dygraph.guard(CPU):
            p1, p2 = dygraph.Linear(4, 3), dygraph.Linear(4, 3)
            copy_layer(first, p1)
            copy_layer(second, p2)
            _P_NET = p1
            pf = jit.to_static(_p_global_forward)
            pf(dygraph.to_variable(x))
            _P_NET = p2
            out = pf(dygraph.to_variable(x))
            want = p2(dygraph.to_variable(x))
            # the entry, as the JAX one, holds the first layer's parameters
            entry, = pf._cache.values()
            held = list(entry.params.values())
            assert any(t is p1.weight for t in held)
            assert not any(t is p2.weight for t in held)
    finally:
        _J_NET = _P_NET = None
    close(jout, jfirst, atol=0)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert pf._compile_count == jf._compile_count == 1


def test_dygraph_names_and_aliases():
    assert dygraph.dygraph_to_static_graph is dygraph.to_static
    assert dygraph.dygraph_to_static_output is dygraph.to_static
    assert dygraph.declarative is jit.declarative
    assert jdy.dygraph_to_static_graph is jdy.to_static
