"""The ten dygraph layers of ROADMAP A.4c (paddle_tpu_torch/dygraph/nn.py:
Conv3D, Conv2DTranspose, Conv3DTranspose, GroupNorm, SpectralNorm, PRelu,
BilinearTensorProduct, GRUUnit, NCE, TreeConv), every layer's ``act``
through the op registry, and the static layers over the same ops
(layers/nn.py, layers/rnn.py's ``gru_unit``), against the JAX package's,
on the CPU.

- Each layer is built in both packages under fresh name counters (the
  parameters' names and shapes must be equal), the JAX layer's parameters
  are carried into the port's with ``set_dict``, and both run on the same
  seeded input: outputs and every parameter's gradient (of a seeded random
  cotangent) at atol 1e-5, rtol 1e-5 for outputs and 1e-4 for gradients
  (f32 sums of up to a few hundred products in another order). NCE's
  negatives are the same fixed classes in both (the JAX sampler patched
  to return them, the port's plain loss given them).
- ``act``: any registered activation through Conv2D, Linear, LayerNorm
  and the new layers, as the JAX layers dispatch it; a name that is no op
  raises the JAX package's ``KeyError``.
- Each static layer in a Program, op for op and variable for variable
  against the JAX package's, the JAX startup values carried in, outputs at
  atol 1e-6, rtol 1e-5 (tests/test_torch_static_layers.py's helper); the
  NCE program's output by shape (its negatives are drawn in each
  package).
- Where the JAX layer ignores an argument or departs from Paddle 1.7
  (ROADMAP C.4 items 11-17, 19, 20), a test holds each side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.dygraph.tape import dispatch_op as jdispatch
from paddle_tpu.ops import extra_ops as jextra
from paddle_tpu.ops.registry import get_op as jget
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.dygraph import to_variable
from paddle_tpu_torch.ops import extra_ops
from paddle_tpu_torch.ops.registry import get_op
from test_torch_static_layers import (build_and_run,  # noqa: F401
                                      fresh_port_programs)
from torch_jax_seed import jax_seed_pinned  # noqa: F401

CPU = fluid.CPUPlace()
OUT = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def arr(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def jax_layer_run(build, inputs, cots):
    """(the JAX layer, its outputs, {name: gradient}) of ``build()`` on
    ``inputs`` under the JAX package's guard."""
    from paddle_tpu.core import unique_name as jnames
    with jdy.guard(), jnames.guard():
        layer = build(jdy)
        outs = layer(*[jdy.to_variable(a) for a in inputs])
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = None
        for o, c in zip(outs, cots):
            term = jdispatch('reduce_sum', {'x': jdispatch(
                'elementwise_mul', {'x': o, 'y': jdy.to_variable(c)}, {})},
                {})
            loss = term if loss is None else jdispatch(
                'elementwise_add', {'x': loss, 'y': term}, {})
        loss.backward()
        grads = {n: np.asarray(p.gradient())
                 for n, p in layer.named_parameters()
                 if p.gradient() is not None}
        return layer, [np.asarray(o.numpy()) for o in outs], grads


def port_layer_run(build, state, inputs, cots):
    """(the port layer, its outputs, {name: gradient}) of ``build()`` with
    ``state`` set, on ``inputs``, under ``guard(CPUPlace())``."""
    from paddle_tpu_torch.core import unique_name
    with dygraph.guard(CPU), unique_name.guard():
        layer = build(dygraph)
        layer.set_dict(state)
        outs = layer(*[to_variable(a) for a in inputs])
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs,
                                                                   cots))
        loss.backward()
        grads = {n: p.grad.numpy() for n, p in layer.named_parameters()
                 if p.grad is not None}
        return layer, [o.detach().numpy() for o in outs], grads


def check_layer(build, inputs, n_out=1, out_tol=OUT):
    """Build in both packages, carry the JAX weights over and compare
    names, shapes, outputs and gradients."""
    probe = port_probe_shapes(build, inputs)
    cots = [arr(100 + i, *s) for i, s in enumerate(probe[:n_out])]
    jl, jouts, jgrads = jax_layer_run(build, inputs, cots)
    state = {n: np.asarray(p.numpy()) for n, p in jl.named_parameters()}
    tl, touts, tgrads = port_layer_run(build, state, inputs, cots)
    assert [(n, tuple(p.shape), p.name) for n, p in tl.named_parameters()] \
        == [(n, tuple(p.shape), p.name) for n, p in jl.named_parameters()]
    for t, j in zip(touts, jouts):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, **out_tol)
    assert sorted(tgrads) == sorted(jgrads)
    for n in jgrads:
        np.testing.assert_allclose(tgrads[n], jgrads[n], err_msg=n, **GRAD)
    return touts


def port_probe_shapes(build, inputs):
    from paddle_tpu_torch.core import unique_name
    with dygraph.guard(CPU), unique_name.guard(), torch.no_grad():
        outs = build(dygraph)(*[to_variable(a) for a in inputs])
    outs = outs if isinstance(outs, tuple) else (outs,)
    return [tuple(o.shape) for o in outs]


LAYERS = {
    'conv3d': (lambda d: d.Conv3D(4, 6, 3, stride=2, padding=1, groups=2,
                                  act='relu6'),
               [arr(1, 2, 4, 5, 5, 5)], 1),
    'conv3d_tuple': (lambda d: d.Conv3D(2, 3, [2, 3, 1], dilation=(1, 2, 1),
                                        bias_attr=False),
                     [arr(2, 1, 2, 4, 6, 3)], 1),
    'conv2d_transpose_dcgan': (
        lambda d: d.Conv2DTranspose(8, 4, 4, stride=2, padding=1,
                                    act='leaky_relu'),
        [arr(3, 2, 8, 4, 4)], 1),
    'conv2d_transpose_groups': (
        lambda d: d.Conv2DTranspose(4, 6, 3, groups=2, dilation=2),
        [arr(4, 2, 4, 5, 5)], 1),
    'conv3d_transpose': (
        lambda d: d.Conv3DTranspose(3, 4, 3, stride=2, padding=1,
                                    act='tanh'),
        [arr(5, 1, 3, 3, 3, 3)], 1),
    'group_norm': (lambda d: d.GroupNorm(6, 3, act='swish'),
                   [arr(6, 2, 6, 3, 3, scale=2.0)], 1),
    'spectral_norm': (lambda d: d.SpectralNorm([6, 4], dim=1,
                                               power_iters=2), [], 1),
    'prelu_all': (lambda d: d.PRelu('all'), [arr(8, 2, 3, 4, 4)], 1),
    'prelu_channel': (lambda d: d.PRelu('channel', channel=3),
                      [arr(9, 2, 3, 4, 4)], 1),
    'prelu_element': (lambda d: d.PRelu('element', input_shape=[4, 6]),
                      [arr(10, 4, 6)], 1),
    'bilinear_tensor_product': (
        lambda d: d.BilinearTensorProduct(3, 4, 5, act='sigmoid'),
        [arr(11, 6, 3), arr(12, 6, 4)], 1),
    'gru_unit': (lambda d: d.GRUUnit(12), [arr(13, 3, 12), arr(14, 3, 4)],
                 3),
    'gru_unit_origin': (lambda d: d.GRUUnit(12, origin_mode=True),
                        [arr(15, 3, 12), arr(16, 3, 4)], 3),
    'tree_conv': (lambda d: d.TreeConv(5, 4, num_filters=2),
                  [arr(17, 2, 6, 5), np.zeros((2, 5, 2), np.float32)], 1),
    # act through the layers that had it before A.4c
    'conv2d_hard_swish': (lambda d: d.Conv2D(3, 4, 3, padding=1,
                                             act='hard_swish'),
                          [arr(18, 2, 3, 5, 5, scale=3.0)], 1),
    'linear_elu': (lambda d: d.Linear(4, 3, act='elu'), [arr(19, 5, 4)], 1),
    'layer_norm_softsign': (lambda d: d.LayerNorm(6, act='softsign'),
                            [arr(20, 3, 6)], 1),
}


@pytest.mark.parametrize('case', sorted(LAYERS))
def test_layer_matches_jax_from_the_same_weights(case):
    build, inputs, n_out = LAYERS[case]
    check_layer(build, inputs, n_out)


def test_nce_matches_jax_with_the_same_negatives(monkeypatch):
    classes, dim, negs = 37, 5, 4
    neg = np.array([3, 0, 36, 3], np.int64)
    monkeypatch.setattr(jax.random, 'randint',
                        lambda key, shape, lo, hi: jnp.asarray(neg))
    plain = extra_ops.nce_loss
    monkeypatch.setattr(
        extra_ops, 'nce_loss',
        lambda x, label, w, b, negatives: plain(x, label, w, b,
                                                torch.from_numpy(neg)))
    label = np.random.RandomState(21).randint(0, classes, (4, 1))
    x = arr(22, 4, dim)
    cots = [arr(23, 4, 1)]

    def build(d):     # the int64 label goes in through the closure
        layer = d.NCE(classes, dim, num_neg_samples=negs)
        forward = layer.forward
        layer.forward = lambda inp: forward(inp, d.to_variable(label))
        return layer

    jl, jouts, jgrads = jax_layer_run(build, [x], cots)
    state = {n: np.asarray(p.numpy()) for n, p in jl.named_parameters()}
    tl, touts, tgrads = port_layer_run(build, state, [x], cots)
    np.testing.assert_allclose(touts[0], jouts[0], **OUT)
    assert sorted(tgrads) == sorted(jgrads)
    for n in jgrads:
        np.testing.assert_allclose(tgrads[n], jgrads[n], err_msg=n, **GRAD)


def test_an_act_naming_no_op_raises_the_jax_key_error():
    x = arr(24, 2, 3, 4, 4)
    for mod, guard in ((jdy, jdy.guard()), (dygraph, dygraph.guard(CPU))):
        with guard:
            layer = mod.Conv2DTranspose(3, 2, 3, act='no_such_op')
            with pytest.raises(KeyError, match='no_such_op'):
                layer(mod.to_variable(x))


# ------------------------------------------------ what the JAX layers ignore

def test_batch_norm_act_is_applied_here_and_dropped_in_jax():
    """ROADMAP C.4 item 11: the JAX BatchNorm(act='relu6') equals its
    BatchNorm() (the act is never read); the port's applies it, as Paddle
    1.7's does: relu6 of the JAX BatchNorm's output (atol 1e-5), training
    and eval."""
    x = arr(25, 4, 3, 2, 2, scale=5.0)
    with jdy.guard():
        with_act, plain = jdy.BatchNorm(3, act='relu6'), jdy.BatchNorm(3)
        for mode in ('train', 'eval'):
            getattr(with_act, mode)()
            getattr(plain, mode)()
            a = with_act(jdy.to_variable(x)).numpy()
            b = plain(jdy.to_variable(x)).numpy()
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        jax_train = np.asarray(jget('batch_norm').fn(
            x, np.ones(3, np.float32), np.zeros(3, np.float32),
            np.zeros(3, np.float32), np.ones(3, np.float32))[0])
    with dygraph.guard(CPU):
        bn = dygraph.BatchNorm(3, act='relu6')
        got = bn(to_variable(x)).numpy()
    assert (jax_train < 0).any()
    np.testing.assert_allclose(got, np.clip(jax_train, 0, 6), atol=1e-5)


def test_conv2d_transpose_output_size_is_never_read_in_jax():
    """ROADMAP C.4 item 12, the layer: the JAX layer's output keeps the
    computed size whatever ``output_size`` says; the port's accepts that
    size and raises on another when it runs."""
    x = arr(26, 1, 2, 4, 4)
    with jdy.guard():
        out = jdy.Conv2DTranspose(2, 3, 3, output_size=[12, 12], stride=2)(
            jdy.to_variable(x))
        assert tuple(out.shape) == (1, 3, 9, 9)
    with dygraph.guard(CPU):
        ok = dygraph.Conv2DTranspose(2, 3, 3, output_size=[9, 9], stride=2)
        assert tuple(ok(to_variable(x)).shape) == (1, 3, 9, 9)
        bad = dygraph.Conv2DTranspose(2, 3, 3, output_size=[12, 12],
                                      stride=2)
        with pytest.raises(NotImplementedError, match=r'C\.4 item 12'):
            bad(to_variable(x))


def test_gru_unit_activations_are_never_read_in_jax():
    """ROADMAP C.4 item 13: the JAX GRUUnit with relu and tanh gates gives
    what the default gives; the port raises on anything but the
    defaults."""
    x, h = arr(27, 2, 6), arr(28, 2, 2)
    from paddle_tpu.core import unique_name as jnames
    outs, weights = [], None
    for kw in ({}, {'activation': 'relu', 'gate_activation': 'tanh'}):
        with jdy.guard(), jnames.guard():
            layer = jdy.GRUUnit(6, **kw)
            if weights is None:
                weights = [np.asarray(p.numpy()) for p in layer.parameters()]
            for p, w in zip(layer.parameters(), weights):
                p.set_value(w)
            outs.append(np.asarray(layer(jdy.to_variable(x),
                                         jdy.to_variable(h))[0].numpy()))
    np.testing.assert_array_equal(outs[0], outs[1])
    with dygraph.guard(CPU):
        dygraph.GRUUnit(6, activation='tanh', gate_activation='sigmoid')
        for kw in ({'activation': 'relu'}, {'gate_activation': 'tanh'}):
            with pytest.raises(NotImplementedError, match=r'C\.4 item 13'):
                dygraph.GRUUnit(6, **kw)


@pytest.mark.parametrize('kw', [{'sampler': 'log_uniform'},
                                {'custom_dist': [0.5, 0.5]},
                                {'sample_weight': np.ones(2, np.float32)},
                                {'seed': 7}, {'is_sparse': True}])
def test_nce_arguments_never_read_in_jax_raise(kw):
    """ROADMAP C.4 item 14: the JAX NCE accepts these and draws one set of
    uniform negatives whatever they say; the port raises."""
    with jdy.guard():
        jdy.NCE(2, 3, **kw)
    with dygraph.guard(CPU):
        with pytest.raises(NotImplementedError, match=r'C\.4 item 14'):
            dygraph.NCE(2, 3, **kw)
        layer = dygraph.NCE(2, 3)
        if 'sample_weight' in kw:
            with pytest.raises(NotImplementedError, match=r'C\.4 item 14'):
                layer(to_variable(np.ones((1, 3), np.float32)),
                      to_variable(np.zeros((1, 1), np.int64)),
                      sample_weight=to_variable(np.ones((1,), np.float32)))


def test_tree_conv_reads_neither_edges_nor_its_bias():
    """ROADMAP C.4 item 15: in both packages TreeConv's output does not
    move with ``edge_set`` or with its bias."""
    nodes = arr(29, 2, 4, 3)
    edges = [np.zeros((2, 3, 2), np.float32),
             np.random.RandomState(30).randint(0, 4, (2, 3, 2)).astype(
                 np.float32)]
    for mod, guard in ((jdy, jdy.guard()), (dygraph, dygraph.guard(CPU))):
        with guard:
            layer = mod.TreeConv(3, 5, num_filters=2)
            a = np.asarray(layer(mod.to_variable(nodes),
                                 mod.to_variable(edges[0])).numpy())
            b = np.asarray(layer(mod.to_variable(nodes),
                                 mod.to_variable(edges[1])).numpy())
            np.testing.assert_array_equal(a, b)
            assert tuple(layer.bias.shape) == (2, 5)
            if mod is jdy:
                layer.bias.set_value(np.ones((2, 5), np.float32))
            else:
                layer.bias.data.fill_(1.0)
            c = np.asarray(layer(mod.to_variable(nodes),
                                 mod.to_variable(edges[0])).numpy())
            np.testing.assert_array_equal(a, c)


def test_group_norm_nhwc_raises():
    """ROADMAP C.4 item 17 (the op's half is in
    tests/test_torch_activation_ops.py)."""
    with jdy.guard():
        jdy.GroupNorm(4, 2, data_layout='NHWC')
    with dygraph.guard(CPU):
        with pytest.raises(NotImplementedError, match=r'C\.4 item 17'):
            dygraph.GroupNorm(4, 2, data_layout='NHWC')


def test_grouped_conv3d_transpose_layer_runs_where_jax_raises():
    """ROADMAP C.4 item 19, the layer: the port's output has Paddle's
    shape, the JAX layer's forward raises."""
    x = arr(31, 1, 4, 2, 2, 2)
    with jdy.guard():
        with pytest.raises(Exception):
            jdy.Conv3DTranspose(4, 6, 2, groups=2)(jdy.to_variable(x))
    with dygraph.guard(CPU):
        layer = dygraph.Conv3DTranspose(4, 6, 2, groups=2)
        assert tuple(layer.weight.shape) == (4, 3, 2, 2, 2)
        assert tuple(layer(to_variable(x)).shape) == (1, 6, 3, 3, 3)


def test_prelu_element_layer_on_images_runs_where_jax_raises():
    """ROADMAP C.4 item 20, the layer: the JAX PRelu('element') raises on a
    4-D input; the port's reads its flat weight as (C, H, W)."""
    x = arr(32, 2, 3, 2, 2)
    with jdy.guard():
        with pytest.raises(Exception):
            jdy.PRelu('element', input_shape=[2, 3, 2, 2])(
                jdy.to_variable(x))
    with dygraph.guard(CPU):
        layer = dygraph.PRelu('element', input_shape=[2, 3, 2, 2])
        assert tuple(layer.weight.shape) == (12,)
        got = layer(to_variable(x)).numpy()
    np.testing.assert_allclose(got, np.where(x >= 0, x, 0.25 * x),
                               atol=1e-7)


# ------------------------------------------------------------ static layers

def _static_cases():
    def gru(p, x):
        h = p.layers.split(x, 3, dim=1)[0]
        return list(p.layers.gru_unit(x, h, size=6))

    return {
        'conv3d': ((2, 3, 4, 4, 4), lambda p, x: [p.layers.conv3d(
            x, 4, 3, padding=1, act='relu')]),
        'conv2d_transpose': ((2, 4, 3, 3), lambda p, x: [
            p.layers.conv2d_transpose(x, 3, filter_size=4, stride=2,
                                      padding=1, act='leaky_relu')]),
        'conv3d_transpose': ((1, 2, 3, 3, 3), lambda p, x: [
            p.layers.conv3d_transpose(x, 3, filter_size=2, stride=2)]),
        'group_norm': ((2, 6, 3, 3), lambda p, x: [p.layers.group_norm(
            x, 3, act='relu6')]),
        'spectral_norm': ((6, 4), lambda p, x: [p.layers.spectral_norm(
            x, dim=1, power_iters=2)]),
        'prelu_all': ((2, 3, 4, 4), lambda p, x: [p.layers.prelu(x,
                                                                 'all')]),
        'prelu_channel': ((2, 3, 4, 4), lambda p, x: [p.layers.prelu(
            x, 'channel')]),
        'prelu_element': ((4, 6), lambda p, x: [p.layers.prelu(
            x, 'element')]),
        'bilinear_tensor_product': ((4, 6), lambda p, x: [
            p.layers.bilinear_tensor_product(x, x * 0.5, 3, act='tanh')]),
        'gru_unit': ((4, 6), gru),
    }


STATIC = _static_cases()


@pytest.mark.parametrize('case', sorted(STATIC))
def test_static_layer_matches_jax_op_for_op(case):
    shape, builder = STATIC[case]
    got, want = build_and_run(builder, {'x': arr(33, *shape)})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).shape == np.asarray(w).shape
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-6,
                                   rtol=1e-5)


def test_static_nce_builds_the_jax_program():
    from test_torch_static_layers import _ops
    progs = {}
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data('x', [4, 5], 'float32')
            y = pkg.data('y', [4, 1], 'int64')
            out = pkg.layers.nce(x, y, 11, num_neg_samples=3)
        progs[pkg] = main, startup, out
    assert _ops(progs[fluid][0]) == _ops(progs[jfluid][0])
    main, startup, out = progs[fluid]
    exe = fluid.Executor(CPU)
    exe.run(startup)
    got, = exe.run(main, feed={'x': arr(34, 4, 5),
                               'y': np.arange(4, dtype=np.int64)[:, None]},
                   fetch_list=[out])
    assert got.shape == (4, 1) and np.isfinite(got).all()
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        x = fluid.data('x', [4, 5], 'float32')
        with pytest.raises(NotImplementedError, match=r'C\.4 item 14'):
            fluid.layers.nce(x, x, 11, sampler='log_uniform')


def test_static_conv2d_transpose_needs_filter_size_in_both():
    for pkg in (jfluid, fluid):
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            x = pkg.data('x', [1, 2, 3, 3], 'float32')
            with pytest.raises(ValueError, match='filter_size'):
                pkg.layers.conv2d_transpose(x, 3, output_size=[6, 6])


def test_static_gru_unit_takes_only_the_default_activations_in_both():
    for pkg in (jfluid, fluid):
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            x = pkg.data('x', [2, 6], 'float32')
            h = pkg.data('h', [2, 2], 'float32')
            with pytest.raises(ValueError, match='defaults'):
                pkg.layers.gru_unit(x, h, 6, activation='relu')
    assert get_op('gru_unit').output_slots == jget('gru_unit').output_slots
    assert jextra.gru_unit is jget('gru_unit').fn
