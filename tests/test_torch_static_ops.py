"""The static graph's ops in the port (paddle_tpu_torch/ops/{math_ops,
tensor_ops, nn_ops, loss_ops, optimizer_ops}.py, as the registry binds
them) against the JAX package's registered ops on the CPU, from the same
numpy inputs (``numpy.random.RandomState``).

Tolerance atol 1e-6, rtol 1e-5 throughout: each op is the same few f32
operations in both packages (sums and products in another order at most).
Integer results are compared exactly; the port keeps int64 where the JAX
package computes int32 (x64 off), so values are compared, not types, for
``cast`` to int64.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch.ops import registry

ATOL, RTOL = 1e-6, 1e-5


def jax_op(name):
    from paddle_tpu import ops  # noqa: F401  (registers every JAX op)
    return jax_registry.get_op(name)


def run_both(name, args, attrs=None):
    """The op ``name`` of both packages on the same numpy ``args``; returns
    (port results, JAX results) as lists of numpy arrays."""
    attrs = attrs or {}
    jfn, tfn = jax_op(name).fn, registry.get_op(name).fn
    want = jfn(*args, **attrs)
    got = tfn(*[None if a is None else torch.from_numpy(np.asarray(a))
                for a in args], **attrs)

    def as_list(r):
        r = r if isinstance(r, (tuple, list)) else (r,)
        return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
                for x in r]

    return as_list(got), as_list(want)


def assert_close(got, want, atol=ATOL, rtol=RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


def test_every_op_has_the_reference_slots():
    """Each registered op reads the JAX op's input slots and writes its
    output slots, so a program of one package binds in the other."""
    for name, opdef in registry.all_ops().items():
        ref = jax_op(name)
        assert opdef.input_slots == ref.input_slots, name
        assert opdef.output_slots == ref.output_slots, name
        assert opdef.needs_rng == ref.needs_rng, name


# ------------------------------------------------------------ elementwise

EW_CASES = {
    'same_shape': ((2, 3), (2, 3), -1),
    'bias_axis1': ((2, 3, 4, 5), (3,), 1),
    'trailing': ((2, 3, 4, 5), (4, 5), -1),
    'middle': ((2, 3, 4, 5), (3, 4), 1),
    'fc_bias': ((4, 10), (10,), 1),
    'broadcast_rank': ((2, 3, 4), (1, 3, 1), -1),
}


@pytest.mark.parametrize('case', sorted(EW_CASES))
@pytest.mark.parametrize('op', ['add', 'sub', 'mul', 'div'])
def test_elementwise_matches_jax(op, case):
    xs, ys, axis = EW_CASES[case]
    rng = np.random.RandomState(len(case) + len(op))
    x = rng.standard_normal(xs).astype(np.float32)
    y = rng.standard_normal(ys).astype(np.float32)
    if op == 'div':
        y = np.sign(y) * (np.abs(y) + 0.5)
    assert_close(*run_both(f'elementwise_{op}', [x, y], {'axis': axis}))


# ------------------------------------------------------------ products

@pytest.mark.parametrize('xs,ys,xn,yn', [
    ((4, 6), (6, 5), 1, 1), ((2, 3, 4), (4, 5), 2, 1),
    ((2, 3, 4, 5), (60, 7), 1, 1), ((6, 12), (3, 4, 5), 1, 2)],
    ids=['2d', 'x2', 'flatten', 'y2'])
def test_mul_matches_jax(xs, ys, xn, yn):
    rng = np.random.RandomState(3)
    x = rng.standard_normal(xs).astype(np.float32)
    y = rng.standard_normal(ys).astype(np.float32)
    assert_close(*run_both('mul', [x, y], {'x_num_col_dims': xn,
                                           'y_num_col_dims': yn}))


@pytest.mark.parametrize('tx,ty,alpha', [(False, False, 1.0),
                                         (True, False, 0.5),
                                         (False, True, 2.0)])
def test_matmul_matches_jax(tx, ty, alpha):
    rng = np.random.RandomState(4)
    x = rng.standard_normal((2, 4, 3) if tx else (2, 3, 4)).astype(
        np.float32)
    y = rng.standard_normal((5, 4) if ty else (4, 5)).astype(np.float32)
    assert_close(*run_both('matmul', [x, y], {
        'transpose_x': tx, 'transpose_y': ty, 'alpha': alpha}))


@pytest.mark.parametrize('after', [True, False])
def test_scale_matches_jax(after):
    x = np.random.RandomState(5).standard_normal((3, 7)).astype(np.float32)
    assert_close(*run_both('scale', [x], {'scale': 0.3, 'bias': -1.25,
                                          'bias_after_scale': after}))


# ------------------------------------------------------------ reductions

def test_mean_matches_jax():
    x = np.random.RandomState(6).standard_normal((4, 5, 6)).astype(
        np.float32)
    assert_close(*run_both('mean', [x]))


@pytest.mark.parametrize('attrs', [
    {}, {'dim': 1}, {'dim': [0, 2]}, {'dim': -1, 'keep_dim': True},
    {'dim': 1, 'reduce_all': True}, {'keep_dim': True}],
    ids=['all', 'dim1', 'dims02', 'last_keep', 'reduce_all', 'all_keep'])
@pytest.mark.parametrize('op', ['reduce_sum', 'reduce_mean'])
def test_reduce_matches_jax(op, attrs):
    x = np.random.RandomState(7).standard_normal((3, 4, 5)).astype(
        np.float32)
    assert_close(*run_both(op, [x], attrs))


# ------------------------------------------------------------ nn / metrics

@pytest.mark.parametrize('axis', [-1, 1])
def test_softmax_matches_jax(axis):
    x = (np.random.RandomState(8).standard_normal((4, 6, 3)) * 3).astype(
        np.float32)
    assert_close(*run_both('softmax', [x], {'axis': axis}))


@pytest.mark.parametrize('k', [1, 3])
@pytest.mark.parametrize('label_shape', [(16, 1), (16,)], ids=['n1', 'n'])
def test_accuracy_matches_jax(k, label_shape):
    rng = np.random.RandomState(9)
    pred = rng.standard_normal((16, 10)).astype(np.float32)
    label = rng.randint(0, 10, label_shape).astype(np.int64)
    label[:4] = pred[:4].argmax(-1).reshape((4,) + label_shape[1:])
    got, want = run_both('accuracy', [pred, label], {'k': k})
    assert_close(got, want)
    assert [g.dtype for g in got] == [np.float32, np.int32, np.int32]


@pytest.mark.parametrize('impl', ['downgrade_in_infer', 'upscale_in_train'])
def test_dropout_at_test_time_matches_jax(impl):
    x = np.random.RandomState(10).standard_normal((4, 8)).astype(np.float32)
    assert_close(*run_both('dropout', [x], {
        'dropout_prob': 0.3, 'is_test': True,
        'dropout_implementation': impl}))


@pytest.mark.parametrize('impl', ['downgrade_in_infer', 'upscale_in_train'])
def test_dropout_in_training_keeps_its_share(impl):
    """The masks come from the device's generator (not the JAX PRNG), so
    the kept share and the kept values are checked: 1 - p of 40,000
    elements within 0.01 (some 6 standard deviations)."""
    p = 0.3
    x = torch.ones(200, 200)
    g = torch.Generator().manual_seed(0)
    y = registry.get_op('dropout').fn(x, dropout_prob=p, is_test=False,
                                      dropout_implementation=impl, key=g)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    want = 1 / (1 - p) if impl == 'upscale_in_train' else 1.0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], want))


# ------------------------------------------------------------ tensor ops

@pytest.mark.parametrize('dtype,value', [('float32', 2.5), ('int32', 7),
                                         ('int64', -3)])
def test_fill_constant_matches_jax(dtype, value):
    got, want = run_both('fill_constant', [], {'shape': [2, 3],
                                               'value': value,
                                               'dtype': dtype})
    assert_close(got, want)
    assert got[0].dtype == np.dtype(dtype)


@pytest.mark.parametrize('src,dst', [('float32', 'int32'),
                                     ('int64', 'float32'),
                                     ('float32', 'int64')])
def test_cast_matches_jax(src, dst):
    x = (np.random.RandomState(11).standard_normal((3, 4)) * 5).astype(src)
    got, want = run_both('cast', [x], {'dtype': dst})
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.dtype(dst)


@pytest.mark.parametrize('shape', [[0, -1], [6, 2, 2], [-1, 4], [0, 3, 0]])
def test_reshape_matches_jax(shape):
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    if shape == [0, 3, 0]:
        x = x.reshape(2, 3, 4)
    assert_close(*run_both('reshape', [x], {'shape': shape}))


# ------------------------------------------------------------ optimizer ops

def _opt_inputs(rng, shape=(5, 7)):
    p = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return p, g, np.asarray([0.01], np.float32)


def test_sgd_matches_jax():
    p, g, lr = _opt_inputs(np.random.RandomState(12))
    assert_close(*run_both('sgd', [p, g, lr]))


@pytest.mark.parametrize('nesterov', [False, True])
def test_momentum_matches_jax(nesterov):
    rng = np.random.RandomState(13)
    p, g, lr = _opt_inputs(rng)
    v = (rng.standard_normal(p.shape) * 0.1).astype(np.float32)
    got, want = run_both('momentum', [p, g, v, lr],
                         {'mu': 0.9, 'use_nesterov': nesterov})
    assert len(got) == 2          # ParamOut, VelocityOut
    assert_close(got, want)


def test_adam_matches_jax():
    rng = np.random.RandomState(14)
    p, g, lr = _opt_inputs(rng)
    m1 = (rng.standard_normal(p.shape) * 0.01).astype(np.float32)
    m2 = (rng.random_sample(p.shape) * 1e-3).astype(np.float32)
    b1p = np.asarray([0.9 ** 3], np.float32)
    b2p = np.asarray([0.999 ** 3], np.float32)
    got, want = run_both('adam', [p, g, m1, m2, b1p, b2p, lr],
                         {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8})
    assert len(got) == 5          # ParamOut, Moment1/2Out, Beta1/2PowOut
    assert_close(got, want)


def test_registered_updates_are_functional():
    """The registry's momentum and adam return new tensors and leave their
    inputs as they were (the dygraph forms update in place)."""
    p, g, v = torch.ones(3), torch.ones(3), torch.zeros(3)
    out = registry.get_op('momentum').fn(p, g, v, torch.tensor([0.1]))
    assert out[0] is not p and torch.equal(p, torch.ones(3))
    assert torch.equal(v, torch.zeros(3))
