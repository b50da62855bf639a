"""The ops of the port's ResNet slice (paddle_tpu_torch/ops/nn_ops.py conv2d,
pool2d, batch_norm; ops/pallas_conv.py stem_space_to_depth and the fused
1x1 conv + BN + act op K4; ops/optimizer_ops.py momentum) against the JAX
package's, on the CPU with the same numpy inputs. The JAX K4 runs as its
own tests run it: ``force_pallas=True`` in Pallas interpret mode.

Tolerances:
- f32 convolutions, pools, batch norm, the s2d stem and K4's plain version:
  atol 1e-5 and rtol 1e-5 (f32 sums of at most a few hundred products in
  another order), except the s2d stem against a plain conv, 1e-4 as the
  reference's own test (the re-layout sums the 147 products in another
  grouping), and the 224x224 stem against the JAX op, atol 1e-4;
- bf16 K4 against the JAX kernel: within one bf16 ulp of the larger value
  (both sum the exact products in f32 and round once, so they differ only
  where the two f32 sums straddle a rounding boundary), plus 1e-6 absolute;
- bf16 batch norm: one bf16 ulp of the output's scale (2**-7 * 4), since
  both compute the same chain of bf16 operations from f32 statistics that
  differ in their last f32 bits;
- gradients of K4 and conv2d against ``jax.grad``: atol 1e-5, rtol 1e-4;
- momentum: atol 1e-7 (a few f32 operations); the multi-tensor update
  bitwise equal to the per-tensor one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import nn_ops as jnn
from paddle_tpu.ops import optimizer_ops as jopt
from paddle_tpu.ops import pallas_conv as jpc
from paddle_tpu_torch.ops import nn_ops, optimizer_ops, pallas_conv
import torch_jax_seed  # noqa: F401  (caps torch's threads)

TOL = dict(atol=1e-5, rtol=1e-5)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def hwio_to_oihw(w):
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


# ---------------------------------------------------------------- conv2d --

CONV_CASES = {
    'nchw-7x7-s2-p3': ('NCHW', (2, 3, 17, 17), (8, 3, 7, 7),
                       dict(stride=2, padding=3)),
    'nhwc-7x7-s2-p3': ('NHWC', (2, 17, 17, 3), (8, 3, 7, 7),
                       dict(stride=2, padding=3)),
    'nchw-3x3-groups': ('NCHW', (2, 8, 9, 9), (6, 4, 3, 3),
                        dict(stride=1, padding=1, groups=2)),
    'nhwc-3x3-s2-groups': ('NHWC', (2, 10, 10, 8), (8, 2, 3, 3),
                           dict(stride=2, padding=1, groups=4)),
    'nchw-same-s2-dilated': ('NCHW', (1, 4, 11, 12), (5, 4, 3, 3),
                             dict(stride=2, padding='SAME', dilation=2)),
    'nhwc-four-pads': ('NHWC', (1, 9, 8, 4), (5, 4, 3, 2),
                       dict(stride=(2, 1), padding=(1, 2, 0, 1))),
}


@pytest.mark.parametrize('case', list(CONV_CASES))
def test_conv2d_matches_jax(case):
    fmt, xs, ws, kw = CONV_CASES[case]
    rng = np.random.default_rng(0)
    x, w = rand(rng, *xs), rand(rng, *ws, scale=0.3)
    jw = w if fmt == 'NCHW' else w.transpose(2, 3, 1, 0)    # OIHW -> HWIO
    want = np.asarray(jnn.conv2d(x, jw, data_format=fmt, **kw))
    got = nn_ops.conv2d(t(x), t(w), data_format=fmt, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_conv2d_gradients_match_jax():
    rng = np.random.default_rng(1)
    x, w = rand(rng, 2, 9, 9, 4), rand(rng, 6, 4, 3, 3, scale=0.3)
    g = rand(rng, 2, 5, 5, 6)

    def f(x, w):
        return jnp.sum(jnn.conv2d(x, w, stride=2, padding=1,
                                  data_format='NHWC') * g)

    wx, ww = jax.grad(f, argnums=(0, 1))(x, w.transpose(2, 3, 1, 0))
    tx, tw = t(x).requires_grad_(), t(w).requires_grad_()
    (nn_ops.conv2d(tx, tw, stride=2, padding=1, data_format='NHWC')
     * t(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wx),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(),
                               hwio_to_oihw(np.asarray(ww)),
                               atol=1e-5, rtol=1e-4)


def test_conv2d_casts_x_to_the_weights_type():
    x = torch.ones(1, 2, 4, 4)
    y = nn_ops.conv2d(x, torch.ones(3, 2, 1, 1, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16


# ---------------------------------------------------------------- pool2d --

POOL_CASES = {
    'max-3-2-1': dict(pool_size=3, pool_type='max', pool_stride=2,
                      pool_padding=1),
    'global-avg': dict(pool_type='avg', global_pooling=True),
    'avg-exclusive-padded': dict(pool_size=3, pool_type='avg',
                                 pool_stride=2, pool_padding=1),
    'avg-inclusive-padded': dict(pool_size=3, pool_type='avg',
                                 pool_stride=2, pool_padding=1,
                                 exclusive=False),
    'max-ceil': dict(pool_size=2, pool_type='max', pool_stride=2,
                     ceil_mode=True),
    'avg-ceil-exclusive': dict(pool_size=3, pool_type='avg', pool_stride=2,
                               ceil_mode=True),
    'max-wide-padding': dict(pool_size=2, pool_type='max', pool_stride=1,
                             pool_padding=2),
}


@pytest.mark.parametrize('fmt', ['NCHW', 'NHWC'])
@pytest.mark.parametrize('case', list(POOL_CASES))
def test_pool2d_matches_jax(case, fmt):
    rng = np.random.default_rng(2)
    x = rand(rng, 2, 3, 9, 10) if fmt == 'NCHW' else rand(rng, 2, 9, 10, 3)
    kw = dict(POOL_CASES[case], data_format=fmt)
    want = np.asarray(jnn.pool2d(x, **kw))
    got = nn_ops.pool2d(t(x), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------------ batch_norm --

BN_CASES = {
    'nchw': ('NCHW', (4, 6, 5, 5)),
    'nhwc': ('NHWC', (4, 5, 5, 6)),
    # ResNet's last stage at 32x32 input: statistics from the batch alone
    'nhwc-1x1-batch8': ('NHWC', (8, 1, 1, 6)),
    'nchw-1x1-batch8': ('NCHW', (8, 6, 1, 1)),
}


@pytest.mark.parametrize('is_test', [False, True], ids=['train', 'eval'])
@pytest.mark.parametrize('case', list(BN_CASES))
def test_batch_norm_matches_jax(case, is_test):
    fmt, xs = BN_CASES[case]
    rng = np.random.default_rng(3)
    x = rand(rng, *xs) * 3 + 1
    c = 6
    scale, bias = rand(rng, c) + 1, rand(rng, c)
    mean, var = rand(rng, c), rng.random(c).astype(np.float32) + 0.5
    kw = dict(momentum=0.9, epsilon=1e-5, is_test=is_test, data_layout=fmt)
    want = jnn.batch_norm(x, scale, bias, mean, var, **kw)
    got = nn_ops.batch_norm(t(x), t(scale), t(bias), t(mean), t(var), **kw)
    for g, w, name in zip(got, want, ('y', 'new_mean', 'new_var')):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    if not is_test:
        # the biased batch variance moves the running one: (n-1)/n off
        # torch's unbiased update, 8/7 at the 1x1 batch of 8
        n = x.size // c
        axes = (0, 2, 3) if fmt == 'NCHW' else (0, 1, 2)
        biased = 0.9 * var + 0.1 * x.var(axis=axes)
        np.testing.assert_allclose(got[2].numpy(), biased, rtol=1e-5)
        assert n > 1


def test_batch_norm_computes_in_xs_type_from_f32_statistics():
    """Under AMP: bf16 x, bf16 scale and bias, f32 running statistics; y
    is bf16 (torch's promotion would give f32) and the new statistics f32,
    as the reference's."""
    rng = np.random.default_rng(4)
    x = rand(rng, 4, 5, 5, 6) * 2 + 1
    scale, bias = rand(rng, 6) + 1, rand(rng, 6)
    mean, var = np.zeros(6, np.float32), np.ones(6, np.float32)
    bf = jnp.bfloat16
    want = jnn.batch_norm(jnp.asarray(x, bf), jnp.asarray(scale, bf),
                          jnp.asarray(bias, bf), mean, var,
                          data_layout='NHWC')
    got = nn_ops.batch_norm(t(x).bfloat16(), t(scale).bfloat16(),
                            t(bias).bfloat16(), t(mean), t(var),
                            data_layout='NHWC')
    assert got[0].dtype == torch.bfloat16
    assert got[1].dtype == got[2].dtype == torch.float32
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32),
                               atol=2 ** -7 * 4, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_batch_norm_keeps_float64_statistics_in_float64():
    """An f64 x (a static program declared in float64) keeps f64
    statistics: values about 1e3 that differ by 1e-2, where f32's spacing
    (6e-5 at 1e3) would move y by about 1e-2 relative, against numpy in
    f64 at rtol 1e-9 (the JAX package has no f64 without x64)."""
    rng = np.random.default_rng(5)
    x = 1e3 + 1e-2 * rng.standard_normal((8, 3, 4, 4))
    scale, bias = rng.standard_normal(3) + 2, rng.standard_normal(3)
    mean, var = np.zeros(3), np.ones(3)
    y, new_mean, new_var = nn_ops.batch_norm(
        *(torch.from_numpy(a) for a in (x, scale, bias, mean, var)),
        momentum=0.9, epsilon=1e-12)
    m, v = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
    want = ((x - m[None, :, None, None]) / np.sqrt(v + 1e-12)[
        None, :, None, None] * scale[None, :, None, None]
        + bias[None, :, None, None])
    assert y.dtype == new_mean.dtype == new_var.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(new_mean.numpy(), 0.1 * m, rtol=1e-9)
    np.testing.assert_allclose(new_var.numpy(), 0.9 + 0.1 * v, rtol=1e-9)


def test_batch_norm_sync_stats_is_not_ported():
    """``sync_stats`` is ported (A.9a); with no process group it is the
    plain path, bit for bit (tests/test_torch_data_parallel.py holds two
    ranks to the JAX op on the whole batch)."""
    x = torch.randn(2, 3, generator=torch.Generator().manual_seed(0))
    plain = nn_ops.batch_norm(x, x[0], x[1], x[0] * 0, x[0] ** 2)
    synced = nn_ops.batch_norm(x, x[0], x[1], x[0] * 0, x[0] ** 2,
                               sync_stats=True)
    for a, b in zip(plain, synced):
        assert torch.equal(a, b)


# ----------------------------------------------------------- s2d stem ----

@pytest.mark.parametrize('hw', [224, 32, 30])
def test_stem_space_to_depth_matches_jax_and_plain_conv(hw):
    rng = np.random.default_rng(hw)
    x = rand(rng, 2, hw, hw, 3)
    w = rand(rng, 8, 3, 7, 7, scale=0.1)                  # OIHW
    want = np.asarray(jpc.stem_space_to_depth(x, w.transpose(2, 3, 1, 0)))
    got = pallas_conv.stem_space_to_depth(t(x), t(w))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    plain = nn_ops.conv2d(t(x), t(w), stride=2, padding=3,
                          data_format='NHWC')
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_stem_space_to_depth_rejects_what_it_does_not_take():
    x = torch.zeros(1, 8, 8, 3)
    with pytest.raises(ValueError, match='NHWC'):
        pallas_conv.stem_space_to_depth(x, torch.zeros(4, 3, 7, 7),
                                        data_format='NCHW')
    with pytest.raises(ValueError, match='7x7'):
        pallas_conv.stem_space_to_depth(x, torch.zeros(4, 3, 3, 3))


# ------------------------------------------------------------------ K4 --

# (B, H, W, C, O): the reference's parity test's and its gradient table's
K4_SHAPES = {'c16-o12': (2, 8, 8, 16, 12), 'c6-o5': (1, 4, 4, 6, 5)}


def k4_inputs(shape, seed):
    b, h, w, c, o = shape
    rng = np.random.default_rng(seed)
    return (rand(rng, b, h, w, c), rand(rng, 1, 1, c, o, scale=0.3),
            (rng.random(o) + 0.5).astype(np.float32),
            rand(rng, o, scale=0.1))


def port_args(x, w, scale, shift, dtype=torch.float32):
    return (t(x).to(dtype), t(hwio_to_oihw(w)).to(dtype), t(scale), t(shift))


@pytest.mark.parametrize('act', [None, 'relu'], ids=['none', 'relu'])
@pytest.mark.parametrize('shape', list(K4_SHAPES))
def test_fused_conv1x1_f32_matches_jax_kernel(shape, act):
    x, w, scale, shift = k4_inputs(K4_SHAPES[shape], 5)
    want = np.asarray(jpc.fused_conv1x1_bn_act(x, w, scale, shift, act=act,
                                               force_pallas=True))
    args = port_args(x, w, scale, shift)
    ref = pallas_conv.fused_conv1x1_bn_act_ref(*args, act=act)
    np.testing.assert_allclose(ref.numpy(), want, **TOL)
    nn_ops.reset_launch_counts()
    got = pallas_conv.fused_conv1x1_bn_act(*args, act=act)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # CPU tensors run the plain version: no kernel was launched
    assert set(nn_ops.launch_counts().values()) == {0}


@pytest.mark.parametrize('act', [None, 'relu'], ids=['none', 'relu'])
@pytest.mark.parametrize('shape', list(K4_SHAPES))
def test_fused_conv1x1_bf16_matches_the_jax_kernels_rounding(shape, act):
    """bf16 inputs, scale and shift cast to bf16: the f32 sum, the affine
    in f32 on it, one rounding to bf16, in both."""
    x, w, scale, shift = k4_inputs(K4_SHAPES[shape], 6)
    bf = jnp.bfloat16
    want = np.asarray(jpc.fused_conv1x1_bn_act(
        jnp.asarray(x, bf), jnp.asarray(w, bf), scale, shift, act=act,
        force_pallas=True)).astype(np.float32)
    got = pallas_conv.fused_conv1x1_bn_act(
        *port_args(x, w, scale, shift, torch.bfloat16), act=act)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.ldexp(1.0, np.frexp(big)[1] - 8)
    assert np.all(np.abs(got - want) <= ulp + 1e-6), \
        np.abs(got - want).max()


@pytest.mark.parametrize('act', [None, 'relu'], ids=['none', 'relu'])
@pytest.mark.parametrize('shape', list(K4_SHAPES))
def test_fused_conv1x1_gradients_match_jax(shape, act):
    """All four inputs, as tests/ops/test_grads.py differentiates the JAX
    op (its XLA form: the Pallas kernel has no vjp)."""
    x, w, scale, shift = k4_inputs(K4_SHAPES[shape], 7)
    b, h, ww, c, o = K4_SHAPES[shape]
    g = rand(np.random.default_rng(8), b, h, ww, o)

    def f(*a):
        return jnp.sum(jpc.fused_conv1x1_bn_act(*a, act=act) * g)

    want = jax.grad(f, argnums=(0, 1, 2, 3))(x, w, scale, shift)
    leaves = [a.requires_grad_() for a in port_args(x, w, scale, shift)]
    (pallas_conv.fused_conv1x1_bn_act(*leaves, act=act) * t(g)).sum() \
        .backward()
    got = [leaves[0].grad.numpy(),
           leaves[1].grad.numpy().transpose(2, 3, 1, 0),     # OIHW -> HWIO
           leaves[2].grad.numpy(), leaves[3].grad.numpy()]
    for name, gg, ww_ in zip(('x', 'w', 'scale', 'shift'), got, want):
        np.testing.assert_allclose(gg, np.asarray(ww_), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_fused_conv1x1_rejects_what_the_reference_rejects():
    x, w, scale, shift = port_args(*k4_inputs(K4_SHAPES['c6-o5'], 9))
    with pytest.raises(ValueError, match='NHWC'):
        pallas_conv.fused_conv1x1_bn_act(x, w, scale, shift,
                                         data_format='NCHW')
    with pytest.raises(ValueError, match='1x1'):
        pallas_conv.fused_conv1x1_bn_act(x, torch.zeros(5, 6, 3, 3), scale,
                                         shift)
    with pytest.raises(ValueError, match='act'):
        pallas_conv.fused_conv1x1_bn_act(x, w, scale, shift, act='gelu')


def test_fused_conv1x1_casts_x_to_the_weights_type():
    x, w, scale, shift = port_args(*k4_inputs(K4_SHAPES['c6-o5'], 10))
    y = pallas_conv.fused_conv1x1_bn_act(x, w.bfloat16(), scale, shift)
    assert y.dtype == torch.bfloat16


# ------------------------------------------------------------ momentum --

@pytest.mark.parametrize('nesterov', [False, True], ids=['plain', 'nesterov'])
def test_momentum_matches_jax(nesterov):
    rng = np.random.default_rng(11)
    p, g, v = rand(rng, 7, 5), rand(rng, 7, 5), rand(rng, 7, 5)
    wp, wv = jopt.momentum(p, g, v, np.float32(0.1), mu=0.9,
                           use_nesterov=nesterov)
    tp, tv = t(p.copy()), t(v.copy())
    out = optimizer_ops.momentum(tp, t(g), tv, 0.1, mu=0.9,
                                 use_nesterov=nesterov)
    assert out is tp
    np.testing.assert_allclose(tp.numpy(), np.asarray(wp), atol=1e-7)
    np.testing.assert_allclose(tv.numpy(), np.asarray(wv), atol=1e-7)


@pytest.mark.parametrize('nesterov', [False, True], ids=['plain', 'nesterov'])
def test_multi_tensor_momentum_gives_the_per_tensor_bits(nesterov):
    rng = np.random.default_rng(12)
    shapes = [(64, 3, 7, 7), (64,), (10, 2048)]
    ps = [rand(rng, *s) for s in shapes]
    gs = [rand(rng, *s) for s in shapes]
    vs = [rand(rng, *s) for s in shapes]
    one = [(t(p.copy()), t(v.copy())) for p, v in zip(ps, vs)]
    many_p = [t(p.copy()) for p in ps]
    many_v = [t(v.copy()) for v in vs]
    for _ in range(2):
        for (p, v), g in zip(one, gs):
            optimizer_ops.momentum(p, t(g), v, 0.1, mu=0.9,
                                   use_nesterov=nesterov)
        optimizer_ops.multi_tensor_momentum(
            many_p, [t(g) for g in gs], many_v, 0.1, mu=0.9,
            use_nesterov=nesterov)
    for (p, v), mp, mv in zip(one, many_p, many_v):
        assert torch.equal(p, mp) and torch.equal(v, mv)
