"""The ops of the dygraph layers slice (ROADMAP A.4c) against the JAX
package's, on the CPU: every activation of paddle_tpu/ops/math_ops.py,
``conv3d``, ``conv2d_transpose``, ``conv3d_transpose``, ``group_norm`` and
``bilinear_tensor_product`` of ops/nn_ops.py, ``spectral_norm``, ``nce``,
``gru_unit`` and ``tree_conv`` of ops/extra_ops.py, and ``temporal_shift``
of ops/tensor_ops.py. Each runs on the same seeded numpy inputs in both
packages; the gradients are the vjp of a seeded random cotangent of every
output, with respect to every floating input.

Tolerances, f32:

- elementwise ops: values and gradients atol 1e-6, rtol 1e-5 (the same
  formula, transcendental functions of two libraries a few ulps apart),
  with inputs on each op's breakpoints (0 for the relus and ``abs``, each
  clip's bounds, the shrinks' thresholds, ``round``'s halves, ``maxout``'s
  two- and three-way ties), where the two must pick the same branch: a
  branch-picking op's gradient there is exact in both, so it is compared
  at the same tolerance;
- convolutions, ``group_norm``, the products and ``spectral_norm``: values
  atol 1e-5, rtol 1e-5, gradients atol 1e-4, rtol 1e-4 (sums of up to a
  few hundred f32 products in another order);
- ``temporal_shift``: exactly (it moves values).

``nce``'s negatives come from each package's own generator, so the loss is
held with the JAX op's negatives given to the port's plain
``nce_loss`` (atol 1e-6), and the port's sampler is held to its range and
to uniformity on its own (20,000 draws over 10 classes, each count within
5 standard deviations of 2,000).

Where the JAX op departs from Paddle 1.7 (ROADMAP C.4 items 12 and
15-20), a test holds each side: what the JAX op does, and what the port
does (the same, or Paddle's documented result against a float64 witness,
or a raise naming the item).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import extra_ops as jextra
from paddle_tpu.ops import nn_ops as jnn
from paddle_tpu.ops import tensor_ops as jtensor
from paddle_tpu.ops.registry import get_op as jget
from paddle_tpu_torch.ops import extra_ops, nn_ops, tensor_ops
from paddle_tpu_torch.ops.registry import get_op
import torch_jax_seed  # noqa: F401  (caps torch's threads)

EW = dict(atol=1e-6, rtol=1e-5)
SUM = dict(atol=1e-5, rtol=1e-5)
SUM_GRAD = dict(atol=1e-4, rtol=1e-4)


def rng(seed):
    return np.random.RandomState(seed)


def f32(r, *shape):
    return r.randn(*shape).astype(np.float32)


def run_both(port_fn, jax_fn, arrays, grad_of, seed=7):
    """(port outputs, JAX outputs, port grads, JAX grads) of the functions
    on ``arrays``: the gradients of ``Σ out · c`` (a seeded cotangent c a
    output) with respect to the arrays whose indices are ``grad_of``."""
    ts = [torch.tensor(a, requires_grad=i in grad_of)
          for i, a in enumerate(arrays)]
    out = port_fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    r = rng(seed)
    cots = [r.randn(*o.shape).astype(np.float32) for o in outs]
    total = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    pgrads = torch.autograd.grad(total, [ts[i] for i in grad_of])

    def jfun(*diff):
        args = list(arrays)
        for i, d in zip(grad_of, diff):
            args[i] = d
        return jax_fn(*args)

    jout, vjp = jax.vjp(jfun, *[jnp.asarray(arrays[i]) for i in grad_of])
    jouts = jout if isinstance(jout, tuple) else (jout,)
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots) if isinstance(
        jout, tuple) else jnp.asarray(cots[0]))
    return ([o.detach().numpy() for o in outs],
            [np.asarray(o) for o in jouts],
            [g.numpy() for g in pgrads], [np.asarray(g) for g in jgrads])


def assert_both(got, tol, grad_tol):
    pouts, jouts, pgrads, jgrads = got
    assert len(pouts) == len(jouts)
    for p, j in zip(pouts, jouts):
        assert p.shape == j.shape
        np.testing.assert_allclose(p, j, **tol)
    for p, j in zip(pgrads, jgrads):
        np.testing.assert_allclose(p, j, **grad_tol)


# ------------------------------------------------------------ activations

# case: (op, attrs, breakpoints placed in the input, input domain)
ACTIVATIONS = {
    'logsigmoid': ('logsigmoid', {}, [0.0], 'real'),
    'atan': ('atan', {}, [0.0], 'real'),
    'tanh_shrink': ('tanh_shrink', {}, [0.0], 'real'),
    'rsqrt': ('rsqrt', {}, [1.0], 'pos'),
    'abs': ('abs', {}, [0.0, -0.0], 'real'),
    'sin': ('sin', {}, [0.0], 'real'),
    'acos': ('acos', {}, [0.0], 'unit'),
    'asin': ('asin', {}, [0.0], 'unit'),
    'cosh': ('cosh', {}, [0.0], 'real'),
    'sinh': ('sinh', {}, [0.0], 'real'),
    'round': ('round', {}, [0.5, 1.5, 2.5, -0.5, -1.5], 'real'),
    'reciprocal': ('reciprocal', {}, [1.0], 'pos'),
    'softplus': ('softplus', {}, [0.0, 30.0], 'real'),
    'softsign': ('softsign', {}, [0.0], 'real'),
    'erf': ('erf', {}, [0.0], 'real'),
    'gelu': ('gelu', {}, [0.0], 'real'),
    'gelu_tanh': ('gelu', {'approximate': True}, [0.0], 'real'),
    'leaky_relu': ('leaky_relu', {}, [0.0], 'real'),
    'leaky_relu_alpha': ('leaky_relu', {'alpha': 0.2}, [0.0], 'real'),
    'relu6': ('relu6', {}, [0.0, 6.0], 'wide'),
    'relu6_threshold': ('relu6', {'threshold': 2.0}, [0.0, 2.0], 'real'),
    'elu': ('elu', {}, [0.0], 'real'),
    'elu_alpha': ('elu', {'alpha': 0.5}, [0.0], 'real'),
    'selu': ('selu', {}, [0.0], 'real'),
    'brelu': ('brelu', {}, [0.0, 24.0], 'wide'),
    'brelu_bounds': ('brelu', {'t_min': -1.0, 't_max': 1.0}, [-1.0, 1.0],
                     'real'),
    'soft_relu': ('soft_relu', {}, [-40.0, 40.0], 'wide'),
    'soft_relu_threshold': ('soft_relu', {'threshold': 1.0}, [-1.0, 1.0],
                            'real'),
    'stanh': ('stanh', {}, [0.0], 'real'),
    'hard_sigmoid': ('hard_sigmoid', {}, [-2.5, 2.5], 'wide'),
    'hard_swish': ('hard_swish', {}, [-3.0, 3.0], 'wide'),
    'swish': ('swish', {}, [0.0], 'real'),
    'swish_beta': ('swish', {'beta': 2.0}, [0.0], 'real'),
    'hard_shrink': ('hard_shrink', {}, [-0.5, 0.5, 0.0], 'real'),
    'softshrink': ('softshrink', {}, [-0.5, 0.5, 0.0], 'real'),
    'softshrink_lambda': ('softshrink', {'lambda_': 0.25}, [-0.25, 0.25],
                          'real'),
    'thresholded_relu': ('thresholded_relu', {}, [1.0, 0.0], 'real'),
}


def activation_input(name, breaks, domain):
    r = rng(sum(map(ord, name)))
    if domain == 'pos':
        x = r.uniform(0.2, 3.0, (3, 8))
    elif domain == 'unit':
        x = r.uniform(-0.9, 0.9, (3, 8))
    elif domain == 'wide':
        x = r.uniform(-50.0, 50.0, (3, 8))
    else:
        x = r.randn(3, 8) * 2.0
    x = x.astype(np.float32)
    x.reshape(-1)[:len(breaks)] = breaks
    return x


@pytest.mark.parametrize('case', sorted(ACTIVATIONS))
def test_activation_matches_jax_with_breakpoints(case):
    op, attrs, breaks, domain = ACTIVATIONS[case]
    x = activation_input(case, breaks, domain)
    got = run_both(lambda t: get_op(op).fn(t, **attrs),
                   lambda a: jget(op).fn(a, **attrs), [x], [0])
    assert_both(got, EW, EW)


@pytest.mark.parametrize('mode', ['all', 'channel', 'element'])
def test_prelu_matches_jax(mode):
    r = rng(3)
    x = f32(r, 4, 6)
    x[0, :3] = 0.0
    alpha = {'all': r.rand(1), 'channel': r.rand(6),
             'element': r.rand(6)}[mode].astype(np.float32)
    got = run_both(lambda t, a: get_op('prelu').fn(t, a, mode=mode),
                   lambda t, a: jget('prelu').fn(t, a, mode=mode),
                   [x, alpha], [0, 1])
    assert_both(got, EW, EW)


def test_prelu_channel_mode_on_images_matches_jax():
    r = rng(4)
    x = f32(r, 2, 3, 4, 4)
    x[0, :, 0, 0] = 0.0
    alpha = r.rand(3).astype(np.float32)
    got = run_both(lambda t, a: get_op('prelu').fn(t, a, mode='channel'),
                   lambda t, a: jget('prelu').fn(t, a, mode='channel'),
                   [x, alpha], [0, 1])
    assert_both(got, EW, EW)


def test_prelu_element_mode_on_images_is_paddles_where_jax_raises():
    """ROADMAP C.4 item 20: the JAX op broadcasts the flat (C*H*W,) alpha
    against (N, C, H, W) and raises; the port reads it as (C, H, W),
    Paddle's documented per-element alpha (float64 witness, atol 1e-6)."""
    r = rng(5)
    x = f32(r, 2, 3, 4, 5)
    alpha = r.rand(60).astype(np.float32)
    with pytest.raises(Exception):
        jget('prelu').fn(jnp.asarray(x), jnp.asarray(alpha), mode='element')
    got = get_op('prelu').fn(torch.from_numpy(x), torch.from_numpy(alpha),
                             mode='element').numpy()
    x64 = x.astype(np.float64)
    want = np.where(x64 >= 0, x64, alpha.astype(np.float64).reshape(
        3, 4, 5) * x64)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize('groups,axis,shape', [(2, 1, (2, 6, 3)),
                                               (3, 1, (2, 6, 2, 2)),
                                               (2, 2, (2, 3, 4))])
def test_maxout_matches_jax_at_ties(groups, axis, shape):
    r = rng(6)
    x = f32(r, *shape)
    idx = [0] * len(shape)
    for k in range(groups):       # a tie across a whole group
        idx[axis] = k
        x[tuple(idx)] = 1.5
    idx[axis] = groups            # and a two-way tie in the next
    if shape[axis] >= 2 * groups:
        x[tuple(idx)] = -0.25
        idx[axis] = groups + 1
        x[tuple(idx)] = -0.25
    got = run_both(lambda t: get_op('maxout').fn(t, groups=groups, axis=axis),
                   lambda a: jget('maxout').fn(a, groups=groups, axis=axis),
                   [x], [0])
    assert_both(got, EW, EW)


def test_every_jax_activation_is_registered_in_the_port():
    """Every op of paddle_tpu/ops/math_ops.py's activation section (the
    unary rows and the activations, lines 139-264) runs in the port."""
    from paddle_tpu.ops import math_ops as jmath
    names = {jget(n).name for n in (
        'sigmoid', 'logsigmoid', 'exp', 'tanh', 'atan', 'tanh_shrink',
        'sqrt', 'rsqrt', 'abs', 'ceil', 'floor', 'cos', 'sin', 'acos',
        'asin', 'cosh', 'sinh', 'round', 'reciprocal', 'log', 'square',
        'softplus', 'softsign', 'relu', 'sign', 'erf', 'gelu', 'leaky_relu',
        'relu6', 'elu', 'selu', 'prelu', 'brelu', 'soft_relu', 'stanh',
        'hard_sigmoid', 'hard_swish', 'swish', 'hard_shrink', 'softshrink',
        'thresholded_relu', 'maxout', 'pow')}
    assert jmath.maxout is jget('maxout').fn
    for n in names:
        assert get_op(n).input_slots == jget(n).input_slots, n


# ------------------------------------------------------------ convolutions

CONV3D = {
    'groups2_strided': (dict(stride=(1, 2, 1), padding=1, dilation=(1, 1, 2),
                             groups=2), (2, 4, 5, 6, 7), (6, 2, 3, 3, 3)),
    'same': (dict(stride=2, padding='SAME'), (1, 3, 5, 6, 5),
             (4, 3, 3, 2, 3)),
    'valid': (dict(padding='VALID'), (1, 2, 4, 4, 4), (3, 2, 2, 2, 2)),
}


@pytest.mark.parametrize('case', sorted(CONV3D))
def test_conv3d_matches_jax(case):
    attrs, xs, ws = CONV3D[case]
    r = rng(10)
    x, w = f32(r, *xs), f32(r, *ws) * 0.3
    got = run_both(lambda a, b: nn_ops.conv3d(a, b, **attrs),
                   lambda a, b: jnn.conv3d(a, b, **attrs), [x, w], [0, 1])
    assert_both(got, SUM, SUM_GRAD)


def test_conv3d_ndhwc_takes_dhwio_weights_as_jax():
    r = rng(11)
    x, w = f32(r, 2, 4, 5, 3, 4), f32(r, 3, 3, 3, 4, 5) * 0.3
    kw = dict(padding=1, data_format='NDHWC')
    got = run_both(lambda a, b: nn_ops.conv3d(a, b, **kw),
                   lambda a, b: jnn.conv3d(a, b, **kw), [x, w], [0, 1])
    assert_both(got, SUM, SUM_GRAD)


CONV2D_T = {
    'dcgan': (dict(stride=2, padding=1), (2, 8, 4, 4), (8, 4, 4, 4)),
    'groups2_dilated': (dict(groups=2, dilation=2), (2, 4, 5, 5),
                        (4, 3, 3, 3)),
    'stride3_pad2': (dict(stride=3, padding=2), (1, 3, 4, 3), (3, 2, 3, 3)),
    'rect': (dict(stride=(2, 1), padding=(1, 0)), (1, 2, 3, 4),
             (2, 3, 3, 2)),
}


@pytest.mark.parametrize('case', sorted(CONV2D_T))
def test_conv2d_transpose_matches_jax(case):
    attrs, xs, ws = CONV2D_T[case]
    r = rng(12)
    x, w = f32(r, *xs), f32(r, *ws) * 0.3
    got = run_both(lambda a, b: nn_ops.conv2d_transpose(a, b, **attrs),
                   lambda a, b: jnn.conv2d_transpose(a, b, **attrs),
                   [x, w], [0, 1])
    assert_both(got, SUM, SUM_GRAD)


def test_conv2d_transpose_output_size_the_jax_op_never_reads():
    """ROADMAP C.4 item 12: the JAX op returns the computed size whatever
    ``output_size`` says; the port accepts that size and raises on any
    other, naming the item."""
    r = rng(13)
    x, w = f32(r, 1, 2, 4, 4), f32(r, 2, 3, 3, 3)
    out = jnn.conv2d_transpose(jnp.asarray(x), jnp.asarray(w), stride=2,
                               output_size=[10, 10])
    assert out.shape == (1, 3, 9, 9)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = nn_ops.conv2d_transpose(tx, tw, stride=2, output_size=[9, 9])
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **SUM)
    assert nn_ops.conv2d_transpose(tx, tw, stride=2,
                                   output_size=9).shape == (1, 3, 9, 9)
    with pytest.raises(NotImplementedError, match=r'C\.4 item 12'):
        nn_ops.conv2d_transpose(tx, tw, stride=2, output_size=[10, 10])


def test_conv3d_transpose_matches_jax():
    r = rng(14)
    x, w = f32(r, 2, 3, 3, 4, 3), f32(r, 3, 4, 3, 3, 2) * 0.3
    kw = dict(stride=2, padding=1)
    got = run_both(lambda a, b: nn_ops.conv3d_transpose(a, b, **kw),
                   lambda a, b: jnn.conv3d_transpose(a, b, **kw),
                   [x, w], [0, 1])
    assert_both(got, SUM, SUM_GRAD)


def test_grouped_conv3d_transpose_is_paddles_where_jax_raises():
    """ROADMAP C.4 item 19: with groups 2 the JAX op swaps the IODHW
    weight's first two axes only and raises; the port's grouped transposed
    convolution equals each group through the JAX op at groups 1,
    concatenated (atol/rtol 1e-5)."""
    r = rng(15)
    x, w = f32(r, 2, 4, 3, 3, 3), f32(r, 4, 3, 2, 2, 2) * 0.3
    with pytest.raises(Exception):
        jnn.conv3d_transpose(jnp.asarray(x), jnp.asarray(w), stride=2,
                             groups=2)
    got = nn_ops.conv3d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                                  stride=2, groups=2).numpy()
    want = np.concatenate([np.asarray(jnn.conv3d_transpose(
        jnp.asarray(x[:, 2 * g:2 * g + 2]), jnp.asarray(w[2 * g:2 * g + 2]),
        stride=2)) for g in range(2)], axis=1)
    assert got.shape == (2, 6, 6, 6, 6)
    np.testing.assert_allclose(got, want, **SUM)


# ------------------------------------------------------------ norms, products

@pytest.mark.parametrize('shape,groups,affine', [((2, 6, 3, 4), 3, True),
                                                 ((3, 8, 5), 2, True),
                                                 ((2, 4, 2, 2), 4, False)])
def test_group_norm_matches_jax(shape, groups, affine):
    r = rng(16)
    x = f32(r, *shape) * 2.0 + 0.5
    c = shape[1]
    s, b = (r.rand(c) + 0.5).astype(np.float32), f32(r, c)
    if affine:
        got = run_both(
            lambda a, sc, bi: nn_ops.group_norm(a, sc, bi, groups=groups),
            lambda a, sc, bi: jnn.group_norm(a, sc, bi, groups=groups),
            [x, s, b], [0, 1, 2])
    else:
        got = run_both(lambda a: nn_ops.group_norm(a, groups=groups),
                       lambda a: jnn.group_norm(a, groups=groups), [x], [0])
    assert_both(got, SUM, SUM_GRAD)


def test_group_norm_nhwc_is_grouped_as_nchw_in_jax_and_raises_here():
    """ROADMAP C.4 item 17: the JAX op's NHWC result is its NCHW result on
    the same array (the layout is never read); the port raises."""
    x = f32(rng(17), 2, 4, 3, 6)      # N, H, W, C
    a = jnp.asarray(x)
    np.testing.assert_array_equal(
        np.asarray(jnn.group_norm(a, groups=2, data_layout='NHWC')),
        np.asarray(jnn.group_norm(a, groups=2)))
    with pytest.raises(NotImplementedError, match=r'C\.4 item 17'):
        nn_ops.group_norm(torch.from_numpy(x), groups=2, data_layout='NHWC')


def test_bilinear_tensor_product_matches_jax():
    r = rng(18)
    arrays = [f32(r, 5, 3), f32(r, 5, 4), f32(r, 2, 3, 4), f32(r, 2)]
    got = run_both(nn_ops.bilinear_tensor_product,
                   jnn.bilinear_tensor_product, arrays, [0, 1, 2, 3])
    assert_both(got, SUM, SUM_GRAD)


# ------------------------------------------------------------ extra ops

@pytest.mark.parametrize('shape,dim,iters', [((4, 6), 0, 1), ((3, 2, 4), 1, 3),
                                             ((5, 5), 1, 2)])
def test_spectral_norm_matches_jax(shape, dim, iters):
    w = f32(rng(19), *shape)
    kw = dict(dim=dim, power_iters=iters)
    got = run_both(lambda a: extra_ops.spectral_norm(a, **kw),
                   lambda a: jextra.spectral_norm(a, **kw), [w], [0])
    assert_both(got, SUM, SUM_GRAD)


def test_spectral_norm_restarts_its_power_iteration_from_ones():
    """ROADMAP C.4 item 16: two calls give the same result in both
    packages (no U or V kept), equal to one power step from ones in
    float64 (rtol 1e-5); Paddle, keeping U and V, would move on the
    second call."""
    w = f32(rng(20), 6, 4)
    first = extra_ops.spectral_norm(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(
        first, extra_ops.spectral_norm(torch.from_numpy(w)).numpy())
    jw = jnp.asarray(w)
    np.testing.assert_array_equal(np.asarray(jextra.spectral_norm(jw)),
                                  np.asarray(jextra.spectral_norm(jw)))
    w64 = w.astype(np.float64)
    v = w64.T @ np.ones(6)
    v /= np.linalg.norm(v)
    u = w64 @ v
    u /= np.linalg.norm(u)
    np.testing.assert_allclose(first, w64 / (u @ w64 @ v), rtol=1e-5)


@pytest.mark.parametrize('origin_mode', [False, True])
def test_gru_unit_matches_jax(origin_mode):
    r = rng(21)
    d = 4
    arrays = [f32(r, 3, 3 * d), f32(r, 3, d), f32(r, d, 3 * d) * 0.5,
              f32(r, 1, 3 * d)]
    got = run_both(
        lambda *a: extra_ops.gru_unit(*a, origin_mode=origin_mode),
        lambda *a: jextra.gru_unit(*a, origin_mode=origin_mode), arrays,
        [0, 1, 2, 3])
    assert_both(got, SUM, SUM_GRAD)


def test_tree_conv_matches_jax_and_never_reads_edges():
    """ROADMAP C.4 item 15: ``edges`` changes nothing in either package."""
    r = rng(22)
    nodes, w = f32(r, 2, 5, 3), f32(r, 3, 3, 4, 2)
    edges = r.randint(0, 5, (2, 4, 2)).astype(np.int64)
    got = run_both(lambda n, wt: extra_ops.tree_conv(n, torch.from_numpy(
        edges), wt), lambda n, wt: jextra.tree_conv(n, edges, wt),
        [nodes, w], [0, 1])
    assert_both(got, SUM, SUM_GRAD)
    other = np.zeros_like(edges)
    np.testing.assert_array_equal(
        extra_ops.tree_conv(torch.from_numpy(nodes), torch.from_numpy(other),
                            torch.from_numpy(w)).numpy(), got[0][0])
    np.testing.assert_array_equal(
        np.asarray(jextra.tree_conv(jnp.asarray(nodes), other,
                                    jnp.asarray(w))),
        np.asarray(jextra.tree_conv(jnp.asarray(nodes), edges,
                                    jnp.asarray(w))))


def test_nce_loss_matches_jax_given_its_negatives():
    r = rng(23)
    classes, negs = 50, 6
    x, w, b = f32(r, 8, 5), f32(r, classes, 5) * 0.3, f32(r, classes) * 0.1
    label = r.randint(0, classes, (8, 1)).astype(np.int64)
    key = jax.random.PRNGKey(3)
    neg = np.asarray(jax.random.randint(key, (negs,), 0, classes))
    got = run_both(
        lambda a, wt, bi: extra_ops.nce_loss(a, torch.from_numpy(label), wt,
                                             bi, torch.from_numpy(neg)),
        lambda a, wt, bi: jextra.nce(a, label, wt, bi,
                                     num_total_classes=classes,
                                     num_neg_samples=negs, key=key),
        [x, w, b], [0, 1, 2])
    assert_both(got, EW, EW)


def test_nce_draws_uniform_negatives_in_range_from_its_generator(
        monkeypatch):
    """The sampler's negatives: in [0, classes), uniform (20,000 draws over
    10 classes, each count within 5 standard deviations of 2,000), one set
    for the batch, the same for the same generator state."""
    classes, n = 10, 20000
    seen, plain = [], extra_ops.nce_loss

    def capture(x, label, weight, bias, negatives):
        seen.append(negatives)
        return plain(x, label, weight, bias, negatives)

    monkeypatch.setattr(extra_ops, 'nce_loss', capture)
    x, label = torch.zeros(2, 3), torch.tensor([[1], [2]])
    w, b = torch.zeros(classes, 3), torch.zeros(classes)
    outs = [extra_ops.nce(x, label, w, b, num_total_classes=classes,
                          num_neg_samples=n,
                          key=torch.Generator().manual_seed(4))
            for _ in range(2)]
    assert torch.equal(seen[0], seen[1]) and seen[0].shape == (n,)
    # every logit 0: the positive and each negative add log 2
    np.testing.assert_allclose(outs[0].numpy(),
                               np.full((2, 1), (n + 1) * np.log(2.0)),
                               rtol=1e-5)
    neg = seen[0].numpy()
    assert neg.min() >= 0 and neg.max() < classes
    counts = np.bincount(neg, minlength=classes)
    sd = np.sqrt(n * 0.1 * 0.9)
    assert np.all(np.abs(counts - n / classes) < 5 * sd), counts


# ------------------------------------------------------------ temporal shift

def test_temporal_shift_matches_jax():
    x = f32(rng(24), 6, 8, 2, 3)
    got = run_both(lambda a: tensor_ops.temporal_shift(a, seg_num=3),
                   lambda a: jtensor.temporal_shift(a, seg_num=3), [x], [0])
    assert_both(got, dict(atol=0, rtol=0), dict(atol=0, rtol=0))


def test_temporal_shift_direction_is_the_jax_ops_not_paddles():
    """ROADMAP C.4 item 18: in both packages the first quarter of frame t's
    channels comes from frame t + 1 and the second from t - 1; Paddle
    1.7's documented shift (pad one frame each side, slices [0:T],
    [2:T+2], [1:T+1]) takes the first from t - 1 and the second from
    t + 1."""
    t, c = 4, 8
    x = f32(rng(25), 2 * t, c, 1, 1)
    got = tensor_ops.temporal_shift(torch.from_numpy(x), seg_num=t).numpy()
    clip = x.reshape(2, t, c)
    out = got.reshape(2, t, c)
    np.testing.assert_array_equal(out[:, :-1, :2], clip[:, 1:, :2])
    np.testing.assert_array_equal(out[:, 1:, 2:4], clip[:, :-1, 2:4])
    np.testing.assert_array_equal(out[:, :, 4:], clip[:, :, 4:])
    padded = np.pad(clip, ((0, 0), (1, 1), (0, 0)))
    paddle = np.concatenate([padded[:, :t, :2], padded[:, 2:, 2:4],
                             padded[:, 1:t + 1, 4:]], axis=2)
    np.testing.assert_array_equal(paddle[:, 1:, :2], clip[:, :-1, :2])
    np.testing.assert_array_equal(paddle[:, :-1, 2:4], clip[:, 1:, 2:4])
    assert not np.array_equal(out[:, :, :4], paddle[:, :, :4])
    np.testing.assert_array_equal(out[:, :, 4:], paddle[:, :, 4:])


def test_find_op_gives_the_registered_op_or_none():
    """A layer's ``act`` looks its op up once: the registered op, or None
    for a name that is no op (where the layer raises KeyError)."""
    from paddle_tpu_torch.ops.registry import find_op, get_op, has_op
    assert find_op('relu6') is get_op('relu6')
    assert find_op('no_such_op') is None and not has_op('no_such_op')
