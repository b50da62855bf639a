"""The port's fused_attention (paddle_tpu_torch/ops/nn_ops.py) against the
JAX package's, on the CPU: the same numpy inputs through
``paddle_tpu.ops.nn_ops.fused_attention`` (its XLA formulation, which is what
it runs off the TPU) and through the port's autograd Function, whose CPU
forward and backward are the plain versions of the three flash kernels.

Tolerance atol 1e-5: f32 throughout, the port sums in another order (its
plain forward goes through the row statistics the kernels save, its
backward recomputes P from them) and O(1) inputs keep every value near 1.
"""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.ops import nn_ops as jax_ops
from paddle_tpu_torch.ops import nn_ops

ATOL = 1e-5
# (B, H, S, D)
SHAPES = [(2, 3, 16, 16), (1, 2, 24, 32)]
KINDS = ['none', 'mask', 'full', 'causal', 'sq_ne_sk']


def inputs(shape, kind, seed=0):
    """q, k, v, dO, bias (or None) and causal, as numpy; Sk = S + 8 for
    ``sq_ne_sk``."""
    rng = np.random.default_rng(seed)
    b, h, s, d = shape
    sk = s + 8 if kind == 'sq_ne_sk' else s

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    bias = None
    if kind == 'mask':      # BertModel's (B, 1, 1, S) 0 / -1e4 bias
        keep = rng.random((b, 1, 1, sk)) < 0.7
        keep[:, :, :, 0] = True
        bias = np.where(keep, 0.0, -1e4).astype(np.float32)
    elif kind == 'full':
        bias = n(b, h, s, sk)
    return (n(b, h, s, d), n(b, h, sk, d), n(b, h, sk, d), n(b, h, s, d),
            bias, kind == 'causal')


def jax_fwd_vjp(q, k, v, do, bias, causal, sm_scale):
    def f(q, k, v, *bias):
        return jax_ops.fused_attention(q, k, v, *bias, sm_scale=sm_scale,
                                       causal=causal)

    args = (q, k, v) + (() if bias is None else (bias,))
    out, vjp = jax.vjp(f, *args)
    grads = vjp(do)
    return np.asarray(out), [np.asarray(g) for g in grads]


def leaves(*arrays):
    return [None if a is None else torch.tensor(a, requires_grad=True)
            for a in arrays]


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_forward_matches_jax(shape, kind):
    q, k, v, _, bias, causal = inputs(shape, kind)
    sm = shape[-1] ** -0.5
    want = np.asarray(jax_ops.fused_attention(q, k, v, bias, sm_scale=sm,
                                              causal=causal))
    tq, tk, tv, tb = (None if a is None else torch.from_numpy(a)
                      for a in (q, k, v, bias))
    nn_ops.reset_launch_counts()
    got = nn_ops.fused_attention(tq, tk, tv, tb, sm_scale=sm, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    ref = nn_ops.fused_attention_ref(tq, tk, tv, tb, sm_scale=sm,
                                     causal=causal)
    np.testing.assert_allclose(ref.numpy(), want, atol=ATOL, rtol=0)
    # CPU tensors run the plain versions: no kernel was launched
    assert set(nn_ops.launch_counts().values()) == {0}


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_gradients_match_jax(shape, kind):
    """dq, dk, dv (and dbias) from ``jax.vjp`` against torch autograd
    through the port's Function."""
    q, k, v, do, bias, causal = inputs(shape, kind, seed=1)
    sm = shape[-1] ** -0.5
    _, want = jax_fwd_vjp(q, k, v, do, bias, causal, sm)
    ts = leaves(q, k, v, bias)
    out = nn_ops.fused_attention(*ts, sm_scale=sm, causal=causal)
    out.backward(torch.from_numpy(do))
    got = [t.grad.numpy() for t in ts if t is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('shape', SHAPES, ids=str)
def test_bwd_ref_matches_autograd_of_the_plain_version(shape, kind):
    """The backward the kernels implement, from the saved row statistics,
    against torch autograd through ``fused_attention_ref``."""
    q, k, v, do, bias, causal = inputs(shape, kind, seed=2)
    sm = shape[-1] ** -0.5
    ts = leaves(q, k, v, bias)
    nn_ops.fused_attention_ref(*ts, sm_scale=sm, causal=causal).backward(
        torch.from_numpy(do))
    tq, tk, tv, tb = (None if a is None else torch.from_numpy(a)
                      for a in (q, k, v, bias))
    o, stats = nn_ops.fused_attention_fwd_ref(tq, tk, tv, tb, sm_scale=sm,
                                              causal=causal)
    assert stats.shape == (2,) + tq.shape[:3] and stats.dtype == torch.float32
    dq, dk, dv, ds = nn_ops.fused_attention_bwd_ref(
        tq, tk, tv, tb, o, stats, torch.from_numpy(do), sm_scale=sm,
        causal=causal)
    for g, t in zip((dq, dk, dv), ts):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=ATOL,
                                   rtol=0)
    assert tuple(ds.shape) == tq.shape[:3] + (tk.shape[2],)
    if bias is not None:
        np.testing.assert_allclose(
            nn_ops._sum_to(ds, tb.shape).numpy(), ts[3].grad.numpy(),
            atol=ATOL, rtol=0)


def test_bf16_keeps_the_input_type_and_sums_in_f32():
    """bf16 q, k, v give bf16 O and gradients, equal to the f32 result on
    the same (bf16-representable) inputs rounded once to bf16."""
    q, k, v, do, _, _ = inputs((1, 2, 16, 16), 'none', seed=3)
    ts = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    out = nn_ops.fused_attention(*ts, sm_scale=0.25)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(do).bfloat16())
    assert all(t.grad.dtype == torch.bfloat16 for t in ts)
    f32 = [t.detach().float() for t in ts]
    want, _ = nn_ops.fused_attention_fwd_ref(*f32, sm_scale=0.25)
    assert torch.equal(out.detach(), want.bfloat16())


def test_bias_grad_sums_to_the_broadcast_shape():
    q, k, v, do, bias, _ = inputs((2, 3, 16, 16), 'mask', seed=4)
    ts = leaves(q, k, v, bias)
    nn_ops.fused_attention(*ts, sm_scale=0.25).backward(torch.from_numpy(do))
    assert tuple(ts[3].grad.shape) == (2, 1, 1, 16)
    # a bias that takes no gradient gets none computed
    frozen = torch.from_numpy(bias)
    out = nn_ops.fused_attention(*leaves(q, k, v), frozen, sm_scale=0.25)
    out.sum().backward()
    assert frozen.grad is None


@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
def test_rows_masked_by_finfo_min_match_jax(causal):
    """A (B, 1, 1, S) bias of ``finfo.min`` on every key of batch row 1 (B 2,
    H 2, S 8, D 16, sm_scale 0.25). The JAX op's softmax weighs every key of
    those rows 1/S (under causal the keys past the diagonal too: its mask
    fills them with ``finfo.min`` as well), and the port's CPU path gives
    its O and its gradients of q, k, v and the bias; batch row 0 is an
    ordinary row."""
    rng = np.random.default_rng(8)
    q, k, v, do = (rng.standard_normal((2, 2, 8, 16)).astype(np.float32)
                   for _ in range(4))
    bias = np.zeros((2, 1, 1, 8), np.float32)
    bias[1] = np.finfo(np.float32).min
    want_o, want = jax_fwd_vjp(q, k, v, do, bias, causal, 0.25)
    np.testing.assert_allclose(
        want_o[1], np.broadcast_to(v[1].mean(-2, keepdims=True), v[1].shape),
        atol=ATOL, rtol=0)
    ts = leaves(q, k, v, bias)
    out = nn_ops.fused_attention(*ts, sm_scale=0.25, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), want_o, atol=ATOL,
                               rtol=0)
    out.backward(torch.from_numpy(do))
    for name, t, w in zip(('dq', 'dk', 'dv', 'dbias'), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=ATOL, rtol=0,
                                   err_msg=name)
