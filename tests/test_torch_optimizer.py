"""The port's Adam and softmax cross entropy (paddle_tpu_torch/ops/,
paddle_tpu_torch/optimizer.py) against the JAX package's ops on the CPU,
from the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import loss_ops as jax_loss
from paddle_tpu.ops import optimizer_ops as jax_opt
from paddle_tpu_torch.ops.loss_ops import softmax_with_cross_entropy
from paddle_tpu_torch.ops.optimizer_ops import adam, multi_tensor_adam
from paddle_tpu_torch.clip import GradientClipByGlobalNorm
from paddle_tpu_torch.optimizer import Adam, AdamOptimizer
from paddle_tpu_torch.regularizer import L2Decay
import torch_jax_seed  # noqa: F401  (caps torch's threads)


@pytest.mark.parametrize('scale', [0.02, 1.0])
def test_adam_matches_jax_over_five_steps(scale):
    """atol 1e-7: the same f32 operations in the same order; gradients
    include entries near epsilon, where Paddle's rule and torch.optim.Adam
    part ways."""
    rng = np.random.default_rng(0)
    p = (rng.standard_normal((64, 32)) * scale).astype(np.float32)
    grads = [(rng.standard_normal((64, 32)) * 10.0 ** rng.integers(
        -9, 0, (64, 32))).astype(np.float32) for _ in range(5)]
    lr = np.asarray([1e-3], np.float32)
    jp, jm1, jm2 = jnp.asarray(p), jnp.zeros_like(p), jnp.zeros_like(p)
    jb1, jb2 = jnp.asarray([0.9], jnp.float32), jnp.asarray([0.999],
                                                             jnp.float32)
    tp, tm1, tm2 = torch.tensor(p), torch.zeros(64, 32), torch.zeros(64, 32)
    tb1, tb2 = torch.tensor([0.9]), torch.tensor([0.999])
    for g in grads:
        jp, jm1, jm2, jb1, jb2 = jax_opt.adam(jp, g, jm1, jm2, jb1, jb2, lr)
        out = adam(tp, torch.from_numpy(g), tm1, tm2, tb1, tb2,
                   torch.from_numpy(lr))
        assert out is tp                       # updated in place
    for got, want in ((tp, jp), (tm1, jm1), (tm2, jm2), (tb1, jb1),
                      (tb2, jb2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7,
                                   rtol=0)


def test_adam_is_not_torch_optim_adam():
    """Where sqrt(m2) is near epsilon the two rules give different steps;
    the port follows Paddle's."""
    g = torch.full((4,), 1e-8)
    p = torch.zeros(4, requires_grad=True)
    s = {'moment1': torch.zeros(4), 'moment2': torch.zeros(4),
         'beta1_pow': torch.tensor([0.9]), 'beta2_pow': torch.tensor([0.999])}
    adam(p, g, s['moment1'], s['moment2'], s['beta1_pow'], s['beta2_pow'],
         1e-3)
    q = torch.zeros(4, requires_grad=True)
    q.grad = g.clone()
    torch.optim.Adam([q], lr=1e-3).step()
    paddle_step = 1e-3 * np.sqrt(1 - 0.999) / (1 - 0.9) \
        * (0.1 * 1e-8) / (np.sqrt(0.001) * 1e-8 + 1e-8)
    np.testing.assert_allclose(-p.detach().numpy(), paddle_step, rtol=1e-5)
    assert not torch.allclose(p.detach(), q.detach(), rtol=1e-2)


def test_adam_optimizer_slots_and_unported_options():
    w = torch.nn.Parameter(torch.ones(3, 2))
    opt = Adam(0.1, parameter_list=[w])
    assert Adam is AdamOptimizer
    w.grad = torch.ones(3, 2)
    opt.step()
    s = opt.slots(w)
    assert sorted(s) == ['beta1_pow', 'beta2_pow', 'moment1', 'moment2']
    np.testing.assert_allclose(s['beta1_pow'].numpy(), [0.81], rtol=1e-6)
    np.testing.assert_allclose(s['beta2_pow'].numpy(), [0.999 ** 2],
                               rtol=1e-6)
    assert (w.detach() < 1).all()
    # regularization and grad_clip are ported: L2 decay 0.5 on p = 1
    # turns g = 3 into 3.5, the global-norm clip at 1.0 scales it to
    # 1/sqrt(6) per entry; Adam's first step is then lr * sign(g) (up to
    # epsilon), and p.grad stays as it was
    for kw in ({'regularization': L2Decay(0.5)},
               {'grad_clip': GradientClipByGlobalNorm(1.0)}):
        v = torch.nn.Parameter(torch.ones(3, 2))
        opt = AdamOptimizer(0.1, parameter_list=[v], **kw)
        v.grad = torch.full((3, 2), 3.0)
        opt.step()
        np.testing.assert_allclose(v.detach().numpy(), 0.9, rtol=1e-6)
        np.testing.assert_allclose(opt.slots(v)['moment1'].numpy(),
                                   0.1 * (3.5 if 'regularization' in kw
                                          else 6 ** -0.5), rtol=1e-6)
        assert torch.equal(v.grad, torch.full((3, 2), 3.0))
    with pytest.raises(NotImplementedError, match='A.4'):
        AdamOptimizer(0.1, parameter_list=[w], lazy_mode=True)


@pytest.mark.parametrize('label_shape', ['n1', 'n'])
def test_softmax_with_cross_entropy_matches_jax(label_shape):
    """Labels are compared as values: the reference runs with x64 off, so
    its int64 feeds become int32. Ignored rows give exactly 0. Tolerance
    1e-6 relative: f32 log-softmax, its sum taken in another order."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((12, 40)).astype(np.float32) * 3
    label = rng.integers(0, 40, (12, 1)).astype(np.int64)
    label[[1, 4, 9]] = -1
    if label_shape == 'n':
        label = label[:, 0]
    want_loss, want_sm = jax_loss.softmax_with_cross_entropy(
        logits, label, ignore_index=-1)
    loss, sm = softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label), ignore_index=-1)
    assert tuple(loss.shape) == (12, 1) == tuple(np.shape(want_loss))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(sm.numpy(), np.asarray(want_sm), atol=1e-7,
                               rtol=1e-6)
    assert (loss.numpy()[[1, 4, 9]] == 0.0).all()


def test_multi_tensor_adam_gives_adams_bits():
    """The optimizer's multi-tensor update against the one-tensor op, over
    three steps of three parameters of different shapes: equal bits."""
    rng = np.random.default_rng(2)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    init = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    grads = [[(rng.standard_normal(sh) * 10.0 ** rng.integers(-9, 0, sh))
              .astype(np.float32) for sh in shapes] for _ in range(3)]

    def slots(p):
        return [torch.zeros_like(p), torch.zeros_like(p),
                torch.tensor([0.9]), torch.tensor([0.999])]

    one = [torch.tensor(a) for a in init]
    one_s = [slots(p) for p in one]
    many = [torch.tensor(a) for a in init]
    many_s = [slots(p) for p in many]
    for gs in grads:
        for p, s, g in zip(one, one_s, gs):
            adam(p, torch.from_numpy(g), *s, 1e-3)
        multi_tensor_adam(many, [torch.from_numpy(g) for g in gs],
                          *(list(col) for col in zip(*many_s)), 1e-3)
    for a, b in zip(one + [t for s in one_s for t in s],
                    many + [t for s in many_s for t in s]):
        assert torch.equal(a, b)


def test_optimizer_groups_parameters_by_update_count():
    """A parameter that missed a step keeps its own beta powers."""
    w = torch.nn.Parameter(torch.ones(3))
    u = torch.nn.Parameter(torch.ones(2))
    opt = Adam(0.1, parameter_list=[w, u])
    w.grad = torch.ones(3)
    opt.step()                               # u has no gradient yet
    u.grad, w.grad = torch.ones(2), torch.ones(3)
    opt.step()
    np.testing.assert_allclose(opt.slots(w)['beta1_pow'].numpy(), [0.9 ** 3],
                               rtol=1e-6)
    np.testing.assert_allclose(opt.slots(u)['beta1_pow'].numpy(), [0.9 ** 2],
                               rtol=1e-6)
    # u's first step: lr * sqrt(1-b2)/(1-b1) * m1 / (sqrt(m2) + eps) with
    # m1 = 0.1 g, m2 = 0.001 g^2, g = 1
    lr_t = 0.1 * np.sqrt(1 - 0.999) / (1 - 0.9)
    np.testing.assert_allclose(
        u.detach().numpy(), 1 - lr_t * 0.1 / (np.sqrt(0.001) + 1e-8),
        rtol=1e-6)
