"""The port's ResNet slice (paddle_tpu_torch/models/resnet.py, dygraph/nn.py,
convert.py, optimizer.py Momentum, dygraph/jit.py TrainStep with BatchNorm's
running statistics) against the JAX package's, on the CPU at ResNet-50 with
class_dim 10, batch 8 and 32x32 images (bench.py's off-chip shape), NHWC
and NCHW, Momentum(0.01, 0.9).

At this size the model is ill-conditioned in both packages, and the
tolerances say so. Measured on the CPU, port against a float64 run of
itself: the training-mode logits carry 4e-4 of f32 noise (the JAX model's
logits move by 3.7e-4 when its input moves by 1e-7 relative; the 1x1
last stage normalises over the 8 samples alone) and every gradient about
1.4-2.2% of its norm (at 32 to 128 pixels alike, in the reference too).
A Momentum step at lr 0.01 is far outside the linear regime (the loss
moves by several units), so from the second step on the trajectory is
chaotic: the reference's own losses move by 2-9% when its inputs move by
1e-7. Hence:

- logits, in eval mode (running statistics calibrated on a batch, what a
  trained model has) and in training mode: atol 2e-3, and the port no
  further from the port's own float64 evaluation than 1.5x the
  reference's distance plus 1e-4 (measured: each package lies 3.5e-4 to
  8e-4 from it, at logits up to 27; the 53 conv + BN layers amplify f32
  rounding about a thousandfold);
- the first f32 step: loss rtol 1e-4; each parameter's update within 5e-2
  of the reference's, relative to its norm (twice the gradients' f32
  noise); every running statistic rtol 1e-3, atol 1e-5 (a tenth of the
  batch statistics of the training-mode forward);
- the second and third f32 steps, the state after them and the trained
  model's eval logits: within 4x the reference's own spread, measured in
  the test by running the reference again on inputs moved by 1e-7
  relative, plus rtol 1e-4;
- bf16 AMP: the same, with the reference's spread measured at inputs
  moved by 2**-8 relative (a bf16 rounding; a 1e-7 move vanishes in the
  cast), plus rtol 2e-2.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.dygraph import guard
from paddle_tpu.dygraph.jit import TrainStep as JaxTrainStep
from paddle_tpu.dygraph.tape import Tensor, dispatch_op, no_grad_guard
from paddle_tpu.models import resnet as jax_resnet
from paddle_tpu_torch.clip import GradientClipByValue
from paddle_tpu_torch.convert import (resnet_expected_shapes,
                                      resnet_init_params,
                                      resnet_state_dict_from_paddle)
from paddle_tpu_torch.dygraph import TrainStep
from paddle_tpu_torch.models import resnet as port_resnet
from paddle_tpu_torch.ops.loss_ops import softmax_with_cross_entropy
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.regularizer import L1Decay
import torch_jax_seed  # noqa: F401  (caps torch's threads)

B, IMG, CLASSES = 8, 32, 10
FORMATS = ['NHWC', 'NCHW']


def images(fmt, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, IMG, IMG, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, (B, 1)).astype(np.int64)
    return (x if fmt == 'NHWC' else x.transpose(0, 3, 1, 2).copy()), y


@functools.lru_cache(maxsize=None)
def calibrated(fmt, seed):
    """resnet_init_params with the running statistics of a trained model:
    each BatchNorm's batch statistics on one batch (the port's float64
    training-mode forward with momentum 0), so that the eval forward
    normalises as a trained model's does."""
    named = resnet_init_params(50, CLASSES, fmt, seed)
    model = port_model(named, fmt).double()
    for m in model.modules():
        if hasattr(m, '_mean_buf'):
            m._attrs['momentum'] = 0.0
    x, _ = images(fmt, seed + 50)
    with torch.no_grad():
        model.train()(torch.from_numpy(x).double())
    for n, b in model.named_buffers():
        named[n] = b.float().numpy()
    for a in named.values():
        a.setflags(write=False)         # shared between the tests
    return named


def jax_model(fmt, named, s2d=False):
    model = jax_resnet.ResNet50(class_dim=CLASSES, data_format=fmt,
                                stem_space_to_depth=s2d)
    for n, p in list(model.named_parameters()) + list(model.named_buffers()):
        p.set_value(named[n])
    return model


def port_model(named, fmt, s2d=False):
    model = port_resnet.ResNet50(CLASSES, fmt, stem_space_to_depth=s2d,
                                 device='cpu')
    model.load_state_dict(resnet_state_dict_from_paddle(named, fmt))
    return model


def jax_logits(model, x, train):
    model.train() if train else model.eval()
    with no_grad_guard():
        return np.asarray(model(Tensor(x, stop_gradient=True)).numpy())


def port_logits(model, x, train):
    model.train(train)
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def jax_loss(model, x, y):
    logits = dispatch_op('cast', {'x': model(x)}, {'dtype': 'float32'})
    loss, _ = dispatch_op('softmax_with_cross_entropy',
                          {'logits': logits, 'label': y}, {})
    return dispatch_op('reduce_mean', {'x': loss}, {})


def port_loss(model, x, y):
    loss, _ = softmax_with_cross_entropy(model(x).float(), y)
    return loss.mean()


@pytest.mark.parametrize('fmt', FORMATS)
def test_names_and_shapes_equal_the_jax_models(fmt):
    named = resnet_init_params(50, CLASSES, fmt, 0)
    shapes = resnet_expected_shapes(50, CLASSES, fmt)
    with guard():
        jm = jax_resnet.ResNet50(class_dim=CLASSES, data_format=fmt)
        jp = {n: tuple(p.shape) for n, p in jm.named_parameters()}
        jb = {n: tuple(p.shape) for n, p in jm.named_buffers()}
    assert len(jp) == 161 and len(jb) == 106
    assert list(shapes) == list(jp) + list(jb)
    assert shapes == {**jp, **jb}
    assert {n: a.shape for n, a in named.items()} == shapes
    model = port_model(named, fmt)
    assert [n for n, _ in model.named_parameters()] == list(jp)
    assert [n for n, _ in model.named_buffers()] == list(jb)
    sd = resnet_state_dict_from_paddle(named, fmt)
    w = named['blocks.3.conv1._conv.weight']
    np.testing.assert_array_equal(
        sd['blocks.3.conv1._conv.weight'].numpy(),
        w.transpose(3, 2, 0, 1) if fmt == 'NHWC' else w)
    np.testing.assert_array_equal(sd['out.weight'].numpy(),
                                  named['out.weight'])
    for n in ('conv._bn.weight', 'blocks.0.short._bn._variance_buf'):
        np.testing.assert_array_equal(sd[n].numpy(), named[n])
    if fmt == 'NHWC':       # the convs run NHWC kernels end to end
        assert all(p.is_contiguous(memory_format=torch.channels_last)
                   for n, p in model.named_parameters() if p.dim() == 4)


def test_conversion_rejects_unknown_and_missing_names():
    named = resnet_init_params(50, CLASSES, 'NHWC', 0)
    with pytest.raises(KeyError, match='unknown'):
        resnet_state_dict_from_paddle(
            {**named, 'blocks.0.conv3._conv.weight':
             named['blocks.0.conv2._conv.weight']}, 'NHWC')
    short = dict(named)
    del short['blocks.7.conv1._bn._mean_buf']
    with pytest.raises(KeyError, match='missing'):
        resnet_state_dict_from_paddle(short, 'NHWC')
    bad = dict(named)
    bad['conv._conv.weight'] = bad['conv._conv.weight'].transpose(3, 2, 0, 1)
    with pytest.raises(ValueError, match='shape'):
        resnet_state_dict_from_paddle(bad, 'NHWC')


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('fmt', FORMATS)
def test_logits_match_jax(fmt, train):
    named = calibrated(fmt, 1)
    x, _ = images(fmt, 2)
    with guard():
        want = jax_logits(jax_model(fmt, named), x, train)
    got = port_logits(port_model(named, fmt), x, train)
    assert np.abs(want).max() > 0.5
    assert_logits_close(got, want, named, fmt, x, train)


def assert_logits_close(got, want, named, fmt, x, train, s2d=False):
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    exact = port_model(named, fmt, s2d).double()
    exact.train(train)
    with torch.no_grad():
        exact = exact(torch.from_numpy(x).double()).numpy()
    port_err = np.abs(got - exact).max()
    ref_err = np.abs(want - exact).max()
    assert port_err <= 1.5 * ref_err + 1e-4, (port_err, ref_err)


def test_s2d_stem_model_matches_the_plain_stem_and_jax():
    named = calibrated('NHWC', 3)
    x, _ = images('NHWC', 4)
    with guard():
        want = jax_logits(jax_model('NHWC', named, s2d=True), x, False)
    plain = port_logits(port_model(named, 'NHWC'), x, False)
    got = port_logits(port_model(named, 'NHWC', s2d=True), x, False)
    assert_logits_close(got, want, named, 'NHWC', x, False, s2d=True)
    np.testing.assert_allclose(got, plain, atol=2e-3, rtol=0)
    with pytest.raises(ValueError, match='space_to_depth'):
        port_resnet.ResNet50(CLASSES, 'NCHW', stem_space_to_depth=True,
                             device='cpu')


def perturbed(batches, rel, seed=0):
    """The batches with every image entry moved by ``rel`` relative."""
    rng = np.random.default_rng(seed)
    return [((x * (1 + rel * rng.standard_normal(x.shape))).astype(
        np.float32), y) for x, y in batches]


def run_jax_steps(named, fmt, batches, amp, x_eval):
    """Losses, the state after the first and the last step (Paddle
    layout) and the trained model's eval logits on ``x_eval``."""
    with guard():
        jm = jax_model(fmt, named)
        opt = fluid.optimizer.Momentum(0.01, momentum=0.9,
                                       parameter_list=jm.parameters())
        step = JaxTrainStep(jm, jax_loss, opt, donate=False,
                            amp_dtype=jnp.bfloat16 if amp else None)
        losses, states = [], []
        for b in batches:
            losses.append(float(step(*b)))
            params, buffers = step.state()
            states.append({n: np.asarray(v) for n, v in
                           {**params, **buffers}.items()})
        logits = jax_logits(jax_model(fmt, states[-1]), x_eval, False)
        return np.array(losses), states[0], states[-1], logits


def run_port_steps(named, fmt, batches, amp, x_eval):
    """As :func:`run_jax_steps`; states in the port's layout, numpy."""
    model = port_model(named, fmt)
    opt = Momentum(0.01, momentum=0.9,
                   parameter_list=list(model.parameters()))
    step = TrainStep(model, port_loss, opt,
                     amp_dtype=torch.bfloat16 if amp else None)
    losses, states = [], []
    for b in batches:
        losses.append(float(step(*b)))
        params, buffers = step.state()
        assert all(v.dtype == torch.float32 for v in params.values())
        assert all(v.dtype == torch.float32 for v in buffers.values())
        states.append({n: v.numpy().copy() for n, v in
                       {**params, **buffers}.items()})
    return np.array(losses), states[0], states[-1], \
        port_logits(model, x_eval, False)


def port_layout(state, fmt):
    return {n: v.numpy() for n, v in
            resnet_state_dict_from_paddle(state, fmt).items()}


def norm(d, names):
    return np.sqrt(sum(float(np.sum(np.square(d[n], dtype=np.float64)))
                       for n in names))


def check_within_spread(got, want, spread, rtol, what):
    """max |got - want| <= 4 max |spread - want| + rtol max |want|."""
    err, own = np.abs(got - want).max(), np.abs(spread - want).max()
    assert err <= 4 * own + rtol * np.abs(want).max(), (
        f'{what}: port off by {err:.3e}, the reference off itself by '
        f'{own:.3e}')


def check_trajectory(fmt, named, batches, amp, rel, rtol):
    x_eval, _ = images(fmt, 99)
    want = run_jax_steps(named, fmt, batches, amp, x_eval)
    spread = run_jax_steps(named, fmt, perturbed(batches, rel), amp, x_eval)
    got = run_port_steps(named, fmt, batches, amp, x_eval)
    # the reference's own spread is real from the second step on
    assert np.all(want[0][1:] != spread[0][1:])
    check_within_spread(got[0], want[0], spread[0], rtol, 'losses')
    check_within_spread(got[3], want[3], spread[3], rtol, 'eval logits')
    ref, own = port_layout(want[2], fmt), port_layout(spread[2], fmt)
    for kind in ('params', 'buffers'):
        names = [n for n in ref if n.endswith('_buf') == (kind == 'buffers')]
        d_port = norm({n: got[2][n] - ref[n] for n in names}, names)
        d_own = norm({n: own[n] - ref[n] for n in names}, names)
        assert d_port <= 4 * d_own + rtol * norm(ref, names), (
            kind, d_port, d_own)
    return want, got


@pytest.mark.parametrize('fmt', FORMATS)
def test_f32_train_steps_match_jax(fmt):
    """Three TrainStep + Momentum(0.01) steps on three batches: losses,
    every parameter and running statistic, the trained eval logits."""
    named = resnet_init_params(50, CLASSES, fmt, 5)
    batches = [images(fmt, s) for s in (6, 7, 8)]
    want, got = check_trajectory(fmt, named, batches, False, 1e-7, 1e-4)
    # the first step is the forward and one gradient: held tightly
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-4)
    ref = port_layout(want[1], fmt)
    start = {n: v.numpy() for n, v in
             resnet_state_dict_from_paddle(named, fmt).items()}
    moved = 0
    for n, w in ref.items():
        if n.endswith('_buf'):
            np.testing.assert_allclose(got[1][n], w, rtol=1e-3, atol=1e-5,
                                       err_msg=n)
            moved += not np.array_equal(got[1][n], start[n])
        else:
            du, dw = got[1][n] - start[n], w - start[n]
            assert np.linalg.norm(du - dw) <= 5e-2 * np.linalg.norm(dw), n
    assert moved == 106            # every running statistic moved


def test_bf16_amp_train_steps_match_jax():
    """Three bf16-AMP steps: the f32 masters and running statistics take
    the update (run_port_steps checks their type), within the reference's
    own bf16 spread."""
    named = resnet_init_params(50, CLASSES, 'NHWC', 10)
    batches = [images('NHWC', s) for s in (11, 12, 13)]
    _, got = check_trajectory('NHWC', named, batches, True, 2 ** -8, 2e-2)
    assert not np.array_equal(got[2]['blocks.0.conv0._bn._mean_buf'],
                              named['blocks.0.conv0._bn._mean_buf'])
    assert not np.array_equal(got[2]['out.weight'], named['out.weight'])


def test_bf16_amp_activations_stay_bf16():
    """Under AMP every conv, BatchNorm and pool output is bf16 (the
    reference's types; torch's promotion would turn BatchNorm's output f32
    against its f32 buffers), and the NHWC model's activations stay
    channels_last end to end."""
    model = port_model(resnet_init_params(50, CLASSES, 'NHWC', 14), 'NHWC')
    seen = []
    for mod in model.modules():
        if isinstance(mod, (port_resnet.ConvBNLayer,)):
            mod.register_forward_hook(
                lambda m, i, o: seen.append((o.dtype, o.is_contiguous())))
    cast = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
    x, _ = images('NHWC', 15)
    with torch.no_grad():
        logits = torch.func.functional_call(model, cast,
                                            (torch.from_numpy(x),))
    assert logits.dtype == torch.bfloat16
    assert len(seen) == 53
    assert all(dt == torch.bfloat16 for dt, _ in seen)
    # NHWC tensors: contiguous as (B, H, W, C); the 1x1-spatial last
    # stage is contiguous in either format
    assert all(contiguous for _, contiguous in seen)


def test_momentum_rejects_unported_options():
    """regularization= and grad_clip= are ported: one update by hand, with
    L1 decay 0.25 on p = (1, -2) and gradients clipped to [-1, 1];
    a rate that is neither a number nor a schedule still raises."""
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    opt = Momentum(0.1, momentum=0.9, parameter_list=[p],
                   regularization=L1Decay(0.25),
                   grad_clip=GradientClipByValue(1.0))
    p.grad = torch.tensor([0.5, 3.0])
    opt.step()
    # g = clip((0.5 + 0.25, 3.0 - 0.25), -1, 1) = (0.75, 1.0)
    np.testing.assert_allclose(p.detach().numpy(), [1.0 - 0.075, -2.1],
                               rtol=1e-6)
    with pytest.raises(NotImplementedError, match='schedules'):
        Momentum(object())


def test_constructor_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_resnet.ResNet50(CLASSES)
