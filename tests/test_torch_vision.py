"""The vision models of the port (paddle_tpu_torch/models/vision.py) and
their training loops (tools/vision_recipes.py) against the JAX package's
paddle_tpu/models/vision.py, on the CPU, at the sizes of the JAX package's
model-zoo tests: MobileNetV1 (scale 0.25), MobileNetV2 (scale 0.35) and
VGG-11 (``input_size=32``, ``fc_dim=64``, with BatchNorm and without) at
10 classes on a batch of 16 32x32 images, TSM at seg_num 2 on 8 clips
over ResNet-50 (the port takes the bottleneck depths only, ROADMAP C.4
item 21), and the DCGAN at ``z_dim=8``, ``base=8`` on 16 images.

Weights carry across: the JAX model's ``state_dict()``, running
statistics included, set into the port's model with ``set_dict``.

The JAX models' ConvBN and the DCGAN generator pass their activation to
BatchNorm's ``act``, which the JAX BatchNorm never reads (ROADMAP C.4 item
11); the port's BatchNorm applies it, as Paddle 1.7's does. So the JAX
reference here is the JAX model built while its BatchNorm applies ``act``
through the JAX op of that name (a monkeypatch of the JAX class for the
test's duration, the JAX package's files untouched), and one test holds
the JAX model as it stands: without its activations.

Tolerances. These nets normalise over a few values a channel in their
last stages (the 1x1 maps of a 32x32 input), which amplifies f32 rounding
as ResNet-50 does at its parity size (ROADMAP C.4 item 4): at a batch of
4, one ReLU whose input lies within rounding of 0 takes another side in
one package and moves a first step's gradients by 10%, and from the
third loss on even a batch of 16 is chaotic (the JAX package's own third
loss moves by up to 0.25 when its inputs move by 1e-7 relative). So the
batch is 16, and the port's result must lie within 4x the f32 noise of
either package, plus a floor of 1e-5 relative (of the largest logit, of
each loss; in L2 over all the parameters, and over all the running
statistics, after each step), of the JAX package's result. The noise is
the larger of the port's distance from a float64 run of itself (the same
model in float64, ``set_dict`` of the same state) and the JAX package's
own spread (its run on inputs moved by 1e-7 relative), as
tests/test_torch_resnet.py measures it: each is taken inside one
package, so a layer or an activation that computes something else in the
port shows in full (the forward's noise is some 1e-4 of the logits).
Training: three steps of the user loop (``loss.backward()``,
``minimize``, ``clear_gradients()``) with ``Momentum(0.01, 0.9)`` on one
batch; the DCGAN three alternating iterations with two ``Adam(2e-4,
beta1=0.5)``. VGG's dropout is set to 0 in both packages throughout (its
masks come from each package's own generator).
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import dygraph as jdy
from paddle_tpu import models as jmodels
from paddle_tpu.dygraph import nn as jnn
from paddle_tpu.dygraph.tape import Tensor as JTensor
from paddle_tpu.dygraph.tape import dispatch_op as jdispatch
from paddle_tpu_torch import models
from paddle_tpu_torch.ops.loss_ops import softmax_with_cross_entropy
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.tools import vision_recipes
from torch_jax_seed import jax_seed_pinned  # noqa: F401

B, IMG, CLASSES = 16, 32, 10
FWD_FLOOR, STATE_FLOOR = 1e-5, 1e-5
LR = 0.01


@pytest.fixture
def jax_bn_act(monkeypatch):
    """The JAX BatchNorm applying its ``act`` (Paddle 1.7's behaviour) for
    the test's duration."""
    init, forward = jnn.BatchNorm.__init__, jnn.BatchNorm.forward

    def patched_init(self, num_channels, act=None, *args, **kwargs):
        init(self, num_channels, None, *args, **kwargs)
        self._paddle_act = act

    def patched_forward(self, x):
        y = forward(self, x)
        act = getattr(self, '_paddle_act', None)
        return jdispatch(act, {'x': y}, {}) if act else y

    monkeypatch.setattr(jnn.BatchNorm, '__init__', patched_init)
    monkeypatch.setattr(jnn.BatchNorm, 'forward', patched_forward)


MODELS = {
    'mobilenet_v1': (lambda m, **kw: m.MobileNetV1(CLASSES, 0.25, **kw),
                     (B, 3, IMG, IMG), CLASSES),
    'mobilenet_v2': (lambda m, **kw: m.MobileNetV2(CLASSES, 0.35, **kw),
                     (B, 3, IMG, IMG), CLASSES),
    'vgg11': (lambda m, **kw: m.VGG(11, CLASSES, input_size=IMG, fc_dim=64,
                                    **kw), (B, 3, IMG, IMG), CLASSES),
    'vgg11_plain': (lambda m, **kw: m.VGG(11, CLASSES, use_bn=False,
                                          input_size=IMG, fc_dim=64, **kw),
                    (B, 3, IMG, IMG), CLASSES),
    'tsm50': (lambda m, **kw: m.TSM(5, seg_num=2, backbone_layers=50, **kw),
              (B, 3, IMG, IMG), 5),
}


def batch(case, seed=0):
    _, shape, classes = MODELS[case]
    r = np.random.RandomState(seed)
    x = r.randn(*shape).astype(np.float32)
    n = shape[0] // 2 if case.startswith('tsm') else shape[0]
    return x, r.randint(0, classes, (n, 1)).astype(np.int64)


_JAX_MODELS = {}


def jax_model(case):
    """The JAX model of ``case`` set to its initial weights, and those
    weights; built once a process (building the JAX MobileNetV2 takes
    seconds). VGG's dropout is off (see the module's docstring)."""
    if case not in _JAX_MODELS:
        model = MODELS[case][0](jmodels)
        _JAX_MODELS[case] = model, {n: np.asarray(v.numpy())
                                    for n, v in model.state_dict().items()}
    model, state = _JAX_MODELS[case]
    for n, v in list(model.named_parameters()) + list(model.named_buffers()):
        v.set_value(np.array(state[n]))
    no_dropout(model)
    return model, state


def port_model(case, state, dtype=torch.float32):
    model = MODELS[case][0](models, device='cpu')
    model.set_dict(state)
    no_dropout(model)
    return model.to(dtype)


def no_dropout(model):
    if hasattr(model, 'drop'):
        model.drop._p = 0.0


def jax_logits(model, x, train):
    model.train() if train else model.eval()
    return np.asarray(model(JTensor(x, stop_gradient=True)).numpy())


def port_logits(model, x, train):
    model.train(train)
    dt = model.parameters()[0].dtype
    with torch.no_grad():
        return model(torch.from_numpy(x).to(dt)).double().numpy()


def assert_near_jax(port, jax, witness, moved, floor, what):
    """The port's result within 4x the f32 noise of either package, plus
    ``floor``, of the JAX package's: the noise is the larger of the
    port's distance from its float64 witness and the JAX package's own
    spread (its result on inputs moved by 1e-7 relative). Each is
    measured inside one package, so a layer that computes something else
    in the port shows in full."""
    noise = max(float(np.abs(port - witness).max()),
                float(np.abs(moved - jax).max()))
    diff = float(np.abs(port - jax).max())
    assert diff <= 4 * noise + floor, (what, diff, noise)


def rel_l2(a, b):
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


@pytest.mark.parametrize('case', sorted(MODELS))
def test_names_and_shapes_equal_the_jax_models(case, jax_bn_act):
    with jdy.guard():
        jm, state = jax_model(case)
        jshapes = {n: tuple(v.shape) for n, v in jm.state_dict().items()}
    pm = port_model(case, state)
    assert {n: tuple(v.shape) for n, v in pm.state_dict().items()} \
        == jshapes


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('case', sorted(MODELS))
def test_forward_matches_jax_from_the_same_weights(case, train, jax_bn_act):
    x, _ = batch(case)
    with jdy.guard():
        jm, state = jax_model(case)
        want = jax_logits(jm, x, train)
        jm, _ = jax_model(case)
        moved = jax_logits(jm, x * np.float32(1 + 1e-7), train)
    got = port_logits(port_model(case, state), x, train)
    witness = port_logits(port_model(case, state, torch.float64), x, train)
    assert got.shape == want.shape == (MODELS[case][1][0] // (
        2 if case.startswith('tsm') else 1), MODELS[case][2])
    assert_near_jax(got, want, witness, moved,
                    FWD_FLOOR * np.abs(witness).max(), 'logits')


def jax_steps(case, state, x, y, steps):
    from paddle_tpu.dygraph.tape import Tensor
    with jdy.guard():
        model, _ = jax_model(case)
        model.train()
        opt = jfluid.optimizer.MomentumOptimizer(
            LR, 0.9, parameter_list=model.parameters())
        losses, states = [], []
        for _ in range(steps):
            logits = model(Tensor(x, stop_gradient=True))
            loss, _ = jdispatch('softmax_with_cross_entropy',
                                {'logits': logits, 'label': Tensor(y)}, {})
            loss = jdispatch('reduce_mean', {'x': loss}, {})
            loss.backward()
            opt.minimize(loss)
            model.clear_gradients()
            losses.append(float(np.asarray(loss.numpy())))
            states.append({n: np.asarray(v.numpy())
                           for n, v in model.state_dict().items()})
        return losses, states


def port_steps(case, state, x, y, steps, dtype=torch.float32):
    model = port_model(case, state, dtype)
    model.train()
    opt = Momentum(LR, momentum=0.9, parameter_list=model.parameters())
    xt, yt = torch.from_numpy(x).to(dtype), torch.from_numpy(y)
    losses, states = [], []
    for _ in range(steps):
        # the recipe's loss, in the model's type (float64 for the witness)
        loss = softmax_with_cross_entropy(model(xt), yt)[0].mean()
        loss.backward()
        opt.minimize(loss)
        model.clear_gradients()
        losses.append(loss.item())
        states.append({n: v.detach().double().numpy().copy()
                       for n, v in model.state_dict().items()})
    return losses, states


def flat(state, buffers):
    """One float64 vector of a state dict's parameters (or its running
    statistics)."""
    return np.concatenate([np.zeros(0)] + [
        np.asarray(v, np.float64).ravel() for n, v in sorted(state.items())
        if ('_buf' in n) == buffers])


def assert_states_near_jax(got, want, witness, moved, what):
    """The parameters, then the running statistics, of the port's state
    within 4x the f32 noise (as :func:`assert_near_jax`, relative L2 of
    all of them) plus STATE_FLOOR of the JAX package's."""
    assert sorted(got) == sorted(want) == sorted(witness) == sorted(moved)
    for buffers in (False, True):
        j = flat(want, buffers)
        if not j.size:
            continue
        port = flat(got, buffers)
        noise = max(rel_l2(port, flat(witness, buffers)),
                    rel_l2(flat(moved, buffers), j))
        diff = rel_l2(port, j)
        assert diff <= 4 * noise + STATE_FLOOR, (what, buffers, diff, noise)


@pytest.mark.parametrize('case', sorted(MODELS))
def test_three_steps_match_jax_from_the_same_weights(case, jax_bn_act):
    x, y = batch(case)
    with jdy.guard():
        _, state = jax_model(case)
    want_losses, want = jax_steps(case, state, x, y, 3)
    moved_losses, moved = jax_steps(case, state, x * np.float32(1 + 1e-7),
                                    y, 3)
    got_losses, got = port_steps(case, state, x, y, 3)
    w_losses, witness = port_steps(case, state, x.astype(np.float64), y, 3,
                                   torch.float64)
    for i in range(3):
        assert_near_jax(np.float64(got_losses[i]), np.float64(want_losses[i]),
                        np.float64(w_losses[i]),
                        np.float64(moved_losses[i]),
                        FWD_FLOOR * abs(w_losses[i]), f'loss {i}')
        assert_states_near_jax(got[i], want[i], witness[i], moved[i],
                               f'step {i}')


def test_the_jax_models_run_without_their_batchnorm_activations():
    """ROADMAP C.4 item 11, as the JAX package stands: its ConvBN's output
    is its BatchNorm's, negative values and all (the relu is never
    applied), and a MobileNetV2 built so gives other logits than the one
    whose BatchNorm applies ``act``."""
    x = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32)
    with jdy.guard():
        block = jmodels.vision.ConvBN(3, 4, 3)
        block.eval()
        y = np.asarray(block(JTensor(x, stop_gradient=True)).numpy())
        assert (y < 0).any()


def test_tsm_over_basic_blocks_shifts_nothing_in_jax_and_raises_here():
    """ROADMAP C.4 item 21: the JAX TSM over ResNet-18 equals the frames'
    ResNet-18 logits averaged a clip (no shift: BasicBlock has no conv2);
    the port raises for 18 and 34."""
    x = np.random.RandomState(2).randn(4, 3, 32, 32).astype(np.float32)
    with jdy.guard():
        tsm = jmodels.TSM(num_classes=5, seg_num=2, backbone_layers=18)
        tsm.eval()
        got = np.asarray(tsm(JTensor(x, stop_gradient=True)).numpy())
        frames = np.asarray(tsm.backbone(JTensor(x, stop_gradient=True))
                            .numpy())
    np.testing.assert_allclose(got, frames.reshape(2, 2, 5).mean(1),
                               atol=1e-6)
    for depth in (18, 34):
        with pytest.raises(NotImplementedError, match=r'C\.4 item 21'):
            models.TSM(5, seg_num=2, backbone_layers=depth, device='cpu')


def test_tsm_shifts_every_bottleneck_input():
    """The port's TSM: each bottleneck block sees its input shifted (a
    hook a block, the backbone's parameter names unchanged)."""
    tsm = models.TSM(5, seg_num=2, backbone_layers=50, device='cpu')
    seen = []
    for blk in tsm.backbone.blocks:
        blk.register_forward_pre_hook(
            lambda layer, inputs: seen.append(inputs[0].detach().clone()))
    x = torch.randn(4, 3, 32, 32)
    with torch.no_grad():
        tsm.eval()(x)
    assert len(seen) == len(tsm.backbone.blocks) == 16
    # the hooks run in order: each block's input after the TSM shift is
    # the shift of what the block before returned; the first quarter of
    # channels of frame 1 of each clip is zero (frame 2 does not exist)
    for inp in seen:
        c1 = inp.shape[1] // 4
        clips = inp.reshape(2, 2, *inp.shape[1:])
        assert torch.count_nonzero(clips[:, 1, :c1]) == 0
        assert torch.count_nonzero(clips[:, 0, c1:2 * c1]) == 0
    assert not any(n.startswith('backbone.blocks.0.shift')
                   for n, _ in tsm.named_parameters())


# ------------------------------------------------------------------ DCGAN

Z, BASE = 8, 8


def dcgan_batch(seed=3):
    r = np.random.RandomState(seed)
    return (np.tanh(r.randn(B, 1, 32, 32)).astype(np.float32),
            r.randn(B, Z).astype(np.float32))


def jax_dcgan(iters, state_g, state_d, real, z):
    from paddle_tpu.dygraph.tape import Tensor
    with jdy.guard():
        g, d = jmodels.DCGenerator(Z, BASE), jmodels.DCDiscriminator(BASE)
        for model, state in ((g, state_g), (d, state_d)):
            for n, v in list(model.named_parameters()) + list(
                    model.named_buffers()):
                v.set_value(np.array(state[n]))
        d_opt = jfluid.optimizer.AdamOptimizer(2e-4, beta1=0.5,
                                               parameter_list=d.parameters())
        g_opt = jfluid.optimizer.AdamOptimizer(2e-4, beta1=0.5,
                                               parameter_list=g.parameters())

        def bce(logits, value):
            label = Tensor(np.full((B, 1), value, np.float32))
            loss = jdispatch('sigmoid_cross_entropy_with_logits',
                             {'x': logits, 'label': label}, {})
            return jdispatch('reduce_mean', {'x': loss}, {})

        losses = []
        xr, xz = Tensor(real), Tensor(z)
        for _ in range(iters):
            d_loss = jdispatch('elementwise_add', {
                'x': bce(d(xr), 1.0), 'y': bce(d(g(xz)), 0.0)}, {})
            d_loss.backward()
            d_opt.minimize(d_loss)
            d.clear_gradients()
            g.clear_gradients()
            g_loss = bce(d(g(xz)), 1.0)
            g_loss.backward()
            g_opt.minimize(g_loss)
            d.clear_gradients()
            g.clear_gradients()
            losses.append((float(np.asarray(d_loss.numpy())),
                           float(np.asarray(g_loss.numpy()))))
        return losses, [{n: np.asarray(v.numpy())
                         for n, v in m.state_dict().items()} for m in (g, d)]


def port_dcgan(iters, state_g, state_d, real, z, dtype=torch.float32):
    g = models.DCGenerator(Z, BASE, device='cpu')
    d = models.DCDiscriminator(BASE, device='cpu')
    g.set_dict(state_g)
    d.set_dict(state_d)
    g, d = g.to(dtype), d.to(dtype)
    d_opt, g_opt = vision_recipes.dcgan_optimizers(g, d)
    xr, xz = torch.from_numpy(real).to(dtype), torch.from_numpy(z).to(dtype)
    losses = []
    for _ in range(iters):
        d_loss, g_loss = vision_recipes.dcgan_iteration(g, d, d_opt, g_opt,
                                                        xr, xz)
        assert all(p.grad is None for p in d.parameters())
        losses.append((float(d_loss), float(g_loss)))
    return losses, [{n: v.detach().double().numpy().copy()
                     for n, v in m.state_dict().items()} for m in (g, d)]


def dcgan_states(jax_bn_act):
    with jdy.guard():
        g, d = jmodels.DCGenerator(Z, BASE), jmodels.DCDiscriminator(BASE)
        return [{n: np.asarray(v.numpy()) for n, v in m.state_dict().items()}
                for m in (g, d)]


def test_dcgan_forward_matches_jax(jax_bn_act):
    state_g, state_d = dcgan_states(jax_bn_act)
    _, z = dcgan_batch()
    with jdy.guard():
        g, d = jmodels.DCGenerator(Z, BASE), jmodels.DCDiscriminator(BASE)
        for model, state in ((g, state_g), (d, state_d)):
            for n, v in list(model.named_parameters()) + list(
                    model.named_buffers()):
                v.set_value(np.array(state[n]))
        fake = g(JTensor(z, stop_gradient=True))
        want_fake = np.asarray(fake.numpy())
        want_score = np.asarray(d(fake).numpy())
    pg, pd = (models.DCGenerator(Z, BASE, device='cpu'),
              models.DCDiscriminator(BASE, device='cpu'))
    pg.set_dict(state_g)
    pd.set_dict(state_d)
    with torch.no_grad():
        got_fake = pg(torch.from_numpy(z))
        got_score = pd(got_fake)
    assert got_fake.shape == (B, 1, 32, 32) and got_score.shape == (B, 1)
    np.testing.assert_allclose(got_fake.numpy(), want_fake, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_score.numpy(), want_score, atol=1e-5,
                               rtol=1e-5)


def test_dcgan_three_iterations_match_jax(jax_bn_act):
    """Both losses of each iteration, then every parameter and D's running
    statistics (moved three times an iteration in both packages: real,
    fake for D, fake for G) against the JAX package's, within the f32
    noise."""
    state_g, state_d = dcgan_states(jax_bn_act)
    real, z = dcgan_batch()
    want_losses, want = jax_dcgan(3, state_g, state_d, real, z)
    moved_losses, moved = jax_dcgan(3, state_g, state_d,
                                    real * np.float32(1 + 1e-7), z)
    got_losses, got = port_dcgan(3, state_g, state_d, real, z)
    w_losses, witness = port_dcgan(3, state_g, state_d,
                                   real.astype(np.float64),
                                   z.astype(np.float64), torch.float64)
    for i, (g, j, w, mv) in enumerate(zip(got_losses, want_losses,
                                          w_losses, moved_losses)):
        for k in range(2):
            assert_near_jax(np.float64(g[k]), np.float64(j[k]),
                            np.float64(w[k]), np.float64(mv[k]),
                            FWD_FLOOR * abs(w[k]), f'iteration {i} loss {k}')
    for m in range(2):
        assert_states_near_jax(got[m], want[m], witness[m], moved[m],
                               ('generator', 'discriminator')[m])


def test_the_discriminator_update_never_sees_the_generators_gradients():
    """After the generator's step the discriminator holds no gradient, so
    its next update equals one from cleared gradients; with the gradients
    of the generator's loss left on it the update differs (the check
    bites)."""
    torch.manual_seed(0)
    real, z = (torch.from_numpy(a) for a in dcgan_batch())
    g = models.DCGenerator(Z, BASE, device='cpu')
    d = models.DCDiscriminator(BASE, device='cpu')
    d_opt, g_opt = vision_recipes.dcgan_optimizers(g, d)
    vision_recipes.dcgan_iteration(g, d, d_opt, g_opt, real, z)
    assert all(p.grad is None for p in d.parameters())

    def forked_d_step(dirty):
        """D's next update on copies of the models and of D's optimizer
        state, from cleared gradients or with the generator's loss's
        gradients left on D."""
        gc, dc = copy.deepcopy(g), copy.deepcopy(d)
        opt = vision_recipes.dcgan_optimizers(gc, dc)[0]
        opt.set_dict(d_opt.state_dict())
        dc.clear_gradients()
        if dirty:
            logits = dc(gc(z))
            vision_recipes._bce(logits, torch.ones_like(logits)).backward()
            gc.clear_gradients()
        vision_recipes.dcgan_d_step(gc, dc, opt, real, z)
        return [p.detach().clone() for p in dc.parameters()]

    clean, dirty = forked_d_step(False), forked_d_step(True)
    vision_recipes.dcgan_d_step(g, d, d_opt, real, z)
    for p, q in zip(d.parameters(), clean):
        torch.testing.assert_close(p.detach(), q, atol=0, rtol=0)
    assert any(not torch.equal(p, q) for p, q in zip(clean, dirty))


@pytest.mark.parametrize('recipe', ['mobilenet_v2', 'tsm'])
def test_recipes_carry_their_published_settings(recipe):
    """PaddleCV's MobileNetV2 recipe: Momentum 0.9 over cosine decay from
    0.1, one ImageNet epoch at the batch size a schedule epoch, for 240
    epochs, L2Decay(4e-5); TSM's: Momentum 0.9 at 0.01, L2Decay(1e-4)."""
    model = models.MobileNetV2(CLASSES, scale=0.35, device='cpu')
    if recipe == 'mobilenet_v2':
        step = vision_recipes.mobilenet_v2_step(model, 128)
    else:
        step = vision_recipes.tsm_step(model)
    opt = step._opt
    assert isinstance(opt, Momentum) and opt._momentum == 0.9
    rate = opt._learning_rate
    if recipe == 'mobilenet_v2':
        assert (rate.lr, rate.step_each_epoch, rate.epochs) == (
            0.1, 1281167 // 128, 240)
        assert vision_recipes.MOBILENET_V2_EPOCHS == 240
        assert opt.regularization.coeff == 4e-5
    else:
        assert rate == 0.01 and opt.regularization.coeff == 1e-4
