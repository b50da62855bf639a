"""``TrainStep``'s ``remat``, ``snapshot`` and ``set_state``
(paddle_tpu_torch/dygraph/jit.py), and BERT-tiny trained with LAMB, against
the JAX package's, on the CPU.

- ``remat=True`` against ``remat=False`` on BERT-tiny with dropout 0.1 on
  (hidden and attention probabilities), f32 and bf16 AMP, from the same
  weights, batch and generator state: the loss and every gradient bit for
  bit over a merge of two calls (the recompute draws the first run's
  masks), and the parameters after it. Without putting the generators
  back the gradients differ (checked). The forward keeps under 2/3 of
  the bytes for the backward (the blocks' inputs; a saved-tensor hook). A
  BatchNorm model's running statistics move once a step under remat, as
  without it, recomputed whole or a block at a time.
- ``snapshot`` of an MLP (4 -> 3 relu -> 2) under Adam with a
  ``PiecewiseDecay`` schedule and ``accum_steps=2``, after 3 calls (mid
  merge) and after 4: the same keys and meta as the JAX package's
  ``TrainStep.snapshot`` for the same model and merge, and the same
  values (atol 1e-6: the same f32 steps).
- A run of 6 calls against one snapshotted after call 3 and restored with
  ``set_state`` into a fresh model, optimizer and step: calls 4-6 give
  the same losses and parameters bit for bit (the accumulators, the call
  count and the schedule's step carried), before and after the fresh
  step's first call; keys it does not know are ignored.
- BERT-tiny with ``Lamb(1e-3)`` through ``TrainStep`` for three f32 steps
  against the JAX package's: losses rtol 1e-4, parameters atol 1e-5 where
  the first JAX gradient is at least 1e-6 (as Adam's test: LAMB's first
  direction is about sign(g), round-off where g is), the trust ratio
  scaling each tensor. The JAX package's step takes the shared
  hyperparameters for every parameter (``_hypers``), so no parameter is
  excluded from weight decay here; the port applies
  ``exclude_from_weight_decay_fn`` in ``TrainStep`` too (ROADMAP C.16),
  checked on the LayerNorm parameters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import dygraph as jdy
from paddle_tpu import layers as jlayers
from paddle_tpu.dygraph.jit import TrainStep as JaxTrainStep
from paddle_tpu.dygraph.jit import functionalize
from paddle_tpu.models import bert as jax_bert
import paddle_tpu_torch as fluid
from paddle_tpu_torch import dygraph, layers
from paddle_tpu_torch.convert import (bert_init_params,
                                      bert_state_dict_from_paddle)
from paddle_tpu_torch.dygraph import TrainStep
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.optimizer import Lamb
from test_torch_bert import _JaxLoss, batch, config, jax_model, three_batches
from torch_jax_seed import jax_seed_pinned  # noqa: F401

CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_port_names():
    """The port's name counter fresh, as tests/conftest.py makes the JAX
    package's, so both name a model's parameters alike."""
    from paddle_tpu_torch.core import unique_name
    old = unique_name.generator
    unique_name.generator = unique_name.UniqueNameGenerator()
    yield
    unique_name.generator = old


# ------------------------------------------------------------------ remat

def bert_step(remat, amp, accum_steps=2):
    cfg = port_bert.BertConfig.tiny()           # dropout 0.1 on
    cfg.use_fused_attention = False
    assert cfg.hidden_dropout_prob == cfg.attention_probs_dropout_prob == 0.1
    model = port_bert.BertForPretraining(cfg, device='cpu', seed=3)
    model.load_state_dict(bert_state_dict_from_paddle(
        bert_init_params(cfg, 0)))
    opt = Lamb(1e-3, parameter_list=list(model.parameters()))
    return model, TrainStep(model, port_bert.pretrain_loss, opt,
                            remat=remat, accum_steps=accum_steps,
                            amp_dtype=torch.bfloat16 if amp else None)


def remat_run(remat, amp):
    model, step = bert_step(remat, amp)
    ids, tt, _, mlm, nsp = batch(3)
    losses = [step(ids, tt, mlm, nsp)]
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    losses.append(step(ids, tt, mlm, nsp))
    return losses, grads, {n: p.detach().clone()
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize('amp', [False, True], ids=['f32', 'bf16'])
def test_remat_gives_the_same_bits_with_dropout_on(amp):
    plain = remat_run(False, amp)
    remat = remat_run(True, amp)
    for a, b in zip(plain[0], remat[0]):
        assert torch.equal(a, b)
    for part in (1, 2):
        for n in plain[part]:
            assert torch.equal(plain[part][n], remat[part][n]), n


def test_remat_keeps_fewer_bytes_for_the_backward():
    """What the forward saves for the backward outside the checkpointed
    blocks (a saved-tensor hook; the blocks' own saved tensors are the
    checkpoint's): with remat, the blocks' inputs and the layers around
    them. BERT-tiny has two encoder layers, and its embeddings and MLM
    head over the 1024-word vocabulary keep what they keep in both runs,
    so the saving is under 2/3 here (0.59 measured) where BERT-base's
    twelve layers make it most of the step's."""
    ids, tt, _, mlm, nsp = batch(3)
    saved = {}
    for remat in (False, True):
        _, step = bert_step(remat, False)
        total = [0]

        def pack(t, total=total):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            step(ids, tt, mlm, nsp)
        saved[remat] = total[0]
    assert saved[True] < saved[False] * 2 / 3, saved


def test_remat_without_the_generators_put_back_differs(monkeypatch):
    monkeypatch.setattr(TrainStep, '_generators', lambda self: [])
    plain = remat_run(False, False)
    remat = remat_run(True, False)
    assert torch.equal(plain[0][0], remat[0][0])      # the forward is one
    assert any(not torch.equal(plain[1][n], remat[1][n]) for n in plain[1])


class Blocks(dygraph.Layer):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = dygraph.LayerList(blocks)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x


@pytest.mark.parametrize('blocks', [False, True],
                         ids=['whole_forward', 'blocks'])
def test_remat_moves_running_statistics_once(blocks):
    """A Sequential is recomputed whole; a LayerList's blocks one at a
    time."""
    out = []
    for remat in (False, True):
        with dygraph.guard(CPU):
            conv = dygraph.Conv2D(3, 4, 3)
            bn = dygraph.BatchNorm(4)
            model = (Blocks([conv, bn]) if blocks
                     else dygraph.Sequential(conv, bn))
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 3, 6, 6)).astype(np.float32)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.from_numpy(rng.standard_normal(
                    tuple(p.shape)).astype(np.float32)))
        opt = fluid.optimizer.SGD(0.1, parameter_list=model.parameters())
        step = TrainStep(model, lambda m, x: m(x).square().mean(), opt,
                         remat=remat)
        step(x)
        out.append({n: b.clone() for n, b in model.named_buffers()})
    assert out[0].keys() == out[1].keys() and out[0]
    for n in out[0]:
        assert torch.equal(out[0][n], out[1][n]), n


# ------------------------------------------------------- snapshot / resume

def mlp_data(calls=6):
    rng = np.random.default_rng(11)
    w1 = rng.standard_normal((4, 3)).astype(np.float32)
    w2 = rng.standard_normal((3, 2)).astype(np.float32)
    xs = [rng.standard_normal((5, 4)).astype(np.float32)
          for _ in range(calls)]
    return w1, w2, xs


class PortMLP(dygraph.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = dygraph.Linear(4, 3, act='relu')
        self.fc2 = dygraph.Linear(3, 2)

    def forward(self, x):
        return self.fc2(self.fc1(x))


class JaxMLP(jdy.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jdy.Linear(4, 3, act='relu')
        self.fc2 = jdy.Linear(3, 2)

    def forward(self, x):
        return self.fc2(self.fc1(x))


def port_loss(model, x):
    return layers.reduce_mean(model(x))


def jax_loss(model, x):
    return jlayers.reduce_mean(model(x))


def make_step(pkg):
    """The MLP, Adam on a PiecewiseDecay schedule and a TrainStep with
    accum_steps=2, in ``pkg``."""
    w1, w2, _ = mlp_data()
    if pkg is fluid:
        model = PortMLP()
    else:
        model = JaxMLP()
    model.fc1.weight.set_value(w1)
    model.fc2.weight.set_value(w2)
    dy = dygraph if pkg is fluid else jdy
    sched = dy.PiecewiseDecay([2, 4], [0.1, 0.05, 0.01], 0)
    opt = pkg.optimizer.Adam(sched, parameter_list=model.parameters())
    cls = TrainStep if pkg is fluid else JaxTrainStep
    kw = {} if pkg is fluid else {'donate': False}
    return model, cls(model, port_loss if pkg is fluid else jax_loss, opt,
                      accum_steps=2, **kw)


def as_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v.numpy() if hasattr(v, 'numpy') else v)


@pytest.mark.parametrize('calls', [3, 4], ids=['mid_merge', 'after_merge'])
def test_snapshot_keys_meta_and_values_match_jax(calls):
    xs = mlp_data()[2][:calls]
    snaps = {}
    for pkg in (fluid, jfluid):
        dy = dygraph if pkg is fluid else jdy
        with dy.guard(CPU if pkg is fluid else None):
            _, step = make_step(pkg)
            for x in xs:
                step(x)
            arrays, meta = step.snapshot()
            snaps[pkg] = ({k: as_numpy(v) for k, v in arrays.items()},
                          meta)
    (got, gmeta), (want, wmeta) = snaps[fluid], snaps[jfluid]
    assert sorted(got) == sorted(want)
    assert gmeta == wmeta == {'step': calls, 'accum_steps': 2,
                              'lr_step_num': calls}
    assert 'acc/fc1.weight' in got and 'slot/moment1/fc2.bias' in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    if calls == 3:
        assert np.abs(got['acc/fc1.weight']).max() > 0
    else:
        assert not np.any(got['acc/fc1.weight'])


def run_calls(step, xs):
    return [step(x) for x in xs]


@pytest.mark.parametrize('when', ['before_first_call', 'after_a_call'])
def test_mid_merge_resume_repeats_the_uninterrupted_run(when):
    xs = mlp_data()[2]
    with dygraph.guard(CPU):
        model, step = make_step(fluid)
        losses = run_calls(step, xs)
        want = {n: p.detach().clone() for n, p in model.named_parameters()}

        model, step = make_step(fluid)
        run_calls(step, xs[:3])
        arrays, meta = step.snapshot()
        arrays = {k: v.numpy() for k, v in arrays.items()}   # via the host
        arrays['scope/elsewhere'] = np.zeros(3)               # ignored

        fresh, resumed = make_step(fluid)
        if when == 'after_a_call':
            resumed(xs[0])
        resumed.set_state(arrays, meta)
        again = run_calls(resumed, xs[3:])
    for a, b in zip(again, losses[3:]):
        assert torch.equal(a, b)
    for n, p in fresh.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    assert resumed._opt._learning_rate.step_num == 6


# ------------------------------------------------------ BERT-tiny with LAMB

def test_bert_tiny_lamb_train_steps_match_jax():
    named = bert_init_params(config(True, port_bert.BertConfig), 7)
    steps = three_batches()
    with jdy.guard():
        jm = jax_model(True)
        for n, p in jm.named_parameters():
            p.set_value(named[n])
        jstep = JaxTrainStep(jm, jax_bert.pretrain_loss,
                             jfluid.optimizer.Lamb(
                                 1e-3, parameter_list=jm.parameters()),
                             donate=False)
        want_losses = [float(jstep(*b)) for b in steps]
        want = {n: np.asarray(v) for n, v in jstep.state()[0].items()}
        jm2 = jax_model(True)
        for n, p in jm2.named_parameters():
            p.set_value(named[n])
        apply_fn, params, buffers = functionalize(_JaxLoss(jm2))
        grads = jax.grad(lambda pv: jnp.sum(
            apply_fn(pv, buffers, *steps[0])[0]))(params)
    model = port_bert.BertForPretraining(
        config(True, port_bert.BertConfig), device='cpu')
    model.load_state_dict(bert_state_dict_from_paddle(named))
    step = TrainStep(model, port_bert.pretrain_loss,
                     Lamb(1e-3, parameter_list=list(model.parameters())))
    got_losses = [float(step(*b)) for b in steps]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert got_losses[-1] < got_losses[0]
    left_out = total = 0
    for n, p in model.named_parameters():
        keep = np.abs(np.asarray(grads[f'model.{n}'])) >= 1e-6
        left_out += int((~keep).sum())
        total += keep.size
        np.testing.assert_allclose(p.detach().numpy()[keep], want[n][keep],
                                   atol=1e-5, rtol=0, err_msg=n)
    assert left_out < total // 10, (left_out, total)


def test_lamb_excludes_layer_norm_in_train_step():
    """One step with LayerNorm's parameters excluded moves them as
    ``lamb_weight_decay=0`` would, and the other parameters as the full
    decay would."""
    cfg = config(True, port_bert.BertConfig)
    named = bert_init_params(cfg, 7)
    ids, tt, _, mlm, nsp = batch(4)
    out = []
    for kw in ({}, {'lamb_weight_decay': 0.0}, 'exclude'):
        model = port_bert.BertForPretraining(cfg, device='cpu')
        model.load_state_dict(bert_state_dict_from_paddle(named))
        ln = {id(p) for n, p in model.named_parameters() if '_ln.' in n}
        assert ln
        if kw == 'exclude':
            kw = {'exclude_from_weight_decay_fn': lambda p: id(p) in ln}
        TrainStep(model, port_bert.pretrain_loss,
                  Lamb(1e-2, parameter_list=list(model.parameters()),
                       **kw))(ids, tt, mlm, nsp)
        out.append({n: p.detach() for n, p in model.named_parameters()})
    full, none, excluded = out
    for n in full:
        want = none[n] if '_ln.' in n else full[n]
        assert torch.equal(excluded[n], want), n
    assert any(not torch.equal(full[n], none[n]) for n in full
               if '_ln.' in n)
