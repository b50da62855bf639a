"""The port's ERNIE finetune slice (paddle_tpu_torch/models/ernie.py,
convert.py, dygraph/jit.py ``TrainStep(accum_steps=)``, the regularized
Adam and ``decorate``) against the JAX package's, on the CPU at bench.py's
CPU config of ``bench_ernie`` (vocab 128, hidden 32, 2 layers, 2 heads,
FFN 64, 32 positions), batch 4 x 16, dropouts 0.

Tolerances: logits atol 1e-5 (f32 sums in another order through two
layers); 16 f32 ``TrainStep(accum_steps=4)`` calls of
``finetune_optimizer`` (Adam 1e-3 with L2Decay 0.01, LinearLrWarmup over 6
calls, ``decorate``), that is 4 updates: every call's loss and the final
parameters within rtol 1e-4 (plus atol 1e-6 for entries near 0: the
classifier bias starts at 0, and Adam steps such entries by about lr
whatever their size).
"""
import numpy as np
import pytest
import torch

from paddle_tpu import dygraph as jdy
from paddle_tpu.dygraph.jit import TrainStep as JaxTrainStep
from paddle_tpu.dygraph.tape import dispatch_op
from paddle_tpu.models import ernie as jax_ernie
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.contrib.mixed_precision import (
    OptimizerWithMixedPrecision)
from paddle_tpu_torch.convert import (ernie_expected_shapes,
                                      ernie_init_params,
                                      ernie_state_dict_from_paddle)
from paddle_tpu_torch.core import CPUPlace
from paddle_tpu_torch.dygraph.jit import TrainStep
from paddle_tpu_torch.models import ernie as port_ernie
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops.loss_ops import softmax_with_cross_entropy
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.regularizer import L2Decay
import torch_jax_seed  # noqa: F401  (caps torch's threads)

B, S, CALLS, K = 4, 16, 16, 4
ACC_PARAM = 'backbone.encoder.0.attn.q.weight'
CPU = CPUPlace()


def config(cls, fused=False):
    return cls(vocab_size=128, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=64,
               max_position_embeddings=32, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, use_fused_attention=fused)


def batches(n=CALLS):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        ids = rng.randint(0, 128, (B, S)).astype(np.int64)
        tt = rng.randint(0, 2, (B, S)).astype(np.int64)
        y = rng.randint(0, 2, (B, 1)).astype(np.int64)
        out.append((ids, tt, y))
    return out


@pytest.fixture(scope='module')
def named():
    return ernie_init_params(config(port_ernie.ErnieConfig), 0)


def jax_model(named):
    model = jax_ernie.ErnieForSequenceClassification(
        config(jax_ernie.ErnieConfig), num_labels=2, dropout=0.0)
    for n, p in model.named_parameters():
        p.set_value(named[n])
    return model


def port_model(named, fused=False):
    model = port_ernie.ErnieForSequenceClassification(
        config(port_ernie.ErnieConfig, fused), num_labels=2, dropout=0.0,
        device='cpu')
    model.set_dict(named)
    return model


def jax_loss(m, ids, tt, y):
    logits = dispatch_op('cast', {'x': m(ids, tt)}, {'dtype': 'float32'})
    loss, _ = dispatch_op('softmax_with_cross_entropy',
                          {'logits': logits, 'label': y}, {})
    return dispatch_op('reduce_mean', {'x': loss}, {})


def port_loss(m, ids, tt, y):
    loss, _ = softmax_with_cross_entropy(m(ids, tt).float(), y)
    return loss.mean()


def test_names_and_shapes_equal_the_jax_model(named):
    with jdy.guard():
        jm = jax_model(named)
        want = {n: tuple(p.shape) for n, p in jm.named_parameters()}
    shapes = ernie_expected_shapes(config(port_ernie.ErnieConfig))
    assert list(shapes) == list(want) and shapes == want
    assert {n: a.shape for n, a in named.items()} == shapes
    sd = ernie_state_dict_from_paddle(named)
    assert list(sd) == list(shapes)
    model = port_model(named)
    assert [n for n, _ in model.named_parameters()] == list(want)
    for n, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), named[n])
    assert port_ernie.ErnieConfig.base().vocab_size == 18000
    with pytest.raises(KeyError, match='classifier.bias'):
        ernie_state_dict_from_paddle(
            {n: a for n, a in named.items() if n != 'classifier.bias'})


@pytest.mark.parametrize('fused', [False, True], ids=['unfused', 'fused'])
def test_logits_match_jax(named, fused):
    ids, tt, _ = batches(1)[0]
    with jdy.guard():
        want = jax_model(named)(jdy.to_variable(ids),
                                jdy.to_variable(tt)).numpy()
        want_none = jax_model(named)(jdy.to_variable(ids)).numpy()
    nn_ops.reset_launch_counts()
    with dygraph.guard(CPU):
        model = port_model(named, fused)
        got = model(dygraph.to_variable(ids), dygraph.to_variable(tt))
        got_none = model(dygraph.to_variable(ids))
    assert isinstance(got, dygraph.Tensor) and got.shape == (B, 2)
    assert set(nn_ops.launch_counts().values()) == {0}
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_none.numpy(), want_none, atol=1e-5,
                               rtol=0)


def test_model_takes_the_guards_device(named):
    with dygraph.guard(CPU):
        model = port_ernie.ErnieForSequenceClassification(
            config(port_ernie.ErnieConfig))
    assert {p.device for p in model.parameters()} == {torch.device('cpu')}


def _jax_run(named):
    with jdy.guard():
        model = jax_model(named)
        opt = jax_ernie.finetune_optimizer(model, 1e-3, warmup_steps=6,
                                           weight_decay=0.01, use_amp=True)
        step = JaxTrainStep(model, jax_loss, opt, accum_steps=K)
        losses = [float(step(*b)) for b in batches()]
        params = {n: np.asarray(p.numpy())
                  for n, p in model.named_parameters()}
        return losses, params, opt.current_step_lr


def _port_run(named):
    with dygraph.guard(CPU):
        model = port_model(named)
        opt = port_ernie.finetune_optimizer(model, 1e-3, warmup_steps=6,
                                            weight_decay=0.01, use_amp=True)
        assert isinstance(opt, OptimizerWithMixedPrecision)
        assert isinstance(opt.regularization, L2Decay)
        step = TrainStep(model, port_loss, opt, accum_steps=K)
        w = dict(model.named_parameters())[ACC_PARAM]
        losses, merges = [], []
        for b in batches():
            losses.append(float(step(*b)))
            # the call count, and the accumulator (the parameter's .grad)
            merges.append((step._count, None if w.grad is None
                           else float(w.grad.abs().max())))
        params = {n: t.numpy() for n, t in model.state_dict().items()}
        return losses, params, opt.current_step_lr, merges


def test_sixteen_accumulated_finetune_calls_match_jax(named):
    want_losses, want, want_lr = _jax_run(named)
    losses, got, lr, merges = _port_run(named)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert lr == pytest.approx(want_lr, rel=1e-12)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)
    w = ACC_PARAM
    assert np.abs(got[w] - named[w]).max() > 1e-3          # 4 updates moved
    # the count, and the accumulators, which hold the merge's gradient
    # between calls and which the 4th call of a merge hands to the
    # optimizer and clears
    assert [c for c, _ in merges] == list(range(1, CALLS + 1))
    assert all((acc is None) == ((i + 1) % K == 0)
               for i, (_, acc) in enumerate(merges))
    assert merges[5][1] > 0


def test_merged_calls_equal_one_call_on_the_whole_batch(named):
    """Gradient merge of 4 calls of batch 4 updates as one call of batch
    16 does (the mean of means of equal batches): SGD 0.5 with L2Decay
    0.01, whose step scales with the gradient, f32, rtol 1e-5."""
    bs = batches(K)
    whole = tuple(np.concatenate(a) for a in zip(*bs))
    out = []
    for k, feeds in ((K, bs), (1, [whole])):
        with dygraph.guard(CPU):
            model = port_model(named)
            opt = SGD(0.5, parameter_list=model.parameters(),
                      regularization=L2Decay(0.01))
            step = TrainStep(model, port_loss, opt, accum_steps=k)
            for b in feeds:
                step(*b)
            out.append({n: t.numpy() for n, t in model.state_dict().items()})
    for n in out[0]:
        np.testing.assert_allclose(out[0][n], out[1][n], rtol=1e-5,
                                   atol=1e-7, err_msg=n)
    w = 'classifier.weight'
    assert np.abs(out[0][w] - named[w]).max() > 1e-3


def test_accum_steps_must_be_positive(named):
    with dygraph.guard(CPU):
        model = port_model(named)
        opt = port_ernie.finetune_optimizer(model)
        with pytest.raises(ValueError, match='accum_steps'):
            TrainStep(model, port_loss, opt, accum_steps=0)
