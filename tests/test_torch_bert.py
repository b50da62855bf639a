"""The port's BERT pretraining slice (paddle_tpu_torch/models/bert.py,
convert.py, dygraph/jit.py, optimizer.py) against the JAX package's, on the
CPU at BertConfig.tiny() with batch 2 and sequence 16, dropouts 0.

Tolerances: logits atol 1e-4 (f32 sums in another order through the
layers); the loss rtol 1e-5 and gradients atol 1e-5 + rtol 1e-4 (one
forward and backward of those sums); three f32 TrainStep + Adam steps: losses
rtol 1e-4, parameters atol 1e-5 (a hundredth of one Adam step at lr 1e-3);
three bf16-AMP steps: losses rtol 2e-2 (bf16 rounds at other places in the
two frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.dygraph import Layer, guard
from paddle_tpu.dygraph.jit import TrainStep as JaxTrainStep
from paddle_tpu.dygraph.jit import functionalize
from paddle_tpu.dygraph.tape import Tensor, no_grad_guard
from paddle_tpu.models import bert as jax_bert
from paddle_tpu_torch.convert import (bert_expected_shapes, bert_init_params,
                                      bert_state_dict_from_paddle)
from paddle_tpu_torch.dygraph import TrainStep
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.optimizer import Adam
import torch_jax_seed  # noqa: F401  (caps torch's threads)

B, S = 2, 16


def config(fused, cls):
    cfg = cls.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.use_fused_attention = fused
    return cfg


def batch(seed=0):
    """ids, token types, attention mask (row 1 padded after 10), MLM labels
    (15% labelled, the rest -1) and NSP labels, as numpy."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (B, S)).astype(np.int64)
    tt = rng.randint(0, 2, (B, S)).astype(np.int64)
    mask = np.ones((B, S), np.int64)
    mask[1, 10:] = 0
    mlm = np.where(rng.rand(B, S) < 0.15, rng.randint(0, 1024, (B, S)),
                   -1).astype(np.int64)
    mlm[0, 0] = 7                       # at least one labelled position
    nsp = rng.randint(0, 2, (B, 1)).astype(np.int64)
    return ids, tt, mask, mlm, nsp


def jax_model(fused, seed=None):
    model = jax_bert.BertForPretraining(config(fused, jax_bert.BertConfig))
    if seed is not None:
        for n, p in model.named_parameters():
            p.set_value(bert_init_params(model.cfg, seed)[n])
    return model


def jax_params(model):
    return {n: np.asarray(p.numpy()) for n, p in model.named_parameters()}


def port_model(named, fused):
    model = port_bert.BertForPretraining(
        config(fused, port_bert.BertConfig), device='cpu')
    model.load_state_dict(bert_state_dict_from_paddle(named))
    return model


def t(a):
    return torch.from_numpy(a)


@pytest.fixture(scope='module')
def jax_pair():
    """Unfused and fused JAX models sharing one set of weights."""
    with guard():
        unfused = jax_model(False)
        fused = jax_model(True)
        for n, p in fused.named_parameters():
            p.set_value(jax_params(unfused)[n])
        yield {False: unfused, True: fused}


def test_weight_transfer_names_shapes_and_tied_decoder(jax_pair):
    named = jax_params(jax_pair[False])
    cfg = config(False, port_bert.BertConfig)
    shapes = bert_expected_shapes(cfg)
    assert list(named) == list(shapes)
    assert {n: a.shape for n, a in named.items()} == shapes
    model = port_model(named, False)
    assert [n for n, _ in model.named_parameters()] == list(named)
    sd = bert_state_dict_from_paddle(named)
    for name in ('bert.encoder.0.attn.q.weight', 'bert.encoder.1.ffn1.weight',
                 'bert.pooler.weight', 'heads.transform.weight',
                 'heads.nsp.weight'):
        np.testing.assert_array_equal(sd[name].numpy(), named[name])
    for name in ('bert.word_emb.weight', 'bert.type_emb.weight',
                 'heads.decoder_bias', 'heads.transform_ln.bias'):
        np.testing.assert_array_equal(sd[name].numpy(), named[name])
    # the MLM decoder reads the embedding matrix itself: one tensor
    assert not any('decoder.weight' in n for n in sd)
    seen = []
    model.heads.register_forward_pre_hook(
        lambda mod, args: seen.append(args[2]))
    with torch.no_grad():
        ids, tt, *_ = batch()
        model(t(ids), t(tt))
    assert seen[0] is model.bert.word_emb.weight


def test_conversion_rejects_unknown_and_missing_names(jax_pair):
    named = jax_params(jax_pair[False])
    with pytest.raises(KeyError, match='unknown'):
        bert_state_dict_from_paddle(
            {**named, 'heads.decoder.weight': named['bert.word_emb.weight']})
    short = dict(named)
    del short['heads.nsp.bias']
    with pytest.raises(KeyError, match='missing'):
        bert_state_dict_from_paddle(short)


@pytest.mark.parametrize('with_mask', [False, True], ids=['nomask', 'mask'])
@pytest.mark.parametrize('fused', [False, True], ids=['unfused', 'fused'])
def test_logits_match_jax(jax_pair, fused, with_mask):
    jm = jax_pair[fused]
    model = port_model(jax_params(jm), fused).eval()
    ids, tt, mask, _, _ = batch(1)
    args = (ids, tt) + ((mask,) if with_mask else ())
    with no_grad_guard():
        jm.eval()
        want = jm(*[Tensor(a, stop_gradient=True) for a in args])
    with torch.no_grad():
        got = model(*[t(a) for a in args])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   atol=1e-4, rtol=0)


def test_logits_match_jax_at_seeded_weights():
    """bert_init_params feeds both packages; weights of the real scale give
    logits far from 0, so the atol 1e-4 bar means something."""
    named = bert_init_params(config(True, port_bert.BertConfig), 3)
    named['heads.decoder_bias'] = np.linspace(
        -1, 1, 1024).astype(np.float32)
    with guard():
        jm = jax_model(True)
        for n, p in jm.named_parameters():
            p.set_value(named[n])
        jm.eval()
        ids, tt, mask, _, _ = batch(2)
        with no_grad_guard():
            want = jm(*[Tensor(a, stop_gradient=True)
                        for a in (ids, tt, mask)])
    with torch.no_grad():
        got = port_model(named, True).eval()(t(ids), t(tt), t(mask))
    assert np.abs(np.asarray(want[0].numpy())).max() > 0.5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   atol=1e-4, rtol=0)


class _JaxLoss(Layer):
    """pretrain_loss as a JAX Layer, so that functionalize binds its
    parameters."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, ids, tt, mlm, nsp):
        return jax_bert.pretrain_loss(self.model, ids, tt, mlm, nsp)


@pytest.mark.parametrize('fused', [False, True], ids=['unfused', 'fused'])
def test_loss_and_every_gradient_match_jax(jax_pair, fused):
    jm = jax_pair[fused]
    named = jax_params(jm)
    ids, tt, _, mlm, nsp = batch(3)
    apply_fn, params, buffers = functionalize(_JaxLoss(jm))

    def loss_of(pvals):
        out, _ = apply_fn(pvals, buffers, ids, tt, mlm, nsp)
        return jnp.sum(out)

    want_loss, want_grads = jax.value_and_grad(loss_of)(params)
    model = port_model(named, fused)
    loss = port_bert.pretrain_loss(model, t(ids), t(tt), t(mlm), t(nsp))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    for n, p in model.named_parameters():
        w = np.asarray(want_grads[f'model.{n}'])
        g = p.grad.numpy()
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4, err_msg=n)


def run_jax_steps(named, fused, steps, amp):
    with guard():
        jm = jax_model(fused)
        for n, p in jm.named_parameters():
            p.set_value(named[n])
        opt = fluid.optimizer.Adam(1e-3, parameter_list=jm.parameters())
        step = JaxTrainStep(jm, jax_bert.pretrain_loss, opt, donate=False,
                            amp_dtype=jnp.bfloat16 if amp else None)
        losses = [float(step(*b)) for b in steps]
        params, _ = step.state()
        return losses, {n: np.asarray(v) for n, v in params.items()}


def run_port_steps(named, fused, steps, amp):
    model = port_model(named, fused)
    opt = Adam(1e-3, parameter_list=list(model.parameters()))
    step = TrainStep(model, port_bert.pretrain_loss, opt,
                     amp_dtype=torch.bfloat16 if amp else None)
    losses = [float(step(*b)) for b in steps]
    params, _ = step.state()
    return losses, params


def three_batches():
    out = []
    for seed in (4, 5, 6):
        ids, tt, _, mlm, nsp = batch(seed)
        out.append((ids, tt, mlm, nsp))
    return out


def test_f32_train_steps_match_jax():
    """Three TrainStep + Adam(1e-3) steps. Adam's first step is about
    lr * sign(g), so entries whose first JAX gradient is below 1e-6 in
    magnitude (where the sign is round-off) are left out of the parameter
    comparison; the assertion message says how many."""
    named = bert_init_params(config(True, port_bert.BertConfig), 7)
    steps = three_batches()
    want_losses, want = run_jax_steps(named, True, steps, amp=False)
    got_losses, got = run_port_steps(named, True, steps, amp=False)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert got_losses[-1] < got_losses[0]

    with guard():
        jm = jax_model(True)
        for n, p in jm.named_parameters():
            p.set_value(named[n])
        apply_fn, params, buffers = functionalize(_JaxLoss(jm))
        grads = jax.grad(lambda pv: jnp.sum(
            apply_fn(pv, buffers, *steps[0])[0]))(params)
    left_out = total = 0
    for n, w in want.items():
        g = got[n].numpy()
        keep = np.abs(np.asarray(grads[f'model.{n}'])) >= 1e-6
        left_out += int((~keep).sum())
        total += keep.size
        np.testing.assert_allclose(
            g[keep], w[keep], atol=1e-5, rtol=0,
            err_msg=f'{n} ({left_out} of {total} entries left out so far)')
    assert left_out < total // 10, (left_out, total)


def test_bf16_amp_train_steps_match_jax():
    named = bert_init_params(config(True, port_bert.BertConfig), 8)
    steps = three_batches()
    want_losses, _ = run_jax_steps(named, True, steps, amp=True)
    got_losses, got = run_port_steps(named, True, steps, amp=True)
    np.testing.assert_allclose(got_losses, want_losses, rtol=2e-2)
    # the f32 masters took the update; none was left in bf16
    assert all(p.dtype == torch.float32 for p in got.values())
    assert not np.array_equal(got['bert.encoder.0.attn.q.weight'].numpy(),
                              named['bert.encoder.0.attn.q.weight'])


def test_dropout_draws_from_the_models_generator():
    cfg = port_bert.BertConfig.tiny()
    cfg.use_fused_attention = False
    ids, tt, _, mlm, nsp = batch(9)
    runs = []
    for seed in (1, 1, 2):
        model = port_bert.BertForPretraining(cfg, device='cpu', seed=seed)
        model.load_state_dict(bert_state_dict_from_paddle(
            bert_init_params(cfg, 0)))
        torch.manual_seed(seed * 100)          # the global stream is unused
        with torch.no_grad():
            runs.append(port_bert.pretrain_loss(model, t(ids), t(tt),
                                                t(mlm), t(nsp)).item())
    assert runs[0] == runs[1] != runs[2]


def test_fused_attention_with_probability_dropout_warns():
    cfg = port_bert.BertConfig.tiny()
    cfg.use_fused_attention = True
    with pytest.warns(UserWarning, match='bypasses'):
        port_bert.BertForPretraining(cfg, device='cpu')


def test_train_step_rejects_unported_options():
    cfg = config(True, port_bert.BertConfig)
    model = port_bert.BertForPretraining(cfg, device='cpu')
    opt = Adam(1e-3, parameter_list=list(model.parameters()))
    for kw, item in (({'async_fetch': True}, 'A.11'),
                     ({'supervisor': object()}, 'A.11'),
                     ({'data_sharding': object()}, 'A.9')):
        with pytest.raises(NotImplementedError, match=f'ROADMAP {item}'):
            TrainStep(model, port_bert.pretrain_loss, opt, **kw)


def test_constructor_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_bert.BertForPretraining(port_bert.BertConfig.tiny())
