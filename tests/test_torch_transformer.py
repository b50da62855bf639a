"""The port's NMT Transformer (paddle_tpu_torch/models/transformer.py, on
the dygraph API) against the JAX package's, on the CPU, at
``TransformerConfig.tiny`` (d_model 32, 2 heads, 2 + 2 layers, vocabularies
of 64, max_length 16), dropout 0, with the same numpy weights
(convert.transformer_init_params) and ``RandomState`` ids:

- ``state_dict()`` keys and shapes equal the JAX model's, with and without
  ``weight_sharing`` (the shared table under both names);
- logits within atol 1e-5 (f32 products summed in another order), with and
  without a source pad mask;
- ``transformer_loss`` (label smoothing 0.1 and 0, pad positions masked)
  within rtol 1e-6, and every parameter's gradient within atol 1e-5;
- three steps of ``Adam(NoamDecay(32, 4))`` through the user loop
  (``backward`` -> ``minimize`` -> ``clear_gradients``): losses within
  rtol 1e-4; every parameter within 4 times the reference's own spread
  (the JAX run from weights one f32 ulp away) plus 1e-4 of its largest
  value, as the ResNet trajectories are held (see the test);
- ``greedy_decode`` and ``beam_search_decode`` tokens equal;
- ``TrainStep`` in f32 equals the eager loop exactly; in bf16 AMP it keeps
  the f32 masters, binds a shared embedding once and lowers the loss;
- the user script of the README runs as written, with only its import
  line changed, under ``guard(CPUPlace())`` (at tiny widths: the test
  makes ``TransformerConfig.big`` return the tiny config; the card runs
  the full width in chip_smoke.py phase 9).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.models import transformer as jt
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.convert import (transformer_expected_shapes,
                                      transformer_init_params,
                                      transformer_state_dict_from_paddle)
from paddle_tpu_torch.dygraph import TrainStep, to_variable
from paddle_tpu_torch.models import transformer as pt
import torch_jax_seed  # noqa: F401  (caps torch's threads)

CPU = fluid.CPUPlace()
B, S, V = 3, 16, 64


def cfg_kw(shared=False):
    return dict(dropout=0.0, weight_sharing=shared)


def batch(seed=0, pads=True):
    rs = np.random.RandomState(seed)
    src = rs.randint(1, V, (B, S)).astype(np.int64)
    trg = rs.randint(1, V, (B, S)).astype(np.int64)
    lbl = rs.randint(1, V, (B, S)).astype(np.int64)
    mask = np.ones((B, S), np.float32)
    if pads:
        lbl[:, -3:] = 0
        lbl[0, 5:] = 0
        mask[1, 10:] = 0
    return src, trg, lbl, mask


def jax_model(named, shared=False):
    m = jt.Transformer(jt.TransformerConfig.tiny(**cfg_kw(shared)))
    for n, p in m.state_dict().items():
        p.set_value(named[n])
    return m


def port_model(named, shared=False):
    m = pt.Transformer(pt.TransformerConfig.tiny(**cfg_kw(shared)))
    m.set_dict(named)
    return m


@pytest.fixture(scope='module')
def named():
    return transformer_init_params(pt.TransformerConfig.tiny(), 0)


@pytest.mark.parametrize('shared', [False, True], ids=['own', 'shared'])
def test_state_dict_keys_and_shapes_equal_the_jax_models(shared):
    cfg = pt.TransformerConfig.tiny(**cfg_kw(shared))
    init = transformer_init_params(cfg, 1)
    with jdy.guard():
        want = {n: tuple(p.shape) for n, p in
                jt.Transformer(jt.TransformerConfig.tiny(
                    **cfg_kw(shared))).state_dict().items()}
    with dygraph.guard(CPU):
        m = pt.Transformer(cfg)
        got = {n: tuple(t.shape) for n, t in m.state_dict().items()}
        assert (m.src_emb is m.trg_emb) == shared
        n_params = len(m.parameters())
    assert list(got) == list(want) == list(transformer_expected_shapes(cfg))
    assert got == want
    assert {n: a.shape for n, a in init.items()} == want
    assert (init['src_emb.weight'] is init['trg_emb.weight']) == shared
    assert n_params == len(want) - shared
    sd = transformer_state_dict_from_paddle(init)
    assert list(sd) == list(want)
    np.testing.assert_array_equal(sd['enc_1.ffn.fc2.weight'].numpy(),
                                  init['enc_1.ffn.fc2.weight'])


def test_conversion_rejects_unknown_and_missing_names(named):
    with pytest.raises(KeyError, match='unknown'):
        transformer_state_dict_from_paddle({**named, 'enc_0.attn.z.bias':
                                            np.zeros(32, np.float32)})
    short = dict(named)
    del short['dec_1.ln3.bias']
    with pytest.raises(KeyError, match='missing'):
        transformer_state_dict_from_paddle(short)
    bad = {**named, 'proj.weight': np.zeros((32, 63), np.float32)}
    with pytest.raises(ValueError, match='proj.weight'):
        transformer_state_dict_from_paddle(bad)


def test_the_constants_are_non_persistent_device_buffers():
    with dygraph.guard(CPU):
        m = pt.Transformer(pt.TransformerConfig.tiny())
        buffers = dict(m.named_buffers())
        assert 'pos_enc' in buffers and 'dec_0.self_attn.causal_mask' \
            in buffers
        assert not any(n in m.state_dict() for n in buffers)
        np.testing.assert_array_equal(
            buffers['pos_enc'].numpy(), pt.position_encoding(16, 32))


@pytest.mark.parametrize('with_mask', [False, True], ids=['nomask', 'mask'])
@pytest.mark.parametrize('shared', [False, True], ids=['own', 'shared'])
def test_logits_match_jax(with_mask, shared):
    named = transformer_init_params(
        pt.TransformerConfig.tiny(**cfg_kw(shared)), 2)
    src, trg, _, mask = batch(1)
    with jdy.guard():
        jm = jax_model(named, shared)
        want = jm(jdy.to_variable(src), jdy.to_variable(trg),
                  jdy.to_variable(mask) if with_mask else None).numpy()
    with dygraph.guard(CPU):
        m = port_model(named, shared)
        got = m(to_variable(src), to_variable(trg),
                to_variable(mask) if with_mask else None)
        assert isinstance(got, dygraph.Tensor)
        got = got.numpy()
    assert got.shape == (B, S, V)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize('eps', [0.1, 0.0])
def test_loss_and_every_gradient_match_jax(named, eps):
    src, trg, lbl, _ = batch(3)
    with jdy.guard():
        jm = jax_model(named)
        jloss = jt.transformer_loss(jm(jdy.to_variable(src),
                                       jdy.to_variable(trg)),
                                    jdy.to_variable(lbl),
                                    label_smooth_eps=eps)
        jloss.backward()
        want = float(jloss.numpy())
        want_g = {n: np.asarray(p.gradient())
                  for n, p in jm.state_dict().items()}
    with dygraph.guard(CPU):
        m = port_model(named)
        loss = pt.transformer_loss(m(to_variable(src), to_variable(trg)),
                                   to_variable(lbl), label_smooth_eps=eps)
        loss.backward()
        np.testing.assert_allclose(float(loss.numpy()), want, rtol=1e-6)
        for n, p in m.named_parameters():
            np.testing.assert_allclose(p.gradient(), want_g[n], atol=1e-5,
                                       rtol=0, err_msg=n)


def test_loss_ignores_pad_positions(named):
    src, trg, lbl, _ = batch(4, pads=False)
    with dygraph.guard(CPU):
        m = port_model(named)
        logits = m(to_variable(src), to_variable(trg))
        full = float(pt.transformer_loss(logits, to_variable(lbl)).numpy())
        padded = lbl.copy()
        padded[:, 8:] = 0
        logits2 = logits.detach().clone()
        logits2[:, 8:] = 1e3                # garbage under the pads
        half = float(pt.transformer_loss(logits2[:, :8],
                                         to_variable(lbl[:, :8])).numpy())
        masked = float(pt.transformer_loss(logits2,
                                           to_variable(padded)).numpy())
    assert np.isfinite(full)
    np.testing.assert_allclose(masked, half, rtol=1e-6)


def _user_loop(model, opt, lm, steps, to_var):
    losses = []
    for src, trg, lbl, _ in steps:
        loss = lm.transformer_loss(model(to_var(src), to_var(trg)),
                                   to_var(lbl))
        loss.backward()
        opt.minimize(loss)
        model.clear_gradients()
        losses.append(float(loss.numpy()))
    return losses


def _jax_adam_noam_run(named, steps):
    with jdy.guard():
        jm = jax_model(named)
        jopt = jfluid.optimizer.Adam(learning_rate=jdy.NoamDecay(32, 4),
                                     parameter_list=jm.parameters())
        losses = _user_loop(jm, jopt, jt, steps, jdy.to_variable)
        return losses, {n: np.asarray(p.numpy())
                        for n, p in jm.state_dict().items()}


def test_three_adam_noam_steps_match_jax(named):
    """Losses within rtol 1e-4. Adam moves each entry by about
    lr * m / (sqrt(v) + eps), an lr-sized step whatever the gradient's
    size, so the f32 round-off of a small gradient becomes a difference
    in the parameter at the scale of the step, which the next steps carry
    on. The parameters are therefore held to the reference's own spread,
    as tests/test_torch_resnet.py holds its trajectories: the JAX run
    again from weights moved by one f32 ulp (rel 2**-23, random signs);
    per tensor, max |port - JAX| <= 4 max |spread - JAX| + 1e-4 max
    |JAX|."""
    steps = [batch(s) for s in (5, 6, 7)]
    want, want_p = _jax_adam_noam_run(named, steps)
    rng = np.random.default_rng(1)
    nudged = {n: (a * (1 + rng.choice([-1.0, 1.0], a.shape) * 2.0 ** -23)
                  ).astype(np.float32) for n, a in named.items()}
    _, spread_p = _jax_adam_noam_run(nudged, steps)
    with dygraph.guard(CPU):
        m = port_model(named)
        opt = fluid.optimizer.Adam(learning_rate=dygraph.NoamDecay(32, 4),
                                   parameter_list=m.parameters())
        got = _user_loop(m, opt, pt, steps, to_variable)
        got_p = {n: t.numpy() for n, t in m.state_dict().items()}
        assert opt._learning_rate.step_num == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for n, w in want_p.items():
        assert not np.array_equal(w, named[n]), n          # it moved
        err = np.abs(got_p[n] - w).max()
        own = np.abs(spread_p[n] - w).max()
        assert err <= 4 * own + 1e-4 * np.abs(w).max(), (n, err, own)


@pytest.mark.parametrize('shared', [False, True], ids=['own', 'shared'])
def test_greedy_and_beam_tokens_equal_jax(shared):
    named = transformer_init_params(
        pt.TransformerConfig.tiny(**cfg_kw(shared)), 8)
    src, _, _, mask = batch(9)
    with jdy.guard():
        jm = jax_model(named, shared)
        jm.eval()
        want_g = jt.greedy_decode(jm, src, 1, 2, max_len=8)
        want_b = jt.beam_search_decode(jm, src, 1, 2, beam_size=4,
                                       max_len=8)
        want_m = jt.greedy_decode(jm, src, 1, 2, max_len=8,
                                  src_mask=jdy.to_variable(mask))
    with dygraph.guard(CPU):
        m = port_model(named, shared)
        m.eval()
        got_g = pt.greedy_decode(m, src, 1, 2, max_len=8)
        got_b = pt.beam_search_decode(m, to_variable(src), 1, 2,
                                      beam_size=4, max_len=8)
        got_m = pt.greedy_decode(m, src, 1, 2, max_len=8, src_mask=mask)
    assert got_g.shape == got_b.shape == (B, 8)
    np.testing.assert_array_equal(got_g, want_g)
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_m, want_m)


def _loss_fn(model, src, trg, lbl):
    return pt.transformer_loss(model(src, trg), lbl)


def test_train_step_in_f32_equals_the_eager_loop(named):
    steps = [batch(s) for s in (10, 11, 12)]
    with dygraph.guard(CPU):
        m1 = port_model(named)
        opt1 = fluid.optimizer.Adam(learning_rate=dygraph.NoamDecay(32, 4),
                                    parameter_list=m1.parameters())
        want = _user_loop(m1, opt1, pt, steps, to_variable)
        m2 = port_model(named)
        opt2 = fluid.optimizer.Adam(learning_rate=dygraph.NoamDecay(32, 4),
                                    parameter_list=m2.parameters())
        step = TrainStep(m2, _loss_fn, opt2)
        got = [float(step(src, trg, lbl)) for src, trg, lbl, _ in steps]
        assert got == want
        for (n, a), b in zip(m1.state_dict().items(),
                             m2.state_dict().values()):
            assert torch.equal(a, b), n


@pytest.mark.parametrize('shared', [False, True], ids=['own', 'shared'])
def test_train_step_bf16_amp_keeps_f32_masters(shared):
    named = transformer_init_params(
        pt.TransformerConfig.tiny(**cfg_kw(shared)), 13)
    src, trg, lbl, _ = batch(14)
    with dygraph.guard(CPU):
        m = port_model(named, shared)
        params = m.parameters()
        opt = fluid.optimizer.Adam(1e-3, parameter_list=params)
        step = TrainStep(m, _loss_fn, opt, amp_dtype=torch.bfloat16)
        losses = [float(step(src, trg, lbl)) for _ in range(4)]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
        assert m.parameters() == params
        assert all(type(p) is dygraph.Parameter and p.is_leaf
                   and p.dtype == torch.float32 for p in params)
        assert (m.src_emb.weight is m.trg_emb.weight) == shared
        moved = m.trg_emb.weight.numpy() - named['trg_emb.weight']
        assert np.abs(moved).max() > 0
        assert len(opt._slots) == len(params)


def test_sequence_parallel_raises():
    with dygraph.guard(CPU):
        with pytest.raises(NotImplementedError, match='A.9'):
            pt.Transformer(pt.TransformerConfig.tiny(sequence_parallel=True))


USER_SCRIPT = '''
import paddle_tpu_torch as fluid
from paddle_tpu_torch import dygraph
from paddle_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                                 transformer_loss, greedy_decode,
                                                 beam_search_decode)
with dygraph.guard(fluid.CPUPlace()):
    model = Transformer(TransformerConfig.big(dropout=0.0, max_length=64))
    opt = fluid.optimizer.Adam(
        learning_rate=dygraph.NoamDecay(1024, 4000),
        parameter_list=model.parameters())
    loss = transformer_loss(model(dygraph.to_variable(src),
                                  dygraph.to_variable(trg)),
                            dygraph.to_variable(lbl))
    loss.backward(); opt.minimize(loss); model.clear_gradients()
    print(float(loss.numpy()))
    state = model.state_dict(); dygraph.save_dygraph(state, 'ckpt/transformer')
'''


def test_the_user_script_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(
        pt.TransformerConfig, 'big',
        classmethod(lambda cls, **kw: cls.tiny(**kw)))
    rs = np.random.RandomState(0)
    ids = {k: rs.randint(1, V, (2, 8)).astype(np.int64)
           for k in ('src', 'trg', 'lbl')}
    exec(compile(USER_SCRIPT, 'user_script.py', 'exec'), dict(ids))
    loss = float(capsys.readouterr().out.split()[-1])
    assert np.isfinite(loss) and loss > 0
    assert sorted(os.listdir('ckpt')) == ['transformer.pdparams.json',
                                          'transformer.pdparams.npz']
    state, _ = dygraph.load_dygraph('ckpt/transformer')
    assert 'dec_1.cross_attn.q.weight' in state
