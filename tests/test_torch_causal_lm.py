"""The port's TransformerLM (paddle_tpu_torch/models/) against the JAX
package's, on the CPU at CausalLMConfig.tiny(): weight transfer through
paddle_tpu_torch/convert.py, whole-sequence logits (atol 1e-4: f32 sums in
another order through six matmul layers), greedy generation, and the
device rule."""
import numpy as np
import pytest
import torch

from paddle_tpu.dygraph import guard
from paddle_tpu.dygraph.tape import Tensor, no_grad_guard
from paddle_tpu.models import causal_lm as jax_lm
from paddle_tpu_torch.convert import (expected_shapes, init_params,
                                      state_dict_from_paddle)
from paddle_tpu_torch.models import causal_lm as port_lm
import torch_jax_seed  # noqa: F401  (caps torch's threads)

ATOL = 1e-4


@pytest.fixture(scope='module')
def jax_model():
    with guard():
        model = jax_lm.TransformerLM(jax_lm.CausalLMConfig.tiny())
        model.eval()
        yield model


def jax_params(model):
    return {n: np.asarray(p.numpy()) for n, p in model.named_parameters()}


def port_model(named):
    model = port_lm.TransformerLM(port_lm.CausalLMConfig.tiny(),
                                  device='cpu')
    model.load_state_dict(state_dict_from_paddle(named))
    return model.eval()


def jax_logits(model, ids):
    with no_grad_guard():
        return np.asarray(model(Tensor(ids, stop_gradient=True)).numpy())


def port_logits(model, ids):
    with torch.no_grad():
        return model(torch.from_numpy(ids)).numpy()


def test_weight_transfer_whole_sequence_logits(jax_model):
    model = port_model(jax_params(jax_model))
    ids = np.random.RandomState(0).randint(0, 128, (2, 12)).astype(np.int64)
    np.testing.assert_allclose(port_logits(model, ids),
                               jax_logits(jax_model, ids), atol=ATOL)


def test_linear_weights_are_transposed(jax_model):
    """The port's Linear keeps Paddle's (in, out) weight, so no Linear
    weight is transposed on the way in."""
    named = jax_params(jax_model)
    sd = state_dict_from_paddle(named)
    w = named['blocks.0.ffn1.weight']                  # Paddle (in, out)
    assert w.shape == (32, 64)
    assert tuple(sd['blocks.0.ffn1.weight'].shape) == (32, 64)
    np.testing.assert_array_equal(sd['blocks.0.ffn1.weight'].numpy(), w)
    np.testing.assert_array_equal(sd['word_emb.weight'].numpy(),
                                  named['word_emb.weight'])


def test_conversion_rejects_unknown_and_missing_names(jax_model):
    named = jax_params(jax_model)
    with pytest.raises(KeyError, match='unknown'):
        state_dict_from_paddle({**named, 'blocks.0.attn.z.weight':
                                np.zeros((32, 32), np.float32)})
    short = dict(named)
    del short['blocks.1.ffn_ln.bias']
    with pytest.raises(KeyError, match='missing'):
        state_dict_from_paddle(short)
    bad = {**named, 'blocks.0.attn.q.weight': np.zeros((32, 31), np.float32)}
    with pytest.raises(ValueError, match='shape'):
        state_dict_from_paddle(bad)


def test_init_params_feed_both_packages(jax_model):
    """Seeded numpy weights in Paddle layout: the JAX model's names and
    shapes, deterministic, truncated at two std, and the same logits
    through both packages."""
    cfg = port_lm.CausalLMConfig.tiny()
    named = init_params(cfg, 5)
    ref = jax_params(jax_model)
    assert list(named) == list(ref) == list(expected_shapes(cfg))
    assert all(named[n].shape == ref[n].shape for n in named)
    w = named['blocks.0.attn.q.weight']
    assert np.abs(w).max() <= 2 * cfg.initializer_range + 1e-7
    assert 0.012 < w.std() < 0.02
    np.testing.assert_array_equal(w, init_params(cfg, 5)[
        'blocks.0.attn.q.weight'])
    old = {n: p.numpy() for n, p in jax_model.named_parameters()}
    try:
        for n, p in jax_model.named_parameters():
            p.set_value(named[n])
        ids = np.random.RandomState(1).randint(0, 128, (1, 9)).astype(
            np.int64)
        np.testing.assert_allclose(port_logits(port_model(named), ids),
                                   jax_logits(jax_model, ids), atol=ATOL)
    finally:
        for n, p in jax_model.named_parameters():
            p.set_value(old[n])


def test_greedy_generate_matches_jax(jax_model):
    """Greedy tokens of the port's uncached reference against the JAX
    package's; a differing token must be a near tie under teacher forcing
    (its logit within 1e-3 of the row's max in the JAX model)."""
    model = port_model(jax_params(jax_model))
    rng = np.random.RandomState(2)
    for n, budget in ((3, 8), (9, 5)):
        prompt = [int(t) for t in rng.randint(3, 100, n)]
        got = port_lm.greedy_generate(model, prompt, budget, pad_len=24)
        want = jax_lm.greedy_generate(jax_model, prompt, budget, pad_len=24)
        assert len(got) == len(want) == budget
        seq = np.zeros((1, 24), np.int64)
        seq[0, :n + budget] = prompt + got
        rows = jax_logits(jax_model, seq)[0, n - 1:n - 1 + budget]
        gaps = rows.max(-1) - rows[np.arange(budget), got]
        assert gaps.max() <= 1e-3, (got, want, gaps)
        assert port_lm.max_logit_gaps(model, prompt, got,
                                      pad_len=24).max() == 0.0


def test_constructor_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_lm.TransformerLM(port_lm.CausalLMConfig.tiny())
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        port_lm.TransformerLM(port_lm.CausalLMConfig.tiny(), device='cuda')


def test_fused_attention_whole_sequence_logits(jax_model):
    """``use_fused_attention=True`` sends the uncached whole-sequence
    forward through ``fused_attention(causal=True)`` in both packages; the
    logits agree at the same bar as the unfused path."""
    named = jax_params(jax_model)
    cfg = jax_lm.CausalLMConfig.tiny()
    cfg.use_fused_attention = True
    pcfg = port_lm.CausalLMConfig.tiny()
    pcfg.use_fused_attention = True
    model = port_lm.TransformerLM(pcfg, device='cpu')
    model.load_state_dict(state_dict_from_paddle(named))
    model.eval()
    with guard():
        jm = jax_lm.TransformerLM(cfg)
        for n, p in jm.named_parameters():
            p.set_value(named[n])
        jm.eval()
        ids = np.random.RandomState(4).randint(0, 128, (2, 12)).astype(
            np.int64)
        want = jax_logits(jm, ids)
    np.testing.assert_allclose(port_logits(model, ids), want, atol=ATOL)
