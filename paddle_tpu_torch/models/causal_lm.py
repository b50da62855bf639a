"""Decoder-only causal transformer LM, the model the decode engine serves
(counterpart of paddle_tpu/models/causal_lm.py).

Built from the BERT blocks (models/bert.py) with the causal mask and a
weight-tied LM head that reads ``word_emb.weight``. Two execution modes share
every parameter:

- **whole-sequence** (``cache=None``): the full (B, L) padded sequence in one
  forward, the uncached reference :func:`greedy_generate` runs; with
  ``use_fused_attention=True`` its attention is one
  ``fused_attention(causal=True)`` call per layer (the flash kernels on the
  card), as in the JAX model;
- **incremental** (``cache=`` a serving/decode ``CacheContext``): prefill
  writes the prompt's K/V into paged cache blocks, decode steps run at fixed
  (S, 1) shape and read K/V through per-slot block tables.

Parity between the two is a tolerance, not bitwise: the cached path sums in
another order (and on the card through the paged kernels). Greedy streams
are compared with :func:`max_logit_gaps`: under teacher forcing each served
token's logit must lie within a small tolerance of its row's maximum.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .bert import TransformerLayer

__all__ = ['CausalLMConfig', 'TransformerLM', 'greedy_generate',
           'sampled_generate', 'max_logit_gaps']


class CausalLMConfig:
    """The BERT config fields TransformerLayer reads, plus the LM's.
    ``attention_probs_dropout_prob`` is pinned to 0 (the cached attention
    path has no attention-probability dropout)."""

    def __init__(self, vocab_size=32000, hidden_size=512,
                 num_hidden_layers=6, num_attention_heads=8,
                 intermediate_size=2048, hidden_act='gelu',
                 hidden_dropout_prob=0.1, max_position_embeddings=512,
                 initializer_range=0.02, use_fused_attention=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = 0.0
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.use_fused_attention = use_fused_attention

    @staticmethod
    def tiny():
        """Test scale."""
        return CausalLMConfig(vocab_size=128, hidden_size=32,
                              num_hidden_layers=2, num_attention_heads=2,
                              intermediate_size=64,
                              max_position_embeddings=128)


class TransformerLM(nn.Module):
    """``TransformerLM(cfg, device=None)``: parameters live on ``device``
    (the card unless ``'cpu'`` is asked for; see device.py). They start from
    torch's default initialisation; load real ones with ``load_state_dict``
    (convert.py builds the state dict from Paddle-layout numpy arrays, e.g.
    the JAX model's, or from a seed)."""

    def __init__(self, cfg: CausalLMConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_emb = nn.Embedding(cfg.vocab_size, h, device=device)
        self.pos_emb = nn.Embedding(cfg.max_position_embeddings, h,
                                    device=device)
        self.emb_ln = nn.LayerNorm(h, eps=1e-5, device=device)
        self.emb_drop = nn.Dropout(cfg.hidden_dropout_prob)
        self.blocks = nn.ModuleList([TransformerLayer(cfg, device=device)
                                     for _ in range(cfg.num_hidden_layers)])

    @property
    def device(self):
        return self.word_emb.weight.device

    @property
    def num_cache_layers(self):
        return self.cfg.num_hidden_layers

    def forward(self, input_ids, pos_ids=None, cache=None):
        """``input_ids`` (B, S) int -> logits (B, S, V) f32. ``pos_ids``
        defaults to 0..S-1 per row; the decode engine passes each slot's
        context position. ``cache`` routes attention through the paged KV
        cache."""
        b, s = input_ids.shape
        if pos_ids is None:
            pos_ids = torch.arange(s, device=input_ids.device)[None, :] \
                .expand(b, s)
        x = self.word_emb(input_ids) + self.pos_emb(pos_ids)
        x = self.emb_drop(self.emb_ln(x))
        for blk in self.blocks:
            x = blk(x, None, causal=True, cache=cache)
        # weight-tied LM head: the embedding matrix, transposed
        return torch.matmul(x, self.word_emb.weight.t())


def _check_lengths(prompt_ids, max_new_tokens, pad_len):
    prompt = [int(t) for t in prompt_ids]
    if not prompt:
        raise ValueError('empty prompt')
    n = len(prompt)
    length = int(pad_len) if pad_len else n + int(max_new_tokens)
    if length < n + int(max_new_tokens):
        raise ValueError(f'pad_len={length} cannot hold prompt({n}) + '
                         f'{max_new_tokens} new tokens')
    return prompt, length


def sampled_generate(model, prompt_ids, max_new_tokens, sampler, eos_id=None,
                     pad_len=None):
    """Uncached whole-sequence decode at ONE fixed padded shape: every step
    re-runs the full (1, pad_len) sequence and hands the logits row of the
    last real position to ``sampler(row, index)`` (``index`` is the 0-based
    generated-token index). Pair it with a serving ``TokenSampler`` and
    ``pad_len == engine.padded_context`` for the engine's sampled path.
    Returns the generated ids (stops at ``eos_id``)."""
    prompt, length = _check_lengths(prompt_ids, max_new_tokens, pad_len)
    n = len(prompt)
    buf = torch.zeros((1, length), dtype=torch.long, device=model.device)
    buf[0, :n] = torch.tensor(prompt)
    out = []
    with torch.no_grad():
        for i in range(int(max_new_tokens)):
            c = n + i
            row = model(buf)[0, c - 1].cpu().numpy()
            nxt = int(sampler(row, i))
            out.append(nxt)
            buf[0, c] = nxt
            if eos_id is not None and nxt == int(eos_id):
                break
    return out


def greedy_generate(model, prompt_ids, max_new_tokens, eos_id=None,
                    pad_len=None):
    """:func:`sampled_generate` with the exact argmax: the uncached
    reference the decode engine is tested against (run it with
    ``pad_len == engine.padded_context``)."""
    return sampled_generate(model, prompt_ids, max_new_tokens,
                            lambda row, i: int(row.argmax()), eos_id=eos_id,
                            pad_len=pad_len)


def max_logit_gaps(model, prompt_ids, tokens, pad_len=None):
    """Teacher-forced check of a generated stream: one uncached forward over
    ``prompt + tokens`` (padded to ``pad_len``); returns, per generated
    token, ``max(row) - row[token]`` for the logits row that predicted it
    (0 where the token is the exact argmax). A greedy stream is right when
    every gap is within the near-tie tolerance."""
    prompt, length = _check_lengths(prompt_ids, len(tokens), pad_len)
    n = len(prompt)
    seq = prompt + [int(t) for t in tokens]
    buf = torch.zeros((1, length), dtype=torch.long, device=model.device)
    buf[0, :len(seq)] = torch.tensor(seq)
    with torch.no_grad():
        rows = model(buf)[0, n - 1:n - 1 + len(tokens)].cpu().numpy()
    picked = rows[np.arange(len(tokens)), np.asarray(tokens, np.int64)]
    return rows.max(axis=-1) - picked
