"""BERT (base/large) pretraining, and the attention and transformer blocks
the causal LM is built from (counterpart of paddle_tpu/models/bert.py).

Attention has three paths, as in the JAX model:

- ``cache=``: the paged-KV-cache path the decode engine drives;
- ``use_fused_attention=True``: one ``fused_attention`` op, the hand-written
  flash-attention kernels on the card (ops/nn_ops.py), forward and backward.
  It bypasses attention-probability dropout, and warns when that dropout is
  set;
- otherwise the unfused matmul -> additive mask -> softmax -> matmul path.

Linear, LayerNorm and Dropout come from dygraph/nn.py, where the reference
keeps them too. Linear layers keep torch's (out, in) weight layout;
paddle_tpu_torch/convert.py transposes Paddle's (in, out) weights into it.
Submodule names give exactly the JAX model's ``named_parameters()`` names.
Types promote as
in JAX where an f32 tensor meets bf16 weights under AMP (a (B, 1, 1, S)
attention bias is f32), so such a mix computes in f32 rather than failing.

Dropout draws its masks from a ``torch.Generator`` that
``BertForPretraining`` owns and seeds (``seed=``), never from torch's global
generator; the JAX model's bits are not reproduced.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..dygraph.nn import Dropout, LayerNorm, Linear, _promote
from ..ops.loss_ops import softmax_with_cross_entropy
from ..ops.nn_ops import fused_attention

__all__ = ['BertConfig', 'MultiHeadAttention', 'TransformerLayer',
           'BertModel', 'BertPretrainHeads', 'BertForPretraining',
           'pretrain_loss']


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act='gelu',
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, use_fused_attention=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        # attention through the fused op (the flash kernels on the card);
        # bypasses attention-prob dropout, so use for p_drop=0 or eval
        self.use_fused_attention = use_fused_attention

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def large():
        return BertConfig(hidden_size=1024, num_hidden_layers=24,
                          num_attention_heads=16, intermediate_size=4096)

    @staticmethod
    def tiny():
        """For tests."""
        return BertConfig(vocab_size=1024, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=128, max_position_embeddings=128)


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        h = cfg.hidden_size
        self.q = Linear(h, h, device=device)
        self.k = Linear(h, h, device=device)
        self.v = Linear(h, h, device=device)
        self.out = Linear(h, h, device=device)
        self.drop = Dropout(cfg.attention_probs_dropout_prob, generator)
        self.n_heads = cfg.num_attention_heads
        self.d_head = h // cfg.num_attention_heads
        self._fused = cfg.use_fused_attention
        if self._fused and cfg.attention_probs_dropout_prob > 0:
            warnings.warn(
                'use_fused_attention bypasses attention-probability '
                'dropout (attention_probs_dropout_prob='
                f'{cfg.attention_probs_dropout_prob} is ignored); set it '
                'to 0 to silence this warning', stacklevel=2)

    def forward(self, x, attn_bias=None, causal=False, cache=None):
        """``x`` (B, S, H). ``attn_bias`` broadcasts to (B, heads, S, S).
        ``causal``: the fused path masks with the top-left ``tril``, the
        unfused one adds the upper-triangular -1e9 mask. ``cache`` is a
        serving/decode/kv_cache.py ``CacheContext`` whose
        ``attend(q, k, v, sm_scale=)`` writes this layer's K/V into the
        paged pool and attends through the block tables."""
        b, s, h = x.shape
        sm_scale = 1.0 / math.sqrt(self.d_head)

        def heads(t):
            return t.reshape(b, s, self.n_heads, self.d_head).transpose(1, 2)

        q = heads(self.q(x))
        k = heads(self.k(x))
        v = heads(self.v(x))
        if cache is not None:
            ctx = cache.attend(q, k, v, sm_scale=sm_scale)
        elif self._fused:
            ctx = fused_attention(q, k, v, attn_bias, sm_scale=sm_scale,
                                  causal=causal)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
            if attn_bias is not None:
                scores = scores + attn_bias
            if causal:
                mask = np.triu(np.full((s, s), -1e9, 'float32'), 1)
                scores = scores + torch.from_numpy(mask).to(x.device)
            probs = self.drop(torch.softmax(scores, dim=-1))
            ctx = torch.matmul(*_promote(probs, v))
        ctx = ctx.transpose(1, 2).reshape(b, s, h)
        return self.out(ctx)


class TransformerLayer(nn.Module):
    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        if cfg.hidden_act != 'gelu':
            raise NotImplementedError(f'hidden_act={cfg.hidden_act!r}: only '
                                      f'the exact-erf gelu is ported')
        h = cfg.hidden_size
        self.attn = MultiHeadAttention(cfg, device=device,
                                       generator=generator)
        self.attn_ln = LayerNorm(h, device=device)
        self.ffn1 = Linear(h, cfg.intermediate_size, act='gelu',
                           device=device)
        self.ffn2 = Linear(cfg.intermediate_size, h, device=device)
        self.ffn_ln = LayerNorm(h, device=device)
        self.drop = Dropout(cfg.hidden_dropout_prob, generator)

    def forward(self, x, attn_bias=None, causal=False, cache=None):
        a = self.attn(x, attn_bias, causal=causal, cache=cache)
        x = self.attn_ln(x + self.drop(a))
        f = self.ffn2(self.ffn1(x))
        return self.ffn_ln(x + self.drop(f))


class BertModel(nn.Module):
    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_emb = nn.Embedding(cfg.vocab_size, h, device=device)
        self.pos_emb = nn.Embedding(cfg.max_position_embeddings, h,
                                    device=device)
        self.type_emb = nn.Embedding(cfg.type_vocab_size, h, device=device)
        self.emb_ln = LayerNorm(h, device=device)
        self.emb_drop = Dropout(cfg.hidden_dropout_prob, generator)
        self.encoder = nn.ModuleList(
            [TransformerLayer(cfg, device=device, generator=generator)
             for _ in range(cfg.num_hidden_layers)])
        self.pooler = Linear(h, h, act='tanh', device=device)

    def forward(self, input_ids, token_type_ids, attention_mask=None):
        """``input_ids``, ``token_type_ids`` (B, S) int; ``attention_mask``
        (B, S) 1/0 becomes the additive (B, 1, 1, S) f32 bias
        ``m * 1e4 - 1e4``. Returns (sequence output, pooled first token)."""
        b, s = input_ids.shape
        pos_ids = torch.arange(s, device=input_ids.device)[None, :] \
            .expand(b, s)
        emb = self.word_emb(input_ids) + self.pos_emb(pos_ids) \
            + self.type_emb(token_type_ids)
        x = self.emb_drop(self.emb_ln(emb))
        attn_bias = None
        if attention_mask is not None:
            m = attention_mask.to(torch.float32).reshape(b, 1, 1, s)
            attn_bias = m * 10000.0 + -10000.0
        for layer in self.encoder:
            x = layer(x, attn_bias)
        pooled = self.pooler(x[:, 0])
        return x, pooled


class BertPretrainHeads(nn.Module):
    """MLM and NSP heads. The MLM decoder is tied to the word-embedding
    matrix: it owns only ``decoder_bias``; the embedding weight is passed in
    at forward time, so its gradient is the sum of the lookup's and the
    decoder product's."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.decoder_bias = nn.Parameter(
            torch.zeros(cfg.vocab_size, device=device))
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                act=cfg.hidden_act, device=device)
        self.transform_ln = LayerNorm(cfg.hidden_size, device=device)
        self.nsp = Linear(cfg.hidden_size, 2, device=device)

    def forward(self, seq_out, pooled, word_emb_weight):
        h = self.transform_ln(self.transform(seq_out))
        mlm_logits = F.linear(*_promote(h, word_emb_weight,
                                        self.decoder_bias))
        return mlm_logits, self.nsp(pooled)


class BertForPretraining(nn.Module):
    """``BertForPretraining(cfg, device=None, seed=0)``: parameters live on
    ``device`` (the card unless ``'cpu'`` is asked for; see device.py) and
    start from torch's default initialisation; load real ones with
    ``load_state_dict(convert.bert_state_dict_from_paddle(...))``.
    ``seed`` seeds the model's own dropout generator."""

    def __init__(self, cfg=None, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg or BertConfig.base()
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed))
        self.bert = BertModel(self.cfg, device=device,
                              generator=self.generator)
        self.heads = BertPretrainHeads(self.cfg, device=device)

    def forward(self, input_ids, token_type_ids, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.heads(seq, pooled, self.bert.word_emb.weight)


def pretrain_loss(model, input_ids, token_type_ids, mlm_labels, nsp_labels):
    """MLM + NSP loss; ``mlm_labels`` (B, S) uses -1 for unmasked positions,
    ``nsp_labels`` is (B, 1). The MLM term is the mean over labelled
    positions, the NSP term the mean over the batch."""
    mlm_logits, nsp_logits = model(input_ids, token_type_ids)
    b, s, v = mlm_logits.shape
    flat_labels = mlm_labels.reshape(b * s, 1)
    mlm_raw, _ = softmax_with_cross_entropy(
        mlm_logits.reshape(b * s, v), flat_labels, ignore_index=-1)
    mask = (flat_labels >= 0).to(torch.float32)
    mlm_loss = (mlm_raw * mask).sum() / (mask.sum() + 1e-6)
    nsp_raw, _ = softmax_with_cross_entropy(nsp_logits, nsp_labels)
    return mlm_loss + nsp_raw.mean()
