"""Transformer for NMT (WMT en-de): encoder-decoder with greedy and beam
decode (counterpart of paddle_tpu/models/transformer.py), built on the
dygraph API (``Layer``, ``Linear``, ``Embedding``, ``LayerNorm``,
``Dropout``), so it lives where an open ``dygraph.guard`` puts it.

As in the JAX model:

- batches are padded to a fixed length, with additive attention biases
  (-1e9 on pads and, in decoder self-attention, above the diagonal);
- attention is ``matmul -> + bias -> softmax -> dropout -> matmul``, the
  plain products, outside any fused kernel;
- ``greedy_decode`` and ``beam_search_decode`` run the decoder at one
  fixed (rows, max_len + 1) shape every step and read column t, with the
  same host-side search, length normalisation and EOS rules;
- ``state_dict()`` names equal the JAX model's (``enc_0.attn.q.weight``,
  ``dec_1.cross_attn.out.bias``, ``proj.weight``, ...), and with
  ``weight_sharing`` the one table appears as both ``src_emb.weight`` and
  ``trg_emb.weight``.

What differs: the JAX model rebuilds the positional table and the causal
mask from numpy on every call; here each is a device buffer made once and
registered non-persistent (so ``state_dict`` is unchanged). Both constants
are added in the activation's type: the JAX model adds them in f32, which
under bf16 AMP promotes every layer after the embedding to f32; here a
bf16 step stays bf16 (ROADMAP C records this). ``sequence_parallel=True``
(ring attention) raises (ROADMAP A.9).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..dygraph.layers import Layer
from ..dygraph.nn import Dropout, Embedding, LayerNorm, Linear, _promote
from ..dygraph.tape import _wrap
from ..initializer import NormalInitializer
from ..ops.loss_ops import softmax_with_cross_entropy
from ..ops.math_ops import not_equal
from ..ops.nn_ops import log_softmax, softmax
from ..ops.tensor_ops import one_hot
from ..param_attr import ParamAttr

__all__ = ['TransformerConfig', 'position_encoding', 'EncoderLayer',
           'DecoderLayer', 'Transformer', 'transformer_loss',
           'greedy_decode', 'beam_search_decode']

_NEG = -1e9


class TransformerConfig:
    def __init__(self, src_vocab_size=32000, trg_vocab_size=32000,
                 max_length=256, d_model=512, n_head=8, n_layer=6,
                 d_inner=2048, dropout=0.1, weight_sharing=False,
                 sequence_parallel=False):
        self.src_vocab_size = src_vocab_size
        self.trg_vocab_size = trg_vocab_size
        self.max_length = max_length
        self.d_model = d_model
        self.n_head = n_head
        self.n_layer = n_layer
        self.d_inner = d_inner
        self.dropout = dropout
        self.weight_sharing = weight_sharing
        self.sequence_parallel = sequence_parallel

    @classmethod
    def base(cls, **kw):
        return cls(d_model=512, n_head=8, n_layer=6, d_inner=2048, **kw)

    @classmethod
    def big(cls, **kw):
        return cls(d_model=1024, n_head=16, n_layer=6, d_inner=4096, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault('src_vocab_size', 64)
        kw.setdefault('trg_vocab_size', 64)
        kw.setdefault('max_length', 16)
        return cls(d_model=32, n_head=2, n_layer=2, d_inner=64, **kw)


def _pinit(cfg):
    return ParamAttr(initializer=NormalInitializer(0.0, cfg.d_model ** -0.5))


def position_encoding(max_len, d_model):
    """The (max_len, d_model) f32 sinusoid table, sines in even columns."""
    pos = np.arange(max_len)[:, None].astype('float32')
    i = np.arange(d_model // 2)[None, :].astype('float32')
    angle = pos / np.power(10000.0, 2 * i / d_model)
    enc = np.zeros((max_len, d_model), 'float32')
    enc[:, 0::2] = np.sin(angle)
    enc[:, 1::2] = np.cos(angle)
    return enc


def _dropout(cfg):
    return Dropout(cfg.dropout, dropout_implementation='upscale_in_train')


class _MHA(Layer):
    def __init__(self, cfg, sequence_parallel=False):
        super().__init__()
        if sequence_parallel:
            raise NotImplementedError('sequence_parallel=True (ring '
                                      'attention) is not ported yet '
                                      '(ROADMAP A.9)')
        d = cfg.d_model
        self.q = Linear(d, d, param_attr=_pinit(cfg))
        self.k = Linear(d, d, param_attr=_pinit(cfg))
        self.v = Linear(d, d, param_attr=_pinit(cfg))
        self.out = Linear(d, d, param_attr=_pinit(cfg))
        self.n_head = cfg.n_head
        self.d_head = d // cfg.n_head
        self.drop = _dropout(cfg)
        self.sequence_parallel = sequence_parallel
        n = cfg.max_length
        self.register_buffer('causal_mask', torch.triu(torch.full(
            (n, n), _NEG, device=self._param_device()), 1), persistent=False)

    def forward(self, q_in, kv_in, bias=None, causal=False):
        b, sq, d = q_in.shape
        sk = kv_in.shape[1]

        def heads(t, s):                       # (B, S, D) -> (B, H, S, Dh)
            return t.reshape(b, s, self.n_head, self.d_head).transpose(1, 2)

        q = heads(self.q(q_in), sq)
        k = heads(self.k(kv_in), sk)
        v = heads(self.v(kv_in), sk)
        scores = torch.matmul(q, k.transpose(-1, -2)) \
            * (1.0 / math.sqrt(self.d_head))
        if bias is not None:
            scores = scores + bias.to(scores.dtype)
        if causal:
            scores = scores + self.causal_mask[:sq, :sk].to(scores.dtype)
        probs = self.drop(softmax(scores))
        ctx = torch.matmul(*_promote(probs, v))
        return self.out(ctx.transpose(1, 2).reshape(b, sq, d))


class _FFN(Layer):
    def __init__(self, cfg):
        super().__init__()
        self.fc1 = Linear(cfg.d_model, cfg.d_inner, param_attr=_pinit(cfg),
                          act='relu')
        self.fc2 = Linear(cfg.d_inner, cfg.d_model, param_attr=_pinit(cfg))
        self.drop = _dropout(cfg)

    def forward(self, x):
        return self.fc2(self.drop(self.fc1(x)))


class EncoderLayer(Layer):
    def __init__(self, cfg):
        super().__init__()
        self.attn = _MHA(cfg, sequence_parallel=cfg.sequence_parallel)
        self.ln1 = LayerNorm(cfg.d_model)
        self.ffn = _FFN(cfg)
        self.ln2 = LayerNorm(cfg.d_model)
        self.drop = _dropout(cfg)

    def forward(self, x, bias):
        x = self.ln1(x + self.drop(self.attn(x, x, bias)))
        return self.ln2(x + self.drop(self.ffn(x)))


class DecoderLayer(Layer):
    def __init__(self, cfg):
        super().__init__()
        self.self_attn = _MHA(cfg)
        self.ln1 = LayerNorm(cfg.d_model)
        self.cross_attn = _MHA(cfg)
        self.ln2 = LayerNorm(cfg.d_model)
        self.ffn = _FFN(cfg)
        self.ln3 = LayerNorm(cfg.d_model)
        self.drop = _dropout(cfg)

    def forward(self, x, enc_out, self_bias, cross_bias):
        x = self.ln1(x + self.drop(self.self_attn(x, x, self_bias,
                                                  causal=True)))
        x = self.ln2(x + self.drop(self.cross_attn(x, enc_out, cross_bias)))
        return self.ln3(x + self.drop(self.ffn(x)))


class Transformer(Layer):
    """``Transformer(cfg)``: ``forward(src_ids, trg_ids, src_mask=None)``
    takes (B, S) int ids and an optional (B, S) 1/0 source mask and returns
    (B, S_trg, trg_vocab) logits."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.src_emb = Embedding([cfg.src_vocab_size, cfg.d_model],
                                 param_attr=_pinit(cfg))
        if cfg.weight_sharing and cfg.src_vocab_size == cfg.trg_vocab_size:
            self.trg_emb = self.src_emb
        else:
            self.trg_emb = Embedding([cfg.trg_vocab_size, cfg.d_model],
                                     param_attr=_pinit(cfg))
        self.register_buffer(
            'pos_enc', torch.from_numpy(position_encoding(
                cfg.max_length, cfg.d_model)).to(self._param_device()),
            persistent=False)
        self.enc_layers = []
        self.dec_layers = []
        for i in range(cfg.n_layer):
            enc = EncoderLayer(cfg)
            dec = DecoderLayer(cfg)
            self.add_sublayer(f'enc_{i}', enc)
            self.add_sublayer(f'dec_{i}', dec)
            self.enc_layers.append(enc)
            self.dec_layers.append(dec)
        self.proj = Linear(cfg.d_model, cfg.trg_vocab_size,
                           param_attr=_pinit(cfg))
        self.drop = _dropout(cfg)

    def _embed(self, emb, ids):
        b, s = ids.shape[0], ids.shape[1]
        # lookup_table squeezes a (B, 1) id column (LoD convention)
        x = emb(ids).reshape(b, s, self.cfg.d_model)
        x = x * (self.cfg.d_model ** 0.5)
        return self.drop(x + self.pos_enc[:s].to(x.dtype))

    @staticmethod
    def _pad_bias(pad_mask):
        """(B, S) 1=valid -> (B, 1, 1, S) additive bias."""
        m = pad_mask.reshape(pad_mask.shape[0], 1, 1, pad_mask.shape[1])
        return (1.0 - m) * _NEG

    def encode(self, src_ids, src_mask=None):
        bias = self._pad_bias(src_mask) if src_mask is not None else None
        x = self._embed(self.src_emb, src_ids)
        for layer in self.enc_layers:
            x = layer(x, bias)
        return x

    def decode(self, trg_ids, enc_out, src_mask=None):
        cross_bias = (self._pad_bias(src_mask) if src_mask is not None
                      else None)
        x = self._embed(self.trg_emb, trg_ids)
        for layer in self.dec_layers:
            x = layer(x, enc_out, None, cross_bias)
        return self.proj(x)

    def forward(self, src_ids, trg_ids, src_mask=None):
        return self.decode(trg_ids, self.encode(src_ids, src_mask), src_mask)


def transformer_loss(logits, labels, pad_id=0, label_smooth_eps=0.1):
    """Label-smoothed cross entropy, pad positions masked out: the sum
    over non-pad positions over their count. logits (B, S, V), labels
    (B, S) ids."""
    V = logits.shape[-1]
    flat = logits.reshape(-1, V)
    lbl = labels.reshape(-1, 1)
    onehot = one_hot(lbl, depth=V)
    if label_smooth_eps:
        onehot = onehot * (1.0 - label_smooth_eps) + label_smooth_eps / V
    loss = softmax_with_cross_entropy(flat, onehot, soft_label=True)[0]
    mask = not_equal(lbl, torch.full((1,), pad_id, dtype=lbl.dtype,
                                     device=lbl.device)).to(torch.float32)
    loss = loss.reshape(-1, 1) * mask
    return _wrap(loss.sum() / (mask.sum() + 1e-9))


def _device_of(model):
    return model.pos_enc.device


def _ids(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


@torch.no_grad()
def greedy_decode(model, src_ids, bos_id, eos_id, max_len=32, src_mask=None):
    """Greedy decode; returns (B, max_len) int64 ids on the host, eos-padded
    past each row's stop. The decoder runs every step at one fixed
    (B, max_len + 1) shape and step t reads logits column t, which the
    causal mask keeps independent of the eos padding after it."""
    dev = _device_of(model)
    src_ids = _ids(src_ids, dev)
    src_mask = None if src_mask is None else _ids(src_mask, dev)
    enc = model.encode(src_ids, src_mask)
    B = src_ids.shape[0]
    ys = np.full((B, max_len + 1), eos_id, np.int64)
    ys[:, 0] = bos_id
    done = np.zeros(B, bool)
    for t in range(max_len):
        logits = model.decode(_ids(ys, dev), enc, src_mask)
        nxt = logits[:, t].argmax(-1).cpu().numpy()
        nxt = np.where(done, eos_id, nxt)
        done |= (nxt == eos_id)
        ys[:, t + 1] = nxt
        if done.all():
            break
    return ys[:, 1:]


@torch.no_grad()
def beam_search_decode(model, src_ids, bos_id, eos_id, beam_size=4,
                       max_len=32, src_mask=None, alpha=0.6):
    """Beam search over the decoder, as the JAX model runs it: dense
    (B * W) beams at one fixed (B * W, max_len + 1) decoder shape, the
    search on the host (finished beams extend only with eos at score 0),
    then the best beam of each row by length-normalised score
    ``score / ((5 + len) / 6) ** alpha``. Returns (B, max_len) int64 ids."""
    dev = _device_of(model)
    src_ids = _ids(src_ids, dev)
    src_mask = None if src_mask is None else _ids(src_mask, dev)
    enc = model.encode(src_ids, src_mask)
    B = src_ids.shape[0]
    W = beam_size
    enc_t = enc.repeat_interleave(W, dim=0)
    mask_t = (None if src_mask is None
              else src_mask.repeat_interleave(W, dim=0))
    ys = np.full((B * W, max_len + 1), eos_id, np.int64)
    ys[:, 0] = bos_id
    scores = np.tile(np.array([0.0] + [-1e9] * (W - 1), np.float32), B)
    finished = np.zeros(B * W, bool)
    for t in range(max_len):
        logits = model.decode(_ids(ys, dev), enc_t, mask_t)
        logp = log_softmax(logits[:, t].float()).cpu().numpy()  # (B*W, V)
        V = logp.shape[-1]
        fin_row = np.full(V, -1e9, np.float32)
        fin_row[eos_id] = 0.0
        logp = np.where(finished[:, None], fin_row[None], logp)
        total = (scores[:, None] + logp).reshape(B, W * V)
        top = np.argsort(-total, axis=1)[:, :W]               # (B, W)
        scores = np.take_along_axis(total, top, 1).reshape(-1)
        beam_idx = top // V + np.arange(B)[:, None] * W
        tok = (top % V).astype(np.int64)
        ys = ys[beam_idx.reshape(-1)]
        ys[:, t + 1] = tok.reshape(-1)
        finished = finished[beam_idx.reshape(-1)] | \
            (tok.reshape(-1) == eos_id)
        if finished.all():
            break
    lens = (ys[:, 1:] != eos_id).sum(1) + 1
    norm = scores / (((5 + lens) / 6.0) ** alpha)
    best = norm.reshape(B, W).argmax(1) + np.arange(B) * W
    return ys[best, 1:]
