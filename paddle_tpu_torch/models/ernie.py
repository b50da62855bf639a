"""ERNIE finetuning (counterpart of paddle_tpu/models/ernie.py): a BERT
backbone (models/bert.py ``BertModel``) with a dropout and a classifier
``Linear`` on the pooled first token, and the reference's finetune recipe,
``finetune_optimizer``: Adam with L2 decay, an optional linear warm-up and
AMP's ``decorate``. ERNIE 1.0 shares BERT's architecture; its
pretraining's entity masking lives in the data, so the model is BERT's.

``BASELINE.json``'s ERNIE config trains ``ErnieConfig.base`` at batch
64 x 128 with bf16 AMP and ``TrainStep(accum_steps=4)`` (bench.py
``bench_ernie``). ``ErnieConfig`` inherits ``use_fused_attention``: with it
on, attention runs the flash-attention kernels (ops/nn_ops.py
``fused_attention``), forward and backward.
"""
from __future__ import annotations

import torch

from ..dygraph.layers import Layer
from ..dygraph.nn import Dropout, Linear
from .bert import BertConfig, BertModel

__all__ = ['ErnieConfig', 'ErnieForSequenceClassification',
           'finetune_optimizer']


class ErnieConfig(BertConfig):
    @classmethod
    def base(cls, **kw):
        """ERNIE 1.0 base: BERT-base with an 18,000-token vocabulary."""
        kw.setdefault('vocab_size', 18000)
        kw.setdefault('hidden_size', 768)
        kw.setdefault('num_hidden_layers', 12)
        kw.setdefault('num_attention_heads', 12)
        kw.setdefault('intermediate_size', 3072)
        return cls(**kw)


class ErnieForSequenceClassification(Layer):
    """``ErnieForSequenceClassification(cfg, num_labels=2, dropout=0.1)``;
    ``forward(input_ids, token_type_ids=None)`` takes (B, S) int ids
    (token types zeros when None) and returns (B, num_labels) logits.
    Parameter names equal the JAX model's (``backbone.word_emb.weight``,
    ..., ``classifier.weight``); parameters live on ``device``, else the
    open guard's device (dygraph/layers.py)."""

    def __init__(self, cfg: BertConfig, num_labels=2, dropout=0.1, *,
                 device=None):
        super().__init__(device=device)
        dev = self._param_device()
        self.backbone = BertModel(cfg, device=dev)
        self.drop = Dropout(dropout,
                            dropout_implementation='upscale_in_train')
        self.classifier = Linear(cfg.hidden_size, num_labels, device=dev)

    def forward(self, input_ids, token_type_ids=None):
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        _, pooled = self.backbone(input_ids, token_type_ids)
        return self.classifier(self.drop(pooled))


def finetune_optimizer(model, learning_rate=5e-5, warmup_steps=0,
                       total_steps=0, weight_decay=0.01, k_steps=1,
                       use_amp=False):
    """The reference's ERNIE finetune recipe: ``Adam`` over the model's
    parameters with ``L2Decay(weight_decay)``, its rate warmed up linearly
    from 0 over ``warmup_steps`` (``LinearLrWarmup``) when that is
    nonzero, wrapped by ``decorate`` with ``use_amp``. ``total_steps`` and
    ``k_steps`` are accepted and unused, as in the reference: gradient
    merge is ``TrainStep(accum_steps=)``."""
    from ..dygraph.learning_rate_scheduler import LinearLrWarmup
    from ..optimizer import AdamOptimizer
    from ..regularizer import L2Decay
    lr = learning_rate
    if warmup_steps:
        lr = LinearLrWarmup(learning_rate, warmup_steps, 0.0, learning_rate)
    opt = AdamOptimizer(lr, parameter_list=model.parameters(),
                        regularization=L2Decay(weight_decay))
    if use_amp:
        from ..contrib.mixed_precision import decorate
        opt = decorate(opt)
    return opt
