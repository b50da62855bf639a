"""Losses of the training path (counterpart of paddle_tpu/ops/loss_ops.py)."""
from __future__ import annotations

import torch

__all__ = ['softmax_with_cross_entropy']


def softmax_with_cross_entropy(logits, label, *, ignore_index=-100):
    """Hard-label softmax cross entropy over the last axis: returns
    ``(loss, softmax)``, ``loss`` of ``logits``'s shape with the last axis
    kept at 1, both in ``logits``'s type. A ``label`` with a trailing axis of
    1 (``(N, 1)``) is squeezed. Rows whose label equals ``ignore_index``
    (negative sentinels such as -1 or -100 included) give exactly 0."""
    logp = torch.log_softmax(logits, dim=-1)
    sm = torch.exp(logp)
    if label.dim() == logits.dim() and label.shape[-1] == 1:
        label = label.squeeze(-1)
    li = label.clamp(0, logits.shape[-1] - 1).long()
    loss = -torch.gather(logp, -1, li.unsqueeze(-1))
    loss = torch.where((label == ignore_index).unsqueeze(-1),
                       torch.zeros((), dtype=loss.dtype, device=loss.device),
                       loss)
    return loss, sm
