"""Losses and metrics of the training paths (counterpart of
paddle_tpu/ops/loss_ops.py): ``softmax_with_cross_entropy``, ``accuracy``,
and the losses of the Fluid recipes, ``cross_entropy`` (of probabilities,
as PaddleCV's image classification computes it after a softmax),
``sigmoid_cross_entropy_with_logits`` and ``square_error_cost``."""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = ['softmax_with_cross_entropy', 'accuracy', 'cross_entropy',
           'sigmoid_cross_entropy_with_logits', 'square_error_cost']


@register_op('softmax_with_cross_entropy', outputs=['Loss', 'Softmax'])
def softmax_with_cross_entropy(logits, label, *, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False, numeric_stable_mode=True):
    """Softmax cross entropy over ``axis``: returns ``(loss, softmax)``,
    ``loss`` of ``logits``'s shape with ``axis`` kept at 1, both in
    ``logits``'s type, as the reference computes them.

    - ``soft_label``: ``label`` is a distribution of ``logits``'s shape and
      the loss is ``-sum(label * log_softmax(logits), axis)``.
    - Otherwise ``label`` holds class indices; a ``label`` of ``logits``'s
      rank with 1 along ``axis`` is squeezed there. Rows whose label equals
      ``ignore_index`` (negative sentinels such as -1 or -100 included)
      give exactly 0.

    ``return_softmax`` and ``numeric_stable_mode`` are accepted and ignored,
    as the reference ignores them: the softmax is always returned, and the
    log-softmax is always the stable one."""
    logp = torch.log_softmax(logits, dim=axis)
    sm = torch.exp(logp)
    if soft_label:
        return -(label * logp).sum(dim=axis, keepdim=True), sm
    if label.dim() == logits.dim() and label.shape[axis] == 1:
        label = label.squeeze(axis)
    li = label.clamp(0, logits.shape[axis] - 1).long()
    loss = -torch.gather(logp, axis, li.unsqueeze(axis))
    loss = torch.where((label == ignore_index).unsqueeze(axis),
                       torch.zeros((), dtype=loss.dtype, device=loss.device),
                       loss)
    return loss, sm


def _squeeze_label(label):
    if label.dim() >= 2 and label.shape[-1] == 1:
        return label[..., 0]
    return label


@register_op('accuracy', outputs=['Out', 'Correct', 'Total'])
def accuracy(pred, label, *, k=1):
    """Top-``k`` accuracy of ``pred`` (N, C) against class indices
    ``label`` (N,) or (N, 1): ``(correct / N, correct, N)``, the first
    f32 and the counts int32 (Paddle's accuracy op counts in int; the JAX
    package's int64 computes in int32 with x64 off). All three are
    scalars, as in the JAX package."""
    label = _squeeze_label(label)
    top = torch.topk(pred, k, dim=-1).indices
    correct = (top == label.to(top.dtype)[:, None]).any(-1)
    ncorrect = correct.sum().to(torch.int32)
    total = torch.full((), pred.shape[0], dtype=torch.int32,
                       device=pred.device)
    return ncorrect.float() / total.float(), ncorrect, total


@register_op('cross_entropy')
def cross_entropy(x, label, *, soft_label=False, ignore_index=-100):
    """``-log(x[label] + 1e-8)`` of probabilities ``x`` (N, ..., C), kept
    at 1 along the last dim; with ``soft_label``,
    ``-sum(label * log(x + 1e-8))``. Rows whose label equals
    ``ignore_index`` give exactly 0. The 1e-8 is the reference's."""
    eps = 1e-8
    if soft_label:
        return -(label * torch.log(x + eps)).sum(-1, keepdim=True)
    label = _squeeze_label(label)
    idx = label.clamp(0, x.shape[-1] - 1).long()[..., None]
    loss = -torch.log(torch.gather(x, -1, idx) + eps)
    return torch.where((label == ignore_index)[..., None],
                       torch.zeros((), dtype=loss.dtype, device=loss.device),
                       loss)


@register_op('sigmoid_cross_entropy_with_logits')
def sigmoid_cross_entropy_with_logits(x, label, *, ignore_index=-100,
                                      normalize=False):
    """The stable ``max(x, 0) - x * label + log1p(exp(-|x|))``, 0 where
    ``label`` equals ``ignore_index``; ``normalize`` divides by the count
    of the others (at least 1)."""
    label = label.to(x.dtype)
    loss = (torch.clamp(x, min=0) - x * label
            + torch.log1p(torch.exp(-x.abs())))
    mask = label != ignore_index
    loss = torch.where(mask, loss,
                       torch.zeros((), dtype=loss.dtype, device=loss.device))
    if normalize:
        loss = loss / mask.sum().clamp(min=1)
    return loss


@register_op('square_error_cost')
def square_error_cost(x, label):
    return torch.square(x - label)
