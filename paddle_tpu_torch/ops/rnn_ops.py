"""The beam-search ops (counterpart of two ops of
paddle_tpu/ops/rnn_ops.py): ``beam_search_step``, one step of the legacy
``beam_search`` over dense (batch x beam) candidates, and
``gather_tree``, the backtrace of a finished search. The JAX package's
whole-sequence recurrences (``dynamic_lstm``, ``dynamic_gru`` and their
units) are not ported (ROADMAP A.10)."""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = ['beam_search_step', 'gather_tree']


@register_op('beam_search_step',
             outputs=('SelectedIds', 'SelectedScores', 'ParentIdx'))
def beam_search_step(pre_ids, pre_scores, ids, scores, *, beam_size, end_id,
                     is_accumulated=True, return_parent_idx=False):
    """One beam step over dense candidates: ``pre_ids``/``pre_scores``
    (B*W, 1), ``ids``/``scores`` (B*W, K) each beam's candidates. A
    finished beam (``pre_id == end_id``) continues only with ``end_id`` at
    its score; then the top W of each batch row's W*K. Returns the
    selected ids and scores (B*W, 1) and the flat parent index (B*W,) of
    each."""
    pre_ids = pre_ids.reshape(-1)
    pre_scores = pre_scores.reshape(-1)
    BW, K = scores.shape
    W = beam_size
    B = BW // W
    if not is_accumulated:
        scores = pre_scores[:, None] + torch.log(torch.clamp(scores, 1e-20))
    finished = (pre_ids == end_id)[:, None]
    fin_scores = torch.cat(
        [pre_scores[:, None],
         torch.full((BW, K - 1), -1e9, dtype=scores.dtype,
                    device=scores.device)], 1)
    scores = torch.where(finished, fin_scores, scores)
    ids = torch.where(finished, torch.full_like(ids, end_id), ids)
    top_scores, top_idx = torch.topk(scores.reshape(B, W * K), W, dim=-1)
    parent = torch.div(top_idx, K, rounding_mode='floor') + (
        torch.arange(B, device=scores.device) * W)[:, None]
    sel_ids = torch.gather(ids.reshape(B, W * K), 1, top_idx)
    return (sel_ids.reshape(BW, 1).long(), top_scores.reshape(BW, 1),
            parent.reshape(BW).long())


@register_op('gather_tree')
def gather_tree(ids, parents):
    """The beam-search backtrace: ``ids`` and ``parents`` (T, B, W), the
    parents each step's beam index in the step before; walks the parent
    pointers from the last step back and returns each final beam's ids
    (T, B, W). One gather of the ids and one of the parents a step, no
    host read."""
    T, B, W = ids.shape
    beam = torch.arange(W, device=ids.device).expand(B, W)
    out = [None] * T
    for t in range(T - 1, -1, -1):
        out[t] = torch.gather(ids[t], 1, beam)
        beam = torch.gather(parents[t], 1, beam).long()
    return torch.stack(out)
