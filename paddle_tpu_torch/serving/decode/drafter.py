"""Draft-token proposers for speculative decoding (counterpart of
paddle_tpu/serving/decode/drafter.py).

A drafter guesses the next n tokens of a greedy stream cheaply; the target
model checks all of them in one (S, k) verify step (engine.spec_step) and
keeps the longest prefix it agrees with. A wrong guess costs only the lane
it rode in, and the stream never depends on the drafter::

    drafter.propose(history, n) -> list of <= n draft token ids

``history`` is the request's prompt and every token emitted so far; its last
element is the pending (emitted, not yet cached) token the drafts continue.

- :class:`NGramDrafter`: no weights; the tokens that followed the most
  recent earlier occurrence of the history's longest matching suffix
  n-gram (prompt copies and repetitions). The default.
- :class:`DraftModelDrafter`: a small ``TransformerLM`` decoded greedily at
  one padded shape (models/causal_lm.greedy_generate), for traffic with no
  surface repetition.
"""
from __future__ import annotations

from ..errors import InvalidRequest

__all__ = ['NGramDrafter', 'DraftModelDrafter', 'build_drafter',
           'DRAFTER_CHOICES']

DRAFTER_CHOICES = ('ngram', 'draft_model', 'off')


class NGramDrafter:
    """Suffix-match drafter: the longest n-gram first (``max_ngram`` down to
    ``min_ngram``), the most recent earlier occurrence wins."""

    def __init__(self, max_ngram=3, min_ngram=1):
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, history, n):
        history = list(history)
        n = int(n)
        if n <= 0 or len(history) < self.min_ngram + 1:
            return []
        top = min(self.max_ngram, len(history) - 1)
        for g in range(top, self.min_ngram - 1, -1):
            suffix = history[-g:]
            # right to left: the most recent earlier occurrence predicts best
            for i in range(len(history) - g - 1, -1, -1):
                if history[i:i + g] == suffix:
                    cont = history[i + g:i + g + n]
                    if cont:
                        return cont
        return []


class DraftModelDrafter:
    """Greedy continuation from a small draft LM at one padded shape.

    ``pad_len`` should be the target engine's ``padded_context``, so the
    draft model's positions line up with the stream it drafts for.
    Proposals are cut so that history + drafts never pass the pad."""

    def __init__(self, model, pad_len):
        model.eval()
        self.model = model
        self.pad_len = int(pad_len)

    def propose(self, history, n):
        from ...models.causal_lm import greedy_generate
        history = [int(t) for t in history]
        n = min(int(n), self.pad_len - len(history))
        if n <= 0 or not history:
            return []
        return greedy_generate(self.model, history, n, pad_len=self.pad_len)


def build_drafter(choice, pad_len, draft_model=None, device=None):
    """A drafter from a name (the ``PADDLE_TPU_SPEC_DRAFTER`` knob or the
    scheduler's argument): 'off' gives None (verify rounds feed no drafts),
    'ngram' an :class:`NGramDrafter`, 'draft_model' a
    :class:`DraftModelDrafter` over ``draft_model``, or, without one, over
    ``TransformerLM(CausalLMConfig.tiny())`` on ``device``. Anything that is
    not a string passes through (an object with ``propose``)."""
    if choice is not None and not isinstance(choice, str):
        return choice
    name = (choice or 'ngram').strip()
    if name not in DRAFTER_CHOICES:
        raise InvalidRequest(f'drafter {name!r} is not supported; supported '
                             f'values: {", ".join(DRAFTER_CHOICES)}')
    if name == 'off':
        return None
    if name == 'ngram':
        return NGramDrafter()
    if draft_model is None:
        from ...models.causal_lm import CausalLMConfig, TransformerLM
        draft_model = TransformerLM(CausalLMConfig.tiny(), device=device)
    return DraftModelDrafter(draft_model, pad_len)
