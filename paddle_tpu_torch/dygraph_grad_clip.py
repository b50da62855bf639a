"""Dygraph gradient clips (counterpart of paddle_tpu/dygraph_grad_clip.py,
the reference's ``fluid.dygraph_grad_clip``). Each is called on a list of
``(parameter, gradient)`` pairs and returns a new list, a gradient of None
left None; the clipped gradients are new tensors, computed with torch's
multi-tensor (``_foreach``) ops on the gradients' device, with no host
sync."""
from __future__ import annotations

import torch

__all__ = ['GradClipByValue', 'GradClipByNorm', 'GradClipByGlobalNorm']


class GradClipBase:
    def _clip(self, para_and_grad):
        raise NotImplementedError

    def __call__(self, para_and_grad):
        return self._clip(para_and_grad)


def _with_grads(para_and_grad, fn):
    """``para_and_grad`` with its gradients (those not None) replaced by
    ``fn(gradients)``."""
    idx = [i for i, (_, g) in enumerate(para_and_grad) if g is not None]
    if not idx:
        return list(para_and_grad)
    new = fn([para_and_grad[i][1] for i in idx])
    out = list(para_and_grad)
    for i, g in zip(idx, new):
        out[i] = (out[i][0], g)
    return out


class GradClipByValue(GradClipBase):
    """Every gradient entry clamped to ``[min_value, max_value]``; with one
    argument the range is ``[-|v|, |v|]``."""

    def __init__(self, min_value, max_value=None):
        if max_value is None:
            max_value = abs(min_value)
            min_value = -max_value
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def _clip(self, para_and_grad):
        def clamp(grads):
            out = torch._foreach_clamp_min(grads, self.min_value)
            torch._foreach_clamp_max_(out, self.max_value)
            return out
        return _with_grads(para_and_grad, clamp)


class GradClipByNorm(GradClipBase):
    """Each gradient scaled by ``min(clip_norm / max(|g|, 1e-12), 1)``, so
    its own L2 norm is at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, para_and_grad):
        def scale(grads):
            norms = torch.stack(torch._foreach_norm(grads))
            s = torch.clamp(self.clip_norm / torch.clamp(norms, min=1e-12),
                            max=1.0)
            return torch._foreach_mul(grads, list(s.unbind()))
        return _with_grads(para_and_grad, scale)


class GradClipByGlobalNorm(GradClipBase):
    """Every gradient scaled by ``min(max_global_norm / max(G, 1e-12), 1)``,
    G the L2 norm of all of them together."""

    def __init__(self, max_global_norm):
        self.max_global_norm = float(max_global_norm)

    def _clip(self, para_and_grad):
        def scale(grads):
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            s = torch.clamp(self.max_global_norm
                            / torch.clamp(norm, min=1e-12), max=1.0)
            return torch._foreach_mul(grads, s)
        return _with_grads(para_and_grad, scale)
