"""Gradient clipping (counterpart of paddle_tpu/clip.py): by value, by each
gradient's norm, and by the global norm of all of them
(``scale = clip_norm / max(global_norm, clip_norm)``).

- Dygraph: :meth:`apply_group` clips a list of gradients with
  ``torch._foreach_*``; the global norm is one ``_foreach_norm`` and one
  scale on the device, with no host sync. ``apply_tree`` is the
  reference's ``{name: grad}`` form. The optimizers take a clip through
  ``grad_clip=`` and apply it after regularization.
- Static graph: ``process`` appends the reference's ops (``clip``,
  ``clip_by_norm``, or ``square``/``reduce_sum``/``sum``/``sqrt``/
  ``elementwise_max``/``scale``/``elementwise_div``) and returns the new
  ``[(param, grad)]``; ``set_gradient_clip`` records a clip on a program
  for optimizers built without ``grad_clip=``.
"""
from __future__ import annotations

import torch

__all__ = ['BaseGradientClipAttr', 'GradientClipByValue',
           'GradientClipByNorm', 'GradientClipByGlobalNorm',
           'ErrorClipByValue', 'set_gradient_clip',
           'append_gradient_clip_ops']


class BaseGradientClipAttr:
    def process(self, params_grads):
        """Static graph: new ``[(param, grad)]`` with clip ops appended."""
        raise NotImplementedError

    def apply_group(self, grads):
        """The clipped gradients of the list ``grads``, as new tensors."""
        raise NotImplementedError

    def apply_tree(self, grads):
        """``{name: grad}`` clipped, as a new dict."""
        names = list(grads)
        return dict(zip(names, self.apply_group([grads[n] for n in names])))


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def process(self, params_grads):
        from .layers.common import apply_op_layer
        return [(p, apply_op_layer('clip', {'x': g},
                                   {'min': self.min, 'max': self.max}))
                for p, g in params_grads]

    def apply_group(self, grads):
        grads = torch._foreach_clamp_min(grads, self.min)
        torch._foreach_clamp_max_(grads, self.max)
        return grads


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def process(self, params_grads):
        from .layers.common import apply_op_layer
        return [(p, apply_op_layer('clip_by_norm', {'x': g},
                                   {'max_norm': self.clip_norm}))
                for p, g in params_grads]

    def apply_group(self, grads):
        # clip / max(n, clip) is clip / n above the bound and exactly 1
        # below it, the reference's where(n > clip, g * (clip / n), g)
        norms = torch._foreach_norm(grads)
        torch._foreach_clamp_min_(norms, self.clip_norm)
        torch._foreach_reciprocal_(norms)
        torch._foreach_mul_(norms, self.clip_norm)
        return [g * f for g, f in zip(grads, norms)]


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name='default_group'):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def process(self, params_grads):
        from .layers.common import apply_op_layer
        sq = [apply_op_layer('reduce_sum', {'x': apply_op_layer(
            'square', {'x': g})}) for _, g in params_grads]
        total = apply_op_layer('sum', {'xs': sq})
        gn = apply_op_layer('sqrt', {'x': total})
        # scale = clip / max(gn, clip)
        denom = apply_op_layer('elementwise_max', {
            'x': gn, 'y': _const_like(gn, self.clip_norm)})
        out = []
        for p, g in params_grads:
            scaled = apply_op_layer('elementwise_div', {'x': apply_op_layer(
                'scale', {'x': g}, {'scale': self.clip_norm}), 'y': denom})
            out.append((p, scaled))
        return out

    def apply_group(self, grads):
        if not grads:
            return grads
        # the f32 norm of all of them, on the first one's device
        dev = grads[0].device
        gn = torch.linalg.vector_norm(torch.stack(
            [n.to(dev, torch.float32) for n in torch._foreach_norm(grads)]))
        scale = self.clip_norm / torch.clamp_min(gn, self.clip_norm)
        return torch._foreach_mul(grads, scale)


def _const_like(var, value):
    from .layers.tensor import fill_constant
    return fill_constant([1], var.dtype, value)


class ErrorClipByValue:
    """Accepted for the reference's API, which folds an activation
    gradient's error clip into value clipping of the gradients."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max


def set_gradient_clip(clip, param_list=None, program=None):
    """Record ``clip`` on ``program`` (the default main program), for the
    static ``minimize`` of an optimizer built without ``grad_clip=``."""
    from .framework import default_main_program
    program = program or default_main_program()
    program._gradient_clip = clip
    if param_list:
        for p in param_list:
            (p if not isinstance(p, str) else
             program.global_block().var(p)).gradient_clip = clip


def append_gradient_clip_ops(params_grads, program=None):
    """Static graph: ``params_grads`` through the clip that
    :func:`set_gradient_clip` recorded on ``program``, if any."""
    from .framework import default_main_program
    program = program or default_main_program()
    clip = getattr(program, '_gradient_clip', None)
    if clip is None:
        return params_grads
    return clip.process(params_grads)
