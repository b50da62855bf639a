"""append_backward: mark a program for autodiff (counterpart of
paddle_tpu/backward.py).

As in the JAX package, no grad op is appended per op: one marker op
(``framework.BACKWARD_OP_TYPE``) names the loss and the parameters, and
declares their ``<name>@GRAD`` variables. The Executor runs the ops before
the marker with the parameters as leaf tensors that require grad, and at
the marker takes ``torch.autograd.grad`` of the loss (executor.py), where
the JAX package wraps the forward in ``jax.value_and_grad``.
``checkpoints`` go on the marker: the executor then runs the forward in
segments that end at the ops producing them and recomputes each in the
backward (``torch.utils.checkpoint``, where the JAX package uses
``jax.checkpoint``).

Rows-only (sparse) embedding gradients are not ported: they need
``lookup_table(is_sparse=True)``, which is not ported either (ROADMAP
A.10), so a program cannot ask for them yet.
"""
from __future__ import annotations

from .framework import BACKWARD_OP_TYPE

__all__ = ['append_backward', 'gradients']


def _grad_name(name):
    return name + '@GRAD'


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append the backward marker of ``loss``; returns
    ``[(param, grad_var)]`` for the trainable parameters (those in
    ``parameter_list`` if given, less ``no_grad_set``). ``checkpoints``
    (Variables or names) are recorded on the marker for recompute."""
    program = loss.block.program
    block = program.global_block()
    params = [p for p in program.all_parameters() if p.trainable]
    if parameter_list:
        wanted = {p if isinstance(p, str) else p.name for p in parameter_list}
        params = [p for p in params if p.name in wanted]
    if no_grad_set:
        banned = {v if isinstance(v, str) else v.name for v in no_grad_set}
        params = [p for p in params if p.name not in banned]
    if not params:
        raise ValueError('no trainable parameters to differentiate')
    param_grads = []
    for p in params:
        g = block.create_var(name=_grad_name(p.name), shape=list(p.shape),
                             dtype=p.dtype, stop_gradient=True)
        param_grads.append((p, g))
    block.append_op(BACKWARD_OP_TYPE, inputs={'Loss': loss.name},
                    outputs={'Grads': [g.name for _, g in param_grads]},
                    attrs={'loss': loss.name,
                           'params': [p.name for p, _ in param_grads],
                           'checkpoints': [
                               c.name if hasattr(c, 'name') else c
                               for c in (checkpoints or [])]})
    return param_grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """fluid.gradients: the gradient Variables of one scalar target with
    respect to ``inputs`` (parameters or fed variables)."""
    if target_gradients is not None:
        raise NotImplementedError('gradients(target_gradients=) is not '
                                  'ported yet (ROADMAP A.10)')
    t = targets[0] if isinstance(targets, (list, tuple)) else targets
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    block = t.block
    grads = [block.create_var(name=_grad_name(x.name),
                              shape=list(x.shape or []), dtype=x.dtype,
                              stop_gradient=True) for x in inputs]
    block.append_op(BACKWARD_OP_TYPE, inputs={'Loss': t.name},
                    outputs={'Grads': [g.name for g in grads]},
                    attrs={'loss': t.name, 'params': [x.name for x in inputs],
                           'wrt_inputs': True, 'checkpoints': []})
    return grads
