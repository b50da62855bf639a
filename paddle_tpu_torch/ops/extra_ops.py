"""Ops that the reference builds inside layer functions (counterpart of
four ops of paddle_tpu/ops/extra_ops.py): ``spectral_norm``, ``nce``,
``gru_unit`` and ``tree_conv``, which the dygraph layers SpectralNorm,
NCE, GRUUnit and TreeConv and their static layers run. The JAX package
computes them in XLA, outside any Pallas kernel, so they are torch's own
ops here. The file's other ops are not ported (ROADMAP A.10).

Where the JAX op departs from Paddle 1.7, the port computes what the JAX
op computes (the parity target) and says so: ``spectral_norm`` restarts its
power iteration from ones on every call (ROADMAP C.4 item 16), ``nce``
draws one set of uniform negatives for the whole batch (C.4 item 14), and
``tree_conv`` never reads ``edges`` (C.4 item 15)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op

__all__ = ['spectral_norm', 'nce', 'nce_loss', 'check_nce_defaults',
           'gru_unit', 'tree_conv']


@register_op('spectral_norm')
def spectral_norm(w, *, dim=0, power_iters=1, eps=1e-12):
    """``w / σ``, σ its largest singular value as ``max(power_iters, 1)``
    steps of power iteration estimate it on ``w`` with ``dim`` moved first
    and the rest flattened. The iteration starts from ones on every call,
    as the JAX op's does (Paddle keeps U and V between calls; ROADMAP C.4
    item 16); the gradient runs through the iteration."""
    wm = w.movedim(dim, 0).reshape(w.shape[dim], -1)
    u = torch.ones(wm.shape[0], dtype=w.dtype, device=w.device)
    v = torch.ones(wm.shape[1], dtype=w.dtype, device=w.device)
    for _ in range(max(power_iters, 1)):
        v = wm.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return w / (u @ wm @ v)


def nce_loss(x, label, weight, bias, negatives):
    """The plain NCE loss with its negative classes given: a (B, 1) column
    of ``-log σ(x·w[y] + b[y]) - Σ_n log σ(-(x·w[n] + b[n]))``, the same
    ``negatives`` (int64 (num_neg_samples,)) for every row."""
    label = label.reshape(-1)
    pos_logit = torch.sum(x * weight[label], -1) + bias[label]
    neg_logit = x @ weight[negatives].t() + bias[negatives]
    pos_loss = -F.logsigmoid(pos_logit)
    neg_loss = -torch.sum(F.logsigmoid(-neg_logit), -1)
    return (pos_loss + neg_loss)[:, None]


@register_op('nce', needs_rng=True)
def nce(x, label, weight, bias, *, num_total_classes, num_neg_samples=10,
        key=None):
    """Noise-contrastive estimation over ``num_total_classes`` classes:
    ``num_neg_samples`` negatives drawn uniformly from ``key`` (the
    device's ``torch.Generator``), one set for the whole batch as the JAX
    op draws them (ROADMAP C.4 item 14), then :func:`nce_loss`. The
    draws differ from the JAX package's PRNG by design."""
    if x.device.type == 'meta':
        neg = torch.zeros(num_neg_samples, dtype=torch.int64, device='meta')
    else:
        neg = torch.randint(0, num_total_classes, (num_neg_samples,),
                            generator=key, device=x.device)
    return nce_loss(x, label, weight, bias, neg)


_NCE_DEFAULTS = dict(sample_weight=None, sampler='uniform', custom_dist=None,
                     seed=0, is_sparse=False)


def check_nce_defaults(**given):
    """Raise on an argument of the NCE layers that the reference never
    reads (``sample_weight``, ``sampler``, ``custom_dist``, ``seed``,
    ``is_sparse``), given a value other than its default."""
    for name, v in given.items():
        d = _NCE_DEFAULTS[name]
        if v is d or (d is not None and type(v) is type(d) and v == d):
            continue
        raise NotImplementedError(
            f'NCE({name}={v!r}): the reference never reads it (one set of '
            f'uniform negatives for the batch); only the default is ported '
            f'(ROADMAP C.4 item 14)')


@register_op('gru_unit', outputs=['Hidden', 'ResetHidden', 'Gate'])
def gru_unit(x, hidden, weight, bias=None, *, origin_mode=False):
    """One GRU step on the projected input ``x`` (B, 3D) and ``hidden`` (B,
    D) with ``weight`` (D, 3D) (the update and reset gates' columns, then
    the candidate's) and ``bias`` (1, 3D): returns (the new hidden, the
    reset hidden r·h, the gates [u, r, c]), sigmoid gates and a tanh
    candidate. ``origin_mode`` mixes u·h + (1-u)·c, else (1-u)·h + u·c."""
    d = hidden.shape[-1]
    g = x if bias is None else x + bias
    ur = torch.sigmoid(g[:, :2 * d] + hidden @ weight[:, :2 * d])
    u, r = ur[:, :d], ur[:, d:]
    rh = r * hidden
    c = torch.tanh(g[:, 2 * d:] + rh @ weight[:, 2 * d:])
    new_h = u * hidden + (1 - u) * c if origin_mode \
        else (1 - u) * hidden + u * c
    return new_h, rh, torch.cat([ur, c], -1)


@register_op('tree_conv')
def tree_conv(nodes, edges, weight, *, max_depth=8):
    """The JAX op's dense tree convolution: ``nodes`` (B, N, F) through
    ``weight`` (F, 3, O, K) as ``self + (left + right) / 2`` of its three
    (F, O, K) slices, (B, N, O, K), linear (the layer applies ``act``).
    ``edges`` and ``max_depth`` are not read, as in the JAX op (ROADMAP
    C.4 item 15)."""
    agg_self = torch.einsum('bnf,fok->bnok', nodes, weight[:, 0])
    agg_l = torch.einsum('bnf,fok->bnok', nodes, weight[:, 1])
    agg_r = torch.einsum('bnf,fok->bnok', nodes, weight[:, 2])
    return agg_self + 0.5 * (agg_l + agg_r)
