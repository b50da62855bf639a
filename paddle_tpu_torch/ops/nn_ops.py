"""Neural-network ops of the port, their hand-written CUDA kernels'
wrappers and their plain PyTorch versions (counterpart of
paddle_tpu/ops/nn_ops.py).

- ``paged_attention`` and ``paged_prefill_attention``: the two ops the
  decode-serving path runs in every attention layer
  (csrc/paged_attention.cu), over f32, bf16 or int8 pools; the verify read
  of speculative decoding is ``paged_attention``'s (S, H, K, D) form.
- ``fused_attention``: the training path's attention, a
  ``torch.autograd.Function`` whose forward and backward are the three
  flash-attention kernels of csrc/flash_attention.cu
  (``flash_attention_fwd``, ``flash_attention_bwd_dkv``,
  ``flash_attention_bwd_dq``).
- ``conv2d``, ``pool2d``, ``batch_norm`` and ``relu``: the ops ResNet runs;
  ``softmax`` and ``dropout`` with them on the static graph's path;
  ``lookup_table``, ``layer_norm`` and ``log_softmax``, which the dygraph
  Transformer adds; ``conv3d``, ``conv2d_transpose``,
  ``conv3d_transpose``, ``group_norm`` and ``bilinear_tensor_product``,
  which the rest of the dygraph layers and the vision models run.
  The reference computes them in XLA, outside any Pallas kernel, so here
  they are torch's own ops (``F.conv2d``, ``F.max_pool2d``, ...) with
  Paddle's semantics and the reference's types.

On a CUDA tensor each kernel op launches its kernels or raises; on a CPU
tensor it runs its plain version (``*_ref``). There is no fallback from a
kernel to a plain version.

Each kernel wrapper counts its launches in ``<wrapper>.launches`` (see
:func:`launch_counts` / :func:`reset_launch_counts`, which also cover
ops/pallas_conv.py's K4), so a run can show that the path really went
through the kernels.
"""
from __future__ import annotations

import ctypes
import math
import numbers

import torch
import torch.nn.functional as F

from .registry import register_op

__all__ = ['paged_attention', 'paged_attention_ref', 'paged_prefill_attention',
           'paged_prefill_attention_ref', 'fused_attention',
           'fused_attention_ref', 'fused_attention_fwd_ref',
           'fused_attention_bwd_ref', 'flash_attention_fwd',
           'flash_attention_bwd_dkv', 'flash_attention_bwd_dq',
           'flash_kernel_info', 'FLASH_KINDS', 'paged_kernel_info',
           'PAGED_KINDS', 'PAGED_PAYLOADS', 'verify_rows',
           'conv2d', 'pool2d', 'batch_norm', 'relu', 'softmax',
           'log_softmax', 'layer_norm', 'dropout', 'lookup_table',
           'conv3d', 'conv2d_transpose', 'conv3d_transpose', 'group_norm',
           'bilinear_tensor_product',
           'launch_counts', 'reset_launch_counts', 'HEAD_DIMS']

# head dims the kernels are compiled for (csrc/*.cu)
HEAD_DIMS = (16, 32, 64, 128)
# the pool payloads the paged kernels are compiled for, by the code their
# launchers take (serving/decode/kv_cache.py's KV_DTYPE_CODES)
PAGED_PAYLOADS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
PAGED_KINDS = ('paged_decode_attention', 'paged_prefill_attention')


def _gather_pages(pages, block_tables, s, h, d, scales=None):
    """(H, NB, BS, D) cache pool + (S, nbs) tables -> dense (S, H, nbs*BS, D)
    per-slot key/value view, f32. A quantized pool dequantizes after the
    gather, as the reference does: int8 payload times its row's scale
    (``scales`` (H, NB, BS), gathered the same way), bf16 cast to f32."""
    nb = block_tables.shape[1]
    bs = pages.shape[2]
    idx = block_tables.reshape(-1).long()
    g = pages.index_select(1, idx)
    g = g.reshape(h, s, nb, bs, d).permute(1, 0, 2, 3, 4)
    g = g.reshape(s, h, nb * bs, d)
    if scales is not None:
        sc = scales.index_select(1, idx).reshape(h, s, nb, bs)
        sc = sc.permute(1, 0, 2, 3).reshape(s, h, nb * bs)
        return g.float() * sc[..., None]
    if g.dtype != torch.float32:
        return g.float()
    return g


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens,
                        k_scales=None, v_scales=None, *, sm_scale=1.0):
    """Plain version of :func:`paged_attention`: gather each slot's blocks
    into a dense f32 view, then matmul -> mask -> softmax -> matmul. Masked
    keys get exactly zero probability (``finfo.min`` underflows ``exp``), so
    stale rows in reused blocks never bleed into the result. A (S, H, K, D)
    ``q`` is the verify read: row j attends ``context_lens + j`` keys."""
    multi = q.dim() == 4
    s, h = q.shape[:2]
    d = q.shape[-1]
    kq = q.shape[2] if multi else 1
    k = _gather_pages(k_pages, block_tables, s, h, d, k_scales)
    v = _gather_pages(v_pages, block_tables, s, h, d, v_scales)
    t_pad = k.shape[2]
    scores = torch.matmul(q if multi else q[:, :, None, :],
                          k.transpose(-1, -2))
    if sm_scale != 1.0:
        scores = scores * sm_scale
    extent = (context_lens.to(q.device)[:, None, None, None]
              + torch.arange(kq, device=q.device)[None, None, :, None])
    valid = torch.arange(t_pad, device=q.device)[None, None, None, :] < extent
    scores = scores.masked_fill(~valid, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, v)
    return out if multi else out.reshape(s, h, d)


def paged_prefill_attention_ref(q, k_pages, v_pages, block_tables,
                                k_scales=None, v_scales=None, *,
                                sm_scale=1.0):
    """Plain version of :func:`paged_prefill_attention`: causal attention of
    ``q`` (B, H, Lq, D) over the gathered (and dequantized) paged view; row
    r attends keys 0..r."""
    b, h, lq, d = q.shape
    kd = _gather_pages(k_pages, block_tables, b, h, d, k_scales)
    vd = _gather_pages(v_pages, block_tables, b, h, d, v_scales)
    t_pad = kd.shape[2]
    scores = torch.matmul(q, kd.transpose(-1, -2))
    if sm_scale != 1.0:
        scores = scores * sm_scale
    causal = (torch.arange(t_pad, device=q.device)[None, None, None, :]
              <= torch.arange(lq, device=q.device)[None, None, :, None])
    scores = scores.masked_fill(~causal, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, vd)


def _check_scales(k_pages, k_scales, v_scales):
    """An int8 pool needs both row-scale tensors, an f32 or bf16 pool takes
    none; each is (H, NB, BS) f32, contiguous, on the pool's device."""
    int8 = k_pages.dtype == torch.int8
    for name, sc in (('k_scales', k_scales), ('v_scales', v_scales)):
        if int8 and sc is None:
            raise ValueError(f'{name} is missing: an int8 pool needs '
                             f'k_scales and v_scales')
        if not int8 and sc is not None:
            raise ValueError(f'{name} given for a {k_pages.dtype} pool: only '
                             f'int8 pools take row scales')
        if sc is None:
            continue
        want = tuple(k_pages.shape[:3])
        if (sc.dtype != torch.float32 or tuple(sc.shape) != want
                or sc.device != k_pages.device or not sc.is_contiguous()):
            raise ValueError(f'{name} must be a contiguous {want} float32 '
                             f'tensor on {k_pages.device}, got {sc.dtype} '
                             f'{tuple(sc.shape)} on {sc.device}')


def _check_pool(k_pages, v_pages, block_tables, dev):
    """Validate the pool and tables for a kernel launch; returns
    (H, NB, BS, D, max_bps, payload code)."""
    for name, t in (('k_pages', k_pages), ('v_pages', v_pages),
                    ('block_tables', block_tables)):
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, expected {dev}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if block_tables.dtype != torch.int32:
        raise TypeError(f'block_tables must be torch.int32, got '
                        f'{block_tables.dtype}')
    if k_pages.dtype not in PAGED_PAYLOADS or v_pages.dtype != k_pages.dtype:
        raise TypeError(f'k_pages/v_pages must both be one of '
                        f'{list(PAGED_PAYLOADS)}, got {k_pages.dtype} and '
                        f'{v_pages.dtype}')
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f'k_pages/v_pages must both be (H, NB, BS, D), got '
                         f'{tuple(k_pages.shape)} and {tuple(v_pages.shape)}')
    h, nb, bs, d = k_pages.shape
    if d not in HEAD_DIMS:
        raise ValueError(f'head_dim {d} unsupported: the kernels are built '
                         f'for {HEAD_DIMS}')
    if block_tables.dim() != 2:
        raise ValueError(f'block_tables must be 2-D, got '
                         f'{tuple(block_tables.shape)}')
    return h, nb, bs, d, block_tables.shape[1], PAGED_PAYLOADS[k_pages.dtype]


def paged_kernel_info(kind, head_dim, payload=torch.float32):
    """What K1's (``kind`` 'paged_decode_attention') or K2's
    ('paged_prefill_attention') body at ``head_dim`` over a ``payload``
    pool (f32, bf16 or int8) was built with, read from the loaded library
    on the current card: ``{'registers', 'spill_bytes', 'static_smem',
    'dynamic_smem', 'ctas_per_sm', 'threads'}``."""
    if (kind not in PAGED_KINDS or head_dim not in HEAD_DIMS
            or payload not in PAGED_PAYLOADS):
        raise ValueError(f'no paged body for {kind} at head_dim {head_dim} '
                         f'over {payload}')
    from ._build import kernel_info
    return kernel_info('paged_attention', 'paged_attention_kernel_info',
                       PAGED_KINDS.index(kind), head_dim,
                       PAGED_PAYLOADS[payload])


def _check_status(lib, err, name):
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {err} '
                           f'({msg})')


def verify_rows(q, block_tables, context_lens, max_keys):
    """The verify read (``q`` (S, H, K, D), row j of a slot attending
    ``context_lens + j`` keys) as the S*K single-query rows K1 takes:
    ``(rows (S*K, H, D) slot-major, tables (S*K, max_bps), contexts
    (S*K,))``, each row the function K1 computes for a lockstep step at
    that context.

    A padded lane's context ``c + 1 + j`` (a slot that fed fewer than K
    tokens, or an inactive one at context 1) can pass ``max_keys`` =
    max_bps * BS near the end of a table, and the blocks the slot owns.
    Each context is clamped to ``max_keys``, so no row reads a table entry
    past the table's width; past the owned blocks the tables pad with the
    scratch block, so every row reads inside the pool. Those rows are
    garbage that the scheduler ignores."""
    s, h, kq, d = q.shape
    rows = q.transpose(1, 2).reshape(s * kq, h, d).contiguous()
    tables = block_tables.repeat_interleave(kq, dim=0)
    lanes = torch.arange(kq, dtype=torch.int32, device=context_lens.device)
    contexts = (context_lens[:, None] + lanes[None, :]).reshape(-1)
    return rows, tables, contexts.clamp(max=max_keys)


def _launch_decode(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                   context_lens, pool, sm_scale):
    """One K1 launch over (S, H, D) rows ``q``; ``pool`` is
    :func:`_check_pool`'s tuple."""
    h, nb, bs, d, max_bps, payload = pool
    s = q.shape[0]
    dev = q.device
    from ._build import library
    lib = library('paged_attention')
    out = torch.empty_like(q)
    err = lib.paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        None if k_scales is None else k_scales.data_ptr(),
        None if v_scales is None else v_scales.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        s, h, d, nb, bs, max_bps, payload, float(sm_scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _check_status(lib, err, 'paged_decode_attention')
    paged_attention.launches += 1
    return out


@register_op('paged_attention')
def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    k_scales=None, v_scales=None, *, sm_scale=1.0,
                    pages_per_compute_block=4):
    """Decode attention over the paged KV pool.

    - ``q``: (S, H, D) f32, one query row per decode slot; or (S, H, K, D),
      the verify read of speculative decoding, where row j of a slot attends
      ``context_lens + j`` keys (the slot's K fed tokens, causally).
    - ``k_pages`` / ``v_pages``: (H, NB, BS, D) f32, bf16 or int8; block 0
      is scratch.
    - ``block_tables``: (S, max_bps) int32, each slot's blocks in order,
      padded with the scratch block.
    - ``context_lens``: (S,) int32, keys to attend per slot (row 0's),
      including the token written this step; inactive slots pass 1 and read
      scratch.
    - ``k_scales`` / ``v_scales``: (H, NB, BS) f32 row scales, given for an
      int8 pool and only then.
    - ``pages_per_compute_block``: the TPU kernel's tiling knob, checked
      and otherwise unused (the kernel here splits the context itself).

    Returns (S, H, D) or (S, H, K, D) f32. CUDA tensors launch the
    hand-written kernel once (split-context: each CTA takes 64-key ranges
    of one slot and head, and the CTAs of a slot and head, one thread-block
    cluster, merge their ranges in a fixed order; quantized rows are
    dequantized as they are loaded; the verify read goes through it as
    :func:`verify_rows` flattens it), CPU tensors run
    :func:`paged_attention_ref`.
    """
    _check_scales(k_pages, k_scales, v_scales)
    if (not isinstance(pages_per_compute_block, numbers.Integral)
            or isinstance(pages_per_compute_block, bool)
            or pages_per_compute_block < 1):
        raise ValueError(f'pages_per_compute_block must be a positive int, '
                         f'got {pages_per_compute_block!r}')
    if q.dim() not in (3, 4):
        raise ValueError(f'q must be (S, H, D) or (S, H, K, D), got '
                         f'{tuple(q.shape)}')
    if q.device.type == 'cpu':
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   context_lens, k_scales, v_scales,
                                   sm_scale=sm_scale)
    if q.device.type != 'cuda':
        raise ValueError(f'unsupported device {q.device}')
    dev = q.device
    pool = _check_pool(k_pages, v_pages, block_tables, dev)
    h, _, bs, d, max_bps, _ = pool
    s = q.shape[0]
    if (q.dtype != torch.float32 or (q.dim() == 3 and not q.is_contiguous())
            or (q.shape[1], q.shape[-1]) != (h, d)
            or block_tables.shape[0] != s):
        raise ValueError(f'q must be a contiguous (S, H, D) or an '
                         f'(S, H, K, D) f32 tensor matching the pool (H={h}, '
                         f'D={d}) and block_tables '
                         f'{tuple(block_tables.shape)}, got {q.dtype} '
                         f'{tuple(q.shape)}')
    if (context_lens.device != dev or context_lens.dtype != torch.int32
            or tuple(context_lens.shape) != (s,)
            or not context_lens.is_contiguous()):
        raise ValueError(f'context_lens must be a contiguous ({s},) int32 '
                         f'tensor on {dev}')
    if q.dim() == 3:
        return _launch_decode(q, k_pages, v_pages, k_scales, v_scales,
                              block_tables, context_lens, pool, sm_scale)
    kq = q.shape[2]
    rows, tables, contexts = verify_rows(q, block_tables, context_lens,
                                         max_bps * bs)
    out = _launch_decode(rows, k_pages, v_pages, k_scales, v_scales, tables,
                         contexts, pool, sm_scale)
    return out.reshape(s, kq, h, d).transpose(1, 2)


@register_op('paged_prefill_attention')
def paged_prefill_attention(q, k, v, k_pages, v_pages, block_tables,
                            k_scales=None, v_scales=None, *, sm_scale=1.0):
    """Prefill attention for the decode engine: causal attention of the
    bucket-padded prompt's ``q`` (B, H, Lq, D) f32 over the paged K/V view
    (the caller has already written the prompt's K/V into its blocks).
    ``k`` and ``v`` are the prompt's own (B, H, Lq, D) projections, which
    the reference hands only to its TPU kernel: they are checked for shape
    and not read. ``block_tables`` is (B, max_bps) int32 with
    Lq <= max_bps * BS; the pool is f32, bf16 or int8, and
    ``k_scales`` / ``v_scales`` (H, NB, BS) f32 are given for an int8 pool
    and only then. Row r attends keys 0..r; rows past the real prompt are
    finite garbage, never read. CUDA tensors launch the hand-written kernel
    (key-split: the warps of a CTA share a 16-row query tile's causal keys
    and merge once; quantized rows are dequantized as they are loaded),
    CPU tensors run :func:`paged_prefill_attention_ref`."""
    _check_scales(k_pages, k_scales, v_scales)
    for name, t in (('k', k), ('v', v)):
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f'{name} {tuple(t.shape)} must have q\'s shape '
                             f'{tuple(q.shape)}')
    if q.device.type == 'cpu':
        return paged_prefill_attention_ref(q, k_pages, v_pages, block_tables,
                                           k_scales, v_scales,
                                           sm_scale=sm_scale)
    if q.device.type != 'cuda':
        raise ValueError(f'unsupported device {q.device}')
    dev = q.device
    h, nb, bs, d, max_bps, payload = _check_pool(k_pages, v_pages,
                                                 block_tables, dev)
    if q.dtype != torch.float32 or not q.is_contiguous() or q.dim() != 4:
        raise ValueError(f'q must be a contiguous (B, H, Lq, D) f32 tensor, '
                         f'got {q.dtype} {tuple(q.shape)}')
    b, _, lq, _ = q.shape
    if tuple(q.shape) != (b, h, lq, d) or block_tables.shape[0] != b:
        raise ValueError(f'q {tuple(q.shape)} does not match the pool '
                         f'(H={h}, D={d}) or block_tables '
                         f'{tuple(block_tables.shape)}')
    if not 1 <= lq <= max_bps * bs:
        raise ValueError(f'Lq={lq} must be in [1, max_bps * BS = '
                         f'{max_bps * bs}]')
    from ._build import library
    lib = library('paged_attention')
    out = torch.empty_like(q)
    err = lib.paged_prefill_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        None if k_scales is None else k_scales.data_ptr(),
        None if v_scales is None else v_scales.data_ptr(),
        block_tables.data_ptr(), out.data_ptr(), b, h, lq, d, nb, bs,
        max_bps, payload, float(sm_scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _check_status(lib, err, 'paged_prefill_attention')
    paged_prefill_attention.launches += 1
    return out


# ---------------------------------------------------------------------------
# fused (flash) attention: the training path
# ---------------------------------------------------------------------------

def fused_attention_ref(q, k, v, bias=None, *, sm_scale=1.0, causal=False):
    """Plain version of :func:`fused_attention`: a line-for-line port of the
    JAX op's XLA formulation, ``softmax(Q.K^T * sm_scale + bias).V`` over
    (B, H, S, D), with ``causal`` the top-left ``tril`` filled with
    ``finfo.min``. Types promote as in JAX (a bf16 ``q`` with an f32 bias
    gives f32)."""
    scores = torch.einsum('bhqd,bhkd->bhqk', q, k) * sm_scale
    if bias is not None:
        scores = scores + bias
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.tril(torch.ones((s_q, s_k), dtype=torch.bool,
                                     device=scores.device))
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum('bhqk,bhkd->bhqd', probs, v.to(probs.dtype))


def _causal_keep(s):
    """The top-left ``tril`` over the last two dims of ``s``."""
    return torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()


def _scores_f32(q, k, bias, sm_scale, causal):
    """The kernels' scores in f32: ``Q.K^T * sm_scale + bias``, with the
    keys the causal mask drops at ``finfo.min``, as the JAX op fills them.
    They weigh nothing unless every attended key of the row scores
    ``finfo.min`` too (a mask bias over the whole row); then all the row's
    scores tie and the softmax weighs every key alike, as there."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        s = s.masked_fill(~_causal_keep(s), torch.finfo(torch.float32).min)
    return s


def fused_attention_fwd_ref(q, k, v, bias=None, *, sm_scale=1.0,
                            causal=False):
    """Plain version of the forward kernel: ``(O, stats)``, O in ``q``'s
    type, every sum in f32. ``stats`` (2, B, H, Sq) f32 holds each row's
    max score m and log l, l = sum exp(S - m): the backward recomputes
    ``P = exp((S - m) - log l)``. (One log-sum-exp m + log l would lose
    log l where a ``finfo.min`` bias masks every key of a row: the sum
    rounds back to m.)"""
    s = _scores_f32(q, k, bias, sm_scale, causal)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1)
    o = torch.matmul(e, v.float()) / l[..., None]
    return o.to(q.dtype), torch.stack((m, torch.log(l)))


def _row_dot(o, do):
    """``di = rowsum(O . dO)`` in f32, (B, H, Sq): computed in torch between
    the forward and the backward kernels, as the stock TPU code computes it
    outside its Pallas calls."""
    return (o.float() * do.float()).sum(-1)


def _bwd_from_di(q, k, v, bias, stats, di, do, sm_scale, causal):
    s = _scores_f32(q, k, bias, sm_scale, causal)
    m, log_l = stats
    p = torch.exp((s - m[..., None]) - log_l[..., None])
    dof = do.float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, v.float().transpose(-1, -2)) - di[..., None])
    if causal:      # the mask's where passes a dropped score no gradient
        ds = ds.masked_fill(~_causal_keep(ds), 0.0)
    dq = torch.matmul(ds, k.float()) * sm_scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds


def fused_attention_bwd_ref(q, k, v, bias, o, stats, do, *, sm_scale=1.0,
                            causal=False):
    """Plain version of the backward kernels, from the forward's saved row
    statistics: recompute ``P = exp((S - m) - log l)``, then
    ``dV = P^T.dO``, ``dS = P o (dO.V^T - rowsum(O . dO))`` (0 where the
    causal mask drops a key), ``dQ = dS.K * sm_scale``,
    ``dK = dS^T.Q * sm_scale``. Returns ``(dq, dk, dv, ds)``; ``ds`` is the
    full (B, H, Sq, Sk) f32 score gradient, the bias's gradient before it is
    summed to the bias's shape."""
    return _bwd_from_di(q, k, v, bias, stats, _row_dot(o, do), do, sm_scale,
                        causal)


class _FlashParams(ctypes.Structure):
    """Mirror of ``struct FlashParams`` in csrc/flash_attention.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ('q', 'k', 'v', 'd_o', 'bias', 'row_max', 'row_log_l', 'di',
                  'o', 'dq', 'dk', 'dv', 'ds')]
                + [(n, ctypes.c_longlong * 3) for n in
                   ('q_str', 'k_str', 'v_str', 'do_str')]
                + [('bias_str', ctypes.c_longlong * 4)]
                + [(n, ctypes.c_int) for n in
                   ('B', 'H', 'Sq', 'Sk', 'D', 'causal', 'bf16')]
                + [('sm_scale', ctypes.c_float)])


def _rows_readable(t):
    """``t`` itself when the kernels can read its rows in 16-byte chunks
    (unit stride on D, 16-byte aligned, strides a multiple of 8 elements),
    else a contiguous copy. The head-split views of the projections
    qualify, so the main path copies nothing."""
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(st % 8 for st in t.stride()[:-1])):
        return t.contiguous()
    return t


def _flash_inputs(q, k, v, bias, do=None):
    """Validate a launch and put its operands in the kernels' layout;
    returns (q, k, v, bias as f32 expanded to (B, H, Sq, Sk) or None, do)."""
    if q.device.type != 'cuda':
        raise ValueError(f'the flash-attention kernels run on CUDA tensors, '
                         f'got {q.device}; fused_attention runs the plain '
                         f'version on the CPU')
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'q must be f32 or bf16, got {q.dtype}')
    named = (('k', k), ('v', v)) + ((('do', do),) if do is not None else ())
    for name, t in named:
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, expected {dev}')
        if t.dtype != q.dtype:
            raise TypeError(f'{name} is {t.dtype}, q is {q.dtype}')
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f'q, k, v must be (B, H, S, D) with k and v alike, '
                         f'got {tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d):
        raise ValueError(f'k {tuple(k.shape)} does not match q '
                         f'{tuple(q.shape)}')
    if d not in HEAD_DIMS:
        raise ValueError(f'head_dim {d} unsupported: the kernels are built '
                         f'for {HEAD_DIMS}')
    if min(b, h, sq, sk) < 1 or max(b, h) > 65535:
        raise ValueError(f'B={b}, H={h}, Sq={sq}, Sk={sk} out of the '
                         f'kernels\' range')
    if do is not None and tuple(do.shape) != tuple(q.shape):
        raise ValueError(f'do {tuple(do.shape)} != q {tuple(q.shape)}')
    if bias is not None:
        if bias.device != dev:
            raise ValueError(f'bias is on {bias.device}, expected {dev}')
        if bias.dim() > 4:
            raise ValueError(f'bias must broadcast to (B, H, Sq, Sk), got '
                             f'{tuple(bias.shape)}')
        try:
            bias = bias.to(torch.float32).expand(b, h, sq, sk)
        except RuntimeError as e:
            raise ValueError(f'bias {tuple(bias.shape)} does not broadcast '
                             f'to {(b, h, sq, sk)}') from e
    q, k, v = _rows_readable(q), _rows_readable(k), _rows_readable(v)
    if do is not None:
        do = _rows_readable(do)
    return q, k, v, bias, do


def _flash_params(q, k, v, bias, sm_scale, causal, do=None):
    b, h, sq, d = q.shape
    p = _FlashParams()
    p.q, p.k, p.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    p.q_str = (ctypes.c_longlong * 3)(*q.stride()[:3])
    p.k_str = (ctypes.c_longlong * 3)(*k.stride()[:3])
    p.v_str = (ctypes.c_longlong * 3)(*v.stride()[:3])
    if do is not None:
        p.d_o = do.data_ptr()
        p.do_str = (ctypes.c_longlong * 3)(*do.stride()[:3])
    if bias is not None:
        p.bias = bias.data_ptr()
        p.bias_str = (ctypes.c_longlong * 4)(*bias.stride())
    p.B, p.H, p.Sq, p.Sk, p.D = b, h, sq, k.shape[2], d
    p.causal = int(bool(causal))
    p.bf16 = int(q.dtype == torch.bfloat16)
    p.sm_scale = float(sm_scale)
    return p


def _flash_launch(fn, params, dev):
    from ._build import library
    lib = library('flash_attention')
    if lib.flash_attention_params_size() != ctypes.sizeof(_FlashParams):
        raise RuntimeError('FlashParams layout differs between '
                           'csrc/flash_attention.cu and ops/nn_ops.py')
    err = getattr(lib, fn)(ctypes.addressof(params),
                           torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f'{fn} kernel launch failed: CUDA error {err} '
                           f'({msg})')


FLASH_KINDS = ('flash_attention_fwd', 'flash_attention_bwd_dkv',
               'flash_attention_bwd_dq')


def flash_kernel_info(kind, head_dim, dtype):
    """What the flash body for ``kind`` (one of :data:`FLASH_KINDS`) at
    ``head_dim`` in ``dtype`` was built with, read from the loaded library
    on the current card: ``{'registers', 'spill_bytes', 'static_smem',
    'dynamic_smem', 'ctas_per_sm', 'threads'}`` (``spill_bytes``: the local
    memory a thread uses)."""
    from ._build import kernel_info
    if (kind not in FLASH_KINDS or head_dim not in HEAD_DIMS
            or dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f'no flash body for {kind}, head_dim {head_dim}, '
                         f'{dtype}')
    return kernel_info('flash_attention', 'flash_attention_kernel_info',
                       FLASH_KINDS.index(kind), head_dim,
                       int(dtype == torch.bfloat16))


def _bwd_state(stats, di, q):
    b, h, sq, _ = q.shape
    for name, t, shape in (('stats', stats, (2, b, h, sq)),
                           ('di', di, (b, h, sq))):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f'{name} must be a contiguous {shape} f32 '
                             f'tensor on {q.device}')


def _set_stats(p, stats):
    p.row_max, p.row_log_l = stats[0].data_ptr(), stats[1].data_ptr()


def flash_attention_fwd(q, k, v, bias=None, *, sm_scale=1.0, causal=False):
    """Launch the forward kernel (K3) on CUDA tensors: ``(O, stats)``, O
    contiguous in ``q``'s type, ``stats`` (2, B, H, Sq) f32, each row's max
    score and log of its sum of exponentials (see
    :func:`fused_attention_fwd_ref`, the plain version). Raises on what the
    kernel does not take."""
    q, k, v, bias, _ = _flash_inputs(q, k, v, bias)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stats = torch.empty((2,) + q.shape[:3], dtype=torch.float32,
                        device=q.device)
    p = _flash_params(q, k, v, bias, sm_scale, causal)
    p.o = o.data_ptr()
    _set_stats(p, stats)
    _flash_launch('flash_attention_fwd', p, q.device)
    flash_attention_fwd.launches += 1
    return o, stats


def flash_attention_bwd_dkv(q, k, v, bias, stats, di, do, *, sm_scale=1.0,
                            causal=False):
    """Launch the dK/dV backward kernel (K3b) on CUDA tensors: ``(dk, dv)``
    contiguous in ``k``'s type. ``stats`` is the forward's, ``di`` is
    ``rowsum(O . dO)`` in f32."""
    q, k, v, bias, do = _flash_inputs(q, k, v, bias, do)
    _bwd_state(stats, di, q)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    p = _flash_params(q, k, v, bias, sm_scale, causal, do)
    _set_stats(p, stats)
    p.di = di.data_ptr()
    p.dk, p.dv = dk.data_ptr(), dv.data_ptr()
    _flash_launch('flash_attention_bwd_dkv', p, q.device)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, bias, stats, di, do, *, sm_scale=1.0,
                           causal=False, need_ds=False):
    """Launch the dQ backward kernel (K3b-dq) on CUDA tensors:
    ``(dq, ds)``, dq contiguous in ``q``'s type; ``ds`` is the
    (B, H, Sq, Sk) f32 score gradient when ``need_ds`` (the bias's
    gradient), else None."""
    q, k, v, bias, do = _flash_inputs(q, k, v, bias, do)
    _bwd_state(stats, di, q)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ds = None
    if need_ds:
        ds = torch.zeros(q.shape[:3] + (k.shape[2],), dtype=torch.float32,
                         device=q.device)
    p = _flash_params(q, k, v, bias, sm_scale, causal, do)
    _set_stats(p, stats)
    p.di, p.dq = di.data_ptr(), dq.data_ptr()
    if ds is not None:
        p.ds = ds.data_ptr()
    _flash_launch('flash_attention_bwd_dq', p, q.device)
    flash_attention_bwd_dq.launches += 1
    return dq, ds


def _sum_to(g, shape):
    """Sum a broadcast gradient back to ``shape``."""
    lead = g.dim() - len(shape)
    if lead > 0:
        g = g.sum(dim=tuple(range(lead)))
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    if dims:
        g = g.sum(dim=dims, keepdim=True)
    return g.reshape(shape)


class _FusedAttention(torch.autograd.Function):
    """Forward K3, backward K3b-dkv then K3b-dq on CUDA tensors; the plain
    versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale, causal):
        if q.device.type == 'cpu':
            o, stats = fused_attention_fwd_ref(q, k, v, bias,
                                               sm_scale=sm_scale,
                                               causal=causal)
        else:
            o, stats = flash_attention_fwd(q, k, v, bias, sm_scale=sm_scale,
                                           causal=causal)
        ctx.save_for_backward(q, k, v, bias, o, stats)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, stats = ctx.saved_tensors
        kw = {'sm_scale': ctx.sm_scale, 'causal': ctx.causal}
        need_ds = bias is not None and ctx.needs_input_grad[3]
        if do.device.type == 'cpu':
            dq, dk, dv, ds = fused_attention_bwd_ref(q, k, v, bias, o, stats,
                                                     do, **kw)
        else:
            di = _row_dot(o, do)
            dk, dv = flash_attention_bwd_dkv(q, k, v, bias, stats, di, do,
                                             **kw)
            dq, ds = flash_attention_bwd_dq(q, k, v, bias, stats, di, do,
                                            need_ds=need_ds, **kw)
        dbias = _sum_to(ds, bias.shape).to(bias.dtype) if need_ds else None
        return dq, dk, dv, dbias, None, None


@register_op('fused_attention')
def fused_attention(q, k, v, bias=None, *, sm_scale=1.0, causal=False):
    """Fused multi-head attention, (B, H, S, D) layout:
    ``softmax(Q.K^T * sm_scale + bias).V``, optionally causal (top-left
    ``tril``: row i attends keys j <= i), differentiable in q, k, v and
    bias.

    - ``q`` (B, H, Sq, D), ``k``/``v`` (B, H, Sk, D): f32 or bf16, one type;
      the output has that type. Sums are f32.
    - ``bias``: anything that broadcasts to (B, H, Sq, Sk), read as f32 in
      place through broadcast strides.

    CUDA tensors run the hand-written flash kernels (forward, then dK/dV and
    dQ in the backward) or raise; CPU tensors run
    :func:`fused_attention_fwd_ref` and :func:`fused_attention_bwd_ref`."""
    if q.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {q.device}')
    return _FusedAttention.apply(q, k, v, bias, float(sm_scale),
                                 bool(causal))


def _pair(v, n=2):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def _match_weight_dtype(x, w):
    """The reference's AMP rule: a floating activation meeting a floating
    weight of another type is cast to the WEIGHT's type (a bf16 weight
    makes an f32 feed bf16). This is not type promotion."""
    if (x.is_floating_point() and w.is_floating_point()
            and x.dtype != w.dtype):
        return x.to(w.dtype)
    return x


def _nchw(x, data_format):
    """An NHWC tensor as its NCHW view (channels_last when ``x`` is
    contiguous, so torch's convolutions and pools run NHWC kernels and
    nothing is copied); an NCHW tensor as it is."""
    if data_format == 'NCHW':
        return x
    if data_format != 'NHWC':
        raise ValueError(f'data_format must be NCHW or NHWC, got '
                         f'{data_format!r}')
    return x.permute(0, 3, 1, 2)


def _from_nchw(y, data_format):
    return y if data_format == 'NCHW' else y.permute(0, 2, 3, 1)


def _same_pads(size, k, s, d):
    """XLA's SAME padding of one spatial axis: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


@register_op('conv2d')
def conv2d(x, weight, *, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCHW'):
    """Paddle's conv2d: ``x`` NCHW or NHWC, ``weight`` OIHW whatever the
    data format (torch's layout; the reference's NHWC weights are HWIO,
    and convert.py transposes them). ``padding``: an int, a pair, four
    values (top, bottom, left, right) or ``'SAME'``/``'VALID'`` as XLA
    reads them. ``x`` takes the weight's type (:func:`_match_weight_dtype`).
    Runs ``F.conv2d``: the reference computes the convolution in XLA,
    outside any Pallas kernel."""
    x = _match_weight_dtype(x, weight)
    stride, dilation = _pair(stride), _pair(dilation)
    xc = _nchw(x, data_format)
    kh, kw = weight.shape[2:]
    if isinstance(padding, str):
        if padding.upper() == 'VALID':
            pads = (0, 0, 0, 0)
        elif padding.upper() == 'SAME':
            pads = (_same_pads(xc.shape[2], kh, stride[0], dilation[0])
                    + _same_pads(xc.shape[3], kw, stride[1], dilation[1]))
        else:
            raise ValueError(f'padding {padding!r}: use SAME or VALID')
    else:
        p = _pair(padding)
        pads = (p[0], p[0], p[1], p[1]) if len(p) == 2 else tuple(p)
    top, bottom, left, right = pads
    if top == bottom and left == right:
        pad = (top, left)
    else:
        xc = F.pad(xc, (left, right, top, bottom))
        pad = 0
    y = F.conv2d(xc, weight, None, stride, pad, dilation, groups)
    return _from_nchw(y, data_format)


@register_op('pool2d')
def pool2d(x, *, pool_size=-1, pool_type='max', pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, data_format='NCHW'):
    """Paddle's pool2d, as the reference computes it: max pooling pads with
    -inf; average pooling sums the window and divides by the count of
    input elements in it (``exclusive``) or by the window's size;
    ``ceil_mode`` pads the high side so the last partial window is kept;
    ``global_pooling`` pools each whole feature map. Runs torch's pools,
    NHWC through a channels_last view."""
    if pool_type not in ('max', 'avg'):
        raise ValueError(f'pool_type must be max or avg, got {pool_type!r}')
    xc = _nchw(x, data_format)
    if global_pooling:
        ksize, stride, pad = tuple(xc.shape[2:]), tuple(xc.shape[2:]), (0, 0)
    else:
        ksize = _pair(pool_size)
        stride = _pair(pool_stride if pool_stride is not None else ksize)
        pad = _pair(pool_padding)
    extra = [0, 0]
    if ceil_mode:
        for i in range(2):
            rem = (xc.shape[2 + i] + 2 * pad[i] - ksize[i]) % stride[i]
            extra[i] = stride[i] - rem if rem else 0
    # (left, right, top, bottom) for F.pad
    pads = (pad[1], pad[1] + extra[1], pad[0], pad[0] + extra[0])
    if pool_type == 'max':
        if any(extra) or pad[0] > ksize[0] // 2 or pad[1] > ksize[1] // 2:
            # beyond what max_pool2d's own (-inf) padding can express
            xc, pad = F.pad(xc, pads, value=-math.inf), (0, 0)
        y = F.max_pool2d(xc, ksize, stride, pad)
    else:
        padded = F.pad(xc, pads) if any(pads) else xc
        y = F.avg_pool2d(padded, ksize, stride, divisor_override=1)
        if exclusive:
            ones = F.pad(torch.ones((1, 1) + tuple(xc.shape[2:]),
                                    dtype=xc.dtype, device=xc.device), pads)
            y = y / F.avg_pool2d(ones, ksize, stride, divisor_override=1)
        else:
            y = y / math.prod(ksize)
    return _from_nchw(y, data_format)


def _synced():
    from ..parallel.collective import group_size
    return group_size() > 1


class _RankMean(torch.autograd.Function):
    """The mean over the ranks of the process group, whose gradient is
    the mean over the ranks of the incoming gradients."""

    @staticmethod
    def forward(ctx, x):
        from ..parallel.collective import allreduce_mean
        return allreduce_mean(x)

    @staticmethod
    def backward(ctx, g):
        from ..parallel.collective import allreduce_mean
        return allreduce_mean(g.contiguous())


@register_op('batch_norm',
             outputs=['Y', 'MeanOut', 'VarianceOut'])
def batch_norm(x, scale, bias, mean, variance, *, momentum=0.9,
               epsilon=1e-5, is_test=False, use_global_stats=False,
               data_layout='NCHW', sync_stats=False):
    """Paddle's batch_norm: returns ``(y, new_mean, new_var)``.

    In training the statistics are the batch mean and the BIASED batch
    variance over every axis but the channel's, in f32 (in f64 for an f64
    ``x``), and the running ones move as ``momentum * running + (1 -
    momentum) * batch`` (Paddle's rule, the mirror of torch's
    ``momentum``; ``F.batch_norm`` would also update with the unbiased
    variance). ``new_mean``/``new_var`` carry no gradient.
    With ``is_test`` or ``use_global_stats`` the running statistics
    normalise and come back unchanged.

    ``y = (x - mean) * rsqrt(var + eps) * scale + bias`` is computed in
    ``x``'s type, as the reference does: under AMP a bf16 ``x`` with bf16
    ``scale``/``bias`` gives bf16 ``y`` from f32 statistics, where torch's
    promotion of bf16 with an f32 buffer would give f32.

    ``sync_stats`` (the reference's sync_batch_norm): in a process group of
    more than one rank, each rank's mean and mean of squares (f32) are
    averaged over the ranks, and ``var = E[x^2] - mean^2``, the JAX form,
    which assumes equal shards. The average is an autograd-aware
    all-reduce (:class:`_RankMean`), so the backward of the statistics is
    averaged over the ranks too, as Paddle's sync_batch_norm reduces it.
    In a group of one, or with no group, it is the plain path, bit for
    bit."""
    if data_layout == 'NCHW' and x.dim() > 2:
        axes = (0,) + tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
    else:
        axes = tuple(range(x.dim() - 1))
        shape = (1,) * (x.dim() - 1) + (-1,)
    stat = torch.promote_types(x.dtype, torch.float32)    # f64 stays f64
    if is_test or use_global_stats:
        m, v = mean, variance
        new_mean, new_var = mean, variance
    else:
        xs = x.to(stat)
        if sync_stats and _synced():
            m, ex2 = _RankMean.apply(torch.stack(
                [xs.mean(dim=axes), (xs * xs).mean(dim=axes)])).unbind(0)
            v = ex2 - m * m
        else:
            v, m = torch.var_mean(xs, dim=axes, correction=0)
        with torch.no_grad():
            new_mean = momentum * mean + (1 - momentum) * m.to(mean.dtype)
            new_var = (momentum * variance
                       + (1 - momentum) * v.to(variance.dtype))
    inv = torch.rsqrt(v.to(stat) + epsilon).to(x.dtype)
    return ((x - m.to(x.dtype).reshape(shape)) * inv.reshape(shape)
            * scale.reshape(shape) + bias.reshape(shape)), new_mean, new_var


def _pads3(x, weight, stride, padding, dilation):
    """(x padded where needed, torch's symmetric padding) of a 3-D conv:
    an int or three values, or ``'SAME'``/``'VALID'`` as XLA reads
    them."""
    if isinstance(padding, str):
        if padding.upper() == 'VALID':
            return x, 0
        if padding.upper() != 'SAME':
            raise ValueError(f'padding {padding!r}: use SAME or VALID')
        pads = [_same_pads(x.shape[2 + i], weight.shape[2 + i], stride[i],
                           dilation[i]) for i in range(3)]
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        return F.pad(x, flat), 0
    p = _pair(padding, 3)
    if len(p) != 3:
        raise ValueError(f'conv3d padding takes one value a spatial dim, '
                         f'got {padding!r}')
    return x, p


@register_op('conv3d')
def conv3d(x, weight, *, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCDHW'):
    """Paddle's conv3d over an OIDHW ``weight``: ``x`` NCDHW, or NDHWC
    with a DHWIO weight as the reference takes it (both permuted to
    torch's layout, and the result back). ``F.conv3d``; the reference
    computes it in XLA, outside any Pallas kernel."""
    x = _match_weight_dtype(x, weight)
    stride, dilation = _pair(stride, 3), _pair(dilation, 3)
    if data_format == 'NDHWC':
        x, weight = x.permute(0, 4, 1, 2, 3), weight.permute(4, 3, 0, 1, 2)
    elif data_format != 'NCDHW':
        raise ValueError(f'data_format must be NCDHW or NDHWC, got '
                         f'{data_format!r}')
    x, pad = _pads3(x, weight, stride, padding, dilation)
    y = F.conv3d(x, weight, None, stride, pad, dilation, groups)
    return y.permute(0, 2, 3, 4, 1) if data_format == 'NDHWC' else y


def _check_output_size(y, output_size, spatial):
    """The JAX op never reads ``output_size``: one equal to the size it
    computes is accepted, any other raises (ROADMAP C.4 item 12)."""
    if output_size is None:
        return
    want = tuple(_pair(output_size, spatial))
    if want != tuple(y.shape[2:]):
        raise NotImplementedError(
            f'conv2d_transpose(output_size={list(want)}): the output is '
            f'{list(y.shape[2:])} from filter_size, stride and padding; the '
            f'reference never reads output_size, so no other size is '
            f'ported (ROADMAP C.4 item 12)')


@register_op('conv2d_transpose')
def conv2d_transpose(x, weight, *, stride=1, padding=0, dilation=1, groups=1,
                     output_size=None, data_format='NCHW'):
    """Paddle's conv2d_transpose (the gradient of conv2d) over an IOHW
    ``weight``, (C_in, C_out / groups, kh, kw), which is torch's own
    transposed layout: ``F.conv_transpose2d`` with nothing permuted. The
    output is (H - 1) * stride - 2 * padding + dilation * (k - 1) + 1 a
    side; an ``output_size`` other than that raises (ROADMAP C.4 item
    12). NCHW only: the reference's NHWC branch reads the IOHW weight as
    HWIO."""
    if data_format != 'NCHW':
        raise NotImplementedError(
            f'conv2d_transpose(data_format={data_format!r}): the reference '
            f'reads the IOHW weight as HWIO there; only NCHW is ported')
    x = _match_weight_dtype(x, weight)
    y = F.conv_transpose2d(x, weight, None, _pair(stride), _pair(padding), 0,
                           groups, _pair(dilation))
    _check_output_size(y, output_size, 2)
    return y


@register_op('conv3d_transpose')
def conv3d_transpose(x, weight, *, stride=1, padding=0, dilation=1, groups=1,
                     data_format='NCDHW'):
    """Paddle's conv3d_transpose over an IODHW ``weight``,
    ``F.conv_transpose3d``. With ``groups`` > 1 the port computes Paddle's
    grouped transposed convolution; the JAX op swaps the weight's first
    two axes only and raises (ROADMAP C.4 item 19). NCDHW only."""
    if data_format != 'NCDHW':
        raise NotImplementedError(
            f'conv3d_transpose(data_format={data_format!r}): only NCDHW is '
            f'ported, as the reference computes it')
    x = _match_weight_dtype(x, weight)
    return F.conv_transpose3d(x, weight, None, _pair(stride, 3),
                              _pair(padding, 3), 0, groups,
                              _pair(dilation, 3))


@register_op('group_norm')
def group_norm(x, scale=None, bias=None, *, groups, epsilon=1e-5,
               data_layout='NCHW'):
    """Paddle's group_norm of an NCHW(...) ``x``: each sample's channels in
    ``groups`` runs, normalised by the run's mean and biased variance (in
    ``x``'s type, as the reference), then scaled and shifted a channel.
    NHWC raises: the reference reshapes it as if it were NCHW (ROADMAP C.4
    item 17)."""
    if data_layout != 'NCHW':
        raise NotImplementedError(
            f'group_norm(data_layout={data_layout!r}): the reference '
            f'groups an NHWC input as if it were NCHW; only NCHW is ported '
            f'(ROADMAP C.4 item 17)')
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    v, m = torch.var_mean(xg, dim=axes, correction=0, keepdim=True)
    y = ((xg - m) * torch.rsqrt(v + epsilon)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


@register_op('bilinear_tensor_product')
def bilinear_tensor_product(x, y, weight, bias=None):
    """``out[b, k] = x[b]ᵀ · weight[k] · y[b] + bias[k]``, one
    ``torch.einsum``."""
    out = torch.einsum('bi,kij,bj->bk', x, weight, y)
    return out if bias is None else out + bias


@register_op('relu')
def relu(x):
    return torch.relu(x)


@register_op('softmax')
def softmax(x, *, axis=-1):
    return torch.softmax(x, dim=axis)


@register_op('log_softmax')
def log_softmax(x, *, axis=-1):
    return torch.log_softmax(x, dim=axis)


@register_op('layer_norm')
def layer_norm(x, scale=None, bias=None, *, begin_norm_axis=1, epsilon=1e-5):
    """Normalise over the dims from ``begin_norm_axis`` on, then scale and
    shift (each (prod of those dims,), or None). Statistics are f32 for a
    bf16 ``x``, as in the reference; the result is in the common type of
    ``x``, ``scale`` and ``bias`` (JAX's promotion), one fused
    ``F.layer_norm``."""
    norm_shape = tuple(x.shape[begin_norm_axis:])
    dt = x.dtype
    for t in (scale, bias):
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    x, scale, bias = (None if t is None else t.to(dt)
                      for t in (x, scale, bias))
    return F.layer_norm(
        x, norm_shape, None if scale is None else scale.reshape(norm_shape),
        None if bias is None else bias.reshape(norm_shape), epsilon)


@register_op('lookup_table')
def lookup_table(w, ids, *, padding_idx=-1, is_sparse=False,
                 is_distributed=False, _sparse_site=None):
    """Rows of ``w`` for ``ids`` (clamped into the table, as the reference
    clips them); a trailing id dim of 1 is squeezed (LoD convention), and
    rows of ``padding_idx`` (>= 0) read as zeros. ``is_sparse`` (rows-only
    gradients, ``_sparse_site``) is not ported and raises (ROADMAP A.10)."""
    if is_sparse or _sparse_site is not None:
        raise NotImplementedError('lookup_table(is_sparse=True): rows-only '
                                  'gradients (ops/sparse_ops.py) are not '
                                  'ported yet (ROADMAP A.10)')
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    out = F.embedding(ids.clamp(0, w.shape[0] - 1), w)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device), out)
    return out


@register_op('dropout', needs_rng=True)
def dropout(x, *, dropout_prob=0.5, is_test=False,
            dropout_implementation='downgrade_in_infer', key=None):
    """Paddle's dropout. In training each element is kept with
    probability ``1 - dropout_prob`` (the mask drawn from ``key``, the
    device's ``torch.Generator``), and ``upscale_in_train`` divides the
    kept ones by that probability; at test time ``downgrade_in_infer``
    scales by it instead. The masks differ from the JAX package's PRNG by
    design."""
    if is_test:
        if dropout_implementation == 'downgrade_in_infer':
            return x * (1.0 - dropout_prob)
        return x
    if dropout_prob == 0.0:
        return x
    keep = torch.rand(x.shape, generator=key, device=x.device) \
        < (1.0 - dropout_prob)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if dropout_implementation == 'upscale_in_train':
        return torch.where(keep, x / (1.0 - dropout_prob), zero).to(x.dtype)
    return torch.where(keep, x, zero)


paged_attention.launches = 0
paged_prefill_attention.launches = 0
flash_attention_fwd.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0
_KERNEL_WRAPPERS = (paged_attention, paged_prefill_attention,
                    flash_attention_fwd, flash_attention_bwd_dkv,
                    flash_attention_bwd_dq)


def _kernel_wrappers():
    # K4's wrapper lives in pallas_conv.py, which imports this module
    from .pallas_conv import conv1x1_bn_act
    return _KERNEL_WRAPPERS + (conv1x1_bn_act,)


def launch_counts():
    """{wrapper name: kernel launches since the last reset}."""
    return {f.__name__: f.launches for f in _kernel_wrappers()}


def reset_launch_counts():
    """Every kernel's launch count to 0, K4's count of its wgmma body's
    launches too."""
    for f in _kernel_wrappers():
        f.launches = 0
    from .pallas_conv import conv1x1_bn_act
    conv1x1_bn_act.launches_wgmma = 0
