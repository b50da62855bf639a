#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. It exits non-zero, printing no result, when there is no card or no
``paddle_tpu_torch`` package beside it. No phase catches an exception.

Phases:

1. device: the card's name, the device count, and ``nvidia-smi``'s name and
   power limit (every time below stands beside them);
2. build: every source under ``paddle_tpu_torch/csrc/`` (the paged-attention
   and the flash-attention kernels), one ``nvcc`` each for ``sm_90a``, all
   started together (seconds and ``-Xptxas -v`` lines printed);
3. kernels against their plain PyTorch versions at the decode-serving
   path's shapes (8 slots, 8 heads, head_dim 64, block 16, 256-block pool,
   24 blocks per sequence), each launch synchronised and compared; then
   the device time (torch.profiler) of the kernel, the plain version and
   one PyTorch library call (``scaled_dot_product_attention``, timed only,
   never called by the port), CUDA-event times of the same calls back to
   back, and the least time the card could take (bytes over 3.35 TB/s or
   f32 operations over 67 TFLOP/s, whichever is larger);
3b. the flash-attention kernels (forward K3, backward K3b-dkv and K3b-dq)
   against their plain versions: at BERT-base's training shapes (B 128,
   H 12, S 128, D 64) in bf16 (the path's type) and f32 with no bias, in
   bf16 with a (B, 1, 1, S) mask bias that takes a gradient (so dS is
   written), and at TransformerLM's causal shape (B 8, H 8, S 512, D 64,
   f32); each chain of launches synchronised and compared, max |diff|
   printed beside its tolerance; then device times of each kernel, the
   plain version and the library yardstick
   (``scaled_dot_product_attention`` forward, and its autograd backward
   for K3b; timed only, never called by the port) beside the bound (bytes
   over 3.35 TB/s, or operations over 989 TFLOP/s bf16 or 67 TFLOP/s f32);
4. served path: ``TransformerLM(CausalLMConfig())`` at full width from a
   seed, behind the replica stack's ``ServingServer`` on port 0 (8 slots,
   prompts up to 256, up to 128 new tokens); 16 concurrent ``/generate``
   requests (half streamed), each finishing with its full budget; two
   streams held against the uncached ``greedy_generate`` under teacher
   forcing; the kernels' launch counts equal to decode steps x layers and
   prefills x layers; tokens/s, decode-step p50, prefill ms by rung and
   peak device memory; then a profiled window of decode steps with every
   slot active: host ms per step, device busy ms and idle share, and the
   kernels that take the time;
5. training: ``BertForPretraining`` at BERT-base width and full depth (110 M
   parameters, ``use_fused_attention=True``, dropouts 0, 128 positions)
   from ``bert_init_params(cfg, seed)``, the batch ``bench.py`` makes (128
   sequences of 128, 15% MLM labels); the f32 loss through the fused model
   against a second instance with ``use_fused_attention=False`` (relative
   1e-4); then ``TrainStep(amp_dtype=torch.bfloat16)`` with ``Adam(1e-4)``:
   2 warm-up and 20 timed steps, each synchronised; every loss finite and
   the last below the first; seq/s, step p50, peak device memory and the
   model-FLOP share (``bench.py``'s count over 989 TFLOP/s); each flash
   kernel launched exactly 12 x the steps run; one profiled step: device
   busy ms, idle share, the top kernels and the flash kernels' share;
6. a ``{"kernels": [...]}`` line (all five kernels) and, last,
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16 dense on the tensor cores
ATOL, RTOL = 2e-5, 1e-5         # f32, sums in another order
# flash kernels against their plain versions, (atol, rtol): f32 as above
# for O and the log-sum-exp, 1e-4 for gradients (sums of up to S * D f32
# products in another order); bf16 output of both is one rounding of an
# f32 sum (the kernels carry P and dS as two bf16 terms, about 16 bits),
# so they differ by about one bf16 ulp (at most 2**-7 relative)
FLASH_TOL = {'f32': {'o': (ATOL, RTOL), 'grad': (1e-4, 1e-4)},
             'bf16': {'o': (1e-3, 8e-3), 'grad': (1e-3, 8e-3)}}
NEAR_TIE = 1e-3                 # served token's logit vs its row's max
TIMED_LAUNCHES = 200

# kernel shapes of the decode-serving path (replica ENGINE_DEFAULTS)
S, H, D, BS, NB, MAX_BPS = 8, 8, 64, 16, 256, 24
PREFILL_RUNGS = (1, 16, 64, 256)
# flash kernel shapes: BERT-base training (bench.py bench_bert) and the
# causal TransformerLM (CausalLMConfig(): 8 heads of 64, 512 positions)
BERT_SHAPE = (128, 12, 128, 64)
LM_SHAPE = (8, 8, 512, 64)
TRAIN_STEPS, WARMUP_STEPS = 20, 2


def log(*parts):
    print(*parts, flush=True)


def device_us(prof):
    """Device time in microseconds of everything a profiler recorded
    (kernels, copies, fills), summed over all events."""
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, 'self_device_time_total',
                         getattr(e, 'self_cuda_time_total', 0.0))
    return total


def profiled(run):
    """A torch.profiler trace (device activity only) of one call of
    ``run``, after an identical warm-up call inside the profiler, so that
    the tracer's start-up does not drop the first events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) \
            as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    return prof


def timed(fn, iters=TIMED_LAUNCHES, warmup=10):
    """(device ms per call, event ms per call) of ``fn``.

    Device ms: the kernels' own time per call, summed by torch.profiler
    (CUPTI) over ``iters`` calls, without the host's launch gaps; None when
    the profiler recorded no device time. Event ms: CUDA events around
    ``iters`` back-to-back calls, which for calls shorter than their host
    overhead measures the host's launch rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / iters
    dev = device_us(profiled(lambda: [fn() for _ in range(iters)]))
    return (dev / 1e3 / iters if dev > 0 else None), event_ms


def times(kernel, plain, library):
    """The three timings of one comparison, device time where the
    profiler saw it, else CUDA events (``timing`` says which)."""
    return times_of(timed(kernel), timed(plain), timed(library))


def times_of(kernel, plain, library):
    """:func:`times` from three :func:`timed` results."""
    (k, ke), (p, pe), (lib, libe) = kernel, plain, library
    if None in (k, p, lib):
        return {'ms': ke, 'plain_ms': pe, 'library_ms': libe,
                'timing': 'cuda events, back to back'}
    return {'ms': k, 'plain_ms': p, 'library_ms': lib,
            'timing': 'profiler device time', 'event_ms': ke,
            'plain_event_ms': pe, 'library_event_ms': libe}


def bound_ms(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def fmt_times(t):
    line = (f'kernel {t["ms"]:.5f} ms plain {t["plain_ms"]:.5f} ms sdpa '
            f'{t["library_ms"]:.5f} ms bound {t["bound_ms"]:.5f} ms '
            f'({t["bound_by"]}); {t["timing"]}')
    if 'event_ms' in t:
        line += (f'; back-to-back events: kernel {t["event_ms"]:.5f} plain '
                 f'{t["plain_event_ms"]:.5f} sdpa '
                 f'{t["library_event_ms"]:.5f} ms')
    return line


def compare(name, got, want, atol=ATOL, rtol=RTOL):
    import torch
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name}: non-finite kernel output')
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = atol + rtol * want.abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f'{name}: max |diff| {err.max().item():.3e} '
                             f'beyond atol {atol} + rtol {rtol}')
    return err.max().item()


def make_pool(rng, dev):
    """A pool full of non-zero data: every free block holds stale rows."""
    import torch
    k = torch.from_numpy(rng.standard_normal((H, NB, BS, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((H, NB, BS, D), np.float32))
    return k.to(dev), v.to(dev)


def make_tables(rng, contexts):
    """Distinct random blocks per sequence, scratch-padded; a context of
    None is an inactive slot (all scratch, context 1)."""
    free = list(rng.permutation(np.arange(1, NB)))
    tables, ctx = np.zeros((len(contexts), MAX_BPS), np.int32), []
    for i, c in enumerate(contexts):
        if c is None:
            ctx.append(1)
            continue
        nb = -(-c // BS)
        tables[i, :nb] = [free.pop() for _ in range(nb)]
        ctx.append(c)
    return tables, np.asarray(ctx, np.int32)


def check_decode_kernel(rng, dev):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import nn_ops
    contexts = [1, 17, 384, 100, None, 250, 33, 64]
    k_pages, v_pages = make_pool(rng, dev)
    tables, ctx = make_tables(rng, contexts)
    bt = torch.from_numpy(tables).to(dev)
    cl = torch.from_numpy(ctx).to(dev)
    q = torch.from_numpy(rng.standard_normal((S, H, D), np.float32)).to(dev)
    scale = 1.0 / np.sqrt(D)
    got = nn_ops.paged_attention(q, k_pages, v_pages, bt, cl, sm_scale=scale)
    want = nn_ops.paged_attention_ref(q, k_pages, v_pages, bt, cl,
                                      sm_scale=scale)
    err = compare('paged_decode_attention', got, want)

    # yardstick: one library call on the pre-gathered dense view
    kd = nn_ops._gather_pages(k_pages, bt, S, H, D)
    vd = nn_ops._gather_pages(v_pages, bt, S, H, D)
    mask = (torch.arange(MAX_BPS * BS, device=dev)[None, None, None, :]
            < cl[:, None, None, None])
    tm = times(lambda: nn_ops.paged_attention(
                   q, k_pages, v_pages, bt, cl, sm_scale=scale),
               lambda: nn_ops.paged_attention_ref(
                   q, k_pages, v_pages, bt, cl, sm_scale=scale),
               lambda: F.scaled_dot_product_attention(
                   q[:, :, None, :], kd, vd, attn_mask=mask, scale=scale))
    keys = int(np.minimum(ctx, MAX_BPS * BS).sum())
    nbytes = (2 * S * H * D * 4            # q in, out
              + 2 * keys * H * D * 4       # K and V rows of attended keys
              + tables.nbytes + ctx.nbytes)
    flops = keys * H * 4 * D               # q.k and p.v per key
    bms, by = bound_ms(nbytes, flops)
    return {'name': 'paged_decode_attention', 'route': 'cuda',
            'source': 'paddle_tpu_torch/csrc/paged_attention.cu',
            'replaces': 'paddle_tpu/ops/nn_ops.py:776',
            'shape': f'S={S} H={H} D={D} BS={BS} NB={NB} max_bps={MAX_BPS} '
                     f'ctx={ctx.tolist()}',
            'max_abs_err': err, 'bound_ms': bms, 'bound_by': by, **tm}


def check_prefill_kernel(rng, dev):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import nn_ops
    k_pages, v_pages = make_pool(rng, dev)
    scale = 1.0 / np.sqrt(D)
    errs, rungs = [], {}
    for lb in PREFILL_RUNGS:
        # a prompt of lb tokens plus a budget, as the engine reserves it
        tables, _ = make_tables(rng, [min(lb + 128, MAX_BPS * BS)])
        bt = torch.from_numpy(tables).to(dev)
        q = torch.from_numpy(
            rng.standard_normal((1, H, lb, D), np.float32)).to(dev)
        got = nn_ops.paged_prefill_attention(q, k_pages, v_pages, bt,
                                             sm_scale=scale)
        want = nn_ops.paged_prefill_attention_ref(q, k_pages, v_pages, bt,
                                                  sm_scale=scale)
        errs.append(compare(f'paged_prefill_attention Lb={lb}', got, want))
        # yardstick: causal SDPA on the raw prompt K/V (what the TPU
        # kernel attended); the same rows the paged view holds
        kr = nn_ops._gather_pages(k_pages, bt, 1, H, D)[:, :, :lb]
        vr = nn_ops._gather_pages(v_pages, bt, 1, H, D)[:, :, :lb]
        tm = times(lambda: nn_ops.paged_prefill_attention(
                       q, k_pages, v_pages, bt, sm_scale=scale),
                   lambda: nn_ops.paged_prefill_attention_ref(
                       q, k_pages, v_pages, bt, sm_scale=scale),
                   lambda: F.scaled_dot_product_attention(
                       q, kr, vr, is_causal=True, scale=scale))
        nbytes = 2 * lb * H * D * 4 * 2 + tables.nbytes   # q,out + K,V
        flops = lb * (lb + 1) // 2 * H * 4 * D            # causal pairs
        bms, by = bound_ms(nbytes, flops)
        rungs[lb] = {'bound_ms': bms, 'bound_by': by, **tm}
        log(f'K2 Lb={lb}: max|diff| {errs[-1]:.3e} {fmt_times(rungs[lb])}')
    top = rungs[PREFILL_RUNGS[-1]]
    return {'name': 'paged_prefill_attention', 'route': 'cuda',
            'source': 'paddle_tpu_torch/csrc/paged_attention.cu',
            'replaces': 'paddle_tpu/ops/nn_ops.py:883',
            'shape': f'B=1 H={H} Lb={PREFILL_RUNGS[-1]} D={D} BS={BS} '
                     f'NB={NB} max_bps={MAX_BPS}',
            'max_abs_err': max(errs), **top}


def flash_inputs(rng, dev, shape, dtype, mask=False):
    """q, k, v, dO of ``shape`` in ``dtype`` and, with ``mask``, BertModel's
    (B, 1, 1, S) f32 bias: 0 where attended, -1e4 where padded."""
    import torch
    b, h, s, d = shape

    def n():
        return torch.from_numpy(
            rng.standard_normal((b, h, s, d), np.float32)).to(dev, dtype)

    q, k, v, do = n(), n(), n(), n()
    bias = None
    if mask:
        keep = rng.random((b, 1, 1, s)) < 0.85
        keep[..., 0] = True
        bias = torch.from_numpy(
            np.where(keep, 0.0, -1e4).astype(np.float32)).to(dev)
    return q, k, v, do, bias


def check_flash_chain(label, q, k, v, do, bias, causal, tol):
    """The kernels as the training path runs them (the autograd Function:
    forward, then dK/dV and dQ, and dS where the bias takes a gradient)
    against the plain versions; returns {quantity: max |diff|}.

    The forward's O and log-sum-exp are held against the plain forward;
    the gradients against the plain backward run on the forward kernel's
    own saved O and log-sum-exp (the kernel is deterministic, so a second
    launch gives the Function's). Fed the plain forward's bf16 O instead,
    ``di = rowsum(O . dO)`` would carry O's one-ulp rounding differences
    into every gradient and measure the forward twice. In f32 the whole
    chain is also held against the whole plain chain."""
    import torch
    from paddle_tpu_torch.ops import nn_ops
    sm = q.shape[-1] ** -0.5
    kw = {'sm_scale': sm, 'causal': causal}
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    b = None if bias is None else bias.clone().requires_grad_()
    o = nn_ops.fused_attention(*leaves, b, **kw)
    o.backward(do)
    o_k, lse_k = nn_ops.flash_attention_fwd(q, k, v, bias, **kw)
    o_ref, lse_ref = nn_ops.fused_attention_fwd_ref(q, k, v, bias, **kw)
    errs = {'o': compare(f'{label} O', o.detach(), o_ref, *tol['o']),
            'lse': compare(f'{label} lse', lse_k, lse_ref,
                           *FLASH_TOL['f32']['o'])}
    refs = [nn_ops.fused_attention_bwd_ref(q, k, v, bias, o_k, lse_k, do,
                                           **kw)]
    if q.dtype == torch.float32:
        refs.append(nn_ops.fused_attention_bwd_ref(q, k, v, bias, o_ref,
                                                   lse_ref, do, **kw))
    for i, want in enumerate(refs):
        tag = '' if i == 0 else ' (whole chain)'
        for name, leaf, ref in zip(('dq', 'dk', 'dv'), leaves, want):
            e = compare(f'{label} {name}{tag}', leaf.grad, ref, *tol['grad'])
            errs[name] = max(errs.get(name, 0.0), e)
        if b is not None:
            e = compare(f'{label} dbias{tag}', b.grad,
                        nn_ops._sum_to(want[3], bias.shape), *tol['grad'])
            errs['dbias'] = max(errs.get('dbias', 0.0), e)
    return errs


def time_flash(q, k, v, do, causal):
    """Device times of the three kernels at these inputs (no bias), beside
    their plain versions, the library yardstick and their bounds. The
    plain and library backward compute dQ, dK and dV together, so both
    backward kernels stand beside the same two times."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import nn_ops
    b, h, s, d = q.shape
    sm = d ** -0.5
    kw = {'sm_scale': sm, 'causal': causal}
    o, lse = nn_ops.flash_attention_fwd(q, k, v, **kw)
    di = nn_ops._row_dot(o, do)
    fwd = times(lambda: nn_ops.flash_attention_fwd(q, k, v, **kw),
                lambda: nn_ops.fused_attention_fwd_ref(q, k, v, **kw),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=sm))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                         scale=sm)
    plain_bwd = timed(lambda: nn_ops.fused_attention_bwd_ref(
        q, k, v, None, o, lse, do, **kw))
    lib_bwd = timed(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                retain_graph=True))
    dkv = times_of(timed(lambda: nn_ops.flash_attention_bwd_dkv(
        q, k, v, None, lse, di, do, **kw)), plain_bwd, lib_bwd)
    dq = times_of(timed(lambda: nn_ops.flash_attention_bwd_dq(
        q, k, v, None, lse, di, do, **kw)), plain_bwd, lib_bwd)
    # bytes: each (B, H, S, D) operand read or written once, the f32
    # log-sum-exp and di rows; operations: 2 * D per attended pair and
    # product (QK^T and PV forward; S, dP, dV, dK for dK/dV; S, dP, dQ for
    # dQ)
    row = b * h * s * d * q.element_size()
    vec = b * h * s * 4
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 \
        else F32_FLOPS_PER_S
    out = []
    for name, t, nbytes, products in (
            ('flash_attention_fwd', fwd, 4 * row + vec, 2),
            ('flash_attention_bwd_dkv', dkv, 6 * row + 2 * vec, 4),
            ('flash_attention_bwd_dq', dq, 5 * row + 2 * vec, 3)):
        bms, by = bound_ms(nbytes, products * 2 * pairs * d, peak)
        out.append({'name': name, 'bound_ms': bms, 'bound_by': by, **t})
    return out


# the stock Pallas kernels that paddle_tpu/ops/nn_ops.py:714 reaches
FLASH_STOCK = {
    'flash_attention_fwd': 'jax/experimental/pallas/ops/tpu/'
                           'flash_attention.py:758',
    'flash_attention_bwd_dkv': 'jax/experimental/pallas/ops/tpu/'
                               'flash_attention.py:1121',
    'flash_attention_bwd_dq': 'jax/experimental/pallas/ops/tpu/'
                              'flash_attention.py:1456'}


def check_flash_kernels(rng, dev, card):
    """Phase 3b: every case's kernel chain against the plain chain, then
    the times at the unbiased shapes. Returns the kernels' entries at the
    training path's case (BERT-base, bf16, no bias)."""
    import torch
    cases = (('BERT bf16', BERT_SHAPE, torch.bfloat16, False, False),
             ('BERT f32', BERT_SHAPE, torch.float32, False, False),
             ('BERT bf16 mask', BERT_SHAPE, torch.bfloat16, True, False),
             ('LM causal f32', LM_SHAPE, torch.float32, False, True))
    entries = None
    for label, shape, dtype, mask, causal in cases:
        q, k, v, do, bias = flash_inputs(rng, dev, shape, dtype, mask)
        tol = FLASH_TOL['bf16' if dtype == torch.bfloat16 else 'f32']
        errs = check_flash_chain(label, q, k, v, do, bias, causal, tol)
        log(f'K3/K3b {label} (B, H, S, D)={shape} causal={causal}: max|diff| '
            + ', '.join(f'{n} {e:.3e}' for n, e in errs.items())
            + f' (O atol {tol["o"][0]} rtol {tol["o"][1]}, gradients atol '
              f'{tol["grad"][0]} rtol {tol["grad"][1]}, lse atol {ATOL} '
              f'rtol {RTOL})')
        if not mask:
            timings = time_flash(q, k, v, do, causal)
            for t in timings:
                log(f'{t["name"]} {label} [{card}]: {fmt_times(t)}')
            if entries is None:
                errs_of = {'flash_attention_fwd': errs['o'],
                           'flash_attention_bwd_dkv': max(errs['dk'],
                                                          errs['dv']),
                           'flash_attention_bwd_dq': errs['dq']}
                entries = [{
                    'route': 'cuda',
                    'source': 'paddle_tpu_torch/csrc/flash_attention.cu',
                    'replaces': 'paddle_tpu/ops/nn_ops.py:714',
                    'stock': FLASH_STOCK[t['name']],
                    'shape': f'B={shape[0]} H={shape[1]} S={shape[2]} '
                             f'D={shape[3]} bf16, no bias',
                    'max_abs_err': errs_of[t['name']], **t}
                    for t in timings]
        del q, k, v, do, bias
        torch.cuda.empty_cache()
    return entries


def train(seed, dev, card):
    """Phase 5: BERT-base pretraining steps through the flash kernels;
    returns the kernels' launch counts over the warm-up and timed steps."""
    import torch
    from paddle_tpu_torch.convert import (bert_init_params,
                                          bert_state_dict_from_paddle)
    from paddle_tpu_torch.dygraph import TrainStep
    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              pretrain_loss)
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.optimizer import Adam
    t0 = time.perf_counter()

    def config(fused):
        # bench.py bench_bert's configuration, plus the fused-attention flag
        return BertConfig(attention_probs_dropout_prob=0.0,
                          hidden_dropout_prob=0.0,
                          max_position_embeddings=128,
                          use_fused_attention=fused)

    cfg = config(True)
    sd = bert_state_dict_from_paddle(bert_init_params(cfg, seed))
    model = BertForPretraining(cfg, device=dev, seed=seed)
    model.load_state_dict(sd)
    n_params = sum(p.numel() for p in model.parameters())
    # the batch bench.py makes: 15% MLM labels, the rest -1
    batch, seq = 128, 128
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    tt = np.zeros((batch, seq), np.int64)
    mlm = np.where(rng.rand(batch, seq) < 0.15,
                   rng.randint(0, cfg.vocab_size, (batch, seq)),
                   -1).astype(np.int64)
    nsp = rng.randint(0, 2, (batch, 1)).astype(np.int64)
    feeds = [torch.from_numpy(a).to(dev) for a in (ids, tt, mlm, nsp)]
    log(f'training model: BertConfig(vocab {cfg.vocab_size}, hidden '
        f'{cfg.hidden_size}, {cfg.num_hidden_layers} layers, '
        f'{cfg.num_attention_heads} heads, FFN {cfg.intermediate_size}, '
        f'fused attention) {n_params} parameters; batch {batch} x {seq}, '
        f'{int((mlm >= 0).sum())} MLM labels; built in '
        f'{time.perf_counter() - t0:.1f} s')

    # 1. the fused model against the reference's own unfused route, f32
    unfused = BertForPretraining(config(False), device=dev, seed=seed)
    unfused.load_state_dict(sd)
    with torch.no_grad():
        lf = pretrain_loss(model, *feeds).item()
        lu = pretrain_loss(unfused, *feeds).item()
    del unfused
    torch.cuda.empty_cache()
    rel = abs(lf - lu) / abs(lu)
    log(f'f32 loss: fused {lf!r} unfused {lu!r}, relative difference '
        f'{rel:.3e} (limit 1e-4)')
    if not rel <= 1e-4:
        raise AssertionError(f'fused and unfused f32 losses differ by {rel}')

    # 2. bf16-AMP training steps on the same batch, as bench.py runs them
    step = TrainStep(model, pretrain_loss,
                     Adam(1e-4, parameter_list=list(model.parameters())),
                     amp_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nn_ops.reset_launch_counts()
    losses, secs = [], []
    for _ in range(WARMUP_STEPS + TRAIN_STEPS):
        t = time.perf_counter()
        loss = step(*feeds)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(loss.item())
    launches = nn_ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = WARMUP_STEPS + TRAIN_STEPS
    log('bf16 AMP losses: ' + ' '.join(repr(x) for x in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'losses not finite or not falling: {losses}')
    want = cfg.num_hidden_layers * steps
    for name in FLASH_STOCK:
        if launches[name] != want:
            raise AssertionError(f'{name}: {launches[name]} launches for '
                                 f'{steps} steps x {cfg.num_hidden_layers} '
                                 f'layers')
    timed_s = secs[WARMUP_STEPS:]
    seq_s = batch * TRAIN_STEPS / sum(timed_s)
    p50 = statistics.median(timed_s) * 1e3
    h, layers, vocab = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
    # bench.py's analytic train FLOPs per sequence (forward + backward)
    flops_per_seq = seq * (72.0 * layers * h * h + 12.0 * layers * h * seq
                           + 6.0 * h * vocab)
    log(f'trained [{card}]: {steps} steps ({WARMUP_STEPS} warm-up), '
        f'{seq_s:.1f} seq/s over the {TRAIN_STEPS} timed steps, step p50 '
        f'{p50:.3f} ms (min {min(timed_s) * 1e3:.3f}, max '
        f'{max(timed_s) * 1e3:.3f}); peak device memory {peak} bytes; '
        f'model FLOPs {flops_per_seq / 1e9:.1f} G per sequence, '
        f'{flops_per_seq * seq_s / 1e12:.1f} TFLOP/s = '
        f'{flops_per_seq * seq_s / BF16_FLOPS_PER_S:.4f} of 989 TFLOP/s '
        f'bf16')
    log(f'launches on the training path: {launches} ({steps} steps x '
        f'{layers} layers = {want} each)')
    profile_train_step(step, feeds, p50, card)
    return launches


def profile_train_step(step, feeds, step_ms, card):
    """Where a training step's time goes: the device's busy ms in one
    profiled step against the step's p50 on the host clock, the kernels
    that take it, and the flash kernels' share."""
    prof = profiled(lambda: step(*feeds))
    busy_ms = device_us(prof) / 1e3
    if busy_ms <= 0:
        log(f'train step [{card}]: device busy share not measured (the '
            f'profiler recorded no device time)')
        return

    def dev_ms(e):
        return getattr(e, 'self_device_time_total', 0.0) / 1e3

    events = sorted(prof.key_averages(), key=lambda e: -dev_ms(e))
    flash_ms = sum(dev_ms(e) for e in events if 'flash_' in e.key)
    log(f'train step [{card}]: p50 {step_ms:.3f} ms on the host clock, '
        f'device busy {busy_ms:.3f} ms, idle share '
        f'{1 - busy_ms / step_ms:.3f}; flash kernels {flash_ms:.3f} ms = '
        f'{flash_ms / busy_ms:.3f} of busy')
    for e in events[:12]:
        log(f'  {dev_ms(e):.4f} ms  {dev_ms(e) / busy_ms:.3f}  '
            f'{e.count} calls  {e.key[:90]}')


def post(port, body, timeout=600):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/generate', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read().decode()
    if not body.get('stream', True):
        reply = json.loads(raw)
        return reply['tokens'], reply['finish_reason']
    lines = [json.loads(ln) for ln in raw.splitlines() if ln.strip()]
    if 'error' in lines[-1]:
        raise RuntimeError(f'stream failed: {lines[-1]}')
    tokens = [ln['token'] for ln in lines[:-1]]
    if tokens != lines[-1]['tokens']:
        raise AssertionError('streamed tokens differ from the final line')
    return tokens, lines[-1]['finish_reason']


def serve(seed, card):
    import torch
    from paddle_tpu_torch.models.causal_lm import (greedy_generate,
                                                   max_logit_gaps)
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.serving import ServingServer
    from paddle_tpu_torch.serving.tier.replica import (build_lm,
                                                       build_replica_stack)
    t0 = time.perf_counter()
    model = build_lm('default', seed, 'cuda')
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    engine, sched = build_replica_stack(model)
    srv = ServingServer(None, port=0, generator=sched, warmup=True,
                        request_timeout=600).start()
    log(f'served model: CausalLMConfig() {n_params} parameters, '
        f'{cfg.num_hidden_layers} layers; engine slots={engine.slots} '
        f'block={engine.block_size} ladder={engine.prompt_buckets} '
        f'padded_context={engine.padded_context}; built and warmed in '
        f'{time.perf_counter() - t0:.1f} s')
    try:
        rng = np.random.RandomState(seed)
        reqs = []
        for i in range(16):
            n = int(rng.randint(16, 257))
            budget = int(rng.randint(96, 129) if i % 4 == 3
                         else rng.randint(16, 49))
            prompt = [int(t) for t in rng.randint(0, cfg.vocab_size, n)]
            reqs.append({'prompt': prompt, 'max_new_tokens': budget,
                         'stream': i % 2 == 0, 'request_id': f'smoke-{i}'})
        results = [None] * len(reqs)

        def client(i):
            results[i] = post(srv.port, reqs[i])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        nn_ops.reset_launch_counts()
        engine.reset_stats()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        launches = nn_ops.launch_counts()
        stats = engine.stats
        if any(t.is_alive() for t in threads) or None in results:
            raise AssertionError('a /generate request did not finish')
        for r, (tokens, reason) in zip(reqs, results):
            if len(tokens) != r['max_new_tokens'] or reason != 'length':
                raise AssertionError(
                    f'{r["request_id"]}: {len(tokens)} tokens ({reason}), '
                    f'budget {r["max_new_tokens"]}')
        layers = cfg.num_hidden_layers
        if stats['prefills'] != len(reqs):
            raise AssertionError(f'{stats["prefills"]} prefills for '
                                 f'{len(reqs)} requests')
        if launches['paged_attention'] != stats['decode_steps'] * layers:
            raise AssertionError(f'K1 launches {launches} != decode steps '
                                 f'{stats["decode_steps"]} x {layers}')
        if launches['paged_prefill_attention'] != stats['prefills'] * layers:
            raise AssertionError(f'K2 launches {launches} != prefills '
                                 f'{stats["prefills"]} x {layers}')
        peak = torch.cuda.max_memory_allocated()
        # two streamed requests against the uncached reference on the card
        for i in (0, 3):
            r, tokens = reqs[i], results[i][0]
            gaps = max_logit_gaps(model, r['prompt'], tokens,
                                  pad_len=engine.padded_context)
            ref = greedy_generate(model, r['prompt'], len(tokens),
                                  pad_len=engine.padded_context)
            same = sum(a == b for a, b in zip(tokens, ref))
            log(f'reference {r["request_id"]}: prompt {len(r["prompt"])} '
                f'budget {len(tokens)}: {same}/{len(tokens)} tokens equal to '
                f'greedy_generate, max teacher-forced logit gap '
                f'{gaps.max():.3e} (limit {NEAR_TIE})')
            if gaps.max() > NEAR_TIE:
                raise AssertionError(f'{r["request_id"]}: served token '
                                     f'{gaps.max():.3e} below its row max')
        generated = sum(len(t) for t, _ in results)
        steps_ms = sorted(1e3 * s for s in stats['step_seconds'])
        prefill_ms = {b: round(1e3 * statistics.median(v), 3)
                      for b, v in sorted(stats['prefill_seconds'].items())}
        log(f'served [{card}]: {len(reqs)} requests, {generated} tokens in '
            f'{wall:.3f} s = {generated / wall:.1f} tokens/s; '
            f'{stats["decode_steps"]} decode steps, p50 '
            f'{statistics.median(steps_ms):.3f} ms; prefill median ms by '
            f'rung {prefill_ms}; peak device memory {peak} bytes')
        log(f'launches on the served path: {launches} '
            f'(decode steps {stats["decode_steps"]}, prefills '
            f'{stats["prefills"]}, layers {layers})')
    finally:
        srv.shutdown()
    profile_decode_steps(engine, rng, card)
    return launches


def profile_decode_steps(engine, rng, card, steps=20):
    """Where a decode step's time goes, with every slot active at a context
    of half the longest prompt and up: host-clock ms per step (synchronised)
    against the device's busy ms per step (profiler), and the kernels that
    take it."""
    import torch
    vocab = engine.model.cfg.vocab_size
    prompt_len = engine.max_prompt_len // 2
    tables, tokens = [], []
    for _ in range(engine.slots):
        t = engine.reserve_table(prompt_len, 3 * steps + 1)
        tokens.append(engine.prefill(
            [int(x) for x in rng.randint(0, vocab, prompt_len)], t))
        tables.append(t)

    def run():
        nonlocal tokens
        for _ in range(steps):
            tokens = [int(x) for x in engine.decode_step(tokens, tables)]
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    prof = profiled(run)
    for t in tables:
        engine.release_table(t)
    busy_ms = device_us(prof) / 1e3 / steps
    if busy_ms <= 0:
        log(f'decode step [{card}]: {wall_ms:.3f} ms per step; device busy '
            f'share not measured (the profiler recorded no device time)')
        return
    log(f'decode step [{card}]: {engine.slots} active slots, context '
        f'{prompt_len}-{prompt_len + 3 * steps}: {wall_ms:.3f} ms per step '
        f'on the host clock, device busy {busy_ms:.3f} ms per step, idle '
        f'share {1 - busy_ms / wall_ms:.3f}')
    top = sorted(prof.key_averages(), key=lambda e: -getattr(
        e, 'self_device_time_total', 0.0))[:8]
    for e in top:
        log(f'  {getattr(e, "self_device_time_total", 0.0) / 1e3 / steps:.4f}'
            f' ms/step  {e.count // steps} calls/step  {e.key[:90]}')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device; this script runs on the card')
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.ops import _build

    # 1. device
    dev = resolve_device('cuda')
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f'device: {name}, count {count}, torch {torch.__version__} cuda '
        f'{torch.version.cuda}, tf32 matmul '
        f'{torch.backends.cuda.matmul.allow_tf32} cudnn '
        f'{torch.backends.cudnn.allow_tf32}')
    log(smi)

    # 2. build
    info = _build.build()
    for src, i in info.items():
        log(f'build {src}.cu: {i["seconds"]:.1f} s (cached {i["cached"]})')
        for line in i['ptxas']:
            log(f'  {line}')

    # 3. kernels against their plain versions
    rng = np.random.default_rng(args.seed)
    k1 = check_decode_kernel(rng, dev)
    log(f'K1 [{smi}]: max|diff| {k1["max_abs_err"]:.3e} {fmt_times(k1)}')
    k2 = check_prefill_kernel(rng, dev)

    # 3b. flash-attention kernels against their plain versions
    flash = check_flash_kernels(rng, dev, smi)

    # 4. served path
    launches = serve(args.seed, smi)
    k1['launches'] = launches['paged_attention']
    k2['launches'] = launches['paged_prefill_attention']

    # 5. training path
    launches = train(args.seed, dev, smi)
    for kern in flash:
        kern['launches'] = launches[kern['name']]

    # 6. result lines
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'timing',
            'shape')
    log(json.dumps({'kernels': [
        {k: kern[k] for k in keys + (('stock',) if 'stock' in kern else ())}
        for kern in (k1, k2, *flash)]}))
    log(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                           'count': count}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
