#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit. It exits non-zero, printing no result, when there is no card or no
``paddle_tpu_torch`` package beside it. No phase catches an exception.

Phases:

1. device: the card's name, the device count, and ``nvidia-smi``'s name and
   power limit (every time below stands beside them);
2. build: every source under ``paddle_tpu_torch/csrc/`` (the paged-attention,
   flash-attention and fused 1x1 conv kernels), one ``nvcc`` each for
   ``sm_90a``, all started together (seconds and ``-Xptxas -v`` lines
   printed, spill lines included); then each flash body (forward, dK/dV,
   dQ; bf16 and f32; every head dim) as the loaded library reports it:
   registers, local memory a thread (spills), static and dynamic shared
   memory and the CTAs an SM holds; then the same for K2's key-split body
   (every head dim) and K4's bodies (bf16 wgmma at 64 and 128 tile
   columns, bf16 WMMA, f32);
3. kernels against their plain PyTorch versions at the decode-serving
   path's shapes (8 slots, 8 heads, head_dim 64, block 16, 256-block pool,
   24 blocks per sequence): K1 at ragged contexts up to the full 384 and
   at the served decode step's (contexts 128-188 on every slot), two
   launches bitwise equal; K2 at every prompt rung (1, 16, 64, 256), two
   launches bitwise equal; each launch synchronised and compared; then
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
   printed beside its tolerance; rows that a ``finfo.min`` bias masks
   whole (bf16 at BERT-base's head shape, f32 causal) held to the JAX
   op's formulation (``fused_attention_ref``'s autograd, in f32); then
   device times of each kernel, the plain version and the library
   yardstick (``scaled_dot_product_attention`` forward, and its autograd
   backward for K3b; timed only, never called by the port) beside the
   bound (bytes over 3.35 TB/s, or operations over 989 TFLOP/s bf16 or 67
   TFLOP/s f32);
4. served path: ``TransformerLM(CausalLMConfig())`` at full width from a
   seed, behind the replica stack's ``ServingServer`` on port 0 (8 slots,
   prompts up to 256, up to 128 new tokens); 16 concurrent ``/generate``
   requests (half streamed), each finishing with its full budget; two
   streams held against the uncached ``greedy_generate`` under teacher
   forcing; the kernels' launch counts equal to decode steps x layers and
   prefills x layers; tokens/s, decode-step p50, prefill ms by rung and
   peak device memory; then a profiled window of decode steps with every
   slot active: host ms per step, device busy ms and idle share, K1's
   share of it, and the kernels that take the time;
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
6. ResNet-50 training: ``ResNet50(class_dim=1000, data_format='NHWC')`` at
   full depth from ``resnet_init_params(50, 1000, 'NHWC', seed)``, the
   batch ``bench.py`` makes (128 images of N(0, 1) at 224x224, uniform
   labels in [0, 1000)); f32 checks first: its training-mode logits
   against an NCHW instance loaded with the same weights (relative 1e-4)
   and the s2d stem ConvBNLayer against the plain one (atol and rtol 1e-4,
   as the reference's test); then ``TrainStep(amp_dtype=torch.bfloat16)``
   with ``Momentum(0.1, momentum=0.9)``: 2 warm-up and 20 timed steps,
   each synchronised, every loss finite and the last below the first,
   every master parameter f32; images/s, step p50, min and max, peak
   device memory and the model-FLOP share (``bench.py``'s 12.3 GFLOP per
   image over 989 TFLOP/s); ``bench.py``'s s2d A/B (10 timed steps with
   ``stem_space_to_depth=True``); one profiled step: device busy ms, idle
   share, the top kernels and any NCHW/NHWC transpose kernels;
7. K4 (the fused 1x1 conv + BN + act kernel) against its plain version at
   every distinct (M, K, N) of the model's 33 stride-1 1x1 ConvBNLayers
   at batch 128 (which include ``tools/bench_fused_conv.py``'s four
   shapes), bf16 and f32, act None and relu: bf16 within one bf16 ulp,
   f32 within 1e-4 absolute and relative; device times of the kernel, the
   plain version and the library yardstick (``F.conv2d`` on the
   channels_last input with the weight pre-multiplied by scale and
   ``bias=shift``, then ``relu_``; timed only, never called by the port)
   beside the bound, kernel / library, and the body and tile the launcher
   chose, a row per shape. Then K4's path: the trained model in eval mode, the
   input and output of each of the 33 layers captured in one eval forward
   in f32 and one with the weights cast to bf16; each layer's BN folded
   into scale and shift and run through ``fused_conv1x1_bn_act``, held
   against the layer's own output (f32 atol and rtol 1e-4; bf16 within
   2**-5 of the sum of the magnitudes the layer rounds, see
   ``check_k4_on_model``); K4 launched exactly 33 times per pass, in
   bf16 all 33 through its wgmma body (that body's own counter);
8. the static graph: README's Fluid script, ``build_static_lenet``
   (MNIST LeNet at its published width, 431,080 parameters) with
   ``Adam(0.001)``, through ``Executor(CUDAPlace(0))`` on a seeded f32
   batch of 64; the first step's loss, accuracy and every ``@GRAD``
   against the same step on ``Executor(CPUPlace())`` from the card's
   startup values copied across (atol 1e-5, rtol 1e-4); then 2 warm-up and
   20 timed steps, each synchronised, every loss finite and the last below
   the first; one lowering of the main program for all of them and a
   second after one step at batch 32; steps/s, images/s, step p50, min and
   max, host dispatch ms and peak device memory; one profiled step: device
   busy ms, idle share, kernel launches and the top kernels. None of the
   port's kernels is on this path: every launch count stays 0;
9. the dygraph API: README's dygraph script at Transformer-big
   (``TransformerConfig.big(dropout=0.0, max_length=64)``, 6 + 6 layers at
   full width, about 275 M parameters) from
   ``transformer_init_params(cfg, seed)`` under ``guard(CUDAPlace(0))``,
   on bench.py's batch (64 x 64 source, target and label ids from
   ``RandomState(0)``): an f32 forward, loss and five parameters'
   gradients at batch 2 against the same weights under
   ``guard(CPUPlace())``; three steps of the user loop (``backward`` ->
   ``Adam(NoamDecay(1024, 4000)).minimize`` -> ``clear_gradients``), every
   loss finite and every rate the formula's; then
   ``TrainStep(amp_dtype=torch.bfloat16)`` with ``Adam(1e-4)``, 2 warm-up
   and 20 timed steps, each synchronised, every loss finite, the last
   below the first, every master an f32 Parameter: tokens/s by bench.py's
   count, step p50, min and max, host dispatch, peak device memory and the
   model-FLOP share (bench.py's FLOPs a token over 989 TFLOP/s); one
   profiled step (device busy ms, idle share, launches and the top
   kernels by kind); ``save_dygraph`` -> ``load_dygraph`` into a fresh
   model with identical logits; ``greedy_decode`` and
   ``beam_search_decode`` (beam 4, 16 new tokens) of two rows on the card
   and on the CPU from the trained weights, equal or parting only at a
   near tie; the host cost of the dygraph API per call. None of the
   port's kernels is on this path: every launch count stays 0;
10. a ``{"kernels": [...]}`` line (all six kernels) and, last,
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
# K1's contexts: ragged up to the full 384, and the profiled decode step's
# (every slot active, prompts of 128 and up to 60 tokens decoded)
DECODE_CONTEXTS = [1, 17, 384, 100, None, 250, 33, 64]
SERVED_CONTEXTS = [128, 137, 146, 155, 164, 173, 182, 188]
PREFILL_RUNGS = (1, 16, 64, 256)
# flash kernel shapes: BERT-base training (bench.py bench_bert) and the
# causal TransformerLM (CausalLMConfig(): 8 heads of 64, 512 positions)
BERT_SHAPE = (128, 12, 128, 64)
LM_SHAPE = (8, 8, 512, 64)
TRAIN_STEPS, WARMUP_STEPS = 20, 2
# ResNet-50 training: bench.py bench_resnet's on-chip shape and its
# analytic train FLOPs per image (bench.py:62)
RESNET_BATCH, RESNET_IMG, RESNET_CLASSES = 128, 224, 1000
RESNET_GFLOP_PER_IMAGE = 12.3
RESNET_S2D_STEPS = 10
# MNIST LeNet on the static graph: the book recipe's batch and Adam(0.001);
# the card against the CPU executor at a stated tolerance (f32, TF32 off,
# sums in another order)
LENET_BATCH, LENET_SMALL_BATCH, LENET_PARAMS = 64, 32, 431080
LENET_ATOL, LENET_RTOL = 1e-5, 1e-4
K4_PER_PASS = 33                # stride-1 1x1 ConvBNLayers of ResNet-50
# Transformer-big WMT en-de: bench.py bench_transformer_big's on-chip batch
# (64 x 64, max_length 64); the card against the CPU in f32, TF32 off, sums
# in another order: logits and loss at atol/rtol 1e-4, gradients within
# 1e-3 of their tensor's largest entry; decode at 16 new tokens
NMT_BATCH, NMT_SEQ, NMT_DECODE_LEN = 64, 64, 16
NMT_ATOL, NMT_RTOL, NMT_GRAD_RTOL = 1e-4, 1e-4, 1e-3


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


def fmt_times(t, library='sdpa'):
    line = (f'kernel {t["ms"]:.5f} ms plain {t["plain_ms"]:.5f} ms '
            f'{library} {t["library_ms"]:.5f} ms bound {t["bound_ms"]:.5f} '
            f'ms ({t["bound_by"]}); {t["timing"]}')
    if 'event_ms' in t:
        line += (f'; back-to-back events: kernel {t["event_ms"]:.5f} plain '
                 f'{t["plain_event_ms"]:.5f} {library} '
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


def check_decode_kernel(rng, dev, contexts):
    """K1 against its plain version at ``contexts`` (two launches bitwise
    equal), then its times beside the plain version, SDPA and the
    bound."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import nn_ops
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
    again = nn_ops.paged_attention(q, k_pages, v_pages, bt, cl,
                                   sm_scale=scale)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError('paged_decode_attention: two launches differ')

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
            'replaces': 'paddle_tpu/ops/nn_ops.py:785',
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
        got = nn_ops.paged_prefill_attention(q, q, q, k_pages, v_pages, bt,
                                             sm_scale=scale)
        want = nn_ops.paged_prefill_attention_ref(q, k_pages, v_pages, bt,
                                                  sm_scale=scale)
        errs.append(compare(f'paged_prefill_attention Lb={lb}', got, want))
        again = nn_ops.paged_prefill_attention(q, q, q, k_pages, v_pages, bt,
                                               sm_scale=scale)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f'paged_prefill_attention Lb={lb}: two '
                                 f'launches differ')
        # yardstick: causal SDPA on the raw prompt K/V (what the TPU
        # kernel attended); the same rows the paged view holds
        kr = nn_ops._gather_pages(k_pages, bt, 1, H, D)[:, :, :lb]
        vr = nn_ops._gather_pages(v_pages, bt, 1, H, D)[:, :, :lb]
        tm = times(lambda: nn_ops.paged_prefill_attention(
                       q, q, q, k_pages, v_pages, bt, sm_scale=scale),
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


def report_flash_build():
    """Phase 2, the flash bodies (forward, dK/dV, dQ; bf16 and f32; every
    head dim) as the loaded library reports them: registers, local memory a
    thread (spills), static and dynamic shared memory, threads and the CTAs
    an SM holds. Returns the bf16 bodies' figures at D 64, the training
    path's, by wrapper name."""
    import torch
    from paddle_tpu_torch.ops import nn_ops
    at_d64 = {}
    for kind in nn_ops.FLASH_KINDS:
        for dtype in (torch.bfloat16, torch.float32):
            for d in nn_ops.HEAD_DIMS:
                info = nn_ops.flash_kernel_info(kind, d, dtype)
                log(f'{kind} D {d} {str(dtype)[6:]}: {info["registers"]} '
                    f'registers, {info["spill_bytes"]} B local a thread, '
                    f'{info["static_smem"]} B static and '
                    f'{info["dynamic_smem"]} B dynamic shared, '
                    f'{info["threads"]} threads, {info["ctas_per_sm"]} CTAs '
                    f'an SM')
                if dtype == torch.bfloat16 and d == 64:
                    at_d64[kind] = info
    return at_d64


def report_k2_k4_build():
    """Phase 2, K2's bodies (every head dim) and K4's (the bf16 wgmma body
    at each tile width, the bf16 WMMA body, the f32 body) as the loaded
    libraries report them. Returns K2's figures at D 64 and K4's by body
    and tile, labelled as ``check_k4_kernel`` labels them (``'wgmma
    128x64'``)."""
    from paddle_tpu_torch.ops import nn_ops, pallas_conv

    def line(label, info):
        log(f'{label}: {info["registers"]} registers, {info["spill_bytes"]} '
            f'B local a thread, {info["static_smem"]} B static and '
            f'{info["dynamic_smem"]} B dynamic shared, {info["threads"]} '
            f'threads, {info["ctas_per_sm"]} CTAs an SM')

    k2 = {}
    for d in nn_ops.HEAD_DIMS:
        k2[d] = nn_ops.prefill_kernel_info(d)
        line(f'paged_prefill_attention D {d}', k2[d])
    k4 = {}
    for body, bn in [('wgmma', t) for t in pallas_conv.K4_WGMMA_TILES] + [
            ('wmma', 64), ('f32', 64)]:
        k4[f'{body} 128x{bn}'] = pallas_conv.conv1x1_kernel_info(body, bn)
        line(f'conv1x1_bn_act {body} 128 x {bn}', k4[f'{body} 128x{bn}'])
    return k2[D], k4


def check_flash_chain(label, q, k, v, do, bias, causal, tol):
    """The kernels as the training path runs them (the autograd Function:
    forward, then dK/dV and dQ, and dS where the bias takes a gradient)
    against the plain versions; returns {quantity: max |diff|}.

    The forward's O and row statistics are held against the plain forward;
    the gradients against the plain backward run on the forward kernel's
    own saved O and statistics (the kernel is deterministic, so a second
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
    o_k, st_k = nn_ops.flash_attention_fwd(q, k, v, bias, **kw)
    o_ref, st_ref = nn_ops.fused_attention_fwd_ref(q, k, v, bias, **kw)
    errs = {'o': compare(f'{label} O', o.detach(), o_ref, *tol['o']),
            'stats': compare(f'{label} row statistics', st_k, st_ref,
                             *FLASH_TOL['f32']['o'])}
    refs = [nn_ops.fused_attention_bwd_ref(q, k, v, bias, o_k, st_k, do,
                                           **kw)]
    if q.dtype == torch.float32:
        refs.append(nn_ops.fused_attention_bwd_ref(q, k, v, bias, o_ref,
                                                   st_ref, do, **kw))
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
    o, stats = nn_ops.flash_attention_fwd(q, k, v, **kw)
    di = nn_ops._row_dot(o, do)
    fwd = times(lambda: nn_ops.flash_attention_fwd(q, k, v, **kw),
                lambda: nn_ops.fused_attention_fwd_ref(q, k, v, **kw),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=sm))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                         scale=sm)
    plain_bwd = timed(lambda: nn_ops.fused_attention_bwd_ref(
        q, k, v, None, o, stats, do, **kw))
    lib_bwd = timed(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                retain_graph=True))
    dkv = times_of(timed(lambda: nn_ops.flash_attention_bwd_dkv(
        q, k, v, None, stats, di, do, **kw)), plain_bwd, lib_bwd)
    dq = times_of(timed(lambda: nn_ops.flash_attention_bwd_dq(
        q, k, v, None, stats, di, do, **kw)), plain_bwd, lib_bwd)
    # bytes: each (B, H, S, D) operand read or written once, the f32 row
    # statistics (m and log l) and di rows; operations: 2 * D per attended
    # pair and product (QK^T and PV forward; S, dP, dV, dK for dK/dV; S,
    # dP, dQ for dQ)
    row = b * h * s * d * q.element_size()
    vec = b * h * s * 4
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 \
        else F32_FLOPS_PER_S
    out = []
    for name, t, nbytes, products in (
            ('flash_attention_fwd', fwd, 4 * row + 2 * vec, 2),
            ('flash_attention_bwd_dkv', dkv, 6 * row + 3 * vec, 4),
            ('flash_attention_bwd_dq', dq, 5 * row + 3 * vec, 3)):
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
              f'{tol["grad"][0]} rtol {tol["grad"][1]}, row statistics '
              f'atol {ATOL} rtol {RTOL})')
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
    for shape, dtype, causal in (((4, 12, 128, 64), torch.bfloat16, False),
                                 ((2, 8, 130, 64), torch.float32, True)):
        errs = check_flash_masked_rows(rng, dev, shape, dtype, causal)
        tol = FLASH_TOL['bf16' if dtype == torch.bfloat16 else 'f32']
        log(f'K3/K3b finfo.min rows {str(dtype)[6:]} (B, H, S, D)={shape} '
            f'causal={causal} against fused_attention_ref autograd: max|diff| '
            + ', '.join(f'{n} {e:.3e}' for n, e in errs.items())
            + f' (O atol {tol["o"][0]} rtol {tol["o"][1]}, gradients atol '
              f'{tol["grad"][0]} rtol {tol["grad"][1]})')
    return entries


def check_flash_masked_rows(rng, dev, shape, dtype, causal):
    """Rows that a ``finfo.min`` bias masks whole: a (B, 1, 1, S) bias of
    ``finfo.min`` on about a third of batch row 0's keys and on every key
    of batch row 1, taking a gradient. The kernels, through the autograd
    Function, against ``fused_attention_ref``'s autograd (the JAX op's
    formulation: weight 1/S on each key of a masked row, and under causal
    on the keys past the diagonal too) on the same values in f32: O, and
    the gradients of q, k, v and the bias, in f32 whole and in bf16 on
    batch row 1. In bf16 every gradient is also held, as in
    :func:`check_flash_chain`, to the plain backward run on the forward
    kernel's own O (di = rowsum(O . dO) from a bf16 O differs from the f32
    one by O's rounding, which moves row 0's gradients by more than the
    bf16 tolerance)."""
    import torch
    from paddle_tpu_torch.ops import nn_ops
    q, k, v, do, _ = flash_inputs(rng, dev, shape, dtype)
    b, _, s, d = shape
    keep = rng.random((b, 1, 1, s)) < 0.7
    keep[0, ..., 0] = True
    keep[1] = False
    bias = torch.from_numpy(np.where(keep, 0.0, np.finfo(np.float32).min)
                            .astype(np.float32)).to(dev)
    kw = {'sm_scale': d ** -0.5, 'causal': causal}
    tol = FLASH_TOL['bf16' if dtype == torch.bfloat16 else 'f32']
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    o = nn_ops.fused_attention(*leaves, **kw)
    o.backward(do)
    refs = [t.float().requires_grad_() for t in (q, k, v, bias)]
    o_ref = nn_ops.fused_attention_ref(*refs, **kw)
    o_ref.backward(do.float())
    errs = {'o': compare('finfo.min rows O', o.detach(), o_ref.detach(),
                         *tol['o'])}
    rows = slice(None) if dtype == torch.float32 else slice(1, 2)
    names = ('dq', 'dk', 'dv', 'dbias')
    for name, got, want in zip(names, leaves, refs):
        errs[name] = compare(f'finfo.min rows {name}', got.grad[rows],
                             want.grad[rows], *tol['grad'])
    if dtype == torch.bfloat16:
        o_k, st_k = nn_ops.flash_attention_fwd(q, k, v, bias, **kw)
        dq, dk, dv, ds = nn_ops.fused_attention_bwd_ref(q, k, v, bias, o_k,
                                                        st_k, do, **kw)
        plain = (dq, dk, dv, nn_ops._sum_to(ds, bias.shape))
        for name, got, want in zip(names, leaves, plain):
            errs[name] = max(errs[name], compare(
                f'finfo.min rows {name} (plain backward)', got.grad, want,
                *tol['grad']))
    return errs


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
    profile_train_step(step, feeds, p50, card,
                       {'flash kernels': lambda key: 'flash_' in key})
    return launches


def profile_train_step(step, feeds, step_ms, card, groups,
                       what='train step'):
    """Where a training step's time goes: the device's busy ms in one
    profiled step against the step's p50 on the host clock, the kernels
    that take it, and for each ``label: match`` of ``groups`` the share of
    the kernels whose name ``match``es."""
    prof = profiled(lambda: step(*feeds))
    busy_ms = device_us(prof) / 1e3
    if busy_ms <= 0:
        log(f'{what} [{card}]: device busy share not measured (the '
            f'profiler recorded no device time)')
        return

    def dev_ms(e):
        return getattr(e, 'self_device_time_total', 0.0) / 1e3

    events = sorted(prof.key_averages(), key=lambda e: -dev_ms(e))
    shares = []
    for label, match in groups.items():
        matched = [e for e in events if match(e.key)]
        ms = sum(dev_ms(e) for e in matched)
        shares.append(f'{label} {ms:.3f} ms = {ms / busy_ms:.3f} of busy, '
                      f'{sum(e.count for e in matched)} launches')
    log(f'{what} [{card}]: p50 {step_ms:.3f} ms on the host clock, '
        f'device busy {busy_ms:.3f} ms, idle share '
        f'{1 - busy_ms / step_ms:.3f}; ' + '; '.join(shares))
    for e in events[:12]:
        log(f'  {dev_ms(e):.4f} ms  {dev_ms(e) / busy_ms:.3f}  '
            f'{e.count} calls  {e.key[:90]}')


def resnet_loss(model, x, y):
    """bench.py's loss: the logits cast to f32, softmax cross entropy, the
    batch mean."""
    from paddle_tpu_torch.ops.loss_ops import softmax_with_cross_entropy
    loss, _ = softmax_with_cross_entropy(model(x).float(), y)
    return loss.mean()


def resnet_model(named, fmt, dev, seed, s2d=False):
    from paddle_tpu_torch.convert import resnet_state_dict_from_paddle
    from paddle_tpu_torch.models import ResNet50
    model = ResNet50(RESNET_CLASSES, fmt, stem_space_to_depth=s2d,
                     device=dev, seed=seed)
    model.load_state_dict(resnet_state_dict_from_paddle(named, fmt))
    return model


def check_resnet_f32(named, model, x, dev, seed):
    """The NHWC model's f32 training-mode logits against an NCHW instance
    loaded with the same weights (OIHW copies), and the s2d stem against
    the plain one; ``model`` is reloaded afterwards (the training-mode
    forward moved its running statistics)."""
    import torch
    from paddle_tpu_torch.convert import resnet_state_dict_from_paddle
    from paddle_tpu_torch.models.resnet import ConvBNLayer
    oihw = {n: (a.transpose(3, 2, 0, 1) if a.ndim == 4 else a)
            for n, a in named.items()}
    nchw = resnet_model(oihw, 'NCHW', dev, seed)
    with torch.no_grad():
        a = model.train()(x)
        b = nchw.train()(x.permute(0, 3, 1, 2).contiguous())
    rel = ((a - b).abs().max() / b.abs().max()).item()
    log(f'ResNet-50 f32 training-mode logits, NHWC against NCHW: max|diff| '
        f'{(a - b).abs().max().item():.3e} at max|logit| '
        f'{b.abs().max().item():.3e}, relative {rel:.3e} (limit 1e-4)')
    if not rel <= 1e-4:
        raise AssertionError(f'NHWC and NCHW logits differ by {rel}')
    del nchw, a, b
    model.load_state_dict(resnet_state_dict_from_paddle(named, 'NHWC'))
    s2d = ConvBNLayer(3, 64, 7, stride=2, act='relu', data_format='NHWC',
                      space_to_depth=True, device=dev)
    s2d.load_state_dict(model.conv.state_dict())
    with torch.no_grad():
        want = model.conv.eval()(x)
        got = s2d.eval()(x)
    err = compare('s2d stem', got, want, 1e-4, 1e-4)
    log(f's2d stem ConvBNLayer against the plain stem, f32 eval: max|diff| '
        f'{err:.3e} (atol 1e-4, rtol 1e-4)')
    model.train()
    torch.cuda.empty_cache()


def resnet_steps(model, x, y, steps):
    """``steps`` bf16-AMP Momentum(0.1, 0.9) steps on one batch, each
    synchronised: (losses, seconds per step, the TrainStep)."""
    import torch
    from paddle_tpu_torch.dygraph import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    step = TrainStep(model, resnet_loss,
                     Momentum(0.1, momentum=0.9,
                              parameter_list=list(model.parameters())),
                     amp_dtype=torch.bfloat16)
    losses, secs = [], []
    for _ in range(steps):
        t = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(loss.item())
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'losses not finite or not falling: {losses}')
    if not all(p.dtype == torch.float32 for p in model.parameters()):
        raise AssertionError('a master parameter left f32')
    return losses, secs, step


def train_resnet(seed, dev, card):
    """Phase 6: ResNet-50 bf16-AMP training at bench.py's on-chip shape;
    returns the trained model and the batch's images."""
    import torch
    from paddle_tpu_torch.convert import resnet_init_params
    t0 = time.perf_counter()
    named = resnet_init_params(50, RESNET_CLASSES, 'NHWC', seed)
    model = resnet_model(named, 'NHWC', dev, seed)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(RESNET_BATCH, RESNET_IMG, RESNET_IMG, 3)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, RESNET_CLASSES, (RESNET_BATCH, 1))
                         .astype(np.int64)).to(dev)
    log(f'ResNet-50 NHWC, class_dim {RESNET_CLASSES}: '
        f'{sum(p.numel() for p in model.parameters())} parameters, '
        f'{sum(b.numel() for b in model.buffers())} running statistics; '
        f'batch {RESNET_BATCH} x {RESNET_IMG}^2; built in '
        f'{time.perf_counter() - t0:.1f} s')
    check_resnet_f32(named, model, x, dev, seed)

    xb = x.to(torch.bfloat16)       # bench.py feeds bf16 images on the chip
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, step = resnet_steps(model, xb, y, WARMUP_STEPS + TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    timed_s = secs[WARMUP_STEPS:]
    img_s = RESNET_BATCH * TRAIN_STEPS / sum(timed_s)
    p50 = statistics.median(timed_s) * 1e3
    flops = RESNET_GFLOP_PER_IMAGE * 1e9 * img_s
    log('ResNet-50 bf16 AMP losses: ' + ' '.join(repr(v) for v in losses))
    log(f'ResNet-50 trained [{card}]: {WARMUP_STEPS + TRAIN_STEPS} steps '
        f'({WARMUP_STEPS} warm-up), {img_s:.1f} images/s over the '
        f'{TRAIN_STEPS} timed steps, step p50 {p50:.3f} ms (min '
        f'{min(timed_s) * 1e3:.3f}, max {max(timed_s) * 1e3:.3f}); peak '
        f'device memory {peak} bytes; model FLOPs {RESNET_GFLOP_PER_IMAGE} '
        f'G per image, {flops / 1e12:.1f} TFLOP/s = '
        f'{flops / BF16_FLOPS_PER_S:.4f} of 989 TFLOP/s bf16')
    # a transpose kernel would mean a layer dropped channels_last
    profile_train_step(step, (xb, y), p50, card, {
        'NCHW/NHWC transpose kernels':
            lambda key: 'nchwToNhwc' in key or 'nhwcToNchw' in key,
        'convolutions': lambda key: any(
            t in key.lower() for t in ('conv', 'xmma', 'cudnn', 'dgrad',
                                       'wgrad', 'implicit_gemm', 'nvjet')),
        'reductions': lambda key: 'reduce_kernel' in key,
        'elementwise': lambda key: 'elementwise' in key,
        'optimizer (_foreach)': lambda key: 'multi_tensor' in key,
        'pooling': lambda key: 'pool' in key.lower()})

    # bench.py's A/B of the space-to-depth stem: a fresh model from the
    # same weights, 2 warm-up and 10 timed steps
    s2d = resnet_model(named, 'NHWC', dev, seed, s2d=True)
    _, s2d_secs, _ = resnet_steps(s2d, xb, y, WARMUP_STEPS + RESNET_S2D_STEPS)
    s2d_rate = (RESNET_BATCH * RESNET_S2D_STEPS
                / sum(s2d_secs[WARMUP_STEPS:]))
    log(f'ResNet-50 stem A/B [{card}]: plain {img_s:.1f} images/s, s2d '
        f'{s2d_rate:.1f} images/s ({RESNET_S2D_STEPS} timed steps), step p50 '
        f'{statistics.median(s2d_secs[WARMUP_STEPS:]) * 1e3:.3f} ms')
    del s2d, step
    torch.cuda.empty_cache()
    return model, x


def lenet_programs():
    """README's Fluid script: ``build_static_lenet`` + ``Adam(0.001)`` on
    the port's static graph. Returns (main, startup, loss, acc)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.lenet import build_static_lenet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data('img', [1, 28, 28], dtype='float32')
        label = fluid.layers.data('label', [1], dtype='int64')
        loss, acc, _ = build_static_lenet(img, label)
        fluid.optimizer.Adam(learning_rate=0.001).minimize(loss)
    return main, startup, loss, acc


def train_static_lenet(seed, card):
    """Phase 8: MNIST LeNet through ``Executor(CUDAPlace(0))``, held
    against ``Executor(CPUPlace())``, then timed and profiled. Returns the
    kernels' launch counts over the phase (none of the port's kernels is
    on this path)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.convert import scope_from_paddle
    from paddle_tpu_torch.ops import nn_ops
    fluid.seed(seed)
    main, startup, loss, acc = lenet_programs()
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    if n_params != LENET_PARAMS:
        raise AssertionError(f'LeNet has {n_params} parameters, not '
                             f'{LENET_PARAMS}')
    rng = np.random.default_rng(seed)
    feed = {'img': rng.random((LENET_BATCH, 1, 28, 28), dtype=np.float32),
            'label': rng.integers(0, 10, (LENET_BATCH, 1))}
    grads = [p.name + '@GRAD' for p in main.all_parameters()]
    fetch = [loss, acc] + grads

    nn_ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gpu, gscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gpu.run(startup, scope=gscope)
    # the same first step on the CPU executor, from the card's startup
    # values copied across
    cpu, cscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    persist = sorted(v.name for v in main.list_vars() if v.persistable)
    scope_from_paddle({n: gscope.find(n).cpu().numpy() for n in persist},
                      cscope, fluid.CPUPlace(), program=main)
    got = gpu.run(main, feed=feed, fetch_list=fetch, scope=gscope)
    want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cscope)
    worst = {}
    for name, g, w in zip(['loss', 'acc'] + grads, got, want):
        worst[name] = float(np.max(np.abs(g - w)))
        if g.shape != w.shape or not np.allclose(g, w, atol=LENET_ATOL,
                                                 rtol=LENET_RTOL):
            raise AssertionError(f'LeNet {name} on the card differs from '
                                 f'the CPU executor: max|diff| '
                                 f'{worst[name]:.3e}')
    log(f'LeNet static graph, batch {LENET_BATCH}, {n_params} parameters: '
        f'first step on the card against the CPU executor within atol '
        f'{LENET_ATOL} rtol {LENET_RTOL}: loss {float(got[0])!r} (cpu '
        f'{float(want[0])!r}), acc {float(got[1])!r}; max|diff| ' + ', '.join(
            f'{n} {e:.3e}' for n, e in worst.items()))

    losses, secs = [float(got[0])], []
    for _ in range(WARMUP_STEPS + TRAIN_STEPS):
        t0 = time.perf_counter()
        out = gpu.run(main, feed=feed, fetch_list=[loss], scope=gscope)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(out[0]))
    peak = torch.cuda.max_memory_allocated()
    log('LeNet static-graph Adam losses: ' + ' '.join(repr(v)
                                                      for v in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'LeNet losses {losses}: not finite or not '
                             f'falling')
    lowered = gpu.lowering_count(main)
    if lowered != 1:
        raise AssertionError(f'main program lowered {lowered} times over '
                             f'{len(losses)} steps of one feed shape')
    timed_s = secs[WARMUP_STEPS:]
    p50 = statistics.median(timed_s) * 1e3
    # host dispatch: the run with device tensors fetched, before the sync
    dispatch = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        gpu.run(main, feed=feed, fetch_list=[loss], scope=gscope,
                return_numpy=False)
        dispatch.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    log(f'LeNet static graph trained [{card}]: {len(losses)} steps '
        f'({WARMUP_STEPS} warm-up, {TRAIN_STEPS} timed), '
        f'{TRAIN_STEPS / sum(timed_s):.1f} steps/s, '
        f'{LENET_BATCH * TRAIN_STEPS / sum(timed_s):.1f} images/s, step p50 '
        f'{p50:.3f} ms (min {min(timed_s) * 1e3:.3f}, max '
        f'{max(timed_s) * 1e3:.3f}); host dispatch p50 '
        f'{statistics.median(dispatch) * 1e3:.3f} ms (run returning device '
        f'tensors, before the sync); peak device memory {peak} bytes; '
        f'lowerings of the main program {lowered}')
    profile_train_step(
        lambda: gpu.run(main, feed=feed, fetch_list=[loss], scope=gscope),
        (), p50, card, {
            'kernels': lambda key: not key.startswith(('Memcpy', 'Memset')),
            'copies and fills': lambda key: key.startswith(('Memcpy',
                                                            'Memset')),
            'convolutions': lambda key: any(
                t in key.lower() for t in ('conv', 'xmma', 'cudnn', 'dgrad',
                                           'wgrad', 'implicit_gemm')),
            'gemm': lambda key: any(t in key.lower() for t in (
                'gemm', 'nvjet', 'sm90_', 'cutlass')),
            'elementwise': lambda key: 'elementwise' in key,
            'reductions': lambda key: 'reduce_kernel' in key,
            'pooling': lambda key: 'pool' in key.lower()},
        what='LeNet static-graph step')

    small = {k: v[:LENET_SMALL_BATCH] for k, v in feed.items()}
    out = gpu.run(main, feed=small, fetch_list=[loss], scope=gscope)
    lowered = gpu.lowering_count(main)
    if lowered != 2 or not np.isfinite(out[0]):
        raise AssertionError(f'batch {LENET_SMALL_BATCH}: {lowered} '
                             f'lowerings, loss {out[0]}')
    log(f'LeNet at batch {LENET_SMALL_BATCH}: loss {float(out[0])!r}, '
        f'lowerings of the main program {lowered} (one more for the new '
        f'feed shape)')
    return nn_ops.launch_counts()


def nmt_batch(cfg, batch, seq, seed=0):
    """bench.py's Transformer batch: source, target and (B, S, 1) label ids
    in [1, vocab) from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    src = rng.randint(1, cfg.src_vocab_size, (batch, seq)).astype(np.int64)
    trg = rng.randint(1, cfg.trg_vocab_size, (batch, seq)).astype(np.int64)
    lbl = rng.randint(1, cfg.trg_vocab_size,
                      (batch, seq, 1)).astype(np.int64)
    return src, trg, lbl


def nmt_flops_per_token(cfg, seq):
    """bench.py's analytic train FLOPs per token of Transformer-big (2 FLOP
    a MAC, train = 3x forward, averaged over source and target tokens)."""
    d, di, layers = cfg.d_model, cfg.d_inner, cfg.n_layer
    enc_lin = 2.0 * (4 * d * d + 2 * d * di)
    dec_lin = 2.0 * (8 * d * d + 2 * d * di)
    attn = 4.0 * seq * d
    fwd_per_pair = (layers * (enc_lin + attn) + layers * (dec_lin + 2 * attn)
                    + 2.0 * d * cfg.trg_vocab_size)
    return 3.0 * fwd_per_pair / 2.0


def noam_rate(d_model, warmup, n):
    n = max(n, 1)
    return d_model ** -0.5 * min(n ** -0.5, warmup ** -1.5 * n)


def dygraph_host_costs(dev, card, n=20000):
    """Host microseconds a call of what the dygraph API adds to a plain
    torch op: the op on plain tensors, the op on a dygraph Tensor (torch
    function off), Python arithmetic on a Tensor (wrapped back into one),
    and an outermost against a nested Layer call of a 1x1 Linear."""
    import torch
    from paddle_tpu_torch import dygraph
    x = torch.ones(4, device=dev)
    t = x.as_subclass(dygraph.Tensor)

    def host_us(fn):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) * 1e6 / n
        torch.cuda.synchronize()
        return us

    with dygraph.guard(dev):
        fc = dygraph.Linear(4, 4)
        outer = dygraph.Sequential(fc)
    costs = {'torch.add(plain, plain)': host_us(lambda: torch.add(x, x)),
             'torch.add(Tensor, plain)': host_us(lambda: torch.add(t, x)),
             'plain + plain': host_us(lambda: x + x),
             'Tensor + plain': host_us(lambda: t + x),
             'F.linear (what Linear runs)': host_us(
                 lambda: torch.nn.functional.linear(x, fc.weight.t(),
                                                    fc.bias)),
             'Linear call, outermost': host_us(lambda: fc(x)),
             'Sequential(Linear) call': host_us(lambda: outer(x))}
    log(f'dygraph host cost per call [{card}], {n} calls each on the host '
        f'clock: ' + '; '.join(f'{k} {v:.2f} us' for k, v in costs.items()))
    return costs


def decode_equal_or_near_tie(cpu_model, src, got, want, eos, what):
    """Greedy tokens of the card (``got``) against the CPU's (``want``):
    equal, or at the first step where they part the CPU's top two
    log-probabilities lie within ``NEAR_TIE`` (teacher-forced on the
    common prefix). Returns the rows that parted."""
    import torch
    from paddle_tpu_torch.ops.nn_ops import log_softmax
    parted = []
    for r in range(got.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if not diff.size:
            continue
        t = int(diff[0])
        ys = np.full((1, got.shape[1] + 1), eos, np.int64)
        ys[0, 0] = 1
        ys[0, 1:t + 1] = want[r, :t]
        with torch.no_grad():
            enc = cpu_model.encode(torch.from_numpy(src[r:r + 1]))
            logp = log_softmax(cpu_model.decode(torch.from_numpy(ys),
                                                enc)[0, t]).numpy()
        top = np.sort(logp)[-2:]
        gap = float(top[1] - top[0])
        log(f'{what}: row {r} parts at step {t}: card {got[r, t]} cpu '
            f'{want[r, t]}, the CPU\'s top-two gap {gap:.3e} (near-tie '
            f'limit {NEAR_TIE})')
        if gap > NEAR_TIE:
            raise AssertionError(f'{what}: row {r} differs at step {t} with '
                                 f'a top-two gap of {gap}')
        parted.append(r)
    return parted


def beam_equal_or_near_tie(cpu_model, src, got, want, eos, alpha, what):
    """Beam hypotheses of the card against the CPU's: equal, or, where a
    row's best hypothesis differs, the two hypotheses' length-normalised
    scores under the CPU model (teacher-forced) within ``NEAR_TIE``: a
    near tie between whole hypotheses."""
    import torch
    from paddle_tpu_torch.ops.nn_ops import log_softmax

    def score(r, hyp):
        ys = np.concatenate([[1], hyp]).astype(np.int64)[None]
        with torch.no_grad():
            enc = cpu_model.encode(torch.from_numpy(src[r:r + 1]))
            logp = log_softmax(cpu_model.decode(torch.from_numpy(ys),
                                                enc)[0]).numpy()
        total, n = 0.0, 0
        for t, tok in enumerate(hyp):
            total += float(logp[t, tok])
            n += 1
            if tok == eos:
                break
        length = int((hyp != eos).sum()) + 1
        return total / (((5 + length) / 6.0) ** alpha)

    for r in range(got.shape[0]):
        if np.array_equal(got[r], want[r]):
            continue
        gap = abs(score(r, got[r]) - score(r, want[r]))
        log(f'{what}: row {r} differs; the hypotheses\' normalised CPU '
            f'scores differ by {gap:.3e} (near-tie limit {NEAR_TIE})')
        if gap > NEAR_TIE:
            raise AssertionError(f'{what}: row {r} differs with a score gap '
                                 f'of {gap}')


def train_dygraph_transformer(seed, card):
    """Phase 9: the dygraph API training Transformer-big WMT en-de on the
    card (``guard(CUDAPlace(0))``) at bench.py's on-chip configuration.
    Returns the kernels' launch counts over the phase (none of the port's
    kernels is on this path)."""
    import os
    import shutil
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.convert import transformer_init_params
    from paddle_tpu_torch.dygraph import TrainStep
    from paddle_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, beam_search_decode, greedy_decode,
        transformer_loss)
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.optimizer import Adam

    nn_ops.reset_launch_counts()
    t0 = time.perf_counter()
    cfg = TransformerConfig.big(dropout=0.0, max_length=NMT_SEQ)
    named = transformer_init_params(cfg, seed)
    gpu, cpu = fluid.CUDAPlace(0), fluid.CPUPlace()
    with dygraph.guard(gpu):
        model = Transformer(cfg)
        model.set_dict(named)
    n_params = sum(p.numel() for p in model.parameters())
    src, trg, lbl = nmt_batch(cfg, NMT_BATCH, NMT_SEQ)
    log(f'dygraph Transformer-big: TransformerConfig.big(d_model '
        f'{cfg.d_model}, {cfg.n_head} heads, {cfg.n_layer} + {cfg.n_layer} '
        f'layers, d_inner {cfg.d_inner}, vocab {cfg.src_vocab_size}/'
        f'{cfg.trg_vocab_size}, max_length {cfg.max_length}, dropout 0) '
        f'{n_params} parameters on {model.parameters()[0].device}; '
        f'batch {NMT_BATCH} x {NMT_SEQ}; built in '
        f'{time.perf_counter() - t0:.1f} s')

    # 1. the card against the CPU: f32 forward, loss and a few gradients
    # at batch 2, the same weights
    with dygraph.guard(cpu):
        cpu_model = Transformer(cfg)
        cpu_model.set_dict(named)
    del named
    last = f'dec_{cfg.n_layer - 1}'
    names = ('src_emb.weight', 'enc_0.attn.q.weight', f'{last}.ffn.fc2.weight',
             f'{last}.ln3.bias', 'proj.weight')
    out = {}
    for where, place, m in (('card', gpu, model), ('cpu', cpu, cpu_model)):
        with dygraph.guard(place):
            logits = m(dygraph.to_variable(src[:2]),
                       dygraph.to_variable(trg[:2]))
            loss = transformer_loss(logits, dygraph.to_variable(lbl[:2]))
            loss.backward()
            params = dict(m.named_parameters())
            out[where] = (
                logits.numpy(), float(loss.numpy()),
                {n: params[n].gradient() for n in names})
            m.clear_gradients()
    (gl, gloss, gg), (cl, closs, cg) = out['card'], out['cpu']
    err = float(np.abs(gl - cl).max())
    lerr = abs(gloss - closs) / abs(closs)
    gerr = {n: float(np.abs(gg[n] - cg[n]).max() / np.abs(cg[n]).max())
            for n in names}
    log(f'Transformer-big card vs CPU, f32, batch 2: logits max|diff| '
        f'{err:.3e} (atol {NMT_ATOL} + rtol {NMT_RTOL}), loss {gloss!r} vs '
        f'{closs!r} (relative {lerr:.3e}, limit {NMT_RTOL}); gradients '
        f'max|diff| / max|grad|: ' + ', '.join(
            f'{n} {e:.3e}' for n, e in gerr.items())
        + f' (limit {NMT_GRAD_RTOL})')
    if not np.allclose(gl, cl, atol=NMT_ATOL, rtol=NMT_RTOL) \
            or not lerr <= NMT_RTOL \
            or not max(gerr.values()) <= NMT_GRAD_RTOL:
        raise AssertionError('Transformer-big on the card differs from the '
                             'CPU')

    # 2. the user loop of README's dygraph script, f32: backward ->
    # Adam(NoamDecay(1024, 4000)).minimize -> clear_gradients
    feeds = [torch.from_numpy(a).cuda() for a in (src, trg, lbl)]
    with dygraph.guard(gpu):
        sched = dygraph.NoamDecay(1024, 4000)
        opt = fluid.optimizer.Adam(learning_rate=sched,
                                   parameter_list=model.parameters())
        losses, rates, secs = [], [], []
        for n in range(1, 4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = transformer_loss(model(dygraph.to_variable(feeds[0]),
                                          dygraph.to_variable(feeds[1])),
                                    dygraph.to_variable(feeds[2]))
            loss.backward()
            rates.append(opt.current_step_lr)
            opt.minimize(loss)
            model.clear_gradients()
            losses.append(float(loss.numpy()))
            secs.append(time.perf_counter() - t)
            want = noam_rate(1024, 4000, n)
            if abs(rates[-1] - want) > 1e-12 * want:
                raise AssertionError(f'NoamDecay rate {rates[-1]} at step '
                                     f'{n}, formula {want}')
    log(f'user loop (f32, Adam(NoamDecay(1024, 4000))): losses '
        + ' '.join(repr(v) for v in losses) + '; rates '
        + ' '.join(f'{r:.6e}' for r in rates) + ' (the formula\'s); step ms '
        + ' '.join(f'{s * 1e3:.1f}' for s in secs))
    if not all(np.isfinite(losses)):
        raise AssertionError(f'user-loop losses not finite: {losses}')
    del opt
    torch.cuda.empty_cache()

    # 3. TrainStep(amp_dtype=bf16) with Adam(1e-4), as bench.py runs it
    def loss_fn(m, s, t, y):
        return transformer_loss(m(s, t), y)

    params = model.parameters()
    step = TrainStep(model, loss_fn, Adam(1e-4, parameter_list=params),
                     amp_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, host = [], [], []
    for _ in range(WARMUP_STEPS + TRAIN_STEPS):
        t = time.perf_counter()
        loss = step(*feeds)
        host.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    log('Transformer-big bf16 AMP losses: ' + ' '.join(repr(v)
                                                       for v in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f'losses not finite or not falling: {losses}')
    if not all(p.dtype == torch.float32 and type(p) is dygraph.Parameter
               for p in model.parameters()) or model.parameters() != params:
        raise AssertionError('a master parameter is not an f32 Parameter '
                             'after the AMP steps')
    timed_s = secs[WARMUP_STEPS:]
    tokens = NMT_BATCH * 2 * NMT_SEQ
    tok_s = tokens * TRAIN_STEPS / sum(timed_s)
    p50 = statistics.median(timed_s) * 1e3
    flops = nmt_flops_per_token(cfg, NMT_SEQ)
    log(f'Transformer-big trained [{card}]: {len(losses)} steps '
        f'({WARMUP_STEPS} warm-up), {tok_s:.1f} tokens/s (bench.py\'s count, '
        f'{tokens} source + target tokens a step) over the {TRAIN_STEPS} '
        f'timed steps, step p50 {p50:.3f} ms (min {min(timed_s) * 1e3:.3f}, '
        f'max {max(timed_s) * 1e3:.3f}); host dispatch p50 '
        f'{statistics.median(host[WARMUP_STEPS:]) * 1e3:.3f} ms (the call '
        f'returning, before the sync); peak device memory {peak} bytes; '
        f'model FLOPs {flops / 1e9:.4f} G per token, '
        f'{flops * tok_s / 1e12:.1f} TFLOP/s = '
        f'{flops * tok_s / BF16_FLOPS_PER_S:.4f} of 989 TFLOP/s bf16')
    profile_train_step(step, feeds, p50, card, {
        'all kernels': lambda key: not key.startswith(('Memcpy', 'Memset')),
        'gemm': lambda key: any(s in key.lower() for s in (
            'gemm', 'nvjet', 'sm90_', 'cutlass', 'xmma')),
        'multi-tensor (optimizer, casts)': lambda key: 'multi_tensor' in key
        or 'foreach' in key.lower(),
        'softmax': lambda key: 'softmax' in key.lower(),
        'layer norm': lambda key: 'layer_norm' in key.lower(),
        'elementwise': lambda key: 'elementwise' in key,
        'reductions': lambda key: 'reduce_kernel' in key,
        'embedding': lambda key: 'embedding' in key.lower()
        or 'index' in key.lower(),
        'copies and fills': lambda key: key.startswith(('Memcpy',
                                                        'Memset'))},
        what='Transformer-big bf16 step')
    del step
    torch.cuda.empty_cache()

    # 4. checkpoint: save_dygraph of the trained state, load_dygraph into a
    # fresh model, identical logits
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'paddle_tpu_torch', 'build', 'smoke_ckpt',
                        'transformer')
    t = time.perf_counter()
    dygraph.save_dygraph(model.state_dict(), path)
    saved_s = time.perf_counter() - t
    state, _ = dygraph.load_dygraph(path)
    shutil.rmtree(os.path.dirname(path))
    with dygraph.guard(gpu), torch.no_grad():
        fresh = Transformer(cfg)
        fresh.set_dict(state)
        model.eval()
        fresh.eval()
        a = model(feeds[0][:4], feeds[1][:4])
        b = fresh(feeds[0][:4], feeds[1][:4])
        same = torch.equal(a, b)
    log(f'checkpoint: save_dygraph of {len(state)} arrays in {saved_s:.1f} '
        f's, load_dygraph into a fresh model: logits identical {same} '
        f'(max|diff| {float((a - b).abs().max()):.3e})')
    if not same:
        raise AssertionError('a reloaded checkpoint gives other logits')
    del fresh, a, b, state
    torch.cuda.empty_cache()

    # 5. decode on two source rows, the card against the CPU, the trained
    # weights
    cpu_model.set_dict(model.state_dict())
    cpu_model.eval()
    rows = src[:2]
    res = {}
    for where, place, m in (('card', gpu, model), ('cpu', cpu, cpu_model)):
        with dygraph.guard(place):
            t = time.perf_counter()
            g = greedy_decode(m, rows, 1, 2, max_len=NMT_DECODE_LEN)
            g_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            b = beam_search_decode(m, rows, 1, 2, beam_size=4,
                                   max_len=NMT_DECODE_LEN)
            b_ms = (time.perf_counter() - t) * 1e3
        res[where] = (g, b, g_ms, b_ms)
    (gg, gb, ggms, gbms), (cg_, cb, cgms, cbms) = res['card'], res['cpu']
    log(f'decode of 2 rows, max_len {NMT_DECODE_LEN} [{card}]: greedy '
        f'{ggms:.1f} ms on the card ({cgms:.1f} ms on the CPU), beam 4 '
        f'{gbms:.1f} ms ({cbms:.1f} ms); greedy tokens equal '
        f'{np.array_equal(gg, cg_)}, beam tokens equal '
        f'{np.array_equal(gb, cb)}; card greedy {gg.tolist()}, beam '
        f'{gb.tolist()}')
    with dygraph.guard(cpu):
        decode_equal_or_near_tie(cpu_model, rows, gg, cg_, 2, 'greedy')
        beam_equal_or_near_tie(cpu_model, rows, gb, cb, 2, 0.6, 'beam')
    del cpu_model
    return nn_ops.launch_counts()


def k4_layers(model):
    """(name, ConvBNLayer) of the model's stride-1 1x1 ConvBNLayers, the
    layers K4 takes: every bottleneck's conv0 (relu) and conv2 (no act),
    and the first stage's stride-1 shortcut."""
    from paddle_tpu_torch.models.resnet import ConvBNLayer
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, ConvBNLayer)
            and tuple(m._conv.weight.shape[2:]) == (1, 1)
            and m._conv._attrs['stride'] == 1]


def check_k4_on_model(model, x, card):
    """Phase 7, K4's path: the trained model in eval mode; each of its 33
    stride-1 1x1 ConvBNLayers' input and output captured in one eval
    forward, in f32 and with the weights cast to bf16; the layer's BN
    folded (scale = gamma / sqrt(var + eps), shift = beta - mean * scale,
    from the f32 masters) and run through ``fused_conv1x1_bn_act``.

    f32 is held to atol and rtol 1e-4. In bf16 the layer rounds seven times
    (its conv output, the mean, the rsqrt, the difference, two products
    and the sum) besides the AMP cast of gamma and beta, K4 three times
    (scale, shift, its output); each rounding moves the output by at most
    2**-8 of one of |c s|, |mean s|, |beta|, |y| (c the f32 conv sum, s
    the folded scale), and together they come to at most 7 * 2**-8 of
    their sum B: the bound is 2**-5 B, elementwise.

    Every bf16 layer is a shape the TMA loads of K4's wgmma body describe,
    so the bf16 pass launches that body 33 times (its own counter), the f32
    pass the f32 body.

    Returns (launches in the two passes, the wgmma body's under
    ``'conv1x1_bn_act wgmma'``; the 33 layers' (B, H, W, K, N))."""
    import torch
    from paddle_tpu_torch.ops import nn_ops
    from paddle_tpu_torch.ops.pallas_conv import (conv1x1_bn_act,
                                                  fused_conv1x1_bn_act)
    layers = k4_layers(model)
    if len(layers) != K4_PER_PASS:
        raise AssertionError(f'{len(layers)} stride-1 1x1 ConvBNLayers, '
                             f'expected {K4_PER_PASS}')
    model.eval()
    shapes = []
    wgmma_launches = 0
    nn_ops.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        captured = {}
        hooks = [m.register_forward_hook(
            lambda mod, args, out, n=n: captured.__setitem__(n, (args[0],
                                                                 out)))
            for n, m in layers]
        params = {n: p.detach().to(dtype)
                  for n, p in model.named_parameters()}
        with torch.no_grad():
            torch.func.functional_call(model, params, (x.to(dtype),))
        for h in hooks:
            h.remove()
        before = conv1x1_bn_act.launches
        before_wgmma = conv1x1_bn_act.launches_wgmma
        worst, worst_b = 0.0, 0.0
        for n, m in layers:
            xin, want = captured.pop(n)
            bn = m._bn
            scale = bn.weight.detach() / torch.sqrt(
                bn._variance_buf + bn._attrs['epsilon'])
            shift = bn.bias.detach() - bn._mean_buf * scale
            w = params[f'{n}._conv.weight']
            with torch.no_grad():
                got = fused_conv1x1_bn_act(xin, w, scale, shift, act=m._act)
            if dtype == torch.float32:
                b, h, ww, k = xin.shape
                shapes.append((b, h, ww, k, w.shape[0]))
                worst = max(worst, compare(f'K4 on {n} f32', got, want,
                                           1e-4, 1e-4))
                worst_b = max(worst_b, ((got - want).abs()
                                        / (1e-4 + 1e-4 * want.abs()))
                              .max().item())
                continue
            torch.cuda.synchronize()
            k = xin.shape[-1]
            c = (xin.reshape(-1, k).float()
                 @ w.reshape(-1, k).float().t()).reshape(got.shape)
            bound = (c * scale).abs() + (bn._mean_buf * scale).abs() \
                + bn.bias.detach().abs() + want.float().abs()
            err = (got.float() - want.float()).abs()
            if not bool((err <= 2 ** -5 * bound).all()):
                raise AssertionError(f'K4 on {n} bf16: max|diff| '
                                     f'{err.max().item():.3e} beyond 2**-5 '
                                     f'of B')
            worst = max(worst, err.max().item())
            worst_b = max(worst_b, (err / bound).max().item())
            del c, bound, err
        torch.cuda.synchronize()
        ran = conv1x1_bn_act.launches - before
        ran_wgmma = conv1x1_bn_act.launches_wgmma - before_wgmma
        # every bf16 layer of the pass is a shape TMA describes
        want_wgmma = K4_PER_PASS if dtype == torch.bfloat16 else 0
        if ran != K4_PER_PASS or ran_wgmma != want_wgmma:
            raise AssertionError(f'K4 launched {ran} times ({ran_wgmma} of '
                                 f'the wgmma body) in one {dtype} pass, '
                                 f'expected {K4_PER_PASS} ({want_wgmma})')
        wgmma_launches += ran_wgmma
        log(f'K4 on the trained model, eval {dtype} [{card}]: 33 layers, '
            f'{ran} launches ({ran_wgmma} of the wgmma body), max|diff| '
            f'against the layers {worst:.3e}'
            + (f', max |diff| / (1e-4 + 1e-4 |y|) {worst_b:.3e} (limit 1)'
               if dtype == torch.float32 else
               f', max |diff| / B {worst_b:.3e} (limit 2**-5 = 0.03125)'))
        del captured, params
        torch.cuda.empty_cache()
    launches = nn_ops.launch_counts()
    launches['conv1x1_bn_act wgmma'] = wgmma_launches
    return launches, shapes


def k4_inputs(shape, dtype, dev, gen):
    """``tools/bench_fused_conv.py``'s inputs at (B, H, W, K, N)."""
    import torch
    b, h, w, k, n = shape

    def randn(*sh):
        return torch.randn(sh, generator=gen, device=dev)

    return ((randn(b, h, w, k)).to(dtype),
            (randn(n, k, 1, 1) * 0.05).to(dtype),
            (torch.rand(n, generator=gen, device=dev) + 0.5).to(dtype),
            (randn(n) * 0.1).to(dtype))


def bf16_ulp_err(got, want, atol=1e-5):
    """max |got - want| after one bf16 ulp of the larger magnitude (plus
    ``atol`` for values ReLU cuts at zero) is taken off; <= 0 passes."""
    import torch
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8)
    return ((got - want).abs() - ulp - atol).max().item()


def check_k4_kernel(layer_shapes, dev, card):
    """Phase 7, K4 against its plain version at every distinct shape of its
    path (``layer_shapes``, one per layer), bf16 and f32, act None and
    relu, then its device time (relu) beside the plain version, the
    library yardstick and the bound, kernel / library, and the body and
    tile the launcher chose; a row per shape, and those times summed over
    the path's layers. Returns the kernels-line entry at
    tools/bench_fused_conv.py's first shape (256 -> 64 at 56x56), bf16."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.pallas_conv import (conv1x1_bn_act,
                                                  conv1x1_plan,
                                                  fused_conv1x1_bn_act_ref)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    entry = None
    per_pass = {}             # dtype label -> summed ms over the layers
    rows = []
    for shape in dict.fromkeys(layer_shapes):
        b, h, w, k, n = shape
        m = b * h * w
        cells = []
        for dtype in (torch.bfloat16, torch.float32):
            x, wt, sc, sh = k4_inputs(shape, dtype, dev, gen)
            plan = conv1x1_plan(x, wt, sc, sh)
            errs = []
            for act in (None, 'relu'):
                got = conv1x1_bn_act(x, wt, sc, sh, act=act)
                want = fused_conv1x1_bn_act_ref(x, wt, sc, sh, act=act)
                if dtype == torch.bfloat16:
                    torch.cuda.synchronize()
                    over = bf16_ulp_err(got, want)
                    if over > 0:
                        raise AssertionError(f'K4 {shape} bf16 act={act}: '
                                             f'beyond one bf16 ulp by '
                                             f'{over:.3e}')
                    errs.append((got.float() - want.float()).abs().max()
                                .item())
                else:
                    errs.append(compare(f'K4 {shape} f32 act={act}', got,
                                        want, 1e-4, 1e-4))
            wl = (wt * sc.view(-1, 1, 1, 1)).contiguous(
                memory_format=torch.channels_last)
            xl = x.permute(0, 3, 1, 2)            # channels_last view

            def library():
                return F.conv2d(xl, wl, sh).relu_()

            tm = times_of(
                timed(lambda: conv1x1_bn_act(x, wt, sc, sh, act='relu'),
                      iters=50),
                timed(lambda: fused_conv1x1_bn_act_ref(x, wt, sc, sh,
                                                       act='relu'),
                      iters=50),
                timed(library, iters=50))
            es = x.element_size()
            nbytes = (m * k + n * k + m * n + 2 * n) * es
            peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 \
                else F32_FLOPS_PER_S
            bms, by = bound_ms(nbytes, 2 * m * n * k, peak)
            tm.update(bound_ms=bms, bound_by=by)
            label = 'bf16' if dtype == torch.bfloat16 else 'f32'
            body = f'{plan["body"]} 128x{plan["bn"]}'
            ratio = tm['ms'] / tm['library_ms']
            log(f'K4 {k}->{n}@{h}x{w} (M {m}) {label} [{card}]: body {body}, '
                f'{plan["grid"]} CTAs, {plan["stages"]} stages; max|diff| '
                f'{max(errs):.3e}; {fmt_times(tm, "conv2d")}; kernel / '
                f'conv2d {ratio:.3f}')
            cells.append(f'{label} {body} {tm["ms"]:.5f} / '
                         f'{tm["plain_ms"]:.5f} / {tm["library_ms"]:.5f} / '
                         f'{tm["bound_ms"]:.5f} ({ratio:.2f})')
            total = per_pass.setdefault(label, dict.fromkeys(
                ('ms', 'plain_ms', 'library_ms', 'bound_ms'), 0.0))
            for key in total:
                total[key] += layer_shapes.count(shape) * tm[key]
            if (k, n, h, label) == (256, 64, 56, 'bf16'):
                entry = {'name': 'conv1x1_bn_act', 'route': 'cuda',
                         'source': 'paddle_tpu_torch/csrc/conv1x1_bn_act.cu',
                         'replaces': 'paddle_tpu/ops/pallas_conv.py:93',
                         'body': body,
                         'shape': f'M={m} K={k} N={n} ({k}->{n}@{h}x{w}, '
                                  f'batch {b}) {label}, relu',
                         'max_abs_err': max(errs), **tm}
            del x, wt, sc, sh, wl, xl
        rows.append(f'{k}->{n} @{h} x{layer_shapes.count(shape)}: '
                    + '; '.join(cells))
        torch.cuda.empty_cache()
    log(f'K4 by shape [{card}] (kernel / plain / conv2d + relu_ / bound ms, '
        f'kernel / conv2d):')
    for row in rows:
        log(f'  {row}')
    for label, t in per_pass.items():
        log(f'K4 over the {len(layer_shapes)} layers of one {label} pass '
            f'[{card}]: kernel {t["ms"]:.5f} ms, plain {t["plain_ms"]:.5f} '
            f'ms, conv2d {t["library_ms"]:.5f} ms, bound {t["bound_ms"]:.5f} '
            f'ms')
    if entry is None:
        raise AssertionError('the path has no 256 -> 64 layer at 56x56')
    return entry


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
    k1 = [e for e in prof.key_averages() if 'paged_decode' in e.key]
    k1_ms = sum(getattr(e, 'self_device_time_total', 0.0)
                for e in k1) / 1e3 / steps
    log(f'decode step [{card}]: {engine.slots} active slots, context '
        f'{prompt_len}-{prompt_len + 3 * steps}: {wall_ms:.3f} ms per step '
        f'on the host clock, device busy {busy_ms:.3f} ms per step, idle '
        f'share {1 - busy_ms / wall_ms:.3f}; K1 {k1_ms:.4f} ms per step = '
        f'{k1_ms / busy_ms:.3f} of busy, '
        f'{sum(e.count for e in k1) // steps} kernel launches per step')
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
    flash_build = report_flash_build()
    k2_build, k4_build = report_k2_k4_build()

    # 3. kernels against their plain versions
    rng = np.random.default_rng(args.seed)
    k1 = check_decode_kernel(rng, dev, DECODE_CONTEXTS)
    log(f'K1 [{smi}]: max|diff| {k1["max_abs_err"]:.3e} {fmt_times(k1)}')
    served = check_decode_kernel(rng, dev, SERVED_CONTEXTS)
    log(f'K1 at the served decode step [{smi}]: max|diff| '
        f'{served["max_abs_err"]:.3e} {fmt_times(served)}')
    k1['served_shape'] = {key: served[key] for key in (
        'shape', 'max_abs_err', 'ms', 'plain_ms', 'library_ms', 'bound_ms',
        'bound_by', 'timing')}
    k2 = check_prefill_kernel(rng, dev)

    # 3b. flash-attention kernels against their plain versions
    flash = check_flash_kernels(rng, dev, smi)

    # 4. served path
    launches = serve(args.seed, smi)
    k1['launches'] = launches['paged_attention']
    k2['launches'] = launches['paged_prefill_attention']
    k2['build'] = k2_build

    # 5. training path
    launches = train(args.seed, dev, smi)
    for kern in flash:
        kern['launches'] = launches[kern['name']]
        kern['build'] = flash_build[kern['name']]

    # 6. ResNet-50 training
    model, x = train_resnet(args.seed, dev, smi)

    # 7. K4: its path (the trained model's 1x1 ConvBNLayers in eval), then
    # the kernel against its plain version at the path's shapes
    launches, shapes = check_k4_on_model(model, x, smi)
    del model, x
    torch.cuda.empty_cache()
    k4 = check_k4_kernel(shapes, dev, smi)
    k4['launches'] = launches['conv1x1_bn_act']
    k4['launches_wgmma'] = launches['conv1x1_bn_act wgmma']
    k4['build'] = k4_build[k4['body']]

    # 8. the static graph: MNIST LeNet on Executor(CUDAPlace(0)); no kernel
    # of the port is on this path, and none may launch
    static = train_static_lenet(args.seed, smi)
    if any(static.values()):
        raise AssertionError(f'kernels launched on the static-graph path: '
                             f'{static}')
    log(f'static-graph path kernel launches: {static}')

    # 9. the dygraph API: Transformer-big under guard(CUDAPlace(0)); no
    # kernel of the port is on this path, and none may launch
    torch.cuda.empty_cache()
    nmt = train_dygraph_transformer(args.seed, smi)
    if any(nmt.values()):
        raise AssertionError(f'kernels launched on the dygraph path: {nmt}')
    log(f'dygraph path kernel launches: {nmt}')
    dygraph_host_costs(dev, smi)

    # 10. result lines
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'timing',
            'shape')
    log(json.dumps({'kernels': [
        {k: kern[k] for k in keys + tuple(
            x for x in ('body', 'launches_wgmma', 'stock', 'build',
                        'served_shape') if x in kern)}
        for kern in (k1, k2, *flash, k4)]}))
    log(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                           'count': count}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
