"""Paged attention of the PyTorch port (paddle_tpu_torch/ops/nn_ops.py)
against the JAX package's ops on the CPU.

On CPU tensors the port's wrappers run their plain versions; the JAX ops run
their XLA formulation (the CPU backend never reaches the Pallas kernels).
Both get the same numpy inputs made from a seed: ragged contexts including 1
and the full padded context, inactive slots on the scratch block, and stale
data in blocks no table owns. Tolerance atol 1e-5, rtol 1e-5: f32 sums taken
in another order.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.ops import nn_ops as jax_ops
from paddle_tpu_torch.ops import nn_ops

H = 2
MAXBPS = 4
ATOL = RTOL = 1e-5


def make_pool(rng, bs, d, num_blocks=24):
    """A pool whose every block holds non-zero data, scratch block included
    (stale rows from earlier requests)."""
    k = rng.randn(H, num_blocks, bs, d).astype(np.float32)
    v = rng.randn(H, num_blocks, bs, d).astype(np.float32)
    return k, v


def make_tables(rng, context_lens, bs, num_blocks=24):
    """Distinct shuffled blocks for each active slot, scratch padding after
    its last block; a slot with context None is inactive (all scratch,
    context 1)."""
    free = list(rng.permutation(np.arange(1, num_blocks)))
    tables, ctx = [], []
    for c in context_lens:
        if c is None:
            tables.append([0] * MAXBPS)
            ctx.append(1)
            continue
        nb = -(-c // bs)
        tables.append([int(free.pop()) for _ in range(nb)]
                      + [0] * (MAXBPS - nb))
        ctx.append(c)
    return np.asarray(tables, np.int32), np.asarray(ctx, np.int32)


def torch_inputs(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize('bs', [4, 16])
@pytest.mark.parametrize('d', [16, 64])
def test_decode_matches_jax(bs, d):
    rng = np.random.RandomState(bs * 100 + d)
    full = MAXBPS * bs
    lens = [1, None, 3, full, bs + 1, None, full - 1]
    k, v = make_pool(rng, bs, d)
    tables, ctx = make_tables(rng, lens, bs)
    q = rng.randn(len(lens), H, d).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    ref = np.asarray(jax_ops.paged_attention(q, k, v, tables, ctx,
                                             sm_scale=scale))
    got = nn_ops.paged_attention(*torch_inputs(q, k, v, tables, ctx),
                                 sm_scale=scale)
    assert got.shape == (len(lens), H, d)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('bs', [4, 16])
@pytest.mark.parametrize('d', [16, 64])
def test_prefill_matches_jax(bs, d):
    rng = np.random.RandomState(bs * 10 + d)
    k, v = make_pool(rng, bs, d)
    scale = 1.0 / np.sqrt(d)
    for lq in (1, bs + 3, MAXBPS * bs):
        tables, _ = make_tables(rng, [lq], bs)
        q = rng.randn(1, H, lq, d).astype(np.float32)
        kq = rng.randn(1, H, lq, d).astype(np.float32)   # raw k/v: the JAX
        vq = rng.randn(1, H, lq, d).astype(np.float32)   # op's kernel inputs
        ref = np.asarray(jax_ops.paged_prefill_attention(
            q, kq, vq, k, v, tables, sm_scale=scale))
        got = nn_ops.paged_prefill_attention(
            *torch_inputs(q, kq, vq, k, v, tables), sm_scale=scale)
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('op', ['decode', 'prefill'])
def test_stale_blocks_do_not_bleed(op):
    """Rewriting every row the tables do not expose (other blocks, rows past
    the context, the scratch block) with huge values changes nothing."""
    rng = np.random.RandomState(7)
    bs, d = 4, 16
    k, v = make_pool(rng, bs, d)
    lens = [5, 1, 9] if op == 'decode' else [6]
    tables, ctx = make_tables(rng, lens, bs)
    k2, v2 = k * 1e4, v * 1e4
    for s, c in enumerate(ctx):
        for t in range(c):
            blk, off = tables[s, t // bs], t % bs
            k2[:, blk, off] = k[:, blk, off]
            v2[:, blk, off] = v[:, blk, off]
    if op == 'decode':
        q = rng.randn(len(lens), H, d).astype(np.float32)
        a = nn_ops.paged_attention(*torch_inputs(q, k, v, tables, ctx))
        b = nn_ops.paged_attention(*torch_inputs(q, k2, v2, tables, ctx))
    else:
        q = rng.randn(1, H, lens[0], d).astype(np.float32)
        a = nn_ops.paged_prefill_attention(*torch_inputs(q, q, q, k, v,
                                                         tables))
        b = nn_ops.paged_prefill_attention(*torch_inputs(q, q, q, k2, v2,
                                                         tables))
    assert torch.equal(a, b)


def test_cpu_runs_plain_version_and_counts_no_launch():
    rng = np.random.RandomState(3)
    k, v = make_pool(rng, 4, 16)
    tables, ctx = make_tables(rng, [3, None], 4)
    q = rng.randn(2, H, 16).astype(np.float32)
    nn_ops.reset_launch_counts()
    args = torch_inputs(q, k, v, tables, ctx)
    assert torch.equal(nn_ops.paged_attention(*args),
                       nn_ops.paged_attention_ref(*args))
    qp = torch.from_numpy(rng.randn(1, H, 3, 16).astype(np.float32))
    nn_ops.paged_prefill_attention(qp, qp, qp, *args[1:3], args[3][:1])
    assert nn_ops.launch_counts() == {'paged_attention': 0,
                                      'paged_prefill_attention': 0,
                                      'flash_attention_fwd': 0,
                                      'flash_attention_bwd_dkv': 0,
                                      'flash_attention_bwd_dq': 0,
                                      'conv1x1_bn_act': 0}


def test_multi_query_read_is_a_later_slice():
    q = torch.zeros(2, H, 3, 16)
    k = torch.zeros(H, 4, 4, 16)
    with pytest.raises(NotImplementedError, match='spec_decode'):
        nn_ops.paged_attention(q, k, k, torch.zeros(2, 4, dtype=torch.int32),
                               torch.ones(2, dtype=torch.int32))
