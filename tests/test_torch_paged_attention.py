"""Paged attention of the PyTorch port (paddle_tpu_torch/ops/nn_ops.py)
against the JAX package's ops on the CPU.

On CPU tensors the port's wrappers run their plain versions; the JAX ops run
their XLA formulation (the CPU backend never reaches the Pallas kernels).
Both get the same numpy inputs made from a seed: ragged contexts including 1
and the full padded context, inactive slots on the scratch block, and stale
data in blocks no table owns. Tolerance atol 1e-5, rtol 1e-5: f32 sums taken
in another order; the verify read and the quantized pools at atol 1e-6.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.ops import nn_ops as jax_ops
from paddle_tpu_torch.ops import nn_ops
from torch_jax_seed import jax_seed_pinned  # noqa: F401  (caps threads)

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
    """The (S, H, K, D) read of speculative decoding is ported (ROADMAP
    A.5): it matches the JAX op on the CPU, row j of a slot attending
    context + j keys, with an inactive slot and a slot at the table's end
    (its padded rows past the table are masked garbage in both)."""
    rng = np.random.RandomState(11)
    bs, d, kq = 4, 16, 3
    k, v = make_pool(rng, bs, d)
    tables, ctx = make_tables(rng, [2, None, MAXBPS * bs - 1, 5], bs)
    q = rng.randn(4, H, kq, d).astype(np.float32)
    ref = np.asarray(jax_ops.paged_attention(q, k, v, tables, ctx,
                                             sm_scale=0.25))
    got = nn_ops.paged_attention(*torch_inputs(q, k, v, tables, ctx),
                                 sm_scale=0.25)
    assert got.shape == (4, H, kq, d)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_F32, rtol=0)


# --- the verify read, quantized pools (ROADMAP A.5, A.6) --------------------

# attention outputs against the JAX op at f32: 1e-6 absolute (ROADMAP C.4
# item 1: the reference's own decode rows part by up to 4.8e-7)
ATOL_F32 = 1e-6


def quantize(k, v, payload):
    """(k_pages, v_pages, k_scales, v_scales) as numpy for the JAX op and
    torch for the port, from one f32 pool stored at ``payload``: bf16 as
    its rounded values (exact in both), int8 through the port's codec."""
    from paddle_tpu_torch.parallel.quant_collectives import rowwise_quantize
    import jax.numpy as jnp
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if payload == 'bf16':
        kb, vb = kt.bfloat16(), vt.bfloat16()
        return ((jnp.asarray(kb.float().numpy()).astype(jnp.bfloat16),
                 jnp.asarray(vb.float().numpy()).astype(jnp.bfloat16),
                 None, None), (kb, vb, None, None))
    (kq, ks), (vq, vs) = rowwise_quantize(kt), rowwise_quantize(vt)
    ks[:, 0] = 0                  # the scratch block: unwritten rows
    vs[:, 0] = 0
    return ((kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()),
            (kq, vq, ks, vs))


@pytest.mark.parametrize('kq', [2, 4])
@pytest.mark.parametrize('bs', [4, 16])
@pytest.mark.parametrize('d', [16, 64])
def test_verify_read_matches_jax(kq, bs, d):
    rng = np.random.RandomState(kq * 1000 + bs * 10 + d)
    full = MAXBPS * bs
    lens = [1, None, full - kq + 1, bs + 1, 3, full - 1]
    k, v = make_pool(rng, bs, d)
    tables, ctx = make_tables(rng, lens, bs)
    q = rng.randn(len(lens), H, kq, d).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    ref = np.asarray(jax_ops.paged_attention(q, k, v, tables, ctx,
                                             sm_scale=scale))
    got = nn_ops.paged_attention(*torch_inputs(q, k, v, tables, ctx),
                                 sm_scale=scale)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_F32, rtol=0)


@pytest.mark.parametrize('payload', ['bf16', 'int8'])
@pytest.mark.parametrize('kq', [1, 4])
@pytest.mark.parametrize('bs', [4, 16])
def test_decode_over_quantized_pools_matches_jax(payload, kq, bs):
    """The single-query and the verify read over bf16 and int8 pools: both
    packages dequantize after the gather."""
    rng = np.random.RandomState(bs * 7 + kq)
    d = 16
    full = MAXBPS * bs
    lens = [1, None, full - kq + 1, bs + 1, 3]
    k, v = make_pool(rng, bs, d)
    tables, ctx = make_tables(rng, lens, bs)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = quantize(k, v, payload)
    shape = (len(lens), H, kq, d) if kq > 1 else (len(lens), H, d)
    q = rng.randn(*shape).astype(np.float32)
    ref = np.asarray(jax_ops.paged_attention(q, jk, jv, tables, ctx, jks,
                                             jvs, sm_scale=0.25))
    qt, bt, cl = torch_inputs(q, tables, ctx)
    got = nn_ops.paged_attention(qt, tk, tv, bt, cl, tks, tvs,
                                 sm_scale=0.25)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_F32, rtol=0)


@pytest.mark.parametrize('payload', ['bf16', 'int8'])
@pytest.mark.parametrize('bs', [4, 16])
def test_prefill_over_quantized_pools_matches_jax(payload, bs):
    rng = np.random.RandomState(bs * 3 + len(payload))
    d = 16
    k, v = make_pool(rng, bs, d)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = quantize(k, v, payload)
    for lq in (1, bs + 3, MAXBPS * bs):
        tables, _ = make_tables(rng, [lq], bs)
        q = rng.randn(1, H, lq, d).astype(np.float32)
        ref = np.asarray(jax_ops.paged_prefill_attention(
            q, q, q, jk, jv, tables, jks, jvs, sm_scale=0.25))
        qt, bt = torch_inputs(q, tables)
        got = nn_ops.paged_prefill_attention(qt, qt, qt, tk, tv, bt, tks,
                                             tvs, sm_scale=0.25)
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_F32, rtol=0)


@pytest.mark.parametrize('payload', ['f32', 'bf16', 'int8'])
def test_card_verify_rows_are_in_range_and_k1_rows(payload):
    """The rows the card path launches K1 on (``verify_rows``): slot-major,
    each table a copy of its slot's, each context c + j clamped to max_bps *
    BS, so every table entry a row reads lies in the pool; and the plain
    single-query version over those rows is the multi-query read, row for
    row, where c + j stays inside the table."""
    rng = np.random.RandomState(5)
    bs, d, kq = 4, 16, 4
    full = MAXBPS * bs
    k, v = make_pool(rng, bs, d)
    lens = [full, None, full - 2, 1, bs]
    tables, ctx = make_tables(rng, lens, bs)
    q = torch.from_numpy(rng.randn(len(lens), H, kq, d).astype(np.float32))
    bt, cl = torch_inputs(tables, ctx)
    rows, rt, rc = nn_ops.verify_rows(q, bt, cl, full)
    assert rows.shape == (len(lens) * kq, H, d) and rows.is_contiguous()
    assert rt.dtype == rc.dtype == torch.int32
    assert torch.equal(rt, bt.repeat_interleave(kq, dim=0))
    want = np.minimum(ctx[:, None] + np.arange(kq), full).reshape(-1)
    assert rc.numpy().tolist() == want.tolist()
    assert rc.min() >= 1 and rc.max() <= full
    for r, c in zip(rt.numpy(), rc.numpy()):
        read = r[:-(-int(c) // bs)]
        assert ((read >= 0) & (read < k.shape[1])).all()
    if payload == 'f32':
        tk, tv, tks, tvs = torch.from_numpy(k), torch.from_numpy(v), None, None
    else:
        _, (tk, tv, tks, tvs) = quantize(k, v, payload)
    single = nn_ops.paged_attention_ref(rows, tk, tv, rt, rc, tks, tvs)
    multi = nn_ops.paged_attention_ref(q, tk, tv, bt, cl, tks, tvs)
    inside = (cl[:, None] + torch.arange(kq) <= full).reshape(-1)
    np.testing.assert_allclose(
        single[inside].numpy(),
        multi.transpose(1, 2).reshape(-1, H, d)[inside].numpy(),
        atol=ATOL_F32, rtol=0)
