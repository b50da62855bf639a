"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test takes the ``cuda`` fixture, which skips when no
card is present (decided at run time, never at import). Run them on a
machine with a card and the CUDA toolkit:

    python -m pytest tests/test_torch_gpu.py -m gpu

Paged kernels: atol 2e-5, rtol 1e-5: f32 throughout, sums taken in another
order than the plain version's matmuls. Flash kernels: f32 as the paged ones
for O and the row statistics, atol 1e-4 and rtol 1e-4 for the gradients (sums
of up to Sq * D f32 products of O(1) terms in another order); bf16 atol 1e-3
and rtol 8e-3: kernel and plain version both sum in f32 (the kernel's
tensor-core products carry P and dS as two bf16 terms, about 16 bits) and
round once to bf16, so they differ by about one bf16 ulp (at most 2**-7
relative) where the two sums straddle a rounding boundary.

K4 (fused 1x1 conv + BN affine + act): f32 atol 1e-4 and rtol 1e-4 (sums
of up to 2048 f32 products in another order); bf16 within one bf16 ulp of
the larger of the two values, plus 1e-5 absolute for values that ReLU cuts
at zero: kernel and plain version both sum the exact bf16 products in f32
and round once, so they differ only where the two f32 sums straddle a
rounding boundary. ResNet-50 on the card against the CPU: rtol 1e-4 (f32
throughout, TF32 off, sums in another order).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import nn_ops
import torch_jax_seed  # noqa: F401  (caps torch's threads)

ATOL, RTOL = 2e-5, 1e-5
# the paged decode kernel's key range and its CTAs of one slot and head
# (kSplitKeys, kMaxCluster in csrc/paged_attention.cu, which the tier-1
# tests/test_torch_flash_layout.py pins to these values)
DECODE_SPLIT_KEYS, DECODE_MAX_RANKS = 64, 8

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from paddle_tpu_torch import resolve_device
    return resolve_device('cuda')


def pool(rng, h, nb, bs, d, dev):
    """Non-zero data in every block: free blocks hold stale rows."""
    k = rng.standard_normal((h, nb, bs, d), np.float32)
    v = rng.standard_normal((h, nb, bs, d), np.float32)
    return torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)


def tables_for(rng, contexts, bs, nb, max_bps):
    free = list(rng.permutation(np.arange(1, nb)))
    tables = np.zeros((len(contexts), max_bps), np.int32)
    ctx = []
    for i, c in enumerate(contexts):
        if c is None:                  # inactive slot: scratch, context 1
            ctx.append(1)
            continue
        n = -(-c // bs)
        tables[i, :n] = [free.pop() for _ in range(n)]
        ctx.append(c)
    return tables, np.asarray(ctx, np.int32)


@pytest.mark.parametrize('d,bs', [(16, 4), (32, 1), (64, 16), (128, 48)])
def test_decode_kernel_matches_plain(cuda, d, bs):
    rng = np.random.default_rng(d + bs)
    h, max_bps = 4, 8
    full = max_bps * bs
    contexts = [1, None, full, bs + 1, 3, full - 1, None, 2 * bs]
    nb = 2 + sum(-(-c // bs) for c in contexts if c)
    k, v = pool(rng, h, nb, bs, d, cuda)
    tables, ctx = tables_for(rng, contexts, bs, nb, max_bps)
    bt, cl = torch.from_numpy(tables).to(cuda), torch.from_numpy(ctx).to(cuda)
    q = torch.from_numpy(
        rng.standard_normal((len(contexts), h, d), np.float32)).to(cuda)
    before = nn_ops.paged_attention.launches
    got = nn_ops.paged_attention(q, k, v, bt, cl, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert nn_ops.paged_attention.launches == before + 1
    want = nn_ops.paged_attention_ref(q, k, v, bt, cl, sm_scale=d ** -0.5)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('max_keys', [200, 1100])
@pytest.mark.parametrize('bs', [1, 16])
@pytest.mark.parametrize('d', [16, 32, 64, 128])
def test_decode_kernel_split_edges(cuda, d, bs, max_keys):
    """The split-context kernel at its range edges: contexts 0 (a zero
    row), 1, exactly one range (64 keys), one key past it, exactly one
    CTA's span and one key past it, and the full max_bps * BS. At 200
    padded keys each of 4 CTAs takes one range; at 1100, 18 ranges, each of
    the 8 CTAs of a cluster takes 3 in turn. Two launches bitwise equal
    (the served replay contract)."""
    split, ranks = DECODE_SPLIT_KEYS, DECODE_MAX_RANKS
    rng = np.random.default_rng(7 * d + bs + max_keys)
    h = 3
    max_bps = -(-max_keys // bs)
    full = max_bps * bs
    ranges = -(-full // split)
    span = -(-ranges // min(ranges, ranks)) * split
    contexts = [0, 1, split, split + 1, span, span + 1, full, full - 1]
    nb = 2 + sum(-(-c // bs) for c in contexts)
    k, v = pool(rng, h, nb, bs, d, cuda)
    tables, ctx = tables_for(rng, contexts, bs, nb, max_bps)
    bt, cl = torch.from_numpy(tables).to(cuda), torch.from_numpy(ctx).to(cuda)
    q = torch.from_numpy(
        rng.standard_normal((len(contexts), h, d), np.float32)).to(cuda)
    before = nn_ops.paged_attention.launches
    got = nn_ops.paged_attention(q, k, v, bt, cl, sm_scale=d ** -0.5)
    again = nn_ops.paged_attention(q, k, v, bt, cl, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert nn_ops.paged_attention.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = nn_ops.paged_attention_ref(q, k, v, bt, cl, sm_scale=d ** -0.5)
    torch.testing.assert_close(got[1:], want[1:], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('d,bs', [(16, 4), (32, 1), (64, 16), (128, 48)])
@pytest.mark.parametrize('lq', [1, 16, 33, 64, 256])
def test_prefill_kernel_matches_plain(cuda, d, bs, lq):
    rng = np.random.default_rng(d * lq + bs)
    h = 4
    max_bps = -(-(lq + 8) // bs)
    nb = 2 * max_bps + 2
    k, v = pool(rng, h, nb, bs, d, cuda)
    tables, _ = tables_for(rng, [lq + 8, lq], bs, nb, max_bps)
    bt = torch.from_numpy(tables).to(cuda)
    q = torch.from_numpy(
        rng.standard_normal((2, h, lq, d), np.float32)).to(cuda)
    before = nn_ops.paged_prefill_attention.launches
    got = nn_ops.paged_prefill_attention(q, q, q, k, v, bt,
                                         sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert nn_ops.paged_prefill_attention.launches == before + 1
    want = nn_ops.paged_prefill_attention_ref(q, k, v, bt, sm_scale=d ** -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


# K2's key split (csrc/paged_attention.cu): 16-row query tiles, the tile's
# causal keys cut into one range a warp (8 warps, 4 at D 128), 32 keys a
# chunk. Lq 1 and 16 leave warps without keys, 33 puts a tile's split past
# one key a warp, 255 and 256 are the top rung with and without a ragged
# tile; BS 1, 16 and 48 put block edges inside, at and across chunks.
@pytest.mark.parametrize('bs', [1, 16, 48])
@pytest.mark.parametrize('d', [16, 32, 64, 128])
@pytest.mark.parametrize('lq', [1, 16, 33, 64, 255, 256])
def test_prefill_key_split_matches_plain(cuda, lq, d, bs):
    rng = np.random.default_rng(1000 * d + 10 * bs + lq)
    h = 2
    max_bps = -(-(lq + 5) // bs)
    nb = max_bps + 3
    k, v = pool(rng, h, nb, bs, d, cuda)
    tables, _ = tables_for(rng, [lq + 5], bs, nb, max_bps)
    bt = torch.from_numpy(tables).to(cuda)
    q = torch.from_numpy(
        rng.standard_normal((1, h, lq, d), np.float32)).to(cuda)
    got = nn_ops.paged_prefill_attention(q, q, q, k, v, bt,
                                         sm_scale=d ** -0.5)
    want = nn_ops.paged_prefill_attention_ref(q, k, v, bt, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('d', [64, 128])
def test_prefill_kernel_is_bitwise_repeatable(cuda, d):
    rng = np.random.default_rng(d)
    bs, lq, h = 16, 256, 8
    max_bps = lq // bs + 2
    k, v = pool(rng, h, 2 * max_bps + 1, bs, d, cuda)
    tables, _ = tables_for(rng, [lq + 20], bs, 2 * max_bps + 1, max_bps)
    bt = torch.from_numpy(tables).to(cuda)
    q = torch.from_numpy(
        rng.standard_normal((1, h, lq, d), np.float32)).to(cuda)
    a = nn_ops.paged_prefill_attention(q, q, q, k, v, bt, sm_scale=0.125)
    b = nn_ops.paged_prefill_attention(q, q, q, k, v, bt, sm_scale=0.125)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    k = torch.zeros(2, 4, 4, 16, device=cuda)
    bt = torch.zeros(3, 2, dtype=torch.int32, device=cuda)
    cl = torch.ones(3, dtype=torch.int32, device=cuda)
    q = torch.zeros(3, 2, 16, device=cuda)
    with pytest.raises(TypeError, match='float16'):
        nn_ops.paged_attention(q, k.half(), k.half(), bt, cl)
    with pytest.raises(TypeError):
        nn_ops.paged_attention(q, k, k.bfloat16(), bt, cl)
    with pytest.raises(TypeError):
        nn_ops.paged_attention(q, k, k, bt.long(), cl)
    with pytest.raises(ValueError, match='expected cuda'):
        nn_ops.paged_attention(q, k.cpu(), k.cpu(), bt, cl)
    with pytest.raises(ValueError, match='head_dim'):
        k6 = torch.zeros(2, 4, 4, 6, device=cuda)
        nn_ops.paged_attention(torch.zeros(3, 2, 6, device=cuda), k6, k6,
                               bt, cl)
    with pytest.raises(ValueError, match='contiguous'):
        nn_ops.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                               k, k, bt, cl)
    with pytest.raises(ValueError, match='Lq'):
        q9 = torch.zeros(1, 2, 9, 16, device=cuda)
        nn_ops.paged_prefill_attention(q9, q9, q9, k, k, bt[:1])


# --- quantized pools and the verify read (K1 and K2 over bf16 / int8) -----

PAYLOADS = ['f32', 'bf16', 'int8']


def quantized(k, v, payload):
    """(k_pages, v_pages, k_scales, v_scales) of an f32 pool stored at
    ``payload`` as the KV cache stores it; int8's scratch block keeps scale
    0 (unwritten rows)."""
    from paddle_tpu_torch.parallel.quant_collectives import rowwise_quantize
    if payload == 'f32':
        return k, v, None, None
    if payload == 'bf16':
        return k.bfloat16(), v.bfloat16(), None, None
    (kq, ks), (vq, vs) = rowwise_quantize(k), rowwise_quantize(v)
    ks[:, 0] = 0
    vs[:, 0] = 0
    return kq, vq, ks.contiguous(), vs.contiguous()


@pytest.mark.parametrize('payload', ['bf16', 'int8'])
@pytest.mark.parametrize('d,bs', [(16, 4), (32, 1), (64, 16), (128, 48)])
def test_decode_kernel_over_quantized_pools_matches_plain(cuda, d, bs,
                                                          payload):
    """K1 dequantizes each row as it loads it: against the plain version's
    gather-then-dequantize at f32's tolerance, two launches bitwise
    equal."""
    rng = np.random.default_rng(3 * d + bs)
    h, max_bps = 4, 8
    full = max_bps * bs
    contexts = [1, None, full, bs + 1, 3, full - 1, None, 2 * bs]
    nb = 2 + sum(-(-c // bs) for c in contexts if c)
    kp, vp, ks, vs = quantized(*pool(rng, h, nb, bs, d, cuda), payload)
    tables, ctx = tables_for(rng, contexts, bs, nb, max_bps)
    bt, cl = torch.from_numpy(tables).to(cuda), torch.from_numpy(ctx).to(cuda)
    q = torch.from_numpy(
        rng.standard_normal((len(contexts), h, d), np.float32)).to(cuda)
    before = nn_ops.paged_attention.launches
    got = nn_ops.paged_attention(q, kp, vp, bt, cl, ks, vs,
                                 sm_scale=d ** -0.5)
    again = nn_ops.paged_attention(q, kp, vp, bt, cl, ks, vs,
                                   sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert nn_ops.paged_attention.launches == before + 2
    assert torch.equal(got, again)
    want = nn_ops.paged_attention_ref(q, kp, vp, bt, cl, ks, vs,
                                      sm_scale=d ** -0.5)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('payload', ['bf16', 'int8'])
@pytest.mark.parametrize('d,bs', [(16, 4), (32, 1), (64, 16), (128, 48)])
@pytest.mark.parametrize('lq', [1, 33, 256])
def test_prefill_kernel_over_quantized_pools_matches_plain(cuda, lq, d, bs,
                                                           payload):
    rng = np.random.default_rng(d * lq + 7 * bs)
    h = 4
    max_bps = -(-(lq + 8) // bs)
    nb = 2 * max_bps + 2
    kp, vp, ks, vs = quantized(*pool(rng, h, nb, bs, d, cuda), payload)
    tables, _ = tables_for(rng, [lq + 8, lq], bs, nb, max_bps)
    bt = torch.from_numpy(tables).to(cuda)
    q = torch.from_numpy(
        rng.standard_normal((2, h, lq, d), np.float32)).to(cuda)
    before = nn_ops.paged_prefill_attention.launches
    got = nn_ops.paged_prefill_attention(q, q, q, kp, vp, bt, ks, vs,
                                         sm_scale=d ** -0.5)
    again = nn_ops.paged_prefill_attention(q, q, q, kp, vp, bt, ks, vs,
                                           sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert nn_ops.paged_prefill_attention.launches == before + 2
    assert torch.equal(got, again)
    want = nn_ops.paged_prefill_attention_ref(q, kp, vp, bt, ks, vs,
                                              sm_scale=d ** -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('payload', PAYLOADS)
@pytest.mark.parametrize('d,bs', [(16, 4), (64, 16), (128, 48)])
def test_verify_read_is_single_query_k1_at_each_context(cuda, d, bs,
                                                        payload):
    """The (S, H, K, D) read goes through K1 in one launch, its row j of a
    slot bitwise equal to a single-query launch at context c + j (clamped
    to max_bps * BS), and within f32's tolerance of the plain multi-query
    version; padded lanes near the end of a table stay finite."""
    rng = np.random.default_rng(5 * d + bs)
    h, max_bps, kq = 4, 8, 4
    full = max_bps * bs
    contexts = [1, None, full - 1, full, bs + 1, 3, full - 2, 2 * bs]
    nb = 2 + sum(-(-c // bs) for c in contexts if c)
    kp, vp, ks, vs = quantized(*pool(rng, h, nb, bs, d, cuda), payload)
    tables, ctx = tables_for(rng, contexts, bs, nb, max_bps)
    bt, cl = torch.from_numpy(tables).to(cuda), torch.from_numpy(ctx).to(cuda)
    q = torch.from_numpy(rng.standard_normal((len(contexts), h, kq, d),
                                             np.float32)).to(cuda)
    before = nn_ops.paged_attention.launches
    got = nn_ops.paged_attention(q, kp, vp, bt, cl, ks, vs,
                                 sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert nn_ops.paged_attention.launches == before + 1
    assert got.shape == q.shape and torch.isfinite(got).all()
    for j in range(kq):
        single = nn_ops.paged_attention(
            q[:, :, j].contiguous(), kp, vp, bt,
            (cl + j).clamp(max=full).int(), ks, vs, sm_scale=d ** -0.5)
        torch.cuda.synchronize()
        assert torch.equal(got[:, :, j], single), j
    # rows whose context stays within the table, against the plain version
    want = nn_ops.paged_attention_ref(q, kp, vp, bt, cl, ks, vs,
                                      sm_scale=d ** -0.5)
    inside = (cl[:, None] + torch.arange(kq, device=cuda)) <= full
    torch.testing.assert_close(got.transpose(1, 2)[inside],
                               want.transpose(1, 2)[inside],
                               atol=ATOL, rtol=RTOL)


def test_wrappers_reject_wrong_scale_arguments(cuda):
    """No fallback: scales that do not match the pool's payload, shape or
    device, or a query rank the kernels do not take, raise on the card."""
    k = torch.zeros(2, 4, 4, 16, device=cuda)
    k8 = k.to(torch.int8)
    sc = torch.ones(2, 4, 4, device=cuda)
    bt = torch.zeros(3, 2, dtype=torch.int32, device=cuda)
    cl = torch.ones(3, dtype=torch.int32, device=cuda)
    q = torch.zeros(3, 2, 16, device=cuda)
    with pytest.raises(ValueError, match='v_scales is missing'):
        nn_ops.paged_attention(q, k8, k8, bt, cl, sc)
    with pytest.raises(ValueError, match='k_scales is missing'):
        nn_ops.paged_attention(q, k8, k8, bt, cl, None, sc)
    with pytest.raises(ValueError, match='k_scales given'):
        nn_ops.paged_attention(q, k, k, bt, cl, sc, sc)
    with pytest.raises(ValueError, match='k_scales given'):
        nn_ops.paged_attention(q, k.bfloat16(), k.bfloat16(), bt, cl, sc, sc)
    with pytest.raises(ValueError, match='k_scales must be'):
        nn_ops.paged_attention(q, k8, k8, bt, cl, sc.cpu(), sc)
    with pytest.raises(ValueError, match='v_scales must be'):
        nn_ops.paged_attention(q, k8, k8, bt, cl, sc, sc[:, :2])
    with pytest.raises(ValueError, match='k_scales must be'):
        nn_ops.paged_attention(q, k8, k8, bt, cl, sc.double(), sc)
    with pytest.raises(ValueError, match='v_scales is missing'):
        q4 = torch.zeros(1, 2, 4, 16, device=cuda)
        nn_ops.paged_prefill_attention(q4, q4, q4, k8, k8, bt[:1], sc)
    with pytest.raises(ValueError, match='S, H, K, D'):
        nn_ops.paged_attention(q[None, :, :, None], k, k, bt, cl)


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_served_engine_with_speculation_over_quantized_pools(cuda, kv_dtype):
    """A tiny engine on the card with speculative decoding over a quantized
    pool: every prefill, decode step and verify round launches the kernels,
    and the speculative streams equal the lockstep ones on the same pool."""
    from paddle_tpu_torch.serving import DecodeEngine, DecodeScheduler
    from paddle_tpu_torch.serving.tier.replica import build_lm
    model = build_lm('tiny', 3, cuda)
    prompts = [[5, 9, 2], list(range(1, 17)), [7, 7, 7, 7]]

    def run(**kw):
        engine = DecodeEngine(model, slots=4, block_size=4, max_blocks=64,
                              max_prompt_len=16, max_new_tokens_cap=16,
                              kv_dtype=kv_dtype, **kw)
        nn_ops.reset_launch_counts()
        with DecodeScheduler(engine) as sched:
            outs = [sched.submit(p, max_new_tokens=12).result(120)
                    for p in prompts]
        layers = model.cfg.num_hidden_layers
        counts = nn_ops.launch_counts()
        assert counts['paged_attention'] == (engine.stats['decode_steps']
                                             * layers)
        assert counts['paged_prefill_attention'] == (
            engine.stats['prefills'] * layers)
        assert engine.pool.allocator.used == 0
        return outs, engine.stats

    lockstep, _ = run()
    spec, stats = run(spec_decode=True, spec_k=4)
    assert stats['spec_rounds'] > 0
    # the verify rows' attention is the lockstep rows' bit for bit; the
    # model's GEMMs at (S * K) rows may round otherwise than at S, so a
    # token may part only at a near tie of the lockstep engine's own rows
    engine = DecodeEngine(model, slots=4, block_size=4, max_blocks=64,
                          max_prompt_len=16, max_new_tokens_cap=16,
                          kv_dtype=kv_dtype)
    for p, a, b in zip(prompts, spec, lockstep):
        assert len(a) == len(b) == 12
        if a != b:
            assert lockstep_gaps(engine, p, a).max() <= 1e-3, (a, b)


def lockstep_gaps(engine, prompt, tokens):
    """Teacher-forced gaps of ``tokens`` under ``engine``'s lockstep path:
    for each token, its row's max logit less the token's."""
    table = engine.reserve_table(len(prompt), len(tokens))
    rows = []
    engine.prefill(prompt, table, sampler=lambda r: rows.append(r) or 0)
    pad = [None] * (engine.slots - 1)
    for tok in tokens[:-1]:
        _, step = engine.decode_step([tok] + pad, [table] + pad,
                                     return_rows=True)
        rows.append(step[0])
    engine.release_table(table)
    rows = np.stack(rows)
    return rows.max(-1) - rows[np.arange(len(tokens)), tokens]


def test_served_engine_goes_through_the_kernels(cuda):
    """A tiny engine on the card: every attention layer of every prefill
    and decode step launches a kernel, and the greedy stream agrees with
    the uncached reference under teacher forcing."""
    from paddle_tpu_torch.models.causal_lm import max_logit_gaps
    from paddle_tpu_torch.serving import DecodeEngine, DecodeScheduler
    from paddle_tpu_torch.serving.tier.replica import build_lm
    model = build_lm('tiny', 3, cuda)
    engine = DecodeEngine(model, slots=4, block_size=4, max_blocks=64,
                          max_prompt_len=16, max_new_tokens_cap=16)
    nn_ops.reset_launch_counts()
    prompts = [[5, 9, 2], list(range(1, 17)), [7]]
    with DecodeScheduler(engine) as sched:
        outs = [sched.submit(p, max_new_tokens=12).result(120)
                for p in prompts]
    layers = model.cfg.num_hidden_layers
    assert nn_ops.launch_counts() == {
        'paged_attention': engine.stats['decode_steps'] * layers,
        'paged_prefill_attention': engine.stats['prefills'] * layers,
        'flash_attention_fwd': 0, 'flash_attention_bwd_dkv': 0,
        'flash_attention_bwd_dq': 0, 'conv1x1_bn_act': 0}
    for p, out in zip(prompts, outs):
        gaps = max_logit_gaps(model, p, out, pad_len=engine.padded_context)
        assert gaps.max() <= 1e-3


# --- flash attention (csrc/flash_attention.cu) ------------------------------

FLASH_TOL = {torch.float32: {'o': (2e-5, 1e-5), 'grad': (1e-4, 1e-4)},
             torch.bfloat16: {'o': (1e-3, 8e-3), 'grad': (1e-3, 8e-3)}}
# (B, H, Sq, Sk): two tiles and a ragged edge; Sq != Sk both ways
FLASH_SHAPES = {'none': (2, 3, 80, 80), 'mask': (2, 3, 80, 80),
                'full': (2, 3, 80, 80), 'causal': (2, 3, 130, 130),
                'sq_ne_sk': (2, 3, 40, 100), 'causal_sq_gt_sk': (1, 2, 100, 70)}


def flash_inputs(kind, d, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    b, h, sq, sk = FLASH_SHAPES[kind]

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, dtype)

    q, k, v, do = t(b, h, sq, d), t(b, h, sk, d), t(b, h, sk, d), \
        t(b, h, sq, d)
    bias = None
    if kind == 'mask':
        keep = rng.random((b, 1, 1, sk)) < 0.7
        bias = torch.from_numpy(np.where(keep, 0.0, -1e4).astype(
            np.float32)).to(dev)
    elif kind == 'full':
        bias = torch.from_numpy(
            rng.standard_normal((b, h, sq, sk), np.float32)).to(dev)
    return q, k, v, do, bias, kind.startswith('causal')


def close(got, want, tol):
    atol, rtol = tol
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize('kind', list(FLASH_SHAPES))
@pytest.mark.parametrize('d', [16, 32, 64, 128])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_flash_forward_matches_plain(cuda, kind, d, dtype):
    q, k, v, _, bias, causal = flash_inputs(kind, d, dtype, cuda)
    before = nn_ops.flash_attention_fwd.launches
    o, stats = nn_ops.flash_attention_fwd(q, k, v, bias, sm_scale=d ** -0.5,
                                        causal=causal)
    torch.cuda.synchronize()
    assert nn_ops.flash_attention_fwd.launches == before + 1
    assert o.dtype == dtype and stats.dtype == torch.float32
    o_ref, stats_ref = nn_ops.fused_attention_fwd_ref(
        q, k, v, bias, sm_scale=d ** -0.5, causal=causal)
    close(o, o_ref, FLASH_TOL[dtype]['o'])
    close(stats, stats_ref, FLASH_TOL[torch.float32]['o'])
    if dtype == torch.float32:      # and the op's own XLA formulation
        close(o, nn_ops.fused_attention_ref(q, k, v, bias, sm_scale=d ** -0.5,
                                            causal=causal), (2e-5, 1e-5))


@pytest.mark.parametrize('kind', list(FLASH_SHAPES))
@pytest.mark.parametrize('d', [16, 32, 64, 128])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_flash_gradients_match_plain(cuda, kind, d, dtype):
    """The backward kernels, through the autograd Function, against the
    plain backward run on the forward kernel's own saved O and log-sum-exp
    (fed the plain forward's bf16 O, di = rowsum(O . dO) would carry O's
    one-ulp rounding differences into every gradient); dbias where the
    bias takes a gradient. In f32 the whole kernel chain is also held
    against the whole plain chain."""
    q, k, v, do, bias, causal = flash_inputs(kind, d, dtype, cuda, seed=1)
    kw = {'sm_scale': d ** -0.5, 'causal': causal}
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if bias is not None:
        leaves.append(bias.clone().requires_grad_())
    args = leaves + [None] * (4 - len(leaves))
    before = dict(nn_ops.launch_counts())
    o = nn_ops.fused_attention(*args, **kw)
    o.backward(do)
    torch.cuda.synchronize()
    after = nn_ops.launch_counts()
    for name in ('flash_attention_fwd', 'flash_attention_bwd_dkv',
                 'flash_attention_bwd_dq'):
        assert after[name] == before[name] + 1
    o_k, stats_k = nn_ops.flash_attention_fwd(q, k, v, bias, **kw)
    assert torch.equal(o_k, o.detach())          # deterministic
    wants = [nn_ops.fused_attention_bwd_ref(q, k, v, bias, o_k, stats_k, do,
                                            **kw)]
    if dtype == torch.float32:
        o_ref, stats = nn_ops.fused_attention_fwd_ref(q, k, v, bias, **kw)
        wants.append(nn_ops.fused_attention_bwd_ref(q, k, v, bias, o_ref,
                                                    stats, do, **kw))
    tol = FLASH_TOL[dtype]['grad']
    for dq, dk, dv, ds in wants:
        for got, want in zip(leaves[:3], (dq, dk, dv)):
            assert got.grad.dtype == dtype
            close(got.grad, want, tol)
        if bias is not None:
            close(leaves[3].grad, nn_ops._sum_to(ds, bias.shape), tol)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_flash_dq_writes_ds_for_a_head_broadcast_bias(cuda, dtype):
    """A (B, 1, Sq, Sk) bias, broadcast over heads, that takes a gradient:
    dQ writes dS for every head from its accumulators, and the Function
    sums it over the heads into dbias."""
    rng = np.random.default_rng(9)
    b, h, sq, sk, d = 2, 3, 80, 100, 64
    q = torch.from_numpy(rng.standard_normal((b, h, sq, d), np.float32)
                         ).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((b, h, sk, d), np.float32)
                             ).to(cuda, dtype) for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((b, h, sq, d), np.float32)
                          ).to(cuda, dtype)
    bias = torch.from_numpy(rng.standard_normal((b, 1, sq, sk), np.float32)
                            ).to(cuda)
    kw = {'sm_scale': d ** -0.5}
    o, stats = nn_ops.flash_attention_fwd(q, k, v, bias, **kw)
    di = nn_ops._row_dot(o, do)
    dq, ds = nn_ops.flash_attention_bwd_dq(q, k, v, bias, stats, di, do,
                                           need_ds=True, **kw)
    want = nn_ops.fused_attention_bwd_ref(q, k, v, bias, o, stats, do, **kw)
    tol = FLASH_TOL[dtype]['grad']
    close(dq, want[0], tol)
    close(ds, want[3], FLASH_TOL[torch.float32]['grad'] if dtype ==
          torch.float32 else tol)
    leaf = bias.clone().requires_grad_()
    nn_ops.fused_attention(q, k, v, leaf, **kw).backward(do)
    assert leaf.grad.shape == (b, 1, sq, sk)
    close(leaf.grad, nn_ops._sum_to(want[3], bias.shape), tol)


def test_flash_dq_writes_the_score_gradient(cuda):
    q, k, v, do, bias, _ = flash_inputs('full', 32, torch.float32, cuda, 2)
    o, stats = nn_ops.fused_attention_fwd_ref(q, k, v, bias, sm_scale=0.2)
    di = nn_ops._row_dot(o, do)
    dq, ds = nn_ops.flash_attention_bwd_dq(q, k, v, bias, stats, di, do,
                                           sm_scale=0.2, need_ds=True)
    _, _, _, ds_ref = nn_ops.fused_attention_bwd_ref(q, k, v, bias, o, stats,
                                                     do, sm_scale=0.2)
    close(ds, ds_ref, FLASH_TOL[torch.float32]['grad'])
    assert nn_ops.flash_attention_bwd_dq(q, k, v, bias, stats, di, do,
                                         sm_scale=0.2)[1] is None


def test_flash_reads_strided_head_views(cuda):
    """The projections' (B, S, H*D) outputs viewed as (B, H, S, D) are read
    in place, and give what their contiguous copies give."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 48, 4 * 64), np.float32)
                         ).to(cuda)
    q = x.reshape(2, 48, 4, 64).transpose(1, 2)
    assert not q.is_contiguous()
    o, stats = nn_ops.flash_attention_fwd(q, q, q, sm_scale=0.125)
    oc, statsc = nn_ops.flash_attention_fwd(q.contiguous(), q.contiguous(),
                                          q.contiguous(), sm_scale=0.125)
    assert torch.equal(o, oc) and torch.equal(stats, statsc)


def flash_chain(leaves, do, bias, causal, dtype):
    """Run the autograd Function on ``leaves`` (q, k, v, each a leaf or a
    view of one) and hold O, the log-sum-exp and the gradients of q, k and
    v against the plain versions, as test_flash_gradients_match_plain
    does: the plain backward runs on the forward kernel's own O and
    log-sum-exp. Returns the gradients (dq, dk, dv) the Function gave."""
    q, k, v = leaves
    d = q.shape[-1]
    kw = {'sm_scale': d ** -0.5, 'causal': causal}
    for t in (q, k, v):
        t.retain_grad()
    before = dict(nn_ops.launch_counts())
    o = nn_ops.fused_attention(q, k, v, bias, **kw)
    o.backward(do)
    torch.cuda.synchronize()
    after = nn_ops.launch_counts()
    for name in nn_ops.FLASH_KINDS:
        assert after[name] == before[name] + 1
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o_k, stats_k = nn_ops.flash_attention_fwd(qd, kd, vd, bias, **kw)
    assert torch.equal(o_k, o.detach())
    o_ref, stats_ref = nn_ops.fused_attention_fwd_ref(qd, kd, vd, bias, **kw)
    close(o_k, o_ref, FLASH_TOL[dtype]['o'])
    close(stats_k, stats_ref, FLASH_TOL[torch.float32]['o'])
    want = nn_ops.fused_attention_bwd_ref(qd, kd, vd, bias, o_k, stats_k, do,
                                          **kw)
    for t, ref in zip((q, k, v), want):
        assert t.grad.dtype == dtype
        close(t.grad, ref, FLASH_TOL[dtype]['grad'])
    return q.grad, k.grad, v.grad


def test_flash_bert_head_views_through_the_function(cuda):
    """BERT-base's head shape (B 2, H 12, S 128, D 64, bf16), q, k and v
    the head-split views of one fused (B, S, 3 * H * D) projection, read in
    place by the kernels, with BertModel's (B, 1, 1, S) mask bias."""
    rng = np.random.default_rng(4)
    b, h, s, d = 2, 12, 128, 64
    x = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d), np.float32)
                         ).to(cuda, torch.bfloat16).requires_grad_()
    q, k, v = (x[..., i * h * d:(i + 1) * h * d].reshape(b, s, h, d)
               .transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    keep = rng.random((b, 1, 1, s)) < 0.85
    keep[..., 0] = True
    bias = torch.from_numpy(np.where(keep, 0.0, -1e4).astype(np.float32)
                            ).to(cuda)
    do = torch.from_numpy(rng.standard_normal((b, h, s, d), np.float32)
                          ).to(cuda, torch.bfloat16)
    dq, dk, dv = flash_chain([q, k, v], do, bias, False, torch.bfloat16)
    # the views' gradients land in the fused projection's gradient
    for i, g in enumerate((dq, dk, dv)):
        assert torch.equal(x.grad[..., i * h * d:(i + 1) * h * d],
                           g.transpose(1, 2).reshape(b, s, h * d))


@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
@pytest.mark.parametrize('s', [1, 65, 129])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_flash_ragged_by_one(cuda, s, dtype, causal):
    """One row or key past a tile (S 65, 129) and a single one (S 1)."""
    rng = np.random.default_rng(5)

    def t():
        return torch.from_numpy(rng.standard_normal((2, 3, s, 64), np.float32)
                                ).to(cuda, dtype)

    leaves = [t().requires_grad_() for _ in range(3)]
    flash_chain(leaves, t(), None, causal, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_flash_kernels_are_deterministic(cuda, dtype):
    """Two launches of the forward and of dK/dV on the same inputs give
    bitwise the same O, row statistics, dK and dV: every output row is
    owned by one warp and summed in one order, with no atomics."""
    q, k, v, do, bias, _ = flash_inputs('mask', 64, dtype, cuda, seed=6)
    kw = {'sm_scale': 0.125}
    o1, stats1 = nn_ops.flash_attention_fwd(q, k, v, bias, **kw)
    o2, stats2 = nn_ops.flash_attention_fwd(q, k, v, bias, **kw)
    assert torch.equal(o1, o2) and torch.equal(stats1, stats2)
    di = nn_ops._row_dot(o1, do)
    dk1, dv1 = nn_ops.flash_attention_bwd_dkv(q, k, v, bias, stats1, di, do,
                                              **kw)
    dk2, dv2 = nn_ops.flash_attention_bwd_dkv(q, k, v, bias, stats1, di, do,
                                              **kw)
    torch.cuda.synchronize()
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_flash_dq_is_deterministic(cuda, dtype):
    """Two launches of dQ, with dS written, give bitwise the same dQ and
    dS: each warp owns its rows' dQ, nothing is atomic."""
    q, k, v, do, bias, _ = flash_inputs('full', 64, dtype, cuda, seed=6)
    kw = {'sm_scale': 0.125}
    o, stats = nn_ops.flash_attention_fwd(q, k, v, bias, **kw)
    di = nn_ops._row_dot(o, do)
    dq1, ds1 = nn_ops.flash_attention_bwd_dq(q, k, v, bias, stats, di, do,
                                             need_ds=True, **kw)
    dq2, ds2 = nn_ops.flash_attention_bwd_dq(q, k, v, bias, stats, di, do,
                                             need_ds=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dq1, dq2) and torch.equal(ds1, ds2)


@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_flash_rows_masked_by_finfo_min(cuda, dtype, causal):
    """A (B, 1, 1, S) bias of finfo.min on some keys of batch row 0 and on
    every key of batch row 1, at S 130 (a ragged tile), taking a gradient.
    Times log2 e such a bias leaves the f32 range; the kernels keep every
    output finite. Through the autograd Function, O and the gradients of
    q, k, v and the bias are held to ``fused_attention_ref``'s autograd on
    the same values in f32, the JAX op's formulation: the softmax weighs
    every key of row 1 alike (under causal the keys past the diagonal too,
    which its mask fills with finfo.min as well); in bf16 the gradients on
    row 1, and all of them against the plain backward on the forward
    kernel's own O (row 0's di = rowsum(O . dO) carries O's bf16 rounding,
    as in flash_chain). The row statistics match the plain forward's: max
    finfo.min and log S on row 1."""
    rng = np.random.default_rng(7)
    b, h, s, d = 2, 3, 130, 64

    def t():
        return torch.from_numpy(rng.standard_normal((b, h, s, d), np.float32)
                                ).to(cuda, dtype)

    q, k, v, do = t(), t(), t(), t()
    keep = rng.random((b, 1, 1, s)) < 0.7
    keep[0, ..., 0] = True
    keep[1] = False
    bias = torch.from_numpy(np.where(keep, 0.0, np.finfo(np.float32).min)
                            .astype(np.float32)).to(cuda)
    kw = {'sm_scale': d ** -0.5, 'causal': causal}
    tol = FLASH_TOL[dtype]
    leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
    o = nn_ops.fused_attention(*leaves, **kw)
    o.backward(do)
    torch.cuda.synchronize()
    refs = [x.float().requires_grad_() for x in (q, k, v, bias)]
    o_ref = nn_ops.fused_attention_ref(*refs, **kw)
    o_ref.backward(do.float())
    close(o.detach(), o_ref.detach(), tol['o'])
    rows = slice(None) if dtype == torch.float32 else slice(1, 2)
    for got, want in zip(leaves, refs):
        close(got.grad[rows], want.grad[rows], tol['grad'])
    o_k, stats = nn_ops.flash_attention_fwd(q, k, v, bias, **kw)
    _, stats_ref = nn_ops.fused_attention_fwd_ref(q, k, v, bias, **kw)
    close(stats, stats_ref, FLASH_TOL[torch.float32]['o'])
    assert (stats[0, 1] == torch.finfo(torch.float32).min).all()
    dq, dk, dv, ds = nn_ops.fused_attention_bwd_ref(q, k, v, bias, o_k, stats,
                                                    do, **kw)
    for got, want in zip(leaves, (dq, dk, dv, nn_ops._sum_to(ds, bias.shape))):
        close(got.grad, want, tol['grad'])


def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 32, device=cuda)
    with pytest.raises(TypeError, match='f32 or bf16'):
        nn_ops.fused_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match='k is'):
        nn_ops.fused_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match='head_dim'):
        q48 = torch.zeros(1, 2, 8, 48, device=cuda)
        nn_ops.fused_attention(q48, q48, q48)
    with pytest.raises(ValueError, match='broadcast'):
        nn_ops.fused_attention(q, q, q, torch.zeros(1, 3, 8, 8, device=cuda))
    with pytest.raises(ValueError, match='expected cuda'):
        nn_ops.fused_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match='CUDA tensors'):
        nn_ops.flash_attention_fwd(q.cpu(), q.cpu(), q.cpu())
    stats = torch.zeros(2, 1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match='stats'):
        nn_ops.flash_attention_bwd_dq(q, q, q, None, stats.double(), stats[0],
                                      q)


def test_tiny_train_step_goes_through_the_flash_kernels(cuda):
    """Every attention layer of every bf16-AMP training step launches the
    forward kernel once and each backward kernel once, and the loss falls
    on a repeated batch."""
    from paddle_tpu_torch.convert import (bert_init_params,
                                          bert_state_dict_from_paddle)
    from paddle_tpu_torch.dygraph import TrainStep
    from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                              pretrain_loss)
    from paddle_tpu_torch.optimizer import Adam
    cfg = BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.use_fused_attention = True
    model = BertForPretraining(cfg, device=cuda)
    model.load_state_dict(bert_state_dict_from_paddle(
        bert_init_params(cfg, 0)))
    step = TrainStep(model, pretrain_loss,
                     Adam(1e-3, parameter_list=list(model.parameters())),
                     amp_dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (4, 32))
    mlm = np.where(rng.rand(4, 32) < 0.15,
                   rng.randint(0, cfg.vocab_size, (4, 32)), -1)
    batch = (ids, np.zeros((4, 32), np.int64), mlm,
             rng.randint(0, 2, (4, 1)))
    nn_ops.reset_launch_counts()
    losses = [float(step(*batch)) for _ in range(3)]
    n = cfg.num_hidden_layers * 3
    counts = nn_ops.launch_counts()
    assert (counts['flash_attention_fwd'], counts['flash_attention_bwd_dkv'],
            counts['flash_attention_bwd_dq']) == (n, n, n)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_multi_tensor_adam_gives_adams_bits_on_the_card(cuda):
    """The _foreach kernels compute the one-tensor op's arithmetic: the
    same bits for every parameter and slot."""
    from paddle_tpu_torch.ops.optimizer_ops import adam, multi_tensor_adam
    rng = np.random.default_rng(5)
    shapes = [(768, 768), (3072,), (2, 30522)]
    init = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]

    def state():
        ps = [torch.from_numpy(a).to(cuda) for a in init]
        return ps, [[torch.zeros_like(p), torch.zeros_like(p),
                     torch.full((1,), 0.9, device=cuda),
                     torch.full((1,), 0.999, device=cuda)] for p in ps]

    one, one_s = state()
    many, many_s = state()
    for step in range(3):
        gs = [torch.from_numpy((rng.standard_normal(sh) * 10.0 ** rng.integers(
            -9, 0, sh)).astype(np.float32)).to(cuda) for sh in shapes]
        for p, s, g in zip(one, one_s, gs):
            adam(p, g, *s, 1e-4)
        multi_tensor_adam(many, gs, *(list(c) for c in zip(*many_s)), 1e-4)
    for a, b in zip(one + [t for s in one_s for t in s],
                    many + [t for s in many_s for t in s]):
        assert torch.equal(a, b)


# (B, H, W, C, O): ResNet-50's bottleneck shapes at batch 128 x 224^2
# (tools/bench_fused_conv.py's four reduce convs and an expand conv), and
# odd ones: M off the 128-row tile, C 6 / O 5 (unaligned, scalar loads),
# K 2048 with O off the 64-column tile, K not a multiple of the K slice
K4_SHAPES = [(128, 56, 56, 256, 64), (128, 28, 28, 512, 128),
             (128, 14, 14, 1024, 256), (128, 7, 7, 2048, 512),
             (128, 56, 56, 64, 256), (2, 8, 8, 16, 12), (1, 4, 4, 6, 5),
             (3, 7, 5, 2048, 33), (1, 3, 43, 72, 130), (1, 1, 1, 1, 1)]


def k4_inputs(shape, dtype, dev, seed=0):
    b, h, w, c, o = shape
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    return (t(rng.standard_normal((b, h, w, c))),
            t(rng.standard_normal((o, c, 1, 1)) * c ** -0.5),
            t(rng.random(o) + 0.5), t(rng.standard_normal(o) * 0.1))


def assert_within_bf16_ulp(got, want, atol=1e-5):
    """|got - want| <= one bf16 ulp of the larger magnitude + atol."""
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs())
    _, e = torch.frexp(big)
    ulp = torch.ldexp(torch.ones_like(big), e - 8)
    err = (got - want).abs()
    assert bool((err <= ulp + atol).all()), (
        f'max |diff| {err.max().item():.3e}, beyond one bf16 ulp at '
        f'{int((err > ulp + atol).sum())} elements')


@pytest.mark.parametrize('act', [None, 'relu'], ids=['none', 'relu'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('shape', K4_SHAPES, ids=str)
def test_conv1x1_kernel_matches_plain(cuda, shape, dtype, act):
    from paddle_tpu_torch.ops import pallas_conv
    x, w, sc, sh = k4_inputs(shape, dtype, cuda)
    before = pallas_conv.conv1x1_bn_act.launches
    got = pallas_conv.fused_conv1x1_bn_act(x, w, sc, sh, act=act)
    torch.cuda.synchronize()
    assert pallas_conv.conv1x1_bn_act.launches == before + 1
    assert got.shape == shape[:3] + (shape[4],) and got.dtype == dtype
    assert got.is_contiguous()
    want = pallas_conv.fused_conv1x1_bn_act_ref(x, w, sc, sh, act=act)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert_within_bf16_ulp(got, want)


def test_conv1x1_kernel_is_bitwise_repeatable(cuda):
    from paddle_tpu_torch.ops import pallas_conv
    for dtype in (torch.float32, torch.bfloat16):
        x, w, sc, sh = k4_inputs((4, 14, 14, 1024, 256), dtype, cuda, 1)
        a = pallas_conv.conv1x1_bn_act(x, w, sc, sh, act='relu')
        b = pallas_conv.conv1x1_bn_act(x, w, sc, sh, act='relu')
        assert torch.equal(a, b)


# (B, H, W, C, O) of ResNet-50's 12 distinct stride-1 1x1 layers, at batch
# 8 (every M at least four 128-row tiles)
K4_PATH_SHAPES = [(8, 56, 56, 64, 64), (8, 56, 56, 64, 256),
                  (8, 56, 56, 256, 64), (8, 56, 56, 256, 128),
                  (8, 28, 28, 128, 512), (8, 28, 28, 512, 128),
                  (8, 28, 28, 512, 256), (8, 14, 14, 256, 1024),
                  (8, 14, 14, 1024, 256), (8, 14, 14, 1024, 512),
                  (8, 7, 7, 512, 2048), (8, 7, 7, 2048, 512)]


@pytest.mark.parametrize('act', [None, 'relu'], ids=['none', 'relu'])
@pytest.mark.parametrize('shape', K4_PATH_SHAPES, ids=str)
def test_conv1x1_wgmma_body_at_the_path_shapes(cuda, shape, act):
    from paddle_tpu_torch.ops import pallas_conv
    x, w, sc, sh = k4_inputs(shape, torch.bfloat16, cuda, 4)
    plan = pallas_conv.conv1x1_plan(x, w, sc, sh)
    assert plan['body'] == 'wgmma'
    before = (pallas_conv.conv1x1_bn_act.launches,
              pallas_conv.conv1x1_bn_act.launches_wgmma)
    got = pallas_conv.fused_conv1x1_bn_act(x, w, sc, sh, act=act)
    torch.cuda.synchronize()
    assert (pallas_conv.conv1x1_bn_act.launches,
            pallas_conv.conv1x1_bn_act.launches_wgmma) == (
                before[0] + 1, before[1] + 1)
    assert_within_bf16_ulp(
        got, pallas_conv.fused_conv1x1_bn_act_ref(x, w, sc, sh, act=act))


@pytest.mark.parametrize('batch', [8, 128])
def test_conv1x1_tiles_at_the_path_shapes(cuda, batch):
    """The wgmma body at every path shape, 64 tile columns where O <= 64
    and 128 elsewhere, a persistent grid of min(tiles, SMs) CTAs."""
    from paddle_tpu_torch.ops import pallas_conv
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for _, hh, ww, c, o in K4_PATH_SHAPES:
        x, w, sc, sh = (torch.empty(s, dtype=torch.bfloat16, device=cuda)
                        for s in ((batch, hh, ww, c), (o, c, 1, 1), (o,),
                                  (o,)))
        plan = pallas_conv.conv1x1_plan(x, w, sc, sh)
        bn = 64 if o <= 64 else 128
        tiles = -(-batch * hh * ww // 128) * -(-o // bn)
        assert plan == {'body': 'wgmma', 'bn': bn,
                        'grid': min(tiles, sms),
                        'stages': 8 if bn == 64 else 6}, (c, o, plan)


@pytest.mark.parametrize('shape,dtype,body', [
    ((2, 8, 8, 16, 16), torch.bfloat16, 'wgmma'),    # K < one 64-deep slice
    ((2, 8, 8, 16, 12), torch.bfloat16, 'wmma'),     # N % 8 != 0
    ((1, 4, 4, 6, 8), torch.bfloat16, 'wmma'),       # K % 8 != 0
    ((1, 3, 43, 72, 136), torch.bfloat16, 'wgmma'),  # M, N off the tile
    ((1, 3, 43, 72, 130), torch.bfloat16, 'wmma'),
    ((3, 7, 5, 2048, 40), torch.bfloat16, 'wgmma'),
    ((3, 7, 5, 2048, 33), torch.bfloat16, 'wmma'),
    ((1, 1, 1, 8, 8), torch.bfloat16, 'wgmma'),
    ((1, 1, 1, 1, 1), torch.bfloat16, 'wmma'),
    ((2, 8, 8, 16, 16), torch.float32, 'f32')], ids=str)
def test_conv1x1_launcher_picks_the_body_by_shape(cuda, shape, dtype, body):
    from paddle_tpu_torch.ops import pallas_conv
    x, w, sc, sh = k4_inputs(shape, dtype, cuda, 5)
    assert pallas_conv.conv1x1_plan(x, w, sc, sh)['body'] == body
    before = pallas_conv.conv1x1_bn_act.launches_wgmma
    got = pallas_conv.conv1x1_bn_act(x, w, sc, sh, act='relu')
    torch.cuda.synchronize()
    assert (pallas_conv.conv1x1_bn_act.launches_wgmma - before
            == int(body == 'wgmma'))
    want = pallas_conv.fused_conv1x1_bn_act_ref(x, w, sc, sh, act='relu')
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        assert_within_bf16_ulp(got, want)


def test_conv1x1_launcher_takes_unaligned_operands_to_wmma(cuda):
    """A view of x one element into its storage is not 16-byte aligned,
    which TMA needs: the WMMA body takes it."""
    from paddle_tpu_torch.ops import pallas_conv
    x, w, sc, sh = k4_inputs((2, 8, 8, 64, 64), torch.bfloat16, cuda, 6)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xu = flat[1:].view(x.shape)
    xu.copy_(x)
    assert pallas_conv.conv1x1_plan(xu, w, sc, sh)['body'] == 'wmma'
    assert pallas_conv.conv1x1_plan(x, w, sc, sh)['body'] == 'wgmma'
    got = pallas_conv.conv1x1_bn_act(xu, w, sc, sh)
    torch.cuda.synchronize()
    assert_within_bf16_ulp(got, pallas_conv.fused_conv1x1_bn_act_ref(
        x, w, sc, sh))


@pytest.mark.parametrize('shape', [(8, 7, 7, 2048, 512), (8, 56, 56, 64, 256),
                                   (8, 14, 14, 1024, 256)], ids=str)
def test_conv1x1_wgmma_body_is_bitwise_repeatable(cuda, shape):
    from paddle_tpu_torch.ops import pallas_conv
    x, w, sc, sh = k4_inputs(shape, torch.bfloat16, cuda, 7)
    assert pallas_conv.conv1x1_plan(x, w, sc, sh)['body'] == 'wgmma'
    a = pallas_conv.conv1x1_bn_act(x, w, sc, sh, act='relu')
    b = pallas_conv.conv1x1_bn_act(x, w, sc, sh, act='relu')
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize('body,bn', [('wmma', 64), ('f32', 64),
                                     ('wgmma', 64), ('wgmma', 128)])
def test_conv1x1_kernel_info_reports_each_body(cuda, body, bn):
    from paddle_tpu_torch.ops import pallas_conv
    info = pallas_conv.conv1x1_kernel_info(body, bn)
    assert info['ctas_per_sm'] >= 1 and info['registers'] > 0
    if body == 'wgmma':
        assert info['threads'] == 384 and info['dynamic_smem'] > 48 * 1024


def test_conv1x1_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from paddle_tpu_torch.ops import pallas_conv
    x, w, sc, sh = k4_inputs((2, 8, 8, 16, 12), torch.float32, cuda)
    with pytest.raises(ValueError, match='contiguous'):
        pallas_conv.fused_conv1x1_bn_act(x.transpose(1, 2), w, sc, sh)
    with pytest.raises(ValueError, match='1x1'):
        pallas_conv.fused_conv1x1_bn_act(
            x, torch.zeros(12, 16, 3, 3, device=cuda), sc, sh)
    with pytest.raises(TypeError, match='one type'):
        pallas_conv.conv1x1_bn_act(x, w, sc.bfloat16(), sh)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        pallas_conv.conv1x1_bn_act(x.half(), w.half(), sc.half(), sh.half())
    with pytest.raises(ValueError, match='scale'):
        pallas_conv.fused_conv1x1_bn_act(x, w, sc[:11], sh)
    with pytest.raises(ValueError, match='NHWC'):
        pallas_conv.fused_conv1x1_bn_act(x, w, sc, sh, data_format='NCHW')
    with pytest.raises(ValueError, match='CUDA tensors'):
        pallas_conv.conv1x1_bn_act(x.cpu(), w.cpu(), sc.cpu(), sh.cpu())


def _resnet_losses(named, x, y, dev, steps=3):
    from paddle_tpu_torch.convert import resnet_state_dict_from_paddle
    from paddle_tpu_torch.dygraph import TrainStep
    from paddle_tpu_torch.models import ResNet50
    from paddle_tpu_torch.ops.loss_ops import softmax_with_cross_entropy
    from paddle_tpu_torch.optimizer import Momentum

    def loss_fn(model, x, y):
        loss, _ = softmax_with_cross_entropy(model(x).float(), y)
        return loss.mean()

    model = ResNet50(10, 'NHWC', device=dev)
    model.load_state_dict(resnet_state_dict_from_paddle(named, 'NHWC'))
    step = TrainStep(model, loss_fn, Momentum(
        0.01, momentum=0.9, parameter_list=list(model.parameters())))
    return np.array([float(step(x, y)) for _ in range(steps)]), model


def test_resnet50_f32_steps_on_the_card_match_the_cpu(cuda):
    """Three f32 Momentum(0.01) steps at batch 4, 32x32, TF32 off. At this
    size the model is ill-conditioned (tests/test_torch_resnet.py: f32
    rounding moves even the first loss by ~3e-4 at batch 4, and the
    trajectory is chaotic from the second step on), so the card's losses
    must stay within 4x the CPU's own spread when its images move by 1e-7
    relative, plus rtol 1e-4."""
    from paddle_tpu_torch.convert import resnet_init_params
    named = resnet_init_params(50, 10, 'NHWC', 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (4, 1))
    moved = (x * (1 + 1e-7 * rng.standard_normal(x.shape))).astype(
        np.float32)
    want, _ = _resnet_losses(named, torch.from_numpy(x),
                             torch.from_numpy(y), 'cpu')
    spread, _ = _resnet_losses(named, torch.from_numpy(moved),
                               torch.from_numpy(y), 'cpu')
    got, _ = _resnet_losses(named, torch.from_numpy(x).to(cuda),
                            torch.from_numpy(y).to(cuda), cuda)
    err, own = np.abs(got - want).max(), np.abs(spread - want).max()
    assert err <= 4 * own + 1e-4 * np.abs(want).max(), (got, want, spread)


def test_resnet50_eval_pass_launches_k4_on_every_1x1_layer(cuda):
    """The 33 stride-1 1x1 ConvBNLayers of an eval forward, each folded
    and run through K4: 33 launches, each output within atol and rtol
    1e-4 of the layer's own (f32)."""
    from paddle_tpu_torch.convert import (resnet_init_params,
                                          resnet_state_dict_from_paddle)
    from paddle_tpu_torch.models import ResNet50
    from paddle_tpu_torch.models.resnet import ConvBNLayer
    from paddle_tpu_torch.ops import pallas_conv
    model = ResNet50(10, 'NHWC', device=cuda)
    model.load_state_dict(resnet_state_dict_from_paddle(
        resnet_init_params(50, 10, 'NHWC', 2), 'NHWC'))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)).to(cuda)
    with torch.no_grad():
        model.train()(x)                   # running statistics of a batch
    model.eval()
    layers = [m for m in model.modules() if isinstance(m, ConvBNLayer)
              and tuple(m._conv.weight.shape[2:]) == (1, 1)
              and m._conv._attrs['stride'] == 1]
    assert len(layers) == 33
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[0], out)))
        for m in layers]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    before = pallas_conv.conv1x1_bn_act.launches
    for m, xin, want in seen:
        bn = m._bn
        scale = bn.weight / torch.sqrt(bn._variance_buf + 1e-5)
        shift = bn.bias - bn._mean_buf * scale
        with torch.no_grad():
            got = pallas_conv.fused_conv1x1_bn_act(xin, m._conv.weight,
                                                   scale, shift, act=m._act)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert pallas_conv.conv1x1_bn_act.launches == before + 33


def test_static_lenet_on_the_card_matches_the_cpu(cuda):
    """MNIST LeNet on the static graph (build_static_lenet + Adam(0.001),
    batch 64, f32) through Executor(CUDAPlace(0)) against the same programs
    on Executor(CPUPlace()) from the card's startup values: the first
    step's loss, accuracy and every @GRAD, then three more losses, within
    atol 1e-5, rtol 1e-4 (TF32 off, sums in another order), as
    chip_smoke.py holds them; one lowering of the main program."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.convert import scope_from_paddle
    from paddle_tpu_torch.models.lenet import build_static_lenet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data('img', [1, 28, 28], dtype='float32')
        label = fluid.layers.data('label', [1], dtype='int64')
        loss, acc, _ = build_static_lenet(img, label)
        fluid.optimizer.Adam(learning_rate=0.001).minimize(loss)
    rng = np.random.default_rng(4)
    feed = {'img': rng.random((64, 1, 28, 28), dtype=np.float32),
            'label': rng.integers(0, 10, (64, 1))}
    gpu, gscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gpu.run(startup, scope=gscope)
    cpu, cscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    persist = [v.name for v in main.list_vars() if v.persistable]
    scope_from_paddle({n: gscope.find(n).cpu().numpy() for n in persist},
                      cscope, fluid.CPUPlace(), program=main)
    fetch = [loss, acc] + [p.name + '@GRAD' for p in main.all_parameters()]
    for step in range(4):
        got = gpu.run(main, feed=feed, fetch_list=fetch if step == 0
                      else [loss], scope=gscope)
        want = cpu.run(main, feed=feed, fetch_list=fetch if step == 0
                       else [loss], scope=cscope)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)
    assert gpu.lowering_count(main) == 1
    assert gscope.find('fc_0.w_0').device.type == 'cuda'


def test_transformer_tiny_card_matches_cpu(cuda):
    """The tiny NMT Transformer on the dygraph API, the same numpy weights
    under guard(CUDAPlace(0)) and guard(CPUPlace()), f32, TF32 off:
    logits within atol 1e-5 (sums in another order), the loss within rtol
    1e-4, greedy tokens equal, no kernel of the port launched. One
    Adam(NoamDecay(32, 4)) step moves each entry by about lr whatever its
    gradient's size, so a gradient at round-off level (the attention key
    biases, which softmax ignores) takes a step of round-off sign: the
    parameters after it are held, per tensor, within 4 times the CPU's own
    spread (the CPU run again from weights one f32 ulp away) plus 1e-4 of
    the tensor's largest value, as tests/test_torch_transformer.py holds
    the port against the JAX package."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.convert import transformer_init_params
    from paddle_tpu_torch.models import transformer as pt
    cfg = pt.TransformerConfig.tiny(dropout=0.0)
    named = transformer_init_params(cfg, 0)
    rng = np.random.default_rng(1)
    nudged = {n: (a * (1 + rng.choice([-1.0, 1.0], a.shape) * 2.0 ** -23)
                  ).astype(np.float32) for n, a in named.items()}
    rs = np.random.RandomState(0)
    src, trg, lbl = (rs.randint(1, 64, (3, 16)) for _ in range(3))
    out = {}
    nn_ops.reset_launch_counts()
    for key, place, weights in (('card', fluid.CUDAPlace(0), named),
                                ('cpu', fluid.CPUPlace(), named),
                                ('spread', fluid.CPUPlace(), nudged)):
        with dygraph.guard(place):
            m = pt.Transformer(cfg)
            m.set_dict(weights)
            opt = fluid.optimizer.Adam(
                learning_rate=dygraph.NoamDecay(32, 4),
                parameter_list=m.parameters())
            logits = m(dygraph.to_variable(src), dygraph.to_variable(trg))
            loss = pt.transformer_loss(logits, dygraph.to_variable(lbl))
            loss.backward()
            opt.minimize(loss)
            m.clear_gradients()
            m.eval()
            out[key] = (logits.numpy(), float(loss.numpy()),
                        {n: t.numpy() for n, t in m.state_dict().items()},
                        pt.greedy_decode(m, src, 1, 2, max_len=8))
    assert set(nn_ops.launch_counts().values()) == {0}
    got, want, spread = out['card'], out['cpu'], out['spread']
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    for n, w in want[2].items():
        err = np.abs(got[2][n] - w).max()
        own = np.abs(spread[2][n] - w).max()
        assert err <= 4 * own + 1e-4 * np.abs(w).max(), (n, err, own)
    np.testing.assert_array_equal(got[3], want[3])


def test_ernie_tiny_card_matches_cpu(cuda):
    """ERNIE finetuning at bench.py's CPU config of ``bench_ernie`` (vocab
    128, hidden 32, 2 layers), batch 4 x 16: the same numpy weights under
    guard(CUDAPlace(0)) and guard(CPUPlace()), four f32
    ``TrainStep(accum_steps=4)`` calls of ``finetune_optimizer`` (Adam 1e-3
    with L2Decay 0.01 and a linear warm-up, ``decorate``), that is one
    update: every call's loss within rtol 1e-4 (TF32 off, sums in another
    order), no kernel of the port launched (the default unfused
    attention). The parameters after the update are held, per tensor,
    within 4 times the CPU's own spread (the CPU run again from weights
    one f32 ulp away) plus 1e-4 of the tensor's largest value, as
    ``test_transformer_tiny_card_matches_cpu`` holds them: Adam steps a
    round-off gradient (the attention key biases) by round-off sign."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.convert import ernie_init_params
    from paddle_tpu_torch.dygraph.jit import TrainStep
    from paddle_tpu_torch.models import ernie
    from paddle_tpu_torch.ops.loss_ops import softmax_with_cross_entropy
    cfg = ernie.ErnieConfig(vocab_size=128, hidden_size=32,
                            num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=64, max_position_embeddings=32,
                            hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
    named = ernie_init_params(cfg, 0)
    rng = np.random.default_rng(1)
    nudged = {n: (a * (1 + rng.choice([-1.0, 1.0], a.shape) * 2.0 ** -23)
                  ).astype(np.float32) for n, a in named.items()}
    rs = np.random.RandomState(0)
    feeds = [(rs.randint(0, 128, (4, 16)), rs.randint(0, 2, (4, 16)),
              rs.randint(0, 2, (4, 1))) for _ in range(4)]

    def loss_fn(m, ids, tt, y):
        loss, _ = softmax_with_cross_entropy(m(ids, tt).float(), y)
        return loss.mean()

    out = {}
    nn_ops.reset_launch_counts()
    for key, place, weights in (('card', fluid.CUDAPlace(0), named),
                                ('cpu', fluid.CPUPlace(), named),
                                ('spread', fluid.CPUPlace(), nudged)):
        with dygraph.guard(place):
            m = ernie.ErnieForSequenceClassification(cfg, dropout=0.0)
            m.set_dict(weights)
            opt = ernie.finetune_optimizer(m, 1e-3, warmup_steps=2,
                                           weight_decay=0.01, use_amp=True)
            step = TrainStep(m, loss_fn, opt, accum_steps=4)
            losses = [float(step(*f)) for f in feeds]
            out[key] = (losses, {n: t.numpy()
                                 for n, t in m.state_dict().items()})
    assert set(nn_ops.launch_counts().values()) == {0}
    got, want, spread = out['card'], out['cpu'], out['spread']
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    for n, w in want[1].items():
        err = np.abs(got[1][n] - w).max()
        own = np.abs(spread[1][n] - w).max()
        assert err <= 4 * own + 1e-4 * np.abs(w).max(), (n, err, own)
    moved = np.abs(got[1]['classifier.weight'] - named['classifier.weight'])
    assert moved.max() > 1e-4


@pytest.fixture
def no_tf32():
    """cuDNN convolutions in full f32 for a card-against-CPU check."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = old


def _small_static_resnet(fluid):
    from paddle_tpu_torch.tools import static_resnet
    with fluid.unique_name.guard():
        return static_resnet.build(fluid, class_dim=10,
                                   image_shape=(3, 32, 32),
                                   blocks=[1, 1, 1, 1], width_div=16)


def test_static_resnet_first_step_on_the_card_matches_the_cpu(cuda,
                                                              no_tf32):
    """PaddleCV's static ResNet recipe at test size (one bottleneck a
    stage, width / 16, 10 classes, 32x32, batch 8) through
    CompiledProgram on Executor(CUDAPlace(0)) against Executor(CPUPlace())
    from the card's startup values, TF32 off: the first step's loss within
    rtol 1e-4, top-1 and top-5 equal, every @GRAD within 1e-3 of its
    tensor's largest entry (f32 sums in another order through 13 BN
    layers); no kernel of the port launched; one lowering."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.convert import scope_from_paddle
    main, startup, _, v = _small_static_resnet(fluid)
    rng = np.random.default_rng(5)
    feed = {'image': rng.standard_normal((8, 3, 32, 32), dtype=np.float32),
            'label': rng.integers(0, 10, (8, 1))}
    gpu, gscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gpu.run(startup, scope=gscope)
    cpu, cscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    persist = [x.name for x in main.list_vars() if x.persistable]
    scope_from_paddle({n: gscope.find(n).cpu().numpy() for n in persist},
                      cscope, fluid.CPUPlace(), program=main)
    grads = [p.name + '@GRAD' for p in main.all_parameters()]
    fetch = [v['loss'], v['acc1'], v['acc5']] + grads
    nn_ops.reset_launch_counts()
    step = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v['loss'].name)
    got = gpu.run(step, feed=feed, fetch_list=fetch, scope=gscope)
    want = cpu.run(step, feed=feed, fetch_list=fetch, scope=cscope)
    assert set(nn_ops.launch_counts().values()) == {0}
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert float(got[1]) == float(want[1])
    assert float(got[2]) == float(want[2])
    for name, g, w in zip(grads, got[3:], want[3:]):
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), name
    assert gpu.lowering_count(main) == 1


def test_load_inference_model_puts_every_persistable_on_the_card(cuda,
                                                                 tmp_path):
    import paddle_tpu_torch as fluid
    main, startup, _, v = _small_static_resnet(fluid)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path), ['image'], [v['prob']],
                                      exe, main_program=main)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        prog, _, fetches = fluid.io.load_inference_model(str(tmp_path), exe)
    persist = [x.name for x in prog.list_vars() if x.persistable]
    assert persist
    for n in persist:
        assert scope.find(n).device.type == 'cuda', n
    x = np.random.default_rng(6).standard_normal((4, 3, 32, 32),
                                                 dtype=np.float32)
    out = exe.run(prog, feed={'image': x}, fetch_list=fetches, scope=scope)
    np.testing.assert_allclose(out[0].sum(-1), 1.0, rtol=1e-5)


def test_predictor_runs_on_the_card_by_default(cuda, tmp_path):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference
    main, startup, _, v = _small_static_resnet(fluid)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path), ['image'], [v['prob']],
                                      exe, main_program=main)
    pred = inference.create_paddle_predictor(
        inference.Config(str(tmp_path)))
    assert pred.executor.device.type == 'cuda'
    x = np.random.default_rng(7).standard_normal((4, 3, 32, 32),
                                                 dtype=np.float32)
    a, b = pred.run([x])[0], pred.run({'image': x})[0]
    assert np.array_equal(a, b)
    assert pred.executor.lowering_count(pred.program) == 1


def test_inference_engine_rows_on_the_card_match_the_predictor(cuda,
                                                               tmp_path):
    """The serving engine on the card (its default executor) at every rung
    of max_batch_size 8: each batch's rows against ``Predictor.run`` on the
    same rows, and each row against its single-row run, at atol 1e-5 (the
    softmax outputs of the same f32 model; cuDNN may pick another
    algorithm for each batch size, so bitwise is not promised); the
    padded rows never come back; no kernel of the port launched."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving import InferenceEngine
    main, startup, _, v = _small_static_resnet(fluid)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path), ['image'], [v['prob']],
                                      exe, main_program=main)
    engine = InferenceEngine(str(tmp_path), max_batch_size=8)
    assert engine.device.type == 'cuda'
    pred = inference.Predictor(str(tmp_path))
    rng = np.random.default_rng(8)
    nn_ops.reset_launch_counts()
    for n in (1, 2, 3, 4, 5, 8):
        x = rng.standard_normal((n, 3, 32, 32), dtype=np.float32)
        got = engine.run_batch({'image': x}, n)[0]
        assert got.shape == (n, 10)
        np.testing.assert_allclose(got, pred.run([x])[0], atol=1e-5, rtol=0)
        for i in range(n):
            np.testing.assert_allclose(
                got[i:i + 1], engine.run_batch({'image': x[i:i + 1]}, 1)[0],
                atol=1e-5, rtol=0)
    assert engine.compiled_buckets == [1, 2, 4, 8] and engine.warmed
    assert set(nn_ops.launch_counts().values()) == {0}


# --------------------------------- static control flow and the PTB LM

def test_control_flow_constructs_on_the_card_match_the_cpu(cuda):
    """Each construct of chip_smoke.py's phase 12 (cond, case,
    switch_case, Switch, IfElse, While, while_loop bounded with its
    gradient and unbounded, DynamicRNN with lengths, tensor arrays) on
    Executor(CUDAPlace(0)) against Executor(CPUPlace()): f32 atol and rtol
    1e-6, integers and booleans equal, same shapes and types."""
    import chip_smoke
    chip_smoke.check_control_flow_on_card('test')


@pytest.mark.parametrize('route', ['padding', 'static'])
def test_static_ptb_lm_steps_on_the_card_match_the_cpu(cuda, route):
    """PaddleNLP's PTB LM at test size (vocabulary 50, hidden 16, 2
    layers, 5 steps, batch 4, dropout off) through CompiledProgram on the
    card against the CPU executor from the card's startup values, three
    steps feeding the fetched last states back: losses within rtol 1e-5,
    the states and every @GRAD of the first step within 1e-5 of their
    largest entry; no kernel of the port launched; one lowering. Then with
    dropout 0.65 on the card: finite losses and masks that keep 0.35 of
    the step outputs within 0.1."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.convert import scope_from_paddle
    from paddle_tpu_torch.tools import static_ptb_lm
    kw = dict(vocab_size=50, hidden_size=16, num_layers=2, num_steps=5,
              batch_size=4)
    with fluid.unique_name.guard():
        main, startup, _, v = static_ptb_lm.build(fluid, route, dropout=0.0,
                                                  **kw)
    rng = np.random.default_rng(8)
    feeds = [{'x': rng.integers(0, 50, (4, 5, 1)),
              'y': rng.integers(0, 50, (20, 1))} for _ in range(3)]
    state = 0.1 * rng.standard_normal((2, 2, 4, 16), np.float32)
    gpu, gscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    gpu.run(startup, scope=gscope)
    cpu, cscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    persist = [x.name for x in main.list_vars() if x.persistable]
    scope_from_paddle({n: gscope.find(n).cpu().numpy() for n in persist},
                      cscope, fluid.CPUPlace(), program=main)
    grads = [p.name + '@GRAD' for p in main.all_parameters()]
    step = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=v['loss'].name)
    nn_ops.reset_launch_counts()
    runs = {}
    for name, exe, scope in (('card', gpu, gscope), ('cpu', cpu, cscope)):
        h, c, out = state[0], state[1], []
        for i, f in enumerate(feeds):
            fetch = [v['loss'], v['last_hidden'], v['last_cell']] + (
                grads if i == 0 else [])
            got = exe.run(step, feed={**f, 'init_hidden': h,
                                      'init_cell': c},
                          fetch_list=fetch, scope=scope)
            h, c = got[1], got[2]
            out.append(got)
        runs[name] = out
    assert set(nn_ops.launch_counts().values()) == {0}
    for got, want in zip(runs['card'], runs['cpu']):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        for g, w in zip(got[1:], want[1:]):
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    assert gpu.lowering_count(main) == 1
    with fluid.unique_name.guard():
        main, startup, _, v = static_ptb_lm.build(fluid, route, dropout=0.65,
                                                  **kw)
    with fluid.scope_guard(fluid.Scope()):
        gpu.run(startup)
        scan = next(op for op in main.global_block().ops
                    if op.type == '__scan__')
        fetch = [v['loss']] + ([scan.outputs['Out'][-1]]
                               if route == 'padding' else [])
        out = gpu.run(main, feed={**feeds[0], 'init_hidden': state[0],
                                  'init_cell': state[1]}, fetch_list=fetch)
    assert np.isfinite(out[0])
    if route == 'padding':
        assert abs((out[1] != 0).mean() - 0.35) < 0.1


def test_run_check_and_trainer_steps_on_the_card(cuda, tmp_path):
    """``fluid.install_check.run_check()`` with no place runs on the card;
    three ``contrib.Trainer`` steps of PaddleBook's recognize_digits at
    batch 64 on ``CUDAPlace(0)`` give finite losses, no kernel of the port
    launches, and the Inferencer reading the saved parameters gives the
    test program's softmax within 1e-6 on the same card; with
    ``FLAGS_check_nan_inf`` on, a NaN pixel raises naming the loss."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.tools import recognize_digits as book
    fluid.install_check.run_check()
    nn_ops.reset_launch_counts()
    trainer = fluid.contrib.Trainer(lambda: book.train_program(fluid),
                                    lambda: book.optimizer_func(fluid),
                                    place=fluid.CUDAPlace(0))
    losses = []
    trainer.train(1, lambda e: losses.append(float(e.metrics[0]))
                  if isinstance(e, fluid.contrib.EndStepEvent) else None,
                  reader=book.mnist_reader(0, 3), feed_order=book.FEED_ORDER)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert set(nn_ops.launch_counts().values()) == {0}
    trainer.save_params(str(tmp_path))
    inf = fluid.contrib.Inferencer(lambda: book.inference_program(fluid),
                                   str(tmp_path), place=fluid.CUDAPlace(0))
    rows = next(book.mnist_reader(1, 1)())
    test_program = trainer.train_program.clone(for_test=True)
    block = trainer.train_program.global_block()
    feed = fluid.DataFeeder([block.var(n) for n in book.FEED_ORDER]).feed(
        rows)
    softmax = [op for op in test_program.global_block().ops
               if op.type == 'softmax'][0].output_names()[0]
    want, = trainer.exe.run(test_program, feed=feed, fetch_list=[softmax],
                            scope=trainer.scope)
    got, = inf.infer({'img': feed['img']})
    assert np.abs(got - want).max() <= 1e-6
    fluid.debugging.enable_check_nan_inf()
    try:
        with pytest.raises(FloatingPointError, match=trainer.loss.name):
            trainer.train(1, lambda e: None,
                          reader=book.mnist_reader(0, 1, nan_pixel=True),
                          feed_order=book.FEED_ORDER)
    finally:
        fluid.debugging.enable_check_nan_inf(False)


# ----------------------------------------------- the multi-tensor updates

@pytest.mark.parametrize('rule', ['lamb', 'lars_momentum'])
def test_lamb_and_lars_multi_tensor_forms_match_their_ops(cuda, rule):
    """On the card ``torch._foreach_norm`` sums in another order than the
    per-parameter op's ``torch.linalg.vector_norm``, so the two forms agree
    to f32 round-off of the norms: atol 1e-6, rtol 1e-5. A parameter at
    zero and a zero gradient take the plain rate."""
    from paddle_tpu_torch.ops import optimizer_ops as ops
    gen = torch.Generator(device=cuda).manual_seed(0)
    shapes = [(768, 768), (768,), (3072, 768), (30522, 768), (2,)]
    ps = [torch.randn(s, generator=gen, device=cuda) for s in shapes]
    ps[1].zero_()
    gs = [torch.randn(s, generator=gen, device=cuda) * 1e-2 for s in shapes]
    gs[4].zero_()
    lr = torch.tensor([1e-3], device=cuda)
    if rule == 'lamb':
        slots = [[torch.rand(s, generator=gen, device=cuda) * 1e-3
                  for s in shapes] for _ in range(2)]
        slots += [[torch.tensor([0.9 ** 3], device=cuda) for _ in shapes],
                  [torch.tensor([0.999 ** 3], device=cuda)
                   for _ in shapes]]
        kw = {'weight_decay': 0.01}
    else:
        slots = [[torch.randn(s, generator=gen, device=cuda) * 1e-3
                  for s in shapes]]
        kw = {}
    plain = [getattr(ops, rule)(p, g, *[s[i] for s in slots], lr, **kw)
             for i, (p, g) in enumerate(zip(ps, gs))]
    lists = [[t.clone() for t in col] for col in [ps, gs, *slots]]
    getattr(ops, f'multi_tensor_{rule}')(*lists, lr, **kw)
    updated = [lists[0]] + lists[2:]
    for i, outs in enumerate(plain):
        for k, out in enumerate(outs):
            torch.testing.assert_close(updated[k][i], out, atol=1e-6,
                                       rtol=1e-5)
    assert not torch.equal(updated[0][1], ps[1])


@pytest.mark.parametrize('op', ['conv2d_transpose', 'group_norm',
                                'temporal_shift'])
def test_a4c_ops_on_the_card_match_the_cpu(cuda, op):
    """The dygraph layers slice's ops (torch's own, no kernel of the port)
    on the card against the CPU: forward and every input's gradient at
    atol 1e-4, rtol 1e-4 (f32, TF32 off, sums in another order); the
    shift exactly."""
    from paddle_tpu_torch.ops import tensor_ops
    rng = np.random.default_rng(7)
    cases = {
        'conv2d_transpose': (lambda x, w: nn_ops.conv2d_transpose(
            x, w, stride=2, padding=1), [(16, 32, 8, 8), (32, 16, 4, 4)]),
        'group_norm': (lambda x, s, b: nn_ops.group_norm(x, s, b, groups=8),
                       [(4, 64, 14, 14), (64,), (64,)]),
        'temporal_shift': (lambda x: tensor_ops.temporal_shift(x, seg_num=4),
                           [(8, 16, 7, 7)]),
    }
    fn, shapes = cases[op]
    arrays = [rng.standard_normal(s, np.float32) for s in shapes]
    got, cot = [], None
    for dev in ('cpu', cuda):
        ts = [torch.tensor(a, device=dev, requires_grad=True)
              for a in arrays]
        out = fn(*ts)
        if cot is None:
            cot = rng.standard_normal(tuple(out.shape), np.float32)
        (out * torch.from_numpy(cot).to(dev)).sum().backward()
        got.append([out.detach().cpu()] + [t.grad.cpu() for t in ts])
    tol = (dict(atol=0, rtol=0) if op == 'temporal_shift'
           else dict(atol=1e-4, rtol=1e-4))
    for a, b in zip(got[1], got[0]):
        torch.testing.assert_close(a, b, **tol)
