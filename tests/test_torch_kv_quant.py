"""The port's quantized KV pools (ROADMAP A.6: ``kv_dtype`` 'bf16' and
'int8', paddle_tpu_torch/serving/decode/kv_cache.py and
parallel/quant_collectives.py) against the JAX package's, on the CPU at
``CausalLMConfig.tiny()`` with the reference's geometry (2 slots, block 4,
64 blocks, prompts up to 16; tests/framework/test_kv_quant.py).

Rounding rule. Both packages quantize the same way (absmax / 127, the
reciprocal, round half to even, clip), but their f32 inputs differ by the
f32 sums taken in another order, so a payload entry may be one step apart
where the scaled value lies within that difference of a rounding midpoint
(int8: k + 1/2 of the scaled value; bf16: half an ulp). Such entries are
allowed and counted; every other entry is equal."""
import numpy as np
import pytest
import torch

from paddle_tpu.dygraph import guard
from paddle_tpu.parallel import quant_collectives as jax_quant
from paddle_tpu.serving import DecodeEngine as JaxEngine
from paddle_tpu.serving.tier.replica import build_tiny_lm
from paddle_tpu_torch.convert import state_dict_from_paddle
from paddle_tpu_torch.models import causal_lm as port_lm
from paddle_tpu_torch.parallel.quant_collectives import (rowwise_dequantize,
                                                         rowwise_quantize)
from paddle_tpu_torch.serving import DecodeEngine, DecodeScheduler
from paddle_tpu_torch.serving.decode.kv_cache import (KV_DTYPE_CODES,
                                                      KVCachePool,
                                                      kv_row_bytes)
from torch_jax_seed import jax_seed_pinned  # noqa: F401  (caps threads)

ENGINE_KW = dict(slots=2, block_size=4, max_blocks=64, max_prompt_len=16,
                 max_new_tokens_cap=16)
# the reference's workload and gate (tests/framework/test_kv_quant.py)
WORK = [([7, 3, 11, 5, 9], 8), ([2, 44, 8, 13], 6), ([9] * 7, 10),
        ([1, 2, 3], 5)]
MATCH_RATE = 0.99
MIDPOINT_SLACK = 1e-5


@pytest.fixture(scope='module')
def models():
    """The reference's seeded tiny LM and the port's with its weights."""
    with guard():
        jm = build_tiny_lm()
        named = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
        pm = port_lm.TransformerLM(port_lm.CausalLMConfig.tiny(),
                                   device='cpu')
        pm.load_state_dict(state_dict_from_paddle(named))
        pm.eval()
        yield jm, pm


def run_streams(engine, work=WORK):
    with DecodeScheduler(engine, queue_depth=len(work) + 1) as sched:
        streams = [sched.submit(p, max_new_tokens=m) for p, m in work]
        return [s.result(240) for s in streams]


def off_by_one_where_near_midpoint(got, want, scaled, slack):
    """Assert int8 payloads equal but for entries one step apart whose
    scaled value lies within ``slack`` of a midpoint; returns their
    count."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    near = np.abs(np.abs(scaled - np.trunc(scaled)) - 0.5) < slack
    assert near[diff == 1].all(), scaled[(diff == 1) & ~near][:8]
    return int((diff == 1).sum())


def test_rowwise_quantize_matches_jax():
    rng = np.random.RandomState(0)
    rows = rng.randn(6, 40, 64).astype(np.float32)
    rows[0, 3] = 0.0                              # an all-zero row
    rows[1] *= 1e-3
    rows[2] *= 1e3
    rows[3, :, 5] = 200.0                         # a row max at the clip
    rows[4] = np.round(rows[4] * 4) / 4           # exact halves after scale
    q, scale = rowwise_quantize(torch.from_numpy(rows))
    jq, jscale = jax_quant.rowwise_quantize(rows)
    jq, jscale = np.asarray(jq), np.asarray(jscale)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_allclose(scale.numpy(), jscale, rtol=1e-7, atol=0)
    inv = np.where(jscale > 0, 1.0 / np.where(jscale > 0, jscale, 1.0), 0.0)
    scaled = rows * inv.astype(np.float32)[..., None]
    n = off_by_one_where_near_midpoint(q.numpy(), jq, scaled, MIDPOINT_SLACK)
    print(f'rowwise_quantize: {n} of {q.numel()} entries one step from the '
          f'JAX package\'s, each within {MIDPOINT_SLACK} of a midpoint')
    assert scale[0, 3] == 0 and (q[0, 3] == 0).all()
    back = rowwise_dequantize(q, scale).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jax_quant.rowwise_dequantize(q.numpy(),
                                                      scale.numpy())))
    # round trip within half a step of the row's scale
    assert (np.abs(back - rows)
            <= scale.numpy()[..., None] / 2 * (1 + 1e-6) + 1e-30).all()


def forced_run(engine, prompts, forced):
    """Prefill each prompt into its own slot, then decode under teacher
    forcing (``forced[i][j]`` fed at step j); the pool is left written."""
    tables = []
    for p, f in zip(prompts, forced):
        t = engine.reserve_table(len(p), len(f))
        engine.prefill(p, t, sampler=lambda r, f=f: f[0])
        tables.append(t)
    for j in range(1, len(forced[0])):
        engine.decode_step([f[j - 1] for f in forced], tables)
    return tables


def port_pool(engine, layer):
    k, v = engine.pool.pages(layer)
    return [k.float().numpy(), v.float().numpy()]


def jax_pool(engine, layer):
    return [np.asarray(a).astype(np.float32)
            for a in engine.pool.pages(layer)]


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_pools_match_jax_after_the_same_steps(models, kv_dtype):
    """After the same prefills and teacher-forced steps the two packages'
    quantized pools hold the same payloads and scales under the rounding
    rule, where the slack is what the packages' f32 pools differ by."""
    jm, pm = models
    rng = np.random.RandomState(3)
    prompts = [[int(t) for t in rng.randint(0, 128, n)] for n in (5, 11)]
    forced = [[int(t) for t in rng.randint(0, 128, 6)] for _ in prompts]
    engines = {}
    for dtype in ('f32', kv_dtype):
        engines[dtype] = (JaxEngine(jm, kv_dtype=dtype, **ENGINE_KW),
                          DecodeEngine(pm, kv_dtype=dtype, **ENGINE_KW))
        with guard():
            forced_run(engines[dtype][0], prompts, forced)
        forced_run(engines[dtype][1], prompts, forced)
    jf32, pf32 = engines['f32']
    jq, pq = engines[kv_dtype]
    assert pq.pool.bytes_in_hbm() == jq.pool.bytes_in_hbm()
    moved = 0
    for layer in range(pm.cfg.num_hidden_layers):
        f32_port, f32_jax = port_pool(pf32, layer), jax_pool(jf32, layer)
        for i, (got, want) in enumerate(zip(port_pool(pq, layer),
                                            jax_pool(jq, layer))):
            delta = np.abs(f32_port[i] - f32_jax[i]).max()
            if kv_dtype == 'bf16':
                # one bf16 ulp apart only where the f32 value lies within
                # delta of the midpoint between the two
                diff = got != want
                if diff.any():
                    ulp = np.abs(got - want)[diff]
                    mid = (got[diff] + want[diff]) / 2
                    assert (np.abs(f32_port[i][diff] - mid)
                            <= delta + 1e-30).all()
                    assert (ulp <= np.abs(want[diff]) * 2.0 ** -7).all()
                moved += int(diff.sum())
                continue
            ks, js = (pq.pool.scales(layer)[i].numpy(),
                      np.asarray(jq.pool.scales(layer)[i]))
            np.testing.assert_allclose(ks, js, rtol=1e-7,
                                       atol=delta / 127 + 1e-12)
            inv = np.where(js > 0, 1 / np.where(js > 0, js, 1), 0)
            scaled = f32_port[i] * inv[..., None]
            moved += off_by_one_where_near_midpoint(
                got.astype(np.int8), want.astype(np.int8), scaled,
                MIDPOINT_SLACK + float(delta * inv.max()))
    print(f'{kv_dtype} pools: {moved} payload entries one step from the JAX '
          f'package\'s')


def test_f32_pool_keeps_encode_rows_identity(models):
    _, pm = models
    eng = DecodeEngine(pm, **ENGINE_KW)
    assert eng.pool.dtype == torch.float32 and eng.pool.kv_dtype == 'f32'
    vals = torch.ones(2, 3, 8)
    enc, sc = eng.pool._encode_rows(vals)
    assert enc is vals and sc is None
    refs = [port_lm.greedy_generate(pm, p, m, pad_len=eng.padded_context)
            for p, m in WORK]
    assert run_streams(eng) == refs
    assert all(eng.pool.scales(layer) is None
               for layer in range(eng.pool.num_layers))


def test_kv_dtype_env_strict_parse(models, monkeypatch):
    _, pm = models
    monkeypatch.setenv('PADDLE_TPU_KV_DTYPE', 'fp8')
    with pytest.raises(ValueError, match='PADDLE_TPU_KV_DTYPE') as e:
        DecodeEngine(pm, **ENGINE_KW)
    assert 'int8' in str(e.value)
    for env, storage in (('f32', torch.float32), ('bf16', torch.bfloat16),
                         ('int8', torch.int8)):
        monkeypatch.setenv('PADDLE_TPU_KV_DTYPE', env)
        eng = DecodeEngine(pm, **ENGINE_KW)
        assert eng.pool.kv_dtype == env and eng.pool.dtype == storage
    monkeypatch.setenv('PADDLE_TPU_KV_DTYPE', 'f32')
    assert DecodeEngine(pm, kv_dtype='int8',
                        **ENGINE_KW).pool.kv_dtype == 'int8'
    with pytest.raises(ValueError, match='supported values'):
        KVCachePool(kv_dtype='fp16')
    assert KV_DTYPE_CODES == {'f32': 0, 'bf16': 1, 'int8': 2}
    assert [kv_row_bytes(64, d) for d in ('f32', 'bf16', 'int8')] == [256,
                                                                     128, 68]


@pytest.mark.parametrize('kv_dtype', ['bf16', 'int8'])
def test_quantized_greedy_match_rate(models, kv_dtype):
    """The reference's quality gate: at least 0.99 of the greedy tokens
    equal the f32 reference's (a length difference counts against it)."""
    _, pm = models
    eng = DecodeEngine(pm, kv_dtype=kv_dtype, **ENGINE_KW)
    refs = [port_lm.greedy_generate(pm, p, m, pad_len=eng.padded_context)
            for p, m in WORK]
    outs = run_streams(eng)
    matched = sum(sum(a == b for a, b in zip(o, r))
                  for o, r in zip(outs, refs))
    total = sum(len(r) for r in refs)
    assert matched / total >= MATCH_RATE, (outs, refs)
    if kv_dtype == 'int8':
        assert all(eng.pool.scales(layer) is not None
                   for layer in range(eng.pool.num_layers))
    assert eng.pool.allocator.used == 0
    f32_bytes = DecodeEngine(pm, **ENGINE_KW)
    run_streams(f32_bytes, WORK[:1])
    head_dim = pm.cfg.hidden_size // pm.cfg.num_attention_heads
    assert (eng.pool.bytes_in_hbm() * kv_row_bytes(head_dim, 'f32')
            == f32_bytes.pool.bytes_in_hbm() * kv_row_bytes(head_dim,
                                                            kv_dtype))


def test_int8_spec_decode_equals_int8_lockstep(models):
    """Verify rounds over an int8 pool read the dequantized keys and
    re-quantize the accepted window: the streams equal the int8 lockstep
    engine's."""
    _, pm = models
    lockstep = run_streams(DecodeEngine(pm, kv_dtype='int8', **ENGINE_KW))
    eng = DecodeEngine(pm, kv_dtype='int8', spec_decode=True, **ENGINE_KW)
    assert run_streams(eng) == lockstep
    assert eng.stats['spec_rounds'] > 0 and eng.stats['spec_drafted'] > 0


def test_decode_hbm_mb_is_a_later_item(models, monkeypatch):
    _, pm = models
    kw = {**ENGINE_KW, 'max_blocks': None}
    monkeypatch.setenv('PADDLE_TPU_DECODE_HBM_MB', 'lots')
    with pytest.raises(ValueError, match='PADDLE_TPU_DECODE_HBM_MB'):
        DecodeEngine(pm, **kw)
    monkeypatch.setenv('PADDLE_TPU_DECODE_HBM_MB', '0')
    with pytest.raises(ValueError, match='integers >= 1'):
        DecodeEngine(pm, **kw)
    monkeypatch.setenv('PADDLE_TPU_DECODE_HBM_MB', '64')
    with pytest.raises(NotImplementedError, match='A.11'):
        DecodeEngine(pm, **kw)
    # an explicit block count wins over the budget, as in the reference
    assert DecodeEngine(pm, **ENGINE_KW).pool.num_blocks == 64
    monkeypatch.setenv('PADDLE_TPU_DECODE_MAX_BLOCKS', '48')
    assert DecodeEngine(pm, **kw).pool.num_blocks == 48
