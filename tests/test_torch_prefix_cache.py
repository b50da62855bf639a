"""The port's radix prefix cache and its host spill tier
(paddle_tpu_torch/serving/tier/prefix_cache.py, the refcounted
``BlockAllocator``, ``reserve_table(prompt=)``, ``publish_prefix``, the
scheduler's suffix fill) against the JAX package's, on the CPU at
``CausalLMConfig.tiny()`` with one set of weights and the reference's
geometry (2 slots, block 4, 64 blocks, prompts up to 16, budgets up to 8;
tests/framework/test_prefix_cache.py and test_kv_spill.py, case by case).

Tolerances: a hit's suffix rows against the cold prefill's rows at atol
1e-4 (the suffix runs through the decode step, the cold prompt through
the prefill: f32 sums in another order). Greedy streams are equal, or part
only at a near tie: the token that differs lies within 1e-3 of its row's
max logit under teacher forcing through the JAX model (as
tests/test_torch_decode_engine.py judges them). Moving blocks to the host
tier and back is a copy: the reinjected blocks equal the spilled ones bit
for bit, f32 and int8 (with scales), and so does the hit's stream equal
the resident hit's. Every scheduler run waits at most 120 s a result."""
import sys
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.dygraph import guard
from paddle_tpu.dygraph.tape import Tensor, no_grad_guard
from paddle_tpu.observability import registry
from paddle_tpu.serving import DecodeEngine as JaxEngine
from paddle_tpu.serving import DecodeScheduler as JaxScheduler
from paddle_tpu.serving.tier.replica import build_tiny_lm
from paddle_tpu_torch.convert import state_dict_from_paddle
from paddle_tpu_torch.models import causal_lm as port_lm
from paddle_tpu_torch.serving import DecodeEngine, DecodeScheduler, PrefixCache
from paddle_tpu_torch.serving.decode.kv_cache import BlockTable
from paddle_tpu_torch.serving.tier.prefix_cache import _HostTier, _Node
from torch_jax_seed import jax_seed_pinned  # noqa: F401  (caps threads)

ENGINE_KW = dict(slots=2, block_size=4, max_blocks=64, max_prompt_len=16,
                 max_new_tokens_cap=8)
ATOL = 1e-4
NEAR_TIE = 1e-3
SYS_PROMPT = [7, 3, 11, 5, 9, 2, 44, 8]          # two whole 4-token blocks
PROMPT = SYS_PROMPT + [13]
WAIT = 120


@pytest.fixture(scope='module')
def models():
    with guard():
        jm = build_tiny_lm()
        named = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
        pm = port_lm.TransformerLM(port_lm.CausalLMConfig.tiny(),
                                   device='cpu')
        pm.load_state_dict(state_dict_from_paddle(named))
        pm.eval()
        yield jm, pm


@pytest.fixture(autouse=True)
def no_cache_env(monkeypatch):
    for name in ('PADDLE_TPU_PREFIX_CACHE', 'PADDLE_TPU_PREFIX_CACHE_HOST_MB',
                 'PADDLE_TPU_PREFIX_CACHE_MAX_BLOCKS', 'PADDLE_TPU_KV_DTYPE'):
        monkeypatch.delenv(name, raising=False)


def make_engine(pm, **kw):
    kw = {**ENGINE_KW, 'prefix_cache': True, **kw}
    return DecodeEngine(pm, **kw)


def serve(engine, work, concurrent=False):
    """Greedy streams of ``work`` [(prompt, budget)] through a scheduler,
    one after another (or all at once)."""
    with DecodeScheduler(engine, queue_depth=len(work) + 1) as sched:
        if concurrent:
            streams = [sched.submit(p, max_new_tokens=m) for p, m in work]
            return [s.result(WAIT) for s in streams]
        return [sched.submit(p, max_new_tokens=m).result(WAIT)
                for p, m in work]


def jax_counter(name, **labels):
    d = registry.to_dict().get(name)
    if not d or not d['samples']:
        return 0.0
    return sum(s['value'] for s in d['samples']
               if not labels or s.get('labels') == labels)


def jax_gaps(jm, prompt, tokens, pad_len):
    seq = np.zeros((1, pad_len), np.int64)
    seq[0, :len(prompt) + len(tokens)] = list(prompt) + list(tokens)
    with no_grad_guard():
        logits = np.asarray(jm(Tensor(seq, stop_gradient=True)).numpy())
    rows = logits[0, len(prompt) - 1:len(prompt) - 1 + len(tokens)]
    return rows.max(-1) - rows[np.arange(len(tokens)), tokens]


def assert_equal_or_near_tie(jm, work, got, want, pad_len):
    for (p, m), g, w in zip(work, got, want):
        assert len(g) == m
        if g != w:
            assert jax_gaps(jm, p, g, pad_len).max() <= NEAR_TIE, (g, w)


def trie(pc):
    """{chunk path: block id (None: spilled)} of a cache of either
    package."""
    out, stack = {}, [((), pc._root)]
    while stack:
        path, node = stack.pop()
        for chunk, child in node.children.items():
            key = path + (tuple(int(t) for t in chunk),)
            out[key] = None if child.block is None else int(child.block)
            stack.append((key, child))
    return out


def pool_blocks(engine, ids):
    """Every layer's K, V (and int8 scales) of blocks ``ids``, host
    tensors."""
    pool = engine.pool
    return [(*pool.read_blocks(layer, ids),
             *(pool.read_block_scales(layer, ids) or ()))
            for layer in range(pool.num_layers)]


def assert_same_bits(a, b):
    for la, lb in zip(a, b):
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and torch.equal(x, y)


# -- the knobs ---------------------------------------------------------------

def test_prefix_cache_env_strict_parse(models, monkeypatch):
    _, pm = models
    monkeypatch.setenv('PADDLE_TPU_PREFIX_CACHE', 'yes')
    with pytest.raises(ValueError, match="'0', '1'"):
        make_engine(pm, prefix_cache=None)
    monkeypatch.setenv('PADDLE_TPU_PREFIX_CACHE', '1')
    assert make_engine(pm, prefix_cache=None).prefix_cache is not None
    assert make_engine(pm, prefix_cache=False).prefix_cache is None
    monkeypatch.setenv('PADDLE_TPU_PREFIX_CACHE', '0')
    assert make_engine(pm, prefix_cache=None).prefix_cache is None
    assert make_engine(pm).prefix_cache is not None


@pytest.mark.parametrize('name,bad,match', [
    ('PADDLE_TPU_PREFIX_CACHE_MAX_BLOCKS', 'many',
     'PADDLE_TPU_PREFIX_CACHE_MAX_BLOCKS'),
    ('PADDLE_TPU_PREFIX_CACHE_MAX_BLOCKS', '-3', 'integers >= 0'),
    ('PADDLE_TPU_PREFIX_CACHE_HOST_MB', '1.5',
     'PADDLE_TPU_PREFIX_CACHE_HOST_MB')])
def test_cache_size_knobs_strict_parse(models, monkeypatch, name, bad,
                                       match):
    _, pm = models
    eng = make_engine(pm, prefix_cache=False)
    monkeypatch.setenv(name, bad)
    with pytest.raises(ValueError, match=match):
        PrefixCache(eng.pool)
    monkeypatch.setenv(name, '7')
    pc = PrefixCache(eng.pool)
    assert (pc.max_blocks == 7 if 'MAX' in name
            else pc._host.cap == 7 << 20)


# -- hits against cold runs and the reference --------------------------------

def test_hit_rows_match_the_cold_prefill(models):
    """A hit's suffix rows (fed through the decode step over the shared
    blocks) against the cold prefill's rows of the same prompt, and the
    JAX engine's."""
    jm, pm = models
    eng = make_engine(pm)
    rows = {}
    prompt = SYS_PROMPT + [13, 21, 4]
    for what in ('cold', 'hit'):
        t = eng.reserve_table(len(prompt), 4, prompt=prompt)
        if what == 'cold':
            assert t.cached_len == 0
            got = []
            eng.prefill(prompt, t, sampler=lambda r: got.append(r) or 0)
            eng.publish_prefix(prompt, t)
            rows[what] = got[0]
        else:
            assert t.cached_len == 8
            t.context_len = t.cached_len
            pad = [None] * (eng.slots - 1)
            for tok in prompt[8:]:
                _, r = eng.decode_step([tok] + pad, [t] + pad,
                                       return_rows=True)
            rows[what] = r[0]
        eng.release_table(t)
    np.testing.assert_allclose(rows['hit'], rows['cold'], atol=ATOL)
    jeng = JaxEngine(jm, **ENGINE_KW)
    t = jeng.reserve_table(len(prompt), 4)
    want = []
    jeng.prefill(prompt, t, sampler=lambda r: want.append(r) or 0)
    np.testing.assert_allclose(rows['hit'], want[0], atol=ATOL)


@pytest.mark.parametrize('spec', [False, True], ids=['lockstep', 'verify'])
def test_hit_streams_equal_cold_and_the_jax_cache(models, spec):
    """Cold, then the same prompt as a hit, then the shared system prompt
    under other suffixes: the port's streams against its own cold run
    (cache off) and the JAX engine's prefix-cached streams; with
    speculative decoding the suffix rides verify rounds (up to k prompt
    tokens a round)."""
    jm, pm = models
    work = [(SYS_PROMPT + s, 6) for s in
            ([13, 21], [13, 21], [17, 6], [99, 1, 2], [40])]
    kw = {'spec_decode': True, 'spec_k': 4} if spec else {}
    eng = make_engine(pm, **kw)
    got = serve(eng, work)
    cold = serve(make_engine(pm, prefix_cache=False), work)
    jeng = JaxEngine(jm, prefix_cache=True, **kw, **ENGINE_KW)
    with JaxScheduler(jeng) as js:
        want = [js.submit(p, max_new_tokens=m).result(WAIT)
                for p, m in work]
    pad_len = eng.padded_context
    assert_equal_or_near_tie(jm, work, got, cold, pad_len)
    assert_equal_or_near_tie(jm, work, got, want, pad_len)
    stats = eng.prefix_cache.stats
    assert stats['prefix_cache_hits'] == 4
    assert stats['prefix_cache_tokens_saved'] == 4 * 8
    assert eng.stats['prefills'] == 1             # the cold miss alone
    assert eng.pool.allocator.used == eng.prefix_cache.resident_blocks
    if spec:
        assert eng.stats['spec_rounds'] == eng.stats['decode_steps']


@pytest.mark.parametrize('spec,steps', [(False, 8), (True, 2)],
                         ids=['lockstep', 'verify'])
def test_suffix_fill_steps(models, spec, steps):
    """A hit with an 8-token suffix and a budget of 1 takes 8 lockstep
    steps, or 2 verify rounds of k = 4 prompt tokens."""
    _, pm = models
    kw = {'spec_decode': True, 'spec_k': 4} if spec else {}
    eng = make_engine(pm, **kw)
    prompt = SYS_PROMPT + [13, 21, 4, 9, 30, 31, 32, 33]
    serve(eng, [(SYS_PROMPT + [1], 1)])
    before = eng.stats['decode_steps']
    serve(eng, [(prompt, 1)])
    assert eng.prefix_cache.stats['prefix_cache_hits'] == 1
    assert eng.stats['decode_steps'] - before == steps


# -- a sampled hit alone in its step (ROADMAP C.15, C.4 item 9) --------------

SAMPLED = {'temperature': 0.9, 'top_k': 20, 'top_p': 0.95, 'seed': 1234}
HIT_PROMPT = SYS_PROMPT + [13, 21, 4]


def recording_steps(engine):
    """Wrap ``engine.decode_step`` and ``engine.prefill``: each decode step
    appends (tables, rows or None), each sampled prefill its row."""
    steps, prefill_rows = [], []
    decode_step, prefill = engine.decode_step, engine.prefill

    def step(tokens, tables, return_rows=False):
        out = decode_step(tokens, tables, return_rows=return_rows)
        steps.append((list(tables), out[1] if return_rows else None))
        return out

    def fill(prompt, table, sampler=None):
        def draw(row):
            prefill_rows.append(np.array(row))
            return sampler(row)
        return prefill(prompt, table, sampler=draw if sampler else None)

    engine.decode_step, engine.prefill = step, fill
    return steps, prefill_rows


def sampled_first_token(engine, request_id):
    with DecodeScheduler(engine, queue_depth=2) as sched:
        return sched.submit(HIT_PROMPT, max_new_tokens=1, sampling=SAMPLED,
                            request_id=request_id).result(WAIT)


def test_sampled_hit_alone_draws_its_first_token_from_its_row(models):
    """A sampled request that hits the cache alone in its step: the step
    that consumes its last suffix token asks for logits rows, and its first
    token is the request's sampler applied to that hit's row. Against a
    cold run of the same request and seed: the rows agree within ATOL (the
    row test's rule), so the first tokens are equal or part only at such a
    near tie. (The JAX package emits the argmax there: the next test.)"""
    from paddle_tpu_torch.serving.decode.sampling import (SamplingParams,
                                                           TokenSampler)
    _, pm = models
    eng = make_engine(pm)
    serve(eng, [(SYS_PROMPT + [1], 1)])
    steps, _ = recording_steps(eng)
    got = sampled_first_token(eng, 'c15')
    assert eng.prefix_cache.stats['prefix_cache_hits'] == 1
    assert len(steps) == len(HIT_PROMPT) - 8       # the suffix, one a step
    tables, rows = steps[-1]
    live = [i for i, t in enumerate(tables) if t is not None]
    assert len(live) == 1 and rows is not None     # alone, rows asked for
    hit_row = rows[live[0]]
    sampler = TokenSampler(SamplingParams.validate(SAMPLED), 'c15')
    assert got == [sampler.sample(hit_row, 0)]
    # at this seed the draw is not the row's argmax, so the test tells the
    # two behaviours apart
    assert got[0] != int(np.argmax(hit_row))

    cold_eng = make_engine(pm, prefix_cache=False)
    _, cold_rows = recording_steps(cold_eng)
    cold = sampled_first_token(cold_eng, 'c15')
    assert len(cold_rows) == 1
    assert cold == [sampler.sample(cold_rows[0], 0)]
    np.testing.assert_allclose(hit_row, cold_rows[0], atol=ATOL)
    assert got == cold or np.abs(hit_row - cold_rows[0]).max() <= ATOL


def test_jax_scheduler_emits_the_argmax_for_a_sampled_hit_alone(models):
    """ROADMAP C.4 item 9: the JAX package's step that consumes a hit's last
    suffix token asks for rows only for slots that are not prefilling
    (paddle_tpu/serving/decode/scheduler.py:546-547), so a sampled hit
    alone in it emits the argmax: the greedy hit's first token, which the
    request's own sampler does not draw from that row."""
    from paddle_tpu.serving.decode.sampling import (SamplingParams,
                                                     TokenSampler)
    jm, _ = models
    jeng = JaxEngine(jm, prefix_cache=True, **ENGINE_KW)
    with JaxScheduler(jeng) as js:
        js.submit(SYS_PROMPT + [1], max_new_tokens=1).result(WAIT)
        hits = jax_counter('prefix_cache_hits')
        sampled = js.submit(HIT_PROMPT, max_new_tokens=1, sampling=SAMPLED,
                            request_id='c15').result(WAIT)
        greedy = js.submit(HIT_PROMPT, max_new_tokens=1).result(WAIT)
    assert jax_counter('prefix_cache_hits') - hits == 2
    assert sampled == greedy
    cold = JaxEngine(jm, **ENGINE_KW)
    t = cold.reserve_table(len(HIT_PROMPT), 1)
    row = []
    cold.prefill(HIT_PROMPT, t, sampler=lambda r: row.append(r) or 0)
    assert int(np.argmax(row[0])) == sampled[0]
    sampler = TokenSampler(SamplingParams.validate(SAMPLED), 'c15')
    assert sampler.sample(row[0], 0) != sampled[0]


def test_concurrent_mixed_workload(models):
    """A ragged concurrent mix of cold and hitting prompts through the
    continuous batching scheduler at 3 slots."""
    jm, pm = models
    rng = np.random.RandomState(3)
    work = [(SYS_PROMPT + [int(t) for t in rng.randint(3, 100, n)], m)
            for n, m in zip((1, 3, 2, 5, 1, 4), (6, 3, 8, 2, 5, 7))]
    eng = make_engine(pm, slots=3)
    got = serve(eng, work, concurrent=True)
    want = [port_lm.greedy_generate(pm, p, m, pad_len=eng.padded_context)
            for p, m in work]
    assert_equal_or_near_tie(jm, work, got, want, eng.padded_context)
    assert eng.pool.allocator.used == eng.prefix_cache.resident_blocks


def test_trie_and_counters_match_the_jax_cache(models):
    """The same request sequence, one at a time, through both packages'
    cached engines: the same trie (chunk paths and block ids), the same
    hits, misses, tokens saved and inserted blocks."""
    jm, pm = models
    pa, pb = SYS_PROMPT, SYS_PROMPT + [61, 62, 63, 64]
    work = [(pa, 4), (pb, 4), (pb + [33], 4), ([1, 2, 3], 3), ([1, 2, 3], 3),
            ([91, 92, 93, 94, 95], 2), (pa + [5], 4)]
    eng = make_engine(pm)
    serve(eng, work)
    names = ('prefix_cache_hits', 'prefix_cache_misses',
             'prefix_cache_tokens_saved', 'prefix_cache_inserted_blocks')
    before = {n: jax_counter(n) for n in names}
    jeng = JaxEngine(jm, prefix_cache=True, **ENGINE_KW)
    with JaxScheduler(jeng) as js:
        for p, m in work:
            js.submit(p, max_new_tokens=m).result(WAIT)
    assert trie(eng.prefix_cache) == trie(jeng.prefix_cache)
    assert len(trie(eng.prefix_cache)) == 4
    assert eng.prefix_cache.resident_blocks == \
        jeng.prefix_cache.resident_blocks == 4
    for n in names:
        assert eng.prefix_cache.stats[n] == jax_counter(n) - before[n], n
    assert eng.prefix_cache.stats['prefix_cache_hits'] == 3


# -- refcounts and shared blocks ---------------------------------------------

def test_shared_prefix_refcount_lifecycle(models):
    """The cache's reference plus one a sharing table: 2 while one request
    holds the blocks, 3 while two share them, 1 after both retire, 0
    (free) after eviction."""
    _, pm = models
    eng = make_engine(pm)
    alloc = eng.pool.allocator
    t1 = eng.reserve_table(len(PROMPT), 4, prompt=PROMPT)
    assert t1.cached_len == 0
    eng.prefill(PROMPT, t1)
    eng.publish_prefix(PROMPT, t1)
    shared = eng.prefix_cache.resident_block_ids()
    assert len(shared) == 2
    assert all(alloc.refcount(b) == 2 for b in shared)
    t2 = eng.reserve_table(len(PROMPT), 4, prompt=PROMPT)
    assert t2.cached_len == 8 and t2.blocks[:2] == t1.blocks[:2]
    assert all(alloc.refcount(b) == 3 for b in shared)
    eng.release_table(t1)
    assert all(alloc.refcount(b) == 2 for b in shared)
    eng.release_table(t2)
    assert all(alloc.refcount(b) == 1 for b in shared)
    used = alloc.used
    assert eng.prefix_cache.evict_idle() == 2
    assert alloc.used == used - 2
    assert all(alloc.refcount(b) == 0 for b in shared)
    with pytest.raises(ValueError, match='double free'):
        alloc.release(shared[:1])
    with pytest.raises(ValueError, match='non-live'):
        alloc.retain(shared[:1])


def test_refcounts_and_counters_hold_under_threads(models):
    """16 threads matching the cached prompt and releasing what they got,
    at a 1 us switch interval: every shared block ends at the cache's own
    reference and the hit counter counts every match (a lost update
    breaks either)."""
    _, pm = models
    eng = make_engine(pm)
    t = eng.reserve_table(len(PROMPT), 4, prompt=PROMPT)
    eng.prefill(PROMPT, t)
    eng.publish_prefix(PROMPT, t)
    eng.release_table(t)
    pc, alloc = eng.prefix_cache, eng.pool.allocator
    shared = pc.resident_block_ids()
    hits, errors = pc.stats['prefix_cache_hits'], []

    def worker():
        try:
            for _ in range(200):
                blocks = pc.match(PROMPT)
                assert sorted(blocks) == sorted(shared)
                alloc.release(blocks)
        except Exception as e:                 # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:1]
    assert all(alloc.refcount(b) == 1 for b in shared)
    assert pc.stats['prefix_cache_hits'] == hits + 16 * 200


@pytest.mark.parametrize('kv_dtype,spec', [('f32', False), ('int8', False),
                                           ('f32', True), ('int8', True)])
def test_sharing_requests_never_write_shared_blocks(models, kv_dtype, spec):
    """A hit's decode and verify writes (a verify round's padded lanes
    included) land in its own blocks: the shared blocks' bytes, int8
    scales too, are the same before and after two hitting generations."""
    _, pm = models
    kw = {'spec_decode': True, 'spec_k': 4} if spec else {}
    eng = make_engine(pm, kv_dtype=kv_dtype, **kw)
    prompt = SYS_PROMPT + [13, 21]
    with DecodeScheduler(eng) as sched:
        sched.submit(prompt, max_new_tokens=6).result(WAIT)
        ids = eng.prefix_cache.resident_block_ids()
        before = pool_blocks(eng, ids)
        streams = [sched.submit(prompt, max_new_tokens=8),
                   sched.submit(SYS_PROMPT + [1], max_new_tokens=8)]
        [s.result(WAIT) for s in streams]
        after = pool_blocks(eng, ids)
    assert len(ids) == 2 and len(before[0]) == (4 if kv_dtype == 'int8'
                                                else 2)
    assert_same_bits(before, after)


# -- eviction ----------------------------------------------------------------

def test_eviction_under_pool_pressure(models):
    """A pool too small for the cache and a new request evicts idle cached
    blocks (LRU) instead of failing or waiting forever; the evicted prompt
    is served again as a miss."""
    jm, pm = models
    # 5 usable blocks; a request needs ceil((8 + 8) / 4) = 4
    eng = make_engine(pm, max_blocks=6, max_prompt_len=8)
    p2 = [91, 92, 93, 94, 95, 96, 97, 98]
    work = [(SYS_PROMPT, 8), (p2, 8), (SYS_PROMPT, 8)]
    got = serve(eng, work)
    want = [port_lm.greedy_generate(pm, p, m, pad_len=eng.padded_context)
            for p, m in work]
    assert_equal_or_near_tie(jm, work, got, want, eng.padded_context)
    assert got[0] == got[2]
    ev = eng.prefix_cache.stats['prefix_cache_evictions']
    assert ev['pressure'] >= 1 and ev['cap'] == 0
    assert eng.pool.allocator.used == eng.prefix_cache.resident_blocks


@pytest.mark.parametrize('host', [False, True], ids=['drop', 'spill'])
def test_max_blocks_cap_at_publication(models, monkeypatch, host):
    """Three disjoint 2-block prompts through a cap of 2 keep 2 resident
    and count evictions by cause 'cap'; with a host tier the capped-out
    blocks spill, and the first prompt hits again through reinjection."""
    _, pm = models
    monkeypatch.setenv('PADDLE_TPU_PREFIX_CACHE_MAX_BLOCKS', '2')
    if host:
        monkeypatch.setenv('PADDLE_TPU_PREFIX_CACHE_HOST_MB', '8')
    eng = make_engine(pm)
    pc = eng.prefix_cache
    prompts = [[t] * 9 for t in (5, 6, 7)]
    with DecodeScheduler(eng) as sched:
        colds = [sched.submit(p, max_new_tokens=4).result(WAIT)
                 for p in prompts]
        assert pc.resident_blocks == 2 == len(pc.resident_block_ids())
        assert pc.stats['prefix_cache_evictions']['cap'] > 0
        assert pc.spilled_blocks == (4 if host else 0)
        again = sched.submit(prompts[0], max_new_tokens=4).result(WAIT)
    assert again == colds[0]
    if host:
        assert pc.stats['prefix_cache_hits'] == 1
        assert pc.stats['kv_cache_reinject_count'] == 2


def test_lru_prefers_older_idle_leaves(models):
    _, pm = models
    eng = make_engine(pm)
    pc = eng.prefix_cache
    pa, pb = SYS_PROMPT + [13], [91, 92, 93, 94, 95]
    for p in (pa, pb):
        t = eng.reserve_table(len(p), 4, prompt=p)
        eng.prefill(p, t)
        eng.publish_prefix(p, t)
        eng.release_table(t)
    blocks = pc.match(pa)                 # a recency touch of pa's path
    assert len(blocks) == 2
    eng.pool.allocator.release(blocks)
    assert pc._spill_or_evict_one()
    assert tuple(pb[:4]) not in pc._root.children
    assert tuple(pa[:4]) in pc._root.children


# -- block boundaries --------------------------------------------------------

def test_sub_block_prompts_never_cached(models):
    _, pm = models
    eng = make_engine(pm)
    serve(eng, [([1, 2, 3], 3), ([1, 2, 3], 3)])
    assert eng.prefix_cache.resident_blocks == 0
    assert eng.prefix_cache.stats['prefix_cache_misses'] == 2
    assert eng.prefix_cache.stats['prefix_cache_hits'] == 0


def test_last_prompt_token_never_served_from_cache(models):
    """A block-aligned prompt (P = 2 blocks) hits at most 1 block: one real
    token must run through the model for the first token's logits."""
    jm, pm = models
    eng = make_engine(pm)
    with DecodeScheduler(eng) as sched:
        first = sched.submit(SYS_PROMPT, max_new_tokens=4).result(WAIT)
        t = eng.reserve_table(len(SYS_PROMPT), 4, prompt=SYS_PROMPT)
        assert t.cached_len == 4
        eng.release_table(t)
        again = sched.submit(SYS_PROMPT, max_new_tokens=4).result(WAIT)
    assert again == first
    want = port_lm.greedy_generate(pm, SYS_PROMPT, 4,
                                   pad_len=eng.padded_context)
    assert_equal_or_near_tie(jm, [(SYS_PROMPT, 4)], [first], [want],
                             eng.padded_context)


def test_trie_deepens_with_longer_shared_prompts(models):
    _, pm = models
    eng = make_engine(pm)
    pb = SYS_PROMPT + [61, 62, 63, 64]
    serve(eng, [(SYS_PROMPT, 4), (pb, 4)])
    assert eng.prefix_cache.resident_blocks == 3
    saved = eng.prefix_cache.stats['prefix_cache_tokens_saved']
    serve(eng, [(pb + [33], 4)])
    assert eng.prefix_cache.stats['prefix_cache_tokens_saved'] - saved == 12


# -- the host spill tier -----------------------------------------------------

@pytest.mark.parametrize('kv_dtype', ['f32', 'int8'])
def test_spill_reinject_bitwise_equals_resident_hit(models, monkeypatch,
                                                    kv_dtype):
    """Cold, a resident hit, every cached block spilled to the host tier,
    then the same prompt again: the reinjected blocks equal the spilled
    ones bit for bit (int8 scales too) and the hit's stream equals the
    resident hit's."""
    _, pm = models
    monkeypatch.setenv('PADDLE_TPU_PREFIX_CACHE_HOST_MB', '8')
    eng = make_engine(pm, kv_dtype=kv_dtype)
    pc = eng.prefix_cache
    with DecodeScheduler(eng) as sched:
        cold = sched.submit(PROMPT, max_new_tokens=6).result(WAIT)
        resident = sched.submit(PROMPT, max_new_tokens=6).result(WAIT)
        ids = pc.resident_block_ids()
        blocks = pool_blocks(eng, ids)
        while pc._spill_or_evict_one():
            pass
        assert pc.resident_blocks == 0 and pc.spilled_blocks == 2
        assert pc.host_bytes == pc.stats['kv_cache_bytes_spilled'] > 0
        assert pc.stats['kv_cache_spill_count'] == 2
        # hold the freed blocks, so the hit reinjects into other ids
        held = eng.pool.allocator.allocate(2)
        assert sorted(held) == sorted(ids)
        hit = sched.submit(PROMPT, max_new_tokens=6).result(WAIT)
        new_ids = pc.resident_block_ids()
        assert not set(new_ids) & set(ids)
        reinjected = pool_blocks(eng, new_ids)
        eng.pool.allocator.release(held)
    assert hit == resident == cold
    assert pc.stats['kv_cache_reinject_count'] == 2
    assert pc.spilled_blocks == 0 and pc.resident_blocks == 2
    # both reads walk the trie in the same order: node for node
    assert_same_bits(blocks, reinjected)


def test_evict_idle_drops_the_host_tier_too(models, monkeypatch):
    _, pm = models
    monkeypatch.setenv('PADDLE_TPU_PREFIX_CACHE_HOST_MB', '8')
    eng = make_engine(pm)
    pc = eng.prefix_cache
    serve(eng, [(PROMPT, 4)])
    while pc._spill_or_evict_one():
        pass
    assert pc.spilled_blocks > 0
    serve(eng, [(PROMPT, 4)])      # a cold publish promotes in place
    assert pc.spilled_blocks == 0 and pc.resident_blocks == 2
    while pc._spill_or_evict_one():
        pass
    pc.evict_idle()
    assert pc.resident_blocks == 0 and pc.spilled_blocks == 0
    assert pc.host_bytes == 0 and not pc._root.children
    assert eng.pool.allocator.used == 0


def test_host_tier_lru_cap_drops_oldest():
    t = _HostTier(100)
    n1, n2, n3 = _Node(None), _Node(None), _Node(None)
    assert t.put(n1, 'x', 40) == [] and t.put(n2, 'y', 40) == []
    t.touch(n1)
    assert t.put(n3, 'z', 40) == [n2]
    assert t.bytes <= 100 and n1 in t and n3 in t and n2 not in t
    assert t.pop(n1) == 'x' and t.bytes == 40


def test_host_overflow_drops_the_trie_path(models, monkeypatch):
    """A payload the LRU drops takes its spilled trie node with it: the
    prompt becomes an honest miss, served again as the cold run."""
    _, pm = models
    monkeypatch.setenv('PADDLE_TPU_PREFIX_CACHE_HOST_MB', '8')
    eng = make_engine(pm)
    pc = eng.prefix_cache
    with DecodeScheduler(eng) as sched:
        cold = sched.submit(PROMPT, max_new_tokens=4).result(WAIT)
        while pc._spill_or_evict_one():
            pass
        pc._host.cap = 1
        sched.submit([9] * 9, max_new_tokens=4).result(WAIT)
        while pc._spill_or_evict_one():
            pass
        assert pc.spilled_blocks == 0 and pc.host_bytes == 0
        assert pc.match(PROMPT) == []
        misses = pc.stats['prefix_cache_misses']
        again = sched.submit(PROMPT, max_new_tokens=4).result(WAIT)
    assert again == cold and pc.stats['prefix_cache_misses'] > misses


def test_insert_never_orphans_the_walked_path(models):
    """A publish that reaches the cap while standing on an idle cached node
    must not evict that node; it stops, leaking nothing."""
    _, pm = models
    eng = make_engine(pm, prefix_cache=False)
    pool = eng.pool
    pc = PrefixCache(pool, max_blocks=1, host_mb=0)
    bs = pool.block_size
    prefix = [5, 6, 7, 8]
    q = pool.allocator.allocate(1)
    pc.insert(prefix, BlockTable(q, bs))
    pool.allocator.release(q)
    node_a = pc._root.children[tuple(prefix)]
    assert pool.allocator.refcount(node_a.block) == 1
    r = pool.allocator.allocate(2)
    pc.insert(prefix + [9, 10, 11, 12], BlockTable(r, bs))
    pool.allocator.release(r)
    assert pc._root.children[tuple(prefix)] is node_a
    assert node_a.block is not None
    assert pc.resident_blocks == len(pc.resident_block_ids()) == 1
    assert pool.allocator.used == 1
    assert pc.match(prefix + [0]) == [node_a.block]
    pool.allocator.release([node_a.block])


def test_reinject_survives_the_host_lru_dropping_a_path_node(models):
    """During reinjection the pressure spill of a node off the path can
    overflow the host LRU and drop a later node of the path: the match
    stops at a shorter honest hit and leaks no block."""
    _, pm = models
    eng = make_engine(pm, prefix_cache=False)
    pool = eng.pool
    t = pool.new_table(4)
    eng.prefill([1, 2, 3, 4], t)             # allocate the layers
    eng.release_table(t)
    pc = PrefixCache(pool, max_blocks=0, host_mb=8)
    bs = pool.block_size
    pa = list(range(5, 5 + 2 * bs))
    blocks = pool.allocator.allocate(2)
    pc.insert(pa, BlockTable(blocks, bs))
    pool.allocator.release(blocks)
    while pc._spill_or_evict_one():
        pass
    assert pc.spilled_blocks == 2
    for tok in (21, 22):
        b2 = pool.allocator.allocate(1)
        pc.insert([tok] * bs, BlockTable(b2, bs))
        pool.allocator.release(b2)
    pc._host.cap = pc.host_bytes + 1
    held = pool.allocator.allocate(pool.allocator.available)
    hit = pc.match(pa + [0])
    parent = pc._root.children[tuple(pa[:bs])]
    assert hit == [parent.block] and parent.block is not None
    assert tuple(pa[bs:2 * bs]) not in parent.children
    assert pc.resident_blocks == 2 and pc.spilled_blocks == 1
    pool.allocator.release(hit)
    assert pool.allocator.used == len(held) + 2
    pool.allocator.release(held)
    pc.evict_idle()
    assert pool.allocator.used == 0
    assert pc.spilled_blocks == 0 and pc.host_bytes == 0


def test_truncated_reinject_refreshes_host_lru_recency(models):
    _, pm = models
    eng = make_engine(pm, prefix_cache=False)
    pool = eng.pool
    t = pool.new_table(4)
    eng.prefill([1, 2, 3, 4], t)
    eng.release_table(t)
    pc = PrefixCache(pool, max_blocks=0, host_mb=8)
    bs = pool.block_size
    pa = list(range(5, 5 + 2 * bs))
    blocks = pool.allocator.allocate(2)
    pc.insert(pa, BlockTable(blocks, bs))
    pool.allocator.release(blocks)
    b2 = pool.allocator.allocate(1)
    pc.insert([31] * bs, BlockTable(b2, bs))
    pool.allocator.release(b2)
    while pc._spill_or_evict_one():
        pass
    assert pc.spilled_blocks == 3
    cold_node = pc._root.children[tuple([31] * bs)]
    held = pool.allocator.allocate(pool.allocator.available)
    misses = pc.stats['prefix_cache_misses']
    assert pc.match(pa + [0]) == []
    assert pc.stats['prefix_cache_misses'] == misses + 1
    assert pc.spilled_blocks == 3
    assert next(iter(pc._host._entries)) is cold_node
    pool.allocator.release(held)
