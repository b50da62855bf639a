"""The port's disaggregated prefill (paddle_tpu_torch/serving/tier/disagg.py,
``DecodeEngine.inject_prefill``, the scheduler's ``disagg=`` handoff and
``build_replica_stack(disagg=)``) against colocated prefill and against the
JAX package's, on the CPU at ``CausalLMConfig.tiny()`` with one set of
weights (tests/framework/test_disagg.py, case by case).

Tolerances: a handoff moves the bytes a colocated prefill writes through
the same model, GEMM shapes and paged prefill: its blocks equal the
colocated prefill's bit for bit (f32, bf16 and int8 with scales), and so do
its streams. The wire format is the reference's byte for byte: every npz
member of the port's ``to_bytes`` equals the JAX package's for the same
arrays. Streams decoded from the other package's payload are equal, or
part only at a near tie (1e-3 of the row's max logit under teacher forcing
through the JAX model). Every scheduler run waits at most 120 s a result,
and every worker thread is closed."""
import io
import threading
import time
import zipfile

import numpy as np
import pytest
import torch

from paddle_tpu.dygraph import guard
from paddle_tpu.dygraph.tape import Tensor, no_grad_guard
from paddle_tpu.serving import DecodeEngine as JaxEngine
from paddle_tpu.serving.tier import disagg as jax_disagg
from paddle_tpu.serving.tier.replica import build_tiny_lm
from paddle_tpu_torch.convert import state_dict_from_paddle
from paddle_tpu_torch.models import causal_lm as port_lm
from paddle_tpu_torch.serving import DecodeEngine, ServingError
from paddle_tpu_torch.serving.tier.disagg import (KVPayload,
                                                  LocalPrefillWorker,
                                                  PrefillReplica)
from paddle_tpu_torch.serving.tier.replica import build_replica_stack
from torch_jax_seed import jax_seed_pinned  # noqa: F401  (caps threads)

ENGINE_KW = dict(slots=2, block_size=4, max_blocks=128, max_prompt_len=16,
                 max_new_tokens_cap=16)
NEAR_TIE = 1e-3
WAIT = 120
PROMPTS = [[7, 3, 11, 5, 9], [2, 44, 8, 13], [1, 2, 3], [9] * 7]
KV_DTYPES = ['f32', 'bf16', 'int8']


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
def no_tier_env(monkeypatch):
    for name in ('PADDLE_TPU_DISAGG', 'PADDLE_TPU_PREFIX_CACHE',
                 'PADDLE_TPU_KV_DTYPE'):
        monkeypatch.delenv(name, raising=False)


def stack(pm, **kw):
    return build_replica_stack(pm, **{**ENGINE_KW, **kw})


def serve(sched, worker, prompts, budget=6):
    try:
        return [sched.submit(p, max_new_tokens=budget).result(WAIT)
                for p in prompts]
    finally:
        sched.close(timeout=WAIT)
        if worker is not None:
            worker.close()


def jax_gaps(jm, prompt, tokens, pad_len):
    seq = np.zeros((1, pad_len), np.int64)
    seq[0, :len(prompt) + len(tokens)] = list(prompt) + list(tokens)
    with no_grad_guard():
        logits = np.asarray(jm(Tensor(seq, stop_gradient=True)).numpy())
    rows = logits[0, len(prompt) - 1:len(prompt) - 1 + len(tokens)]
    return rows.max(-1) - rows[np.arange(len(tokens)), tokens]


def decode_after_inject(engine, prompt, payload, n):
    """Inject ``payload`` into a fresh table of ``engine`` (either
    package's) and decode ``n`` greedy tokens on slot 0."""
    table = engine.reserve_table(len(prompt), n)
    tokens = [engine.inject_prefill(table, payload)]
    pad = [None] * (engine.slots - 1)
    while len(tokens) < n:
        tokens.append(int(engine.decode_step([tokens[-1]] + pad,
                                             [table] + pad)[0]))
    engine.release_table(table)
    return tokens


def npz_members(blob):
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_disagg_env_strict_parse(models, monkeypatch):
    _, pm = models
    monkeypatch.setenv('PADDLE_TPU_DISAGG', 'on')
    with pytest.raises(ValueError, match="'0', '1'"):
        stack(pm)
    monkeypatch.setenv('PADDLE_TPU_DISAGG', '1')
    eng, sched, worker = stack(pm)
    try:
        assert worker is not None and sched.disagg is worker
        prefill_eng = worker.replica.engine
        assert prefill_eng is not eng and prefill_eng.slots == 1
        assert prefill_eng.prefix_cache is None
        assert prefill_eng.pool.kv_dtype == eng.pool.kv_dtype
    finally:
        sched.close()
        worker.close()
    monkeypatch.setenv('PADDLE_TPU_DISAGG', '0')
    eng, sched, worker = stack(pm)
    sched.close()
    assert worker is None and sched.disagg is None


@pytest.mark.parametrize('kv_dtype', KV_DTYPES)
def test_handoff_equals_colocated(models, kv_dtype):
    """Streams whose prefill ran on the prefill engine (its own pool, the
    blocks shipped) equal the colocated streams and, in f32, the uncached
    reference; the handed-over blocks equal a colocated prefill's bit for
    bit."""
    _, pm = models
    eng_d, sched_d, worker = stack(pm, disagg=True, kv_dtype=kv_dtype)
    outs = serve(sched_d, worker, PROMPTS)
    assert worker.stats['disagg_handoffs'] == len(PROMPTS)
    assert worker.stats['disagg_handoff_failures'] == 0
    assert worker.stats['disagg_kv_bytes'] > 0
    assert len(worker.stats['disagg_handoff_seconds']) == len(PROMPTS)
    assert eng_d.stats['prefills'] == 0
    assert eng_d.pool.allocator.used == 0
    eng_c, sched_c, _ = stack(pm, kv_dtype=kv_dtype)
    assert serve(sched_c, None, PROMPTS) == outs
    if kv_dtype == 'f32':
        assert outs == [port_lm.greedy_generate(
            pm, p, 6, pad_len=eng_d.padded_context) for p in PROMPTS]
    # the blocks: the prefill engine's payload against a colocated prefill
    prompt = PROMPTS[0]
    payload = PrefillReplica(worker.replica.engine).prefill_to_payload(
        prompt)
    colo = DecodeEngine(pm, kv_dtype=kv_dtype, **ENGINE_KW)
    table = colo.reserve_table(len(prompt), 4)
    assert colo.prefill(prompt, table) == payload.first_token
    nb = payload.num_blocks
    for layer, (k, v) in enumerate(payload.layers):
        ck, cv = colo.pool.read_blocks(layer, table.blocks[:nb])
        assert torch.equal(k, ck) and torch.equal(v, cv)
        assert k.dtype == colo.pool.dtype
        if kv_dtype == 'int8':
            ks, vs = payload.scales[layer]
            cks, cvs = colo.pool.read_block_scales(layer, table.blocks[:nb])
            assert torch.equal(ks, cks) and torch.equal(vs, cvs)
    assert (payload.scales is None) == (kv_dtype != 'int8')
    # and injected into a third pool they read back as shipped
    dst = DecodeEngine(pm, kv_dtype=kv_dtype, **ENGINE_KW)
    t2 = dst.reserve_table(len(prompt), 4)
    t2.blocks = t2.blocks[::-1]                   # other block ids
    dst.inject_prefill(t2, KVPayload.from_bytes(payload.to_bytes()))
    for layer, (k, v) in enumerate(payload.layers):
        dk, dv = dst.pool.read_blocks(layer, t2.blocks[:nb])
        assert torch.equal(k, dk) and torch.equal(v, dv)
        if kv_dtype == 'int8':
            ks, vs = payload.scales[layer]
            dks, dvs = dst.pool.read_block_scales(layer, t2.blocks[:nb])
            assert torch.equal(ks, dks) and torch.equal(vs, dvs)


@pytest.mark.parametrize('kv_dtype', KV_DTYPES)
def test_wire_format_is_the_reference_byte_for_byte(models, kv_dtype):
    """The JAX package's payload arrays, carried into a port KVPayload:
    every npz member of the port's bytes equals the reference's; both
    packages read each other's bytes back to the same arrays."""
    jm, _ = models
    jeng = JaxEngine(jm, kv_dtype=kv_dtype, **ENGINE_KW)
    jpay = jax_disagg.PrefillReplica(jeng).prefill_to_payload(PROMPTS[0])

    def torch_of(a):
        a = np.asarray(a)
        if a.dtype.name == 'bfloat16':
            return torch.from_numpy(a.astype(np.float32)).bfloat16()
        return torch.from_numpy(np.array(a))

    port = KVPayload([(torch_of(k), torch_of(v)) for k, v in jpay.layers],
                     jpay.context_len, jpay.first_token, jpay.block_size,
                     kv_dtype=jpay.kv_dtype,
                     scales=None if jpay.scales is None else
                     [(torch_of(a), torch_of(b)) for a, b in jpay.scales])
    want, got = npz_members(jpay.to_bytes()), npz_members(port.to_bytes())
    assert sorted(got) == sorted(want)
    assert 'meta.npy' in got and ('ks0.npy' in got) == (kv_dtype == 'int8')
    for name in want:
        assert got[name] == want[name], name
    back = KVPayload.from_bytes(jpay.to_bytes())
    assert back.kv_dtype == kv_dtype and back.context_len == 5
    for (k, v), (pk, pv) in zip(back.layers, port.layers):
        assert torch.equal(k.to(pk.dtype), pk) and torch.equal(
            v.to(pv.dtype), pv)
    jback = jax_disagg.KVPayload.from_bytes(port.to_bytes())
    assert jback.kv_dtype == kv_dtype
    assert jback.first_token == jpay.first_token
    for (k, v), (jk, jv) in zip(jback.layers, jpay.layers):
        assert np.array_equal(np.asarray(k, np.float32),
                              np.asarray(jk, np.float32))


@pytest.mark.parametrize('kv_dtype', KV_DTYPES)
def test_payloads_cross_between_the_packages(models, kv_dtype):
    """JAX ``to_bytes`` -> port ``from_bytes`` -> port inject -> the port's
    stream, and the port's bytes into the JAX engine: each the sender's
    own stream, or parting at a near tie."""
    jm, pm = models
    prompt, n = PROMPTS[0], 8
    jeng = JaxEngine(jm, kv_dtype=kv_dtype, **ENGINE_KW)
    peng = DecodeEngine(pm, kv_dtype=kv_dtype, **ENGINE_KW)
    jpay = jax_disagg.PrefillReplica(jeng).prefill_to_payload(prompt)
    ppay = PrefillReplica(peng).prefill_to_payload(prompt)
    jax_own = decode_after_inject(jeng, prompt, jpay, n)
    port_own = decode_after_inject(peng, prompt, ppay, n)
    port_from_jax = decode_after_inject(
        peng, prompt, KVPayload.from_bytes(jpay.to_bytes()), n)
    jax_from_port = decode_after_inject(
        jeng, prompt, jax_disagg.KVPayload.from_bytes(ppay.to_bytes()), n)
    pad_len = peng.padded_context
    for got, want in ((port_from_jax, jax_own), (jax_from_port, port_own),
                      (port_own, jax_own)):
        assert len(got) == n
        if got != want:
            assert jax_gaps(jm, prompt, got, pad_len).max() <= NEAR_TIE


def test_handoff_failure_is_typed_and_isolated(models):
    """A prefill engine's failure fails exactly that request with a typed
    ServingError; the decode loop serves the next one."""
    _, pm = models
    eng, sched, worker = stack(pm, disagg=True)
    prefill_eng = worker.replica.engine
    real = prefill_eng.prefill
    armed = [True]

    def flaky(prompt, table, sampler=None):
        if armed[0]:
            armed[0] = False
            raise RuntimeError('injected prefill failure')
        return real(prompt, table, sampler)

    prefill_eng.prefill = flaky
    try:
        s1 = sched.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises(ServingError, match='injected'):
            s1.result(WAIT)
        assert len(sched.submit([4, 5, 6], max_new_tokens=4).result(
            WAIT)) == 4
    finally:
        sched.close(timeout=WAIT)
        worker.close()
    assert worker.stats['disagg_handoff_failures'] == 1
    assert worker.stats['disagg_handoffs'] == 1
    assert eng.pool.allocator.used == 0
    assert prefill_eng.pool.allocator.used == 0


def test_decode_keeps_stepping_while_a_handoff_is_pending(models):
    """A slow prefill does not stall the decode step: an active stream
    finishes its whole generation while the handoff is in flight."""
    _, pm = models
    eng, sched, worker = stack(pm, disagg=True)
    replica = worker.replica
    real = replica.prefill_to_payload
    gate = threading.Event()

    def slow(prompt, max_new):
        if len(prompt) > 4:                       # only the long prompt
            gate.wait(WAIT)
        return real(prompt, max_new)

    replica.prefill_to_payload = slow
    try:
        fast = sched.submit([1, 2], max_new_tokens=8)
        next(fast.iter_tokens(timeout=WAIT))      # it is decoding
        slow_s = sched.submit([5, 6, 7, 8, 9], max_new_tokens=4)
        time.sleep(0.05)
        assert len(fast.result(WAIT)) == 8
        assert not slow_s.done() and worker.pending == 1
        gate.set()
        assert len(slow_s.result(WAIT)) == 4
    finally:
        gate.set()
        sched.close(timeout=WAIT)
        worker.close()
    assert eng.pool.allocator.used == 0


def test_a_prefix_hit_skips_the_handoff(models):
    """A hit is filled by the decode engine's suffix steps: no second
    handoff for a repeated prompt; sampled requests prefill inline."""
    _, pm = models
    eng, sched, worker = stack(pm, disagg=True, prefix_cache=True)
    prompt = [7, 3, 11, 5, 9, 2, 44, 8, 13]
    ref = port_lm.greedy_generate(pm, prompt, 5, pad_len=eng.padded_context)
    try:
        assert sched.submit(prompt, max_new_tokens=5).result(WAIT) == ref
        assert worker.stats['disagg_handoffs'] == 1
        assert sched.submit(prompt, max_new_tokens=5).result(WAIT) == ref
        assert worker.stats['disagg_handoffs'] == 1
        sampled = sched.submit([4, 4, 4], max_new_tokens=3,
                               sampling={'temperature': 0.9},
                               request_id='inline')
        assert len(sampled.result(WAIT)) == 3
        assert worker.stats['disagg_handoffs'] == 1
    finally:
        sched.close(timeout=WAIT)
        worker.close()
    assert eng.prefix_cache.stats['prefix_cache_hits'] == 1
    assert eng.stats['prefills'] == 1             # the sampled request


def test_inject_skips_the_shared_blocks(models):
    """An injected payload writes only the blocks above ``cached_len``: a
    hit's shared blocks keep their bytes even when the payload's differ."""
    _, pm = models
    eng = DecodeEngine(pm, prefix_cache=True, **ENGINE_KW)
    prompt = [7, 3, 11, 5, 9, 2, 44, 8, 13]
    t = eng.reserve_table(len(prompt), 4, prompt=prompt)
    eng.prefill(prompt, t)
    eng.publish_prefix(prompt, t)
    eng.release_table(t)
    shared = eng.prefix_cache.resident_block_ids()
    before = [eng.pool.read_blocks(layer, shared)
              for layer in range(eng.pool.num_layers)]
    payload = PrefillReplica(DecodeEngine(pm, **ENGINE_KW)) \
        .prefill_to_payload(prompt)
    for k, v in payload.layers:
        k.zero_()
        v.zero_()
    hit = eng.reserve_table(len(prompt), 4, prompt=prompt)
    assert hit.cached_len == 8
    eng.inject_prefill(hit, payload)
    assert hit.context_len == len(prompt)
    for layer, (k, v) in enumerate(before):
        nk, nv = eng.pool.read_blocks(layer, shared)
        assert torch.equal(k, nk) and torch.equal(v, nv)
        tail_k, _ = eng.pool.read_blocks(layer, hit.blocks[2:3])
        assert not tail_k.any()                   # the private block: zeros
    eng.release_table(hit)


def test_payload_roundtrip_and_scratch_pool(models):
    _, pm = models
    eng = DecodeEngine(pm, **ENGINE_KW)
    pay = PrefillReplica(eng).prefill_to_payload([5, 6, 7, 8, 9])
    assert eng.pool.allocator.used == 0           # the pool is scratch
    clone = KVPayload.from_bytes(pay.to_bytes())
    assert (clone.context_len, clone.first_token, clone.block_size) == (
        5, pay.first_token, 4)
    assert clone.num_blocks == pay.num_blocks == 2
    assert len(clone.layers) == eng.pool.num_layers
    for (k1, v1), (k2, v2) in zip(pay.layers, clone.layers):
        assert torch.equal(k1, k2) and torch.equal(v1, v2)
    h, _, bs, d = pay.layers[0][0].shape
    assert pay.nbytes == clone.nbytes == len(pay.layers) * 2 * h * 2 * bs \
        * d * 4
    with LocalPrefillWorker(PrefillReplica(eng)) as w:
        w.submit('k', [1, 2, 3])
        done = w.drain_completed(WAIT)
    assert done[0][0] == 'k' and done[0][2] is None
