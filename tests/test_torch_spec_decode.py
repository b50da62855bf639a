"""The port's speculative decoding (ROADMAP A.5: serving/decode/drafter.py,
``DecodeEngine.spec_step``, the scheduler's verify rounds, the replica's
flags) against the JAX package's, on the CPU at ``CausalLMConfig.tiny()``
with the reference's geometry (4 slots, block 4, 64 blocks, prompts up to
16; tests/framework/test_spec_decode.py).

Tolerances: logits rows at atol 1e-5 (f32 sums in another order; the
verify rows of both packages, and each verify row against the port's own
lockstep row at the same context). Greedy streams are equal, or part only
at a near tie: the token that differs lies within 1e-3 of its row's max
logit under teacher forcing through the JAX model (as
tests/test_torch_decode_engine.py judges them)."""
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu.dygraph import guard
from paddle_tpu.dygraph.tape import Tensor, no_grad_guard
from paddle_tpu.serving import DecodeEngine as JaxEngine
from paddle_tpu.serving import DecodeScheduler as JaxScheduler
from paddle_tpu.serving.decode import drafter as jax_drafter
from paddle_tpu.serving.tier.replica import build_tiny_lm
from paddle_tpu_torch.convert import state_dict_from_paddle
from paddle_tpu_torch.models import causal_lm as port_lm
from paddle_tpu_torch.serving import (DecodeEngine, DecodeScheduler,
                                      InvalidRequest)
from paddle_tpu_torch.serving.decode.drafter import (DraftModelDrafter,
                                                     NGramDrafter,
                                                     build_drafter)
from torch_jax_seed import jax_seed_pinned  # noqa: F401  (caps threads)

REPO = Path(__file__).resolve().parents[1]
ENGINE_KW = dict(slots=4, block_size=4, max_blocks=64, max_prompt_len=16,
                 max_new_tokens_cap=16)
ATOL = 1e-5
NEAR_TIE = 1e-3
# (prompt lengths, budgets): the reference's _WORK
WORK = [((3, 7, 12, 5), (10, 4, 16, 7)), ((9, 1, 16, 2), (12, 16, 2, 9))]


def workload(seed):
    rng = np.random.RandomState(seed)
    lens, budgets = WORK[seed % len(WORK)]
    prompts = [[int(t) for t in rng.randint(3, 100, n)] for n in lens]
    return list(zip(prompts, budgets))


@pytest.fixture(scope='module')
def models():
    """The reference's seeded tiny LM and the port's with its weights; the
    tests run under the JAX package's dygraph guard."""
    with guard():
        jm = build_tiny_lm()
        named = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
        pm = port_lm.TransformerLM(port_lm.CausalLMConfig.tiny(),
                                   device='cpu')
        pm.load_state_dict(state_dict_from_paddle(named))
        pm.eval()
        yield jm, pm


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
            gaps = jax_gaps(jm, p, g, pad_len)
            assert gaps.max() <= NEAR_TIE, (g, w, gaps)


def run(engine, work, **submit_kw):
    with DecodeScheduler(engine, queue_depth=len(work) + 1) as sched:
        streams = [sched.submit(p, max_new_tokens=m, **submit_kw)
                   for p, m in work]
        outs = [s.result(240) for s in streams]
    assert engine.pool.allocator.used == 0
    return outs


@pytest.mark.parametrize('seed', range(4))
def test_drafters_propose_what_the_reference_proposes(models, seed):
    jm, pm = models
    rng = np.random.RandomState(seed)
    port, ref = NGramDrafter(), jax_drafter.NGramDrafter()
    for _ in range(50):
        hist = [int(t) for t in rng.randint(0, 6, rng.randint(1, 30))]
        n = int(rng.randint(0, 5))
        assert port.propose(hist, n) == ref.propose(hist, n)
    hist = [int(t) for t in rng.randint(0, 128, 6)]
    got = DraftModelDrafter(pm, 32).propose(hist, 3)
    want = jax_drafter.DraftModelDrafter(jm, 32).propose(hist, 3)
    if got != want:
        assert jax_gaps(jm, hist, got, 32).max() <= NEAR_TIE, (got, want)
    assert DraftModelDrafter(pm, 8).propose(hist, 5) == got[:2]


def test_build_drafter(models):
    _, pm = models
    d = NGramDrafter()
    history = [7, 8, 9, 4, 7, 8, 9]
    assert d.propose(history, 2) == [4, 7]
    assert d.propose([1, 2, 3], 4) == [] and d.propose([5], 3) == []
    assert build_drafter('off', 32) is None
    assert isinstance(build_drafter(None, 32), NGramDrafter)
    dm = build_drafter('draft_model', 32, draft_model=pm)
    assert dm.propose([3, 5, 7], 2) == port_lm.greedy_generate(
        pm, [3, 5, 7], 2, pad_len=32)
    tiny = build_drafter('draft_model', 32, device='cpu')
    assert tiny.model.cfg.vocab_size == 128
    assert len(tiny.propose([3, 5, 7], 2)) == 2
    with pytest.raises(InvalidRequest, match='supported'):
        build_drafter('nope', 32)
    assert build_drafter(d, 32) is d


def prefill_all(engine, prompts, firsts):
    tables = []
    for p, f in zip(prompts, firsts):
        t = engine.reserve_table(len(p), 12)
        engine.prefill(p, t, sampler=lambda r, f=f: f)
        tables.append(t)
    return tables


def test_spec_step_rows_match_jax(models):
    """One verify step of ragged feeds (4, 1 and 2 tokens, an inactive
    slot) after the same prefills: every fed row of the port's (S, k, V)
    rows within atol of the JAX engine's."""
    jm, pm = models
    rng = np.random.RandomState(7)
    prompts = [[int(t) for t in rng.randint(0, 128, n)] for n in (5, 9, 3)]
    feeds = [[int(t) for t in rng.randint(0, 128, f)] for f in (4, 1, 2)]
    rows = []
    for engine in (JaxEngine(jm, spec_decode=True, spec_k=4, **ENGINE_KW),
                   DecodeEngine(pm, spec_decode=True, spec_k=4,
                                **ENGINE_KW)):
        tables = prefill_all(engine, prompts, [f[0] for f in feeds])
        tokens = [feeds[0], feeds[1], None, feeds[2]]
        out = engine.spec_step(tokens, [tables[0], tables[1], None,
                                        tables[2]])
        assert out.shape == (4, 4, 128)
        assert [t.context_len for t in tables] == [9, 10, 5]
        rows.append(out)
    want, got = rows
    for s, f in ((0, 4), (1, 1), (3, 2)):
        np.testing.assert_allclose(got[s, :f], want[s, :f], atol=ATOL)


def test_verify_rows_equal_lockstep_rows_across_accept_lengths(models):
    """The _OffsetOracle idea: verify rounds with ragged windows and ragged
    accepted prefixes (each rolled back by one context_len store, across
    block edges) give, row for row, the port's own lockstep rows at the
    same contexts."""
    _, pm = models
    rng = np.random.RandomState(2)
    prompt = [int(t) for t in rng.randint(0, 128, 6)]
    forced = [int(t) for t in rng.randint(0, 128, 16)]
    lock = DecodeEngine(pm, **ENGINE_KW)
    spec = DecodeEngine(pm, spec_decode=True, spec_k=4, **ENGINE_KW)
    pad = [None] * 3
    t_lock = lock.reserve_table(len(prompt), 16)
    lock.prefill(prompt, t_lock)
    want = []
    for tok in forced[:-1]:
        _, r = lock.decode_step([tok] + pad, [t_lock] + pad,
                                return_rows=True)
        want.append(r[0])
    t_spec = spec.reserve_table(len(prompt), 16)
    spec.prefill(prompt, t_spec)
    i, windows, accepts, rounds = 0, [4, 1, 3, 2, 4, 4], [2, 1, 3, 1, 4, 1], 0
    while i < len(forced) - 1:
        f = min(windows[rounds % 6], len(forced) - 1 - i)
        base = t_spec.context_len
        out = spec.spec_step([forced[i:i + f]] + pad, [t_spec] + pad)
        for j in range(f):
            np.testing.assert_allclose(out[0, j], want[i + j], atol=ATOL)
        a = min(accepts[rounds % 6], f)
        t_spec.context_len = base + a         # roll the rejected tail back
        i += a
        rounds += 1
    assert rounds > 6


def test_greedy_spec_streams_match_lockstep_and_jax(models):
    """Greedy speculative streams (n-gram drafter) against the port's
    lockstep streams and the JAX scheduler's speculative streams, in fewer
    steps than lockstep."""
    jm, pm = models
    work = workload(0) + workload(1)
    lock_engine = DecodeEngine(pm, **ENGINE_KW)
    lockstep = run(lock_engine, work)
    spec_engine = DecodeEngine(pm, spec_decode=True, spec_k=4, **ENGINE_KW)
    spec = run(spec_engine, work)
    jeng = JaxEngine(jm, spec_decode=True, spec_k=4, **ENGINE_KW)
    with JaxScheduler(jeng) as js:
        want = [js.submit(p, max_new_tokens=m).result(240) for p, m in work]
    pad_len = spec_engine.padded_context
    assert_equal_or_near_tie(jm, work, spec, lockstep, pad_len)
    assert_equal_or_near_tie(jm, work, spec, want, pad_len)
    stats = spec_engine.stats
    assert stats['spec_rounds'] == stats['decode_steps'] > 0
    assert stats['decode_steps'] < lock_engine.stats['decode_steps']
    assert 0 < stats['spec_accepted'] <= stats['spec_drafted']


class OffsetOracle:
    """Drafts the true greedy continuation with every token id moved by
    ``off``: 0 has every draft accepted, 1 every draft rejected."""

    def __init__(self, prompt, ref, off=0):
        self.plen, self.ref, self.off = len(prompt), list(ref), int(off)

    def propose(self, history, n):
        i = len(history) - self.plen
        return [(t + self.off) % 128 for t in self.ref[i:i + int(n)]]


def test_oracle_drafters_accept_all_none_and_stop_at_eos(models):
    _, pm = models
    prompt = [3, 5, 7, 11, 13]
    ref = port_lm.greedy_generate(pm, prompt, 16, pad_len=32)
    for off, accepted in ((0, 'all'), (1, 'none')):
        eng = DecodeEngine(pm, spec_decode=True, spec_k=4, **ENGINE_KW)
        with DecodeScheduler(eng, drafter=OffsetOracle(prompt, ref,
                                                       off)) as sched:
            out = sched.submit(prompt, max_new_tokens=16).result(240)
        assert eng.pool.allocator.used == 0
        assert out == ref
        drafted, acc = eng.stats['spec_drafted'], eng.stats['spec_accepted']
        assert drafted > 0
        assert acc == (drafted if accepted == 'all' else 0)
    eos = ref[2]
    eng = DecodeEngine(pm, spec_decode=True, spec_k=4, **ENGINE_KW)
    with DecodeScheduler(eng, drafter=OffsetOracle(prompt, ref)) as sched:
        s = sched.submit(prompt, max_new_tokens=16, eos_id=eos)
        assert s.result(240) == ref[:ref.index(eos) + 1]
        assert s.finish_reason == 'stop'
    assert eng.pool.allocator.used == 0


def test_sampled_spec_streams_equal_lockstep(models):
    _, pm = models
    params = {'temperature': 1.1, 'top_p': 0.9}
    work = [([9, 2, 31], 8), ([4, 4, 4, 4], 12)]
    lockstep = run(DecodeEngine(pm, **ENGINE_KW), work, sampling=params,
                   request_id='spec-sampled')
    spec = run(DecodeEngine(pm, spec_decode=True, **ENGINE_KW), work,
               sampling=params, request_id='spec-sampled')
    assert spec == lockstep
    assert run(DecodeEngine(pm, spec_decode=True, **ENGINE_KW), work,
               sampling=params, request_id='spec-sampled') == lockstep


def test_warmup_covers_the_verify_shape(models):
    _, pm = models
    eng = DecodeEngine(pm, spec_decode=True, **ENGINE_KW)
    assert not eng.warmed
    timings = eng.warmup()
    assert eng.warmed and 'spec_step' in timings
    assert eng.stats['spec_rounds'] == 1
    assert eng.pool.allocator.used == 0
    plain = DecodeEngine(pm, **ENGINE_KW)
    assert 'spec_step' not in plain.warmup() and plain.warmed


def test_escape_hatch_and_knobs(models, monkeypatch):
    _, pm = models
    monkeypatch.setenv('PADDLE_TPU_SPEC_DECODE', '0')
    eng = DecodeEngine(pm, spec_decode=True, **ENGINE_KW)
    assert not eng.spec_enabled
    with DecodeScheduler(eng) as sched:
        assert sched.drafter is None
        assert sched.submit([5, 9, 2], max_new_tokens=6).result(120) == \
            port_lm.greedy_generate(pm, [5, 9, 2], 6,
                                    pad_len=eng.padded_context)
    monkeypatch.setenv('PADDLE_TPU_SPEC_DECODE', '1')
    monkeypatch.setenv('PADDLE_TPU_SPEC_K', '3')
    eng = DecodeEngine(pm, **ENGINE_KW)
    assert eng.spec_enabled and eng.spec_k == 3
    assert DecodeEngine(pm, spec_decode=False, **ENGINE_KW).spec_enabled is \
        False
    monkeypatch.setenv('PADDLE_TPU_SPEC_DRAFTER', 'off')
    with DecodeScheduler(eng, start=False) as sched:
        assert sched.drafter is None
    monkeypatch.setenv('PADDLE_TPU_SPEC_DRAFTER', 'bogus')
    with pytest.raises(ValueError, match='bogus'):
        DecodeScheduler(eng, start=False)
    for name, bad in (('PADDLE_TPU_SPEC_DECODE', 'yes'),
                      ('PADDLE_TPU_SPEC_K', '1')):
        monkeypatch.setenv('PADDLE_TPU_SPEC_DRAFTER', 'ngram')
        monkeypatch.setenv(name, bad)
        with pytest.raises(ValueError, match=name):
            DecodeEngine(pm, **ENGINE_KW)
        monkeypatch.setenv(name, {'PADDLE_TPU_SPEC_DECODE': '1',
                                  'PADDLE_TPU_SPEC_K': '3'}[name])
    with pytest.raises(ValueError, match='spec_k'):
        DecodeEngine(pm, spec_decode=True, spec_k=1, **ENGINE_KW)


def test_replica_cli_flags():
    env = {k: v for k, v in os.environ.items()
           if k not in ('CUDA_VISIBLE_DEVICES', 'PADDLE_TPU_SPEC_DECODE')}
    env['PADDLE_TPU_KV_DTYPE'] = 'int8'
    proc = subprocess.Popen(
        [sys.executable, '-m', 'paddle_tpu_torch.serving.tier.replica',
         '--port', '0', '--config', 'tiny', '--device', 'cpu', '--slots',
         '2', '--block-size', '4', '--max-blocks', '32', '--max-prompt-len',
         '8', '--max-new-tokens-cap', '8', '--spec-decode', '1',
         '--spec-k', '3', '--drafter', 'ngram'],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready['ready'] and ready['spec_decode'] is True
        assert ready['spec_k'] == 3 and ready['kv_dtype'] == 'int8'
        req = urllib.request.Request(
            f'http://127.0.0.1:{ready["port"]}/generate',
            data=json.dumps({'prompt': [1, 2, 1, 2, 1], 'max_new_tokens': 6,
                             'stream': False}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert len(json.loads(r.read())['tokens']) == 6
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
    bad = subprocess.run(
        [sys.executable, '-m', 'paddle_tpu_torch.serving.tier.replica',
         '--drafter', 'oracle'], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert bad.returncode == 2 and '--drafter' in bad.stderr
