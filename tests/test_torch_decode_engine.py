"""The port's decode-serving path (paddle_tpu_torch/serving/) against the JAX
package's, on the CPU at CausalLMConfig.tiny() with small pools: engine
logits rows under teacher forcing (atol 1e-4), greedy streams through the
scheduler (near-tie rule: a token that differs from the JAX stream must lie
within 1e-3 of the JAX row's max logit), block lifecycle, sampling replay,
HTTP /generate and the replica CLI."""
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.dygraph import guard
from paddle_tpu.dygraph.tape import Tensor, no_grad_guard
from paddle_tpu.models import causal_lm as jax_lm
from paddle_tpu.serving import DecodeEngine as JaxEngine
from paddle_tpu.serving import DecodeScheduler as JaxScheduler
from paddle_tpu_torch.convert import state_dict_from_paddle
from paddle_tpu_torch.models import causal_lm as port_lm
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.serving import (DecodeEngine, DecodeScheduler,
                                      InvalidRequest, SamplingParams,
                                      ServingServer, TokenSampler)
import torch_jax_seed  # noqa: F401  (caps torch's threads)

REPO = Path(__file__).resolve().parents[1]
ENGINE_KW = dict(slots=4, block_size=4, max_blocks=64, max_prompt_len=16,
                 max_new_tokens_cap=16)
ATOL = 1e-4
NEAR_TIE = 1e-3


@pytest.fixture(scope='module')
def models():
    with guard():
        jm = jax_lm.TransformerLM(jax_lm.CausalLMConfig.tiny())
        jm.eval()
        named = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
        pm = port_lm.TransformerLM(port_lm.CausalLMConfig.tiny(),
                                   device='cpu')
        pm.load_state_dict(state_dict_from_paddle(named))
        pm.eval()
        yield jm, pm


def teacher_forced_rows(engine, prompts, forced):
    """Prefill each prompt into its own slot, then decode under teacher
    forcing (slot i is fed forced[i][j] at step j); returns the prefill
    rows and the per-step rows of the active slots."""
    tables, rows = [], []
    for p, f in zip(prompts, forced):
        t = engine.reserve_table(len(p), len(f))
        captured = []
        engine.prefill(p, t, sampler=lambda r: captured.append(r) or f[0])
        rows.append(captured[0])
        tables.append(t)
    pad = engine.slots - len(prompts)
    for j in range(1, len(forced[0])):
        _, step = engine.decode_step([f[j - 1] for f in forced] + [None] * pad,
                                     tables + [None] * pad, return_rows=True)
        rows.extend(step[:len(prompts)])
    for t in tables:
        engine.release_table(t)
    return np.stack(rows)


def test_prefill_and_decode_rows_match_jax(models):
    jm, pm = models
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, 128, n)] for n in (5, 11, 1)]
    forced = [[int(t) for t in rng.randint(0, 128, 5)] for _ in prompts]
    want = teacher_forced_rows(JaxEngine(jm, **ENGINE_KW), prompts, forced)
    got = teacher_forced_rows(DecodeEngine(pm, **ENGINE_KW), prompts, forced)
    assert got.shape == want.shape == (3 + 3 * 4, 128)
    np.testing.assert_allclose(got, want, atol=ATOL)


def jax_gaps(jm, prompt, tokens, pad_len):
    seq = np.zeros((1, pad_len), np.int64)
    seq[0, :len(prompt) + len(tokens)] = list(prompt) + list(tokens)
    with no_grad_guard():
        logits = np.asarray(jm(Tensor(seq, stop_gradient=True)).numpy())
    rows = logits[0, len(prompt) - 1:len(prompt) - 1 + len(tokens)]
    return rows.max(-1) - rows[np.arange(len(tokens)), tokens]


def test_greedy_streams_match_jax_scheduler(models):
    jm, pm = models
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(3, 100, n)]
               for n in (3, 7, 12, 5, 9, 1, 16)]
    budgets = [10, 4, 16, 7, 12, 16, 2]
    jeng = JaxEngine(jm, **ENGINE_KW)
    with JaxScheduler(jeng) as js:
        want = [js.submit(p, max_new_tokens=b).result(120)
                for p, b in zip(prompts, budgets)]
    engine = DecodeEngine(pm, **ENGINE_KW)
    nn_ops.reset_launch_counts()
    with DecodeScheduler(engine) as sched:
        streams = [sched.submit(p, max_new_tokens=b)
                   for p, b in zip(prompts, budgets)]
        got = [s.result(120) for s in streams]
    for p, b, g, w, s in zip(prompts, budgets, got, want, streams):
        assert len(g) == b and s.finish_reason == 'length'
        if g != w:
            gaps = jax_gaps(jm, p, g, engine.padded_context)
            assert gaps.max() <= NEAR_TIE, (g, w, gaps)
    # every block returns to the pool once the scheduler drains
    assert engine.pool.allocator.used == 0
    assert engine.pool.allocator.available == engine.pool.allocator.capacity
    assert engine.stats['prefills'] == len(prompts)
    assert nn_ops.launch_counts() == {'paged_attention': 0,
                                      'paged_prefill_attention': 0,
                                      'flash_attention_fwd': 0,
                                      'flash_attention_bwd_dkv': 0,
                                      'flash_attention_bwd_dq': 0,
                                      'conv1x1_bn_act': 0}


def test_eos_and_sampled_replay(models):
    _, pm = models
    engine = DecodeEngine(pm, **ENGINE_KW)
    prompt = [5, 9, 2, 44]
    ref = port_lm.greedy_generate(pm, prompt, 8,
                                  pad_len=engine.padded_context)
    params = {'temperature': 0.9, 'top_k': 20, 'top_p': 0.95}
    with DecodeScheduler(engine) as sched:
        s = sched.submit(prompt, max_new_tokens=8, eos_id=ref[0])
        assert s.result(60) == [ref[0]] and s.finish_reason == 'stop'
        a = sched.submit(prompt, 12, sampling=params, request_id='r-1')
        b = sched.submit(prompt, 12, sampling=params, request_id='r-1')
        c = sched.submit(prompt, 12, sampling=params, request_id='r-2')
        ta, tb, tc = a.result(60), b.result(60), c.result(60)
    assert ta == tb and len(ta) == 12
    assert ta != tc
    assert engine.pool.allocator.used == 0
    # the uncached reference draws the same stream from the same sampler
    sampler = TokenSampler(SamplingParams.validate(params), 'r-1')
    assert port_lm.sampled_generate(
        pm, prompt, 12, sampler.sample,
        pad_len=engine.padded_context) == ta


def test_validation_and_later_slices(models):
    """Admission checks, and the serving pieces the JAX package's server
    and router answer the same way: a server with neither an engine nor a
    generator is refused with the reference's message, and the router's
    fleet metrics over an unreachable replica are an empty merge with one
    scrape failure counted. (The prefix cache and disaggregated prefill
    run too: tests/test_torch_prefix_cache.py and
    tests/test_torch_disagg.py; /predict: tests/test_torch_serving_http.py.)"""
    from paddle_tpu.observability import registry as jax_registry
    from paddle_tpu.serving import Router as JaxRouter
    from paddle_tpu.serving import ServingServer as JaxServer
    from paddle_tpu_torch.observability import registry
    from paddle_tpu_torch.serving import Router
    _, pm = models
    engine = DecodeEngine(pm, **ENGINE_KW)
    with pytest.raises(InvalidRequest):
        engine.validate([], 4)
    with pytest.raises(InvalidRequest):
        engine.validate([1] * 17, 4)
    with pytest.raises(InvalidRequest):
        engine.validate([1, 128], 4)            # id outside the vocab
    with pytest.raises(InvalidRequest):
        engine.validate([1], 17)
    assert DecodeEngine(pm, **ENGINE_KW,
                        prefix_cache=True).prefix_cache is not None
    sched = DecodeScheduler(engine, disagg=object(), start=False)
    assert sched.disagg is not None
    messages = []
    for server_cls in (ServingServer, JaxServer):
        with pytest.raises(ValueError) as ei:
            server_cls(None, generator=None)
        messages.append(str(ei.value))
    assert messages[0] == messages[1] == ('need an engine, a generator, '
                                          'or both')
    for router_cls, reg in ((Router, registry), (JaxRouter, jax_registry)):
        router = router_cls(['http://127.0.0.1:9'], connect_timeout=0.5,
                            start=False)
        failures = reg.counter('router_scrape_failures').labels(
            replica='http://127.0.0.1:9')
        before = failures.value
        assert router.fleet_metrics_text(timeout_s=0.5) == ''
        assert failures.value == before + 1
        router.close()


def _post(port, path, body):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_generate_over_http(models):
    _, pm = models
    engine = DecodeEngine(pm, **ENGINE_KW)
    sched = DecodeScheduler(engine)
    srv = ServingServer(None, port=0, generator=sched, warmup=True).start()
    try:
        prompt = [3, 1, 4, 1, 5]
        ref = port_lm.greedy_generate(pm, prompt, 6,
                                      pad_len=engine.padded_context)
        code, body = _post(srv.port, '/generate',
                           {'prompt': prompt, 'max_new_tokens': 6,
                            'stream': False, 'request_id': 'http-1'})
        assert code == 200
        reply = json.loads(body)
        assert reply['tokens'] == ref and reply['finish_reason'] == 'length'
        assert reply['request_id'] == 'http-1'
        code, body = _post(srv.port, '/generate',
                           {'prompt': prompt, 'max_new_tokens': 6})
        lines = [json.loads(ln) for ln in body.splitlines()]
        assert code == 200
        assert [ln['token'] for ln in lines[:-1]] == ref
        assert lines[-1]['done'] and lines[-1]['tokens'] == ref
        code, body = _post(srv.port, '/generate',
                           {'prompt': prompt, 'temprature': 1.0})
        assert code == 400 and 'temprature' in body
        code, _ = _post(srv.port, '/generate',
                        {'prompt': prompt, 'max_new_tokens': 99})
        assert code == 400
        code, body = _post(srv.port, '/predict', {'inputs': {}})
        assert code == 404 and json.loads(body) == {
            'error': 'NotFound',
            'message': 'no predict engine configured (decode-only server; '
                       'use POST /generate)'}
        with urllib.request.urlopen(
                f'http://127.0.0.1:{srv.port}/healthz', timeout=30) as r:
            health = json.loads(r.read())
        assert health['status'] == 'ok' and health['warmup']['done']
        assert health['decode']['cache_blocks_used'] == 0
    finally:
        srv.shutdown()
    assert not sched._worker.is_alive()


def _replica(*args):
    env = {k: v for k, v in os.environ.items() if k != 'CUDA_VISIBLE_DEVICES'}
    return subprocess.Popen(
        [sys.executable, '-m', 'paddle_tpu_torch.serving.tier.replica',
         '--port', '0', '--config', 'tiny', '--slots', '2',
         '--block-size', '4', '--max-blocks', '32', '--max-prompt-len', '8',
         '--max-new-tokens-cap', '8', *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def test_replica_cli_serves_on_cpu():
    proc = _replica('--device', 'cpu')
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready['ready'] and ready['device'] == 'cpu'
        code, body = _post(ready['port'], '/generate',
                           {'prompt': [1, 2, 3], 'max_new_tokens': 4,
                            'stream': False})
        assert code == 200 and len(json.loads(body)['tokens']) == 4
    finally:
        proc.terminate()
        proc.communicate(timeout=60)


def test_replica_cli_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('this machine has a card: the default device works')
    proc = _replica()
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0 and not out
    assert 'no CUDA device' in err
