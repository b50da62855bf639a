"""The port's multi-replica router (paddle_tpu_torch/serving/tier/router.py)
over in-process CPU replicas and replica processes, against the JAX
package's router tests case by case (tests/framework/test_serving_tier.py
and test_router_failover.py): the strict knobs, routed streams equal to the
uncached reference, least-loaded dispatch, the cold-replica gate, a
degraded replica drained and a half-open one re-admitted by its probe,
failover mid-stream (only the in-flight stream fails), a rolling restart
behind a drain, HTTP end to end, and ``kill -9`` of a replica process
(``--device cpu``) mid-stream. The least-loaded, degraded/half-open and
failover cases run the JAX package's Router through the same scenario
over the same kind of replicas and hold its replica states, choices and
counters (its metrics registry) to the port's.

Every replica here serves ``CausalLMConfig.tiny()`` with the weights of
``build_lm('tiny', seed)``, so any replica answers any request with the
bytes of the port's uncached ``greedy_generate`` on the CPU. Every request
and server has its own time limit (``WAIT``), every replica process is
killed at the end of its test, and the subprocess drill waits at most 180
s for a replica to start."""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from paddle_tpu.serving.tier.router import Router as JaxRouter
from paddle_tpu_torch.models.causal_lm import greedy_generate
from paddle_tpu_torch.serving import (NoReplicaAvailable, Router,
                                      RouterServer, ServingError,
                                      ServingServer)
from paddle_tpu_torch.serving.tier import knobs
from paddle_tpu_torch.serving.tier.replica import (DEFAULT_SEED, build_lm,
                                                   build_replica_stack)
import torch_jax_seed  # noqa: F401  (caps torch's threads)

REPO = Path(__file__).resolve().parents[1]
ENGINE_KW = dict(slots=2, block_size=4, max_blocks=64, max_prompt_len=16,
                 max_new_tokens_cap=16)
WAIT = 60


@pytest.fixture(scope='module')
def lm():
    return build_lm('tiny', DEFAULT_SEED, 'cpu')


def ref(lm, prompt, n, cap=ENGINE_KW['max_new_tokens_cap']):
    pad = -(-(ENGINE_KW['max_prompt_len'] + cap) // 4) * 4
    return greedy_generate(lm, prompt, n, pad_len=pad)


class InProcReplica:
    """One in-process replica stack behind its HTTP listener."""

    def __init__(self, lm, replica_id, warm=True, **kw):
        self.engine, self.scheduler, self.worker = build_replica_stack(
            lm, replica_id=replica_id, **{**ENGINE_KW, **kw})
        if warm:
            self.engine.warmup()
        self.server = ServingServer(None, port=0, generator=self.scheduler,
                                    request_timeout=WAIT).start()
        self.url = f'http://127.0.0.1:{self.server.port}'

    def shutdown(self, drain=True):
        self.server.shutdown(drain=drain, timeout=WAIT)
        if self.worker is not None:
            self.worker.close()


@pytest.fixture()
def pair(lm):
    reps = [InProcReplica(lm, f'rep-{i}', prefix_cache=True)
            for i in range(2)]
    yield reps
    for r in reps:
        r.shutdown()


def get_json(url):
    with urllib.request.urlopen(url, timeout=WAIT) as r:
        return json.load(r)


def post(url, body):
    req = urllib.request.Request(url + '/generate',
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return r.read()


def test_router_knobs_strict_parse(monkeypatch):
    env = {'PADDLE_TPU_ROUTER_PORT': 'auto'}
    with pytest.raises(ValueError, match='PADDLE_TPU_ROUTER_PORT'):
        knobs.parse_int_env(knobs.ENV_ROUTER_PORT, 8180, minimum=0,
                            maximum=65535, environ=env)
    with pytest.raises(ValueError, match='<= 65535'):
        knobs.parse_int_env(knobs.ENV_ROUTER_PORT, 8180, minimum=0,
                            maximum=65535,
                            environ={'PADDLE_TPU_ROUTER_PORT': '99999'})
    for bad, match in (('fast', 'PADDLE_TPU_ROUTER_HEALTH_POLL_S'),
                       ('0', '> 0')):
        with pytest.raises(ValueError, match=match):
            knobs.parse_float_env(
                knobs.ENV_ROUTER_HEALTH_POLL_S, 1.0,
                environ={'PADDLE_TPU_ROUTER_HEALTH_POLL_S': bad})
    assert knobs.parse_float_env(knobs.ENV_ROUTER_HEALTH_POLL_S, 1.0,
                                 environ={}) == 1.0
    with pytest.raises(ValueError, match='PADDLE_TPU_ROUTER_REPLICAS'):
        knobs.parse_replicas_env(
            environ={'PADDLE_TPU_ROUTER_REPLICAS': 'localhost'})
    with pytest.raises(ValueError, match='empty entry'):
        knobs.parse_replicas_env(
            environ={'PADDLE_TPU_ROUTER_REPLICAS': 'a:1,,b:2'})
    monkeypatch.setenv('PADDLE_TPU_ROUTER_REPLICAS',
                       'http://a:1,b:2, http://c:3/')
    assert knobs.parse_replicas_env() == ['http://a:1', 'http://b:2',
                                          'http://c:3']
    monkeypatch.setenv('PADDLE_TPU_ROUTER_HEALTH_POLL_S', 'fast')
    with pytest.raises(ValueError, match='HEALTH_POLL_S'):
        Router(['http://127.0.0.1:9'], start=False)


def test_routed_parity_and_result_metadata(lm, pair):
    with Router([r.url for r in pair], health_poll_s=0.2) as router:
        prompt = [5, 9, 2, 44, 7, 3, 11, 5, 1]
        want = ref(lm, prompt, 6)
        finals = [router.generate(prompt, max_new_tokens=6)
                  for _ in range(4)]
        for fin in finals:
            assert fin['tokens'] == want and fin['retries'] == 0
            assert fin['replica'] in [r.url for r in pair]
            assert fin['replica_id'] in ('rep-0', 'rep-1')
        assert len({f['request_id'] for f in finals}) == 4
        body = router.generate_nonstream(prompt, max_new_tokens=6)
        assert body['tokens'] == want and body['retries'] == 0
        assert router.stats['router_requests'] == 5
        assert router.stats['router_requests_completed'] == 5
        assert len(router.stats['router_dispatch_seconds']) == 5
    # the replicas' prefix caches served the repeats
    assert sum(r.engine.prefix_cache.stats['prefix_cache_hits']
               for r in pair) >= 3


# the router counters both packages keep: the port's ``Router.stats``, the
# JAX package's metrics registry (process-wide, so read as deltas)
COUNTED = ('router_requests', 'router_requests_completed',
           'router_requests_failed', 'router_requests_rerouted',
           'router_probes')
NONE = dict.fromkeys(COUNTED, 0)


def counts(router):
    if isinstance(router, Router):
        return {n: router.stats[n] for n in COUNTED}
    from paddle_tpu.observability import registry
    table = registry.to_dict()
    return {n: int(sum(s['value'] for s in table[n]['samples']))
            if n in table else 0 for n in COUNTED}


def delta(before, after):
    return {n: after[n] - before[n] for n in COUNTED}


def where(reps, url):
    return [r.url for r in reps].index(url)


def hold_steps(reps):
    """Make each replica's decode step wait for the returned gate, and
    raise once its replica is in the returned set."""
    gate, failing = threading.Event(), set()
    for r in reps:
        def step(*a, _real=r.engine.decode_step, _r=r, **k):
            gate.wait(WAIT)
            if _r in failing:
                raise RuntimeError('injected replica failure')
            return _real(*a, **k)
        r.engine.decode_step = step
    return gate, failing


def least_loaded_run(lm, router_cls):
    """One replica holds a long generation in its first decode step, the
    router polls, then sends three short requests."""
    reps = [InProcReplica(lm, f'rep-{i}', prefix_cache=True)
            for i in range(2)]
    try:
        with router_cls([r.url for r in reps], health_poll_s=60) as router:
            c0 = counts(router)
            gate, _ = hold_steps(reps[:1])
            try:
                long_s = reps[0].scheduler.submit([3, 5, 7],
                                                  max_new_tokens=16)
                next(long_s.iter_tokens(timeout=WAIT))
                router.poll_once()
                loads = [r.reported_load for r in router.replicas]
                fins = [router.generate([9, 2], max_new_tokens=2)
                        for _ in range(3)]
            finally:
                gate.set()
            return {'loads': loads,
                    'chosen': [where(reps, f['replica']) for f in fins],
                    'tokens': [f['tokens'] for f in fins]
                    + [long_s.result(WAIT)],
                    'counts': delta(c0, counts(router))}
    finally:
        for r in reps:
            r.shutdown()


def test_least_loaded_dispatch(lm):
    """With one replica holding a long generation, short requests land on
    the idle one; the JAX package's Router over the same replicas sees
    the same loads, picks the same replica and counts the same."""
    port = least_loaded_run(lm, Router)
    assert port['loads'] == [1, 0] and port['chosen'] == [1, 1, 1]
    assert port['tokens'] == [ref(lm, [9, 2], 2)] * 3 + [
        ref(lm, [3, 5, 7], 16)]
    assert port['counts'] == {**NONE, 'router_requests': 3,
                              'router_requests_completed': 3}
    assert least_loaded_run(lm, JaxRouter) == port


def test_cold_replica_not_routed_until_warm(lm):
    cold = InProcReplica(lm, 'cold', warm=False)
    try:
        health = get_json(cold.url + '/healthz')
        assert health['status'] == 'ok'
        assert health['warmup'] == {'decode': False, 'done': False}
        with Router([cold.url], health_poll_s=10,
                    connect_timeout=2) as router:
            assert not router.replicas[0].routable()
            with pytest.raises(NoReplicaAvailable):
                router.generate([1, 2], max_new_tokens=2, timeout=0.5)
            assert router.stats['router_no_replica'] >= 1
            cold.engine.warmup()
            router.poll_once()
            assert router.replicas[0].routable()
            assert len(router.generate([1, 2],
                                       max_new_tokens=2)['tokens']) == 2
        health = get_json(cold.url + '/healthz')
        assert health['warmup'] == {'decode': True, 'done': True}
        assert health['replica'] == 'cold'
    finally:
        cold.shutdown()


def degraded_run(lm, router_cls):
    """A replica's breaker trips (drained), cools down (half-open), takes
    the router's probe and closes; (routable, healthy, half_open) at each
    poll."""
    rep = InProcReplica(lm, 'trippy')
    rep.scheduler.breaker.failure_threshold = 2
    rep.scheduler.breaker.reset_after_s = 0.4
    try:
        with router_cls([rep.url], health_poll_s=60,
                        connect_timeout=2) as router:
            r0, seen = router.replicas[0], []

            def look():
                seen.append((r0.routable(), r0.healthy, r0.half_open))

            c0 = counts(router)
            look()
            rep.scheduler.breaker.record_failure()
            rep.scheduler.breaker.record_failure()       # open
            router.poll_once()
            look()
            time.sleep(0.5)                              # cooldown
            router.poll_once()
            look()
            fin = router.generate([1, 2], max_new_tokens=2)
            router.poll_once()
            look()
            return {'seen': seen, 'tokens': fin['tokens'],
                    'counts': delta(c0, counts(router))}
    finally:
        rep.shutdown()


def test_degraded_replica_drained_then_probe_readmits(lm):
    port = degraded_run(lm, Router)
    assert port['seen'] == [(True, True, False),     # healthy
                            (False, False, False),   # degraded: drained
                            (True, False, True),     # half-open: the probe
                            (True, True, False)]     # closed again
    assert port['tokens'] == ref(lm, [1, 2], 2)
    assert port['counts'] == {**NONE, 'router_requests': 1,
                              'router_requests_completed': 1,
                              'router_probes': 1}
    assert degraded_run(lm, JaxRouter) == port


def failover_run(lm, router_cls):
    """A replica fails mid-stream, then dies; four requests follow. Then a
    router that believes the dead replica healthy sends one more."""
    reps = [InProcReplica(lm, f'rep-{i}', prefix_cache=True)
            for i in range(2)]
    down = set()
    try:
        with router_cls([r.url for r in reps], health_poll_s=60) as router:
            c0 = counts(router)
            gate, failing = hold_steps(reps)
            try:
                gen = router.stream_generate([3, 5, 7], max_new_tokens=16)
                events = gen.events()
                next(events)                      # the prefill's token
                victim = where(reps, gen.replica)
                failing.add(reps[victim])
            finally:
                gate.set()
            tail = [('error' in e, bool(e.get('done'))) for e in events]
            reps[victim].shutdown(drain=False)
            down.add(victim)
            fins = [router.generate([9, 2], max_new_tokens=3)
                    for _ in range(4)]
            out = {'victim': victim, 'tail': tail,
                   'chosen': [where(reps, f['replica']) for f in fins],
                   'retries': [f['retries'] for f in fins],
                   'tokens': [f['tokens'] for f in fins],
                   'counts': delta(c0, counts(router))}
        # a replica believed healthy but refusing: rerouted before any event
        with router_cls([reps[victim].url, reps[1 - victim].url],
                        health_poll_s=60, start=False) as router:
            router.replicas[0].healthy = router.replicas[0].warmed = True
            c0 = counts(router)
            fin = router.generate([9, 2], max_new_tokens=3)
            body = router.generate_nonstream([9, 2], max_new_tokens=3)
            out['refusing'] = (where(reps, fin['replica']), fin['retries'],
                               fin['tokens'], body['tokens'],
                               delta(c0, counts(router)))
        return out
    finally:
        for i, r in enumerate(reps):
            if i not in down:
                r.shutdown()


def test_midstream_failover_kills_only_the_inflight_stream(lm):
    """A replica failing mid-stream errors its in-flight stream; requests
    sent after it dies (its port refusing) reroute to the survivor with no
    drop. The JAX package's Router, through the same scenario over the
    same kind of replicas, picks and counts the same."""
    port = failover_run(lm, Router)
    want = ref(lm, [9, 2], 3)
    survivor = 1 - port['victim']
    assert port['tail'] == [(True, False)]
    assert port['chosen'] == [survivor] * 4 and port['tokens'] == [want] * 4
    assert port['retries'] == [1, 0, 0, 0]
    assert port['counts'] == {**NONE, 'router_requests': 5,
                              'router_requests_completed': 4,
                              'router_requests_failed': 1,
                              'router_requests_rerouted': 1}
    assert port['refusing'][:4] == (survivor, 1, want, want)
    assert port['refusing'][4]['router_requests_rerouted'] >= 1
    assert failover_run(lm, JaxRouter) == port


def test_rolling_restart_behind_drain(lm, pair):
    """Both replicas restart one at a time behind a drain while traffic
    flows: every request during the roll completes with the reference's
    tokens, and some are served by the restarted replicas."""
    want = ref(lm, [5, 9, 2], 3)
    with Router([r.url for r in pair], health_poll_s=0.2) as router:
        results, errors = [], []
        stop = threading.Event()

        def traffic():
            while not stop.is_set():
                try:
                    results.append(router.generate([5, 9, 2],
                                                   max_new_tokens=3))
                except Exception as e:
                    errors.append(e)
                time.sleep(0.02)

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        by_url = {r.url: r for r in pair}

        def restart(url):
            old = by_url.pop(url)
            old.shutdown()
            fresh = InProcReplica(lm, old.server.replica_id + '-r2',
                                  prefix_cache=True)
            by_url[fresh.url] = fresh
            return fresh.url

        try:
            router.rolling_restart(restart, drain_timeout=WAIT,
                                   warm_timeout=WAIT, poll_interval=0.05)
            time.sleep(0.2)
        finally:
            stop.set()
            t.join(WAIT)
            pair[:] = list(by_url.values())
        assert not t.is_alive()
        assert router.stats['router_rolling_restarts'] == 2
        assert not errors, errors
        assert results and all(f['tokens'] == want for f in results)
        assert any(f['replica_id'].endswith('-r2') for f in results)


def test_membership_add_and_remove(lm, pair):
    with Router([pair[0].url], health_poll_s=10) as router:
        rep = router.add_replica(pair[1].url + '/')
        assert router.add_replica(pair[1].url) is rep
        deadline = time.monotonic() + WAIT
        while not rep.routable() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert rep.routable()
        router.drain(pair[0].url)
        assert router.generate([1, 2], max_new_tokens=2)['replica'] == \
            pair[1].url
        router.undrain(pair[0].url)
        router.remove_replica(pair[1].url)
        assert [r.url for r in router.replicas] == [pair[0].url]
        with pytest.raises(KeyError):
            router.remove_replica(pair[1].url)


def test_router_http_end_to_end(lm, pair):
    want = ref(lm, [5, 9, 2, 44], 6)
    with Router([r.url for r in pair], health_poll_s=0.2) as router:
        with RouterServer(router, port=0).start() as rs:
            url = f'http://127.0.0.1:{rs.port}'
            lines = [json.loads(ln) for ln in post(
                url, {'prompt': [5, 9, 2, 44],
                      'max_new_tokens': 6}).splitlines()]
            assert [ln['token'] for ln in lines if 'token' in ln] == want
            done = lines[-1]
            assert done['done'] and done['replica'] in [r.url for r in pair]
            assert done['retries'] == 0 and done['request_id']
            body = json.loads(post(url, {'prompt': [5, 9, 2, 44],
                                         'max_new_tokens': 6,
                                         'stream': False}))
            assert body['tokens'] == want and body['replica']
            for bad, code in (({'prompt': ['x']}, 400),
                              ({'prompt': [1], 'temprature': 1}, 400)):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    post(url, bad)
                assert ei.value.code == code
            h = get_json(url + '/healthz')
            assert h['status'] == 'ok' and h['routable'] == 2
            # the router's registry, and the replicas' merged metrics: the
            # pair runs in this process, so each replica's /metrics is the
            # one registry here and the merged counters are twice its own
            from paddle_tpu_torch.observability import distributed
            with urllib.request.urlopen(url + '/metrics', timeout=30) as r:
                own = distributed.parse_prometheus_text(r.read().decode())
            assert own['paddle_tpu_router_requests']['samples'][0][2] >= 2
            assert own['paddle_tpu_router_requests_completed'][
                'samples'][0][2] >= 2
            with urllib.request.urlopen(url + '/metrics/fleet',
                                        timeout=30) as r:
                fleet = distributed.parse_prometheus_text(r.read().decode())
            tokens = fleet['paddle_tpu_decode_tokens_generated']
            assert tokens['type'] == 'counter'
            assert tokens['samples'][0][2] == 2 * own[
                'paddle_tpu_decode_tokens_generated']['samples'][0][2]
            slots = fleet['paddle_tpu_decode_slots_total']['samples']
            assert len(slots) == 2 and {s[1]['replica'] for s in slots} \
                == {rep.replica_id for rep in router.replicas}
        assert router.fleet_metrics_text()


def test_no_replica_available_is_typed():
    router = Router(['http://127.0.0.1:9'], health_poll_s=10,
                    connect_timeout=0.5, start=False)
    with pytest.raises(NoReplicaAvailable, match='no routable replica'):
        router.generate([1, 2], max_new_tokens=2, timeout=0.6)
    assert router.stats['router_no_replica'] >= 1
    router.close()


# -- replica processes -------------------------------------------------------

def spawn(*args):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('PADDLE_TPU_')}
    proc = subprocess.Popen(
        [sys.executable, '-m', *args], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    box = []
    reader = threading.Thread(target=lambda: box.append(
        proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(180)
    if not box or not box[0].strip():
        proc.kill()
        raise RuntimeError(f'{args[0]} did not start (rc {proc.poll()})')
    ready = json.loads(box[0])
    assert ready['ready'] and ready['pid'] == proc.pid
    return proc, ready


def test_kill9_midstream_drops_no_other_request(lm):
    """Two replica processes (``--device cpu``, prefix cache on) behind the
    router CLI's Router, one long stream on each; ``kill -9`` one: its
    stream ends with an error event, the other long stream and 8 short
    requests sent right after the kill complete with the reference's
    tokens, some rerouted off the dead replica."""
    cap = 96
    procs, urls = [], []
    try:
        for _ in range(2):
            p, ready = spawn(
                'paddle_tpu_torch.serving.tier.replica', '--port', '0',
                '--config', 'tiny', '--device', 'cpu', '--slots', '2',
                '--block-size', '4', '--max-blocks', '64',
                '--max-prompt-len', '16', '--max-new-tokens-cap', str(cap),
                '--prefix-cache', '1')
            assert ready['prefix_cache'] is True and ready['device'] == 'cpu'
            procs.append(p)
            urls.append(f"http://127.0.0.1:{ready['port']}")
        rproc, rready = spawn('paddle_tpu_torch.serving.tier.router',
                              '--port', '0', '--replica', urls[0],
                              '--replica', urls[1], '--health-poll-s', '0.5')
        procs.append(rproc)
        assert rready['replicas'] == urls
        long_prompt, short_prompt = [3, 5, 7], [9, 2]
        long_ref = ref(lm, long_prompt, cap, cap)
        short_ref = ref(lm, short_prompt, 4, cap)
        short_http = json.loads(post(f"http://127.0.0.1:{rready['port']}",
                                     {'prompt': short_prompt,
                                      'max_new_tokens': 4,
                                      'stream': False}))
        assert short_http['tokens'] == short_ref
        with Router(urls, health_poll_s=0.5) as router:
            gens, iters = [], []
            for _ in range(2):
                g = router.stream_generate(long_prompt, max_new_tokens=cap,
                                           timeout=WAIT)
                it = g.events()
                next(it)
                gens.append(g)
                iters.append(it)
            assert {g.replica for g in gens} == set(urls)
            victim = procs[urls.index(gens[0].replica)]
            os.kill(victim.pid, signal.SIGKILL)
            results, errors = [None] * 8, []

            def short(i):
                try:
                    results[i] = router.generate(short_prompt,
                                                 max_new_tokens=4,
                                                 timeout=WAIT)
                except Exception as e:
                    errors.append((i, e))

            threads = [threading.Thread(target=short, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT)
            assert not any(t.is_alive() for t in threads)
            victim_events = list(iters[0])
            assert any('error' in e and not e.get('done')
                       for e in victim_events), victim_events[-1:]
            done = [e for e in iters[1] if e.get('done')]
            assert done and done[0]['tokens'] == long_ref
            assert not errors, errors
            survivor = urls[1 - urls.index(gens[0].replica)]
            assert all(r['tokens'] == short_ref and r['replica'] == survivor
                       for r in results)
            assert router.stats['router_requests_rerouted'] >= 1
            assert router.generate(short_prompt,
                                   max_new_tokens=4)['tokens'] == short_ref
        assert victim.wait(timeout=WAIT) == -signal.SIGKILL
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=WAIT)
