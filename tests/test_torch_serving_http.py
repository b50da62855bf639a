"""The port's HTTP front end (paddle_tpu_torch/serving/server.py) against
the JAX package's, on the CPU: the same saved model (the conv classifier of
tests/test_torch_inference_engine.py) behind each package's
``ServingServer`` on port 0, warmed, with ``batch_timeout_ms=0`` and
``queue_depth=1``.

- One scripted sequence of ``/predict`` requests, errors included (400
  for a bad shape, bad JSON, a body without inputs, a bad timeout and an
  empty body; 413 over ``MAX_BODY_BYTES``; 404 for unknown paths and for
  ``/generate`` on a predict-only server; 429 while a batch runs and the
  queue is full; 504 for a deadline that passes in the queue), gets the
  same status codes and bodies from both, apart from ``latency_ms``, the
  outputs' last bits (atol 1e-5) and the seconds in a deadline message.
- Then ``GET /metrics`` lists the same ``serving_*`` families with the
  same label sets and counter values (timing sums excluded), and
  ``/healthz`` reports the same ``buckets``, ``compiled``, ``warmup`` and
  ``slo``.
- ``/metrics/fleet`` through a ``RouterServer`` over two replica
  processes of the port's CLI (``--device cpu``) merges their exports:
  counters summed, gauges labelled by replica.
"""
import http.client
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.observability as jobs
import paddle_tpu.serving as jserving
import paddle_tpu_torch as fluid
import paddle_tpu_torch.observability as pobs
import paddle_tpu_torch.serving as pserving
from paddle_tpu_torch.observability import distributed
from paddle_tpu_torch.serving import server as port_server
from test_torch_inference_engine import images, save_model
from torch_jax_seed import jax_seed_pinned  # noqa: F401

SLO = 'ttft.p99<0.5'


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    return save_model(tmp_path_factory.mktemp('served'), 'conv')


def start(serving, engine, **kw):
    return serving.ServingServer(engine, port=0, batch_timeout_ms=0,
                                 queue_depth=1, warmup=True,
                                 request_timeout=30, **kw).start()


@pytest.fixture()
def servers(model_dir, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_SLO', SLO)
    for obs in (jobs, pobs):
        obs.reset()
    port_eng = pserving.InferenceEngine(
        model_dir, executor=fluid.Executor(fluid.CPUPlace()),
        max_batch_size=4)
    jax_eng = jserving.InferenceEngine(
        model_dir, executor=jfluid.Executor(jfluid.CPUPlace()),
        max_batch_size=4)
    srvs = {'jax': start(jserving, jax_eng), 'port': start(pserving,
                                                           port_eng)}
    yield srvs
    for srv in srvs.values():
        srv.shutdown()
    for obs in (jobs, pobs):
        obs.reset()


def request(port, method, path, body=None, raw=None, length=None):
    """(status, parsed JSON or text) of one request on a new connection."""
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=30)
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else b'')
    headers = {'Content-Type': 'application/json',
               'Content-Length': str(len(data) if length is None
                                     else length)}
    conn.request(method, path, body=data, headers=headers)
    resp = conn.getresponse()
    text = resp.read().decode()
    conn.close()
    try:
        return resp.status, json.loads(text)
    except ValueError:
        return resp.status, text


def script():
    """(label, method, path, kwargs of ``request``)."""
    x = images(3, seed=5)
    return [
        ('one row', 'POST', '/predict', {'body': {'inputs': {
            'img': x[:1].tolist()}}}),
        ('three rows', 'POST', '/predict', {'body': {'inputs': {
            'img': x.tolist()}, 'timeout_ms': 10000}}),
        ('list inputs', 'POST', '/predict', {'body': {'inputs': [
            x[:2].tolist()]}}),
        ('bad shape', 'POST', '/predict', {'body': {'inputs': {
            'img': x[:, :2].tolist()}}}),
        ('too many rows', 'POST', '/predict', {'body': {'inputs': {
            'img': images(5).tolist()}}}),
        ('bad json', 'POST', '/predict', {'raw': b'{"inputs": '}),
        ('no inputs', 'POST', '/predict', {'body': {'x': 1}}),
        ('not an object', 'POST', '/predict', {'body': [1, 2]}),
        ('bad timeout', 'POST', '/predict', {'body': {
            'inputs': {'img': x[:1].tolist()}, 'timeout_ms': 'soon'}}),
        ('empty body', 'POST', '/predict', {'raw': b''}),
        ('oversize', 'POST', '/predict', {
            'raw': b'{}', 'length': port_server.MAX_BODY_BYTES + 1}),
        ('deadline', 'POST', '/predict', {'body': {
            'inputs': {'img': x[:1].tolist()}, 'timeout_ms': 0}}),
        ('unknown post', 'POST', '/nope', {'body': {}}),
        ('unknown get', 'GET', '/nope', {}),
        ('generate', 'POST', '/generate', {'body': {'prompt': [1]}}),
    ]


def overload(srv):
    """Hold the engine while one request runs and a second waits in the
    queue of depth 1: the third is refused with 429. Returns the three
    (status, body) in submission order."""
    out = [None] * 3
    body = {'inputs': {'img': images(1, seed=9).tolist()}}

    def send(i):
        out[i] = request(srv.port, 'POST', '/predict', body)

    threads = []
    with srv.engine._lock:
        for i in range(2):
            t = threading.Thread(target=send, args=(i,))
            t.start()
            threads.append(t)
            deadline = time.monotonic() + 10
            while srv.batcher.pending() != i and \
                    time.monotonic() < deadline:
                time.sleep(0.001)
            if i == 0:
                time.sleep(0.05)          # the worker holds request 0
        assert srv.batcher.pending() == 1
        send(2)
    for t in threads:
        t.join(30)
    return out


def families(text):
    """``serving_*`` families: {name: (type, {sample name: {label set:
    value or None for a timing}})}."""
    out = {}
    for fam, info in distributed.parse_prometheus_text(text).items():
        if not fam.startswith('paddle_tpu_serving_'):
            continue
        timing = fam.endswith('_seconds')
        samples = {}
        for name, labels, value in info['samples']:
            key = tuple(sorted(labels.items()))
            keep = not timing or name.endswith('_count')
            samples.setdefault(name, {})[key] = value if keep else None
        out[fam] = (info['type'], samples)
    return out


def test_predict_script_metrics_and_healthz_match_jax(servers):
    replies = {}
    for name, srv in servers.items():
        replies[name] = [request(srv.port, method, path, **kw)
                         for _, method, path, kw in script()]
        replies[name].append(overload(srv))
    labels = [s[0] for s in script()]
    for label, (pc, pb), (jc, jb) in zip(labels, replies['port'][:-1],
                                         replies['jax'][:-1]):
        assert pc == jc, label
        if label == 'deadline':
            assert pc == 504 and pb['error'] == jb['error'] == \
                'DeadlineExceeded'
            continue
        if pc == 200:
            pb, jb = dict(pb), dict(jb)
            assert pb.pop('latency_ms') >= 0 and jb.pop('latency_ms') >= 0
            (name, got), = pb.pop('outputs').items()
            (jname, want), = jb.pop('outputs').items()
            assert name == jname
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        assert pb == jb, label
    codes = [r[0] for r in replies['port'][:-1]]
    assert codes == [200, 200, 200, 400, 400, 400, 400, 400, 400, 400,
                     413, 504, 404, 404, 404]
    port_over, jax_over = replies['port'][-1], replies['jax'][-1]
    assert [c for c, _ in port_over] == [c for c, _ in jax_over] == \
        [200, 200, 429]
    assert port_over[2][1] == jax_over[2][1]

    texts = {}
    for name, srv in servers.items():
        with urllib.request.urlopen(
                f'http://127.0.0.1:{srv.port}/metrics', timeout=30) as r:
            assert r.headers['Content-Type'].startswith('text/plain')
            texts[name] = r.read().decode()
    port_fams, jax_fams = families(texts['port']), families(texts['jax'])
    assert port_fams == jax_fams
    completed = port_fams['paddle_tpu_serving_requests_completed'][1]
    assert completed['paddle_tpu_serving_requests_completed'][()] == 5
    http_codes = port_fams['paddle_tpu_serving_http_responses'][1]
    assert sum(http_codes['paddle_tpu_serving_http_responses'].values()) \
        == len(codes) + 3

    health = {}
    for name, srv in servers.items():
        status, body = request(srv.port, 'GET', '/healthz')
        assert status == 200 and body['status'] == 'ok'
        health[name] = {k: body[k] for k in ('buckets', 'compiled',
                                             'warmup', 'slo')}
    assert health['port'] == health['jax']
    assert health['port']['buckets'] == health['port']['compiled'] == \
        [1, 2, 4]
    assert health['port']['warmup'] == {'predict': True, 'done': True}
    assert servers['port'].breaker_states() == {}


def spawn_cli(model_dir, replica_id):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('PADDLE_TPU_')}
    env['PADDLE_TPU_REPLICA_ID'] = replica_id
    return subprocess.Popen(
        [sys.executable, '-m', 'paddle_tpu_torch.serving.server',
         '--model-dir', model_dir, '--device', 'cpu', '--port', '0',
         '--host', '127.0.0.1', '--max-batch-size', '2'],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=os.path.dirname(os.path.dirname(__file__)))


def scrape(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return distributed.parse_prometheus_text(r.read().decode())


def completed(fams):
    return fams['paddle_tpu_serving_requests_completed']['samples'][0][2]


def test_cli_replicas_behind_the_router_merge_their_metrics(model_dir):
    """Two ``python -m paddle_tpu_torch.serving.server --device cpu``
    processes (one ready line each), 1 and 2 requests, then the router's
    ``/metrics/fleet``: the merged completed count is the sum of the
    replicas' own, and each gauge carries its replica's label."""
    pobs.reset()
    procs = [spawn_cli(model_dir, f'pred-{i}') for i in range(2)]
    try:
        ready = [json.loads(p.stdout.readline()) for p in procs]
        for r in ready:
            assert r['ready'] and r['device'] == 'cpu'
            assert r['buckets'] == [1, 2]
        urls = [f'http://127.0.0.1:{r["port"]}' for r in ready]
        body = {'inputs': {'img': images(1).tolist()}}
        for i, r in enumerate(ready):
            for _ in range(i + 1):
                status, reply = request(r['port'], 'POST', '/predict', body)
                assert status == 200 and reply['rows'] == 1
        own = [scrape(u + '/metrics') for u in urls]
        assert [completed(f) for f in own] == [1, 2]
        with pserving.Router(urls, health_poll_s=0.2) as router:
            assert all(r.routable() for r in router.replicas)
            with pserving.RouterServer(router, port=0).start() as rs:
                fleet = scrape(f'http://127.0.0.1:{rs.port}/metrics/fleet')
                mine = scrape(f'http://127.0.0.1:{rs.port}/metrics')
        assert fleet['paddle_tpu_serving_requests_completed']['type'] == \
            'counter'
        assert completed(fleet) == 3
        depth = fleet['paddle_tpu_serving_queue_depth']['samples']
        assert sorted(s[1]['replica'] for s in depth) == ['pred-0', 'pred-1']
        assert mine['paddle_tpu_router_fleet_scrapes']['samples'][0][2] == 1
    finally:
        for p in procs:
            p.terminate()
            p.wait(timeout=60)
        pobs.reset()
