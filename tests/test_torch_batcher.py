"""The port's ``MicroBatcher`` (paddle_tpu_torch/serving/batcher.py)
against the JAX package's, behaviour for behaviour, with one fake engine
class driving both (validate / run_batch / max_batch_size; no model):

- coalescing up to ``max_batch_size`` rows, FIFO, with a carried-over
  request that would overflow a batch;
- a request whose deadline passes in the queue fails with
  ``DeadlineExceeded``; a full queue raises ``Overloaded``; a malformed
  request raises ``InvalidRequest`` and is never queued;
- an engine failure fails exactly its batch; consecutive failures trip the
  breaker (queued requests fail fast, new ones raise ``EngineUnhealthy``),
  and after the cooldown one probe batch closes it again;
- ``close(drain=True)`` runs every queued request, ``close(drain=False)``
  fails the queued ones with ``EngineClosed``;
- the ``serving_*`` counters each batcher records are the same.

Each scenario runs in both packages and must give the same outcome for
every request.
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu.observability as jobs
import paddle_tpu.serving as jserving
import paddle_tpu_torch.observability as pobs
import paddle_tpu_torch.serving as pserving

PACKAGES = [('jax', jserving, jobs), ('port', pserving, pobs)]


class FakeEngine:
    """Rows are (k,) float vectors; the output row is 2x the input row.
    ``gate`` (an Event) holds a batch until set; ``fail`` makes run_batch
    raise; every batch's row count is recorded."""

    def __init__(self, errors, max_batch_size=4, width=3):
        self.errors = errors
        self.max_batch_size = max_batch_size
        self.width = width
        self.batches = []
        self.fail = False
        self.gate = None
        self.entered = threading.Event()

    def validate(self, inputs):
        arr = np.asarray(inputs.get('x') if isinstance(inputs, dict)
                         else None, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self.width:
            raise self.errors.InvalidRequest(f'bad shape {arr.shape}')
        if arr.shape[0] > self.max_batch_size:
            raise self.errors.InvalidRequest('too many rows')
        return {'x': arr}, arr.shape[0]

    def run_batch(self, feed, nrows):
        self.entered.set()
        if self.gate is not None:
            self.gate.wait(10)
        self.batches.append(nrows)
        if self.fail:
            raise RuntimeError('engine down')
        return [feed['x'] * 2]


def rows(i, n=1):
    return {'x': np.full((n, 3), float(i), np.float32)}


def outcome(fut, timeout=10):
    try:
        return ('ok', fut.result(timeout)[0].tolist())
    except Exception as e:
        return (type(e).__name__,)


def counters(obs):
    out = {}
    for name, m in obs.registry.to_dict().items():
        if name.startswith('serving_') and m['type'] == 'counter':
            out[name] = sorted((tuple(sorted(s['labels'].items())),
                                s['value']) for s in m['samples'])
    return out


@pytest.fixture(autouse=True)
def fresh_registries():
    for obs in (jobs, pobs):
        obs.reset()
    yield
    for obs in (jobs, pobs):
        obs.reset()


def both(scenario):
    """Run ``scenario(serving, engine)`` in both packages; returns the
    two results and the two packages' serving counters."""
    results, metrics = [], []
    for _, serving, obs in PACKAGES:
        engine = FakeEngine(serving)
        results.append(scenario(serving, engine))
        metrics.append(counters(obs))
    assert results[0] == results[1]
    assert metrics[0] == metrics[1]
    return results[1], metrics[1]


def test_coalesces_up_to_max_batch_rows():
    def scenario(serving, engine):
        b = serving.MicroBatcher(engine, batch_timeout_ms=50,
                                 queue_depth=32, start=False)
        sizes = [1, 2, 1, 3, 1, 1, 2, 4]
        futs = [b.submit(rows(i, n)) for i, n in enumerate(sizes)]
        assert b.pending() == len(sizes)
        b._worker.start()
        out = [outcome(f) for f in futs]
        b.close()
        return out, engine.batches

    (out, batches), metrics = both(scenario)
    assert batches == [4, 4, 3, 4]     # 1+2+1 | 3+1 | 1+2 | 4 (carried)
    assert out[3] == ('ok', [[6.0] * 3] * 3)
    assert metrics['serving_requests_completed'] == [((), 8.0)]


def test_deadline_overload_and_invalid():
    def scenario(serving, engine):
        b = serving.MicroBatcher(engine, batch_timeout_ms=0, queue_depth=3,
                                 start=False)
        late = b.submit(rows(0), timeout_ms=1)
        on_time = b.submit(rows(1), timeout_ms=60_000)
        free = b.submit(rows(2))
        errs = []
        for bad in (rows(3), {'x': np.zeros((1, 2))}, rows(4, 5)):
            try:
                b.submit(bad)
            except Exception as e:
                errs.append(type(e).__name__)
        time.sleep(0.02)
        b._worker.start()
        out = [outcome(f) for f in (late, on_time, free)]
        b.close()
        return out, errs

    (out, errs), metrics = both(scenario)
    assert out[0] == ('DeadlineExceeded',)
    assert [o[0] for o in out[1:]] == ['ok', 'ok']
    assert errs == ['Overloaded', 'InvalidRequest', 'InvalidRequest']
    assert metrics['serving_requests_rejected_overload'] == [((), 1.0)]
    assert metrics['serving_requests_rejected_invalid'] == [((), 2.0)]
    assert metrics['serving_requests_deadline_missed'] == [((), 1.0)]


def test_breaker_trips_fails_fast_and_probe_closes():
    def scenario(serving, engine):
        b = serving.MicroBatcher(engine, batch_timeout_ms=0, queue_depth=8,
                                 breaker_failures=2, breaker_reset_s=0.3)
        engine.fail = True
        first = [outcome(b.submit(rows(i))) for i in range(2)]
        states = [b.breaker.state]
        try:
            b.submit(rows(9))
            rejected = None
        except Exception as e:
            rejected = type(e).__name__
        time.sleep(0.35)
        states.append(b.breaker.state)
        engine.fail = False
        probe = outcome(b.submit(rows(5)))
        states.append(b.breaker.state)
        b.close()
        return first, rejected, probe, states

    (first, rejected, probe, states), metrics = both(scenario)
    assert first == [('ServingError',)] * 2
    assert rejected == 'EngineUnhealthy'
    assert probe == ('ok', [[10.0] * 3])
    assert states == ['open', 'half_open', 'closed']
    assert metrics['serving_breaker_trips'] == [((), 1.0)]
    assert metrics['serving_breaker_probes'] == [((), 1.0)]
    assert metrics['serving_requests_failed'] == [((), 2.0)]


def test_trip_fails_the_queue_at_once():
    def scenario(serving, engine):
        b = serving.MicroBatcher(engine, batch_timeout_ms=0, queue_depth=8,
                                 breaker_failures=1, breaker_reset_s=60)
        engine.fail = True
        engine.gate = threading.Event()
        running = b.submit(rows(0))
        engine.entered.wait(10)
        queued = [b.submit(rows(i)) for i in (1, 2)]
        engine.gate.set()
        out = [outcome(f) for f in [running] + queued]
        b.close()
        return out

    out, metrics = both(scenario)
    assert out == [('ServingError',), ('EngineUnhealthy',),
                   ('EngineUnhealthy',)]
    assert metrics['serving_requests_failed'] == [((), 3.0)]


@pytest.mark.parametrize('drain', [True, False])
def test_close_drains_or_fails_the_queue(drain):
    def scenario(serving, engine):
        b = serving.MicroBatcher(engine, max_batch_size=1,
                                 batch_timeout_ms=0, queue_depth=8)
        engine.gate = threading.Event()
        running = b.submit(rows(0))
        engine.entered.wait(10)
        queued = [b.submit(rows(i)) for i in (1, 2, 3)]
        closer = threading.Thread(target=b.close, kwargs={'drain': drain})
        closer.start()
        deadline = time.monotonic() + 10
        while not b._closing and time.monotonic() < deadline:
            time.sleep(0.001)
        if not drain:
            for f in queued:
                f._done.wait(10)
        try:
            b.submit(rows(7))
            late = None
        except Exception as e:
            late = type(e).__name__
        engine.gate.set()
        closer.join(10)
        return [outcome(f) for f in [running] + queued], late, b.closed

    (out, late, closed), _ = both(scenario)
    assert out[0] == ('ok', [[0.0] * 3])
    want = [('ok', [[2.0 * i] * 3]) for i in (1, 2, 3)] if drain \
        else [('EngineClosed',)] * 3
    assert out[1:] == want
    assert late == 'EngineClosed' and closed


def test_predict_and_future_callbacks():
    def scenario(serving, engine):
        with serving.MicroBatcher(engine, batch_timeout_ms=0) as b:
            out = b.predict(rows(3), timeout_ms=5000)[0].tolist()
            fut = b.submit(rows(4))
            seen = []
            fut.add_done_callback(lambda f: seen.append(f.done()))
            fut.result(10)
            fut.add_done_callback(lambda f: seen.append('late'))
        return out, seen

    (out, seen), _ = both(scenario)
    assert out == [[6.0] * 3] and seen == [True, 'late']
