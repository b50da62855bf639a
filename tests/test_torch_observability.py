"""The port's observability core (paddle_tpu_torch/observability/) against
the JAX package's (paddle_tpu/observability/), on the same calls and data:

- the same script of ``inc``/``set``/``observe`` calls, with labels, gives
  identical ``prometheus_text()`` and ``to_dict()``;
- ``parse_prometheus_text`` and ``merge_fleet_metrics`` give identical
  results on the same scraped texts (a bucket-ladder skew included);
- ``WindowedSeries`` percentiles, rate and mean at a fixed ``now``;
- ``parse_slo_spec`` and ``SLOMonitor.evaluate`` on injected series, and
  the same errors for malformed specs;
- the ``TraceContext`` header round-trips both ways with fixed ids;
- ``telemetry_guard`` dumps the same artifacts;
- the ``StragglerMonitor`` flags the same host with the same z-scores;
- with telemetry on, a static ``Executor.run`` records the reference's
  spans and counters (the IR passes' by pass too), and
  ``FLAGS_check_nan_inf`` counts its detections.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.observability as jobs
import paddle_tpu_torch as fluid
import paddle_tpu_torch.observability as pobs
from paddle_tpu.observability import distributed as jdist
from paddle_tpu.observability import trace_context as jtc
from paddle_tpu_torch.observability import distributed as pdist
from paddle_tpu_torch.observability import trace_context as ptc
from torch_jax_seed import jax_seed_pinned  # noqa: F401

BOTH = [jobs, pobs]


def metric_script(reg):
    """One script of metric calls, labelled and not, into ``reg``."""
    c = reg.counter('requests', 'requests "seen"\nby the front')
    c.inc()
    c.inc(2.5)
    c.labels(code=200).inc(3)
    c.labels(code=404, path='/x"y').inc()
    g = reg.gauge('queue_depth', 'waiting requests')
    g.set(7)
    g.labels(replica='a\\b').set(1.25)
    g.inc(2)
    h = reg.histogram('latency_seconds', 'request latency')
    for v in (1e-6, 2e-5, 3e-3, 0.5, 90.0, 0.0004):
        h.observe(v)
    h.labels(bucket=4).observe(0.01)
    rows = reg.histogram('rows', 'rows a batch', bounds=(1, 2, 4, 8))
    for v in (1, 3, 3, 8, 9):
        rows.observe(v)
    reg.counter('empty_family', '')
    return reg


def test_same_metric_script_same_prometheus_text():
    jreg = metric_script(jobs.MetricsRegistry())
    preg = metric_script(pobs.MetricsRegistry())
    assert preg.prometheus_text() == jreg.prometheus_text()
    assert preg.prometheus_text(prefix='x_') == jreg.prometheus_text(
        prefix='x_')
    assert preg.to_dict() == jreg.to_dict()
    for reg in (jreg, preg):
        with pytest.raises(TypeError, match='already registered'):
            reg.gauge('requests')
    h_j = jreg.histogram('latency_seconds')
    h_p = preg.histogram('latency_seconds')
    for q in (0, 50, 99, 100):
        assert h_p.percentile(q) == h_j.percentile(q)


def scrapes():
    """Three replicas' exports: two with the same histogram ladder, one
    skewed, a gauge each and counters with overlapping label sets."""
    out = []
    for i, bounds in enumerate(((0.1, 1.0), (0.1, 1.0), (0.5, 1.0))):
        reg = jobs.MetricsRegistry()
        reg.counter('decode_tokens_generated', 'tokens').inc(10 + i)
        reg.counter('serving_http_responses', 'by code').labels(
            code=200).inc(3 * i + 1)
        if i:
            reg.counter('serving_http_responses', 'by code').labels(
                code=429).inc(i)
        reg.gauge('decode_slots_active', 'active').set(i + 0.5)
        h = reg.histogram('decode_step_seconds', 'step', bounds=bounds)
        for v in (0.05, 0.3, 2.0)[:i + 1]:
            h.observe(v)
        out.append((f'rep-{i}', reg.prometheus_text()))
    return out


def test_fleet_merge_and_parse_match_the_reference():
    texts = scrapes()
    for _, text in texts:
        assert pdist.parse_prometheus_text(text) == \
            jdist.parse_prometheus_text(text)
    for label in ('replica', 'host'):
        merged = pdist.merge_fleet_metrics(texts, source_label=label)
        assert merged == jdist.merge_fleet_metrics(texts, source_label=label)
    merged = pdist.parse_prometheus_text(pdist.merge_fleet_metrics(texts))
    tokens = merged['paddle_tpu_decode_tokens_generated']['samples']
    assert tokens == [('paddle_tpu_decode_tokens_generated', {}, 33.0)]
    assert pdist.merge_fleet_metrics([]) == jdist.merge_fleet_metrics([])


def fill_series(mod, name):
    s = mod.WindowedSeries(name, window_s=1.0, windows=3, max_samples=4)
    for i, v in enumerate([5, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7]):
        s.observe(float(v), now=100.0 + 0.37 * i)
    return s


@pytest.mark.parametrize('now', [104.0, 104.9, 106.5, 200.0])
def test_windowed_series_at_a_fixed_now(now):
    j, p = fill_series(jdist, 'x'), fill_series(pdist, 'x')
    for q in (0, 50, 90, 99, 100):
        assert p.percentile(q, now=now) == j.percentile(q, now=now)
    assert p.rate(now=now) == j.rate(now=now)
    assert p.mean(now=now) == j.mean(now=now)
    assert p.count(now=now) == j.count(now=now)
    assert p.snapshot(now=now) == j.snapshot(now=now)


def test_slo_spec_and_monitor_on_injected_series():
    spec = 'ttft.p99<0.2, queue_depth.p50<32,tokens.rate>100,step.mean<1'
    jc, pc = jdist.parse_slo_spec(spec), pdist.parse_slo_spec(spec)
    assert [(c.series, c.agg, c.op, c.bound, c.text) for c in pc] == \
        [(c.series, c.agg, c.op, c.bound, c.text) for c in jc]
    for bad in ('ttft.p98<1', 'ttft<1', 'ttft.p99=1', '.p99<1',
                'ttft.p99<x'):
        msgs = []
        for mod in (jdist, pdist):
            with pytest.raises(ValueError) as ei:
                mod.parse_slo_spec(bad)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
    results = []
    for obs, mod in ((jobs, jdist), (pobs, pdist)):
        obs.reset()
        for v in (0.1, 0.15, 0.5):
            mod.series('ttft').observe(v)
        for v in (3, 40, 50):
            mod.series('queue_depth').observe(v)
        out = mod.SLOMonitor(mod.parse_slo_spec(spec)).evaluate()
        text = obs.registry.prometheus_text()
        results.append((out, sorted(ln for ln in text.splitlines()
                                    if ln.startswith('paddle_tpu_slo'))))
        obs.reset()
    assert results[0] == results[1]
    assert not results[1][0]['ok']


def test_slo_monitor_from_env(monkeypatch):
    monkeypatch.setenv(pdist.ENV_SLO, 'ttft.p99<0.2')
    assert [c.text for c in pdist.SLOMonitor.from_env().clauses] == \
        [c.text for c in jdist.SLOMonitor.from_env().clauses]
    monkeypatch.setenv(pdist.ENV_SLO, '')
    assert pdist.SLOMonitor.from_env() is None


def test_trace_header_round_trips_both_ways():
    tid, sid = '0123456789abcdef', 'fedcba9876543210'
    for src, dst in ((jtc, ptc), (ptc, jtc)):
        for sampled in (True, False):
            ctx = src.TraceContext(tid, sid, None, sampled)
            hdr = ctx.to_headers()
            assert hdr == {'X-PaddleTPU-Trace':
                           f'{tid}-{sid}-{int(sampled)}'}
            back = dst.TraceContext.from_headers(hdr)
            assert (back.trace_id, back.span_id, back.parent_span_id,
                    back.sampled) == (tid, sid, None, sampled)
            child = back.child()
            assert child.trace_id == tid and child.parent_span_id == sid
    assert ptc.TRACE_HEADER == jtc.TRACE_HEADER
    assert ptc.TraceContext.from_headers({}) is None
    for bad in ('x', f'{tid}-{sid}', f'{tid}-{sid}-2',
                f'{tid.upper()}-{sid}-1'):
        msgs = []
        for mod in (jtc, ptc):
            with pytest.raises(ValueError) as ei:
                mod.TraceContext.from_header_value(bad)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize('raw', ['', '0', '1', '0.5', 'x', '1.5'])
def test_trace_sample_knob(monkeypatch, raw):
    monkeypatch.setenv(ptc.ENV_TRACE_SAMPLE, raw)
    got = []
    for mod in (jtc, ptc):
        try:
            got.append(mod.sample_rate())
        except ValueError as e:
            got.append(str(e))
    assert got[0] == got[1]
    if raw == '1':
        assert ptc.maybe_sample().sampled
    if raw in ('', '0'):
        assert ptc.maybe_sample() is None


def record(obs, directory):
    with obs.telemetry_guard(True, directory=str(directory)):
        obs.inc('steps', 2, help='steps taken', kind='train')
        obs.set_gauge('hbm_bytes', 1024)
        obs.observe('step_seconds', 0.25)
        with obs.span('outer', step=1):
            with obs.span('inner'):
                pass
        obs.instant('marker', why='test')
        obs.log_step(step=1, loss=0.5)
        paths = obs.dump_artifacts()
    with obs.telemetry_guard(False):
        assert obs.span('off') is obs.NULL_SPAN
        obs.inc('steps', 100)
    return paths


def test_telemetry_guard_dumps_the_same_artifacts(tmp_path, monkeypatch):
    monkeypatch.delenv('PADDLE_TPU_METRICS_DIR', raising=False)
    out = {}
    for name, obs in (('jax', jobs), ('port', pobs)):
        obs.reset()
        paths = record(obs, tmp_path / name)
        out[name] = paths
        assert not obs.enabled()
        assert sorted(os.listdir(tmp_path / name)) == [
            'metrics.json', 'metrics.prom', 'steps.jsonl', 'trace.json']
        assert 'PADDLE_TPU_METRICS_DIR' not in os.environ
    assert sorted(out['port']) == sorted(out['jax']) == [
        'metrics', 'prometheus', 'steps', 'trace']
    # the recorded families (the JAX package's registry also runs its
    # kernel-cache collectors at export)
    prom = {n: [ln for ln in (tmp_path / n / 'metrics.prom').read_text()
                .splitlines() if any(f in ln for f in (
                    'paddle_tpu_steps', 'paddle_tpu_hbm_bytes',
                    'paddle_tpu_step_seconds'))]
            for n in ('jax', 'port')}
    assert prom['port'] == prom['jax'] and len(prom['port']) == 24
    traces = {n: json.loads((tmp_path / n / 'trace.json').read_text())
              for n in ('jax', 'port')}
    shape = {n: [(e['name'], e['ph'], sorted(e)) for e in
                 t['traceEvents']] for n, t in traces.items()}
    assert shape['port'] == shape['jax']
    assert [e['name'] for e in traces['port']['traceEvents']] == [
        'inner', 'outer', 'marker']
    steps = {n: [sorted(json.loads(ln)) for ln in
                 (tmp_path / n / 'steps.jsonl').read_text().splitlines()]
             for n in ('jax', 'port')}
    assert steps['port'] == steps['jax']
    for obs in BOTH:
        obs.reset()


def test_straggler_monitor_flags_the_same_host(tmp_path):
    got = []
    for obs, mod in ((jobs, jdist), (pobs, pdist)):
        obs.reset()
        mon = mod.StragglerMonitor(threshold=3.5, window=4,
                                   out_dir=str(tmp_path / obs.__name__))
        for step in range(4):
            for host, t in ((0, 1.0), (1, 1.02), (2, 0.99), (3, 2.5)):
                mon.record(host, t + 0.001 * step)
        res = mon.evaluate(step=4)
        got.append((res, obs.registry.gauge('straggler_count').value))
        lines = (tmp_path / obs.__name__ / 'straggler.jsonl').read_text()
        assert json.loads(lines.splitlines()[0])['host'] == '3'
        obs.reset()
    assert got[0] == got[1] and got[1][0]['stragglers'] == ['3']


def test_fleet_fold_of_given_snapshots(monkeypatch):
    snaps = {r: {'host': r, 'step': 5, 'step_time_s': 1.0 + r,
                 'metrics': {'steps': {'type': 'counter', 'samples': [
                     {'labels': {}, 'value': 2.0 + r}]},
                     'hbm': {'type': 'gauge', 'samples': [
                         {'labels': {'d': '0'}, 'value': 10.0 * r}]}},
                 'series': {'x': {'p50': r}}} for r in range(3)}
    folds = []
    for mod in (jdist, pdist):
        monkeypatch.setattr(mod, 'read_fleet_snapshots', lambda: snaps)
        fleet = mod.aggregate_fleet_snapshots(step=5)
        fleet.pop('unix_time')
        folds.append(fleet)
    assert folds[0] == folds[1]
    with pytest.raises(NotImplementedError, match='ROADMAP A[.]9'):
        pdist.publish_host_snapshot(0, 1)


def test_span_records_and_clock_offsets(tmp_path, monkeypatch):
    keys = []
    for obs, mod, tc in ((jobs, jdist, jtc), (pobs, pdist, ptc)):
        d = tmp_path / obs.__name__
        monkeypatch.setenv(tc.ENV_TRACE_DIR, str(d))
        obs.reset()
        mod.set_process_label('router')
        ctx = tc.TraceContext('0123456789abcdef', 'fedcba9876543210')
        span = mod.record_span(ctx.child(), 'router/dispatch', 1.0, 1.5,
                               replica='r0')
        assert mod.record_span(None, 'x', 0, 1) is None
        mod.record_clock_offset('r0', 0.25, rtt_s=0.01)
        (f,) = os.listdir(d)
        recs = [json.loads(ln) for ln in (d / f).read_text().splitlines()]
        keys.append(([sorted(r) for r in recs], sorted(span),
                     recs[0]['clock']['process'], span['dur_s']))
        obs.reset()
    assert keys[0] == keys[1]


def executor_spans(pkg, obs, check_nan):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data('x', [4], dtype='float32')
        y = pkg.layers.fc(x, 3)
        # log(0) = -inf: a detection on every run
        out = (pkg.layers.log(pkg.layers.scale(y, scale=0.0)) if check_nan
               else y)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    obs.reset()
    feed = {'x': np.full((2, 4), -1.0 if check_nan else 1.0, np.float32)}
    with obs.telemetry_guard(True):
        exe.run(startup, scope=scope)
        if check_nan:
            pkg.debugging.enable_check_nan_inf(True)
            try:
                with pytest.raises(FloatingPointError):
                    for _ in range(2):
                        exe.run(main, feed=feed, fetch_list=[out],
                                scope=scope)
            finally:
                pkg.debugging.enable_check_nan_inf(False)
        else:
            for _ in range(2):
                exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    names = [e['name'] for e in obs.tracer.snapshot()['traceEvents']]
    metrics = obs.registry.to_dict()
    obs.reset()
    return names, metrics


def test_executor_spans_and_counters_with_telemetry_on():
    jnames, jm = executor_spans(jfluid, jobs, False)
    pnames, pm = executor_spans(fluid, pobs, False)
    core = ['executor/prepare', 'executor/execute', 'executor/fetch',
            'executor/run']
    for names in (jnames, pnames):
        # the startup run's executor/run, then the two runs' trees
        assert [n for n in names if n in core] == ['executor/run'] + core * 2
        assert names.count('executor/startup') == 1
    for name in ('executor_steps', 'executor_feed_bytes',
                 'executor_fetch_bytes'):
        assert pm[name]['samples'][0]['value'] == \
            jm[name]['samples'][0]['value'], name
    assert pm['executor_steps']['samples'][0]['value'] == 2
    # the IR passes of the one lowering, by pass (the JAX package's
    # pipeline also runs its knob-gated passes, which do nothing here)
    passes = [{s['labels']['pass']: s['value']
               for s in m['ir_pass_applied_total']['samples']}
              for m in (jm, pm)]
    assert passes[1] and passes[1].items() <= passes[0].items()
    # telemetry off: no span, no counter
    pobs.reset()
    exe = fluid.Executor(fluid.CPUPlace())
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data('x', [4], dtype='float32')
        y = fluid.layers.fc(x, 3)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed={'x': np.ones((2, 4), np.float32)},
            fetch_list=[y], scope=scope)
    assert len(pobs.tracer) == 0 and pobs.registry.to_dict() == {}


def test_check_nan_inf_counts_its_detection():
    pnames, pm = executor_spans(fluid, pobs, True)
    assert pm['nonfinite_detections']['samples'][0]['value'] == 1
    assert 'executor/check_nan_inf' in pnames
    assert 'nonfinite_detected' in pnames


def test_registry_counts_every_update_under_thread_contention():
    """Batcher, scheduler, handler and prefill threads record into one
    registry: 16 threads (more than this machine's cores), a short switch
    interval, each creating children and updating a counter, a gauge and a
    histogram; no update may be lost."""
    import sys
    import threading
    reg = pobs.MetricsRegistry()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(2000):
                reg.counter('hits', 'h').labels(k=i % 7).inc()
                reg.counter('hits').inc(2)
                reg.gauge('depth').inc()
                reg.histogram('lat').labels(t=t % 3).observe(i * 1e-4)

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    d = reg.to_dict()
    hits = {tuple(s['labels'].items()): s['value']
            for s in d['hits']['samples']}
    assert hits.pop(()) == 16 * 2000 * 2
    assert sum(hits.values()) == 16 * 2000 and len(hits) == 7
    assert d['depth']['samples'][0]['value'] == 16 * 2000
    assert sum(s['count'] for s in d['lat']['samples']) == 16 * 2000
