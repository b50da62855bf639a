"""Fleet-wide observability (counterpart of
paddle_tpu/observability/distributed.py).

Three subsystems, all process-local code with cross-process artifacts:

1. **Span records** — `SpanRecorder` streams one JSONL line per traced
   span into ``PADDLE_TPU_TRACE_DIR`` (``spans-<pid>.jsonl``), with a
   first-line clock record (pid, unix_time, perf_counter) and router-side
   clock-offset records, so a merge tool can align N
   processes' spans into ONE chrome-trace timeline. `record_span` also
   mirrors every span into the in-process chrome tracer tagged with its
   trace_id, so a single process's ``trace.json`` already shows its share
   of the distributed request.

2. **Metric merging** — a Prometheus text-format parser plus
   `merge_fleet_metrics`, the ONE merge semantics used by both the
   router's ``/metrics/fleet`` and the training fleet's host-0 aggregate:
   counters sum across processes per label-set, gauges gain a
   ``replica``/``host`` label (summing a utilization gauge would be a
   lie), histograms merge bucket-by-bucket when the bound ladders agree
   and fall back to labeling when they don't. Training hosts publish
   snapshots through the coordinator KV (`publish_host_snapshot`) and
   host 0 folds them (`aggregate_fleet_snapshots`); the KV itself comes
   with the distributed trainers (ROADMAP A.9), so publishing and reading
   raise until then and the fold takes the snapshots it is given.

3. **Windowed series + monitors** — `WindowedSeries` keeps a fixed ring
   of per-window sample snapshots giving sliding-window p50/p99/rate for
   named series (queue depth, TTFT, tokens/s, step time ...); the
   `StragglerMonitor` flags hosts whose step time is a robust-z outlier
   against the fleet (``straggler_*`` gauges + quarantine-style JSONL),
   and the `SLOMonitor` evaluates the declarative ``PADDLE_TPU_SLO``
   spec into burn counters and the ``/healthz`` ``slo`` block.

Layering: this module may import :mod:`observability.metrics` and the
tracer, but never ``serving.*`` (serving imports observability).
"""

import collections
import json
import os
import threading
import time

from .metrics import registry
from .tracer import tracer
from .trace_context import ENV_TRACE_DIR

ENV_SLO = 'PADDLE_TPU_SLO'

#: coordinator-KV prefix for per-host metric snapshots
METRICS_KV_PREFIX = 'paddle_tpu/metrics/'


def _coordinator():
    raise NotImplementedError(
        'the coordinator KV that fleet metric snapshots ride is part of '
        'distributed training, not ported yet (ROADMAP A.9)')

# ---------------------------------------------------------------------------
# span records
# ---------------------------------------------------------------------------


class SpanRecorder(object):
    """Per-process JSONL span stream (`steplog` idiom: append + flush per
    line so a kill -9'd process loses at most the in-flight span — the
    failover drill reads a victim's spans after SIGKILL)."""

    def __init__(self, path, process):
        self._path = path
        self._process = str(process)
        self._fh = None
        self._lock = threading.Lock()

    @property
    def path(self):
        return self._path

    @property
    def process(self):
        return self._process

    def _ensure_open_locked(self):
        if self._fh is None:
            d = os.path.dirname(self._path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self._path, 'a')
            # Clock record first: the merge tool pairs (unix_time,
            # perf_counter) per process to translate perf-based spans
            # onto one wall-clock axis.
            self._write_locked({'clock': {
                'pid': os.getpid(), 'process': self._process,
                'unix_time': time.time(),
                'perf_counter': time.perf_counter()}})

    def _write_locked(self, record):
        self._fh.write(json.dumps(record) + '\n')
        self._fh.flush()

    def write(self, record):
        with self._lock:
            self._ensure_open_locked()
            self._write_locked(record)

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


_RECORDER = None
_RECORDER_LOCK = threading.Lock()


def span_recorder(process=None):
    """The process-wide SpanRecorder, or None when
    ``PADDLE_TPU_TRACE_DIR`` is unset (tracing artifacts off)."""
    global _RECORDER
    trace_dir = os.environ.get(ENV_TRACE_DIR)
    if not trace_dir:
        return None
    with _RECORDER_LOCK:
        if _RECORDER is None:
            label = process if process else 'pid-%d' % os.getpid()
            _RECORDER = SpanRecorder(
                os.path.join(trace_dir, 'spans-%d.jsonl' % os.getpid()),
                label)
        return _RECORDER


def set_process_label(label):
    """Name this process in span records (replicas pass their
    replica_id, the router passes 'router'). Must run before the first
    span is recorded to land in the clock record."""
    rec = span_recorder(process=label)
    if rec is not None and rec._fh is None:
        rec._process = str(label)
    return rec


def record_span(ctx, name, start_perf, end_perf, **args):
    """Record one completed span of a sampled trace.

    `start_perf`/`end_perf` are ``time.perf_counter()`` stamps taken by
    the caller around the work. No-op (a single None/flag check) when
    the request is untraced — the disabled path must stay free."""
    if ctx is None or not ctx.sampled:
        return None
    now_perf = time.perf_counter()
    now_unix = time.time()
    dur_s = max(0.0, end_perf - start_perf)
    start_unix = now_unix - (now_perf - start_perf)
    span = {'name': name, 'trace_id': ctx.trace_id,
            'span_id': ctx.span_id, 'parent_span_id': ctx.parent_span_id,
            'start_unix': start_unix, 'dur_s': dur_s}
    if args:
        span['args'] = {k: v for k, v in args.items()}
    rec = span_recorder()
    if rec is not None:
        span = dict(span, process=rec.process)
        rec.write({'span': span})
    # Mirror into the in-process chrome buffer, tagged so a per-process
    # trace.json can still be filtered by trace_id.
    targs = dict(args)
    targs['trace_id'] = ctx.trace_id
    targs['span_id'] = ctx.span_id
    if ctx.parent_span_id:
        targs['parent_span_id'] = ctx.parent_span_id
    tracer.complete(name, start_perf, end_perf, **targs)
    return span


def record_clock_offset(process, offset_s, rtt_s=None):
    """Router-side: persist the estimated (replica_unix - local_unix)
    clock offset for `process`, measured by the health-poll handshake.
    The merge tool uses these to shift every process onto the recording
    process's clock."""
    rec = span_recorder()
    if rec is not None:
        doc = {'process': str(process), 'offset_s': float(offset_s),
               'unix_time': time.time()}
        if rtt_s is not None:
            doc['rtt_s'] = float(rtt_s)
        rec.write({'offset': doc})


# ---------------------------------------------------------------------------
# prometheus text parsing + fleet merge
# ---------------------------------------------------------------------------


def _parse_labels(raw):
    """``a="x",b="y\"z"`` → dict. Handles the text-format escapes."""
    labels = {}
    i, n = 0, len(raw)
    while i < n:
        j = raw.index('=', i)
        key = raw[i:j].strip()
        i = j + 1
        if raw[i] != '"':
            raise ValueError('unquoted label value in %r' % raw)
        i += 1
        buf = []
        while raw[i] != '"':
            ch = raw[i]
            if ch == '\\':
                nxt = raw[i + 1]
                buf.append({'n': '\n', '\\': '\\', '"': '"'}.get(nxt, nxt))
                i += 2
            else:
                buf.append(ch)
                i += 1
        labels[key] = ''.join(buf)
        i += 1
        while i < n and raw[i] in ', ':
            i += 1
    return labels


def parse_prometheus_text(text):
    """Prometheus text 0.0.4 → ordered ``{family: {'type', 'help',
    'samples': [(sample_name, labels_dict, value)]}}``.

    Histogram families keep their ``_bucket``/``_sum``/``_count``
    samples under the base family name (TYPE lines carry the base)."""
    families = collections.OrderedDict()

    def family_for(sample_name):
        for fam in (sample_name, sample_name.rsplit('_bucket', 1)[0],
                    sample_name.rsplit('_sum', 1)[0],
                    sample_name.rsplit('_count', 1)[0]):
            if fam in families:
                return fam
        return sample_name

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith('#'):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == 'HELP':
                families.setdefault(
                    parts[2], {'type': 'untyped', 'help': '',
                               'samples': []})['help'] = parts[3]
            elif len(parts) >= 4 and parts[1] == 'TYPE':
                families.setdefault(
                    parts[2], {'type': 'untyped', 'help': '',
                               'samples': []})['type'] = parts[3].strip()
            continue
        if '{' in line:
            name = line[:line.index('{')]
            rest = line[line.index('{') + 1:]
            labels_raw, value_raw = rest.rsplit('}', 1)
            labels = _parse_labels(labels_raw)
        else:
            name, value_raw = line.split(None, 1)
            labels = {}
        fam = family_for(name)
        families.setdefault(fam, {'type': 'untyped', 'help': '',
                                  'samples': []})
        families[fam]['samples'].append(
            (name, labels, float(value_raw.strip())))
    return families


def _labels_key(labels, drop=()):
    return tuple(sorted((k, v) for k, v in labels.items()
                        if k not in drop))


def _fmt_num(value):
    if value == float('inf'):
        return '+Inf'
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def _fmt_labels(labels):
    if not labels:
        return ''
    items = ['%s="%s"' % (k, str(v).replace('\\', r'\\')
                          .replace('\n', r'\n').replace('"', r'\"'))
             for k, v in sorted(labels.items())]
    return '{%s}' % ','.join(items)


def merge_fleet_metrics(scrapes, source_label='replica'):
    """Merge N processes' Prometheus exports into one fleet export.

    `scrapes` is ``[(source_name, prom_text), ...]``. Semantics
    (the JAX package's, sample for sample):

    - **counter**: summed across sources per identical label-set — a
      fleet request count is the sum of replica request counts;
    - **gauge**: per-source sample with a ``replica=<source>`` (or
      ``host=``) label added — utilization/occupancy gauges of different
      processes are different facts, never summable;
    - **histogram**: per label-set, bucket counts summed per ``le``
      plus summed ``_sum``/``_count`` — valid because every process
      builds the same bucket ladder from the same code; if the ladders
      disagree (version skew mid-rolling-restart) that label-set falls
      back to gauge-style source labeling;
    - **untyped**: treated as gauge.

    Returns the merged text, parseable by `parse_prometheus_text`.
    """
    merged = collections.OrderedDict()
    for source, text in scrapes:
        for fam, info in parse_prometheus_text(text).items():
            slot = merged.setdefault(
                fam, {'type': info['type'], 'help': info['help'],
                      'per_source': collections.OrderedDict()})
            if slot['type'] == 'untyped' and info['type'] != 'untyped':
                slot['type'] = info['type']
            if not slot['help']:
                slot['help'] = info['help']
            slot['per_source'][source] = info['samples']

    out = []
    for fam, slot in merged.items():
        kind = slot['type']
        if slot['help']:
            out.append('# HELP %s %s' % (fam, slot['help']))
        out.append('# TYPE %s %s' % (fam, kind))
        if kind == 'counter':
            acc = collections.OrderedDict()
            for samples in slot['per_source'].values():
                for name, labels, value in samples:
                    key = (name, _labels_key(labels))
                    if key not in acc:
                        acc[key] = [labels, 0.0]
                    acc[key][1] += value
            for (name, _), (labels, value) in acc.items():
                out.append('%s%s %s' % (name, _fmt_labels(labels),
                                        _fmt_num(value)))
        elif kind == 'histogram':
            out.extend(_merge_histogram_family(
                slot['per_source'], source_label))
        else:  # gauge / untyped → label by source
            for source, samples in slot['per_source'].items():
                for name, labels, value in samples:
                    labeled = dict(labels)
                    labeled[source_label] = source
                    out.append('%s%s %s' % (name, _fmt_labels(labeled),
                                            _fmt_num(value)))
    return '\n'.join(out) + '\n' if out else ''


def _merge_histogram_family(per_source, source_label):
    # group: labels-without-le → {source: {'buckets': {le: v},
    #                                      'sum': x, 'count': n, labels}}
    groups = collections.OrderedDict()
    for source, samples in per_source.items():
        for name, labels, value in samples:
            key = _labels_key(labels, drop=('le',))
            grp = groups.setdefault(key, collections.OrderedDict())
            ent = grp.setdefault(source, {
                'buckets': collections.OrderedDict(), 'sum': 0.0,
                'count': 0.0,
                'labels': {k: v for k, v in labels.items() if k != 'le'}})
            if name.endswith('_bucket'):
                le = labels.get('le', '+Inf')
                ent['buckets'][le] = ent['buckets'].get(le, 0.0) + value
                ent['base'] = name[:-len('_bucket')]
            elif name.endswith('_sum'):
                ent['sum'] += value
                ent['base'] = name[:-len('_sum')]
            elif name.endswith('_count'):
                ent['count'] += value
                ent['base'] = name[:-len('_count')]

    lines = []
    for key, grp in groups.items():
        ladders = {tuple(ent['buckets'].keys()) for ent in grp.values()}
        base = next(iter(grp.values())).get('base', '')
        labels = next(iter(grp.values()))['labels']
        if len(ladders) == 1:
            buckets = collections.OrderedDict()
            total_sum, total_count = 0.0, 0.0
            for ent in grp.values():
                for le, v in ent['buckets'].items():
                    buckets[le] = buckets.get(le, 0.0) + v
                total_sum += ent['sum']
                total_count += ent['count']
            for le, v in buckets.items():
                blabels = dict(labels, le=le)
                lines.append('%s_bucket%s %s' % (
                    base, _fmt_labels(blabels), _fmt_num(v)))
            lines.append('%s_sum%s %s' % (base, _fmt_labels(labels),
                                          repr(float(total_sum))))
            lines.append('%s_count%s %s' % (base, _fmt_labels(labels),
                                            _fmt_num(total_count)))
        else:  # ladder skew → label by source instead of merging
            for source, ent in grp.items():
                slabels = dict(labels)
                slabels[source_label] = source
                for le, v in ent['buckets'].items():
                    blabels = dict(slabels, le=le)
                    lines.append('%s_bucket%s %s' % (
                        base, _fmt_labels(blabels), _fmt_num(v)))
                lines.append('%s_sum%s %s' % (
                    base, _fmt_labels(slabels), repr(float(ent['sum']))))
                lines.append('%s_count%s %s' % (
                    base, _fmt_labels(slabels), _fmt_num(ent['count'])))
    return lines


# ---------------------------------------------------------------------------
# windowed time series
# ---------------------------------------------------------------------------


class WindowedSeries(object):
    """Sliding-window series: a fixed ring of per-window snapshots.

    Each window holds a bounded reservoir-style sample list plus exact
    count/total; `percentile` pools the retained samples across the ring
    (exact when windows stay under `max_samples` observations — the
    intended regime for per-second serving signals), `rate` divides the
    ring's total count by its covered wall time. O(1) per observe, O(ring)
    memory, no timers — windows roll lazily on the next observe/read."""

    __slots__ = ('name', 'window_s', '_ring', '_cur', '_max_samples',
                 '_lock')

    def __init__(self, name, window_s=10.0, windows=6, max_samples=512):
        self.name = name
        self.window_s = float(window_s)
        self._ring = collections.deque(maxlen=int(windows))
        self._max_samples = int(max_samples)
        self._cur = None
        self._lock = threading.Lock()

    def _roll_locked(self, now):
        if self._cur is None:
            self._cur = {'start': now, 'count': 0, 'total': 0.0,
                         'samples': []}
        while now - self._cur['start'] >= self.window_s:
            self._cur['end'] = self._cur['start'] + self.window_s
            self._ring.append(self._cur)
            self._cur = {'start': self._cur['end'], 'count': 0,
                         'total': 0.0, 'samples': []}

    def observe(self, value, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            self._roll_locked(now)
            cur = self._cur
            cur['count'] += 1
            cur['total'] += value
            if len(cur['samples']) < self._max_samples:
                cur['samples'].append(value)
            else:
                # deterministic decimation: keep every k-th overflow so
                # the tail is still represented without unbounded memory
                k = cur['count'] % self._max_samples
                cur['samples'][k] = value

    def _windows_locked(self, now):
        self._roll_locked(now)
        return list(self._ring) + [self._cur]

    def percentile(self, q, now=None):
        """Exact q-th percentile (0..100) over retained samples across
        the ring; None when empty."""
        now = time.monotonic() if now is None else now
        with self._lock:
            samples = []
            for w in self._windows_locked(now):
                samples.extend(w['samples'])
        if not samples:
            return None
        samples.sort()
        if len(samples) == 1:
            return samples[0]
        # linear interpolation, numpy 'linear' convention
        pos = (len(samples) - 1) * (q / 100.0)
        lo = int(pos)
        hi = min(lo + 1, len(samples) - 1)
        frac = pos - lo
        return samples[lo] * (1.0 - frac) + samples[hi] * frac

    def rate(self, now=None):
        """Observations per second over the covered window span."""
        now = time.monotonic() if now is None else now
        with self._lock:
            windows = self._windows_locked(now)
            count = sum(w['count'] for w in windows)
            covered = now - windows[0]['start']
        if covered <= 0:
            return 0.0
        return count / covered

    def count(self, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            return sum(w['count']
                       for w in self._windows_locked(now))

    def mean(self, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            windows = self._windows_locked(now)
            count = sum(w['count'] for w in windows)
            total = sum(w['total'] for w in windows)
        return total / count if count else None

    def snapshot(self, now=None):
        return {'p50': self.percentile(50, now=now),
                'p99': self.percentile(99, now=now),
                'mean': self.mean(now=now),
                'rate': self.rate(now=now),
                'count': self.count(now=now)}


_SERIES = {}
_SERIES_LOCK = threading.Lock()


def series(name, window_s=10.0, windows=6):
    """Get-or-create the named process-wide WindowedSeries."""
    with _SERIES_LOCK:
        s = _SERIES.get(name)
        if s is None:
            s = _SERIES[name] = WindowedSeries(
                name, window_s=window_s, windows=windows)
        return s


def series_snapshot():
    with _SERIES_LOCK:
        items = list(_SERIES.items())
    return {name: s.snapshot() for name, s in items}


# ---------------------------------------------------------------------------
# straggler monitor
# ---------------------------------------------------------------------------


class StragglerMonitor(object):
    """Per-host step-time outlier detection over the fleet.

    Robust z-score: ``z = (x - median) / (1.4826*MAD + floor)`` where the
    floor (5% of the median) keeps microsecond-level jitter at small
    step times from manufacturing outliers, and makes a zero-MAD fleet
    (every healthy host identical, one sleeper) still resolvable. A host
    with z > `threshold` is flagged: ``straggler_zscore{host=}`` gauges,
    a ``straggler_count`` gauge, and a quarantine-style JSONL record
    (``straggler.jsonl`` in `out_dir`) naming the host — the same shape
    the resilience layer's supervisor records use."""

    def __init__(self, threshold=3.5, window=8, out_dir=None):
        self.threshold = float(threshold)
        self._times = {}           # host -> deque of recent step times
        self._window = int(window)
        self._out_dir = out_dir
        self._lock = threading.Lock()

    def record(self, host, step_time_s):
        with self._lock:
            dq = self._times.setdefault(
                str(host), collections.deque(maxlen=self._window))
            dq.append(float(step_time_s))

    def evaluate(self, step=None):
        """→ ``{'stragglers': [host...], 'zscores': {host: z}}``; sets
        the ``straggler_*`` gauges as a side effect."""
        with self._lock:
            means = {h: sum(dq) / len(dq)
                     for h, dq in self._times.items() if dq}
        if len(means) < 2:
            registry.gauge('straggler_count',
                           'hosts currently flagged as stragglers').set(0)
            return {'stragglers': [], 'zscores': {}}
        values = sorted(means.values())
        n = len(values)
        median = (values[n // 2] if n % 2
                  else 0.5 * (values[n // 2 - 1] + values[n // 2]))
        abs_dev = sorted(abs(v - median) for v in values)
        mad = (abs_dev[n // 2] if n % 2
               else 0.5 * (abs_dev[n // 2 - 1] + abs_dev[n // 2]))
        denom = 1.4826 * mad + max(0.05 * abs(median), 1e-9)
        zscores, stragglers = {}, []
        zgauge = registry.gauge(
            'straggler_zscore',
            'robust z-score of each host step time vs the fleet')
        for host, mean in means.items():
            z = (mean - median) / denom
            zscores[host] = z
            zgauge.labels(host=host).set(z)
            if z > self.threshold:
                stragglers.append(host)
        registry.gauge(
            'straggler_count',
            'hosts currently flagged as stragglers').set(len(stragglers))
        if stragglers:
            registry.counter(
                'straggler_flags',
                'cumulative straggler detections').inc(len(stragglers))
            self._write_records(stragglers, zscores, means, step)
        return {'stragglers': sorted(stragglers), 'zscores': zscores}

    def _write_records(self, stragglers, zscores, means, step):
        if not self._out_dir:
            return
        try:
            os.makedirs(self._out_dir, exist_ok=True)
            path = os.path.join(self._out_dir, 'straggler.jsonl')
            with open(path, 'a') as f:
                for host in stragglers:
                    f.write(json.dumps({
                        'host': host, 'zscore': zscores[host],
                        'mean_step_time_s': means[host], 'step': step,
                        'unix_time': time.time(),
                        'action': 'flag'}) + '\n')
        except OSError:
            pass


# ---------------------------------------------------------------------------
# SLO monitor
# ---------------------------------------------------------------------------

_SLO_AGGS = ('p50', 'p99', 'mean', 'rate')


class SLOClause(object):
    __slots__ = ('series', 'agg', 'op', 'bound', 'text')

    def __init__(self, series_name, agg, op, bound, text):
        self.series = series_name
        self.agg = agg
        self.op = op
        self.bound = bound
        self.text = text


def parse_slo_spec(raw):
    """``PADDLE_TPU_SLO`` grammar: comma-separated
    ``<series>.<agg><op><value>`` clauses, e.g.
    ``ttft.p99<0.2,queue_depth.p50<32,tokens.rate>100``.
    agg ∈ p50|p99|mean|rate, op ∈ <|>. Malformed clauses raise naming
    the knob and the supported grammar (repo knob contract)."""
    clauses = []
    for part in str(raw).split(','):
        part = part.strip()
        if not part:
            continue
        err = ValueError(
            '%s clause %r is malformed; supported: '
            '<series>.<agg><op><value> with agg in %s and op < or > '
            '(e.g. ttft.p99<0.2)' % (ENV_SLO, part, '|'.join(_SLO_AGGS)))
        op = '<' if '<' in part else ('>' if '>' in part else None)
        if op is None:
            raise err
        lhs, _, rhs = part.partition(op)
        if '.' not in lhs:
            raise err
        series_name, _, agg = lhs.rpartition('.')
        if not series_name or agg not in _SLO_AGGS:
            raise err
        try:
            bound = float(rhs)
        except ValueError:
            raise err
        clauses.append(SLOClause(series_name, agg, op, bound, part))
    return clauses


class SLOMonitor(object):
    """Evaluates parsed SLO clauses against the windowed series registry.

    Each evaluation sets ``slo_ok{slo=<clause>}`` (1/0) and increments
    the ``slo_breaches{slo=<clause>}`` burn counter on violation; a
    clause whose series has no data yet is vacuously ok (cold start is
    not an outage)."""

    def __init__(self, clauses):
        self.clauses = list(clauses)

    @classmethod
    def from_env(cls):
        raw = os.environ.get(ENV_SLO, '').strip()
        if not raw:
            return None
        return cls(parse_slo_spec(raw))

    def evaluate(self):
        results = []
        all_ok = True
        ok_gauge = registry.gauge(
            'slo_ok', '1 when the SLO clause currently holds')
        burn = registry.counter(
            'slo_breaches', 'evaluations where the SLO clause was '
            'violated (burn counter)')
        for clause in self.clauses:
            s = series(clause.series)
            if clause.agg == 'rate':
                value = s.rate()
            elif clause.agg == 'mean':
                value = s.mean()
            else:
                value = s.percentile(50 if clause.agg == 'p50' else 99)
            if value is None:
                ok = True
            elif clause.op == '<':
                ok = value < clause.bound
            else:
                ok = value > clause.bound
            ok_gauge.labels(slo=clause.text).set(1 if ok else 0)
            if not ok:
                burn.labels(slo=clause.text).inc()
                all_ok = False
            results.append({'slo': clause.text, 'value': value,
                            'ok': ok})
        return {'ok': all_ok, 'clauses': results}


# ---------------------------------------------------------------------------
# training-fleet snapshot publish / aggregate (coordinator KV)
# ---------------------------------------------------------------------------


def publish_host_snapshot(rank, step, step_time_s=None):
    """Publish this host's metric snapshot through the coordinator KV at
    a step boundary (rank-keyed; last write wins — the aggregate wants
    the freshest boundary, not history)."""
    coordinator = _coordinator()
    doc = {'host': int(rank), 'step': int(step),
           'unix_time': time.time(), 'step_time_s': step_time_s,
           'metrics': registry.to_dict(),
           'series': series_snapshot()}
    return coordinator.kv_set('%shost%04d' % (METRICS_KV_PREFIX, rank),
                              json.dumps(doc))


def _labels_suffix(labels):
    if not labels:
        return ''
    return '{%s}' % ','.join('%s=%s' % (k, v)
                             for k, v in sorted(labels.items()))


def read_fleet_snapshots():
    """→ ``{rank: snapshot_doc}`` for every published host (one
    non-blocking KV directory poll)."""
    coordinator = _coordinator()
    out = {}
    for key, val in coordinator.kv_dir(METRICS_KV_PREFIX).items():
        try:
            doc = json.loads(val)
            out[int(doc['host'])] = doc
        except (ValueError, KeyError, TypeError):
            continue
    return out


def aggregate_fleet_snapshots(straggler=None, out_path=None, step=None):
    """Host-0 aggregation: fold every host's published snapshot into one
    fleet document (counter-sum / gauge-label semantics mirroring
    `merge_fleet_metrics`), feed per-host step times into `straggler`
    when given, and atomically export to `out_path` when given."""
    snaps = read_fleet_snapshots()
    fleet = {'hosts': sorted(snaps), 'step': step,
             'unix_time': time.time(), 'counters': {}, 'gauges': {},
             'step_time_s': {}, 'series': {}}
    for rank in sorted(snaps):
        doc = snaps[rank]
        for name, info in doc.get('metrics', {}).items():
            kind = info.get('type')
            if kind == 'counter':
                # counters sum across hosts per label-set
                for s in info.get('samples', []):
                    key = name + _labels_suffix(s.get('labels'))
                    fleet['counters'][key] = (
                        fleet['counters'].get(key, 0.0) + s['value'])
            elif kind == 'gauge':
                # gauges are per-host facts: label, never sum
                for s in info.get('samples', []):
                    key = name + _labels_suffix(s.get('labels'))
                    fleet['gauges'].setdefault(key, {})[
                        'host%d' % rank] = s['value']
        if doc.get('step_time_s') is not None:
            fleet['step_time_s'][str(rank)] = doc['step_time_s']
            if straggler is not None:
                straggler.record(rank, doc['step_time_s'])
        fleet['series']['host%d' % rank] = doc.get('series', {})
    if straggler is not None:
        fleet['straggler'] = straggler.evaluate(step=step)
    if out_path:
        try:
            atomic_write_bytes(out_path,
                               json.dumps(fleet, indent=1).encode())
        except OSError:
            pass
    return fleet


# ---------------------------------------------------------------------------
# test / lifecycle hooks
# ---------------------------------------------------------------------------


def atomic_write_bytes(path, data):
    """Write ``data`` to ``path`` through a temporary file and a rename,
    so a reader never sees half a file."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = '%s.tmp.%d' % (path, os.getpid())
    with open(tmp, 'wb') as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def reset_distributed():
    """Drop process-wide state (tests; mirrors observability.reset())."""
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is not None:
            _RECORDER.close()
        _RECORDER = None
    with _SERIES_LOCK:
        _SERIES.clear()
