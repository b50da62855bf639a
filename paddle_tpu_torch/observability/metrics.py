"""Thread-safe metrics registry: counters, gauges, time-bucketed histograms
(counterpart of paddle_tpu/observability/metrics.py).

The registry is the numeric half of the telemetry subsystem (the tracer is
the timeline half). Design constraints, in order:

1. **Near-zero overhead when disabled** — instrumentation sites guard on the
   module flag `observability._ENABLED` before touching any metric, so the
   disabled hot path pays one attribute read. Nothing in this module runs.
2. **Thread-safe when enabled** — the DataLoader producer thread, reader
   decorator threads, and the training loop all record concurrently. Each
   metric carries its own lock; the registry lock only guards creation.
3. **Two export formats** — `to_dict()` (consumed by the step logger, the
   artifact dump) and `prometheus_text()`
   (the text exposition format, scrape-able by any Prometheus agent),
   the same text the JAX package's registry writes for the same calls.

Metric naming: snake_case, unit-suffixed (`_seconds`, `_bytes`, `_total`
implied for counters). Labels are a small dict (e.g. ``{'op': 'matmul'}``);
each distinct label set is one child series under the parent metric.
"""
from __future__ import annotations

import math
import threading

__all__ = ['Counter', 'Gauge', 'Histogram', 'MetricsRegistry', 'registry']

# Default histogram bounds for latencies: 10 µs … ~81 s, ×3 per bucket.
# Dispatch latencies (~10 µs–1 ms), step phases (~1 ms–1 s), and kernel
# builds (~0.1 s–1 min) all land mid-range instead of saturating an end.
DEFAULT_TIME_BUCKETS = tuple(1e-5 * 3.0 ** i for i in range(15))


def _label_key(labels):
    return tuple(sorted(labels.items())) if labels else ()


class _Metric:
    kind = None

    def __init__(self, name, help=''):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children = {}   # label_key -> child state

    def labels(self, **labels):
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    key, self._new_child(dict(labels)))
        return child

    def to_dict(self):
        with self._lock:
            children = list(self._children.values())
        return {'type': self.kind, 'help': self.help,
                'samples': [c.sample() for c in children]}


class _CounterChild:
    __slots__ = ('_labels', '_value', '_lock')

    def __init__(self, labels):
        self._labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount=1.0):
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value

    def sample(self):
        return {'labels': self._labels, 'value': self._value}


class Counter(_Metric):
    """Monotonically increasing count (events, bytes, detections)."""
    kind = 'counter'

    def _new_child(self, labels):
        return _CounterChild(labels)

    def inc(self, amount=1.0):
        self.labels().inc(amount)

    @property
    def value(self):
        return self.labels().value


class _GaugeChild(_CounterChild):
    def set(self, value):
        with self._lock:
            self._value = float(value)


class Gauge(_Metric):
    """Point-in-time value (queue depth, last wait, cache size)."""
    kind = 'gauge'

    def _new_child(self, labels):
        return _GaugeChild(labels)

    def set(self, value):
        self.labels().set(value)

    def inc(self, amount=1.0):
        self.labels().inc(amount)

    @property
    def value(self):
        return self.labels().value


#: retained raw observations per histogram child for exact percentiles —
#: a ring, so a long-running process keeps the RECENT distribution, which
#: is what p99 questions are about.
RECENT_SAMPLES = 512


class _HistogramChild:
    __slots__ = ('_labels', '_bounds', '_counts', '_sum', '_count', '_min',
                 '_max', '_ring', '_lock')

    def __init__(self, labels, bounds):
        self._labels = labels
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # last bucket = +Inf
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._ring = [0.0] * RECENT_SAMPLES      # bounded sample ring
        self._lock = threading.Lock()

    def observe(self, value):
        value = float(value)
        i = 0
        bounds = self._bounds
        while i < len(bounds) and value > bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._ring[self._count % RECENT_SAMPLES] = value
            self._sum += value
            self._count += 1
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    def percentile(self, q):
        """Exact q-th percentile (0..100) over the last RECENT_SAMPLES
        observations (linear interpolation, numpy convention); None when
        empty. Exact — unlike inferring from exponential bucket edges,
        which is off by up to the 3× bucket width for long-tail decode
        latencies."""
        with self._lock:
            n = min(self._count, RECENT_SAMPLES)
            samples = sorted(self._ring[:n])
        if not samples:
            return None
        if len(samples) == 1:
            return samples[0]
        pos = (len(samples) - 1) * (float(q) / 100.0)
        lo = int(pos)
        hi = min(lo + 1, len(samples) - 1)
        frac = pos - lo
        return samples[lo] * (1.0 - frac) + samples[hi] * frac

    def sample(self):
        with self._lock:
            n = min(self._count, RECENT_SAMPLES)
            return {'labels': self._labels, 'buckets': list(self._counts),
                    'bounds': list(self._bounds), 'sum': self._sum,
                    'count': self._count,
                    'min': None if self._count == 0 else self._min,
                    'max': None if self._count == 0 else self._max,
                    'recent': sorted(self._ring[:n])}


class Histogram(_Metric):
    """Time-bucketed distribution; exponential latency bounds by default."""
    kind = 'histogram'

    def __init__(self, name, help='', bounds=DEFAULT_TIME_BUCKETS):
        super().__init__(name, help)
        self._bounds = tuple(float(b) for b in bounds)

    def _new_child(self, labels):
        return _HistogramChild(labels, self._bounds)

    def observe(self, value):
        self.labels().observe(value)

    def percentile(self, q):
        return self.labels().percentile(q)


class MetricsRegistry:
    """Name → metric map with at-export collectors.

    A collector is a zero-arg callable run at export time — the cheap way to
    snapshot externally-owned counters into gauges without touching their
    hot paths.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}
        self._collectors = []

    def _get(self, name, factory):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = factory()
                    self._metrics[name] = m
        return m

    def counter(self, name, help=''):
        m = self._get(name, lambda: Counter(name, help))
        if m.kind != 'counter':
            raise TypeError(f"metric '{name}' already registered as {m.kind}")
        return m

    def gauge(self, name, help=''):
        m = self._get(name, lambda: Gauge(name, help))
        if m.kind != 'gauge':
            raise TypeError(f"metric '{name}' already registered as {m.kind}")
        return m

    def histogram(self, name, help='', bounds=DEFAULT_TIME_BUCKETS):
        m = self._get(name, lambda: Histogram(name, help, bounds))
        if m.kind != 'histogram':
            raise TypeError(f"metric '{name}' already registered as {m.kind}")
        return m

    def register_collector(self, fn):
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def reset(self):
        with self._lock:
            self._metrics.clear()

    def _run_collectors(self):
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                pass    # a broken collector must never take down the export

    # -- exports -----------------------------------------------------------
    def to_dict(self):
        self._run_collectors()
        with self._lock:
            metrics = dict(self._metrics)
        return {name: m.to_dict() for name, m in sorted(metrics.items())}

    def prometheus_text(self, prefix='paddle_tpu_'):
        """Prometheus text exposition format, version 0.0.4."""
        self._run_collectors()
        with self._lock:
            metrics = dict(self._metrics)
        lines = []
        for name, m in sorted(metrics.items()):
            full = prefix + name
            if m.help:
                lines.append(f"# HELP {full} {m.help}")
            lines.append(f"# TYPE {full} {m.kind}")
            for s in m.to_dict()['samples']:
                if m.kind == 'histogram':
                    cum = 0
                    for bound, c in zip(s['bounds'] + [math.inf],
                                        s['buckets']):
                        cum += c
                        le = '+Inf' if bound == math.inf else repr(bound)
                        lines.append(
                            f"{full}_bucket"
                            f"{_prom_labels(s['labels'], le=le)} {cum}")
                    lines.append(
                        f"{full}_sum{_prom_labels(s['labels'])} {s['sum']}")
                    lines.append(
                        f"{full}_count{_prom_labels(s['labels'])} "
                        f"{s['count']}")
                else:
                    lines.append(
                        f"{full}{_prom_labels(s['labels'])} "
                        f"{_prom_num(s['value'])}")
        return '\n'.join(lines) + '\n'


def _prom_escape(v):
    return str(v).replace('\\', r'\\').replace('"', r'\"').replace('\n', r'\n')


def _prom_labels(labels, **extra):
    items = dict(labels or {})
    items.update(extra)
    if not items:
        return ''
    body = ','.join(f'{k}="{_prom_escape(v)}"'
                    for k, v in sorted(items.items()))
    return '{' + body + '}'


def _prom_num(v):
    # integral values print without the trailing .0 (matches client_python)
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


registry = MetricsRegistry()
