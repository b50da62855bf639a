"""Step tracer: host-side span trees written as chrome-trace JSON
(counterpart of paddle_tpu/observability/tracer.py).

Every `Executor.run` opens a span while telemetry is on; nesting is tracked per thread, so the emitted events form a
tree under each step exactly the way Perfetto / chrome://tracing render
"complete" (`ph: "X"`) events — containment of [ts, ts+dur] on one tid IS
the tree. It does not touch torch.profiler: it works on any device, costs two perf_counter() calls per span, and the
output is a single self-contained JSON file.

The event buffer is bounded (PADDLE_TPU_TRACE_MAX_EVENTS, default 100000);
past the bound new events are dropped and counted, never silently lost.

Spans time the host, not the device. Work on the card is asynchronous:
a span around a kernel launch (``executor/execute``) measures its
dispatch, and only a span that copies a result to the host
(``executor/fetch``, the serving engine's batch, which fetches its
outputs) waits for the device. This is the JAX package's placement; a
device time comes from the profiler, never from a span.
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ['Span', 'StepTracer', 'tracer']


class Span:
    """One timed region. Context manager; after exit `duration` is valid."""

    __slots__ = ('name', 'args', 'start', 'duration', '_tracer', '_depth')

    def __init__(self, tracer, name, args):
        self.name = name
        self.args = args
        self.start = 0.0
        self.duration = 0.0
        self._tracer = tracer
        self._depth = 0

    def __enter__(self):
        self._depth = self._tracer._enter()
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter()
        self.duration = end - self.start
        self._tracer._exit(self, exc_type)
        return False


class _NullSpan:
    """Shared no-op span for the disabled path (one instance, no allocs)."""

    __slots__ = ()
    name = None
    duration = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


NULL_SPAN = _NullSpan()


class StepTracer:
    def __init__(self, max_events=None):
        if max_events is None:
            max_events = int(os.environ.get('PADDLE_TPU_TRACE_MAX_EVENTS',
                                            '100000'))
        self.max_events = max_events
        self._lock = threading.Lock()
        self._events = []
        self.dropped = 0
        self._epoch = time.perf_counter()
        self._local = threading.local()

    # -- recording ---------------------------------------------------------
    def span(self, name, **args):
        return Span(self, name, args or None)

    def _enter(self):
        depth = getattr(self._local, 'depth', 0)
        self._local.depth = depth + 1
        return depth

    def _exit(self, span, exc_type):
        self._local.depth = span._depth
        ev = {
            'name': span.name,
            'ph': 'X',
            'ts': (span.start - self._epoch) * 1e6,      # µs, trace-relative
            'dur': span.duration * 1e6,
            'pid': os.getpid(),
            'tid': threading.get_ident(),
        }
        args = span.args
        if exc_type is not None:
            args = dict(args or {}, error=exc_type.__name__)
        if args:
            ev['args'] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
            else:
                self._events.append(ev)

    def complete(self, name, start_perf, end_perf, **args):
        """Append one already-measured complete event (ph 'X') from
        explicit perf_counter stamps — distributed trace spans are often
        measured retroactively (queue wait is known only at admission),
        so they can't ride the context-manager path."""
        ev = {'name': name, 'ph': 'X',
              'ts': (start_perf - self._epoch) * 1e6,
              'dur': max(0.0, end_perf - start_perf) * 1e6,
              'pid': os.getpid(), 'tid': threading.get_ident()}
        if args:
            ev['args'] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
            else:
                self._events.append(ev)

    def instant(self, name, **args):
        """Zero-duration marker (ph 'i') — e.g. a nonfinite detection."""
        ev = {'name': name, 'ph': 'i', 's': 't',
              'ts': (time.perf_counter() - self._epoch) * 1e6,
              'pid': os.getpid(), 'tid': threading.get_ident()}
        if args:
            ev['args'] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
            else:
                self._events.append(ev)

    # -- export ------------------------------------------------------------
    def snapshot(self):
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        return {'traceEvents': events, 'displayTimeUnit': 'ms',
                'otherData': {'producer': 'paddle_tpu_torch.observability',
                              'dropped_events': dropped}}

    def chrome_trace_json(self):
        return json.dumps(self.snapshot())

    def dump(self, path):
        """Write the Perfetto-loadable chrome-trace file; returns `path`."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, 'w') as f:
            json.dump(self.snapshot(), f)
        return path

    def reset(self):
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._epoch = time.perf_counter()

    def __len__(self):
        with self._lock:
            return len(self._events)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    return str(v)


tracer = StepTracer()
