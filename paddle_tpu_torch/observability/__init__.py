"""Runtime telemetry subsystem: metrics registry + step tracer + step logger
(counterpart of paddle_tpu/observability/__init__.py).

The single switch is ``PADDLE_TPU_TELEMETRY`` (default off). Every
instrumentation site in the framework guards on the module-level bool
``_ENABLED`` — one attribute read — so the disabled hot path pays
nothing measurable. With telemetry on:

- counters/gauges/histograms accumulate in :data:`metrics.registry`
  (dict export + Prometheus text exposition);
- a span tree per ``Executor.run`` (and per IR pass application, counted)
  is recorded by :data:`tracer.tracer` and written as Perfetto-loadable
  chrome-trace JSON — no torch.profiler required;
- one JSON line per step goes to ``$PADDLE_TPU_METRICS_DIR/steps.jsonl``.

Artifacts land in ``PADDLE_TPU_METRICS_DIR`` (when set) at interpreter exit
or on an explicit :func:`dump_artifacts` call:

    metrics.json   registry dict export
    metrics.prom   Prometheus text exposition
    trace.json     chrome trace (load in ui.perfetto.dev)
    steps.jsonl    structured per-step log

The serving path (serving/metrics.py) records into the same registry
always, telemetry on or off: ``GET /metrics`` must answer without it.
"""
from __future__ import annotations

import atexit
import contextlib
import os
import time

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                      registry)
from .tracer import NULL_SPAN, Span, StepTracer, tracer  # noqa: F401
from .steplog import StepLogger, step_logger  # noqa: F401
from .trace_context import TraceContext, TRACE_HEADER  # noqa: F401
from . import distributed  # noqa: F401

__all__ = ['enabled', 'enable', 'disable', 'telemetry_guard', 'metrics_dir',
           'span', 'instant', 'inc', 'set_gauge', 'observe', 'log_step',
           'dump_artifacts', 'registry', 'tracer',
           'step_logger', 'TraceContext', 'TRACE_HEADER', 'distributed']

# THE hot-path flag. Instrumentation sites read this attribute directly
# (``if _obs._ENABLED:``); everything else in this module is off-path.
_ENABLED = os.environ.get('PADDLE_TPU_TELEMETRY', '0') not in ('0', '')

_atexit_registered = False


def enabled():
    return _ENABLED


def metrics_dir():
    """Artifact directory, or None (collect in memory only)."""
    return os.environ.get('PADDLE_TPU_METRICS_DIR') or None


def _register_atexit():
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(_atexit_dump)


def _atexit_dump():
    if _ENABLED and metrics_dir():
        try:
            dump_artifacts(metrics_dir())
        except Exception:
            pass   # interpreter teardown: never turn exit into a traceback


def enable(directory=None):
    """Turn telemetry on at runtime (the programmatic form of
    PADDLE_TPU_TELEMETRY=1). `directory` additionally points
    PADDLE_TPU_METRICS_DIR so artifacts auto-dump at exit."""
    global _ENABLED
    _ENABLED = True
    if directory is not None:
        os.environ['PADDLE_TPU_METRICS_DIR'] = str(directory)
    d = metrics_dir()
    if d:
        step_logger.open(d)
    _register_atexit()


def disable():
    global _ENABLED
    _ENABLED = False


@contextlib.contextmanager
def telemetry_guard(on=True, directory=None):
    """Scope telemetry on/off (tests, A/B overhead measurements). Restores
    the enabled flag, PADDLE_TPU_METRICS_DIR, and the step-log stream."""
    global _ENABLED
    old = _ENABLED
    old_dir = os.environ.get('PADDLE_TPU_METRICS_DIR')
    try:
        if on:
            enable(directory)
        else:
            _ENABLED = False
        yield
    finally:
        _ENABLED = old
        if directory is not None:
            step_logger.close()
            if old_dir is None:
                os.environ.pop('PADDLE_TPU_METRICS_DIR', None)
            else:
                os.environ['PADDLE_TPU_METRICS_DIR'] = old_dir


if _ENABLED:
    # env-enabled process: open the step log + arm the exit dump eagerly so
    # a script needs zero telemetry-specific code to produce artifacts
    if metrics_dir():
        step_logger.open(metrics_dir())
    _register_atexit()


# ---------------------------------------------------------------------------
# thin recording facade — every helper is a no-op when disabled, so call
# sites stay one-liners.
# ---------------------------------------------------------------------------

def span(name, **args):
    """Context manager timing a named region into the trace."""
    if not _ENABLED:
        return NULL_SPAN
    return tracer.span(name, **args)


def instant(name, **args):
    if _ENABLED:
        tracer.instant(name, **args)


def inc(name, amount=1.0, help='', **labels):
    if _ENABLED:
        c = registry.counter(name, help)
        (c.labels(**labels) if labels else c).inc(amount)


def set_gauge(name, value, help='', **labels):
    if _ENABLED:
        g = registry.gauge(name, help)
        (g.labels(**labels) if labels else g).set(value)


def observe(name, value, help='', **labels):
    if _ENABLED:
        h = registry.histogram(name, help)
        (h.labels(**labels) if labels else h).observe(value)


def log_step(**record):
    if _ENABLED:
        step_logger.log(record)


def reset():
    """Drop all recorded telemetry (tests). Keeps the enabled flag."""
    registry.reset()
    tracer.reset()
    distributed.reset_distributed()


def dump_artifacts(directory=None):
    """Write metrics.json / metrics.prom / trace.json into `directory`
    (default $PADDLE_TPU_METRICS_DIR). Returns {artifact: path}."""
    import json
    directory = directory or metrics_dir()
    if not directory:
        raise ValueError(
            'dump_artifacts: no directory given and PADDLE_TPU_METRICS_DIR '
            'is unset')
    os.makedirs(directory, exist_ok=True)
    paths = {}
    m = os.path.join(directory, 'metrics.json')
    with open(m, 'w') as f:
        json.dump({'generated_unix_time': time.time(),
                   'metrics': registry.to_dict()}, f, indent=1)
    paths['metrics'] = m
    p = os.path.join(directory, 'metrics.prom')
    with open(p, 'w') as f:
        f.write(registry.prometheus_text())
    paths['prometheus'] = p
    t = os.path.join(directory, 'trace.json')
    tracer.dump(t)
    paths['trace'] = t
    if step_logger.path:
        paths['steps'] = step_logger.path
    return paths
