"""Distributed trace context (counterpart of
paddle_tpu/observability/trace_context.py).

A request that crosses processes (router -> replica -> scheduler ->
engine) carries ONE `TraceContext`: a 16-hex `trace_id` shared by every
span the request produces anywhere in the fleet, the `span_id` of the
span the carrier was minted under (which becomes the *parent* of spans
recorded on the receiving side), and a `sampled` bit so the disabled
path costs a single header check.

Propagation is one HTTP header::

    X-PaddleTPU-Trace: <trace_id>-<span_id>-<0|1>

Sampling is decided ONCE at the edge (the router, or whoever submits
the request) by `maybe_sample()` from `PADDLE_TPU_TRACE_SAMPLE` and then
travels with the request — downstream processes never re-roll the dice,
so a trace is always complete or absent, never partial.
"""

import os
import random
import uuid

TRACE_HEADER = 'X-PaddleTPU-Trace'

ENV_TRACE_SAMPLE = 'PADDLE_TPU_TRACE_SAMPLE'
ENV_TRACE_DIR = 'PADDLE_TPU_TRACE_DIR'


def _new_id():
    return uuid.uuid4().hex[:16]


class TraceContext(object):
    """Immutable-by-convention carrier of one request's trace identity."""

    __slots__ = ('trace_id', 'span_id', 'parent_span_id', 'sampled')

    def __init__(self, trace_id, span_id, parent_span_id=None,
                 sampled=True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.sampled = bool(sampled)

    # -- construction ---------------------------------------------------
    @classmethod
    def root(cls, sampled=True):
        """Fresh trace: new trace_id, new root span id, no parent."""
        return cls(_new_id(), _new_id(), None, sampled)

    def child(self):
        """Same trace, fresh span id, parented under this context's span.

        The receiving side records its spans under `child()` contexts so
        every span's parent_span_id resolves to a span the sender
        actually recorded."""
        return TraceContext(self.trace_id, _new_id(), self.span_id,
                            self.sampled)

    # -- wire codec -----------------------------------------------------
    def to_header(self):
        return '%s-%s-%d' % (self.trace_id, self.span_id,
                             1 if self.sampled else 0)

    def to_headers(self):
        return {TRACE_HEADER: self.to_header()}

    @classmethod
    def from_header_value(cls, value):
        """Parse the header value; raises ValueError on a malformed one
        (servers turn that into HTTP 400 — a garbled trace header is a
        client bug worth surfacing, not silently dropping)."""
        parts = str(value).strip().split('-')
        if len(parts) != 3:
            raise ValueError(
                'malformed %s header %r: expected '
                '<trace_id>-<span_id>-<0|1>' % (TRACE_HEADER, value))
        trace_id, span_id, flag = parts
        ok = (len(trace_id) == 16 and len(span_id) == 16
              and all(c in '0123456789abcdef' for c in trace_id + span_id)
              and flag in ('0', '1'))
        if not ok:
            raise ValueError(
                'malformed %s header %r: ids must be 16 lowercase hex '
                'chars and the sampled flag 0 or 1'
                % (TRACE_HEADER, value))
        return cls(trace_id, span_id, None, flag == '1')

    @classmethod
    def from_headers(cls, headers):
        """`headers` is any mapping with .get (http.client headers work).
        Returns None when the header is absent."""
        value = headers.get(TRACE_HEADER)
        if value is None:
            return None
        return cls.from_header_value(value)

    def __repr__(self):
        return ('TraceContext(trace_id=%r, span_id=%r, parent=%r, '
                'sampled=%r)' % (self.trace_id, self.span_id,
                                 self.parent_span_id, self.sampled))


def sample_rate():
    """Strict-parse `PADDLE_TPU_TRACE_SAMPLE`: a float in [0, 1].

    Unset/empty means 0.0 (tracing off — the production default costs
    one env read + one float compare per request). Malformed values
    raise naming the knob, per the repo's knob contract."""
    raw = os.environ.get(ENV_TRACE_SAMPLE, '')
    if not raw.strip():
        return 0.0
    try:
        rate = float(raw)
    except ValueError:
        raise ValueError(
            '%s=%r is not a float; supported: a sampling probability '
            'in [0, 1]' % (ENV_TRACE_SAMPLE, raw))
    if not 0.0 <= rate <= 1.0:
        raise ValueError(
            '%s=%r out of range; supported: a sampling probability '
            'in [0, 1]' % (ENV_TRACE_SAMPLE, raw))
    return rate


def maybe_sample():
    """Edge sampling decision: a fresh root context with probability
    `PADDLE_TPU_TRACE_SAMPLE`, else None (request is untraced)."""
    rate = sample_rate()
    if rate <= 0.0:
        return None
    if rate < 1.0 and random.random() >= rate:
        return None
    return TraceContext.root(sampled=True)
