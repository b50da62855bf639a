"""Multi-replica router (counterpart of paddle_tpu/serving/tier/router.py):
least-loaded dispatch over N replica processes, circuit-breaker awareness,
the cold-replica gate, failover before the first event and rolling restarts
behind a drain.

One router process fronts N replicas (each a ``ServingServer`` over a
decode scheduler; ``python -m paddle_tpu_torch.serving.tier.replica`` is
the canonical one). The router holds no model state and touches no device:
it polls each replica's ``/healthz`` (status, breaker state, decode load,
``warmup``) and sends each ``/generate`` to the least loaded routable
replica.

Routability, per replica:

- ``draining`` (router-side, a rolling restart): never routed;
- ``/healthz`` 503 ``degraded`` (breaker open): drained, except a breaker
  reporting ``half_open``: exactly ONE in-flight request goes there as the
  probe, and its success closes the breaker and re-admits the replica;
- ``warmup.done`` false: not routed (a restarted replica never serves its
  first requests while it builds and warms);
- otherwise routable, ties broken by load = the router's in-flight count
  plus the replica's reported ``active + waiting``.

Failover: a dispatch that fails BEFORE the first generation event
(connection refused, the replica died before streaming, 500, 503) is
retried on the next best replica (greedy generation is deterministic, and
a sampled request carries a router-stamped ``request_id`` that seeds its
stream, so a retry is idempotent). Once a token went out, a replica's
death is an error event on that stream: a dying replica kills only its
in-flight streams.

Counters: the registry's ``router_*`` family (serving/metrics.py, the
router's ``GET /metrics``), recorded at the reference's sites, and
``Router.stats``, the router's own view under the same names:
``router_requests``, ``router_requests_completed``,
``router_requests_failed``, ``router_requests_rerouted``,
``router_no_replica``, ``router_probes``, ``router_health_polls``,
``router_rolling_restarts`` and ``router_dispatch_seconds`` (the last
4096).

Observability: the router is the trace EDGE. ``maybe_sample()``
(``PADDLE_TPU_TRACE_SAMPLE``) decides once per request, the context rides
the ``X-PaddleTPU-Trace`` header to the replica, and the router records
the request root, per-attempt dispatch and retry spans around the
replica's spans. ``GET /metrics/fleet`` serves the replicas' merged
Prometheus export (counters summed, gauges labelled by replica,
histograms merged bucket by bucket), and the health poll doubles as the
clock handshake: each ``/healthz`` reply's ``unix_time`` gives the
replica's offset from the router's clock.

Knobs (tier/knobs.py, strict): ``PADDLE_TPU_ROUTER_REPLICAS``,
``PADDLE_TPU_ROUTER_PORT``, ``PADDLE_TPU_ROUTER_HEALTH_POLL_S``.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import metrics as _m
from ..errors import InvalidRequest, NoReplicaAvailable, ServingError
from ...observability import distributed as _dobs
from ...observability import registry
from ...observability.trace_context import maybe_sample
from .knobs import (ENV_ROUTER_HEALTH_POLL_S, ENV_ROUTER_PORT,
                    ENV_ROUTER_REPLICAS, parse_float_env, parse_int_env,
                    parse_replicas_env)

__all__ = ['Router', 'RouterServer', 'RoutedGeneration', 'Replica', 'main']

_logger = logging.getLogger(__name__)

# the replica's /generate schema (serving/server.py): the router rejects
# unknown keys with the same 400, at the front door
_SAMPLING_KEYS = ('temperature', 'top_k', 'top_p', 'seed')
_GENERATE_KEYS = frozenset(('prompt', 'max_new_tokens', 'eos_id', 'stream',
                            'timeout_ms', 'request_id', *_SAMPLING_KEYS))

# dispatch failures that are the replica's fault: retry elsewhere. A 4xx
# (bad request, backpressure, deadline) is the client's and passes through
_REROUTE_HTTP_CODES = (500, 503)


def _span(ctx, name, start_perf, end_perf, **args):
    """Router-side span record; free (one None check) when untraced."""
    if ctx is None:
        return
    _m.trace_spans_recorded.inc()
    _dobs.record_span(ctx, name, start_perf, end_perf, **args)


def _attach_sampling(payload, temperature, top_k, top_p, seed, request_id):
    """Add a request's sampling keys to a /generate payload. A sampled
    request with no pinned identity gets a router-stamped ``request_id``:
    the id seeds its stream, so a retry on another replica replays the
    same tokens."""
    if temperature is not None:
        payload['temperature'] = float(temperature)
    if top_k is not None:
        payload['top_k'] = int(top_k)
    if top_p is not None:
        payload['top_p'] = float(top_p)
    if seed is not None:
        payload['seed'] = int(seed)
    if request_id is not None:
        payload['request_id'] = str(request_id)
    elif payload.get('temperature') and seed is None:
        payload['request_id'] = uuid.uuid4().hex[:16]
    return payload


class Replica:
    """The router's view of one replica process."""

    def __init__(self, url):
        self.url = url.rstrip('/')
        self.healthy = False
        self.warmed = False
        self.half_open = False
        self.draining = False         # router-side (rolling restart)
        self.reported_load = 0        # decode active + waiting at last poll
        self.inflight = 0             # router-side, counted at dispatch
        self.last_poll_ok = 0.0
        # clock handshake: the replica's unix time less the router's, from
        # the health poll's round-trip midpoint
        self.clock_offset = None
        self.replica_id = None        # /healthz's ``replica``
        # /healthz's windowed-series snapshots (queue_depth, occupancy,
        # ttft)
        self.series = {}
        self._lock = threading.Lock()

    def load(self):
        return self.inflight + self.reported_load

    def routable(self):
        if self.draining:
            return False
        if self.healthy and self.warmed:
            return True
        # half-open probe: one request at a time re-admits a tripped replica
        return self.half_open and self.inflight == 0

    def begin(self):
        with self._lock:
            self.inflight += 1
            _m.router_replica_inflight.labels(replica=self.url).set(
                self.inflight)

    def end(self):
        with self._lock:
            self.inflight = max(self.inflight - 1, 0)
            _m.router_replica_inflight.labels(replica=self.url).set(
                self.inflight)

    def mark_dead(self):
        self.healthy = False
        self.half_open = False

    def state(self):
        return {'url': self.url, 'healthy': self.healthy,
                'warmed': self.warmed, 'half_open': self.half_open,
                'draining': self.draining, 'inflight': self.inflight,
                'reported_load': self.reported_load}


class RoutedGeneration:
    """One routed streaming generation: ``events()`` yields the replica's
    NDJSON events (``{'token', 'index'}`` lines, then the ``done`` line
    with ``replica`` and ``retries`` added). ``replica`` / ``retries``
    describe the dispatch that is streaming."""

    def __init__(self, router, payload, timeout):
        self._router = router
        self._payload = payload
        self._timeout = timeout
        self.replica = None           # the url streaming
        self.retries = 0              # reroutes before streaming began
        self.first_event_at = None
        # sampling is decided ONCE here at the edge; the context travels
        # with every dispatch, so a trace is complete or absent
        self.trace = maybe_sample()
        if self.trace is not None:
            _m.trace_requests_sampled.inc()

    def events(self):
        router, payload = self._router, self._payload
        deadline = time.monotonic() + self._timeout
        tried = set()
        req_t0 = time.perf_counter()
        while True:
            rep = router._pick(tried, deadline)
            self.replica = rep.url
            rep.begin()
            t0 = time.perf_counter()
            emitted = False
            # each dispatch attempt is its own span under the request root;
            # the replica parents its spans under the attempt's id
            attempt = self.trace.child() if self.trace is not None else None
            try:
                try:
                    resp = router._post(rep, payload, self._timeout,
                                        trace=attempt)
                except urllib.error.HTTPError as e:
                    if e.code in _REROUTE_HTTP_CODES:
                        raise ConnectionError(f'replica replied {e.code}')
                    raise                     # the client's error: a 4xx
                router._count('router_dispatch_seconds',
                              time.perf_counter() - t0)
                for raw in resp:
                    event = json.loads(raw)
                    if not emitted:
                        emitted = True
                        self.first_event_at = time.monotonic()
                    if event.get('done'):
                        event['replica'] = rep.url
                        event['retries'] = self.retries
                        if self.trace is not None:
                            event.setdefault('trace_id',
                                             self.trace.trace_id)
                            # the spans land BEFORE the done yield: the
                            # consumer may drop the generator right after
                            now = time.perf_counter()
                            _span(attempt, 'router/dispatch', t0, now,
                                  replica=rep.url)
                            _span(self.trace, 'router/request', req_t0,
                                  now, retries=self.retries)
                        router._count('router_requests_completed')
                        yield event
                        return
                    if 'error' in event:      # a typed replica failure
                        router._count('router_requests_failed')
                        now = time.perf_counter()
                        _span(attempt, 'router/dispatch', t0, now,
                              replica=rep.url, error=event.get('error'))
                        _span(self.trace, 'router/request', req_t0, now,
                              retries=self.retries,
                              error=event.get('error'))
                        yield event
                        return
                    yield event
                # the stream ended without a done line: the replica died
                raise ConnectionError('replica stream ended early')
            except urllib.error.HTTPError:
                # only the client's 4xx reach here (reroutable codes became
                # ConnectionError); HTTPError is a URLError, so it goes first
                raise
            except (ConnectionError, urllib.error.URLError, OSError) as e:
                rep.mark_dead()
                if emitted:
                    # tokens already went out: this stream dies with its
                    # replica, the only thing a replica's death may kill
                    router._count('router_requests_failed')
                    now = time.perf_counter()
                    _span(attempt, 'router/dispatch', t0, now,
                          replica=rep.url, error='ReplicaDied')
                    _span(self.trace, 'router/request', req_t0, now,
                          retries=self.retries, error='ReplicaDied')
                    yield {'error': 'ReplicaDied',
                           'message': f'replica {rep.url} failed '
                                      f'mid-stream: {e}',
                           'replica': rep.url, 'retries': self.retries}
                    return
                # nothing streamed yet: reroute, no client-visible drop
                tried.add(rep)
                self.retries += 1
                router._count('router_requests_rerouted')
                # the failed attempt becomes a retry span, between the two
                # replicas' spans
                _span(attempt, 'router/retry', t0, time.perf_counter(),
                      replica=rep.url, error=str(e))
                _logger.warning('rerouting (attempt %d) off %s: %s',
                                self.retries + 1, rep.url, e)
            finally:
                rep.end()


class Router:
    """See the module docstring. ``replica_urls``: the replicas' base URLs
    (``http://host:port``). ``health_poll_s`` defaults from
    ``PADDLE_TPU_ROUTER_HEALTH_POLL_S`` (1 s)."""

    def __init__(self, replica_urls, health_poll_s=None,
                 request_timeout=120.0, connect_timeout=5.0, start=True):
        if not replica_urls:
            raise ValueError('need at least one replica URL')
        self.replicas = [Replica(u) for u in replica_urls]
        self._replicas_lock = threading.Lock()   # guards membership only
        self._stats_lock = threading.Lock()
        self.health_poll_s = (parse_float_env(ENV_ROUTER_HEALTH_POLL_S, 1.0)
                              if health_poll_s is None
                              else float(health_poll_s))
        self.request_timeout = float(request_timeout)
        self.connect_timeout = float(connect_timeout)
        self.reset_stats()
        _dobs.set_process_label('router')
        self._closed = threading.Event()
        self.poll_once()              # the constructor returns with state
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name='paddle-tpu-torch-router-health',
            daemon=True)
        if start:
            self._poll_thread.start()

    def reset_stats(self):
        with self._stats_lock:
            self.stats = {
                'router_requests': 0, 'router_requests_completed': 0,
                'router_requests_failed': 0, 'router_requests_rerouted': 0,
                'router_no_replica': 0, 'router_probes': 0,
                'router_health_polls': 0, 'router_rolling_restarts': 0,
                'router_dispatch_seconds': collections.deque(maxlen=4096)}

    def _count(self, name, seconds=None):
        """One event of the ``router_*`` metric ``name``: into the
        registry and into ``stats``."""
        metric = getattr(_m, name)
        with self._stats_lock:
            if seconds is None:
                self.stats[name] += 1
            else:
                self.stats[name].append(seconds)
        if seconds is None:
            metric.inc()
        else:
            metric.observe(seconds)

    def _set_routable(self):
        _m.router_replicas_routable.set(
            sum(r.healthy and r.warmed and not r.draining
                for r in self.replicas))

    # -- health ------------------------------------------------------------
    def _poll_replica(self, rep):
        self._count('router_health_polls')
        try:
            u0 = time.time()
            with urllib.request.urlopen(rep.url + '/healthz',
                                        timeout=self.connect_timeout) as r:
                body = json.load(r)
            u1 = time.time()
            rep.healthy = body.get('status') == 'ok'
            rep.half_open = False
            warm = body.get('warmup')
            # a replica without the warmup field is taken as warm
            rep.warmed = bool(warm.get('done')) if warm else rep.healthy
            decode = body.get('decode') or {}
            rep.reported_load = (int(decode.get('active', 0))
                                 + int(decode.get('waiting', 0)))
            rep.last_poll_ok = time.monotonic()
            rep.replica_id = body.get('replica') or rep.replica_id
            rep.series = body.get('series') or rep.series
            if 'unix_time' in body:
                # the replica stamped its clock somewhere inside [u0, u1]:
                # the midpoint is the least biased guess (error <= RTT/2)
                rep.clock_offset = float(body['unix_time']) - (u0 + u1) / 2.0
                _m.trace_clock_offset_seconds.labels(
                    replica=rep.replica_id or rep.url).set(rep.clock_offset)
                _dobs.record_clock_offset(rep.replica_id or rep.url,
                                          rep.clock_offset, rtt_s=u1 - u0)
        except urllib.error.HTTPError as e:
            try:
                body = json.load(e)
            except Exception:
                body = {}
            rep.healthy = False
            # a half-open breaker needs ONE probe request to re-admit the
            # replica; the router is its only traffic, so it sends one
            rep.half_open = any(
                s == 'half_open'
                for s in (body.get('breakers') or {}).values())
            rep.last_poll_ok = time.monotonic()
        except OSError:
            rep.mark_dead()
        self._set_routable()

    def poll_once(self):
        for rep in list(self.replicas):
            self._poll_replica(rep)

    def _poll_loop(self):
        while not self._closed.wait(self.health_poll_s):
            self.poll_once()

    def _fast_poll(self, rep):
        """Admission poll of a freshly added replica: 50 ms, doubling up
        to ``health_poll_s``, until it is routable, so its time to routable
        follows its warm-up, not the poll period."""
        delay = 0.05
        while not self._closed.wait(delay):
            if rep not in self.replicas:
                return                 # removed before it came up
            self._poll_replica(rep)
            if rep.routable():
                _logger.info('replica %s admitted', rep.url)
                return
            delay = min(delay * 2, self.health_poll_s)

    # -- membership --------------------------------------------------------
    def add_replica(self, url, fast_poll=True):
        """Register a replica at run time. It starts unpolled, so not
        routable, and the fast poll admits it once ``/healthz`` reports it
        healthy and warm (the cold-replica gate). Returns its
        :class:`Replica` (the existing one if already registered)."""
        url = url.rstrip('/')
        with self._replicas_lock:
            for r in self.replicas:
                if r.url == url:
                    return r
            rep = Replica(url)
            # copy on write: readers iterate a stable list
            self.replicas = self.replicas + [rep]
        if fast_poll:
            threading.Thread(target=self._fast_poll, args=(rep,),
                             name='paddle-tpu-torch-router-admit',
                             daemon=True).start()
        return rep

    def remove_replica(self, url):
        """Deregister a replica (after a drain). In-flight streams keep
        their handle to it; it stops being a dispatch candidate. Raises
        KeyError when unknown."""
        url = url.rstrip('/')
        with self._replicas_lock:
            rep = next((r for r in self.replicas if r.url == url), None)
            if rep is None:
                raise KeyError(f'unknown replica {url}')
            self.replicas = [r for r in self.replicas if r is not rep]
        self._set_routable()
        return rep

    # -- dispatch ----------------------------------------------------------
    def _pick(self, exclude, deadline):
        """The least loaded routable replica, waiting (until ``deadline``)
        through moments when none is, so a blip drops no request. Raises
        :class:`NoReplicaAvailable` at the deadline."""
        while True:
            candidates = [r for r in self.replicas
                          if r not in exclude and r.routable()]
            if candidates:
                rep = min(candidates, key=lambda r: r.load())
                if rep.half_open and not rep.healthy:
                    self._count('router_probes')
                    _logger.info('routing a probe to half-open replica %s',
                                 rep.url)
                return rep
            self._count('router_no_replica')
            if time.monotonic() >= deadline:
                raise NoReplicaAvailable(
                    [r.state() for r in self.replicas])
            # a blip: excluded replicas may have recovered
            exclude.clear()
            time.sleep(min(0.2, self.health_poll_s))
            self.poll_once()

    def _post(self, rep, payload, timeout, trace=None):
        headers = {'Content-Type': 'application/json'}
        if trace is not None:
            headers.update(trace.to_headers())
        req = urllib.request.Request(
            rep.url + '/generate', data=json.dumps(payload).encode(),
            headers=headers)
        return urllib.request.urlopen(req, timeout=timeout)

    # -- fleet metrics -----------------------------------------------------
    def scrape_replica_metrics(self, timeout_s=2.0):
        """Scrape every replica's ``/metrics``; returns ``[(label, text),
        ...]`` for the scrapes that succeeded. A dead or wedged replica
        costs one bounded timeout and a ``router_scrape_failures`` tick,
        never a failed fleet scrape."""
        scrapes = []
        for rep in self.replicas:
            label = rep.replica_id or rep.url
            try:
                with urllib.request.urlopen(rep.url + '/metrics',
                                            timeout=timeout_s) as r:
                    scrapes.append((label,
                                    r.read().decode('utf-8', 'replace')))
            except (OSError, ValueError) as e:
                _m.router_scrape_failures.labels(replica=label).inc()
                _logger.warning('fleet scrape of %s failed: %s',
                                rep.url, e)
        return scrapes

    def fleet_metrics_text(self, timeout_s=2.0):
        """The replicas' merged Prometheus text (``GET /metrics/fleet``).
        The router's own metrics stay on ``/metrics``: this is the
        replicas' merged view, so the two exports never count twice."""
        _m.router_fleet_scrapes.inc()
        return _dobs.merge_fleet_metrics(
            self.scrape_replica_metrics(timeout_s))

    # -- client API --------------------------------------------------------
    def _payload(self, prompt, max_new_tokens, eos_id, timeout_ms, stream,
                 sampling):
        self._count('router_requests')
        payload = {'prompt': list(prompt),
                   'max_new_tokens': int(max_new_tokens), 'stream': stream}
        if eos_id is not None:
            payload['eos_id'] = int(eos_id)
        if timeout_ms is not None:
            payload['timeout_ms'] = timeout_ms
        return _attach_sampling(payload, *sampling)

    def stream_generate(self, prompt, max_new_tokens=16, eos_id=None,
                        timeout_ms=None, timeout=None, temperature=None,
                        top_k=None, top_p=None, seed=None, request_id=None):
        """Route one streaming generation; returns a
        :class:`RoutedGeneration` (consume ``.events()``)."""
        payload = self._payload(prompt, max_new_tokens, eos_id, timeout_ms,
                                True, (temperature, top_k, top_p, seed,
                                       request_id))
        return RoutedGeneration(self, payload,
                                timeout or self.request_timeout)

    def generate(self, prompt, max_new_tokens=16, eos_id=None,
                 timeout_ms=None, timeout=None, **sampling):
        """Route, stream to the end and return the final ``done`` dict
        (raises on an error event). ``**sampling``: temperature, top_k,
        top_p, seed, request_id."""
        gen = self.stream_generate(prompt, max_new_tokens, eos_id,
                                   timeout_ms, timeout, **sampling)
        final = None
        for event in gen.events():
            if 'error' in event and not event.get('done'):
                raise ServingError(
                    f"routed generation failed: {event['error']}: "
                    f"{event.get('message')}")
            final = event
        if final is None or not final.get('done'):
            raise NoReplicaAvailable([r.state() for r in self.replicas])
        return final

    def generate_nonstream(self, prompt, max_new_tokens=16, eos_id=None,
                           timeout_ms=None, timeout=None, temperature=None,
                           top_k=None, top_p=None, seed=None,
                           request_id=None):
        """A non-streamed routed generation: the replica replies with one
        JSON body, so a failure at ANY point before it (a refused
        connection, a replica killed mid-generation, a 5xx) is retried on
        another replica; such a request survives a replica's death even in
        flight."""
        timeout = timeout or self.request_timeout
        payload = self._payload(prompt, max_new_tokens, eos_id, timeout_ms,
                                False, (temperature, top_k, top_p, seed,
                                        request_id))
        deadline = time.monotonic() + timeout
        tried = set()
        retries = 0
        trace = maybe_sample()        # the edge decision, as in events()
        if trace is not None:
            _m.trace_requests_sampled.inc()
        req_t0 = time.perf_counter()
        while True:
            rep = self._pick(tried, deadline)
            rep.begin()
            t0 = time.perf_counter()
            attempt = trace.child() if trace is not None else None
            try:
                try:
                    with self._post(rep, payload, timeout,
                                    trace=attempt) as resp:
                        body = json.load(resp)
                except urllib.error.HTTPError as e:
                    if e.code in _REROUTE_HTTP_CODES:
                        raise ConnectionError(f'replica replied {e.code}')
                    raise                     # the client's error: a 4xx
                self._count('router_dispatch_seconds',
                            time.perf_counter() - t0)
                body['replica'] = rep.url
                body['retries'] = retries
                if trace is not None:
                    body.setdefault('trace_id', trace.trace_id)
                    now = time.perf_counter()
                    _span(attempt, 'router/dispatch', t0, now,
                          replica=rep.url)
                    _span(trace, 'router/request', req_t0, now,
                          retries=retries)
                self._count('router_requests_completed')
                return body
            except urllib.error.HTTPError:
                raise                         # a 4xx (see events())
            except (ConnectionError, urllib.error.URLError, OSError,
                    ValueError) as e:
                rep.mark_dead()
                tried.add(rep)
                retries += 1
                self._count('router_requests_rerouted')
                _span(attempt, 'router/retry', t0, time.perf_counter(),
                      replica=rep.url, error=str(e))
                _logger.warning('retrying a non-streamed request off %s: '
                                '%s', rep.url, e)
            finally:
                rep.end()

    # -- operations --------------------------------------------------------
    def drain(self, url):
        self._replica_by_url(url).draining = True

    def undrain(self, url):
        self._replica_by_url(url).draining = False

    def _replica_by_url(self, url):
        url = url.rstrip('/')
        for r in self.replicas:
            if r.url == url:
                return r
        raise KeyError(f'unknown replica {url}')

    def rolling_restart(self, restart_fn, drain_timeout=60.0,
                        warm_timeout=300.0, poll_interval=0.1):
        """Restart every replica in turn behind a drain: stop routing to
        it, wait for its router-side in-flight work, call
        ``restart_fn(url)`` (which may return the restarted replica's new
        url), then wait until it reports healthy and warm before routing
        to it again and moving on; the other replicas serve meanwhile."""
        for rep in self.replicas:
            rep.draining = True
            deadline = time.monotonic() + drain_timeout
            while rep.inflight > 0 and time.monotonic() < deadline:
                time.sleep(poll_interval)
            new_url = restart_fn(rep.url)
            if new_url:
                rep.url = str(new_url).rstrip('/')
            rep.healthy = rep.warmed = False
            deadline = time.monotonic() + warm_timeout
            while time.monotonic() < deadline:
                self._poll_replica(rep)
                if rep.healthy and rep.warmed:
                    break
                time.sleep(poll_interval)
            else:
                rep.draining = False
                raise RuntimeError(
                    f'replica {rep.url} did not come back healthy and warm '
                    f'within {warm_timeout}s')
            rep.draining = False
            self._count('router_rolling_restarts')
            _logger.info('rolling restart: %s back and warm', rep.url)

    def close(self):
        self._closed.set()
        if self._poll_thread.is_alive():
            self._poll_thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = 'HTTP/1.1'
    server_version = 'paddle-tpu-torch-router'

    def log_message(self, fmt, *args):
        _logger.debug('%s %s', self.address_string(), fmt % args)

    def _reply(self, code, body, content_type='application/json'):
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        self.send_response(code)
        self.send_header('Content-Type', content_type)
        self.send_header('Content-Length', str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _write_chunk(self, obj):
        data = json.dumps(obj).encode() + b'\n'
        self.wfile.write(b'%x\r\n' % len(data) + data + b'\r\n')
        self.wfile.flush()

    def do_GET(self):
        router = self.server.router
        if self.path == '/healthz':
            states = [r.state() for r in router.replicas]
            routable = sum(r.routable() for r in router.replicas)
            self._reply(200 if routable else 503,
                        {'status': 'ok' if routable else 'no_replicas',
                         'routable': routable, 'replicas': states})
        elif self.path == '/metrics':
            self._reply(200, registry.prometheus_text().encode(),
                        content_type='text/plain; version=0.0.4')
        elif self.path == '/metrics/fleet':
            self._reply(200, router.fleet_metrics_text().encode(),
                        content_type='text/plain; version=0.0.4')
        else:
            self._reply(404, {'error': 'NotFound', 'message': self.path})

    def do_POST(self):
        if self.path != '/generate':
            return self._reply(404, {'error': 'NotFound',
                                     'message': self.path})
        router = self.server.router
        try:
            length = int(self.headers.get('Content-Length') or 0)
            payload = json.loads(self.rfile.read(length)) if length > 0 \
                else None
        except (ValueError, UnicodeDecodeError):
            payload = None
        if not isinstance(payload, dict) or \
                not isinstance(payload.get('prompt'), list):
            return self._reply(400, {
                'error': 'InvalidRequest',
                'message': 'body must include "prompt": [token ids]'})
        unknown = sorted(set(payload) - _GENERATE_KEYS)
        if unknown:
            return self._reply(400, {
                'error': 'InvalidRequest',
                'message': f'unknown request field(s): {", ".join(unknown)}'
                           f'; supported: '
                           f'{", ".join(sorted(_GENERATE_KEYS))}'})
        stream = payload.get('stream', True) is not False
        try:
            gen = router.stream_generate(
                payload['prompt'],
                max_new_tokens=payload.get('max_new_tokens', 16),
                eos_id=payload.get('eos_id'),
                timeout_ms=payload.get('timeout_ms'),
                **{k: payload[k] for k in (*_SAMPLING_KEYS, 'request_id')
                   if k in payload})
            if not stream:
                events = list(gen.events())
                final = events[-1] if events else {}
                if 'error' in final and not final.get('done'):
                    return self._reply(502, final)
                reply = {
                    'tokens': final.get('tokens', []),
                    'finish_reason': final.get('finish_reason'),
                    'replica': final.get('replica'),
                    'retries': final.get('retries', 0),
                    'request_id': final.get('request_id'),
                    'replica_id': final.get('replica_id')}
                if 'trace_id' in final:   # sampled: hand the id back
                    reply['trace_id'] = final['trace_id']
                return self._reply(200, reply)
            # take the FIRST event before committing the 200: a replica's
            # 4xx and no-replica failures raise here, while an error reply
            # can still go on the wire
            events = gen.events()
            try:
                first = next(events)
            except StopIteration:
                first = None
            self.send_response(200)
            self.send_header('Content-Type', 'application/x-ndjson')
            self.send_header('Transfer-Encoding', 'chunked')
            self.end_headers()
            try:
                if first is not None:
                    self._write_chunk(first)
                for event in events:
                    self._write_chunk(event)
                self.wfile.write(b'0\r\n\r\n')
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass                  # the client went away
        except NoReplicaAvailable as e:
            self._reply(503, {'error': 'NoReplicaAvailable',
                              'message': str(e)})
        except urllib.error.HTTPError as e:
            # a replica's 4xx, relayed as it came
            try:
                body = e.read()
            except Exception:
                body = json.dumps({'error': 'HTTPError',
                                   'message': str(e)}).encode()
            self._reply(e.code, body)
        except InvalidRequest as e:
            self._reply(400, {'error': 'InvalidRequest', 'message': str(e)})


class RouterServer:
    """Stdlib HTTP front of a :class:`Router`: ``POST /generate`` (streamed
    NDJSON or one JSON reply), ``GET /healthz``, ``GET /metrics`` (the
    router's registry) and ``GET /metrics/fleet`` (the replicas' merged
    metrics, :meth:`Router.fleet_metrics_text`). ``port=0`` binds an
    ephemeral port; the default comes from ``PADDLE_TPU_ROUTER_PORT``
    (8180)."""

    def __init__(self, router, host='127.0.0.1', port=None):
        if port is None:
            port = parse_int_env(ENV_ROUTER_PORT, 8180, minimum=0,
                                 maximum=65535)
        self.router = router
        self._httpd = ThreadingHTTPServer((host, int(port)), _RouterHandler)
        self._httpd.daemon_threads = True
        self._httpd.router = router
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name='paddle-tpu-torch-router-http',
                                        daemon=True)
        self._thread.start()
        _logger.info('routing on %s:%d over %d replicas',
                     self._httpd.server_address[0], self.port,
                     len(self.router.replicas))
        return self

    def serve_forever(self):
        _logger.info('routing on %s:%d over %d replicas',
                     self._httpd.server_address[0], self.port,
                     len(self.router.replicas))
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self.router.close()
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


def main(argv=None):
    """``python -m paddle_tpu_torch.serving.tier.router --replica URL ...``:
    route over the given replicas (or ``PADDLE_TPU_ROUTER_REPLICAS``). It
    prints one JSON line, ``{"ready": true, "port": N, "pid": P,
    "replicas": [...]}``, then serves until killed."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        description='paddle_tpu_torch serving tier: multi-replica router')
    ap.add_argument('--replica', action='append', default=None,
                    help='replica base URL (repeatable); default from '
                         'PADDLE_TPU_ROUTER_REPLICAS')
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--port', type=int, default=None,
                    help='default from PADDLE_TPU_ROUTER_PORT (8180)')
    ap.add_argument('--health-poll-s', type=float, default=None,
                    help='default from PADDLE_TPU_ROUTER_HEALTH_POLL_S (1)')
    args = ap.parse_args(argv)
    if os.environ.get('PADDLE_TPU_AUTOSCALE', '').strip() not in ('', '0'):
        raise NotImplementedError(
            'PADDLE_TPU_AUTOSCALE: the autoscaler (elastic/) comes with '
            'ROADMAP A.11')
    urls = args.replica or parse_replicas_env(ENV_ROUTER_REPLICAS)
    if not urls:
        ap.error(f'no replicas: pass --replica or set {ENV_ROUTER_REPLICAS}')
    router = Router(urls, health_poll_s=args.health_poll_s)
    server = RouterServer(router, host=args.host, port=args.port)
    sys.stdout.write(json.dumps({'ready': True, 'port': server.port,
                                 'pid': os.getpid(),
                                 'replicas': [r.url for r in
                                              router.replicas]}) + '\n')
    sys.stdout.flush()
    server.serve_forever()


if __name__ == '__main__':
    main()
