"""Stdlib HTTP front end for the serving subsystem (counterpart of
paddle_tpu/serving/server.py).

A ``ThreadingHTTPServer`` (one handler thread per connection — the handler
threads only parse JSON and block on futures; all device work stays on the
single batcher worker, or the decode scheduler's) exposing:

- ``POST /predict`` — body ``{"inputs": {name: nested-list}, "timeout_ms":
  optional}`` (or inputs as a list in feed order). Reply ``{"outputs":
  {fetch_name: nested-list}, "rows": n, "latency_ms": ...}``. Typed errors
  map to status codes: InvalidRequest→400, a body over ``MAX_BODY_BYTES``
  →413, Overloaded→429 (backpressure — clients retry with backoff),
  DeadlineExceeded→504, EngineUnhealthy / EngineClosed→503, anything
  else→500. Every error body is ``{"error": type, "message": ...}``.
- ``POST /generate`` — stateful streaming generation over a decode
  scheduler, see :meth:`_Handler._do_generate`.
- ``GET /healthz`` — 200 ``{"status": "ok", ...}`` while serving, 503
  ``draining`` once shutdown begins (load-balancer eviction), 503
  ``degraded`` while a circuit breaker is not closed.
- ``GET /metrics`` — Prometheus text exposition from the shared
  observability registry (serving_* and decode_* series plus anything
  telemetry collected).

Run one from the CLI::

    python -m paddle_tpu_torch.serving.server --model-dir /path/to/model \
        --port 8080 --max-batch-size 16 --batch-timeout-ms 2

(on the card; ``--device cpu`` serves from the CPU). Shutdown (SIGTERM /
SIGINT / :meth:`ServingServer.shutdown`) is graceful: healthz flips to
draining, the batcher and the scheduler drain every admitted request, then
the listener stops.
"""
from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from . import metrics as _m
from .batcher import (DEFAULT_BATCH_TIMEOUT_MS, DEFAULT_QUEUE_DEPTH,
                      MicroBatcher)
from .engine import InferenceEngine
from .errors import (DeadlineExceeded, EngineClosed, EngineUnhealthy,
                     InvalidRequest, Overloaded)
from ..log_helper import get_logger
from ..observability import TraceContext
from ..observability import distributed as _dobs

__all__ = ['ServingServer', 'create_server']

_logger = get_logger(
    __name__, logging.INFO,
    fmt='%(asctime)s-%(levelname)s: [serving] %(message)s')

MAX_BODY_BYTES = 64 * 1024 * 1024

_STATUS_BY_ERROR = ((InvalidRequest, 400), (Overloaded, 429),
                    (DeadlineExceeded, 504), (EngineUnhealthy, 503),
                    (EngineClosed, 503))

# /generate request schema: unknown keys are a 400 naming the field (a
# typo'd sampling knob silently dropped would serve greedy while the
# client believes it set temperature)
_SAMPLING_KEYS = frozenset(('temperature', 'top_k', 'top_p', 'seed'))
_GENERATE_KEYS = frozenset(('prompt', 'max_new_tokens', 'eos_id', 'stream',
                            'timeout_ms', 'request_id')) | _SAMPLING_KEYS


class _Handler(BaseHTTPRequestHandler):
    protocol_version = 'HTTP/1.1'
    server_version = 'paddle-tpu-torch-serving'

    # BaseHTTPRequestHandler writes access logs to stderr with print-style
    # formatting; route through log_helper instead (never print)
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
            pass                      # client went away; nothing to salvage
        _m.http_responses.labels(code=code).inc()

    def _error(self, code, exc):
        self._reply(code, {'error': type(exc).__name__, 'message': str(exc)})

    def do_GET(self):
        srv = self.server.serving
        if self.path == '/healthz':
            # unix_time rides every healthz reply: the router's poll uses
            # it for the clock-offset handshake that aligns this process's
            # trace spans onto the router's timeline (trace_merge.py)
            if srv.draining:
                self._reply(503, {'status': 'draining',
                                  'unix_time': time.time()})
            elif srv.breaker_states():
                # a tripped (or probing) circuit breaker: this replica is
                # alive but should not receive traffic — 503 'degraded'
                # evicts it from the balancer until the probe closes the
                # breaker again
                self._reply(503, {'status': 'degraded',
                                  'breakers': srv.breaker_states(),
                                  'unix_time': time.time()})
            else:
                body = {'status': 'ok', 'replica': srv.replica_id,
                        'warmup': srv.warmup_status(),
                        'unix_time': time.time(),
                        'device': str(srv.device)}
                if srv.engine is not None:
                    body['buckets'] = srv.engine.buckets
                    body['compiled'] = srv.engine.compiled_buckets
                if srv.generator is not None:
                    # the always-on windowed load series ride every
                    # healthz reply: the router caches them per replica
                    # and the elastic autoscaler reads queue_depth /
                    # occupancy / ttft p99 off that cache — no second
                    # scrape channel
                    body['series'] = {
                        name: _dobs.series(name).snapshot()
                        for name in ('queue_depth', 'occupancy', 'ttft')}
                    eng = srv.generator.engine
                    body['decode'] = {
                        'slots': eng.slots,
                        'active': srv.generator.active(),
                        'waiting': srv.generator.pending(),
                        'cache_blocks_used': eng.pool.allocator.used,
                        'cache_blocks_total': eng.pool.allocator.capacity,
                        'prompt_buckets': eng.prompt_buckets,
                    }
                slo = srv.slo_status()
                if slo is not None:
                    body['slo'] = slo
                self._reply(200, body)
        elif self.path == '/metrics':
            from ..observability import registry
            self._reply(200, registry.prometheus_text().encode(),
                        content_type='text/plain; version=0.0.4')
        else:
            self._reply(404, {'error': 'NotFound', 'message': self.path})

    def _read_json_body(self):
        """Parse the request body; returns the payload dict or None after
        replying with the 4xx itself."""
        try:
            length = int(self.headers.get('Content-Length') or 0)
        except ValueError:
            length = -1
        if length <= 0:
            self._error(400, InvalidRequest('missing request body'))
            return None
        if length > MAX_BODY_BYTES:
            self._error(413, InvalidRequest(
                f'body of {length} bytes exceeds {MAX_BODY_BYTES}'))
            return None
        try:
            payload = json.loads(self.rfile.read(length))
        except (ValueError, UnicodeDecodeError) as e:
            self._error(400, InvalidRequest(f'bad JSON body: {e}'))
            return None
        if not isinstance(payload, dict):
            self._error(400, InvalidRequest('body must be a JSON object'))
            return None
        return payload

    def _write_chunk(self, obj):
        """One chunked-transfer NDJSON line."""
        data = json.dumps(obj).encode() + b'\n'
        self.wfile.write(b'%x\r\n' % len(data) + data + b'\r\n')
        self.wfile.flush()

    def do_POST(self):
        if self.path == '/generate':
            return self._do_generate()
        if self.path != '/predict':
            return self._reply(404, {'error': 'NotFound',
                                     'message': self.path})
        srv = self.server.serving
        if srv.batcher is None:
            return self._reply(404, {
                'error': 'NotFound',
                'message': 'no predict engine configured (decode-only '
                           'server; use POST /generate)'})
        try:
            length = int(self.headers.get('Content-Length') or 0)
        except ValueError:
            length = -1
        if length <= 0:
            return self._error(400, InvalidRequest('missing request body'))
        if length > MAX_BODY_BYTES:
            return self._error(413, InvalidRequest(
                f'body of {length} bytes exceeds {MAX_BODY_BYTES}'))
        try:
            payload = json.loads(self.rfile.read(length))
        except (ValueError, UnicodeDecodeError) as e:
            return self._error(400, InvalidRequest(f'bad JSON body: {e}'))
        if not isinstance(payload, dict) or 'inputs' not in payload:
            return self._error(400, InvalidRequest(
                'body must be {"inputs": {...}, "timeout_ms": optional}'))
        timeout_ms = payload.get('timeout_ms')
        if timeout_ms is not None and not isinstance(timeout_ms, (int, float)):
            return self._error(400, InvalidRequest(
                f'timeout_ms must be a number, got {timeout_ms!r}'))
        t0 = time.perf_counter()
        try:
            fut = srv.batcher.submit(payload['inputs'], timeout_ms)
            outs = fut.result(srv.request_timeout)
        except tuple(e for e, _ in _STATUS_BY_ERROR) as e:
            for etype, code in _STATUS_BY_ERROR:
                if isinstance(e, etype):
                    return self._error(code, e)
        except TimeoutError as e:
            return self._error(504, e)
        except Exception as e:     # engine/internal failure: a 500, not a hang
            _logger.error('predict failed: %s: %s', type(e).__name__, e)
            return self._error(500, e)
        names = srv.engine.get_output_names()
        self._reply(200, {
            'outputs': {n: np.asarray(o).tolist() for n, o in
                        zip(names, outs)},
            'rows': int(np.asarray(outs[0]).shape[0]) if outs else 0,
            'latency_ms': round((time.perf_counter() - t0) * 1e3, 3)})

    def _do_generate(self):
        """POST /generate — stateful streaming generation. Body::

            {"prompt": [token ids], "max_new_tokens": 16,
             "eos_id": optional, "stream": true, "timeout_ms": optional,
             "temperature": 0.0, "top_k": 0, "top_p": 1.0,
             "seed": optional, "request_id": optional}

        Sampling keys are validated typed (serving/decode/sampling.py):
        a bad value OR an unknown body key is a 400 naming the field —
        a typo'd knob must never be silently dropped. Sampled streams
        replay bitwise from ``request_id`` (or ``seed``); greedy
        (temperature 0, the default) is exact argmax.

        ``stream=true`` (default) replies 200 with chunked NDJSON: one
        ``{"token": id, "index": i}`` line per decoded token, then a final
        ``{"done": true, "finish_reason": ..., "tokens": [...],
        "latency_ms": ...}`` line. A failure after streaming began arrives
        as an ``{"error": ..., "message": ...}`` line (the 200 status is
        already on the wire — chunked streaming's standard caveat).
        ``stream=false`` blocks and returns the whole generation as one
        JSON reply. Pre-admission failures map like /predict:
        InvalidRequest→400, Overloaded→429, DeadlineExceeded→504,
        EngineClosed→503."""
        srv = self.server.serving
        if srv.generator is None:
            return self._reply(404, {
                'error': 'NotFound',
                'message': 'no decode engine configured (predict-only '
                           'server; use POST /predict)'})
        payload = self._read_json_body()
        if payload is None:
            return
        prompt = payload.get('prompt')
        if not isinstance(prompt, list):
            return self._error(400, InvalidRequest(
                'body must include "prompt": [token ids]'))
        unknown = sorted(set(payload) - _GENERATE_KEYS)
        if unknown:
            return self._error(400, InvalidRequest(
                f'unknown request field(s): {", ".join(unknown)}; '
                f'supported: {", ".join(sorted(_GENERATE_KEYS))}'))
        sampling = {k: payload[k] for k in _SAMPLING_KEYS if k in payload}
        try:
            # distributed trace carrier: absent
            # header = untraced (one dict get); malformed = client bug, 400
            trace = TraceContext.from_headers(self.headers)
        except ValueError as e:
            return self._error(400, InvalidRequest(str(e)))
        t0 = time.perf_counter()
        try:
            stream = srv.generator.submit(
                prompt,
                max_new_tokens=payload.get('max_new_tokens', 16),
                eos_id=payload.get('eos_id'),
                timeout_ms=payload.get('timeout_ms'),
                sampling=sampling or None,
                request_id=payload.get('request_id'),
                trace=trace)
        except tuple(e for e, _ in _STATUS_BY_ERROR) as e:
            for etype, code in _STATUS_BY_ERROR:
                if isinstance(e, etype):
                    return self._error(code, e)
        except Exception as e:
            _logger.error('generate failed: %s: %s', type(e).__name__, e)
            return self._error(500, e)

        if payload.get('stream', True) is False:
            try:
                toks = stream.result(srv.request_timeout)
            except tuple(e for e, _ in _STATUS_BY_ERROR) as e:
                for etype, code in _STATUS_BY_ERROR:
                    if isinstance(e, etype):
                        return self._error(code, e)
            except TimeoutError as e:
                return self._error(504, e)
            except Exception as e:
                _logger.error('generate failed: %s: %s',
                              type(e).__name__, e)
                return self._error(500, e)
            return self._reply(200, {
                'tokens': toks, 'finish_reason': stream.finish_reason,
                'latency_ms': round((time.perf_counter() - t0) * 1e3, 3),
                **stream.meta})

        # chunked per-token streaming
        self.send_response(200)
        self.send_header('Content-Type', 'application/x-ndjson')
        self.send_header('Transfer-Encoding', 'chunked')
        self.end_headers()
        try:
            try:
                for i, tok in enumerate(
                        stream.iter_tokens(srv.request_timeout)):
                    self._write_chunk({'token': int(tok), 'index': i})
                self._write_chunk({
                    'done': True, 'finish_reason': stream.finish_reason,
                    'tokens': stream.tokens,
                    'latency_ms': round((time.perf_counter() - t0) * 1e3,
                                        3),
                    **stream.meta})
            except (BrokenPipeError, ConnectionResetError):
                raise                 # client went away: just stop
            except Exception as e:    # failure mid-stream: error line
                self._write_chunk({'error': type(e).__name__,
                                   'message': str(e)})
            self.wfile.write(b'0\r\n\r\n')
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass                      # generation continues server-side
        _m.http_responses.labels(code=200).inc()


class ServingServer:
    """Engine + batcher + ThreadingHTTPServer, wired and lifecycle-managed.

    Pass an :class:`InferenceEngine` (or a model dir, from which one is
    built). ``port=0`` binds an ephemeral port (tests); read ``.port`` after
    construction.
    """

    def __init__(self, engine, host='127.0.0.1', port=8080,
                 max_batch_size=None, batch_timeout_ms=None, queue_depth=None,
                 default_timeout_ms=None, request_timeout=60.0, warmup=False,
                 generator=None):
        """``generator``: an optional :class:`decode.DecodeScheduler` —
        enables ``POST /generate`` streaming generation beside (or, with
        ``engine=None``, instead of) the stateless ``/predict`` path."""
        if engine is None:
            if generator is None:
                raise ValueError('need an engine, a generator, or both')
            self.engine = None
            self.batcher = None
        else:
            if not isinstance(engine, InferenceEngine):
                engine = InferenceEngine(engine,
                                         max_batch_size=max_batch_size)
            self.engine = engine
            if warmup:
                timings = self.engine.warmup()
                _logger.info('warmed %d buckets: %s', len(timings),
                             {b: round(s, 3) for b, s in timings.items()})
            self.batcher = MicroBatcher(
                engine,
                max_batch_size=max_batch_size,
                batch_timeout_ms=(DEFAULT_BATCH_TIMEOUT_MS
                                  if batch_timeout_ms is None
                                  else batch_timeout_ms),
                queue_depth=(DEFAULT_QUEUE_DEPTH if queue_depth is None
                             else queue_depth),
                default_timeout_ms=default_timeout_ms)
        self.generator = generator
        if generator is not None and warmup:
            timings = generator.engine.warmup()
            _logger.info('warmed decode engine: %s',
                         {k: round(s, 3) for k, s in timings.items()})
        self.request_timeout = request_timeout
        # PADDLE_TPU_SLO monitor (strict parse fails construction, not the
        # first /healthz) + span-record process label for trace merging
        self._slo = _dobs.SLOMonitor.from_env()
        _dobs.set_process_label(self.replica_id)
        self.draining = False
        self._shutdown_started = False
        self._shutdown_lock = threading.Lock()
        self._old_handlers = {}
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.serving = self
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def device(self):
        """The device the engine (else the decode engine) runs on."""
        if self.engine is not None:
            return self.engine.device
        return self.generator.engine.device

    @property
    def replica_id(self):
        """This serving process's identity (stamped into /healthz and every
        GenerationStream's metadata)."""
        if self.generator is not None:
            return self.generator.replica_id
        return (os.environ.get('PADDLE_TPU_REPLICA_ID')
                or f'replica-{os.getpid()}')

    def warmup_status(self):
        """Per-component warmth for /healthz: the serving-tier router
        refuses to route to a replica whose ``done`` is false, so a restart
        never serves its first requests into a first-run cliff (kernel
        builds, algorithm choices). ``done`` = every configured component
        (predict bucket ladder, decode prefill ladder + lockstep step
        shape) has run."""
        status = {}
        if self.engine is not None:
            status['predict'] = self.engine.warmed
        if self.generator is not None:
            status['decode'] = self.generator.engine.warmed
        status['done'] = all(status.values()) if status else False
        return status

    def slo_status(self):
        """Evaluate the PADDLE_TPU_SLO clauses against the live windowed
        series (None when no SLO is configured). Each evaluation also
        drives the slo_ok gauges + slo_breaches burn counters."""
        if self._slo is None:
            return None
        return self._slo.evaluate()

    def breaker_states(self):
        """{component: breaker state} for every NON-closed circuit breaker
        (empty dict = fully healthy)."""
        states = {}
        if self.batcher is not None and \
                self.batcher.breaker.state != 'closed':
            states['predict'] = self.batcher.breaker.state
        if self.generator is not None:
            breaker = getattr(self.generator, 'breaker', None)
            if breaker is not None and breaker.state != 'closed':
                states['decode'] = breaker.state
        return states

    def start(self):
        """Serve in a background thread; returns self."""
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name='paddle-tpu-torch-http',
                                        daemon=True)
        self._thread.start()
        _logger.info('serving on %s:%d (buckets %s)',
                     self._httpd.server_address[0], self.port,
                     self.engine.buckets if self.engine else '[decode-only]')
        return self

    def serve_forever(self):
        """Foreground serve (the CLI path). SIGTERM (pod preemption) and
        SIGINT (Ctrl-C) both trigger the graceful, timeout-capped drain —
        see :meth:`install_signal_handlers`."""
        _logger.info('serving on %s:%d (buckets %s)',
                     self._httpd.server_address[0], self.port,
                     self.engine.buckets if self.engine else '[decode-only]')
        try:
            self.install_signal_handlers()
        except ValueError:
            pass                       # not the main thread: Ctrl-C only
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.uninstall_signal_handlers()
            self.shutdown()

    def install_signal_handlers(self, signals=(signal.SIGTERM, signal.SIGINT)):
        """SIGTERM-safe shutdown: on signal, /healthz
        flips to draining immediately (load-balancer eviction) and a
        background thread runs the graceful ``shutdown(drain=True)`` — the
        handler itself returns right away (signal context must stay cheap).
        The drain is capped by ``PADDLE_TPU_DRAIN_TIMEOUT_S`` (default 30);
        past the cap, remaining queued work fails fast with EngineClosed
        rather than holding the pod through its kill grace period.

        Must be called from the main thread; returns self. The CLI path
        (`serve_forever`) installs these automatically."""
        self._old_handlers = {}
        for s in signals:
            self._old_handlers[s] = signal.signal(s, self._on_signal)
        return self

    def uninstall_signal_handlers(self):
        for s, old in getattr(self, '_old_handlers', {}).items():
            try:
                signal.signal(s, old)
            except (ValueError, TypeError):
                pass
        self._old_handlers = {}

    def _on_signal(self, signum, frame):
        _logger.warning('signal %d: draining (healthz now 503)', signum)
        self.draining = True           # visible to /healthz immediately
        threading.Thread(target=self.shutdown, kwargs={'drain': True},
                         name='paddle-tpu-torch-drain',
                         daemon=True).start()

    def shutdown(self, drain=True, timeout=None):
        """Graceful stop: healthz flips to draining, admission closes, queued
        requests run to completion (drain=True), then the listener stops.
        `timeout` (default ``PADDLE_TPU_DRAIN_TIMEOUT_S``, 30s) caps the
        drain: components still busy at the deadline are re-closed with
        drain=False, failing their remaining queue fast."""
        with self._shutdown_lock:
            if self._shutdown_started:
                return
            self._shutdown_started = True
        self.draining = True
        if timeout is None:
            timeout = float(
                os.environ.get('PADDLE_TPU_DRAIN_TIMEOUT_S', '') or 30.0)
        deadline = time.monotonic() + timeout
        for comp in (self.batcher, self.generator):
            if comp is None:
                continue
            remaining = max(0.0, deadline - time.monotonic())
            comp.close(drain=drain, timeout=remaining if drain else None)
            if comp._worker.is_alive():
                # drain exceeded its budget: escalate to fail-fast so the
                # process exits inside the kill grace period
                _logger.warning(
                    'drain timeout (%.1fs) exceeded; failing remaining '
                    'queued work fast', timeout)
                comp.close(drain=False, timeout=5)
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(5)
        _logger.info('serving stopped (drained=%s)', drain)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


def create_server(model_dir_or_config, **kwargs):
    """One-call constructor: ``create_server('/path', port=8080).start()``."""
    return ServingServer(model_dir_or_config, **kwargs)


def main(argv=None):
    """``python -m paddle_tpu_torch.serving.server --model-dir DIR``: serve
    the saved model behind ``/predict`` on the card (``--device cpu`` for
    the CPU). It prints one JSON line, ``{"ready": true, "port": N, "pid":
    P, "device": ..., "buckets": [...]}``, then serves until SIGTERM or
    SIGINT."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        description='paddle_tpu_torch serving: micro-batched inference over '
                    'HTTP')
    ap.add_argument('--model-dir', required=True)
    ap.add_argument('--model-filename', default=None)
    ap.add_argument('--params-filename', default=None)
    ap.add_argument('--host', default='0.0.0.0')
    ap.add_argument('--port', type=int, default=8080)
    ap.add_argument('--max-batch-size', type=int, default=None)
    ap.add_argument('--batch-timeout-ms', type=float, default=None)
    ap.add_argument('--queue-depth', type=int, default=None)
    ap.add_argument('--default-timeout-ms', type=float, default=None)
    ap.add_argument('--buckets', default=None,
                    help='comma-separated ladder, e.g. 1,2,4,8,16')
    ap.add_argument('--bf16', action='store_true')
    ap.add_argument('--no-warmup', action='store_true',
                    help='skip running the bucket ladder at startup')
    ap.add_argument('--device', default=None,
                    help='torch device (default: the CUDA card; "cpu" must '
                         'be asked for)')
    args = ap.parse_args(argv)

    from ..core.places import CPUPlace, CUDAPlace
    from ..executor import Executor
    from ..inference import Config
    cfg = Config(args.model_dir, args.model_filename, args.params_filename)
    if args.bf16:
        cfg.enable_bf16()
    buckets = [int(b) for b in args.buckets.split(',')] if args.buckets \
        else None
    place = CPUPlace() if args.device == 'cpu' else CUDAPlace(
        int(args.device.split(':')[1]) if args.device
        and ':' in args.device else 0)
    engine = InferenceEngine(cfg, executor=Executor(place),
                             max_batch_size=args.max_batch_size,
                             buckets=buckets)
    srv = ServingServer(engine, host=args.host, port=args.port,
                        max_batch_size=args.max_batch_size,
                        batch_timeout_ms=args.batch_timeout_ms,
                        queue_depth=args.queue_depth,
                        default_timeout_ms=args.default_timeout_ms,
                        warmup=not args.no_warmup)
    # a launcher parses this single stdout line for the port and pid
    sys.stdout.write(json.dumps({'ready': True, 'port': srv.port,
                                 'pid': os.getpid(),
                                 'device': str(engine.device),
                                 'buckets': engine.buckets}) + '\n')
    sys.stdout.flush()
    srv.serve_forever()


if __name__ == '__main__':
    main()
