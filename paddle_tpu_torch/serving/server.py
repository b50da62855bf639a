"""Stdlib HTTP front end for decode serving (counterpart of
paddle_tpu/serving/server.py, ``/generate`` and ``/healthz`` only).

A ``ThreadingHTTPServer`` (one handler thread per connection; handler
threads only parse JSON and block on streams, all device work stays on the
scheduler's single worker) exposing:

- ``POST /generate``: stateful streaming generation, see
  :meth:`_Handler._do_generate`. Typed errors map to status codes:
  InvalidRequest -> 400, Overloaded -> 429 (back off and retry),
  DeadlineExceeded -> 504, EngineUnhealthy / EngineClosed -> 503, anything
  else -> 500. Every error body is ``{"error": type, "message": ...}``.
- ``GET /healthz``: 200 ``{"status": "ok", ...}`` while serving, 503
  ``draining`` once shutdown begins, 503 ``degraded`` while the circuit
  breaker is not closed.

``POST /predict`` (the micro-batched stateless path, ROADMAP A.7b) and
``GET /metrics`` (A.11) come with later slices; they answer 404 naming
their item.

Shutdown (SIGTERM / SIGINT / :meth:`ServingServer.shutdown`) is graceful:
healthz flips to draining, the scheduler drains every admitted request,
then the listener stops.
"""
from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .errors import (DeadlineExceeded, EngineClosed, EngineUnhealthy,
                     InvalidRequest, Overloaded)

__all__ = ['ServingServer']

_logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 64 * 1024 * 1024

_STATUS_BY_ERROR = ((InvalidRequest, 400), (Overloaded, 429),
                    (DeadlineExceeded, 504), (EngineUnhealthy, 503),
                    (EngineClosed, 503))
_TYPED_ERRORS = tuple(e for e, _ in _STATUS_BY_ERROR)

# /generate request schema: unknown keys are a 400 naming the field (a
# typo'd sampling knob silently dropped would serve greedy while the client
# believes it set temperature)
_SAMPLING_KEYS = frozenset(('temperature', 'top_k', 'top_p', 'seed'))
_GENERATE_KEYS = frozenset(('prompt', 'max_new_tokens', 'eos_id', 'stream',
                            'timeout_ms', 'request_id')) | _SAMPLING_KEYS

_LATER_SLICE = {'/predict': 'POST /predict comes with a later slice of the '
                            'port, ROADMAP A.7b (this server decodes: use '
                            'POST /generate)',
                '/metrics': 'GET /metrics comes with the observability '
                            'slice of the port, ROADMAP A.11'}


def _status_for(exc):
    for etype, code in _STATUS_BY_ERROR:
        if isinstance(exc, etype):
            return code
    return 500


class _Handler(BaseHTTPRequestHandler):
    protocol_version = 'HTTP/1.1'
    server_version = 'paddle-tpu-torch-serving'

    def log_message(self, fmt, *args):
        _logger.debug('%s %s', self.address_string(), fmt % args)

    def _reply(self, code, body):
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass                      # client went away; nothing to salvage

    def _error(self, code, exc):
        self._reply(code, {'error': type(exc).__name__, 'message': str(exc)})

    def _not_found(self):
        self._reply(404, {'error': 'NotFound',
                          'message': _LATER_SLICE.get(self.path, self.path)})

    def do_GET(self):
        if self.path != '/healthz':
            return self._not_found()
        srv = self.server.serving
        if srv.draining:
            return self._reply(503, {'status': 'draining',
                                     'unix_time': time.time()})
        breaker = srv.generator.breaker.state
        if breaker != 'closed':
            return self._reply(503, {'status': 'degraded',
                                     'breakers': {'decode': breaker},
                                     'unix_time': time.time()})
        eng = srv.generator.engine
        self._reply(200, {
            'status': 'ok', 'replica': srv.replica_id,
            'warmup': srv.warmup_status(), 'unix_time': time.time(),
            'device': str(eng.device),
            'decode': {
                'slots': eng.slots,
                'active': srv.generator.active(),
                'waiting': srv.generator.pending(),
                'cache_blocks_used': eng.pool.allocator.used,
                'cache_blocks_total': eng.pool.allocator.capacity,
                'prompt_buckets': eng.prompt_buckets}})

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
        if self.path != '/generate':
            return self._not_found()
        return self._do_generate()

    def _do_generate(self):
        """POST /generate. Body::

            {"prompt": [token ids], "max_new_tokens": 16,
             "eos_id": optional, "stream": true, "timeout_ms": optional,
             "temperature": 0.0, "top_k": 0, "top_p": 1.0,
             "seed": optional, "request_id": optional}

        A bad value OR an unknown body key is a 400 naming the field.
        Sampled streams replay from ``request_id`` (or ``seed``); greedy
        (temperature 0, the default) is exact argmax.

        ``stream=true`` (default) replies 200 with chunked NDJSON: one
        ``{"token": id, "index": i}`` line per decoded token, then a final
        ``{"done": true, "finish_reason": ..., "tokens": [...],
        "latency_ms": ...}`` line. A failure after streaming began arrives
        as an ``{"error": ..., "message": ...}`` line (the 200 status is
        already on the wire). ``stream=false`` blocks and returns the whole
        generation as one JSON reply."""
        srv = self.server.serving
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
        t0 = time.perf_counter()
        try:
            stream = srv.generator.submit(
                prompt,
                max_new_tokens=payload.get('max_new_tokens', 16),
                eos_id=payload.get('eos_id'),
                timeout_ms=payload.get('timeout_ms'),
                sampling=sampling or None,
                request_id=payload.get('request_id'))
        except _TYPED_ERRORS as e:
            return self._error(_status_for(e), e)
        except Exception as e:     # internal failure: a 500, not a hang
            _logger.exception('generate failed')
            return self._error(500, e)

        if payload.get('stream', True) is False:
            try:
                toks = stream.result(srv.request_timeout)
            except _TYPED_ERRORS as e:
                return self._error(_status_for(e), e)
            except TimeoutError as e:
                return self._error(504, e)
            except Exception as e:
                _logger.exception('generate failed')
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


class ServingServer:
    """Decode scheduler + ThreadingHTTPServer, wired and lifecycle-managed.

    ``engine`` is the stateless predict engine of the JAX package's server;
    it comes with a later slice, so it must be None here and ``generator``
    (a :class:`decode.DecodeScheduler`) is required. ``port=0`` binds an
    ephemeral port; read ``.port`` after construction.
    """

    def __init__(self, engine=None, host='127.0.0.1', port=8080,
                 request_timeout=60.0, warmup=False, generator=None):
        if engine is not None:
            raise NotImplementedError(
                'the stateless /predict engine comes with a later slice of '
                'the port; pass engine=None and a decode generator')
        if generator is None:
            raise ValueError('need a decode generator (DecodeScheduler)')
        self.generator = generator
        if warmup:
            timings = generator.engine.warmup()
            _logger.info('warmed decode engine: %s',
                         {k: round(s, 3) for k, s in timings.items()})
        self.request_timeout = request_timeout
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
    def replica_id(self):
        return self.generator.replica_id

    def warmup_status(self):
        """{'decode': warmed, 'done': warmed}: a router must not route to a
        replica whose ``done`` is false."""
        warmed = self.generator.engine.warmed
        return {'decode': warmed, 'done': warmed}

    def start(self):
        """Serve in a background thread; returns self."""
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name='paddle-tpu-torch-http',
                                        daemon=True)
        self._thread.start()
        _logger.info('serving on %s:%d', self._httpd.server_address[0],
                     self.port)
        return self

    def serve_forever(self):
        """Foreground serve (the CLI path). SIGTERM and SIGINT trigger the
        graceful, timeout-capped drain."""
        _logger.info('serving on %s:%d', self._httpd.server_address[0],
                     self.port)
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
        """On signal, /healthz flips to draining at once and a background
        thread runs the graceful ``shutdown(drain=True)``. Must be called
        from the main thread; returns self."""
        self._old_handlers = {}
        for s in signals:
            self._old_handlers[s] = signal.signal(s, self._on_signal)
        return self

    def uninstall_signal_handlers(self):
        for s, old in self._old_handlers.items():
            try:
                signal.signal(s, old)
            except (ValueError, TypeError):
                pass
        self._old_handlers = {}

    def _on_signal(self, signum, frame):
        _logger.warning('signal %d: draining (healthz now 503)', signum)
        self.draining = True
        threading.Thread(target=self.shutdown, kwargs={'drain': True},
                         name='paddle-tpu-torch-drain', daemon=True).start()

    def shutdown(self, drain=True, timeout=None):
        """Graceful stop: healthz flips to draining, admission closes, queued
        requests run to completion (drain=True), then the listener stops.
        ``timeout`` (default ``PADDLE_TPU_DRAIN_TIMEOUT_S``, 30 s) caps the
        drain; past it the remaining queue fails fast."""
        with self._shutdown_lock:
            if self._shutdown_started:
                return
            self._shutdown_started = True
        self.draining = True
        if timeout is None:
            timeout = float(
                os.environ.get('PADDLE_TPU_DRAIN_TIMEOUT_S', '') or 30.0)
        gen = self.generator
        gen.close(drain=drain, timeout=timeout if drain else None)
        if gen._worker.is_alive():
            _logger.warning('drain timeout (%.1fs) exceeded; failing '
                            'remaining queued work fast', timeout)
            gen.close(drain=False, timeout=5)
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
