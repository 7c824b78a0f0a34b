"""HTTP serving over :class:`~morgana_tpu_torch.serve.InferenceEngine`
(counterpart of ``morgana_tpu/http_serve.py``), on the standard library's
``http.server`` alone::

    python -m morgana_tpu_torch.serve --model \\
        morgana_tpu_torch.models.rnn_spss:LSTMAcousticModel \\
        --checkpoint_path ckpt.npz --data_root data --http_port 8080

Endpoints
---------
``GET /healthz``
    ``{"status": "ok", "model": <class>, "checkpoint": <path>}``, and with
    several voices ``"models"`` and ``"default"``.
``GET /stats``
    Request and error counts, p50/p95 latency of the last 512 ``/predict``
    requests, each engine's model, batch size, quantization and batcher
    limits, and the batchers' coalescing counters.
``POST /predict``
    ``{"items": [{"name": ..., "<source>": <nested lists>, ...}]}``, one
    entry per test data source; answers ``{"results": {name: {key: nested
    lists}}}``, frame-level outputs unpadded. Through a
    :class:`~morgana_tpu_torch.serve.DynamicBatcher` when
    ``dynamic_batch_ms > 0``: 503 with ``Retry-After: 1`` when its queue is
    full.
``POST /stream``
    ``{"item": {...}, "chunk_frames": 64, "context": 32, "lookahead": 16}``
    for one utterance, a configuration of the engine's ``stream_configs``;
    answers NDJSON in chunked transfer encoding, one ``{"chunk": ...}``
    line as each is computed, then ``{"done": true, "frames": N}``. With
    ``"audio": true`` each line also carries ``wav_int16_b64``, the samples
    that chunk finalises as ``clip(wav * gain * 32767)`` int16 in base64.
    HTTP/1.1 only (505 otherwise); the connection closes after the stream.

Codes: 400 for a malformed body, duplicate names or a missing feature; 404
for an unknown path or voice; 500 for a server fault or non-finite outputs.
One lock serialises the device work of every handler, batcher and voice: the
whole of a ``/predict`` engine call, and one model chunk of a ``/stream``.
A checkpoint reload takes no device lock: it builds the new version beside
the one served and swaps the engine's reference, and every call and stream
keeps the version it started with (``serve.InferenceEngine.reload_checkpoint``).
Converting and encoding a large JSON body holds the interpreter lock for
tens of milliseconds at a time, and under a few concurrent clients the
threads that did so took turns with it almost without a break: a health
check or a reload that waited for it after each of its steps took
seconds. So the handlers' large conversions take turns on a
:class:`_HostGate` instead, and a reload, once the watcher has found a
newer checkpoint, goes next: new work waits for the build (a fraction of a
second) while the device keeps serving.
"""
import base64
import contextlib
import json
import logging
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from morgana_tpu_torch.serve import DynamicBatcher, Overloaded

__all__ = ['make_server', 'serve_forever']

log = logging.getLogger('morgana_tpu_torch')


class _Stats(object):
    """Counts and the latency of the last ``window`` completed ``/predict``
    requests, for ``GET /stats``."""

    def __init__(self, window=512):
        self._lock = threading.Lock()
        self._latency = deque(maxlen=window)
        self.requests = 0
        self.errors = 0

    def record(self, seconds, ok):
        with self._lock:
            self.requests += 1
            if ok:
                self._latency.append(seconds * 1e3)
            else:
                self.errors += 1

    def snapshot(self):
        with self._lock:
            lat = np.asarray(self._latency)
            out = {'requests': self.requests, 'errors': self.errors}
        if lat.size:
            out['latency_ms'] = {'p50': round(float(np.percentile(lat, 50)), 2),
                                 'p95': round(float(np.percentile(lat, 95)), 2),
                                 'n': int(lat.size)}
        return out


class _HostGate(object):
    """Lets the handlers' large JSON and array conversions run one at a
    time, and a checkpoint reload in ahead of the handlers waiting. Under
    the interpreter lock they could not run side by side anyway; queued
    here instead of on the lock, they leave it to the other threads (a
    health check, the checkpoint watcher) between sections. Sections are
    never nested."""

    def __init__(self):
        self._cv = threading.Condition()
        self._busy = False
        self._reloads = 0   # reloads waiting

    @contextlib.contextmanager
    def _hold(self, reload):
        with self._cv:
            self._reloads += reload
            while self._busy or (self._reloads and not reload):
                self._cv.wait()
            self._reloads -= reload
            self._busy = True
        try:
            yield
        finally:
            with self._cv:
                self._busy = False
                self._cv.notify_all()

    def work(self):
        """A handler's section."""
        return self._hold(False)

    def reload(self):
        """A reload's section, next after the one in flight."""
        return self._hold(True)


def _to_arrays(item):
    """A JSON item as a feature dict: integer lists stay integral, floats
    become float32."""
    out = {}
    for key, value in item.items():
        if key == 'name':
            out[key] = str(value)
            continue
        arr = np.asarray(value)
        if arr.dtype.kind == 'f':
            arr = arr.astype(np.float32)
        out[key] = arr
    return out


_ENCODE_ROWS = 64   # rows of a frame-level output encoded by one json.dumps call


def _encode(obj):
    """``json.dumps(obj, allow_nan=False)``, byte for byte, made a dict
    entry and a block of ``_ENCODE_ROWS`` list rows at a time: one call over
    a whole reply holds the interpreter lock for ~0.1 s, and every other
    thread of the server (a ``/healthz``, the checkpoint watcher) waits that
    long behind it; a block of 64 rows of 180 floats, a few milliseconds."""
    if isinstance(obj, dict) and all(isinstance(k, str) for k in obj):
        return '{' + ', '.join(f'{json.dumps(k)}: {_encode(v)}' for k, v in obj.items()) + '}'
    if isinstance(obj, list) and len(obj) > _ENCODE_ROWS:
        return '[' + ', '.join(json.dumps(obj[i:i + _ENCODE_ROWS], allow_nan=False)[1:-1]
                               for i in range(0, len(obj), _ENCODE_ROWS)) + ']'
    return json.dumps(obj, allow_nan=False)


def _to_lists(outputs):
    return {key: np.asarray(value).tolist() for key, value in outputs.items()}


def make_server(engine, host='127.0.0.1', port=0, dynamic_batch_ms=0.0, watch_checkpoints=0.0):
    """A ``ThreadingHTTPServer`` over ``engine``, one
    :class:`~morgana_tpu_torch.serve.InferenceEngine` or a ``{name: engine}``
    fleet whose first entry is the default voice; a request picks another
    with a top-level ``"model"`` key. Call ``.serve_forever()`` (or
    :func:`serve_forever`); ``port=0`` binds a free port
    (``server.server_address[1]``).

    ``dynamic_batch_ms > 0`` gives each voice a
    :class:`~morgana_tpu_torch.serve.DynamicBatcher` (``server.batchers``;
    the default voice's is ``server.batcher``). ``watch_checkpoints > 0``
    polls every that many seconds for a higher-epoch checkpoint beside each
    voice's (:meth:`~morgana_tpu_torch.serve.InferenceEngine.newer_checkpoint`);
    the new version is built while the old one serves, without the device
    lock, which the JAX package's reload needs because it writes the
    module's parameters in place, but ahead of the handlers' waiting host
    work (:class:`_HostGate`). A failure is logged and tried again at the
    next poll. ``server.server_close()`` stops the watcher and the
    batchers."""
    engines = dict(engine) if isinstance(engine, dict) else {'default': engine}
    if not engines:
        raise ValueError('make_server needs at least one engine')
    default_name = next(iter(engines))

    lock = threading.Lock()   # one device: one engine call or model chunk at a time
    gate = _HostGate()        # the handlers' JSON work against a reload
    stats = _Stats()
    batchers = {}
    if dynamic_batch_ms and float(dynamic_batch_ms) > 0:
        batchers = {name: DynamicBatcher(eng, max_wait_ms=float(dynamic_batch_ms), lock=lock)
                    for name, eng in engines.items()}

    def resolve(request):
        """(engine, batcher, error payload) of a request body's "model"."""
        name = request.get('model', default_name)
        if name not in engines:
            return None, None, {'error': f'unknown model {name!r}; serving: {sorted(engines)}'}
        return engines[name], batchers.get(name), None

    def engine_info(name, eng):
        info = {'model': type(eng.model).__name__, 'batch_size': eng.batch_size,
                'quantized': eng.quantized, 'data_parallel': False}
        b = batchers.get(name)
        if b is not None:
            info['dynamic_batching'] = {'max_wait_ms': b.max_wait * 1e3,
                                        'max_batch': b.max_batch, 'max_queue': b.max_queue}
        return info

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 for /stream's chunked encoding; every other reply carries
        # an exact Content-Length.
        protocol_version = 'HTTP/1.1'

        def _reply(self, code, payload, headers=None, large=False):
            try:
                # Python's default writes NaN and Infinity, which are not JSON.
                with gate.work() if large else contextlib.nullcontext():
                    body = _encode(payload).encode()
            except ValueError:
                code = 500
                body = json.dumps({'error': 'model output contains non-finite values'}).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self):
            body = self.rfile.read(int(self.headers.get('Content-Length', 0)))
            with gate.work():
                return json.loads(body)

        def do_GET(self):
            if self.path == '/healthz':
                default = engines[default_name]
                payload = {'status': 'ok', 'model': type(default.model).__name__,
                           'checkpoint': default.checkpoint_path}
                if len(engines) > 1:
                    payload['models'] = {name: {'model': type(eng.model).__name__,
                                                'checkpoint': eng.checkpoint_path}
                                         for name, eng in engines.items()}
                    payload['default'] = default_name
                self._reply(200, payload)
            elif self.path == '/stats':
                payload = stats.snapshot()
                payload['engine'] = engine_info(default_name, engines[default_name])
                if len(engines) > 1:
                    payload['engines'] = {name: engine_info(name, eng)
                                          for name, eng in engines.items()}
                if batchers:
                    payload['dynamic_batching'] = {
                        'dispatch_groups': sum(b.batches_run for b in batchers.values()),
                        'requests_coalesced': sum(b.requests_coalesced
                                                  for b in batchers.values())}
                self._reply(200, payload)
            else:
                self._reply(404, {'error': f'unknown path {self.path}'})

        def _write_chunk(self, line):
            data = line.encode()
            self.wfile.write(f'{len(data):x}\r\n'.encode() + data + b'\r\n')
            self.wfile.flush()

        def _do_stream(self):
            if self.request_version == 'HTTP/1.0':
                # An HTTP/1.0 client would read the chunk sizes as body bytes.
                self._reply(505, {'error': '/stream requires HTTP/1.1 (chunked transfer '
                                           'encoding)'})
                return
            try:
                request = self._read_json()
                engine, _, err = resolve(request)
                if err is not None:
                    self._reply(404, err)
                    return
                with gate.work():
                    item = _to_arrays(request['item'])
                kwargs = {k: int(request[k]) for k in ('chunk_frames', 'context', 'lookahead')
                          if k in request}
                config = (kwargs.get('chunk_frames', 64), kwargs.get('context', 32),
                          kwargs.get('lookahead', 16))
                if config not in engine.stream_configs:
                    self._reply(400, {'error': f'stream config {config} not served; allowed: '
                                               f'{sorted(engine.stream_configs)}'})
                    return
                audio = bool(request.get('audio', False))
                gain = 1.0
                if audio:
                    kwargs['sample_rate'] = int(request.get('sample_rate', 16000))
                    # No global clip protection in a stream: the client sets
                    # the headroom.
                    gain = float(request.get('gain', 1.0))
            except Exception as exc:   # noqa: BLE001 - malformed request
                self._reply(400, {'error': f'{type(exc).__name__}: {exc}'})
                return
            try:
                # Made before the headers: a missing feature or a model that
                # cannot stream is a clean 4xx. The audio stream holds the
                # lock around each model chunk itself, the vocoder outside.
                if audio:
                    stream = iter(engine.stream_item_audio(item, device_lock=lock, **kwargs))
                else:
                    stream = iter(engine.stream_item(item, **kwargs))
            except KeyError as exc:
                self._reply(400, {'error': f'missing feature {exc}'})
                return
            except (ValueError, NotImplementedError, TypeError) as exc:
                self._reply(400, {'error': f'{type(exc).__name__}: {exc}'})
                return
            except Exception as exc:   # noqa: BLE001 - server fault
                self._reply(500, {'error': f'{type(exc).__name__}: {exc}'})
                return
            self.send_response(200)
            self.send_header('Content-Type', 'application/x-ndjson')
            self.send_header('Transfer-Encoding', 'chunked')
            self.end_headers()
            frames = samples = 0
            try:
                # The lock covers a chunk's computation, never the socket
                # write: a slow reader must not hold the device.
                while True:
                    try:
                        if audio:
                            emitted = next(stream)
                        else:
                            with lock:
                                emitted = next(stream)
                    except StopIteration:
                        break
                    if audio:
                        chunk, wav = emitted
                        line = {'chunk': _to_lists(chunk)} if chunk else {}
                        pcm = np.clip(np.asarray(wav) * gain * 32767.0, -32768,
                                      32767).astype('<i2')
                        line['wav_int16_b64'] = base64.b64encode(pcm.tobytes()).decode('ascii')
                        samples += pcm.shape[0]
                    else:
                        chunk = emitted
                        line = {'chunk': _to_lists(chunk)}
                    if chunk:
                        frames += next(iter(chunk.values())).shape[0]
                    self._write_chunk(json.dumps(line, allow_nan=False) + '\n')
                done = {'done': True, 'frames': frames}
                if audio:
                    done.update(samples=samples, sample_rate=kwargs['sample_rate'])
                self._write_chunk(json.dumps(done) + '\n')
                self.wfile.write(b'0\r\n\r\n')
            except Exception as exc:   # noqa: BLE001 - mid-stream fault
                # The headers are gone: the error is the last line. An
                # OSError here means the client has gone.
                try:
                    self._write_chunk(json.dumps({'error': f'{type(exc).__name__}: {exc}'})
                                      + '\n')
                    self.wfile.write(b'0\r\n\r\n')
                except OSError:
                    pass
            self.close_connection = True

        def do_POST(self):
            if self.path == '/stream':
                self._do_stream()
                return
            if self.path != '/predict':
                self._reply(404, {'error': f'unknown path {self.path}'})
                return
            try:
                request = self._read_json()
                engine, engine_batcher, err = resolve(request)
                if err is not None:
                    self._reply(404, err)
                    return
                with gate.work():
                    items = [_to_arrays(item) for item in request['items']]
                names = [item.get('name', str(i)) for i, item in enumerate(items)]
                if len(set(names)) != len(names):
                    self._reply(400, {'error': 'duplicate item names'})
                    return
            except Exception as exc:   # noqa: BLE001 - malformed request
                self._reply(400, {'error': f'{type(exc).__name__}: {exc}'})
                return
            start = time.perf_counter()
            try:
                if engine_batcher is not None:
                    results = engine_batcher.predict_items(items)
                else:
                    with lock:
                        results = engine.predict_items(items)
                with gate.work():
                    payload = {'results': {name: _to_lists(outputs)
                                           for name, outputs in results.items()}}
                stats.record(time.perf_counter() - start, ok=True)
            except Overloaded as exc:
                stats.record(time.perf_counter() - start, ok=False)
                self._reply(503, {'error': str(exc)}, headers={'Retry-After': '1'})
                return
            except KeyError as exc:
                stats.record(time.perf_counter() - start, ok=False)
                self._reply(400, {'error': f'missing feature {exc}'})
                return
            except Exception as exc:   # noqa: BLE001 - server fault
                stats.record(time.perf_counter() - start, ok=False)
                self._reply(500, {'error': f'{type(exc).__name__}: {exc}'})
                return
            # Outside the compute try: an OSError here is the client gone
            # after a good prediction, not a server error.
            try:
                self._reply(200, payload, large=True)
            except OSError:
                self.close_connection = True

        def log_message(self, fmt, *args):
            pass

    watcher_stop = threading.Event()

    class Server(ThreadingHTTPServer):
        def server_close(self):
            watcher_stop.set()
            for b in batchers.values():
                b.close()
            super().server_close()

    server = Server((host, port), Handler)
    server.batcher = batchers.get(default_name)
    server.batchers = batchers
    server.engines = engines

    if watch_checkpoints and float(watch_checkpoints) > 0:
        interval = float(watch_checkpoints)

        def watch():
            while not watcher_stop.wait(interval):
                for name, eng in engines.items():
                    try:
                        newer = eng.newer_checkpoint()
                        if newer:
                            with gate.reload():
                                eng.reload_checkpoint(newer)
                            log.info('hot-reloaded %s -> %s', name, newer)
                    except Exception as exc:   # noqa: BLE001 - tried again at the next poll
                        log.warning('checkpoint watch for %s failed (%s: %s); retrying next '
                                    'poll', name, type(exc).__name__, exc)

        threading.Thread(target=watch, daemon=True, name='morgana-checkpoint-watcher').start()
    return server


def serve_forever(engine, host='127.0.0.1', port=8080, dynamic_batch_ms=0.0,
                  watch_checkpoints=0.0):
    """:func:`make_server`, then serves until interrupted and closes."""
    server = make_server(engine, host, port, dynamic_batch_ms=dynamic_batch_ms,
                         watch_checkpoints=watch_checkpoints)
    mode = f', dynamic batching {dynamic_batch_ms:g} ms' if server.batcher is not None else ''
    if len(server.engines) > 1:
        models = ' + '.join(f'{name}={type(eng.model).__name__}'
                            for name, eng in server.engines.items())
    else:
        models = type(next(iter(server.engines.values())).model).__name__
    print(f'serving {models} on http://{host}:{server.server_address[1]} '
          f'(GET /healthz, GET /stats, POST /predict, POST /stream{mode})', flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
