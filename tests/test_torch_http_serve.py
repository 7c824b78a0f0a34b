"""The port's network serving against the JAX package on the CPU: the
``DynamicBatcher``, the HTTP server (one voice and a fleet; ``/healthz``,
``/stats``, ``/predict``, ``/stream``), checkpoint hot reload (the reload,
the watcher and a stream that keeps its version) and ``serve.main``'s
serving flags.

Both packages' engines load the same seeded JAX checkpoints (2 x LSTM(32)
``LSTMAcousticModel``; ``F0Model`` for the fleet) and serve the
``voice_data`` corpus's test and validation utterances; both servers run in
this process on free ``127.0.0.1`` ports, and each is closed in
``finally``. Tolerances and why:

* port results against JAX's, through the batcher or HTTP: JAX's own rtol
  ``RTOL`` = 2e-4, atol ``ATOL`` = 2e-5 (``tests/test_serve.py:431-435``:
  batched against one at a time; f32 sums in another order);
* ``/stream`` NDJSON against JAX's: the same chunks and frames; network
  outputs within ``NET_ATOL`` = 1e-5, smoothed trajectories within
  ``TRAJ_ATOL`` = 5e-5 (``tests/test_torch_streaming.py``); audio samples
  within ``PCM_LSB`` = 2 of JAX's (the waves agree to ~1e-5 and a sample
  may round the other way), and equal to the port's own
  ``stream_item_audio`` encoded;
* a version against itself (hot reload, a pinned stream): equal.
"""
import base64
import json
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from morgana_tpu import http_serve as jhttp
from morgana_tpu import nn as jnn
from morgana_tpu import serve as jserve
from morgana_tpu.serve import InferenceEngine as JEngine

from morgana_tpu_torch import http_serve as thttp
from morgana_tpu_torch import serve as tserve
from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.device import DeviceError
from morgana_tpu_torch.models import f0_test_model as tf0
from morgana_tpu_torch.models import rnn_spss as trnn
from morgana_tpu_torch.serve import DynamicBatcher, InferenceEngine as TEngine, Overloaded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'models'))
try:
    from f0_test_model import F0Model as JF0
    from rnn_spss import LSTMAcousticModel as JLSTM
finally:
    sys.path.pop(0)

RTOL = 2e-4
ATOL = 2e-5
NET_ATOL = 1e-5
TRAJ_ATOL = 5e-5
PCM_LSB = 2
AC_KWARGS = {'num_layers': 2, 'hidden_size': 32}
LSTM_SPEC = 'morgana_tpu_torch.models.rnn_spss:LSTMAcousticModel'
DEADLINE = 20.0


def _ids(root, split):
    return file_io.get_file_ids(os.path.join(root, split, f'{split}_file_id_list.scp'))


def _item(engine, root, utt, split='test'):
    data_dir = os.path.join(root, split)
    return dict({name: src.load_file(utt, data_dir)
                 for name, src in engine.model.test_data_sources().items()}, name=utt)


def _json_item(item):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in item.items()}


def _hold(got, want, label=''):
    """Every output of ``want`` in ``got`` within RTOL / ATOL."""
    assert sorted(got) == sorted(want), label
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], np.float32),
                                   np.asarray(want[key], np.float32), rtol=RTOL, atol=ATOL,
                                   err_msg=f'{label} {key}')


def _perturbed(src, dst, delta=0.1):
    with np.load(src) as data:
        np.savez(dst, **{k: data[k] + delta for k in data.files})
    return dst


def _copy(src, dst):
    return _perturbed(src, dst, 0.0)


# ------------------------------------------------------------- HTTP helpers

class Running(object):
    """A server of either package serving on a thread; ``close`` shuts it."""

    def __init__(self, make_server, engine, **kwargs):
        self.server = make_server(engine, port=0, **kwargs)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=DEADLINE)
        assert not self.thread.is_alive()


def _request(port, path, payload=None, raw=None):
    """(status, JSON body, headers) of a GET (no payload) or a POST."""
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}', data=data,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _stream(port, payload):
    """The NDJSON lines of a POST /stream, decoded."""
    req = urllib.request.Request(f'http://127.0.0.1:{port}/stream',
                                 data=json.dumps(payload).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200 and r.headers['Content-Type'] == 'application/x-ndjson'
        assert r.headers['Transfer-Encoding'] == 'chunked'
        return [json.loads(line) for line in r.read().decode().splitlines() if line]


def _http10_stream(port, payload):
    """The status code of a POST /stream sent as HTTP/1.0."""
    body = json.dumps(payload).encode()
    with socket.create_connection(('127.0.0.1', port), timeout=DEADLINE) as s:
        s.sendall(b'POST /stream HTTP/1.0\r\nContent-Type: application/json\r\n'
                  + f'Content-Length: {len(body)}\r\n\r\n'.encode() + body)
        head = s.recv(64).decode()
    return int(head.split()[1])


def _pcm(lines):
    return np.concatenate([np.frombuffer(base64.b64decode(line['wav_int16_b64']), '<i2')
                           for line in lines if 'wav_int16_b64' in line])


# ----------------------------------------------------------------- fixture

@pytest.fixture(scope='module')
def served(voice_data, tmp_path_factory):
    """Both packages' engines on seeded checkpoints, and the test and
    validation utterances as items."""
    root = voice_data['data_root']
    base = tmp_path_factory.mktemp('http')
    os.makedirs(base / 'lstm')
    jnn.manual_seed(81)
    ckpt = JLSTM(**AC_KWARGS).save_parameters(str(base / 'lstm'), 1)
    jnn.manual_seed(82)
    f0_ckpt = JF0().save_parameters(str(base / 'f0'), 1)
    common = dict(data_root=root, device='cpu', batch_size=8)
    port = TEngine(trnn.LSTMAcousticModel, ckpt, model_kwargs=AC_KWARGS, **common)
    jax_engine = JEngine(JLSTM, ckpt, model_kwargs=AC_KWARGS, **common)
    items = [_item(port, root, utt, split) for split in ('test', 'valid')
             for utt in _ids(root, split)]
    return {'root': root, 'base': base, 'ckpt': ckpt, 'f0_ckpt': f0_ckpt, 'port': port,
            'jax': jax_engine, 'items': items, 'common': common,
            'jax_all': jax_engine.predict_items(items)}


def _port_engine(served, ckpt=None, **kwargs):
    return TEngine(trnn.LSTMAcousticModel, ckpt or served['ckpt'], model_kwargs=AC_KWARGS,
                   **dict(served['common'], **kwargs))


# ---------------------------------------------------------- DynamicBatcher

def test_batcher_coalesces_and_matches_jax(served):
    """Six concurrent one-item requests, two of them with the same name:
    fewer engine calls than requests, and each caller's results JAX's."""
    items = [dict(item) for item in served['items']]
    want = [served['jax_all'][item['name']] for item in items]
    items[5]['name'] = items[0]['name']
    batcher = DynamicBatcher(served['port'], max_wait_ms=200.0)
    got = [None] * len(items)

    def client(i):
        got[i] = batcher.predict_items([items[i]])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(items))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DEADLINE)
            assert not t.is_alive()
    finally:
        batcher.close()
    assert batcher.batches_run < len(items) and batcher.requests_coalesced == len(items)
    for i, item in enumerate(items):
        assert list(got[i]) == [item['name']]
        _hold(got[i][item['name']], want[i], f'request {i}')


def test_batcher_isolates_faults_and_refuses_duplicates(served):
    batcher = DynamicBatcher(served['port'], max_wait_ms=200.0, max_batch=4)
    good = served['items'][1]
    outcome = {}

    def run(tag, items):
        try:
            outcome[tag] = batcher.predict_items(items)
        except Exception as exc:   # noqa: BLE001 - asserted below
            outcome[tag] = exc

    threads = [threading.Thread(target=run, args=('good', [good])),
               threading.Thread(target=run, args=('bad', [{'name': 'bad', 'lab': good['lab']}]))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DEADLINE)
            assert not t.is_alive()
        assert isinstance(outcome['bad'], KeyError)
        _hold(outcome['good'][good['name']], served['jax_all'][good['name']])
        with pytest.raises(ValueError, match='duplicate'):
            batcher.predict_items([good, dict(good)])
    finally:
        batcher.close()
    with pytest.raises(RuntimeError, match='closed'):
        batcher.predict_items([good])


def test_batcher_lone_request_never_waits(served):
    batcher = DynamicBatcher(served['port'], max_wait_ms=10_000.0)
    try:
        start = time.perf_counter()
        out = batcher.predict_items([served['items'][0]])
        assert time.perf_counter() - start < 5.0
        assert list(out) == [served['items'][0]['name']] and batcher.batches_run == 1
    finally:
        batcher.close()


def test_batcher_backpressure_raises_overloaded(served):
    """JAX's staged test: the worker blocks on the held device lock with one
    request, max_queue utterances queue behind it, and the next request is
    refused."""

    class SignallingGate(object):
        def __init__(self):
            self.inner = threading.Lock()
            self.attempted = threading.Event()

        def __enter__(self):
            self.attempted.set()
            self.inner.acquire()

        def __exit__(self, *exc):
            self.inner.release()

    gate = SignallingGate()
    gate.inner.acquire()
    batcher = DynamicBatcher(served['port'], max_wait_ms=0.0, max_batch=2, max_queue=2, lock=gate)
    item = served['items'][0]
    results = [None] * 3
    threads = []
    try:
        def enqueue(i):
            results[i] = batcher.predict_items([dict(item, name=f'q{i}')])

        threads.append(threading.Thread(target=enqueue, args=(0,), daemon=True))
        threads[0].start()
        assert gate.attempted.wait(timeout=DEADLINE)
        for i in (1, 2):
            threads.append(threading.Thread(target=enqueue, args=(i,), daemon=True))
            threads[-1].start()
        deadline = time.monotonic() + DEADLINE
        pending = 0
        while time.monotonic() < deadline and pending < batcher.max_queue:
            with batcher._cv:
                pending = sum(len(r['items']) for r in batcher._pending)
            time.sleep(0.005)
        assert pending == batcher.max_queue
        with pytest.raises(Overloaded, match='pending'):
            batcher.predict_items([dict(item, name='refused')])
    finally:
        gate.inner.release()
        for t in threads:
            t.join(timeout=DEADLINE)
        batcher.close()
    assert [sorted(r) for r in results] == [['q0'], ['q1'], ['q2']]


@pytest.mark.parametrize('cap', [1, 8, 16])
def test_padded_count_matches_jax(cap):
    for n in range(1, 41):
        assert DynamicBatcher._padded_count(n, cap) == jserve.DynamicBatcher._padded_count(n, cap)


# -------------------------------------------------------- HTTP, one voice

def test_healthz_and_unknown_paths_match_jax(served):
    servers = {tag: Running(mod.make_server, served[tag])
               for tag, mod in (('jax', jhttp), ('port', thttp))}
    try:
        got = {tag: [_request(s.port, '/healthz')[:2], _request(s.port, '/nope')[:2],
                     _request(s.port, '/nope', {'items': []})[:2]]
               for tag, s in servers.items()}
        assert got['port'] == got['jax']
        assert got['port'][0] == (200, {'status': 'ok', 'model': 'LSTMAcousticModel',
                                        'checkpoint': served['ckpt']})
        assert [code for code, _ in got['port'][1:]] == [404, 404]
    finally:
        for s in servers.values():
            s.close()


def test_predict_round_trip_and_refusals_match_jax(served):
    """The same bodies to both servers: the results within tolerance, and the
    same codes for a malformed body, duplicate names and a missing
    feature."""
    servers = {tag: Running(mod.make_server, served[tag])
               for tag, mod in (('jax', jhttp), ('port', thttp))}
    item = _json_item(served['items'][0])
    missing = {k: v for k, v in item.items() if k != 'counters'}
    try:
        replies = {tag: [_request(s.port, '/predict', {'items': [item]}),
                         _request(s.port, '/predict', raw=b'{"items": [{}]'),
                         _request(s.port, '/predict', {'items': [item, item]}),
                         _request(s.port, '/predict', {'items': [missing]})]
                   for tag, s in servers.items()}
    finally:
        for s in servers.values():
            s.close()
    port, jax_replies = replies['port'], replies['jax']
    assert [r[0] for r in port] == [r[0] for r in jax_replies] == [200, 400, 400, 400]
    _hold(port[0][1]['results'][item['name']], jax_replies[0][1]['results'][item['name']])
    assert 'duplicate' in port[2][1]['error']
    assert port[3][1] == jax_replies[3][1] == {'error': "missing feature 'counters'"}


def test_concurrent_requests_get_their_own_results(served):
    server = Running(thttp.make_server, served['port'])
    results, errors = {}, []

    def client(i):
        item = _json_item(served['items'][i])
        try:
            code, body, _ = _request(server.port, '/predict', {'items': [item]})
            results[i] = (code, body['results'][item['name']])
        except Exception as exc:   # noqa: BLE001 - asserted below
            errors.append((i, exc))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(served['items']))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DEADLINE)
            assert not t.is_alive()
    finally:
        server.close()
    assert not errors, errors
    for i, item in enumerate(served['items']):
        assert results[i][0] == 200
        _hold(results[i][1], served['jax_all'][item['name']], item['name'])


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    return type(obj).__name__


def test_stats_match_jax_and_overload_is_503(served):
    servers = {tag: Running(mod.make_server, served[tag], dynamic_batch_ms=1.0)
               for tag, mod in (('jax', jhttp), ('port', thttp))}
    body = {'items': [_json_item(served['items'][0])]}
    try:
        stats = {}
        for tag, s in servers.items():
            assert _request(s.port, '/predict', body)[0] == 200
            stats[tag] = _request(s.port, '/stats')[1]
        assert _key_tree(stats['port']) == _key_tree(stats['jax'])
        for key in ('requests', 'errors', 'engine', 'dynamic_batching'):
            assert stats['port'][key] == stats['jax'][key], key
        assert stats['port']['engine'] == {
            'model': 'LSTMAcousticModel', 'batch_size': 8, 'quantized': False,
            'data_parallel': False,
            'dynamic_batching': {'max_wait_ms': 1.0, 'max_batch': 8, 'max_queue': 256}}
        assert stats['port']['latency_ms']['n'] == 1

        port = servers['port']

        def overloaded(items):
            raise Overloaded('99 utterances already pending')

        port.server.batcher.predict_items = overloaded
        code, reply, headers = _request(port.port, '/predict', body)
        assert code == 503 and headers['Retry-After'] == '1' and 'pending' in reply['error']
        after = _request(port.port, '/stats')[1]
        assert (after['requests'], after['errors']) == (2, 1)
    finally:
        for s in servers.values():
            s.close()


def test_predict_through_the_batcher_coalesces(served):
    server = Running(thttp.make_server, served['port'], dynamic_batch_ms=150.0)
    results, errors = {}, []

    def client(i):
        item = _json_item(served['items'][i])
        try:
            results[i] = _request(server.port, '/predict', {'items': [item]})[1]['results']
        except Exception as exc:   # noqa: BLE001 - asserted below
            errors.append((i, exc))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DEADLINE)
            assert not t.is_alive()
        assert not errors, errors
        assert server.server.batcher.requests_coalesced == 5
        assert server.server.batcher.batches_run < 5
    finally:
        server.close()
    for i in range(5):
        name = served['items'][i]['name']
        _hold(results[i][name], served['jax_all'][name], name)


def test_non_finite_outputs_are_a_server_error(served, monkeypatch):
    server = Running(thttp.make_server, served['port'])
    item = served['items'][0]
    monkeypatch.setattr(served['port'], 'predict_items',
                        lambda items: {item['name']: {'lf0': np.array([np.nan])}})
    try:
        code, reply, _ = _request(server.port, '/predict', {'items': [_json_item(item)]})
    finally:
        server.close()
    assert code == 500 and 'non-finite' in reply['error']


# ----------------------------------------------------------------- /stream

def _longest(served):
    return max(served['items'], key=lambda it: int(np.asarray(it['n_frames']).ravel()[0]))


@pytest.mark.parametrize('audio', [False, True], ids=['features', 'audio'])
def test_stream_ndjson_matches_jax(served, audio):
    """The same chunks and frames as JAX's /stream; features within the
    stream tolerances; audio within PCM_LSB of JAX's and equal to the port's
    stream_item_audio encoded; the done line JAX's."""
    item = _longest(served)
    payload = {'item': _json_item(item), 'audio': audio, 'gain': 0.5}
    servers = {tag: Running(mod.make_server, served[tag])
               for tag, mod in (('jax', jhttp), ('port', thttp))}
    try:
        lines = {tag: _stream(s.port, payload) for tag, s in servers.items()}
    finally:
        for s in servers.values():
            s.close()
    got, want = lines['port'], lines['jax']
    assert got[-1] == want[-1] and got[-1]['done'] and len(got) == len(want) > 3
    for a, b in zip(got[:-1], want[:-1]):
        assert sorted(a) == sorted(b)
        assert sorted(a.get('chunk', {})) == sorted(b.get('chunk', {}))
        for key, value in a.get('chunk', {}).items():
            atol = NET_ATOL if key.startswith('normalised') or key == 'vuv' else TRAJ_ATOL
            np.testing.assert_allclose(np.asarray(value), np.asarray(b['chunk'][key]),
                                       atol=atol, rtol=0, err_msg=key)
    if audio:
        pcm = _pcm(got)
        assert pcm.shape == (got[-1]['samples'],)
        assert np.abs(pcm.astype(np.int32) - _pcm(want)).max() <= PCM_LSB
        wav = np.concatenate([w for _, w in served['port'].stream_item_audio(dict(item))])
        np.testing.assert_array_equal(
            pcm, np.clip(wav * 0.5 * 32767.0, -32768, 32767).astype('<i2'))


STREAM_REFUSALS = {
    'http10': 505,
    'config-not-served': 400,
    'malformed': 400,
    'missing-feature': 400,
    'unknown-voice': 404,
}


@pytest.mark.parametrize('case', list(STREAM_REFUSALS))
def test_stream_refusals_match_jax(served, case):
    item = _json_item(served['items'][0])
    payload = {'item': item}
    if case == 'config-not-served':
        payload['chunk_frames'] = 16
    elif case == 'malformed':
        payload = {'items': [item]}
    elif case == 'missing-feature':
        payload = {'item': {k: v for k, v in item.items() if k != 'lab'}}
    elif case == 'unknown-voice':
        payload['model'] = 'nope'
    servers = {tag: Running(mod.make_server, served[tag])
               for tag, mod in (('jax', jhttp), ('port', thttp))}
    try:
        if case == 'http10':
            codes = {tag: _http10_stream(s.port, payload) for tag, s in servers.items()}
        else:
            replies = {tag: _request(s.port, '/stream', payload)[:2]
                       for tag, s in servers.items()}
            codes = {tag: code for tag, (code, _) in replies.items()}
            assert replies['port'][1].keys() == replies['jax'][1].keys() == {'error'}
    finally:
        for s in servers.values():
            s.close()
    assert codes['port'] == codes['jax'] == STREAM_REFUSALS[case]


# ------------------------------------------------------------------- fleet

@pytest.fixture(scope='module')
def fleets(served):
    """{lstm, f0, q8} voices of each package: the LSTM voice, F0Model and the
    LSTM voice in int8."""
    common = dict(served['common'], batch_size=4)
    port = {'lstm': _port_engine(served, batch_size=4),
            'f0': TEngine(tf0.F0Model, served['f0_ckpt'], **common),
            'q8': _port_engine(served, batch_size=4, quantize='int8')}
    jax_fleet = {'lstm': JEngine(JLSTM, served['ckpt'], model_kwargs=AC_KWARGS, **common),
                 'f0': JEngine(JF0, served['f0_ckpt'], **common),
                 'q8': JEngine(JLSTM, served['ckpt'], model_kwargs=AC_KWARGS, quantize='int8',
                               **common)}
    return {'port': port, 'jax': jax_fleet}


def test_fleet_routes_each_voice_as_jax(served, fleets):
    servers = {tag: Running(mod.make_server, fleets[tag], dynamic_batch_ms=1.0)
               for tag, mod in (('jax', jhttp), ('port', thttp))}
    utt = _ids(served['root'], 'test')[1]
    item = _json_item(_item(served['port'], served['root'], utt))
    items = {None: item, 'q8': item, 'nope': item,
             'f0': _json_item(_item(fleets['port']['f0'], served['root'], utt))}
    try:
        health = {tag: _request(s.port, '/healthz')[1] for tag, s in servers.items()}
        assert health['port'] == health['jax']
        assert set(health['port']['models']) == {'lstm', 'f0', 'q8'}
        assert health['port']['default'] == 'lstm'
        replies = {tag: {voice: _request(s.port, '/predict', dict(
            {'items': [items[voice]]}, **({'model': voice} if voice else {})))
            for voice in items} for tag, s in servers.items()}
        stats = {tag: _request(s.port, '/stats')[1] for tag, s in servers.items()}
    finally:
        for s in servers.values():
            s.close()
    port, jax_replies = replies['port'], replies['jax']
    for voice in (None, 'f0', 'q8'):
        assert port[voice][0] == jax_replies[voice][0] == 200
        _hold(port[voice][1]['results'][item['name']],
              jax_replies[voice][1]['results'][item['name']], voice)
    assert not np.array_equal(port[None][1]['results'][item['name']]['vuv'],
                              port['q8'][1]['results'][item['name']]['vuv'])
    assert port['nope'][:2] == jax_replies['nope'][:2]
    assert port['nope'][0] == 404 and 'lstm' in port['nope'][1]['error']
    assert stats['port']['engines'] == stats['jax']['engines']
    assert stats['port']['engines']['q8']['quantized'] is True
    assert stats['port']['dynamic_batching'] == stats['jax']['dynamic_batching'] == {
        'dispatch_groups': 3, 'requests_coalesced': 3}


def test_single_engine_form(served):
    server = thttp.make_server(served['port'], port=0)
    try:
        assert server.engines == {'default': served['port']}
        assert server.batcher is None and server.batchers == {}
    finally:
        server.server_close()


# -------------------------------------------------------------- hot reload

def test_reload_swaps_the_version(served, tmp_path):
    engine = _port_engine(served)
    item = served['items'][2]
    before = engine.predict_items([item])[item['name']]
    path2 = _perturbed(served['ckpt'], str(tmp_path / 'epoch_2.npz'))
    old_model = engine.model
    assert engine.reload_checkpoint(path2) == path2 == engine.checkpoint_path
    assert engine.model is not old_model
    after = engine.predict_items([item])[item['name']]
    assert not np.array_equal(before['vuv'], after['vuv'])
    fresh = _port_engine(served, path2).predict_items([item])[item['name']]
    for key in fresh:
        np.testing.assert_array_equal(after[key], fresh[key], err_msg=key)


def test_reload_keeps_the_quantization(served, tmp_path):
    engine = _port_engine(served, quantize='int4')
    path2 = _perturbed(served['ckpt'], str(tmp_path / 'epoch_2.npz'))
    engine.reload_checkpoint(path2)
    assert engine.quantized
    assert {p.dtype for n, p in engine.model.named_parameters() if 'original0' in n} == \
        {torch.int8}
    item = served['items'][0]
    got = engine.predict_items([item])[item['name']]
    want = _port_engine(served, path2, quantize='int4').predict_items([item])[item['name']]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_maybe_reload_finds_a_higher_epoch_only(served, tmp_path):
    ckpt = _copy(served['ckpt'], str(tmp_path / 'epoch_1.npz'))
    engine = _port_engine(served, ckpt)
    assert engine.maybe_reload_newer_checkpoint() is None
    path3 = _perturbed(ckpt, str(tmp_path / 'epoch_3.npz'))
    _perturbed(ckpt, str(tmp_path / 'epoch_2.npz'))
    assert engine.maybe_reload_newer_checkpoint() == path3
    assert engine.maybe_reload_newer_checkpoint() is None
    _copy(path3, str(tmp_path / 'epoch_9_ema.npz'))   # another file name pattern
    assert engine.maybe_reload_newer_checkpoint() is None


def test_a_checkpoint_that_does_not_match_raises_and_the_old_version_serves(served, tmp_path):
    engine = _port_engine(served)
    item = served['items'][3]
    before = engine.predict_items([item])[item['name']]
    model = engine.model
    with np.load(served['ckpt']) as data:
        params = {k: data[k] for k in data.files}
    wrong_shape = dict(params, **{'layers.0.bias': np.zeros(7, np.float32)})
    np.savez(str(tmp_path / 'epoch_2.npz'), **wrong_shape)
    with pytest.raises(ValueError, match='layers.0.bias'):
        engine.reload_checkpoint(str(tmp_path / 'epoch_2.npz'))
    params.pop('layers.0.bias')
    np.savez(str(tmp_path / 'epoch_3.npz'), **params)
    with pytest.raises(KeyError, match='missing'):
        engine.reload_checkpoint(str(tmp_path / 'epoch_3.npz'))
    assert engine.model is model and engine.checkpoint_path == served['ckpt']
    after = engine.predict_items([item])[item['name']]
    for key in before:
        np.testing.assert_array_equal(after[key], before[key], err_msg=key)


def test_http_watcher_hot_reloads(served, tmp_path):
    """A higher epoch written beside the served one is picked up by the
    watcher: /healthz names it and /predict serves it. A checkpoint that
    does not match is logged and the version before it goes on serving."""
    ckpt = _copy(served['ckpt'], str(tmp_path / 'epoch_1.npz'))
    engine = _port_engine(served, ckpt)
    server = Running(thttp.make_server, engine, watch_checkpoints=0.1)
    item = served['items'][0]
    try:
        path5 = _perturbed(ckpt, str(tmp_path / 'epoch_5.npz'))
        deadline = time.time() + DEADLINE
        while time.time() < deadline and engine.checkpoint_path != path5:
            time.sleep(0.05)
        assert _request(server.port, '/healthz')[1]['checkpoint'] == path5
        got = _request(server.port, '/predict', {'items': [_json_item(item)]})[1]
        np.savez(str(tmp_path / 'epoch_7.npz'), w=np.zeros(3, np.float32))
        time.sleep(0.5)
        assert _request(server.port, '/healthz')[1]['checkpoint'] == path5
    finally:
        server.close()
    want = _port_engine(served, path5).predict_items([item])[item['name']]
    _hold(got['results'][item['name']], want)


def test_in_flight_stream_keeps_its_version(served, tmp_path):
    """``tests/test_streaming.py:160``: a reload between two chunks does not
    splice two models into one utterance; the stream ends on the version it
    started with, frame for frame, and the next stream runs on the new one."""
    engine = _port_engine(served)
    utt = _ids(served['root'], 'test')[0]
    ref = list(engine.stream_id(utt, chunk_frames=16))
    stream = engine.stream_id(utt, chunk_frames=16)
    got = [next(stream)]
    path2 = engine.reload_checkpoint(_perturbed(served['ckpt'], str(tmp_path / 'epoch_2.npz')))
    got.extend(stream)
    assert len(got) == len(ref) > 2
    for want, chunk in zip(ref, got):
        for key in want:
            np.testing.assert_array_equal(chunk[key], want[key], err_msg=key)
    after = np.concatenate([c['vuv'] for c in engine.stream_id(utt, chunk_frames=16)])
    fresh = np.concatenate([c['vuv'] for c in _port_engine(served, path2).stream_id(
        utt, chunk_frames=16)])
    np.testing.assert_array_equal(after, fresh)
    assert not np.array_equal(after, np.concatenate([c['vuv'] for c in ref]))


# -------------------------------------------------------------- serve.main

FLEET_REFUSALS = {
    'model-and-checkpoint-required': (None, ['--data_root', '.']),
    'fleet-needs-http-port': ({'v': {'model': 'm.py:C', 'checkpoint_path': 'c.npz'}}, []),
    'entry-must-be-an-object': ({'v': 'ckpt.npz'}, ['--http_port', '1']),
    'entry-needs-a-checkpoint': ({'v': {'model': 'm.py:C'}}, ['--http_port', '1']),
}


@pytest.mark.parametrize('case', list(FLEET_REFUSALS))
def test_main_refuses_what_jax_refuses(case, tmp_path, capsys):
    fleet, argv = FLEET_REFUSALS[case]
    if fleet is not None:
        (tmp_path / 'fleet.json').write_text(json.dumps(fleet))
        argv = ['--fleet', str(tmp_path / 'fleet.json')] + argv
    for main in (jserve.main, tserve.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2


UNPORTED = [['--data_parallel'], ['--compute_dtype', 'bfloat16'], ['--num_data_threads', '2'],
            ['--compilation_cache_dir', 'cache']]


@pytest.mark.parametrize('flag', UNPORTED, ids=[f[0][2:] for f in UNPORTED])
def test_main_unported_flags_are_argparse_errors(flag, capsys, monkeypatch, tmp_path):
    """Each flag the port lacks is an argparse error naming ROADMAP.md.
    --compilation_cache_dir, --compute_dtype and --num_data_threads are
    ported now: each is accepted (the command then fails to import its
    model, m:C);
    --compilation_cache_dir names the directory where the kernels are built
    and found, and a compute dtype the port lacks (float16) is an argparse
    error naming ROADMAP.md."""
    from morgana_tpu_torch import _build
    monkeypatch.setattr(_build, 'BUILD_DIR', _build.BUILD_DIR)
    argv = ['--model', 'm:C', '--checkpoint_path', 'c.npz', '--http_port', '1']
    if flag[0] == '--compilation_cache_dir':
        with pytest.raises(ModuleNotFoundError):
            tserve.main(argv + [flag[0], str(tmp_path / flag[1])])
        assert _build.BUILD_DIR == str(tmp_path / flag[1])
        return
    if flag[0] == '--num_data_threads':
        with pytest.raises(ModuleNotFoundError):
            tserve.main(argv + flag)
        return
    if flag[0] == '--compute_dtype':
        with pytest.raises(ModuleNotFoundError):
            tserve.main(argv + flag)
        flag = [flag[0], 'float16']
    with pytest.raises(SystemExit) as exc:
        tserve.main(argv + flag)
    err = capsys.readouterr().err
    assert exc.value.code == 2 and flag[0] in err and 'ROADMAP.md' in err


@pytest.mark.parametrize('fleet', [False, True], ids=['one-voice', 'fleet'])
def test_main_http_port_builds_the_server(served, fleet, tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(thttp, 'serve_forever', lambda engine, **kwargs: calls.append(
        (engine, kwargs)))
    flags = ['--data_root', served['root'], '--device', 'cpu', '--http_port', '0',
             '--http_host', '0.0.0.0', '--dynamic_batch_ms', '2.5', '--watch_checkpoints', '3',
             '--stream_configs', '16,32,32;64,32,16', '--quantize', 'int8',
             '--model_kwargs', repr(AC_KWARGS)]
    if fleet:
        spec = {'a': {'model': LSTM_SPEC, 'checkpoint_path': served['ckpt'], 'batch_size': 3},
                'b': {'checkpoint_path': served['ckpt'], 'quantize': None}}
        (tmp_path / 'fleet.json').write_text(json.dumps(spec))
        flags += ['--fleet', str(tmp_path / 'fleet.json'), '--model', LSTM_SPEC]
    else:
        flags += ['--model', LSTM_SPEC, '--checkpoint_path', served['ckpt']]
    tserve.main(flags)
    (engine, kwargs), = calls
    assert kwargs == {'host': '0.0.0.0', 'port': 0, 'dynamic_batch_ms': 2.5,
                      'watch_checkpoints': 3.0}
    engines = engine if fleet else {'default': engine}
    assert list(engines) == (['a', 'b'] if fleet else ['default'])
    for name, eng in engines.items():
        assert eng.stream_configs == {(16, 32, 32), (64, 32, 16)}
        assert eng.quantized is (name != 'b')
        assert eng.batch_size == (3 if name == 'a' else 8)
        assert eng.device == torch.device('cpu')


@pytest.mark.parametrize('fleet', [False, True], ids=['one-voice', 'fleet'])
def test_main_http_port_serves_in_bf16(served, fleet, tmp_path, monkeypatch):
    """``serve.main --http_port --compute_dtype bfloat16``, one voice or a
    fleet (whose first engine sets the process's compute dtype,
    ``serve.py:1047``): every engine built serves in bf16, as an engine
    built with compute_dtype='bfloat16' does, unlike the f32 engine."""
    from morgana_tpu_torch import nn as tnn
    calls = []
    monkeypatch.setattr(thttp, 'serve_forever', lambda engine, **kwargs: calls.append(engine))
    flags = ['--data_root', served['root'], '--device', 'cpu', '--http_port', '0',
             '--model_kwargs', repr(AC_KWARGS), '--model', LSTM_SPEC, '--compute_dtype',
             'bfloat16']
    if fleet:
        spec = {'a': {'checkpoint_path': served['ckpt']}, 'b': {'checkpoint_path': served['ckpt']}}
        (tmp_path / 'fleet.json').write_text(json.dumps(spec))
        flags += ['--fleet', str(tmp_path / 'fleet.json')]
    else:
        flags += ['--checkpoint_path', served['ckpt']]
    utt = _ids(served['root'], 'test')[0]
    common = dict(data_root=served['root'], device='cpu', model_kwargs=AC_KWARGS)
    f32 = TEngine(trnn.LSTMAcousticModel, served['ckpt'], **common).predict_ids([utt])[utt]
    try:
        tserve.main(flags)
        assert tnn.default_compute_dtype() is torch.bfloat16
        engine, = calls
        engines = engine if fleet else {'default': engine}
        got = {name: eng.predict_ids([utt])[utt] for name, eng in engines.items()}
        want = TEngine(trnn.LSTMAcousticModel, served['ckpt'], compute_dtype='bfloat16',
                       **common).predict_ids([utt])[utt]
    finally:
        tnn.set_default_compute_dtype(None)
    assert list(got) == (['a', 'b'] if fleet else ['default'])
    for outputs in got.values():
        for key, value in want.items():
            np.testing.assert_array_equal(outputs[key], value, err_msg=key)
        assert not np.array_equal(outputs['vuv'], f32['vuv'])


def test_main_needs_a_gpu_unless_asked_for_the_cpu(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(thttp, 'serve_forever', lambda engine, **kwargs: None)
    with pytest.raises(DeviceError, match="device='cpu'"):
        tserve.main(['--model', LSTM_SPEC, '--checkpoint_path', served['ckpt'], '--data_root',
                     served['root'], '--model_kwargs', repr(AC_KWARGS), '--http_port', '0'])


def test_a_reload_holds_the_handlers_host_work_back():
    """The handlers' large host work takes turns on the gate, and the
    watcher's reload goes next: it waits for the section in flight, and a
    section that arrives meanwhile waits for it."""
    gate = thttp._HostGate()
    events = []
    in_flight, reload_waiting = threading.Event(), threading.Event()

    def handler(name, hold):
        with gate.work():
            events.append(f'{name} in')
            in_flight.set()
            hold.wait(5)
            events.append(f'{name} out')

    first_done = threading.Event()
    first = threading.Thread(target=handler, args=('first', first_done))
    first.start()
    in_flight.wait(5)

    def reload():
        reload_waiting.set()
        with gate.reload():
            events.append('reload')

    reloader = threading.Thread(target=reload)
    reloader.start()
    reload_waiting.wait(5)
    time.sleep(0.05)
    go = threading.Event()
    go.set()
    late = threading.Thread(target=handler, args=('late', go))
    late.start()
    time.sleep(0.05)
    assert events == ['first in']          # the reload waits, and so does new work
    first_done.set()
    for t in (first, reloader, late):
        t.join(5)
    assert events == ['first in', 'first out', 'reload', 'late in', 'late out']


@pytest.mark.parametrize('payload', [
    {'results': {'u0': {'lf0': [[5.1], [5.2]], 'mcep': [[0.1, -0.25], [1e-300, 3.0]],
                        'empty': [], 'nested': [[]]}}},
    {'status': 'ok', 'n': 3, 'flag': True, 'none': None, 'ü': 'é', 'd': {}, 'mixed': [[1], 2]},
    {1: 'an int key'}, [[{'a': 1.5}], [{'b': [0.1]}]], 'text',
    {'results': {'u0': {'mcep': np.random.default_rng(0).normal(size=(200, 7)).tolist(),
                        'lf0': [[float(i)] for i in range(129)], 'n': list(range(65))}}}],
    ids=['results', 'scalars', 'int_key', 'lists_of_dicts', 'string', 'blocks'])
def test_replies_encode_as_json_dumps_does(payload):
    """The handlers encode a reply a dict entry and a block of rows at a
    time, into json.dumps(payload, allow_nan=False)'s bytes; a non-finite
    value raises as there."""
    assert thttp._encode(payload) == json.dumps(payload, allow_nan=False)
    with pytest.raises(ValueError):
        thttp._encode({'results': {'u0': {'lf0': [[float('nan')]]}}})
    with pytest.raises(ValueError):
        thttp._encode({'results': {'u0': {'lf0': [[0.0]] * 100 + [[float('inf')]]}}})
