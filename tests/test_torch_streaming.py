"""Streaming inference of the port against the JAX package on the CPU:
``StreamingMLPG``, the recurrent and KV-cache state carried through
``SequentialWithRecurrent`` and ``TransformerEncoder.step``, the models'
streaming hooks, ``InferenceEngine.stream_item`` / ``stream_id`` /
``stream_item_audio`` and ``StreamingSession``.

Weights are seeded JAX parameters, saved as ``epoch_0.npz`` and loaded by
both packages (``nn.load_jax_params``). Tolerances and why:

* a chunked stack or encoder against the same stack run whole: 1e-6 abs
  for recurrent stacks (JAX's ``test_sequential_chunked_equals_full``; the
  same f32 steps), 1e-5 for attention (the cached keys are summed in
  another order than the full sequence's);
* port against JAX, one module or the network outputs of a stream:
  ``NET_ATOL`` = 1e-5 abs (f32 sums in another order);
* a stream against the same engine's batch predict: JAX's own atol (vuv
  1e-6 for the LSTM, 1e-5 for the Transformer, lf0 1e-4, mcep and bap 1e-3;
  ``tests/test_streaming.py:493``, ``:561``): the windowed MLPG approximates
  the whole-utterance solve;
* the port's stream against JAX's stream: ``TRAJ_ATOL`` = 5e-5 abs on the
  smoothed trajectories (two f32 banded solves of each window, fed by the
  network outputs above; ``tests/test_torch_slice.py``'s batch tolerance),
  ``NET_ATOL`` on the rest;
* ``StreamingMLPG`` against JAX's on the same means: 1e-5 abs on values
  near 5 (the port's MLPG is held to JAX's at 5e-6 relative in
  ``tests/test_torch_ops.py``).
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu import nn as jnn
from morgana_tpu.serve import InferenceEngine as JEngine
from morgana_tpu.streaming import StreamingMLPG as JStreamingMLPG

from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.models import duration_model as tduration
from morgana_tpu_torch.models import f0_test_model as tf0
from morgana_tpu_torch.models import rnn_spss as trnn
from morgana_tpu_torch.models import transformer_spss as ttransformer
from morgana_tpu_torch.serve import InferenceEngine as TEngine
from morgana_tpu_torch.streaming import StreamingMLPG
from morgana_tpu_torch.vocoder import StreamingSynthesizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'models'))
try:
    from f0_test_model import F0Model as JF0
    from rnn_spss import LSTMAcousticModel as JLSTM
    from transformer_spss import TransformerAcousticModel as JTransformer
finally:
    sys.path.pop(0)

NET_ATOL = 1e-5
TRAJ_ATOL = 5e-5
MLPG_ATOL = 1e-5
# JAX's streamed-against-batch tolerances.
BATCH_ATOL = {'lstm': {'vuv': 1e-6, 'lf0': 1e-4, 'mcep': 1e-3, 'bap': 1e-3},
              'f0': {'normalised_lf0_deltas': 1e-5, 'lf0': 1e-4},
              'transformer': {'vuv': 1e-5, 'lf0': 1e-4, 'mcep': 1e-3, 'bap': 1e-3}}
CAUSAL = {'num_layers': 2, 'd_model': 32, 'num_heads': 4, 'causal': True,
          'attention_window': 24}
# name: (JAX model, port model, model_kwargs, seed)
MODELS = {
    'lstm': (JLSTM, trnn.LSTMAcousticModel, {'num_layers': 2, 'hidden_size': 32}, 41),
    'f0': (JF0, tf0.F0Model, {}, 42),
    'transformer': (JTransformer, ttransformer.TransformerAcousticModel, CAUSAL, 43),
}
# (chunk_frames, context, lookahead): JAX's test, the smoke's, a short window.
CONFIGS = [(16, 32, 32), (64, 32, 16), (7, 5, 3)]


def _ids(root, split='test'):
    return file_io.get_file_ids(os.path.join(root, split, f'{split}_file_id_list.scp'))


def _concat(chunks):
    return {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}


def _item(engine, root, utt, split='test'):
    data_dir = os.path.join(root, split)
    return dict({name: src.load_file(utt, data_dir)
                 for name, src in engine.model.test_data_sources().items()}, name=utt)


# ------------------------------------------------------------ StreamingMLPG

def _smooth_means(rng, batch, frames, dim):
    return (np.cumsum(rng.normal(0, 0.05, (batch, frames, dim)), axis=1) + 5.0).astype(np.float32)


@pytest.mark.parametrize('chunk,context,lookahead,padding,pushes', [
    (16, 32, 16, 0, [40, 3, 0, 57]),
    (8, 4, 4, 100, [1] * 23),
    (64, 32, 16, 100, [64, 64, 64, 10]),
    (5, 0, 0, 3, [12, 12]),
], ids=['ragged', 'frame-by-frame', 'smoke-config', 'no-context'])
def test_streaming_mlpg_matches_jax(chunk, context, lookahead, padding, pushes):
    """Each push's and the flush's emitted frames equal JAX's within
    MLPG_ATOL, and together cover every frame pushed."""
    rng = np.random.default_rng(sum(pushes))
    means = _smooth_means(rng, 2, sum(pushes), 3 * 4)
    variances = rng.uniform(0.2, 2.0, 3 * 4).astype(np.float32)
    port = StreamingMLPG(variances, chunk, context=context, lookahead=lookahead,
                         padding_size=padding)
    ref = JStreamingMLPG(variances, chunk, context=context, lookahead=lookahead,
                         padding_size=padding)
    start, total = 0, 0
    for n in pushes:
        got, want = port.push(means[:, start:start + n]), np.asarray(ref.push(
            means[:, start:start + n]))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=MLPG_ATOL, rtol=0)
        start += n
        total += got.shape[1]
    got, want = port.flush(), np.asarray(ref.flush())
    np.testing.assert_allclose(got, want, atol=MLPG_ATOL, rtol=0)
    assert total + got.shape[1] == sum(pushes)
    assert port.delay_frames == ref.delay_frames == lookahead + chunk - 1


@pytest.mark.parametrize('misuse', ['push_after_flush', 'flush_twice', 'two_dims',
                                    'zero_chunk', 'negative_context'])
def test_streaming_mlpg_refuses_misuse(misuse):
    variances = np.ones(3, np.float32)
    if misuse in ('zero_chunk', 'negative_context'):
        with pytest.raises(ValueError):
            StreamingMLPG(variances, 0 if misuse == 'zero_chunk' else 4,
                          context=-1 if misuse == 'negative_context' else 0)
        return
    sm = StreamingMLPG(variances, 4)
    if misuse == 'two_dims':
        with pytest.raises(ValueError, match='batch, frames'):
            sm.push(np.zeros((5, 3), np.float32))
        return
    sm.push(np.zeros((1, 5, 3), np.float32))
    sm.flush()
    with pytest.raises(RuntimeError):
        sm.push(np.zeros((1, 2, 3), np.float32)) if misuse == 'push_after_flush' else sm.flush()


def test_streaming_mlpg_keeps_a_window_of_frames():
    """A long stream retains O(context + chunk + lookahead) frames."""
    sm = StreamingMLPG(np.ones(3, np.float32), 16, context=8, lookahead=4)
    means = _smooth_means(np.random.default_rng(2), 1, 2000, 3)
    for start in range(0, 2000, 16):
        sm.push(means[:, start:start + 16])
        assert sum(c.shape[1] for c in sm._chunks) <= 8 + 16 + 4 + 16


# ------------------------------------------------- the state-carrying stack

def _stacks(seed):
    jnn.manual_seed(seed)
    jstack = jnn.SequentialWithRecurrent(jnn.Linear(5, 8), jnn.Sigmoid(),
                                         jnn.Recurrent('gru', 8, 8), jnn.Recurrent('lstm', 8, 8),
                                         jnn.Linear(8, 2))
    tstack = tnn.SequentialWithRecurrent(tnn.Linear(5, 8), tnn.Sigmoid(),
                                         tnn.Recurrent('gru', 8, 8), tnn.Recurrent('lstm', 8, 8),
                                         tnn.Linear(8, 2))
    tnn.load_jax_params(tstack, jnn.state_dict(jstack))
    return jstack, tstack


@pytest.mark.parametrize('chunk', [7, 1, 30])
def test_sequential_chunked_equals_full_and_jax(chunk):
    """GRU and LSTM states threaded chunk to chunk reproduce the whole run
    (1e-6), and JAX's whole run (NET_ATOL); the state slots of the
    stateless members stay None."""
    jstack, tstack = _stacks(7)
    x = np.random.default_rng(3).normal(size=(2, 30, 5)).astype(np.float32)
    with torch.no_grad():
        full = tstack(torch.from_numpy(x)).numpy()
        state, parts = None, []
        for s in range(0, 30, chunk):
            out, state = tstack(torch.from_numpy(x[:, s:s + chunk]), hiddens=state,
                                return_hiddens=True)
            parts.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(parts, axis=1), full, atol=1e-6, rtol=0)
    np.testing.assert_allclose(full, np.asarray(jstack(jnp.asarray(x))), atol=NET_ATOL, rtol=0)
    assert [s is None for s in state] == [True, True, False, False, True]
    assert isinstance(state[3], tuple) and state[3][0].shape == (2, 8)


def test_sequential_leaves_the_callers_state_list_alone():
    _, tstack = _stacks(8)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 6, 5)).astype(np.float32))
    with torch.no_grad():
        _, state = tstack(x[:, :3], return_hiddens=True)
        kept = list(state)
        first, new_state = tstack(x[:, 3:], hiddens=state, return_hiddens=True)
        again, _ = tstack(x[:, 3:], hiddens=state, return_hiddens=True)
    assert all(a is b for a, b in zip(state, kept)) and new_state is not state
    torch.testing.assert_close(first, again, rtol=0, atol=0)


def test_sequential_refuses_a_member_that_cannot_stream():
    """A bare attention block has a ``step`` of another signature: the
    container does not drive it, as in JAX."""
    stack = tnn.SequentialWithRecurrent(tnn.Linear(5, 16), tnn.TransformerEncoderLayer(16, 2, 32))
    with torch.no_grad(), pytest.raises(NotImplementedError, match='cannot stream'):
        stack(torch.zeros(1, 4, 5), return_hiddens=True)


@pytest.mark.parametrize('chunk', [5, 8, 24, 40])
def test_encoder_step_equals_windowed_forward_and_jax_step(chunk):
    """``TransformerEncoder.step`` chunk by chunk (window 8, chunks shorter
    and longer than the window) against the port's causal windowed forward
    (1e-5) and JAX's step (NET_ATOL), positions at their true offsets."""
    jnn.manual_seed(21)
    jenc = jnn.TransformerEncoder(2, 32, 4, 64, causal=True, window=8)
    tenc = tnn.TransformerEncoder(2, 32, 4, 64, causal=True, window=8)
    tnn.load_jax_params(tenc, jnn.state_dict(jenc))
    x = np.random.default_rng(22).normal(size=(2, 40, 32)).astype(np.float32)
    with torch.no_grad():
        full = tenc(torch.from_numpy(x)).numpy()
        tstate, jstate, parts = None, None, []
        for s in range(0, 40, chunk):
            out, tstate = tenc.step(torch.from_numpy(x[:, s:s + chunk]), tstate)
            want, jstate = jenc.step(jnp.asarray(x[:, s:s + chunk]), jstate)
            np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=NET_ATOL, rtol=0)
            parts.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(parts, axis=1), full, atol=1e-5, rtol=0)
    assert tstate['pos'] == int(jstate['pos']) == 40
    for (tk, tv), (jk, jv) in zip(tstate['caches'], jstate['caches']):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=NET_ATOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=NET_ATOL, rtol=0)


def test_bidirectional_encoder_refuses_to_stream():
    with pytest.raises(ValueError, match='causal'):
        tnn.TransformerEncoder(1, 16, 2, 32).init_stream_state(1)


# ------------------------------------------------------ the engines' streams

def _checkpoint(name, base):
    jmodel, _, kwargs, seed = MODELS[name]
    jnn.manual_seed(seed)
    return jmodel(**kwargs).save_parameters(str(base / 'init'), 0)


@pytest.fixture(scope='module', params=list(MODELS))
def engines(request, voice_data, tmp_path_factory):
    """Both packages' engines on one seeded checkpoint, with the batch
    predictions of the test split."""
    name = request.param
    jmodel, tmodel, kwargs, _ = MODELS[name]
    root = voice_data['data_root']
    ckpt = _checkpoint(name, tmp_path_factory.mktemp(f'stream_{name}'))
    jax_engine = JEngine(jmodel, ckpt, data_root=root, device='cpu', batch_size=2,
                         model_kwargs=kwargs)
    port = TEngine(tmodel, ckpt, data_root=root, device='cpu', batch_size=2, model_kwargs=kwargs)
    ids = _ids(root)
    return {'name': name, 'root': root, 'jax': jax_engine, 'port': port, 'ids': ids,
            'batch': port.predict_ids(ids)}


def test_stream_equals_batch_predict(engines):
    """At JAX's own streaming test configuration (chunk 16, context 32,
    lookahead 32), every output the model streams, for each test utterance,
    within JAX's streamed-against-batch tolerances of the same engine's
    batch predict, in more than one chunk, each chunk aligned across the
    outputs. (A shorter window strays further from the whole-utterance
    solve, in both packages alike: the next test holds them to each
    other.)"""
    port = engines['port']
    for utt in engines['ids']:
        chunks = list(port.stream_id(utt, chunk_frames=16, context=32, lookahead=32))
        assert len(chunks) > 1
        for chunk in chunks:
            assert len({v.shape[0] for v in chunk.values()}) == 1
        streamed = _concat(chunks)
        assert sorted(streamed) == sorted(port.model.stream_output_spec())
        for key, atol in BATCH_ATOL[engines['name']].items():
            ref = engines['batch'][utt][key]
            assert streamed[key].shape == ref.shape, key
            np.testing.assert_allclose(streamed[key], ref, atol=atol, rtol=0, err_msg=key)


@pytest.mark.parametrize('config', CONFIGS, ids=['16-32-32', '64-32-16', '7-5-3'])
def test_stream_equals_jax_stream(engines, config):
    """The port's stream against JAX's on the same weights and utterance:
    the same outputs and chunking, the network outputs within NET_ATOL, the
    smoothed trajectories within TRAJ_ATOL."""
    chunk_frames, context, lookahead = config
    for utt in engines['ids']:
        got = list(engines['port'].stream_id(utt, chunk_frames=chunk_frames, context=context,
                                             lookahead=lookahead))
        want = list(engines['jax'].stream_id(utt, chunk_frames=chunk_frames, context=context,
                                             lookahead=lookahead))
        assert [sorted((k, v.shape) for k, v in c.items()) for c in got] == \
            [sorted((k, np.asarray(v).shape) for k, v in c.items()) for c in want]
        got, want = _concat(got), _concat(want)
        for key in got:
            atol = NET_ATOL if key.startswith('normalised') or key == 'vuv' else TRAJ_ATOL
            np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=atol, rtol=0,
                                       err_msg=key)


def test_stream_item_equals_stream_id(engines):
    port, root = engines['port'], engines['root']
    utt = engines['ids'][0]
    from_file = _concat(list(port.stream_id(utt, chunk_frames=16)))
    from_memory = _concat(list(port.stream_item(_item(port, root, utt), chunk_frames=16)))
    for key in from_file:
        np.testing.assert_array_equal(from_file[key], from_memory[key])
    session = port._stream_session(16, 32, 16)
    assert (session.chunk_frames, session.context, session.lookahead) == (16, 32, 16)
    assert sorted(session.spec) == sorted(port.model.stream_output_spec())


def test_stream_item_audio_is_the_streaming_synthesizer(engines):
    """The acoustic models' audio stream: the wave equals
    ``StreamingSynthesizer`` (seed 0) on the streamed features with lf0
    clipped at 8, pushed whole, sample for sample; n_frames * 80 samples,
    some before the last pair; ``device_lock`` entered once per feature
    chunk and once for the stream's end. F0Model streams no audio."""
    port, root = engines['port'], engines['root']
    item = _item(port, root, engines['ids'][0])
    if engines['name'] == 'f0':
        with pytest.raises(ValueError, match='audio streaming needs'):
            port.stream_item_audio(item)
        return

    class Lock(object):
        entered = 0

        def __enter__(self):
            Lock.entered += 1

        def __exit__(self, *exc):
            return False

    pairs = list(port.stream_item_audio(item, chunk_frames=16, context=32, lookahead=16,
                                        device_lock=Lock()))
    feats = {k: np.concatenate([c[k] for c, _ in pairs if c]) for k in ('lf0', 'vuv', 'mcep',
                                                                         'bap')}
    audio = np.concatenate([w for _, w in pairs])
    assert audio.shape == (feats['lf0'].shape[0] * 80,)
    assert any(w.shape[0] for _, w in pairs[:-1])
    assert Lock.entered == sum(1 for c, _ in pairs if c and len(c['lf0'])) + 1
    synth = StreamingSynthesizer(16000, seed=0)
    want = np.concatenate([synth.push_world_feats(np.exp(np.clip(feats['lf0'][:, 0], None, 8.0)),
                                                  feats['vuv'][:, 0], feats['mcep'],
                                                  feats['bap']), synth.flush()])
    np.testing.assert_array_equal(audio, want)


def test_model_without_hooks_refuses_to_stream(voice_data, tmp_path):
    """DurationModel has no streaming hooks: the engine's stream raises."""
    model = tduration.DurationModel(hidden_size=16, generator=torch.Generator().manual_seed(44))
    ckpt = model.save_parameters(str(tmp_path), 0)
    engine = TEngine(tduration.DurationModel, ckpt, data_root=voice_data['data_root'],
                     device='cpu', model_kwargs={'hidden_size': 16})
    with pytest.raises(NotImplementedError, match='does not implement streaming'):
        next(iter(engine.stream_id(_ids(voice_data['data_root'])[0])))


def test_bidirectional_transformer_refuses_to_stream():
    model = ttransformer.TransformerAcousticModel(num_layers=1, d_model=16, num_heads=2)
    with pytest.raises(NotImplementedError, match='causal'):
        model.stream_step(torch.zeros(1, 4, 609), None)
