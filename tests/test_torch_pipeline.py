"""Two-stage TTS from labels through the port against the JAX package on the
CPU: ``durations_to_int``, ``data.prepare``, ``TTSPipeline`` (durations,
acoustic features, wavs on the host or in one ``torch_world`` batch), its
command line and ``evaluate``.

Both packages' engines load the same seeded JAX checkpoints
(``DurationModel(hidden_size=16)`` and ``LSTMAcousticModel`` with 2 x
LSTM(32)) and run the ``voice_data`` corpus's validation split at B=3.
Tolerances and why:

* integer durations equal: the float durations of both packages are within
  1e-5 of each other and none of JAX's lies within ``TIE_MARGIN`` = 1e-3 of
  a .5 boundary, so ``np.rint`` cannot part them (checked, not assumed);
* acoustic features: network outputs within ``NET_ATOL`` = 1e-5, MLPG
  trajectories within ``TRAJ_ATOL`` = 5e-5 (``tests/test_torch_slice.py``);
* host wavs byte-identical given the JAX pipeline's features (the same
  host vocoder), and of the port's own features within ``RATIO_TOL`` =
  1e-4 in energy and peak (``tests/test_torch_generate.py``);
* the device vocoder's inputs (padded f0, vuv, mcep, bap, lengths, T)
  equal to JAX's on the same features, and within the feature tolerances
  on each package's own; the port's waves equal to ``synthesize_batch``
  on its captured inputs (that function is held to JAX's in
  ``tests/test_torch_vocoder.py``; the noise draws differ by design);
* ``evaluate_dirs``: each score within 1e-5 relative of JAX's (f32 sums in
  another order, both rounded to 6 decimals).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from morgana_tpu import nn as jnn
from morgana_tpu import pipeline as jpipeline
from morgana_tpu.data import prepare as jprepare
from morgana_tpu.evaluate import evaluate_dirs as jevaluate_dirs
from morgana_tpu.serve import InferenceEngine as JEngine
from morgana_tpu.vocoder import jax_world

from morgana_tpu_torch import evaluate as tevaluate
from morgana_tpu_torch import pipeline as tpipeline
from morgana_tpu_torch.data import bucket_size, file_io
from morgana_tpu_torch.data import prepare as tprepare
from morgana_tpu_torch.device import DeviceError
from morgana_tpu_torch.models import f0_test_model as tf0
from morgana_tpu_torch.models import rnn_spss as trnn
from morgana_tpu_torch.models.duration_model import DurationModel as TDur
from morgana_tpu_torch.serve import InferenceEngine as TEngine
from morgana_tpu_torch.vocoder import torch_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'models'))
try:
    from duration_model import DurationModel as JDur
    from f0_test_model import F0Model as JF0
    from rnn_spss import LSTMAcousticModel as JLSTM
finally:
    sys.path.pop(0)

TIE_MARGIN = 1e-3
DUR_ATOL = 1e-5
NET_ATOL = 1e-5
TRAJ_ATOL = 5e-5
RATIO_TOL = 1e-4
SCORE_RTOL = 1e-5
BATCH = 3
DUR_KWARGS = {'hidden_size': 16}
AC_KWARGS = {'num_layers': 2, 'hidden_size': 32}
NET_KEYS = ('normalised_lf0_deltas', 'normalised_mcep_deltas', 'normalised_bap_deltas', 'vuv')
TRAJ_KEYS = ('lf0', 'mcep', 'bap')
HOP = 80


# ----------------------------------------------------------- the functions

DURATION_CASES = {
    'rounding-and-tail': (np.array([[3.4], [0.2], [-1.0], [9.6], [7.0]], np.float32), 4, {}),
    'ties-round-to-even': (np.array([0.5, 1.5, 2.5, 3.5]), 4, {}),
    'cap-rescales': (np.array([10.0, 30.0]), 2, {'max_total_frames': 20}),
    'cap-trims-longest-first': (np.full(7, 9.9, np.float32), 7, {'max_total_frames': 32}),
    'floor-beats-cap': (np.ones(10), 10, {'min_frames_per_phone': 2, 'max_total_frames': 5}),
    'floor': (np.zeros(3), 3, {'min_frames_per_phone': 2}),
    'cap-not-reached': (np.array([2.2, 3.7]), 2, {'max_total_frames': 100}),
}


@pytest.mark.parametrize('case', list(DURATION_CASES))
def test_durations_to_int_matches_jax(case):
    pred, n_phones, kwargs = DURATION_CASES[case]
    got = tpipeline.durations_to_int(pred, n_phones, **kwargs)
    want = jpipeline.durations_to_int(pred, n_phones, **kwargs)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('bad', [np.nan, np.inf])
def test_durations_to_int_refuses_non_finite(bad):
    pred = np.array([3.0, bad, 2.0])
    with pytest.raises(ValueError, match='non-finite'):
        jpipeline.durations_to_int(pred, 3)
    with pytest.raises(ValueError, match='non-finite'):
        tpipeline.durations_to_int(pred, 3)


COUNTER_CASES = {
    'durations': (23, np.array([3, 1, 7, 12])),
    'one-phone': (5, np.array([5])),
    'one-frame': (1, np.array([1])),
    'no-durations': (17, None),
    'durations-past-the-end': (5, np.array([2, 2, 2])),
}


@pytest.mark.parametrize('case', list(COUNTER_CASES))
def test_frame_counters_match_jax(case):
    n_frames, dur = COUNTER_CASES[case]
    got = tprepare._frame_counters(n_frames, dur)
    assert got.shape == (n_frames, 9) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jprepare._frame_counters(n_frames, dur))


@pytest.mark.parametrize('dur,n_frames', [([3, 4, 5], 12), ([3, 4, 5], 8), ([3, 4, 5], 3),
                                          ([3, 4, 5], 20), ([1, 1, 9], 4)],
                         ids=['exact', 'trim', 'trim-to-ones', 'pad', 'trim-over-phones'])
def test_fit_durations_matches_jax(dur, n_frames):
    np.testing.assert_array_equal(tprepare.fit_durations(dur, n_frames),
                                  jprepare.fit_durations(dur, n_frames))


def test_fit_durations_refuses_more_phones_than_frames():
    with pytest.raises(ValueError, match='more phones'):
        tprepare.fit_durations([1, 1, 1], 2, 'utt')


# ------------------------------------------------------------ the pipeline

def _ids(root, split):
    return file_io.get_file_ids(os.path.join(root, split, f'{split}_file_id_list.scp'))


def _items(root, split):
    return [{'name': utt, 'lab': np.load(os.path.join(root, split, 'lab', f'{utt}.npy'))}
            for utt in _ids(root, split)]


@pytest.fixture(scope='module')
def stages(voice_data, tmp_path_factory):
    """Both packages' duration and acoustic engines on seeded JAX
    checkpoints, and each package's host-vocoder pipeline run over the
    validation split into its own out_dir."""
    root = voice_data['data_root']
    base = tmp_path_factory.mktemp('tts')
    jnn.manual_seed(61)
    dur_ckpt = JDur(**DUR_KWARGS).save_parameters(str(base / 'dur'), 0)
    jnn.manual_seed(62)
    ac_ckpt = JLSTM(**AC_KWARGS).save_parameters(str(base / 'ac'), 0)
    common = dict(data_root=root, device='cpu', batch_size=BATCH)
    jax_pipe = jpipeline.TTSPipeline(
        JEngine(JDur, dur_ckpt, model_kwargs=DUR_KWARGS, **common),
        JEngine(JLSTM, ac_ckpt, model_kwargs=AC_KWARGS, **common))
    port = tpipeline.TTSPipeline(
        TEngine(TDur, dur_ckpt, model_kwargs=DUR_KWARGS, **common),
        TEngine(trnn.LSTMAcousticModel, ac_ckpt, model_kwargs=AC_KWARGS, **common))
    ids = _ids(root, 'valid')
    results = {'jax': jax_pipe.synthesize_ids(ids, data_dir='valid', out_dir=str(base / 'jax')),
               'port': port.synthesize_ids(ids, data_dir='valid', out_dir=str(base / 'port'))}
    return {'root': root, 'base': base, 'ids': ids, 'jax': jax_pipe, 'port': port,
            'results': results, 'dur_ckpt': dur_ckpt, 'ac_ckpt': ac_ckpt}


def _float_durations(pipe, items):
    """The duration engine's float predictions, cut to each item's phones."""
    built = [{'name': it['name'], 'lab': it['lab'],
              'n_phones': np.asarray([[float(it['lab'].shape[0])]], np.float32)}
             for it in items]
    out = pipe.duration_engine.predict_items(
        built, sources=pipe._stage_sources(pipe.duration_engine, pipe.DURATION_INPUTS))
    return {it['name']: np.asarray(out[it['name']]['dur']).reshape(-1)[:it['lab'].shape[0]]
            for it in items}


@pytest.mark.parametrize('split', ['valid', 'test'])
def test_durations_equal_jax(stages, split):
    """Integer durations equal; float durations within DUR_ATOL; no JAX
    duration within TIE_MARGIN of a rounding boundary."""
    items = _items(stages['root'], split)
    got = stages['port'].predict_durations(items)
    want = stages['jax'].predict_durations(items)
    floats = {tag: _float_durations(stages[tag], items) for tag in ('jax', 'port')}
    for it in items:
        name = it['name']
        f = floats['jax'][name]
        assert np.abs(np.abs(f - np.floor(f)) - 0.5).min() > TIE_MARGIN, (name, f)
        np.testing.assert_allclose(floats['port'][name], f, atol=DUR_ATOL, rtol=0)
        assert got[name].dtype == np.int64 and got[name].shape == (it['lab'].shape[0],)
        np.testing.assert_array_equal(got[name], want[name])
        assert (got[name] >= 1).all()


def test_features_match_jax(stages):
    """Every acoustic output of the port's pipeline within tolerance of
    JAX's, unpadded to the predicted frame count; durations and frame
    counts equal."""
    got, want = stages['results']['port'], stages['results']['jax']
    assert sorted(got) == sorted(want) == sorted(stages['ids'])
    for name in got:
        assert got[name]['n_frames'] == want[name]['n_frames'] == int(got[name]['dur'].sum())
        np.testing.assert_array_equal(got[name]['dur'], want[name]['dur'])
        assert sorted(got[name]) == sorted(want[name])
        for key in NET_KEYS + TRAJ_KEYS:
            assert got[name][key].shape[0] == got[name]['n_frames'], key
            np.testing.assert_allclose(got[name][key], np.asarray(want[name][key]),
                                       atol=NET_ATOL if key in NET_KEYS else TRAJ_ATOL, rtol=0,
                                       err_msg=f'{name} {key}')


def test_synthesize_ids_layout_matches_jax(stages):
    """feats/{key}/{utt}.npy for every feature, durations included, and
    synth/{utt}.wav, the same files as JAX's; each wav n_frames * hop
    samples, energy and peak within RATIO_TOL of JAX's."""
    base = stages['base']

    def listing(tag):
        return sorted(os.path.relpath(os.path.join(d, f), base / tag)
                      for d, _, files in os.walk(base / tag) for f in files)

    assert listing('port') == listing('jax')
    assert {os.path.dirname(p) for p in listing('port')} == \
        {'synth'} | {os.path.join('feats', k) for k in NET_KEYS + TRAJ_KEYS + ('dur',)}
    for name in stages['ids']:
        got, want = (file_io.load_wav(str(base / tag / 'synth' / f'{name}.wav'))[0]
                     .astype(np.float64) for tag in ('port', 'jax'))
        n_frames = stages['results']['port'][name]['n_frames']
        assert got.shape == want.shape == (n_frames * HOP,)
        energy = np.sqrt((got ** 2).mean() / (want ** 2).mean())
        assert abs(energy - 1) < RATIO_TOL and abs(np.abs(got).max() / np.abs(want).max() - 1) \
            < RATIO_TOL, name
        np.testing.assert_array_equal(np.load(base / 'port' / 'feats' / 'dur' / f'{name}.npy'),
                                      stages['results']['jax'][name]['dur'])


def test_host_wavs_are_byte_identical_given_the_jax_features(stages, tmp_path, monkeypatch):
    """The port's pipeline fed the JAX acoustic engine's outputs writes the
    JAX pipeline's wav files byte for byte."""
    port, jax_pipe = stages['port'], stages['jax']
    monkeypatch.setattr(port.acoustic_engine, 'predict_items',
                        jax_pipe.acoustic_engine.predict_items)
    port.synthesize_ids(stages['ids'], data_dir='valid', out_dir=str(tmp_path))
    for name in stages['ids']:
        with open(tmp_path / 'synth' / f'{name}.wav', 'rb') as f:
            got = f.read()
        with open(stages['base'] / 'jax' / 'synth' / f'{name}.wav', 'rb') as f:
            assert got == f.read(), name


def _capture(monkeypatch, module, calls):
    real = module.synthesize_batch

    def capture(f0, vuv, mcep, bap, seq_len, sample_rate, **kwargs):
        calls.append({'f0': np.array(f0), 'vuv': np.array(vuv), 'mcep': np.array(mcep),
                      'bap': np.array(bap), 'seq_len': np.array(seq_len),
                      'sample_rate': sample_rate, 'kwargs': kwargs})
        out = real(f0, vuv, mcep, bap, seq_len, sample_rate, **kwargs)
        calls[-1]['waves'] = np.array(out[0].cpu() if isinstance(out[0], torch.Tensor)
                                      else out[0])
        return out

    monkeypatch.setattr(module, 'synthesize_batch', capture)


def test_device_vocoder_inputs_equal_jax(stages, monkeypatch):
    """``device_vocoder=True`` on the same features (JAX's): one
    ``synthesize_batch`` call in each package with equal inputs, T the
    bucket of the longest utterance, on the acoustic engine's device; the
    port's waves are that call's, cut at n_frames * hop."""
    calls = {'jax': [], 'port': []}
    _capture(monkeypatch, jax_world, calls['jax'])
    _capture(monkeypatch, torch_world, calls['port'])
    features = {name: {k: np.asarray(v) for k, v in out.items() if k != 'wav'}
                for name, out in stages['results']['jax'].items()}
    jdev = jpipeline.TTSPipeline(stages['jax'].duration_engine, stages['jax'].acoustic_engine,
                                 device_vocoder=True)
    tdev = tpipeline.TTSPipeline(stages['port'].duration_engine, stages['port'].acoustic_engine,
                                 device_vocoder=True)
    got = {k: dict(v) for k, v in features.items()}
    jdev._synthesize_wavs_device({k: dict(v) for k, v in features.items()})
    tdev._synthesize_wavs_device(got)
    assert len(calls['jax']) == len(calls['port']) == 1
    want, port = calls['jax'][0], calls['port'][0]
    for key in ('f0', 'vuv', 'mcep', 'bap', 'seq_len'):
        np.testing.assert_array_equal(port[key], want[key], err_msg=key)
    assert port['sample_rate'] == want['sample_rate'] == 16000
    assert port['kwargs'] == {'device': torch.device('cpu')}
    assert port['f0'].shape[1] == bucket_size(max(port['seq_len']))
    for i, name in enumerate(features):
        assert got[name]['wav'].dtype == np.float32
        np.testing.assert_array_equal(got[name]['wav'],
                                      port['waves'][i, :port['seq_len'][i] * HOP])


def test_device_vocoder_pipeline_against_jax(stages, monkeypatch, tmp_path):
    """The whole port pipeline with ``device_vocoder=True``: its
    ``synthesize_batch`` inputs within the feature tolerances of JAX's
    whole pipeline's (f0 relative: it is exp(lf0)), lengths and T equal,
    vuv equal; every wav written, n_frames * hop samples, finite."""
    calls = {'jax': [], 'port': []}
    _capture(monkeypatch, jax_world, calls['jax'])
    _capture(monkeypatch, torch_world, calls['port'])
    ids = stages['ids']
    jpipeline.TTSPipeline(stages['jax'].duration_engine, stages['jax'].acoustic_engine,
                          device_vocoder=True).synthesize_ids(ids, data_dir='valid')
    results = tpipeline.TTSPipeline(stages['port'].duration_engine,
                                    stages['port'].acoustic_engine, device_vocoder=True) \
        .synthesize_ids(ids, data_dir='valid', out_dir=str(tmp_path))
    want, port = calls['jax'][0], calls['port'][0]
    np.testing.assert_array_equal(port['seq_len'], want['seq_len'])
    np.testing.assert_array_equal(port['vuv'], want['vuv'])
    assert port['f0'].shape == want['f0'].shape
    np.testing.assert_allclose(port['f0'], want['f0'], rtol=TRAJ_ATOL, atol=0)
    for key in ('mcep', 'bap'):
        np.testing.assert_allclose(port[key], want[key], atol=TRAJ_ATOL, rtol=0, err_msg=key)
    for name in ids:
        wav = file_io.load_wav(str(tmp_path / 'synth' / f'{name}.wav'))[0]
        assert wav.shape == (results[name]['n_frames'] * HOP,) and np.isfinite(wav).all()


def test_device_vocoder_trims_unequal_streams_like_the_host(stages):
    pipe = tpipeline.TTSPipeline(stages['port'].duration_engine, stages['port'].acoustic_engine,
                                 device_vocoder=True)
    rng = np.random.default_rng(0)
    results = {'utt': {'lf0': np.log(np.full((40, 1), 140.0, np.float32)),
                       'vuv': np.ones((40, 1), np.float32),
                       'mcep': rng.normal(scale=0.01, size=(37, 60)).astype(np.float32),
                       'bap': np.full((40, 5), -8.0, np.float32)}}
    pipe._synthesize_wavs_device(results)
    assert results['utt']['wav'].shape == (37 * HOP,) and np.isfinite(results['utt']['wav']).all()


def test_feature_only_model_gives_features_without_wavs(stages, tmp_path):
    """F0Model (lf0 only) as the acoustic stage: features and durations
    dumped, no synth/ directory, no wav; its audio stream is refused."""
    root = stages['root']
    jnn.manual_seed(63)
    ckpt = JF0().save_parameters(str(tmp_path / 'f0'), 0)
    pipe = tpipeline.TTSPipeline(stages['port'].duration_engine,
                                 TEngine(tf0.F0Model, ckpt, data_root=root, device='cpu'))
    results = pipe.synthesize_ids(_ids(root, 'test'), data_dir='test',
                                  out_dir=str(tmp_path / 'out'))
    for utt, out in results.items():
        assert 'wav' not in out and out['lf0'].shape[0] == out['n_frames']
        for key in ('lf0', 'dur'):
            assert os.path.exists(tmp_path / 'out' / 'feats' / key / f'{utt}.npy')
    assert not os.path.exists(tmp_path / 'out' / 'synth')
    with pytest.raises(ValueError, match='audio streaming needs'):
        pipe.stream_audio(_items(root, 'test')[0])


def test_incompatible_duration_model_fails_loudly(stages):
    """An acoustic model in the duration stage: no 'n_phones' source."""
    pipe = tpipeline.TTSPipeline(stages['port'].acoustic_engine, stages['port'].acoustic_engine)
    with pytest.raises(ValueError, match='n_phones'):
        pipe.predict_durations([{'name': 'x', 'lab': np.zeros((4, 600), np.float32)}])


def test_max_total_frames_caps_the_utterance(stages):
    items = _items(stages['root'], 'test')[:1]
    pipe = tpipeline.TTSPipeline(stages['port'].duration_engine, stages['port'].acoustic_engine,
                                 max_total_frames=32)
    want = jpipeline.TTSPipeline(stages['jax'].duration_engine, stages['jax'].acoustic_engine,
                                 max_total_frames=32).predict_durations(items)
    out = pipe.synthesize_items(items)[items[0]['name']]
    assert out['n_frames'] == 32 == int(out['dur'].sum())
    np.testing.assert_array_equal(out['dur'], want[items[0]['name']])


def test_stream_audio_from_labels(stages):
    """Labels -> predicted durations -> chunked acoustic stream -> audio:
    the durations of ``predict_durations``, n_frames * hop samples, some
    before the flush, and the streamed features within the streamed
    against batch tolerances of the pipeline's batch features."""
    item = _items(stages['root'], 'valid')[0]
    dur, gen = stages['port'].stream_audio(item, chunk_frames=16, context=32, lookahead=32)
    np.testing.assert_array_equal(dur, stages['results']['port'][item['name']]['dur'])
    pairs = list(gen)
    audio = np.concatenate([w for _, w in pairs])
    assert audio.shape == (int(dur.sum()) * HOP,) and np.isfinite(audio).all()
    assert any(w.shape[0] for _, w in pairs[:-1])
    batch = stages['results']['port'][item['name']]
    for key, atol in (('vuv', 1e-6), ('lf0', 1e-4), ('mcep', 1e-3), ('bap', 1e-3)):
        got = np.concatenate([c[key] for c, _ in pairs if c])
        np.testing.assert_allclose(got, batch[key], atol=atol, rtol=0, err_msg=key)


# ------------------------------------------------------------ the commands

def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get('PYTHONPATH', '').split(os.pathsep) if p]))


def _cli(stages, *flags):
    return ['--duration_model', 'morgana_tpu_torch.models.duration_model:DurationModel',
            '--duration_checkpoint', stages['dur_ckpt'],
            '--acoustic_model', 'morgana_tpu_torch.models.rnn_spss:LSTMAcousticModel',
            '--acoustic_checkpoint', stages['ac_ckpt'], '--data_root', stages['root'],
            '--duration_model_kwargs', repr(DUR_KWARGS),
            '--acoustic_model_kwargs', repr(AC_KWARGS), *flags]


@pytest.mark.parametrize('device_vocoder', [False, True], ids=['host', 'device'])
def test_pipeline_cli_writes_wavs_and_prints_stats(stages, device_vocoder):
    """``python -m morgana_tpu_torch.pipeline --device cpu`` over the test
    split (its conventional id list): one wav per utterance, the JAX
    command's stats keys, and with ``--evaluate_against`` the JAX
    evaluation's scores of the same dumped features."""
    out_dir = stages['base'] / f'cli_{device_vocoder}'
    ref_dir = os.path.join(stages['root'], 'test')
    proc = subprocess.run(
        [sys.executable, '-m', 'morgana_tpu_torch.pipeline',
         *_cli(stages, '--out_dir', str(out_dir), '--device', 'cpu', '--batch_size', '2',
               '--evaluate_against', ref_dir, *(['--device_vocoder'] if device_vocoder else []))],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=str(stages['base']))
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    ids = _ids(stages['root'], 'test')
    assert stats['utterances'] == stats['wavs'] == len(ids) and stats['out_dir'] == str(out_dir)
    assert sorted(stats) == ['evaluation', 'frames', 'frames_per_sec', 'out_dir', 'seconds',
                             'utterances', 'wavs']
    assert sorted(os.listdir(out_dir / 'synth')) == sorted(f'{u}.wav' for u in ids)
    want = jevaluate_dirs(ref_dir, str(out_dir / 'feats'), ids)
    assert sorted(stats['evaluation']) == sorted(want)
    for key, value in want.items():
        assert stats['evaluation'][key] == pytest.approx(value, rel=SCORE_RTOL), key


@pytest.mark.parametrize('flag', [['--data_parallel'], ['--compute_dtype', 'bfloat16']],
                         ids=['data_parallel', 'compute_dtype'])
def test_pipeline_cli_refuses_the_flags_it_lacks(stages, flag, capsys):
    """--data_parallel is an argparse error naming ROADMAP.md. --compute_dtype
    is ported now: 'bfloat16' runs both stages in bf16 (the process's
    compute dtype, set by the duration engine) and writes every wav; a dtype
    the port lacks (float16) is an argparse error naming ROADMAP.md."""
    from morgana_tpu_torch import nn as tnn
    if flag[0] == '--compute_dtype':
        out_dir = stages['base'] / 'bf16_cli'
        try:
            tpipeline.main(_cli(stages, *flag, '--device', 'cpu', '--out_dir', str(out_dir)))
            assert tnn.default_compute_dtype() is torch.bfloat16
        finally:
            tnn.set_default_compute_dtype(None)
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        ids = _ids(stages['root'], 'test')
        assert stats['utterances'] == stats['wavs'] == len(ids)
        assert sorted(os.listdir(out_dir / 'synth')) == sorted(f'{u}.wav' for u in ids)
        flag = [flag[0], 'float16']
    with pytest.raises(SystemExit) as exc:
        tpipeline.main(_cli(stages, *flag))
    err = capsys.readouterr().err
    assert exc.value.code == 2 and flag[0] in err and 'ROADMAP.md' in err


def test_pipeline_cli_needs_a_gpu_unless_asked_for_the_cpu(stages, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(DeviceError, match="device='cpu'"):
        tpipeline.main(_cli(stages, '--out_dir', str(stages['base'] / 'no_gpu')))


# ---------------------------------------------------------------- evaluate

@pytest.mark.parametrize('feats', [None, ['lf0', 'vuv'], ['mcep', 'bap', 'dur']],
                         ids=['default', 'lf0-vuv', 'mcep-bap-rmse'])
def test_evaluate_dirs_matches_jax(stages, feats):
    """The port's generated features against the validation split, as JAX
    scores them (a plain RMSE for 'dur', dumped by both)."""
    ref_dir = os.path.join(stages['root'], 'valid')
    gen_dir = str(stages['base'] / 'port' / 'feats')
    if feats and 'dur' in feats:
        ref_dir = str(stages['base'] / 'jax' / 'feats')
    got = tevaluate.evaluate_dirs(ref_dir, gen_dir, stages['ids'], feats=feats, device='cpu')
    want = jevaluate_dirs(ref_dir, gen_dir, stages['ids'], feats=feats)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=SCORE_RTOL, abs=1e-6), key


def test_evaluate_dirs_refuses_nothing_to_compare(stages, tmp_path):
    os.makedirs(tmp_path / 'a' / 'lab')
    os.makedirs(tmp_path / 'b' / 'lab')
    with pytest.raises(ValueError, match='no common scoreable'):
        tevaluate.evaluate_dirs(str(tmp_path / 'a'), str(tmp_path / 'b'), ['x'], device='cpu')
    with pytest.raises(ValueError, match='no comparable utterances'):
        tevaluate.evaluate_dirs(os.path.join(stages['root'], 'valid'),
                                str(stages['base'] / 'port' / 'feats'), ['missing'],
                                device='cpu')


def test_evaluate_cli_prints_the_scores(stages, capsys):
    ref_dir = os.path.join(stages['root'], 'valid')
    gen_dir = str(stages['base'] / 'port' / 'feats')
    tevaluate.main(['--ref_dir', ref_dir, '--gen_dir', gen_dir, '--device', 'cpu'])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == tevaluate.evaluate_dirs(ref_dir, gen_dir, stages['ids'], device='cpu')


@pytest.mark.parametrize('call', ['evaluate_dirs', 'main'])
def test_evaluate_needs_a_gpu_unless_asked_for_the_cpu(stages, monkeypatch, call):
    """Like every entry point of the port, the evaluation runs on ``cuda``
    unless the caller asks for the CPU: without a GPU the default is a
    ``DeviceError`` naming ``device='cpu'``."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    ref_dir = os.path.join(stages['root'], 'valid')
    gen_dir = str(stages['base'] / 'port' / 'feats')
    with pytest.raises(DeviceError, match="device='cpu'"):
        if call == 'main':
            tevaluate.main(['--ref_dir', ref_dir, '--gen_dir', gen_dir])
        else:
            tevaluate.evaluate_dirs(ref_dir, gen_dir, stages['ids'])
