"""Generation through the port against the JAX package on the CPU: labels ->
network -> MLPG -> WORLD synthesis -> ``.wav``.

``InferenceEngine.generate`` of both packages serves one ``epoch_0.npz`` (a
seeded JAX model) of ``F0Model`` (full width) and of ``LSTMAcousticModel``
(2 x LSTM(32)) over the ``voice_data`` corpus's validation split at B=3 (a
batch of 3, then one of 1): the same wav files, each ``n_frames * hop``
samples long, whose energy and peak agree within ``RATIO_TOL`` = 1e-4
(tests/test_torch_vocoder.py: the predicted features differ in float32
rounding, so a glottal pulse may move by a sample; measured 1.1e-6 at
most). Given the JAX engine's features, the port writes the JAX engine's
wav files byte for byte (the same host vocoder). The builders (``--no-train
--valid --test`` from the checkpoint, the Transformer cut to 2 blocks) write
the same ``synth/*.wav`` at the same tolerances and accept the JAX package's
default intervals, and the serving command line writes the wavs and prints
its stats.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import builder_args
from morgana_tpu import nn as jnn
from morgana_tpu.experiment_builder import ExperimentBuilder as JBuilder
from morgana_tpu.serve import InferenceEngine as JEngine

from morgana_tpu_torch import serve as tserve
from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.device import DeviceError
from morgana_tpu_torch.experiment_builder import ExperimentBuilder as TBuilder
from morgana_tpu_torch.models import f0_test_model as tf0
from morgana_tpu_torch.models import rnn_spss as trnn
from morgana_tpu_torch.models import transformer_spss as ttransformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'models'))
try:
    from f0_test_model import F0Model as JF0
    from rnn_spss import LSTMAcousticModel as JLSTM
    from transformer_spss import TransformerAcousticModel as JTransformer
finally:
    sys.path.pop(0)

HOP = 80
RATIO_TOL = 1e-4
BATCH = 3
# name: (JAX model, port model, model_kwargs)
MODELS = {
    'f0': (JF0, tf0.F0Model, {}),
    'lstm': (JLSTM, trnn.LSTMAcousticModel, {'num_layers': 2, 'hidden_size': 32}),
    'transformer': (JTransformer, ttransformer.TransformerAcousticModel, {'num_layers': 2}),
}


def _ids(root, split):
    return file_io.get_file_ids(os.path.join(root, split, f'{split}_file_id_list.scp'))


def _checkpoint(name, base):
    jmodel, _, kwargs = MODELS[name]
    jnn.manual_seed(5)
    return jmodel(**kwargs).save_parameters(str(base / 'init'), 0)


def _wav(path):
    return file_io.load_wav(path)[0].astype(np.float64)


def _assert_same_wavs(got_dir, want_dir, ids, root, split):
    """One wav per id in each directory, n_frames * hop samples, energy and
    peak within RATIO_TOL."""
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir)) == \
        sorted(f'{utt}.wav' for utt in ids)
    for utt in ids:
        got, want = _wav(os.path.join(got_dir, f'{utt}.wav')), _wav(os.path.join(want_dir,
                                                                                  f'{utt}.wav'))
        n_frames = int(np.loadtxt(os.path.join(root, split, 'n_frames', f'{utt}.txt')))
        assert got.shape == want.shape == (n_frames * HOP,), utt
        energy = np.sqrt((got ** 2).mean() / (want ** 2).mean())
        peak = np.abs(got).max() / np.abs(want).max()
        assert abs(energy - 1) < RATIO_TOL and abs(peak - 1) < RATIO_TOL, (utt, energy, peak)


@pytest.fixture(scope='module', params=['f0', 'lstm'])
def served(request, voice_data, tmp_path_factory):
    """Both engines' generate over the validation split, from one seeded
    checkpoint."""
    name = request.param
    jmodel, tmodel, kwargs = MODELS[name]
    root = voice_data['data_root']
    base = tmp_path_factory.mktemp(f'generate_{name}')
    ckpt = _checkpoint(name, base)
    engines = {'jax': JEngine(jmodel, ckpt, data_root=root, device='cpu', batch_size=BATCH,
                              model_kwargs=kwargs),
               'port': tserve.InferenceEngine(tmodel, ckpt, data_root=root, device='cpu',
                                              batch_size=BATCH, model_kwargs=kwargs)}
    stats = {tag: engine.generate(str(base / tag), data_dir='valid',
                                  id_list='valid/valid_file_id_list.scp')
             for tag, engine in engines.items()}
    return {'name': name, 'root': root, 'base': base, 'ckpt': ckpt, 'engines': engines,
            'stats': stats, 'ids': _ids(root, 'valid')}


def test_generate_writes_the_jax_engines_wavs(served):
    """The same files, lengths n_frames * hop, energy and peak within
    RATIO_TOL."""
    _assert_same_wavs(str(served['base'] / 'port' / 'synth'),
                      str(served['base'] / 'jax' / 'synth'), served['ids'], served['root'],
                      'valid')


def test_generate_stats_count_the_names_served(served):
    """4 utterances in batches of 3 and 1: the names are counted, not the
    padded rows; the JAX engine's keys, and the split of the seconds."""
    want, got = served['stats']['jax'], served['stats']['port']
    assert got['utterances'] == want['utterances'] == len(served['ids']) == 4
    assert got['frames'] == want['frames'] > 0
    assert set(want) <= set(got) and got['out_dir'] == str(served['base'] / 'port')
    assert sorted(got['split_seconds']) == ['analysis', 'd2h', 'load', 'predict']
    assert 0 < sum(got['split_seconds'].values()) <= got['seconds'] + 1e-3


def test_port_synthesis_of_the_jax_features_is_bit_identical(served, monkeypatch):
    """The port's engine fed the JAX engine's predictions of each batch
    writes the JAX engine's wav files byte for byte."""
    jax_engine, port = served['engines']['jax'], served['engines']['port']

    def jax_predict(features):
        _, outputs = jax_engine.predict_batch(features)
        return {key: torch.from_numpy(np.array(value)) for key, value in outputs.items()}

    monkeypatch.setattr(port, 'predict_batch', jax_predict)
    out_dir = served['base'] / 'port_from_jax'
    port.generate(str(out_dir), data_dir='valid', id_list='valid/valid_file_id_list.scp')
    for utt in served['ids']:
        with open(out_dir / 'synth' / f'{utt}.wav', 'rb') as f:
            got = f.read()
        with open(served['base'] / 'jax' / 'synth' / f'{utt}.wav', 'rb') as f:
            assert got == f.read(), utt


def test_generate_takes_file_ids(served):
    port = served['engines']['port']
    out_dir = served['base'] / 'port_ids'
    stats = port.generate(str(out_dir), data_dir='valid', file_ids=served['ids'][1:3])
    assert stats['utterances'] == 2
    assert sorted(os.listdir(out_dir / 'synth')) == sorted(f'{u}.wav' for u in served['ids'][1:3])
    with pytest.raises(ValueError, match='id_list'):
        port.generate(str(out_dir), data_dir='valid')


def test_serving_cli_writes_wavs_and_prints_its_stats(served):
    """``python -m morgana_tpu_torch.serve --device cpu`` on the test split,
    whose id list follows the {data_dir}/{data_dir}_file_id_list.scp rule."""
    name = served['name']
    spec = f"{MODELS[name][1].__module__}:{MODELS[name][1].__name__}"
    out_dir = served['base'] / 'cli'
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get('PYTHONPATH', '').split(os.pathsep) if p]))
    proc = subprocess.run(
        [sys.executable, '-m', 'morgana_tpu_torch.serve', '--model', spec, '--checkpoint_path',
         served['ckpt'], '--data_root', served['root'], '--out_dir', str(out_dir),
         '--device', 'cpu', '--batch_size', '2', '--model_kwargs', repr(MODELS[name][2]),
         '--analysis_kwargs', "{'sample_rate': 16000}"],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(served['base']))
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    ids = _ids(served['root'], 'test')
    assert stats['utterances'] == len(ids) and stats['out_dir'] == str(out_dir)
    assert sorted(os.listdir(out_dir / 'synth')) == sorted(f'{u}.wav' for u in ids)


UNPORTED_FLAGS = [['--data_parallel'], ['--compute_dtype', 'bfloat16'],
                  ['--num_data_threads', '2'], ['--compilation_cache_dir', 'cache']]


@pytest.mark.parametrize('flag', UNPORTED_FLAGS, ids=[f[0][2:] for f in UNPORTED_FLAGS])
def test_serving_cli_refuses_the_flags_it_lacks(flag, capsys, monkeypatch, tmp_path):
    """Each flag the port lacks is an argparse error naming ROADMAP.md.
    --compilation_cache_dir, --compute_dtype and --num_data_threads are
    ported now: none is refused (the command then stops at its missing
    --id_list);
    --compilation_cache_dir names the directory where the kernels are built
    and found, and a compute dtype the port lacks (float16) is an argparse
    error naming ROADMAP.md."""
    from morgana_tpu_torch import _build
    monkeypatch.setattr(_build, 'BUILD_DIR', _build.BUILD_DIR)
    if flag[0] == '--compilation_cache_dir':
        flag = [flag[0], str(tmp_path / flag[1])]
    with pytest.raises(SystemExit) as exc:
        tserve.main(['--model', 'm:C', '--checkpoint_path', 'c.npz', *flag])
    err = capsys.readouterr().err
    if flag[0] in ('--compilation_cache_dir', '--compute_dtype', '--num_data_threads'):
        assert exc.value.code == 2 and 'not ported' not in err and '--id_list' in err
        if flag[0] == '--compilation_cache_dir':
            assert _build.BUILD_DIR == flag[1] and os.path.isdir(flag[1])
        elif flag[0] == '--compute_dtype':
            with pytest.raises(SystemExit) as exc:
                tserve.main(['--model', 'm:C', '--checkpoint_path', 'c.npz', flag[0], 'float16'])
            err = capsys.readouterr().err
            assert exc.value.code == 2 and flag[0] in err and 'ROADMAP.md' in err
        return
    assert exc.value.code == 2 and flag[0] in err and 'ROADMAP.md' in err


def test_serving_cli_needs_a_gpu_unless_asked_for_the_cpu(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    name = served['name']
    with pytest.raises(DeviceError, match="device='cpu'"):
        tserve.main(['--model', f"{MODELS[name][1].__module__}:{MODELS[name][1].__name__}",
                     '--checkpoint_path', served['ckpt'], '--data_root', served['root'],
                     '--model_kwargs', repr(MODELS[name][2])])


def test_load_model_class_takes_a_module_or_a_file():
    assert tserve.load_model_class('morgana_tpu_torch.models.f0_test_model:F0Model') \
        is tf0.F0Model
    cls = tserve.load_model_class(os.path.join(REPO, 'morgana_tpu_torch', 'models',
                                               'f0_test_model.py') + ':F0Model')
    assert cls.__name__ == 'F0Model'
    with pytest.raises(ValueError, match='module:Class'):
        tserve.load_model_class('morgana_tpu_torch.models.f0_test_model')


@pytest.mark.parametrize('name', list(MODELS))
def test_builder_valid_and_test_synthesise_as_jax(name, voice_data, tmp_path):
    """``--no-train --valid --test`` from the seeded checkpoint: both builders
    write valid/epoch_0/synth and test/epoch_0/synth with one wav per id,
    the same within RATIO_TOL, and test/epoch_0/metrics.json."""
    jmodel, tmodel, kwargs = MODELS[name]
    root = voice_data['data_root']
    ckpt = _checkpoint(name, tmp_path)
    args = builder_args(root, str(tmp_path / 'jax'), checkpoint_path=ckpt, train=False,
                        test=True, model_kwargs=dict(kwargs))
    jnn.manual_seed(args['seed'])
    JBuilder(jmodel, experiment_name='jax', **args).run_experiment()
    argv = ['--experiment_name', 'port', '--experiments_base', str(tmp_path / 'port'),
            '--data_root', root, '--valid_id_list', 'valid/valid_file_id_list.scp',
            '--test_id_list', 'test/test_file_id_list.scp', '--batch_size', '4',
            '--checkpoint_path', ckpt, '--no-train', '--test', '--device', 'cpu',
            '--model_kwargs', repr(kwargs)]
    TBuilder(tmodel, **TBuilder.get_experiment_args(argv)).run_experiment()
    for split in ('valid', 'test'):
        _assert_same_wavs(str(tmp_path / 'port' / 'port' / split / 'epoch_0' / 'synth'),
                          str(tmp_path / 'jax' / 'jax' / split / 'epoch_0' / 'synth'),
                          _ids(root, split), root, split)
    assert os.path.exists(tmp_path / 'port' / 'port' / 'test' / 'epoch_0' / 'metrics.json')


@pytest.mark.parametrize('name', list(MODELS))
def test_builder_accepts_the_jax_defaults(name, voice_data, tmp_path):
    """--end_epoch 50 with the default --valid_output_interval 10 and
    --test_output_interval 10: the builder of each acoustic model is made
    (it refused these settings while the vocoder was unported) and carries
    the default analysis_kwargs."""
    _, tmodel, kwargs = MODELS[name]
    argv = ['--experiment_name', 'defaults', '--experiments_base', str(tmp_path),
            '--data_root', voice_data['data_root'],
            '--train_id_list', 'train/train_file_id_list.scp',
            '--valid_id_list', 'valid/valid_file_id_list.scp',
            '--test_id_list', 'test/test_file_id_list.scp', '--test', '--end_epoch', '50',
            '--device', 'cpu', '--model_kwargs', repr(kwargs)]
    exp = TBuilder(tmodel, **TBuilder.get_experiment_args(argv))
    assert (exp.valid_output_interval, exp.test_output_interval) == (10, 10)
    assert exp.analysis_kwargs == {'sample_rate': 16000}
    assert len(exp.test_loader) == 1
