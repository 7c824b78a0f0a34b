"""The port's GRU models against the JAX package on the CPU, at full width:
``F0Model`` (609 -> 256, 3 x GRU(64), 3 outputs, single-stream MLPG) and
``DurationModel`` (600 -> 128, GRU(128), 1 output, at the phone rate), on the
``voice_data`` corpus.

From one ``epoch_{N}.npz``, ``predict`` and ``InferenceEngine.predict_ids``
agree with the JAX model: the network outputs within 1e-5 abs (the bar of
the GRU layer), F0Model's lf0 trajectory within 5e-5 abs (both sides solve
an f32 banded Cholesky over T + 200 frames) and DurationModel's durations,
in frames, within 1e-4 abs (the normalised output times the dur std_dev).
Both builders train each model for 2 epochs of B=4 from the same
``epoch_0.npz``: every per-epoch train and valid metric within 1e-3
relative (measured on the CPU: at most 1.2e-6 for F0Model and 5.7e-6 for
DurationModel), and DurationModel's validation analysis writes the same
``feats/dur/*.npy``, within the same 1e-3 (measured 1.3e-6)."""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import builder_args
from morgana_tpu import nn as jnn
from morgana_tpu.experiment_builder import ExperimentBuilder as JBuilder
from morgana_tpu.serve import InferenceEngine as JEngine

from morgana_tpu_torch import data as tdata
from morgana_tpu_torch.data import device_features
from morgana_tpu_torch.device import DeviceError
from morgana_tpu_torch.experiment_builder import ExperimentBuilder as TBuilder
from morgana_tpu_torch.models import duration_model as tduration
from morgana_tpu_torch.models import f0_test_model as tf0
from morgana_tpu_torch.serve import InferenceEngine as TEngine

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'models'))
try:
    from duration_model import DurationModel as JDuration
    from f0_test_model import F0Model as JF0
finally:
    sys.path.pop(0)

NET_ATOL = 1e-5
TRAJ_ATOL = 5e-5
DUR_ATOL = 1e-4
TRAJ_RTOL = 1e-3
TIMING_KEYS = ('epoch_duration_s', 'ms_per_step', 'frames_per_sec')

# name: (JAX model, port module, port model, its outputs with their tolerance)
MODELS = {
    'f0': (JF0, tf0, tf0.F0Model, {'normalised_lf0_deltas': NET_ATOL, 'lf0': TRAJ_ATOL}),
    'duration': (JDuration, tduration, tduration.DurationModel,
                 {'normalised_dur': NET_ATOL, 'dur': DUR_ATOL}),
}


def _port_argv(data_root, experiments_base, ckpt, *flags):
    return ['--experiment_name', 'port', '--experiments_base', experiments_base,
            '--data_root', data_root, '--train_id_list', 'train/train_file_id_list.scp',
            '--valid_id_list', 'valid/valid_file_id_list.scp', '--batch_size', '4',
            '--end_epoch', '2', '--learning_rate', '0.01', '--checkpoint_path', ckpt, *flags]


@pytest.fixture(scope='module', params=list(MODELS))
def trained(request, voice_data, tmp_path_factory):
    """One model's two builders, 2 epochs each from the same init and data;
    the duration model writes its validation analysis every epoch."""
    name = request.param
    jmodel, tmodule, tmodel, outputs = MODELS[name]
    root = voice_data['data_root']
    base = tmp_path_factory.mktemp(f'trained_{name}')
    jnn.manual_seed(5)
    ckpt = jmodel().save_parameters(str(base / 'init'), 0)
    interval = 1 if name == 'duration' else 10

    args = builder_args(root, str(base / 'jax'), checkpoint_path=ckpt, learning_rate=0.01,
                        valid_output_interval=interval)
    jnn.manual_seed(args['seed'])
    JBuilder(jmodel, experiment_name='jax', **args).run_experiment()

    tmodule.main(_port_argv(root, str(base / 'port'), ckpt, '--device', 'cpu',
                            '--valid_output_interval', str(interval)))
    return {'name': name, 'root': root, 'ckpt': ckpt, 'base': base, 'jax_model': jmodel,
            'port_module': tmodule, 'port_model': tmodel, 'outputs': outputs,
            'jax': str(base / 'jax' / 'jax'), 'port': str(base / 'port' / 'port')}


def _metrics(exp_dir, mode, epoch):
    with open(os.path.join(exp_dir, mode, f'epoch_{epoch}', 'metrics.json')) as f:
        return json.load(f)


@pytest.mark.parametrize('mode,epoch', [('train', 1), ('train', 2), ('valid', 1), ('valid', 2)])
def test_trainer_trajectory_matches_jax(trained, mode, epoch):
    """The loss and the model's metric of each epoch within 1e-3 relative;
    the train files also carry the epoch's timing."""
    want, got = _metrics(trained['jax'], mode, epoch), _metrics(trained['port'], mode, epoch)
    assert sorted(got) == sorted(want)
    for key in want:
        if key in TIMING_KEYS:
            assert got[key] > 0
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=TRAJ_RTOL, err_msg=key)


def test_predict_matches_jax(trained):
    """The port's trained epoch_2.npz in both models, on one collated valid
    batch of the port's pipeline: every output within its tolerance."""
    ckpt = os.path.join(trained['port'], 'checkpoints', 'epoch_2.npz')
    root = trained['root']
    jmodel, tmodel = trained['jax_model'](), trained['port_model']()
    jmodel.load_parameters(ckpt)
    tmodel.load_parameters(ckpt)
    for model in (jmodel, tmodel):
        model.normalisers = model.normaliser_sources()
        for normaliser in model.normalisers.values():
            normaliser.load_params('train', root)
    dataset = tdata.FilesDataset(tmodel.valid_data_sources(), 'valid',
                                 'valid/valid_file_id_list.scp', tmodel.normalisers, root)
    batch = tdata.collate([dataset[i] for i in range(len(dataset))])
    with torch.no_grad():
        got = tmodel.predict(device_features(batch, torch.device('cpu')))
    want = jmodel.predict({k: jnp.asarray(v) for k, v in batch.items()
                           if isinstance(v, np.ndarray)})
    assert sorted(got) == sorted(want) == sorted(trained['outputs'])
    for key, atol in trained['outputs'].items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=atol, err_msg=key)


def test_predict_ids_matches_the_jax_engine(trained):
    """Both InferenceEngines serve the port's epoch_2.npz on the test split:
    the same utterances, keys and shapes, each output within its
    tolerance."""
    ckpt = os.path.join(trained['port'], 'checkpoints', 'epoch_2.npz')
    engines = [cls(model, ckpt, data_root=trained['root'], device='cpu', batch_size=2)
               for cls, model in ((JEngine, trained['jax_model']),
                                  (TEngine, trained['port_model']))]
    with open(os.path.join(trained['root'], 'test', 'test_file_id_list.scp')) as f:
        ids = f.read().split()
    want, got = (engine.predict_ids(ids) for engine in engines)
    assert sorted(got) == sorted(want) == sorted(ids)
    for name in ids:
        assert sorted(got[name]) == sorted(trained['outputs'])
        for key, atol in trained['outputs'].items():
            w = np.asarray(want[name][key])
            assert got[name][key].shape == w.shape, (name, key)
            np.testing.assert_allclose(got[name][key], w, atol=atol, err_msg=f'{name} {key}')


def test_port_checkpoint_loads_into_the_jax_model(trained):
    """The port's checkpoints hold the JAX names and shapes, strictly."""
    for epoch in (1, 2):
        ckpt = os.path.join(trained['port'], 'checkpoints', f'epoch_{epoch}.npz')
        trained['jax_model']().load_parameters(ckpt)
    assert os.path.exists(os.path.join(trained['port'], 'config.json'))


def test_validation_analysis_or_its_refusal(trained):
    """DurationModel's analysis writes feats/dur/{utt}.npy each epoch, equal
    to the JAX builder's within 1e-3 relative, and its default validation
    settings (--valid_output_interval 10 with --end_epoch 50) are accepted.
    F0Model synthesises wavs there, so the default argv is refused when the
    builder is made."""
    argv = _port_argv(trained['root'], str(trained['base'] / 'defaults'), trained['ckpt'],
                      '--device', 'cpu', '--end_epoch', '50')
    args = TBuilder.get_experiment_args(argv)
    assert args['valid_output_interval'] == 10
    if trained['name'] == 'f0':
        with pytest.raises(ValueError, match='vocoder'):
            TBuilder(trained['port_model'], **args)
        return
    TBuilder(trained['port_model'], **args)
    with open(os.path.join(trained['root'], 'valid', 'valid_file_id_list.scp')) as f:
        ids = f.read().split()
    for epoch in (1, 2):
        subdir = os.path.join('valid', f'epoch_{epoch}', 'feats', 'dur')
        assert sorted(os.listdir(os.path.join(trained['port'], subdir))) == \
            sorted(f'{utt}.npy' for utt in ids)
        for utt in ids:
            got = np.load(os.path.join(trained['port'], subdir, f'{utt}.npy'))
            want = np.load(os.path.join(trained['jax'], subdir, f'{utt}.npy'))
            n_phones = int(np.loadtxt(os.path.join(trained['root'], 'valid', 'n_phones',
                                                   f'{utt}.txt')))
            assert got.shape == want.shape == (n_phones,)
            np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(trained, monkeypatch):
    """The model's CLI defaults to --device cuda and raises DeviceError
    without a GPU; --device cpu is what the fixture trained with."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    argv = _port_argv(trained['root'], str(trained['base'] / 'nogpu'), trained['ckpt'],
                      '--valid_output_interval', '51')
    assert TBuilder.get_experiment_args(argv)['device'] == 'cuda'
    with pytest.raises(DeviceError, match="device='cpu'"):
        trained['port_module'].main(argv)


def test_resume_from_a_jax_checkpoint_keeps_its_training_state(trained):
    """Both builders resume epoch 2 from the JAX builder's epoch_1.npz and its
    epoch_1.train.pkl sidecar (Adam's moments and count, the step count and
    the LR-schedule state): every epoch-2 train and valid metric within 1e-3
    relative. Restarting Adam instead moves the F0 train loss by 8.2e-2."""
    interval = 1 if trained['name'] == 'duration' else 10
    ckpt = os.path.join(trained['jax'], 'checkpoints', 'epoch_1.npz')
    assert os.path.exists(ckpt[:-len('.npz')] + '.train.pkl')
    base, root = trained['base'], trained['root']
    args = builder_args(root, str(base / 'jax_resume'), checkpoint_path=ckpt, learning_rate=0.01,
                        start_epoch=2, valid_output_interval=interval)
    jnn.manual_seed(args['seed'])
    JBuilder(trained['jax_model'], experiment_name='jax', **args).run_experiment()
    trained['port_module'].main(_port_argv(
        root, str(base / 'port_resume'), ckpt, '--device', 'cpu', '--start_epoch', '2',
        '--valid_output_interval', str(interval)))
    for mode in ('train', 'valid'):
        want = _metrics(str(base / 'jax_resume' / 'jax'), mode, 2)
        got = _metrics(str(base / 'port_resume' / 'port'), mode, 2)
        assert sorted(got) == sorted(want)
        for key in set(want) - set(TIMING_KEYS):
            np.testing.assert_allclose(got[key], want[key], rtol=TRAJ_RTOL, err_msg=f'{mode} {key}')
