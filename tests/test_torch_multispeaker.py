"""The port's multi-speaker path against the JAX package on the CPU: the
``speaker_id`` string source, the speaker-dependent normalisers, the
dataset's per-speaker normalisation and ``MultiSpeakerF0Model``, on one
synthetic corpus of three speakers (``generate_voice_data(speakers=...)``)
and the same seeded weights (carried by ``nn.load_jax_params``).

Tolerances: the normalisers and the dataset 1e-6 relative (the same f32
arithmetic); ``predict`` 1e-5 abs on the normalised lf0 and the lf0 (the GRU
layer's bar), the loss 1e-5 relative and every parameter's gradient within
1e-4 of its largest value; the two builders' train and valid loss and
RMSE_norm after an epoch within 1e-3 relative
(``tests/test_torch_gru_models.py``'s bar for whole runs)."""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import builder_args
from morgana_tpu import data as jdata
from morgana_tpu import nn as jnn
from morgana_tpu.experiment_builder import ExperimentBuilder as JBuilder
from morgana_tpu.training import numeric_features, staged_value_and_grad

from morgana_tpu_torch import data as tdata
from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch.data.synthetic import generate_voice_data
from morgana_tpu_torch.models import multispeaker_f0 as tms
from morgana_tpu_torch.training import TrainLoop as TLoop
from morgana_tpu_torch.training import build_optimizer as tbuild_optimizer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'models'))
try:
    from multispeaker_f0 import MultiSpeakerF0Model as JModel
finally:
    sys.path.pop(0)

SPEAKERS = ['spk_a', 'spk_b', 'spk_c']
RTOL = 1e-6
NET_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
TRAJ_RTOL = 1e-3
MODEL_KWARGS = {'hidden': 16}


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('speakers') / 'data')
    generate_voice_data(root, num_train=6, num_valid=3, num_test=2, seed=17, speakers=SPEAKERS)
    return root


def _write_params(root, kind, rng):
    """Per-speaker parameters of a 4-dim feature 'feat' in both layouts."""
    os.makedirs(os.path.join(root, 'norm'), exist_ok=True)
    with open(os.path.join(root, 'spk.scp'), 'w') as f:
        f.write('\n'.join(SPEAKERS))
    for speaker in SPEAKERS:
        os.makedirs(os.path.join(root, 'norm', speaker), exist_ok=True)
        for name in ('feat', 'feat_deltas'):
            low = rng.normal(size=4)
            params = ({'mean': low.tolist(), 'std_dev': rng.uniform(0.3, 2.0, 4).tolist()}
                      if kind == 'mvn' else
                      {'mmin': low.tolist(), 'mmax': (low + rng.uniform(0.5, 2, 4)).tolist()})
            with open(os.path.join(root, 'norm', speaker, f'{name}_{kind}.json'), 'w') as f:
                json.dump(params, f)


@pytest.mark.parametrize('kind', ['mvn', 'minmax'])
def test_speaker_normalisers_match_jax(tmp_path, kind):
    """One speaker's (T, D) feature, and a batch (B, T, D) with one speaker
    a row, normalised and denormalised (deltas too) by both packages; the
    port also on a tensor. An unknown speaker raises KeyError."""
    rng = np.random.default_rng(5)
    _write_params(str(tmp_path), kind, rng)
    cls = {'mvn': 'SpeakerDependentMeanVarianceNormaliser',
           'minmax': 'SpeakerDependentMinMaxNormaliser'}[kind]
    jnorm = getattr(jdata, cls)('feat', 'spk.scp', use_deltas=True)
    tnorm = getattr(tdata, cls)('feat', 'spk.scp', use_deltas=True)
    for norm in (jnorm, tnorm):
        norm.load_params('norm', str(tmp_path))
    one = rng.normal(size=(7, 4)).astype(np.float32)
    batch = rng.normal(size=(3, 7, 4)).astype(np.float32)
    ids = ['spk_c', 'spk_a', 'spk_c']
    for feature, speakers in ((one, 'spk_b'), (batch, ids), (batch, np.array(ids))):
        for deltas in (False, True):
            for op in ('normalise', 'denormalise'):
                want = np.asarray(getattr(jnorm, op)(feature, speakers, deltas=deltas))
                got = getattr(tnorm, op)(feature, speakers, deltas=deltas)
                np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=op)
                on_tensor = getattr(tnorm, op)(torch.from_numpy(feature), speakers, deltas=deltas)
                np.testing.assert_allclose(on_tensor.numpy(), want, rtol=RTOL, err_msg=op)
    with pytest.raises(KeyError, match='no parameters for speaker'):
        tnorm.normalise(one, 'spk_z')


def test_dataset_normalises_per_speaker_as_jax(corpus):
    """Each item of the multi-speaker model's training set: the same keys,
    the speaker id kept as a string (a host list after collate, left out of
    the device batch), and the per-speaker normalised lf0 of the JAX
    dataset. A speaker-dependent normaliser without a speaker_id source is
    refused."""
    jm, tm = JModel(**MODEL_KWARGS), tms.MultiSpeakerF0Model(**MODEL_KWARGS)
    datasets = []
    for model, package in ((jm, jdata), (tm, tdata)):
        normalisers = package.Normalisers(model.normaliser_sources(), 'train', corpus)
        datasets.append(package.FilesDataset(model.train_data_sources(), 'train',
                                             'train/train_file_id_list.scp', normalisers, corpus))
    jset, tset = datasets
    speakers = set()
    for i in range(len(tset)):
        want, got = jset[i], tset[i]
        assert sorted(got) == sorted(want)
        assert isinstance(got['speaker_id'], str) and got['speaker_id'] == want['speaker_id']
        speakers.add(got['speaker_id'])
        for key in ('normalised_lf0', 'normalised_counters', 'lf0'):
            np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=RTOL, err_msg=key)
    assert speakers == set(SPEAKERS)
    batch = tdata.collate([tset[i] for i in range(4)])
    assert batch['speaker_id'] == [tset[i]['speaker_id'] for i in range(4)]
    assert 'speaker_id' not in tdata.device_features(batch, 'cpu')
    sources = tm.train_data_sources()
    del sources['speaker_id']
    with pytest.raises(KeyError, match='speaker-dependent'):
        tdata.FilesDataset(sources, 'train', 'train/train_file_id_list.scp', tset.normalisers,
                           corpus)


def test_model_predict_loss_and_gradients_match_jax(corpus):
    """On four training utterances: predict with the collated speaker ids
    (the normalised lf0 and, denormalised per row on the host, the lf0),
    the loss, and the gradients of a train step against
    staged_value_and_grad, the JAX train step's."""
    jnn.manual_seed(23)
    jm, tm = JModel(**MODEL_KWARGS), tms.MultiSpeakerF0Model(**MODEL_KWARGS)
    tnn.load_jax_params(tm, jnn.state_dict(jm))
    for model, package in ((jm, jdata), (tm, tdata)):
        model.normalisers = package.Normalisers(model.normaliser_sources(), 'train', corpus)
        model.mode = 'train'
    dataset = tdata.FilesDataset(tm.train_data_sources(), 'train', 'train/train_file_id_list.scp',
                                 tm.normalisers, corpus)
    batch = tdata.collate([dataset[i] for i in range(4)])
    jbatch = dict(numeric_features(batch), global_step=jnp.asarray(0, jnp.int32))
    with jnn.bind(jm, jnn.parameters(jm)):
        want = jm.predict(dict(jbatch, speaker_id=batch['speaker_id']))
    tm.eval()
    with torch.no_grad():
        got = tm.predict(dict(tdata.device_features(batch, 'cpu'), speaker_id=batch['speaker_id']))
    assert sorted(got) == sorted(want) == ['lf0', 'normalised_lf0']
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), atol=NET_ATOL,
                                   err_msg=key)

    grad_fn = jax.jit(lambda p, b: staged_value_and_grad(jm, p, b, jax.random.PRNGKey(0)))
    jloss, _, _, want_g = grad_fn(jnn.parameters(jm), jbatch)
    tloss, _ = TLoop(tm, tbuild_optimizer('adam')).train_step(batch, 0.0)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for name, param in tm.named_parameters():
        want = np.asarray(want_g[name])
        np.testing.assert_allclose(param.grad.numpy() / np.abs(want).max(),
                                   want / np.abs(want).max(), atol=GRAD_RTOL, err_msg=name)


def test_builders_train_the_same_epochs(corpus, tmp_path):
    """Both builders train MultiSpeakerF0Model(hidden=16) for an epoch of
    B=2 from one epoch_0.npz on the speaker corpus, with validation: the
    train and valid loss and RMSE_norm within 1e-3 relative."""
    jnn.manual_seed(29)
    ckpt = JModel(**MODEL_KWARGS).save_parameters(str(tmp_path / 'init'), 0)
    args = builder_args(corpus, str(tmp_path / 'jax'), checkpoint_path=ckpt, batch_size=2,
                        learning_rate=0.01, model_kwargs=MODEL_KWARGS, end_epoch=1)
    JBuilder(JModel, experiment_name='jax', **args).run_experiment()
    tms.main(['--experiment_name', 'port', '--experiments_base', str(tmp_path / 'port'),
              '--data_root', corpus, '--train_id_list', 'train/train_file_id_list.scp',
              '--valid_id_list', 'valid/valid_file_id_list.scp', '--batch_size', '2',
              '--end_epoch', '1', '--learning_rate', '0.01', '--checkpoint_path', ckpt,
              '--model_kwargs', str(MODEL_KWARGS), '--device', 'cpu'])
    for mode in ('train', 'valid'):
        want, got = (json.load(open(tmp_path / exp / mode / 'epoch_1' / 'metrics.json'))
                     for exp in ('jax/jax', 'port/port'))
        for key in ('loss', 'RMSE_norm'):
            np.testing.assert_allclose(got[key], want[key], rtol=TRAJ_RTOL, err_msg=f'{mode} {key}')
