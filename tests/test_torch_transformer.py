"""The port's TransformerAcousticModel against the JAX package on the CPU, on
the ``voice_data`` corpus.

Tolerances and why:
* full-width ``predict`` and ``InferenceEngine.predict_ids`` (609 -> 384, 6
  blocks of 4 heads of 96, d_ff 1536, 199 outputs) from one
  ``epoch_{N}.npz``: the network outputs within 1e-4 abs (six f32 blocks of
  384-wide sums in another order), the MLPG trajectories within 1e-3 of
  each output's max |value| (an f32 banded Cholesky over T + 200 frames on
  both sides, fed by those outputs);
* both builders train a cut model (2 blocks, d_model 384, 4 heads) for 2
  epochs of B=4 from the same ``epoch_0.npz`` at lr 0.001: every per-epoch
  train and valid metric within 1e-3 relative (f32 Adam steps on both sides
  from the same weights and data).
"""
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

from morgana_tpu_torch import checkpointing
from morgana_tpu_torch import data as tdata
from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch.data import device_features
from morgana_tpu_torch.device import DeviceError
from morgana_tpu_torch.experiment_builder import ExperimentBuilder as TBuilder
from morgana_tpu_torch.models import transformer_spss as ttransformer
from morgana_tpu_torch.serve import InferenceEngine as TEngine

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'models'))
try:
    from transformer_spss import TransformerAcousticModel as JModel
finally:
    sys.path.pop(0)

TModel = ttransformer.TransformerAcousticModel
NET_ATOL = 1e-4
TRAJ_RTOL = 1e-3
METRIC_RTOL = 1e-3
CUT = {'num_layers': 2}
NET_KEYS = ('normalised_lf0_deltas', 'normalised_mcep_deltas', 'normalised_bap_deltas', 'vuv')
TRAJ_KEYS = ('lf0', 'mcep', 'bap')
TIMING_KEYS = ('epoch_duration_s', 'ms_per_step', 'frames_per_sec')


@pytest.fixture(scope='module')
def full_width(voice_data, tmp_path_factory):
    """A seeded full-width JAX model saved as epoch_1.npz."""
    base = tmp_path_factory.mktemp('transformer_full')
    jnn.manual_seed(31)
    return JModel().save_parameters(str(base), 1)


def _port_argv(data_root, experiments_base, ckpt, *flags):
    return ['--experiment_name', 'port', '--experiments_base', experiments_base,
            '--data_root', data_root, '--train_id_list', 'train/train_file_id_list.scp',
            '--valid_id_list', 'valid/valid_file_id_list.scp', '--batch_size', '4',
            '--end_epoch', '2', '--learning_rate', '0.001', '--checkpoint_path', ckpt,
            '--model_kwargs', repr(CUT), *flags]


@pytest.fixture(scope='module')
def trained(voice_data, tmp_path_factory):
    """The cut model trained by both builders, 2 epochs each from the same
    init and data."""
    root = voice_data['data_root']
    base = tmp_path_factory.mktemp('transformer_trained')
    jnn.manual_seed(32)
    ckpt = JModel(**CUT).save_parameters(str(base / 'init'), 0)
    args = builder_args(root, str(base / 'jax'), checkpoint_path=ckpt, learning_rate=0.001,
                        model_kwargs=dict(CUT))
    jnn.manual_seed(args['seed'])
    JBuilder(JModel, experiment_name='jax', **args).run_experiment()
    ttransformer.main(_port_argv(root, str(base / 'port'), ckpt, '--device', 'cpu'))
    return {'root': root, 'ckpt': ckpt, 'base': base, 'jax': str(base / 'jax' / 'jax'),
            'port': str(base / 'port' / 'port')}


def _metrics(exp_dir, mode, epoch):
    with open(os.path.join(exp_dir, mode, f'epoch_{epoch}', 'metrics.json')) as f:
        return json.load(f)


@pytest.mark.parametrize('mode,epoch', [('train', 1), ('train', 2), ('valid', 1), ('valid', 2)])
def test_trainer_trajectory_matches_jax(trained, mode, epoch):
    """The loss and the four metrics of each epoch within 1e-3 relative; the
    train files also carry the epoch's timing."""
    want, got = _metrics(trained['jax'], mode, epoch), _metrics(trained['port'], mode, epoch)
    assert sorted(got) == sorted(want)
    for key in want:
        if key in TIMING_KEYS:
            assert got[key] > 0
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL, err_msg=key)


def _assert_outputs_close(got, want, name=''):
    assert sorted(got) == sorted(want) == sorted(NET_KEYS + TRAJ_KEYS)
    for key in NET_KEYS:
        np.testing.assert_allclose(got[key], want[key], atol=NET_ATOL, err_msg=f'{name} {key}')
    for key in TRAJ_KEYS:
        scale = max(float(np.abs(want[key]).max()), 1.0)
        np.testing.assert_allclose(got[key] / scale, want[key] / scale, atol=TRAJ_RTOL,
                                   err_msg=f'{name} {key}')


def test_full_width_predict_matches_jax(voice_data, full_width):
    """Both models at the published defaults from one epoch_1.npz, on one
    collated valid batch of the port's pipeline; padded frames are compared
    too, as both sides zero or mask them alike."""
    root = voice_data['data_root']
    jmodel, tmodel = JModel(), TModel()
    jmodel.load_parameters(full_width)
    tmodel.load_parameters(full_width)
    for model in (jmodel, tmodel):
        model.normalisers = model.normaliser_sources()
        for normaliser in model.normalisers.values():
            normaliser.load_params('train', root)
    dataset = tdata.FilesDataset(tmodel.valid_data_sources(), 'valid',
                                 'valid/valid_file_id_list.scp', tmodel.normalisers, root)
    batch = tdata.collate([dataset[i] for i in range(len(dataset))])
    tmodel.eval()
    with torch.no_grad():
        got = tmodel.predict(device_features(batch, torch.device('cpu')))
    want = jmodel.predict({k: jnp.asarray(v) for k, v in batch.items()
                           if isinstance(v, np.ndarray)})
    mask = (np.arange(batch['normalised_counters'].shape[1])[None, :]
            < batch['n_frames'].reshape(-1, 1))[..., None]
    _assert_outputs_close({k: v.numpy() * mask for k, v in got.items()},
                          {k: np.asarray(v) * mask for k, v in want.items()})


def test_full_width_predict_ids_matches_the_jax_engine(voice_data, full_width):
    """Both InferenceEngines serve epoch_1.npz at full width on the test
    split: the same utterances, keys and shapes, each output within its
    tolerance."""
    root = voice_data['data_root']
    engines = [cls(model, full_width, data_root=root, device='cpu', batch_size=2)
               for cls, model in ((JEngine, JModel), (TEngine, TModel))]
    with open(os.path.join(root, 'test', 'test_file_id_list.scp')) as f:
        ids = f.read().split()
    want, got = (engine.predict_ids(ids) for engine in engines)
    assert sorted(got) == sorted(want) == sorted(ids)
    for name in ids:
        w = {k: np.asarray(v) for k, v in want[name].items()}
        for key in w:
            assert got[name][key].shape == w[key].shape, (name, key)
        _assert_outputs_close(got[name], w, name)


def test_checkpoints_cross_in_both_directions(trained, full_width, tmp_path):
    """The port's trained epoch_N.npz loads strictly into the JAX model; a
    JAX epoch_N.npz loads into the port and the port writes it back with
    the same names, shapes and values."""
    for epoch in (1, 2):
        JModel(**CUT).load_parameters(
            os.path.join(trained['port'], 'checkpoints', f'epoch_{epoch}.npz'))
    model = TModel()
    model.load_parameters(full_width)
    back = model.save_parameters(str(tmp_path), 3)
    want, got = checkpointing.load_state_dict(full_width), checkpointing.load_state_dict(back)
    assert sorted(got) == sorted(want) and len(want) == 78
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    JModel().load_parameters(back)
    assert want['layers.2.blocks.items.5.ffn_in.weight'].shape == (384, 1536)
    with pytest.raises(KeyError, match='mismatch'):
        tnn.load_jax_params(TModel(**CUT), want)


@pytest.mark.parametrize('kwargs', [{'pipeline_stages': 2},
                                    {'moe_experts': 8, 'expert_parallel': True},
                                    {'expert_parallel': True}, {'sequence_parallel': 2},
                                    {'remat': True}],
                         ids=['pipeline', 'moe', 'expert_parallel', 'sequence_parallel', 'remat'])
def test_unported_options_raise(kwargs):
    """The parallel options raise NotImplementedError naming ROADMAP.md;
    ``remat`` is ported: every block of the encoder is checkpointed, and a
    train step's loss and gradients equal those without it."""
    if 'remat' not in kwargs:
        with pytest.raises(NotImplementedError, match='not ported yet'):
            TModel(**CUT, **kwargs)
        return
    rng = np.random.default_rng(4)
    batch = {'normalised_lab': torch.from_numpy(rng.normal(size=(2, 5, 600)).astype(np.float32)),
             'dur': torch.tensor([[3, 4, 2, 1, 0], [2, 2, 2, 2, 2]]),
             'normalised_counters': torch.from_numpy(
                 rng.normal(size=(2, 10, 9)).astype(np.float32)),
             'n_frames': torch.tensor([10, 10])}
    grads = []
    for remat in (None, True):
        torch.manual_seed(0)
        model = TModel(**CUT, **dict(kwargs, remat=remat))
        x = model.stream_inputs(batch)
        y = model.layers(x, seq_len=batch['n_frames'])
        grads.append(torch.autograd.grad(y.square().sum(), list(model.parameters())))
    assert [m.remat for m in model.modules() if isinstance(m, tnn.TransformerEncoder)] == [True]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_unported_paths_raise():
    """Cross-attention, the expert parallelism of MoE blocks (a mesh; the
    blocks themselves are ported, tests/test_torch_moe.py) and sharded
    activations raise NotImplementedError naming ROADMAP.md. The KV-cache
    stream of the causal configuration (window 256) is ported: its step
    runs and carries the caches (held to JAX in
    tests/test_torch_streaming.py)."""
    model = TModel(**CUT, causal=True)
    assert model.attention_window == 256
    encoder = getattr(model.layers, '2')
    assert encoder.window == 256 and encoder.causal
    x = torch.zeros(1, 3, 384)
    calls = [lambda: encoder.blocks[0].attn(x, kv=x),
             lambda: tnn.TransformerEncoderLayer(384, 4, 1536,
                                                 moe={'num_experts': 2, 'mesh': object()}),
             lambda: tnn.TransformerEncoder(1, 384, 4, 1536, activation_sharding=object())]
    for call in calls:
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            call()
    with torch.no_grad():
        y, state = encoder.step(x, None)
    assert y.shape == (1, 3, 384) and state['pos'] == 3
    assert [k.shape for k, _ in state['caches']] == [(1, 256, 384)] * CUT['num_layers']


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(trained, monkeypatch):
    """The model's CLI defaults to --device cuda and raises DeviceError
    without a GPU; --device cpu is what the fixture trained with."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    argv = _port_argv(trained['root'], str(trained['base'] / 'nogpu'), trained['ckpt'])
    assert TBuilder.get_experiment_args(argv)['device'] == 'cuda'
    with pytest.raises(DeviceError, match="device='cpu'"):
        ttransformer.main(argv)
