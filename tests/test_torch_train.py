"""The port's training slice against the JAX package on the CPU: the JAX
``ExperimentBuilder`` and the port's train ``LSTMAcousticModel(num_layers=2,
hidden_size=64)`` from one ``epoch_0.npz`` on the ``voice_data`` corpus (B=4,
2 epochs, validation). Their per-epoch train and valid metrics.json values
agree within 1e-3 relative (measured 8.1e-6 on the CPU), the port's
``epoch_2.npz`` serves through the JAX engine as through the port's at the
tolerances of tests/test_torch_slice.py, and MLPG stays off the autograd
graph. The builder's dropout and EMA paths are checked on a 1 x LSTM(16)."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from conftest import builder_args
from morgana_tpu import nn as jnn
from morgana_tpu.experiment_builder import ExperimentBuilder as JBuilder
from morgana_tpu.serve import InferenceEngine as JEngine

from morgana_tpu_torch import losses
from morgana_tpu_torch.device import DeviceError
from morgana_tpu_torch.experiment_builder import ExperimentBuilder as TBuilder
from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel as TModel
from morgana_tpu_torch.models.rnn_spss import main as tmain
from morgana_tpu_torch.serve import InferenceEngine as TEngine
from morgana_tpu_torch.data import device_features

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'models'))
try:
    from rnn_spss import LSTMAcousticModel as JModel
finally:
    sys.path.pop(0)

MODEL_KWARGS = {'num_layers': 2, 'hidden_size': 64}
TRAJ_RTOL = 1e-3
NET_ATOL = 1e-5
TRAJ_ATOL = 5e-5
TIMING_KEYS = ('epoch_duration_s', 'ms_per_step', 'frames_per_sec')


def _port_argv(data_root, experiments_base, ckpt, *flags):
    return ['--experiment_name', 'port', '--experiments_base', experiments_base,
            '--data_root', data_root, '--train_id_list', 'train/train_file_id_list.scp',
            '--valid_id_list', 'valid/valid_file_id_list.scp', '--batch_size', '4',
            '--end_epoch', '2', '--learning_rate', '0.01', '--model_kwargs', str(MODEL_KWARGS),
            '--checkpoint_path', ckpt, *flags]


@pytest.fixture(scope='module')
def trained(voice_data, tmp_path_factory):
    """Both builders, 2 epochs each from the same init and data."""
    root = voice_data['data_root']
    base = tmp_path_factory.mktemp('trained')
    jnn.manual_seed(5)
    ckpt = JModel(**MODEL_KWARGS).save_parameters(str(base / 'init'), 0)

    args = builder_args(root, str(base / 'jax'), model_kwargs=MODEL_KWARGS, checkpoint_path=ckpt,
                        learning_rate=0.01)
    jnn.manual_seed(args['seed'])
    JBuilder(JModel, experiment_name='jax', **args).run_experiment()

    tmain(_port_argv(root, str(base / 'port'), ckpt, '--device', 'cpu'))
    return {'root': root, 'ckpt': ckpt, 'jax': str(base / 'jax' / 'jax'),
            'port': str(base / 'port' / 'port'), 'base': base}


def _metrics(exp_dir, mode, epoch):
    with open(os.path.join(exp_dir, mode, f'epoch_{epoch}', 'metrics.json')) as f:
        return json.load(f)


@pytest.mark.parametrize('mode,epoch', [('train', 1), ('train', 2), ('valid', 1), ('valid', 2)])
def test_trainer_trajectory_matches_jax(trained, mode, epoch):
    """Loss, LF0 RMSE, VUV accuracy, MCEP and BAP distortion of each epoch;
    the train files also carry the epoch's timing."""
    want, got = _metrics(trained['jax'], mode, epoch), _metrics(trained['port'], mode, epoch)
    assert sorted(got) == sorted(want)
    for key in want:
        if key in TIMING_KEYS:
            assert got[key] > 0
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=TRAJ_RTOL, err_msg=key)


def test_outputs_keep_the_jax_layout(trained):
    for name in ('config.json', 'model_summary.txt', 'checkpoints/epoch_1.npz',
                 'checkpoints/epoch_2.npz'):
        assert os.path.exists(os.path.join(trained['port'], name)), name
    assert os.listdir(os.path.join(trained['port'], 'log'))
    with open(os.path.join(trained['port'], 'config.json')) as f:
        config = json.load(f)
    assert config['batch_size'] == 4 and config['device'] == 'cpu'
    assert config['model_kwargs'] == MODEL_KWARGS


def test_port_checkpoint_serves_identically_through_the_jax_engine(trained):
    """The port's epoch_2.npz, loaded by the JAX engine as its own, gives the
    port engine's outputs: 1e-5 abs on the network outputs, 5e-5 abs on the
    trajectories."""
    ckpt = os.path.join(trained['port'], 'checkpoints', 'epoch_2.npz')
    engines = [cls(model, ckpt, data_root=trained['root'], model_kwargs=MODEL_KWARGS,
                   device='cpu', batch_size=2)
               for cls, model in ((JEngine, JModel), (TEngine, TModel))]
    with open(os.path.join(trained['root'], 'test', 'test_file_id_list.scp')) as f:
        ids = f.read().split()
    want, got = (engine.predict_ids(ids) for engine in engines)
    for name in ids:
        for key, value in want[name].items():
            atol = TRAJ_ATOL if key in ('lf0', 'mcep', 'bap') else NET_ATOL
            np.testing.assert_allclose(got[name][key], np.asarray(value), atol=atol,
                                       err_msg=f'{name} {key}')


def test_mlpg_is_cut_from_the_gradient(trained):
    """After loss.backward() on a train batch the trajectories are off the
    graph, and the gradients equal those of a loss that never reads them."""
    args = TBuilder.get_experiment_args(_port_argv(
        trained['root'], str(trained['base'] / 'detach'), trained['ckpt'], '--device', 'cpu'))
    exp = TBuilder(TModel, **args)
    model = exp.model
    model.mode = 'train'
    batch = device_features(next(iter(exp.train_loader)), torch.device('cpu'))

    loss, outputs = model(batch)
    loss.backward()
    for key in ('lf0', 'mcep', 'bap'):
        assert not outputs[key].requires_grad
        assert outputs[key].grad_fn is None
    with_mlpg = {n: p.grad.clone() for n, p in model.named_parameters()}

    model.zero_grad()
    n_frames = batch['n_frames']
    heads = model._split_heads(model.layers(model.stream_inputs(batch), seq_len=n_frames))
    plain_loss = (losses.mse(heads[0], batch['normalised_lf0_deltas'], n_frames)
                  + losses.mse(heads[2], batch['normalised_mcep_deltas'], n_frames)
                  + losses.mse(heads[3], batch['normalised_bap_deltas'], n_frames)
                  + losses.bce(torch.sigmoid(heads[1]), batch['vuv'], n_frames)) / 4.
    plain_loss.backward()
    torch.testing.assert_close(loss, plain_loss, rtol=0, atol=0)
    for name, param in model.named_parameters():
        torch.testing.assert_close(param.grad, with_mlpg[name], rtol=0, atol=0)


def test_builder_needs_a_gpu_unless_asked_for_the_cpu(trained, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args = TBuilder.get_experiment_args(_port_argv(
        trained['root'], str(trained['base'] / 'nogpu'), trained['ckpt']))
    assert args['device'] == 'cuda'
    with pytest.raises(DeviceError, match="device='cpu'"):
        TBuilder(TModel, **args)


def test_flags_and_settings_the_port_lacks_are_errors(trained):
    argv = _port_argv(trained['root'], str(trained['base'] / 'flags'), trained['ckpt'],
                      '--device', 'cpu')
    with pytest.raises(SystemExit):
        TBuilder.get_experiment_args(argv + ['--data_parallel'])
    args = TBuilder.get_experiment_args(argv)
    with pytest.raises(TypeError, match='data_parallel'):
        TBuilder(TModel, data_parallel=True, **args)
    # --test is ported: with --test_id_list it builds the test loader.
    exp = TBuilder(TModel, **dict(args, test=True, test_id_list='test/test_file_id_list.scp'))
    assert len(exp.test_loader) == 1


@pytest.mark.parametrize('flags', [['--end_epoch', '50'], ['--no-train'],
                                   ['--start_epoch', '11', '--end_epoch', '12',
                                    '--valid_output_interval', '11']],
                         ids=['default_intervals', 'valid_only', 'interval_reached'])
def test_unported_valid_analysis_is_refused_at_construction(trained, flags):
    """The settings that were refused while the vocoder was unported (the
    default --end_epoch 50 with the default --valid_output_interval 10,
    validation alone, an interval that a trained epoch reaches) are
    accepted, and the validation analysis they reach writes one wav per
    valid utterance to valid/epoch_N/synth/: at epoch 10 of the defaults
    (its validation run alone), at epoch 0 of the checkpoint, and at epoch
    11 of a 2-epoch run."""
    base = trained['base'] / 'accepted' / flags[0].strip('-')
    argv = _port_argv(trained['root'], str(base), trained['ckpt'], '--device', 'cpu')
    exp = TBuilder(TModel, **TBuilder.get_experiment_args(argv + flags))
    if flags == ['--end_epoch', '50']:
        assert exp.valid_output_interval == 10
        exp.epoch = 10
        exp.run_valid(gen_output=True)
        epoch = 10
    else:
        exp.run_experiment()
        epoch = 0 if '--no-train' in flags else 11
    with open(os.path.join(trained['root'], 'valid', 'valid_file_id_list.scp')) as f:
        ids = f.read().split()
    synth = base / 'port' / 'valid' / f'epoch_{epoch}' / 'synth'
    assert sorted(os.listdir(synth)) == sorted(f'{utt}.wav' for utt in ids)


def _small_builder(trained, name, *flags):
    """A 1 x LSTM(16) port builder on the CPU, initialised from the seed."""
    argv = ['--experiment_name', name, '--experiments_base', str(trained['base'] / 'small'),
            '--data_root', trained['root'], '--train_id_list', 'train/train_file_id_list.scp',
            '--valid_id_list', 'valid/valid_file_id_list.scp', '--batch_size', '4',
            '--end_epoch', '1', '--device', 'cpu', *flags]
    return TBuilder(TModel, **TBuilder.get_experiment_args(argv))


def test_dropout_noise_is_seeded_per_step_and_off_in_eval(trained):
    """With dropout on, two loops of one seed give the same step; another
    seed gives another; eval has no noise."""
    kwargs = ['--model_kwargs', "{'num_layers': 1, 'hidden_size': 16, 'dropout_prob': 0.5}"]
    exps = [_small_builder(trained, f'dropout_{i}', *kwargs, '--seed', str(seed))
            for i, seed in enumerate((3, 3, 4))]
    batch = next(iter(exps[0].train_loader))
    for exp in exps:
        exp.model.load_state_dict(exps[0].model.state_dict())
        exp.model.mode = 'train'
    losses = [float(exp.loop.train_step(batch, 0.01)[0]) for exp in exps]
    assert losses[0] == losses[1] != losses[2]
    exps[0].model.mode = 'valid'
    evals = [float(exps[0].loop.eval_step(batch)[0]) for _ in range(2)]
    assert evals[0] == evals[1]


def test_ema_averages_every_step_and_is_saved(trained):
    """--ema_decay 0.5: after each step the average moves half way to the
    parameters; the run saves epoch_1_ema.npz and validates with it."""
    exp = _small_builder(trained, 'ema', '--ema_decay', '0.5', '--model_kwargs',
                         "{'num_layers': 1, 'hidden_size': 16}")
    batch = next(iter(exp.train_loader))
    want = {n: t.detach().clone() for n, t in exp.loop.ema_params.items()}
    exp.model.mode = 'train'
    for _ in range(2):
        exp.loop.train_step(batch, 0.01)
        for name, param in exp.model.named_parameters():
            want[name] = want[name] - 0.5 * (want[name] - param.detach())
    for name, value in exp.loop.ema_model.named_parameters():
        torch.testing.assert_close(value.detach(), want[name], rtol=0, atol=1e-7)

    exp.run_experiment()
    ckpt_dir = os.path.join(exp.experiment_dir, 'checkpoints')
    average = TModel(num_layers=1, hidden_size=16)
    average.load_parameters(os.path.join(ckpt_dir, 'epoch_1_ema.npz'))
    for name, value in exp.loop.ema_model.named_parameters():
        torch.testing.assert_close(average.get_parameter(name), value.detach())
    assert np.isfinite(_metrics(exp.experiment_dir, 'valid', 1)['loss'])
