"""Step checkpoints and ``--checkpoint_path latest`` of the port's builder,
and their exchange with the JAX builder, on the CPU.

``F0Model`` (3 x GRU(64), full width) from a seeded JAX ``epoch_0.npz``, on
the 8 training utterances at B4 (2 batches an epoch) for 2 epochs, with
``--step_checkpoint_interval 1 --length_sort_window 1 --num_data_threads 2
--keep_checkpoints 1`` and an EMA. A run stopped by an interrupt in epoch 2
(after its first batch) and finished with ``--checkpoint_path latest``:

- in the port, ends on the uninterrupted run's parameters and EMA bit for
  bit (the CPU is deterministic: the loader's order, the optimiser state and
  the schedule replay exactly);
- a JAX run's step checkpoint finished by the port, and the port's finished
  by the JAX builder, end within 1e-3 of each tensor's largest value of the
  port's uninterrupted run (the bar of the GPU-against-CPU gradients in
  ``chip_smoke.py``; here it covers the two packages' f32 arithmetic over
  the steps each ran).

Then the resolution rules: a step checkpoint of a completed epoch is stale, a
torn ``step.npz``/sidecar pair resumes from the sidecar's parameters, a
corrupt sidecar falls back to the epoch checkpoint, retention spares the
emergency checkpoint, and ``--ema_checkpoint_path latest`` finds the newest
``_ema`` file.
"""
import os
import shutil
import sys

import numpy as np
import pytest

from conftest import builder_args
from morgana_tpu import nn as jnn
from morgana_tpu.data.synthetic import generate_voice_data as jgenerate
from morgana_tpu.experiment_builder import ExperimentBuilder as JBuilder

from morgana_tpu_torch import checkpointing as tckpt
from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch.experiment_builder import ExperimentBuilder as TBuilder
from morgana_tpu_torch.models import f0_test_model as tf0

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'models'))
try:
    from f0_test_model import F0Model as JF0
finally:
    sys.path.pop(0)

CROSS_RTOL = 1e-3
INTERRUPT_AT = 4          # epoch 1's two steps, epoch 2's first, then the interrupt
SETTINGS = dict(valid=False, batch_size=4, end_epoch=2, learning_rate=0.005, ema_decay=0.9,
                step_checkpoint_interval=1, length_sort_window=1, keep_checkpoints=1,
                num_data_threads=2)


def _port(root, base, name, ckpt, **overrides):
    args = TBuilder.get_experiment_args(
        ['--experiment_name', name, '--experiments_base', str(base), '--data_root', root,
         '--train_id_list', 'train/train_file_id_list.scp', '--device', 'cpu'])
    args.update(SETTINGS, checkpoint_path=ckpt, **overrides)
    return TBuilder(tf0.F0Model, **args)


def _jax(root, base, name, ckpt):
    args = builder_args(root, str(base), checkpoint_path=ckpt, **SETTINGS)
    jnn.manual_seed(args['seed'])
    return JBuilder(JF0, experiment_name=name, **args)


def _interrupted(exp):
    """Runs ``exp`` with a KeyboardInterrupt at its INTERRUPT_AT-th step."""
    step, calls = exp.loop.train_step, []

    def interrupting(features, lr, force_apply=False):
        calls.append(1)
        if len(calls) == INTERRUPT_AT:
            raise KeyboardInterrupt
        return step(features, lr, force_apply=force_apply)

    exp.loop.train_step = interrupting
    with pytest.raises(KeyboardInterrupt):
        exp.run_experiment()


@pytest.fixture(scope='module')
def short_voice_data(tmp_path_factory):
    """8 training utterances of 8-32 frames (the default corpus's 24-288
    make the plain GRU loop of these CPU runs five times slower)."""
    root = str(tmp_path_factory.mktemp('short_voice') / 'data')
    jgenerate(root, num_train=8, num_valid=4, num_test=2, seed=1, n_phones_range=(4, 8),
              dur_range=(2, 4))
    return {'data_root': root}


def _params(exp_dir, name):
    return tckpt.load_state_dict(os.path.join(exp_dir, 'checkpoints', name))


@pytest.fixture(scope='module')
def runs(short_voice_data, tmp_path_factory):
    root = short_voice_data['data_root']
    base = tmp_path_factory.mktemp('resume')
    jnn.manual_seed(5)
    init = JF0().save_parameters(str(base / 'init'), 0)
    _port(root, base, 'whole', init).run_experiment()
    _interrupted(_port(root, base, 'port', init))
    shutil.copytree(base / 'port', base / 'port_for_jax')
    shutil.copytree(base / 'port', base / 'interrupted')     # kept as it was
    resumed = _port(root, base, 'port', 'latest')
    position = (resumed.checkpoint_path, resumed.start_epoch, resumed._resume_batches_done,
                resumed.loop.step_count)
    resumed.run_experiment()
    _interrupted(_jax(root, base, 'jax', init))
    _port(root, base, 'jax', 'latest').run_experiment()
    _jax(root, base, 'port_for_jax', 'latest').run_experiment()
    return {'root': root, 'base': base, 'position': position,
            **{name: str(base / name) for name in ('whole', 'port', 'jax', 'port_for_jax',
                                                   'interrupted')}}


def test_latest_resolves_the_step_checkpoint_at_its_batch(runs):
    path, start_epoch, batches_done, step = runs['position']
    assert path == os.path.join(runs['port'], 'checkpoints', 'step.npz')
    assert (start_epoch, batches_done, step) == (2, 1, 3)
    state = tckpt.load_training_state(os.path.join(runs['interrupted'], 'checkpoints',
                                                   'step.train.pkl'))
    extra = state['extra']
    assert (extra['epoch'], extra['batches_done'], extra['num_batches']) == (2, 1, 2)
    assert set(extra['loader_lengths']) == {'epoch_start', 'live'}
    assert len(extra['loader_lengths']['epoch_start']) == 8


@pytest.mark.parametrize('name', ['epoch_2.npz', 'epoch_2_ema.npz'])
def test_port_resume_is_bit_exact(runs, name):
    want, got = _params(runs['whole'], name), _params(runs['port'], name)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('finished_by', ['jax', 'port_for_jax'],
                         ids=['jax_step_checkpoint_in_port', 'port_step_checkpoint_in_jax'])
@pytest.mark.parametrize('name', ['epoch_2.npz', 'epoch_2_ema.npz'])
def test_cross_package_resume_reaches_the_same_parameters(runs, finished_by, name):
    want, got = _params(runs['whole'], name), _params(runs[finished_by], name)
    assert sorted(got) == sorted(want)
    for k in want:
        bar = CROSS_RTOL * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=bar, err_msg=k)


@pytest.mark.parametrize('run', ['port', 'jax', 'port_for_jax'])
def test_retention_spares_the_emergency_checkpoint(runs, run):
    files = sorted(os.listdir(os.path.join(runs[run], 'checkpoints')))
    assert files == sorted(['epoch_2_interrupted.npz', 'epoch_2_interrupted.train.pkl',
                            'epoch_2.npz', 'epoch_2.train.pkl', 'epoch_2_ema.npz', 'step.npz',
                            'step.train.pkl'])


def test_a_completed_epochs_step_checkpoint_is_stale(runs, tmp_path):
    """After the uninterrupted run, step.npz records epoch 2's last batch and
    epoch_2.npz exists: latest is the epoch checkpoint, start_epoch 3."""
    shutil.copytree(runs['whole'], tmp_path / 'whole')
    exp = _port(runs['root'], tmp_path, 'whole', 'latest', end_epoch=3)
    assert exp.checkpoint_path == os.path.join(str(tmp_path), 'whole', 'checkpoints',
                                               'epoch_2.npz')
    assert exp.start_epoch == 3 and exp._resume_batches_done == 0
    assert exp.ema_checkpoint_path == exp.checkpoint_path


def test_a_torn_pair_resumes_from_the_sidecar(runs, tmp_path):
    """step.npz overwritten (a crash between the two writes): the sidecar's
    parameters are the ones restored."""
    shutil.copytree(runs['interrupted'], tmp_path / 'torn')
    ckpt = tmp_path / 'torn' / 'checkpoints'
    shutil.copy(ckpt / 'epoch_1.npz', ckpt / 'step.npz')
    exp = _port(runs['root'], tmp_path, 'torn', 'latest')
    assert exp.checkpoint_path.endswith('step.npz') and exp._resume_batches_done == 1
    state = tckpt.load_training_state(str(ckpt / 'step.train.pkl'))
    got = tnn.state_dict(exp.model)
    for k, v in state['params'].items():
        np.testing.assert_array_equal(got[k], v)
    assert any(not np.array_equal(got[k], v) for k, v in _params(str(tmp_path / 'torn'),
                                                                 'epoch_1.npz').items())


def test_a_corrupt_sidecar_falls_back_to_the_epoch_checkpoint(runs, tmp_path):
    shutil.copytree(runs['interrupted'], tmp_path / 'corrupt')
    (tmp_path / 'corrupt' / 'checkpoints' / 'step.train.pkl').write_bytes(b'not a pickle')
    exp = _port(runs['root'], tmp_path, 'corrupt', 'latest')
    assert exp.checkpoint_path.endswith('epoch_1.npz')
    assert exp.start_epoch == 2 and exp._resume_batches_done == 0


def test_latest_without_checkpoints_starts_afresh(runs, tmp_path):
    exp = _port(runs['root'], tmp_path, 'fresh', 'latest', ema_checkpoint_path='latest')
    assert exp.checkpoint_path is None and exp.ema_checkpoint_path is None
    assert exp.start_epoch == 1 and exp.loop.step_count == 0
