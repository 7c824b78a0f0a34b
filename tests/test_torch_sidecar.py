"""The port's ``epoch_{N}.train.pkl`` sidecar (``morgana_tpu_torch.checkpointing.
save_training_state``) against the JAX package's, on the CPU.

``F0Model`` (3 x GRU(64), full width) trains for 2 epochs of B=4 at lr 0.01
through the port's builder from a JAX-made ``epoch_0.npz``, with the constant
schedule (stepped an epoch) and with Noam (stepped a batch). From the port's
``epoch_1.npz`` and its sidecar, the port's builder and the JAX builder each
resume at epoch 2: every epoch-2 train and valid metric within 1e-3 relative
of the uninterrupted port run (the bar of the builders' trajectories in
``test_torch_gru_models.py``). Without the sidecar, a resume restarts Adam,
the step count and the schedule, and misses that bar (measured on the CPU:
up to 1.0e-1 relative with the constant schedule, 2.7e-2 with Noam).
"""
import json
import os
import shutil
import sys

import jax
import numpy as np
import optax
import pytest

from conftest import builder_args
from morgana_tpu import checkpointing as jckpt
from morgana_tpu import nn as jnn
from morgana_tpu.experiment_builder import ExperimentBuilder as JBuilder
from morgana_tpu.training import build_optimizer as jbuild_optimizer

from morgana_tpu_torch import checkpointing as tckpt
from morgana_tpu_torch.models import f0_test_model as tf0

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'models'))
try:
    from f0_test_model import F0Model as JF0
finally:
    sys.path.pop(0)

TRAJ_RTOL = 1e-3
TIMING_KEYS = ('epoch_duration_s', 'ms_per_step', 'frames_per_sec')
# name: (port flags, JAX builder settings)
SCHEDULES = {
    'constant': ([], {}),
    'noam': (['--lr_schedule_name', 'noam', '--lr_schedule_kwargs', "{'warmup_steps': 3}"],
             {'lr_schedule_name': 'noam', 'lr_schedule_kwargs': {'warmup_steps': 3}}),
}


def _port_argv(data_root, experiments_base, ckpt, *flags):
    return ['--experiment_name', 'port', '--experiments_base', str(experiments_base),
            '--data_root', data_root, '--train_id_list', 'train/train_file_id_list.scp',
            '--valid_id_list', 'valid/valid_file_id_list.scp', '--batch_size', '4',
            '--end_epoch', '2', '--learning_rate', '0.01', '--checkpoint_path', str(ckpt),
            '--device', 'cpu', *flags]


def _metrics(exp_dir, mode, epoch):
    with open(os.path.join(exp_dir, mode, f'epoch_{epoch}', 'metrics.json')) as f:
        return json.load(f)


@pytest.fixture(scope='module', params=list(SCHEDULES))
def runs(request, voice_data, tmp_path_factory):
    """The uninterrupted port run, and the port's and the JAX builder's
    resumes at epoch 2 from the port's epoch_1.npz and its sidecar."""
    flags, jax_settings = SCHEDULES[request.param]
    root = voice_data['data_root']
    base = tmp_path_factory.mktemp(f'sidecar_{request.param}')
    jnn.manual_seed(5)
    init = JF0().save_parameters(str(base / 'init'), 0)
    tf0.main(_port_argv(root, base / 'whole', init, *flags))
    epoch_1 = base / 'whole' / 'port' / 'checkpoints' / 'epoch_1.npz'
    tf0.main(_port_argv(root, base / 'port_resume', epoch_1, '--start_epoch', '2', *flags))
    bare = base / 'bare' / 'epoch_1.npz'           # the checkpoint without its sidecar
    bare.parent.mkdir()
    shutil.copy(epoch_1, bare)
    tf0.main(_port_argv(root, base / 'bare_resume', bare, '--start_epoch', '2', *flags))
    args = builder_args(root, str(base / 'jax_resume'), checkpoint_path=str(epoch_1),
                        learning_rate=0.01, start_epoch=2, **jax_settings)
    jnn.manual_seed(args['seed'])
    JBuilder(JF0, experiment_name='jax', **args).run_experiment()
    return {'whole': str(base / 'whole' / 'port'), 'epoch_1': str(epoch_1),
            'port_resume': str(base / 'port_resume' / 'port'),
            'jax_resume': str(base / 'jax_resume' / 'jax'),
            'bare_resume': str(base / 'bare_resume' / 'port'), 'schedule': request.param}


def test_sidecar_is_written_beside_every_checkpoint(runs):
    for epoch in (1, 2):
        path = os.path.join(runs['whole'], 'checkpoints', f'epoch_{epoch}.train.pkl')
        state = tckpt.load_training_state(path)
        assert sorted(state) == ['ema_params', 'extra', 'opt_state', 'params', 'step']
        assert state['step'] == 2 * epoch        # 8 utterances at B4
        # Saved, as by the JAX builder, before an epoch schedule's step.
        assert state['extra']['lr_schedule']['last_epoch'] == \
            (2 * epoch if runs['schedule'] == 'noam' else epoch - 1)


def test_the_jax_package_reads_it_as_optax_state(runs):
    """Plain ``pickle`` (the JAX package's reader) builds optax's own classes,
    in the tree structure of the JAX optimiser's state for the same
    parameters; the parameters are the checkpoint's."""
    path = tckpt.training_state_path_for(runs['epoch_1'])
    state = jckpt.load_training_state(path)
    adam = state['opt_state'][-1]
    assert isinstance(adam, optax.ScaleByAdamState)
    assert adam.count.dtype == np.int32 and int(adam.count) == 2
    params = jckpt.load_state_dict(runs['epoch_1'])
    want = jbuild_optimizer('adam').init(params)
    assert jax.tree_util.tree_structure(state['opt_state']) == \
        jax.tree_util.tree_structure(want)
    assert state['ema_params'] is None
    for name, value in params.items():
        np.testing.assert_array_equal(state['params'][name], value)
        assert adam.mu[name].shape == adam.nu[name].shape == value.shape


def test_pickle_names_optax_without_importing_it(runs, monkeypatch):
    """The port's pickler writes the same bytes with optax made unimportable:
    it names optax's classes by module path and never imports them."""
    path = tckpt.training_state_path_for(runs['epoch_1'])
    state = tckpt.load_training_state(path)
    with open(path, 'rb') as f:
        written = f.read()
    for name in [m for m in sys.modules if m == 'optax' or m.startswith('optax.')]:
        monkeypatch.setitem(sys.modules, name, None)
    out = path + '.again'
    tckpt.save_training_state(out, **state)
    with open(out, 'rb') as f:
        assert f.read() == written
    assert b'optax._src.transform' in written and b'ScaleByAdamState' in written


@pytest.mark.parametrize('mode', ['train', 'valid'])
@pytest.mark.parametrize('resumed_by', ['port_resume', 'jax_resume'])
def test_resume_at_epoch_2_matches_the_uninterrupted_run(runs, resumed_by, mode):
    want = _metrics(runs['whole'], mode, 2)
    got = _metrics(runs[resumed_by], mode, 2)
    assert sorted(got) == sorted(want)
    for key in set(want) - set(TIMING_KEYS):
        np.testing.assert_allclose(got[key], want[key], rtol=TRAJ_RTOL, err_msg=f'{mode} {key}')


def test_without_the_sidecar_a_resume_misses_the_bar(runs):
    """The same resume from the checkpoint alone (what the port wrote before
    it wrote sidecars) restarts Adam, the step count and the schedule: some
    epoch-2 metric leaves the 1e-3 bar."""
    worst = 0.0
    for mode in ('train', 'valid'):
        want, got = _metrics(runs['whole'], mode, 2), _metrics(runs['bare_resume'], mode, 2)
        for key in set(want) - set(TIMING_KEYS):
            worst = max(worst, abs(got[key] - want[key]) / abs(want[key]))
    assert worst > TRAJ_RTOL
