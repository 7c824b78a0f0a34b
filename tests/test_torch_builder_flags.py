"""The rest of the port's builder surface against the JAX package's, on the
CPU: the flag surface (every JAX option but the 14 listed), ``--config``
of a JAX ``config.json``, ``Callback``/``EarlyStopping``, ``--find_lr``,
the memory tools (``memory.py``'s pure parts against JAX's on the same probe
functions; ``--memory_report``; ``--search_batch_size`` needs the GPU),
``metrics.pdf`` and ``load_experiment_results`` on a JAX experiment,
``--debug_nans``, ``--profile_dir``, ``--compilation_cache_dir``, the
tensorboard scalars and the log channels.

``F0Model`` (3 x GRU(64), full width) on 8 short training utterances (8-32
frames) and 4 validation ones, at B4. Exact comparisons throughout (the
JAX and port runs are compared on settings and files, not numbers), except
``load_experiment_results``, whose values are the same JSON floats.
"""
import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

from conftest import builder_args
from morgana_tpu import memory as jmemory
from morgana_tpu import nn as jnn
from morgana_tpu.data.synthetic import generate_voice_data as jgenerate
from morgana_tpu.experiment_builder import EarlyStopping as JEarlyStopping
from morgana_tpu.experiment_builder import ExperimentBuilder as JBuilder
from morgana_tpu.viz import plotting as jplotting

from morgana_tpu_torch import _build
from morgana_tpu_torch import memory as tmemory
from morgana_tpu_torch.experiment_builder import Callback, EarlyStopping
from morgana_tpu_torch.experiment_builder import ExperimentBuilder as TBuilder
from morgana_tpu_torch.models import f0_test_model as tf0
from morgana_tpu_torch.viz import plotting as tplotting

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'models'))
try:
    from f0_test_model import F0Model as JF0
finally:
    sys.path.pop(0)

#: The JAX builder's option strings the port does not have yet.
MISSING = {'--data_parallel', '--fsdp', '--tensor_parallel', '--shard_map_step', '--multihost',
           '--orbax_dir', '--device_cache', '--no-device_cache', '--device_cache_gb',
           '--device_normalise', '--no-device_normalise', '--steps_per_dispatch', '--remat',
           '--transfer_dtype'}
# An argument for each that takes one.
MISSING_VALUES = {'--tensor_parallel': '2', '--orbax_dir': 'ob', '--device_cache_gb': '1',
                  '--steps_per_dispatch': '4', '--transfer_dtype': 'bfloat16'}


@pytest.fixture(scope='module')
def short_voice_data(tmp_path_factory):
    """8 training utterances of 8-32 frames and 4 validation ones."""
    root = str(tmp_path_factory.mktemp('short_voice') / 'data')
    jgenerate(root, num_train=8, num_valid=4, num_test=2, seed=1, n_phones_range=(4, 8),
              dur_range=(2, 4))
    return {'data_root': root}


def _argv(root, base, name, *flags):
    return ['--experiment_name', name, '--experiments_base', str(base), '--data_root', root,
            '--train_id_list', 'train/train_file_id_list.scp',
            '--valid_id_list', 'valid/valid_file_id_list.scp', '--batch_size', '4',
            '--device', 'cpu', *flags]


@pytest.fixture(scope='module')
def runs(short_voice_data, tmp_path_factory):
    """A JAX run of 2 epochs with validation; a port run of the same with
    the observability flags; the port's run replayed by --config for 1
    epoch."""
    root = short_voice_data['data_root']
    base = tmp_path_factory.mktemp('flags')
    jnn.manual_seed(5)
    init = JF0().save_parameters(str(base / 'init'), 0)
    args = builder_args(root, str(base), checkpoint_path=init, end_epoch=2)
    jnn.manual_seed(args['seed'])
    JBuilder(JF0, experiment_name='jax', **args).run_experiment()
    events = []

    class Recorder(Callback):
        def on_train_begin(self, builder):
            events.append(('on_train_begin',))

        def on_epoch_begin(self, builder, epoch):
            events.append(('on_epoch_begin', epoch))

        def on_epoch_end(self, builder, epoch, train_loss):
            events.append(('on_epoch_end', epoch))

        def on_valid_end(self, builder, epoch, valid_loss):
            events.append(('on_valid_end', epoch))

        def on_train_end(self, builder):
            events.append(('on_train_end',))

    argv = _argv(root, base, 'port', '--checkpoint_path', init, '--end_epoch', '2',
                 '--memory_report', '--profile_dir', str(base / 'profile'), '--log_norms')
    port = TBuilder(tf0.F0Model, callbacks=[Recorder()], **TBuilder.get_experiment_args(argv))
    port.run_experiment()
    replay = TBuilder(tf0.F0Model, **TBuilder.get_experiment_args(
        ['--config', str(base / 'port' / 'config.json'), '--experiment_name', 'replay',
         '--end_epoch', '1', '--profile_dir', str(base / 'profile_replay')]))
    replay.run_experiment()
    return {'root': root, 'base': base, 'init': init, 'jax': str(base / 'jax'),
            'port': str(base / 'port'), 'builder': port, 'replay': replay, 'events': events}


def _option_strings(add_args):
    parser = argparse.ArgumentParser()
    parser.add_argument('--config')
    add_args(parser)
    return {s for action in parser._actions for s in action.option_strings} - {'-h', '--help'}


def test_the_port_has_every_jax_option_but_the_listed_ones():
    jax_options = _option_strings(JBuilder.add_args)
    port_options = _option_strings(TBuilder.add_args)
    assert jax_options - port_options == MISSING
    assert port_options - jax_options == set()


@pytest.mark.parametrize('option', sorted(MISSING))
def test_a_missing_option_is_an_argparse_error_naming_the_roadmap(option, capsys):
    value = [MISSING_VALUES[option]] if option in MISSING_VALUES else []
    with pytest.raises(SystemExit) as exc:
        TBuilder.get_experiment_args(['--experiment_name', 'x', option, *value])
    err = capsys.readouterr().err
    assert exc.value.code == 2 and option in err and 'ROADMAP.md' in err


def test_config_replays_a_jax_config(runs, capsys):
    """Every setting of the JAX run's config.json the port has takes its
    value; the others are printed as ignored; the command line wins."""
    with open(os.path.join(runs['jax'], 'config.json')) as f:
        config = json.load(f)
    args = TBuilder.get_experiment_args(['--config', os.path.join(runs['jax'], 'config.json'),
                                         '--experiment_name', 'again', '--device', 'cpu',
                                         '--batch_size', '2'])
    err = capsys.readouterr().err
    assert 'ignoring unknown keys' in err and "'data_parallel'" in err
    shared = set(config) & set(args) - {'experiment_name', 'device', 'batch_size'}
    assert {'learning_rate', 'checkpoint_path', 'end_epoch', 'valid_id_list'} <= shared
    for key in shared:
        assert args[key] == config[key], key
    assert (args['experiment_name'], args['device'], args['batch_size']) == ('again', 'cpu', 2)


@pytest.mark.parametrize('key,value,default', [
    ('data_parallel', True, False), ('steps_per_dispatch', 4, None),
    ('transfer_dtype', 'bfloat16', None), ('remat', True, False)])
def test_a_config_key_of_a_missing_flag_not_at_its_default_is_an_error(runs, tmp_path, capsys,
                                                                       key, value, default):
    """Such a key set away from the JAX default is the flag's argparse
    error; at the default it is ignored."""
    with open(os.path.join(runs['jax'], 'config.json')) as f:
        config = json.load(f)
    assert config.get(key, default) == default
    path = tmp_path / 'config.json'
    path.write_text(json.dumps(dict(config, **{key: value})))
    with pytest.raises(SystemExit) as exc:
        TBuilder.get_experiment_args(['--config', str(path), '--experiment_name', 'x'])
    err = capsys.readouterr().err
    assert exc.value.code == 2 and key in err and 'ROADMAP.md' in err
    path.write_text(json.dumps(dict(config, **{key: default})))
    TBuilder.get_experiment_args(['--config', str(path), '--experiment_name', 'x'])


def test_config_reproduces_the_first_epochs_losses(runs):
    assert runs['replay'].train_losses[1] == runs['builder'].train_losses[1]
    assert runs['replay'].settings['learning_rate'] == runs['builder'].settings['learning_rate']


def test_callbacks_fire_in_order(runs):
    names = [e[0] for e in runs['events']]
    assert names == ['on_train_begin', 'on_epoch_begin', 'on_valid_end', 'on_epoch_end',
                     'on_epoch_begin', 'on_valid_end', 'on_epoch_end', 'on_train_end']
    assert [e[1] for e in runs['events'] if e[0] == 'on_epoch_end'] == [1, 2]


@pytest.mark.parametrize('losses,patience,min_delta', [
    ([3.0, 2.0, 2.5, 2.4, 1.0, 1.1, 1.2], 2, 0.0), ([3.0, 2.9, 2.85, 2.84], 1, 0.1),
    ([1.0, 0.5, 0.25, 0.125], 1, 0.0), ([2.0, 2.0, 2.0, 2.0, 2.0], 3, 0.0)])
def test_early_stopping_stops_at_the_jax_epoch(losses, patience, min_delta):
    class Logger:
        logger = type('L', (), {'info': staticmethod(lambda *a: None)})()

    stops = []
    for cls in (JEarlyStopping, EarlyStopping):
        cb = cls(patience=patience, min_delta=min_delta)
        stops.append(next((epoch for epoch, loss in enumerate(losses, 1)
                           if cb.on_valid_end(Logger, epoch, loss)), None))
    assert stops[1] == stops[0]


def test_early_stopping_ends_the_run_after_the_epochs_checkpoint(runs, tmp_path):
    """patience 1 with a min_delta no loss can beat: epoch 2 stops the run,
    its checkpoint saved, no epoch 3."""
    args = TBuilder.get_experiment_args(_argv(runs['root'], tmp_path, 'early', '--checkpoint_path',
                                              runs['init'], '--end_epoch', '5'))
    TBuilder(tf0.F0Model, callbacks=[EarlyStopping(patience=1, min_delta=1e9)],
             **args).run_experiment()
    exp = tmp_path / 'early'
    assert (exp / 'checkpoints' / 'epoch_2.npz').exists()
    assert not (exp / 'train' / 'epoch_3').exists()


def test_find_lr_sweeps_and_writes_its_json(runs, tmp_path):
    args = TBuilder.get_experiment_args(_argv(runs['root'], tmp_path, 'lr', '--checkpoint_path',
                                              runs['init'], '--find_lr', '1e-5,1,12'))
    result = TBuilder(tf0.F0Model, **args).run_experiment()
    with open(tmp_path / 'lr' / 'lr_find.json') as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(result))
    assert saved['steps_run'] <= 12 and saved['steps_requested'] == 12
    lrs = [r['lr'] for r in saved['records']]
    np.testing.assert_allclose(lrs, 1e-5 * (1e5 ** (np.arange(len(lrs)) / 11)), rtol=1e-12)
    assert saved['stop_reason'] and 'suggestion' in saved
    assert (tmp_path / 'lr' / 'lr_find.png').exists()
    assert not (tmp_path / 'lr' / 'checkpoints').exists()


def test_find_lr_stops_when_the_loss_diverges_and_checks_its_spec(runs, tmp_path):
    args = TBuilder.get_experiment_args(_argv(runs['root'], tmp_path, 'lr', '--checkpoint_path',
                                              runs['init'], '--find_lr', '1e-3,1e4,40'))
    result = TBuilder(tf0.F0Model, **args).run_experiment()
    assert result['steps_run'] < 40 and result['stop_reason'].startswith('stopped at step')
    for spec in ('1e-3', '1,1e-3', '1e-5,1,5'):
        with pytest.raises(ValueError, match='find_lr'):
            TBuilder(tf0.F0Model, **dict(args, find_lr=spec)).run_experiment()


def _linear(b):
    return 1000 * b + 500


def _raising(b):
    if b > 20:
        raise RuntimeError('refused')
    return 100 * b


@pytest.mark.parametrize('probe,limit,kwargs', [
    (_linear, 64_000, {}), (_linear, 10 ** 9, {'max_batch': 300}), (_linear, 100, {}),
    (_raising, 10 ** 9, {}), (_linear, 37_000, {'start': 3}), (_linear, 64_000, {'granularity': 4}),
    (_linear, 500, {'granularity': 8})])
def test_find_max_batch_size_is_the_jax_search(probe, limit, kwargs):
    assert tmemory.find_max_batch_size(probe, limit, **kwargs) == \
        jmemory.find_max_batch_size(probe, limit, **kwargs)


def test_unavailable_analysis_propagates():
    def probe(b):
        raise tmemory.MemoryAnalysisUnavailable('no stats')
    with pytest.raises(tmemory.MemoryAnalysisUnavailable):
        tmemory.find_max_batch_size(probe, 10)


def test_batch_shapes_and_granularity_are_jaxs(runs):
    features = next(iter(runs['builder'].train_loader))
    for b in (1, 4, 37):
        want = jmemory.batch_shapes_at(features, b)
        got = tmemory.batch_shapes_at(features, b)
        assert sorted(got) == sorted(want)
        for key, spec in want.items():
            assert got[key].shape == spec.shape and got[key].dtype == spec.dtype
        batch = tmemory.batch_at(features, b)
        assert {k: (v.shape, v.dtype) for k, v in batch.items()} == \
            {k: (s.shape, s.dtype) for k, s in got.items()}
    assert tmemory.batch_granularity(features) == jmemory.batch_granularity(features) == 1


def test_memory_report_is_written_after_the_first_step(runs):
    with open(os.path.join(runs['port'], 'memory_report.txt')) as f:
        text = f.read()
    state = tmemory.state_bytes(runs['builder'].loop)
    assert state['parameters'] == sum(p.numel() * 4 for p in runs['builder'].model.parameters())
    assert state['optimizer_state'] == 2 * state['parameters']
    assert 'F0Model train step' in text and 'normalised_lab' in text
    assert 'parameters' in text and 'not reported by this device (CPU)' in text


def test_the_batch_size_search_measures_on_the_gpu(runs, tmp_path):
    args = TBuilder.get_experiment_args(_argv(runs['root'], tmp_path, 'search',
                                              '--checkpoint_path', runs['init'],
                                              '--search_batch_size', '1'))
    with pytest.raises(tmemory.MemoryAnalysisUnavailable, match='GPU'):
        TBuilder(tf0.F0Model, **args).run_experiment()


def test_probe_failures_are_named():
    assert tmemory.probe_failure(torch.cuda.OutOfMemoryError('x')) == 'out of memory'
    assert 'batch limit' in tmemory.probe_failure(
        ValueError('lstm_fwd: the LSTM kernels take 1 <= B <= 256, got B=512'))


@pytest.mark.parametrize('mode', ['train', 'valid'])
def test_load_experiment_results_reads_a_jax_experiment(runs, mode):
    names = ['loss', 'LF0_RMSE_Hz', 'epoch_duration_s']
    base, name = os.path.split(runs['jax'])
    want = jplotting.load_experiment_results(name, names, mode, base)
    got = tplotting.load_experiment_results(name, names, mode, base)
    assert got == want and list(got['loss']) == [1, 2]


def test_plots_are_written(runs, tmp_path, monkeypatch):
    assert os.path.isfile(os.path.join(runs['port'], 'metrics.pdf'))
    monkeypatch.chdir(tmp_path)
    base = os.path.dirname(runs['jax'])
    tplotting.plot_experiment_set(['jax', 'port'], ['loss', 'grad_norm'], base,
                                  file_name='set.pdf')
    assert (tmp_path / 'plots' / 'set.pdf').is_file()


def test_debug_nans_names_the_layer_and_the_step(runs, tmp_path):
    args = TBuilder.get_experiment_args(_argv(runs['root'], tmp_path, 'nan', '--checkpoint_path',
                                              runs['init'], '--debug_nans', '--end_epoch', '1'))
    exp = TBuilder(tf0.F0Model, **args)
    with torch.no_grad():
        dict(exp.model.named_parameters())['layers.5.w_hh_l0'][3, 7] = float('nan')
    with pytest.raises(FloatingPointError, match=r'module layers\.5 \(Recurrent\).* step 1'):
        exp.run_experiment()


def test_debug_nans_sees_a_backward_nan(runs, tmp_path):
    """A finite forward whose gradient turns NaN at a layer's output: the
    backward pass raises FloatingPointError naming the step (anomaly mode
    names the function)."""
    args = TBuilder.get_experiment_args(_argv(runs['root'], tmp_path, 'bnan', '--checkpoint_path',
                                              runs['init'], '--debug_nans', '--end_epoch', '1'))
    exp = TBuilder(tf0.F0Model, **args)
    def poison_the_gradient(module, inputs, output):
        y = output[0] if isinstance(output, tuple) else output
        y.register_hook(lambda g: g * float('nan'))

    dict(exp.model.named_modules())['layers.5'].register_forward_hook(poison_the_gradient)
    with pytest.raises(FloatingPointError, match=r'backward pass of step 1'):
        exp.run_experiment()


def test_profile_trace_of_the_first_epoch(runs):
    path = os.path.join(str(runs['base']), 'profile', 'train_epoch_1.pt.trace.json')
    with open(path) as f:
        names = {event.get('name') for event in json.load(f)['traceEvents']}
    assert {'train step 1', 'train step 2'} <= names
    assert not os.path.exists(os.path.join(str(runs['base']), 'profile',
                                           'train_epoch_2.pt.trace.json'))


def test_compilation_cache_dir_is_the_build_dir(runs, tmp_path, monkeypatch):
    monkeypatch.setattr(_build, 'BUILD_DIR', _build.BUILD_DIR)
    args = TBuilder.get_experiment_args(_argv(runs['root'], tmp_path, 'cache', '--checkpoint_path',
                                              runs['init'], '--compilation_cache_dir',
                                              str(tmp_path / 'kernels')))
    TBuilder(tf0.F0Model, **args)
    assert _build.BUILD_DIR == str(tmp_path / 'kernels') and (tmp_path / 'kernels').is_dir()


def test_tensorboard_scalars_and_log_channels(runs):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    events = EventAccumulator(runs['port'])
    events.Reload()
    tags = set(events.Tags()['scalars'])
    assert {'train/loss', 'train/grad_norm', 'train/update_norm', 'valid/loss'} <= tags
    assert [e.step for e in events.Scalars('train/loss')] == [1, 2]
    logs = os.listdir(os.path.join(runs['port'], 'log'))
    assert sorted(os.path.splitext(f)[1] for f in logs) == ['.stderr', '.stdout', '.tqdm']
    tqdm_log = next(f for f in logs if f.endswith('.tqdm'))
    with open(os.path.join(runs['port'], 'log', tqdm_log)) as f:
        assert 'train | epoch  2: batch_loss = ' in f.read()
