"""Gradient accumulation and ``--log_norms`` of the port's TrainLoop against
the JAX TrainLoop's on the CPU, with ``F0Model`` (3 x GRU(64), full width)
on 8 short synthetic training utterances (8-32 frames).

- Accumulation: micro-batches of 4 + 4 (equal) and 5 + 3 (unequal) at
  ``grad_accum_steps=2``, each against the JAX loop's accumulation and
  against one step on the concatenated 8, and 4 then 4 closed early by
  ``force_apply`` at ``grad_accum_steps=3`` against the concatenated 8.
  With SGD (lr 0.1) the update is linear in the gradient, so the
  parameters differ by lr times the f32 rounding of the gradient sums:
  held to 2e-6 absolute (parameters of order 0.1-1).
- Norms: ``grad_norm``, ``param_norm`` and ``update_norm`` of the applied
  update against the JAX loop's ``stage_norms``, 1e-5 relative (f32 sums in
  another order), registered once and counted on applied updates only.
- The builder: ``--grad_accum_steps 2`` steps a batch-level schedule (Noam)
  once an applied update, closes the epoch's short cycle, and writes the
  norms to ``metrics.json``.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest

from morgana_tpu import data as jdata
from morgana_tpu import nn as jnn
from morgana_tpu.data.synthetic import generate_voice_data as jgenerate
from morgana_tpu.training import TrainLoop as JLoop
from morgana_tpu.training import build_optimizer as jbuild_optimizer

from morgana_tpu_torch import checkpointing as tckpt
from morgana_tpu_torch import data as tdata
from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch.models import f0_test_model as tf0
from morgana_tpu_torch.training import TrainLoop as TLoop
from morgana_tpu_torch.training import build_optimizer as tbuild_optimizer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'models'))
try:
    from f0_test_model import F0Model as JF0
finally:
    sys.path.pop(0)

LR = 0.1
PARAM_ATOL = 2e-6
NORM_RTOL = 1e-5
# name: (grad_accum_steps, micro-batch sizes); the last call applies.
CYCLES = {'equal': (2, (4, 4)), 'unequal': (2, (5, 3)), 'force_apply': (3, (4, 4))}
NORMS = ('grad_norm', 'param_norm', 'update_norm')


@pytest.fixture(scope='module')
def short_voice_data(tmp_path_factory):
    """8 training utterances of 8-32 frames (the default corpus's 24-288
    make the plain GRU loop of these CPU runs five times slower)."""
    root = str(tmp_path_factory.mktemp('short_voice') / 'data')
    jgenerate(root, num_train=8, num_valid=4, num_test=2, seed=1, n_phones_range=(4, 8),
              dur_range=(2, 4))
    return {'data_root': root}


@pytest.fixture(scope='module')
def corpus(short_voice_data):
    """The init (a seeded JAX F0Model's parameters) and the 8 training
    items, collated by the JAX package for any split of them."""
    root = short_voice_data['data_root']
    jnn.manual_seed(5)
    model = JF0()
    init = {k: np.asarray(v) for k, v in jnn.parameters(model).items()}
    normalisers = model.normaliser_sources()
    for norm in normalisers.values():
        norm.load_params('train', root)
    dataset = jdata.FilesDataset(model.train_data_sources(), 'train',
                                 'train/train_file_id_list.scp', normalisers, root)
    items = [dataset[i] for i in range(len(dataset))]
    return {'root': root, 'init': init, 'items': items}


def _batches(corpus, sizes):
    starts = np.cumsum((0,) + sizes)
    return [jdata.collate(corpus['items'][a:b]) for a, b in zip(starts[:-1], starts[1:])]


def _jax_loop(corpus, **kwargs):
    jnn.manual_seed(5)
    model = JF0()
    jnn.load_parameters(model, {k: jax.numpy.asarray(v) for k, v in corpus['init'].items()})
    normalisers = model.normaliser_sources()
    for norm in normalisers.values():
        norm.load_params('train', corpus['root'])
    model.normalisers = normalisers
    model.mode = 'train'
    model.metrics.reset_state('train')
    return JLoop(model, jbuild_optimizer('sgd'), seed=0, **kwargs)


def _port_loop(corpus, **kwargs):
    model = tf0.F0Model()
    tnn.load_jax_params(model, corpus['init'])
    model.normalisers = tdata.Normalisers(model.normaliser_sources(), 'train', corpus['root'])
    model.mode = 'train'
    model.metrics.reset_state('train')
    return TLoop(model, tbuild_optimizer('sgd'), seed=0, **kwargs)


def _params(loop):
    if isinstance(loop, TLoop):
        return tnn.state_dict(loop.model)
    return {k: np.asarray(v) for k, v in loop.params.items()}


def _run(loop, batches):
    """The cycle's calls (the last with force_apply); returns
    last_step_applied after each."""
    applied = []
    for i, batch in enumerate(batches):
        out = loop.train_step(batch, LR, force_apply=i == len(batches) - 1)
        if isinstance(loop, JLoop):
            loop.model.metrics.apply_staged(out[1], tag='train')
        applied.append(loop.last_step_applied)
    return applied


@pytest.fixture(scope='module', params=list(CYCLES))
def cycle(request, corpus):
    """The cycle run by the JAX loop and the port's (both with log_norms),
    and one port step on the concatenated batch."""
    steps, sizes = CYCLES[request.param]
    batches = _batches(corpus, sizes)
    out = {'name': request.param, 'sizes': sizes}
    # The short cycle is the port's alone (against the concatenated batch):
    # JAX's compiles are most of this file's time.
    packages = (('port', _port_loop),) if request.param == 'force_apply' else \
        (('jax', _jax_loop), ('port', _port_loop))
    for package, make in packages:
        loop = make(corpus, grad_accum_steps=steps, log_norms=True)
        out[f'{package}_applied'] = _run(loop, batches)
        out[package] = loop
    whole = _port_loop(corpus, log_norms=True)
    whole.train_step(_batches(corpus, (sum(sizes),))[0], LR)
    out['concat'] = whole
    return out


def test_only_the_last_call_of_the_cycle_applies(cycle):
    want = [False] * (len(cycle['sizes']) - 1) + [True]
    assert cycle['port_applied'] == cycle.get('jax_applied', want) == want
    assert cycle['port'].step_count == len(cycle['sizes'])


@pytest.mark.parametrize('against', ['jax', 'concat'])
def test_accumulated_update_matches(cycle, against):
    if against not in cycle:
        against = 'concat'
    want, got = _params(cycle[against]), _params(cycle['port'])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=PARAM_ATOL, err_msg=k)


def test_accumulation_steps_leave_the_parameters(corpus):
    """A micro-batch that only accumulates moves no parameter."""
    loop = _port_loop(corpus, grad_accum_steps=2)
    loop.train_step(_batches(corpus, (4,))[0], LR)
    assert not loop.last_step_applied
    for k, v in tnn.state_dict(loop.model).items():
        np.testing.assert_array_equal(v, corpus['init'][k])


def test_norms_match_jax_stage_norms(cycle):
    """The three norms of the applied update, registered once in the train
    collection and counted once (the applied update only)."""
    got = cycle['port'].model.metrics['train']
    want = cycle.get('jax', cycle['concat']).model.metrics['train']
    for name in NORMS:
        assert got[name].count == want[name].count == 1
        np.testing.assert_allclose(got[name].result(), float(want[name].result()),
                                   rtol=NORM_RTOL, err_msg=name)
    assert 'grad_norm' not in cycle['port'].model.metrics['valid']


def test_accumulated_grad_norm_is_the_concatenated_batchs(cycle):
    got = cycle['port'].model.metrics['train']['grad_norm'].result()
    want = cycle['concat'].model.metrics['train']['grad_norm'].result()
    np.testing.assert_allclose(got, want, rtol=NORM_RTOL)


def test_builder_steps_a_batch_schedule_once_an_applied_update(short_voice_data, tmp_path):
    """--grad_accum_steps 2 at B3 on 8 utterances: batches 3, 3, 2, so a full
    cycle and a short one closed at the epoch's end, 2 applied updates an
    epoch and 3 steps; Noam steps 4 times in 2 epochs; metrics.json has the
    norms."""
    root = short_voice_data['data_root']
    jnn.manual_seed(5)
    init = JF0().save_parameters(str(tmp_path / 'init'), 0)
    tf0.main(['--experiment_name', 'accum', '--experiments_base', str(tmp_path),
              '--data_root', root, '--train_id_list', 'train/train_file_id_list.scp',
              '--no-valid', '--batch_size', '3', '--end_epoch', '2', '--checkpoint_path', init,
              '--device', 'cpu', '--grad_accum_steps', '2', '--log_norms',
              '--lr_schedule_name', 'noam', '--lr_schedule_kwargs', "{'warmup_steps': 3}"])
    exp = tmp_path / 'accum'
    state = tckpt.load_training_state(str(exp / 'checkpoints' / 'epoch_2.train.pkl'))
    assert state['step'] == 6
    assert state['extra']['lr_schedule']['last_epoch'] == 4
    assert int(state['opt_state'][-1].count) == 4
    with open(exp / 'train' / 'epoch_2' / 'metrics.json') as f:
        metrics = json.load(f)
    assert all(metrics[name] > 0 for name in NORMS)
