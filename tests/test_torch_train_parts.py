"""The pieces of the port's training slice against the JAX package on the
CPU, on the same seeded numpy inputs: losses and metrics (1e-6 relative, f32
sums in another order), Adam with L2 and clipping plus EMA over 5 steps
(1e-6 abs), the LR schedules (equal), the loader's batch order (equal) and
the synthetic corpus writer (equal files)."""
import filecmp
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu import losses as jlosses
from morgana_tpu import lr_schedules as jschedules
from morgana_tpu import metrics as jmetrics
from morgana_tpu.data.loader import DataLoader as JLoader
from morgana_tpu.data.synthetic import generate_voice_data as jgenerate
from morgana_tpu.training import apply_updates as japply_updates
from morgana_tpu.training import build_optimizer as jbuild_optimizer

from morgana_tpu_torch import losses as tlosses
from morgana_tpu_torch import lr_schedules as tschedules
from morgana_tpu_torch import metrics as tmetrics
from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch.data.loader import DataLoader as TLoader
from morgana_tpu_torch.data.synthetic import generate_voice_data as tgenerate
from morgana_tpu_torch.training import apply_updates as tapply_updates
from morgana_tpu_torch.training import build_optimizer as tbuild_optimizer

B, T, D = 3, 11, 5
SEQ_LEN = np.array([11, 4, 1])
RTOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize('seq_len', [None, SEQ_LEN], ids=['no_seq_len', 'ragged'])
@pytest.mark.parametrize('name', ['mse', 'bce', 'ce'])
def test_sequence_losses_match_jax(name, seq_len):
    """Masked sequence losses; bce gets probabilities of exactly 0 and 1,
    where the eps and the -100 clamp decide the value."""
    rng = _rng(1)
    if name == 'ce':
        pred = rng.normal(size=(B, T, D)).astype(np.float32)
        target = rng.integers(0, D, size=(B, T, 1))
    elif name == 'bce':
        pred = rng.random((B, T, D)).astype(np.float32)
        pred[0, 0, :2] = [0.0, 1.0]
        target = (rng.random((B, T, D)) > 0.5).astype(np.float32)
    else:
        pred, target = (rng.normal(size=(B, T, D)).astype(np.float32) for _ in range(2))
    want = getattr(jlosses, name)(jnp.asarray(pred), jnp.asarray(target),
                                  None if seq_len is None else jnp.asarray(seq_len))
    got = getattr(tlosses, name)(torch.from_numpy(pred), torch.from_numpy(target),
                                 None if seq_len is None else torch.from_numpy(seq_len))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_kld_standard_normal_matches_jax():
    rng = _rng(2)
    mean, log_var = (rng.normal(size=(B, D)).astype(np.float32) for _ in range(2))
    want = jlosses.kld_standard_normal(jnp.asarray(mean), jnp.asarray(log_var))
    got = tlosses.kld_standard_normal(torch.from_numpy(mean), torch.from_numpy(log_var))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def _metric_inputs(name, rng, seq_len):
    """Two batches of inputs for one metric class, as numpy arrays."""
    def feats(dim=D):
        return rng.normal(size=(B, T, dim)).astype(np.float32)

    def mask():
        return (rng.random((B, T, 1)) > 0.3).astype(np.float32)

    inputs = {
        'Mean': lambda: (feats(),),
        'RMSE': lambda: (feats(), feats()),
        'F0Distortion': lambda: (100 + feats(1), 100 + feats(1), mask()),
        'LF0Distortion': lambda: (5 + feats(1), 5 + feats(1), mask()),
        'Distortion': lambda: (feats(), feats()),
        'MelCepDistortion': lambda: (feats(), feats()),
    }[name]()
    return inputs if seq_len is None else inputs + (seq_len,)


@pytest.mark.parametrize('seq_len', [None, SEQ_LEN], ids=['no_seq_len', 'ragged'])
@pytest.mark.parametrize('name', ['Mean', 'RMSE', 'F0Distortion', 'LF0Distortion', 'Distortion',
                                  'MelCepDistortion'])
def test_metric_matches_jax(name, seq_len):
    """Two accumulations of seeded inputs, then the result."""
    jmetric, tmetric = getattr(jmetrics, name)(), getattr(tmetrics, name)()
    rng = _rng(3)
    for _ in range(2):
        inputs = _metric_inputs(name, rng, seq_len)
        jmetric.accumulate(*[jnp.asarray(a) for a in inputs])
        tmetric.accumulate(*[torch.from_numpy(np.asarray(a)) for a in inputs])
    np.testing.assert_allclose(tmetric.result(), jmetric.result(), rtol=RTOL)
    assert str(tmetric) == str(jmetric)


def test_handler_merges_lazily_like_jax():
    """The handler of a model: collections, lazy accumulation, json results
    with hidden metrics left out, and reset."""
    handlers = [m.Handler(loss=m.Mean(), err=m.RMSE(hidden=True)) for m in (jmetrics, tmetrics)]
    for h, m in zip(handlers, (jmetrics, tmetrics)):
        h.add_metrics('all', extra=m.Mean())
    rng = _rng(5)
    for _ in range(3):
        loss = np.float32(rng.normal())
        a, b = (rng.normal(size=(B, T, D)).astype(np.float32) for _ in range(2))
        handlers[0].accumulate('train', loss=jnp.asarray(loss), err=(jnp.asarray(a), jnp.asarray(b)),
                               extra=[jnp.asarray(a), {'seq_len': jnp.asarray(SEQ_LEN)}])
        handlers[1].accumulate('train', loss=torch.tensor(loss), err=(torch.from_numpy(a), torch.from_numpy(b)),
                               extra=[torch.from_numpy(a), {'seq_len': torch.from_numpy(SEQ_LEN)}])
    assert len(handlers[1]._pending) == 9
    want, got = (h.results_as_json_dict('train') for h in handlers)
    assert sorted(got) == sorted(want) == ['extra', 'loss']
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL)
    assert not handlers[1]._pending
    for h in handlers:
        h.reset_state('train')
    assert handlers[1].results_as_json_dict('train') == handlers[0].results_as_json_dict('train') == {}


@pytest.mark.parametrize('weight_decay,grad_clip_norm', [(0.0, 0.0), (0.01, 1.5)])
def test_adam_and_ema_match_jax_over_five_steps(weight_decay, grad_clip_norm):
    """build_optimizer('adam') + apply_updates with EMA 0.9: the same grads
    each step, some above the clip norm and some below; parameters and EMA
    within 1e-6 abs after 5 steps."""
    rng = _rng(6)
    init = {'w': rng.normal(size=(4, 3)).astype(np.float32), 'b': rng.normal(size=(3,)).astype(np.float32)}
    lrs = [0.01, 0.01, 0.005, 0.02, 0.01]
    grads = [{k: (scale * rng.normal(size=v.shape)).astype(np.float32) for k, v in init.items()}
             for scale in (2.0, 0.1, 3.0, 0.5, 1.0)]

    jopt = jbuild_optimizer('adam', weight_decay=weight_decay, grad_clip_norm=grad_clip_norm)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate, jema = jopt.init(jparams), dict(jparams)
    for g, lr in zip(grads, lrs):
        jparams, jstate, jema, _ = japply_updates(jopt, 0.9, jparams, jstate, jema,
                                                  {k: jnp.asarray(v) for k, v in g.items()},
                                                  jnp.float32(lr))

    topt = tbuild_optimizer('adam', weight_decay=weight_decay, grad_clip_norm=grad_clip_norm)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    tstate = topt.init(list(tparams.values()))
    tema = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    for g, lr in zip(grads, lrs):
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        tapply_updates(topt, 0.9, tparams, tstate, tema, lr)
    for k in init:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]), atol=1e-6)
        np.testing.assert_allclose(tema[k].numpy(), np.asarray(jema[k]), atol=1e-6)


def test_other_optimizers_are_not_ported():
    with pytest.raises(NotImplementedError, match='adamw'):
        tbuild_optimizer('adamw')
    with pytest.raises(ValueError):
        tbuild_optimizer('rmsprop')


@pytest.mark.parametrize('setting', [{'momentum': 0.9}, {'nesterov': True}])
def test_settings_of_other_optimizers_are_refused(setting):
    """A setting that Adam does not read is an error, not a silent no-op."""
    with pytest.raises(TypeError, match=next(iter(setting))):
        tbuild_optimizer('adam', **setting)


def test_ema_update_matches_jax():
    from morgana_tpu import nn as jnn
    rng = _rng(7)
    shadow, x = ({'a': rng.normal(size=(3,)).astype(np.float32)} for _ in range(2))
    want = jnn.ema_update({'a': jnp.asarray(shadow['a'])}, {'a': jnp.asarray(x['a'])}, 0.99)
    got = tnn.ema_update({'a': torch.from_numpy(shadow['a'])}, {'a': torch.from_numpy(x['a'])}, 0.99)
    np.testing.assert_allclose(got['a'].numpy(), np.asarray(want['a']), atol=1e-7)


SCHEDULE_KWARGS = {
    'lambda': {'lr_lambda': lambda epoch: 0.9 ** epoch}, 'step': {'step_size': 3},
    'multi_step': {'milestones': (2, 7)}, 'cosine_annealing': {'T_max': 10},
    'cosine_annealing_warm_restarts': {'T_0': 4, 'T_mult': 2}, 'cyclic': {'step_size_up': 3},
    'plateau': {'patience': 1}, 'noam': {'warmup_steps': 5}, 'cyclic_noam': {'warmup_steps': 5,
                                                                           'cycle_steps': 7},
}


@pytest.mark.parametrize('name', sorted(jschedules.SUPPORTED))
def test_lr_schedule_matches_jax_over_20_steps(name):
    assert sorted(tschedules.SUPPORTED) == sorted(jschedules.SUPPORTED)
    assert tschedules.EPOCH_LR_SCHEDULES == jschedules.EPOCH_LR_SCHEDULES
    assert tschedules.BATCH_LR_SCHEDULES == jschedules.BATCH_LR_SCHEDULES
    kwargs = SCHEDULE_KWARGS.get(name, {})
    jsched = jschedules.init_lr_schedule(name, **kwargs)(0.01)
    tsched = tschedules.init_lr_schedule(name, **kwargs)(0.01)
    losses = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5] * 4
    for step in range(20):
        assert tsched.lr == jsched.lr, (name, step)
        metric = losses[step] if name == 'plateau' else None
        jsched.step(metric)
        tsched.step(metric)


@pytest.mark.parametrize('drop_remainder', [False, True])
def test_loader_order_matches_jax_over_three_epochs(drop_remainder):
    """The seeded per-epoch shuffle, in the JAX loader's order, with and
    without the remainder batch."""
    items = list(range(11))
    jloader = JLoader(items, batch_size=3, shuffle=True, seed=5, drop_remainder=drop_remainder)
    tloader = TLoader(items, batch_size=3, shuffle=True, seed=5, drop_remainder=drop_remainder)
    assert len(tloader) == len(jloader)
    jloader.set_epoch(1)
    tloader.set_epoch(1)
    for _ in range(3):
        want, got = jloader.iter_batch_indices(), tloader.iter_batch_indices()
        assert [list(map(int, b)) for b in got] == [list(map(int, b)) for b in want]


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize('speakers', [None, ['spk_a', 'spk_b']], ids=['one_voice', 'two_speakers'])
def test_generate_voice_data_writes_the_jax_files(tmp_path, speakers):
    """The same seed writes the same corpus: file names, arrays, text files
    and normaliser statistics."""
    kwargs = dict(num_train=3, num_valid=2, num_test=1, seed=9, sp_bins=7, speakers=speakers)
    jroot, troot = str(tmp_path / 'jax'), str(tmp_path / 'port')
    assert tgenerate(troot, **kwargs) == jgenerate(jroot, **kwargs)
    files = _tree_files(jroot)
    assert _tree_files(troot) == files and len(files) > 40
    for name in files:
        a, b = os.path.join(jroot, name), os.path.join(troot, name)
        if name.endswith('.npy'):
            np.testing.assert_array_equal(np.load(b), np.load(a))
        elif name.endswith('.json'):
            with open(a) as fa, open(b) as fb:
                assert json.load(fb) == json.load(fa), name
        else:
            assert filecmp.cmp(a, b, shallow=False), name
