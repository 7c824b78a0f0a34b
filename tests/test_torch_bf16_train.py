"""Training in bf16 (``--compute_dtype bfloat16``) with the port against the
JAX package under ``nn.set_default_compute_dtype('bfloat16')``, on the CPU,
where each kernel's plain version runs (the kernels K1c with its gate
trace, K2c, K4c, K5b's backward and the bf16 weight-gradient carry are held
to those plain versions on the card, ``tests/test_torch_kernels.py`` and
``chip_smoke.py``).

The gradients are JAX's autodiff of its bf16 forward. Both packages round
the same operands to bf16 and sum exact products in f32, in other orders,
so a gradient may land on the other side of a bf16 rounding boundary; the
bounds below say how far, each against the gradient's largest |value|:

* the recurrent layers' dW_hh, dx and dW_ih at B4 T256 (the repair of the
  bf16 carry): the largest error within ``CARRY_RTOL`` = 5e-3 and at most
  ``CARRY_OFF`` = 5% of the elements more than one bf16 ulp (of each
  element) from JAX's (measured at these seeds: up to 2.8e-3 and 0.05%; an
  f32 sum of dW_hh rounded once, the port before the repair, gives 4.7e-2
  and 69% at B4 T256);
* the modules and the whole train steps: the largest error within
  ``GRAD_MAX_RTOL`` = 2^-7 (two bf16 ulps at the largest |value|; measured
  up to 6.3e-3) and the mean error within ``GRAD_MEAN_RTOL`` = 2e-4
  (measured up to 7.7e-5, a LayerNorm bias);
* the loss of a train step within ``LOSS_RTOL`` = 1e-5 relative (measured
  6.2e-7), and after Adam's first step the parameters within ``PARAM_ATOL``
  = 1e-6 wherever JAX's gradient is at least ``SIGN_FLOOR`` = 2^-6 of its
  largest |value|: there Adam's first update is ``lr * sign(g)`` in both,
  whereas near 0 a sign flip within the bounds above moves it by 2 lr.

Every test sets the compute dtype of both packages back to f32 when it
ends (:func:`_bf16`), so that no other test sees bf16.
"""
import contextlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import builder_args
from morgana_tpu import nn as jnn
from morgana_tpu.experiment_builder import ExperimentBuilder as JBuilder
from morgana_tpu.ops import attention as jattention
from morgana_tpu.ops import rnn as jrnn
from morgana_tpu.training import TrainLoop as JLoop
from morgana_tpu.training import build_optimizer as jbuild_optimizer
from morgana_tpu.training import numeric_features, staged_value_and_grad

from morgana_tpu_torch import data as tdata
from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch.experiment_builder import ExperimentBuilder as TBuilder
from morgana_tpu_torch.models import f0_test_model as tf0
from morgana_tpu_torch.models import rnn_spss as trnn
from morgana_tpu_torch.models import transformer_spss as ttransformer
from morgana_tpu_torch.ops import flash_attention as fa
from morgana_tpu_torch.ops import gru as gru_ops
from morgana_tpu_torch.ops import lstm as lstm_ops
from morgana_tpu_torch.training import TrainLoop as TLoop
from morgana_tpu_torch.training import build_optimizer as tbuild_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'models'))
try:
    from f0_test_model import F0Model as JF0
    from rnn_spss import LSTMAcousticModel as JLSTM
    from transformer_spss import TransformerAcousticModel as JTransformer
finally:
    sys.path.pop(0)

CARRY_RTOL = 5e-3
CARRY_OFF = 0.05
GRAD_MAX_RTOL = 2.0 ** -7
GRAD_MEAN_RTOL = 2e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
SIGN_FLOOR = 2.0 ** -6
LR = 0.01
# name: (JAX model, port model, model_kwargs)
MODELS = {
    'f0': (JF0, tf0.F0Model, {}),
    'lstm': (JLSTM, trnn.LSTMAcousticModel, {'num_layers': 2, 'hidden_size': 64}),
    'transformer': (JTransformer, ttransformer.TransformerAcousticModel,
                    {'num_layers': 2, 'd_model': 64, 'num_heads': 4}),
}


@contextlib.contextmanager
def _bf16(port=True, jax_=True):
    """Both packages' compute dtype bf16 inside, f32 (None) after."""
    try:
        if port:
            tnn.set_default_compute_dtype('bfloat16')
        if jax_:
            jnn.set_default_compute_dtype('bfloat16')
        yield
    finally:
        tnn.set_default_compute_dtype(None)
        jnn.set_default_compute_dtype(None)


def _t(array):
    return torch.from_numpy(np.asarray(array))


def _hold_grad(got, want, label):
    """``got`` against JAX's ``want``: largest error within GRAD_MAX_RTOL and
    mean error within GRAD_MEAN_RTOL of the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert err.max() <= GRAD_MAX_RTOL * scale and err.mean() <= GRAD_MEAN_RTOL * scale, \
        (label, err.max() / scale, err.mean() / scale)


# ------------------------------------------------- the repair: the bf16 carry

def _rnn_case(mode, seed, batch=4, steps=256, in_dim=16, hidden=32):
    rng = np.random.default_rng(seed)
    gates = (4 if mode == 'lstm' else 3) * hidden
    bound = hidden ** -0.5
    x = rng.normal(size=(batch, steps, in_dim)).astype(np.float32)
    weights = [rng.uniform(-bound, bound, shape).astype(np.float32)
               for shape in ((in_dim, gates), (hidden, gates), (gates,), (gates,))]
    seq_len = np.array([steps, steps - 5, steps // 2, 1])
    dy = rng.normal(size=(batch, steps, hidden)).astype(np.float32)
    return x, weights, seq_len, dy


LAYERS = {'lstm': (jrnn.lstm, lstm_ops.lstm_layer, lstm_ops.lstm_layer_reference),
          'gru': (jrnn.gru, gru_ops.gru_layer, gru_ops.gru_layer_reference)}


@pytest.mark.parametrize('plain', [False, True], ids=['layer', 'reference'])
@pytest.mark.parametrize('mode', ['lstm', 'gru'])
def test_recurrent_bf16_gradients_carry_dw_hh_in_bf16(mode, plain):
    """lstm_layer / gru_layer (and their _reference) with compute_dtype bf16
    at B4 T256 I16 H32, ragged seq_len: dx, dW_ih and dW_hh of sum(y * dy)
    against jax.grad of ops.rnn.lstm / gru(compute_dtype=bf16), whose scan
    carries dW_hh in bf16. Largest error within CARRY_RTOL of the largest
    |JAX|, at most CARRY_OFF of the elements more than one bf16 ulp off."""
    jax_fn, layer, reference = LAYERS[mode]
    x, weights, seq_len, dy = _rnn_case(mode, 20 + len(mode))

    def loss(x, *w):
        y = jax_fn(x, *w, seq_len=jnp.asarray(seq_len), compute_dtype=jnp.bfloat16)[0]
        return jnp.sum(y * dy)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), *map(jnp.asarray, weights))
    leaves = [_t(a).requires_grad_(True) for a in (x, *weights)]
    y = (reference if plain else layer)(*leaves, seq_len=_t(seq_len),
                                        compute_dtype='bfloat16')[0]
    (y * _t(dy)).sum().backward()
    for name, leaf, w in zip(('dx', 'dW_ih', 'dW_hh'), leaves, want):
        got, w = leaf.grad.numpy().astype(np.float64), np.asarray(w, np.float64)
        err = np.abs(got - w)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
        assert err.max() <= CARRY_RTOL * np.abs(w).max(), (name, err.max() / np.abs(w).max())
        assert np.mean(err > ulp) <= CARRY_OFF, (name, np.mean(err > ulp))
    # The bf16 carry leaves bf16 values in dW_hh.
    dw_hh = leaves[2].grad
    torch.testing.assert_close(dw_hh, dw_hh.to(torch.bfloat16).float(), rtol=0, atol=0)


# ------------------------------------------------------------- the modules

def test_linear_gradients_match_jax():
    """Linear under both globals: dx, dW and db of sum(out * w) against
    jax.grad (dx and dW each one rounded f32 product, nn.py:110-121)."""
    jnn.manual_seed(30)
    jlin = jnn.Linear(48, 40)
    tlin = tnn.Linear(48, 40)
    params = jnn.state_dict(jlin)
    tnn.load_jax_params(tlin, params)
    rng = np.random.default_rng(31)
    x = rng.normal(size=(3, 11, 48)).astype(np.float32)
    w = rng.normal(size=(3, 11, 40)).astype(np.float32)
    with _bf16():
        def loss(p, x):
            with jnn.bind(jlin, p):
                return jnp.sum(jlin(x) * w)

        want_p, want_x = jax.grad(loss, argnums=(0, 1))(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
        x_t = _t(x).requires_grad_(True)
        (tlin(x_t) * _t(w)).sum().backward()
    _hold_grad(x_t.grad.numpy(), want_x, 'dx')
    for name, p in tlin.named_parameters():
        _hold_grad(p.grad.numpy(), want_p[name], name)
    # dx and dW are rounded to bf16 (the transpose of the cast rounds them).
    for g in (x_t.grad, tlin.weight.grad):
        torch.testing.assert_close(g, g.to(torch.bfloat16).float(), rtol=0, atol=0)


ATTENTION_MASKS = {'full': (False, None, False), 'padded': (False, None, True),
                   'causal': (True, None, True), 'window': (True, 5, True)}


@pytest.mark.parametrize('mask', list(ATTENTION_MASKS))
def test_attention_gradients_match_jax(mask):
    """dq, dk and dv of the bf16 attention (flash_attention with compute_dtype
    bf16, autograd through its plain version on the CPU, and the plain
    backward that K5b's backward is held to, attention_backward_reference)
    against jax.grad of JAX's plain attention with the same biases, for a
    loss on the rows below seq_len."""
    causal, window, padded = ATTENTION_MASKS[mask]
    rng = np.random.default_rng(sum(map(ord, mask)))
    q, k, v = (rng.normal(size=(3, 4, 33, 64)).astype(np.float32) for _ in range(3))
    seq_len = np.array([33, 17, 1]) if padded else None
    rows = np.arange(33)[None, :] < (np.full(3, 33) if seq_len is None else seq_len)[:, None]
    do = rng.normal(size=q.shape).astype(np.float32) * rows[:, None, :, None]
    bias = fa.attention_bias(None if seq_len is None else _t(seq_len), 33, causal, window)

    def loss(q, k, v):
        out = jattention.scaled_dot_product_attention(
            q, k, v, bias=None if bias is None else jnp.asarray(bias.numpy()),
            compute_dtype=jnp.bfloat16)
        return jnp.sum(out * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    sl = None if seq_len is None else _t(seq_len)
    out = fa.flash_attention(*leaves, seq_len=sl, causal=causal, window=window,
                             compute_dtype=torch.bfloat16)
    (out * _t(do)).sum().backward()
    plain = fa.attention_backward_reference(*(t.to(torch.bfloat16) for t in (_t(q), _t(k), _t(v))),
                                            _t(do), seq_len=sl, causal=causal, window=window)
    for name, leaf, p, w in zip('qkv', leaves, plain, want):
        _hold_grad(leaf.grad.numpy(), w, f'd{name}')
        _hold_grad(p.float().numpy(), w, f'd{name} plain backward')
        assert p.dtype == torch.bfloat16


def test_multi_head_attention_gradients_match_jax():
    """MultiHeadAttention under both globals (bf16 projections and attention,
    causal with a window): dx and every parameter's gradient against
    jax.grad, for a loss on the rows below seq_len."""
    jnn.manual_seed(33)
    jmha = jnn.MultiHeadAttention(64, 4)
    tmha = tnn.MultiHeadAttention(64, 4)
    params = jnn.state_dict(jmha)
    tnn.load_jax_params(tmha, params)
    rng = np.random.default_rng(34)
    x = rng.normal(size=(3, 29, 64)).astype(np.float32)
    seq_len = np.array([29, 12, 3])
    w = rng.normal(size=x.shape).astype(np.float32)
    w *= (np.arange(29)[None, :] < seq_len[:, None])[..., None]
    with _bf16():
        def loss(p, x):
            with jnn.bind(jmha, p):
                return jnp.sum(jmha(x, seq_len=jnp.asarray(seq_len), causal=True, window=6) * w)

        want_p, want_x = jax.grad(loss, argnums=(0, 1))(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
        x_t = _t(x).requires_grad_(True)
        (tmha(x_t, seq_len=_t(seq_len), causal=True, window=6) * _t(w)).sum().backward()
    _hold_grad(x_t.grad.numpy(), want_x, 'dx')
    for name, p in tmha.named_parameters():
        _hold_grad(p.grad.numpy(), want_p[name], name)


@pytest.mark.parametrize('mode', ['lstm', 'gru'])
def test_pallas_backend_trains_in_f32_under_bf16(mode):
    """A 'pallas' Recurrent under a bf16 global takes the f32 gradient, bit for
    bit that of the same stack without it (nn.py:659-664); the 'scan' stack's
    differs."""
    rnn = tnn.Recurrent(mode, 12, 32, num_layers=2, backend='pallas',
                        generator=torch.Generator().manual_seed(35))
    x = torch.from_numpy(np.random.default_rng(36).normal(size=(2, 15, 12)).astype(np.float32))
    seq_len = torch.tensor([15, 9])

    def grads():
        rnn.zero_grad()
        out, _ = rnn(x, seq_len=seq_len)
        out.square().sum().backward()
        return [p.grad.clone() for p in rnn.parameters()]

    f32 = grads()
    with _bf16(jax_=False):
        pallas = grads()
        rnn.backend = 'scan'
        scan = grads()
    for got, want in zip(pallas, f32):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert any(not torch.equal(s, f) for s, f in zip(scan, f32))


# ------------------------------------------------------- whole train steps

def _models(name, root):
    """The JAX and port models of ``name`` on the same seeded weights, with
    the corpus' normalisers, in train mode."""
    jmodel, tmodel, kwargs = MODELS[name]
    jnn.manual_seed(40)
    jm, tm = jmodel(**kwargs), tmodel(**kwargs)
    tnn.load_jax_params(tm, jnn.state_dict(jm))
    for model in (jm, tm):
        model.normalisers = model.normaliser_sources()
        for normaliser in model.normalisers.values():
            normaliser.load_params('train', root)
        model.mode = 'train'
    return jm, tm


@pytest.mark.parametrize('name', list(MODELS))
def test_train_step_matches_the_jax_train_loop(voice_data, name):
    """One Adam train step (lr 0.01) of F0Model, a 2 x LSTM(64)
    LSTMAcousticModel and a 2-block Transformer (d_model 64, 4 heads) on four
    training utterances under both globals: the port's TrainLoop against
    the JAX TrainLoop (the loss, and the parameters after the step where
    JAX's gradient clears SIGN_FLOOR) and every parameter's gradient against
    staged_value_and_grad, the JAX step's gradient."""
    root = voice_data['data_root']
    with _bf16():
        jm, tm = _models(name, root)
        dataset = tdata.FilesDataset(tm.train_data_sources(), 'train',
                                     'train/train_file_id_list.scp', tm.normalisers, root)
        batch = tdata.collate([dataset[i] for i in range(4)])
        jbatch = dict(numeric_features(batch), global_step=jnp.asarray(0, jnp.int32))
        grad_fn = jax.jit(lambda p, b: staged_value_and_grad(jm, p, b, jax.random.PRNGKey(0)))
        want_g = grad_fn(jnn.parameters(jm), jbatch)[3]
        jloop = JLoop(jm, jbuild_optimizer('adam'))
        jloss, _, _ = jloop.train_step(batch, LR)
        tloop = TLoop(tm, tbuild_optimizer('adam'))
        tloss, _ = tloop.train_step(batch, LR)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for pname, param in tm.named_parameters():
        want = np.asarray(want_g[pname])
        _hold_grad(param.grad.numpy(), want, pname)
        sure = np.abs(want) >= SIGN_FLOOR * np.abs(want).max()
        np.testing.assert_allclose(param.detach().numpy()[sure],
                                   np.asarray(jloop.params[pname])[sure], rtol=0,
                                   atol=PARAM_ATOL, err_msg=pname)


# ------------------------------------------------------------ the builder

def _port_argv(root, base, *flags):
    return ['--experiment_name', 'port', '--experiments_base', base, '--data_root', root,
            '--train_id_list', 'train/train_file_id_list.scp',
            '--valid_id_list', 'valid/valid_file_id_list.scp', '--batch_size', '4',
            '--end_epoch', '1', '--learning_rate', str(LR), '--device', 'cpu', *flags]


@pytest.mark.parametrize('dtype', ['float16', 'int8'])
def test_builder_refuses_a_compute_dtype_the_port_lacks(voice_data, tmp_path, capsys, dtype):
    """--compute_dtype takes float32 and bfloat16; another dtype is an
    argparse error naming ROADMAP.md."""
    argv = _port_argv(voice_data['data_root'], str(tmp_path), '--compute_dtype', dtype)
    with pytest.raises(SystemExit):
        TBuilder.get_experiment_args(argv)
    assert 'ROADMAP.md' in capsys.readouterr().err
    assert TBuilder.get_experiment_args(argv[:-2])['compute_dtype'] == 'float32'


def test_jax_builder_resumes_a_port_bf16_checkpoint(voice_data, tmp_path):
    """The port's builder trains F0Model for an epoch with --compute_dtype
    bfloat16 (it sets the process's compute dtype and writes it to
    config.json, as the JAX builder does); its epoch_1.npz holds float32
    parameters, and the JAX builder resumes from it and its .train.pkl in
    bf16 for epoch 2: Adam's step count goes on from the port's."""
    root = voice_data['data_root']
    try:
        exp = TBuilder(tf0.F0Model, **TBuilder.get_experiment_args(
            _port_argv(root, str(tmp_path), '--compute_dtype', 'bfloat16')))
        assert tnn.default_compute_dtype() is torch.bfloat16
        exp.run_experiment()
    finally:
        tnn.set_default_compute_dtype(None)
    port_dir = tmp_path / 'port'
    with open(port_dir / 'config.json') as f:
        assert json.load(f)['compute_dtype'] == 'bfloat16'
    ckpt = str(port_dir / 'checkpoints' / 'epoch_1.npz')
    with np.load(ckpt) as saved:
        assert saved.files and all(saved[k].dtype == np.float32 for k in saved.files)
    steps = exp.loop.step_count
    assert steps > 0
    args = builder_args(root, str(tmp_path / 'jax'), checkpoint_path=ckpt, start_epoch=2,
                        end_epoch=2, valid=False, learning_rate=LR, compute_dtype='bfloat16')
    try:
        jexp = JBuilder(JF0, experiment_name='jax', **args)
        jexp.run_experiment()
    finally:
        jnn.set_default_compute_dtype(None)
    assert jexp.loop.step_count == 2 * steps
    loss = json.load(open(tmp_path / 'jax' / 'jax' / 'train' / 'epoch_2' / 'metrics.json'))['loss']
    assert np.isfinite(loss)
