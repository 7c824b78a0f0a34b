"""bf16 serving of the port (``--compute_dtype bfloat16``) against the JAX
package under ``nn.set_default_compute_dtype('bfloat16')``, on the CPU:
the compute-dtype global, ``Linear``, the LSTM and GRU layers, the plain
attention, ``MultiHeadAttention.forward`` and ``.step``, the 'pallas'
backend and a layer's own ``compute_dtype``, then the served models
(``LSTMAcousticModel``, ``F0Model``, ``TransformerAcousticModel``, an int8
LSTM voice and the ``DurationModel`` -> ``LSTMAcousticModel`` pipeline)
through ``InferenceEngine(compute_dtype='bfloat16', device='cpu')`` and
their streams. On the CPU each kernel's plain version runs; the kernels
K1c, K3c and K5b are held to those on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).

Weights are seeded JAX parameters, loaded by both packages; inputs are
seeded numpy arrays. Both packages round the same operands to bf16 (round to
nearest even) and sum the exact products in f32, in other orders. So:

* each output of the port against JAX's: its mean |error| within
  ``MEAN_RTOL`` = 3e-5 of the output's largest |value| (the bulk: about
  1e-8 where no rounding parts the packages, up to 1.4e-5 measured where
  one does), and its largest |error| within ``MAX_RTOL`` = 2^-8 of it, a
  bf16-sized bound: an f32 sum that falls on the other side of a bf16
  rounding boundary in one package moves that rounded h (or probability)
  by one bf16 ulp, and the recurrence carries it on (up to 9.4e-4
  measured);
* the MLPG trajectories (lf0, mcep, bap), which the solve smooths: the
  error against JAX and the bf16 rounding shrink alike (measured: below
  7e-7, and from 7e-6 up against f32), so their mean bound is
  ``TRAJ_MEAN_RTOL`` = 5e-6;
* the guard against a silent f32 path: the port's bf16 outputs differ from
  its f32 outputs on the same inputs, in the mean over every element and
  in units of each output's mean bound at its largest |value|, by more than
  1 (measured: 3.4 and up; an f32 path, whose only difference from f32 is
  the order of its sums, would give about 1e-3);
* the 'pallas' backend under a bf16 global equals f32 bit for bit, as the
  JAX package holds its own (``tests/test_nn.py:205-226``);
* integer durations of the pipeline equal, its float durations and
  features within the bounds above.

Every test sets the compute dtype of both packages back to f32 when it
ends (:func:`_bf16`), so that no other test sees bf16.
"""
import contextlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu import nn as jnn
from morgana_tpu import pipeline as jpipeline
from morgana_tpu.ops import attention as jattention
from morgana_tpu.ops import rnn as jrnn
from morgana_tpu.serve import InferenceEngine as JEngine

from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch import pipeline as tpipeline
from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.models import duration_model as tduration
from morgana_tpu_torch.models import f0_test_model as tf0
from morgana_tpu_torch.models import rnn_spss as trnn
from morgana_tpu_torch.models import transformer_spss as ttransformer
from morgana_tpu_torch.ops import attention as tattention
from morgana_tpu_torch.ops import flash_attention as fa
from morgana_tpu_torch.ops import gru as gru_ops
from morgana_tpu_torch.ops import lstm as lstm_ops
from morgana_tpu_torch.serve import InferenceEngine as TEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'models'))
try:
    from duration_model import DurationModel as JDur
    from f0_test_model import F0Model as JF0
    from rnn_spss import LSTMAcousticModel as JLSTM
    from transformer_spss import TransformerAcousticModel as JTransformer
finally:
    sys.path.pop(0)

MEAN_RTOL = 3e-5
TRAJ_MEAN_RTOL = 5e-6
TRAJECTORIES = ('lf0', 'mcep', 'bap')
MAX_RTOL = 2.0 ** -8
CAUSAL = {'num_layers': 2, 'd_model': 32, 'num_heads': 4, 'causal': True,
          'attention_window': 24}
# name: (JAX model, port model, model_kwargs, seed)
MODELS = {
    'lstm': (JLSTM, trnn.LSTMAcousticModel, {'num_layers': 2, 'hidden_size': 32}, 81),
    'f0': (JF0, tf0.F0Model, {}, 82),
    'transformer': (JTransformer, ttransformer.TransformerAcousticModel, CAUSAL, 83),
}
DUR_KWARGS = {'hidden_size': 16}
STREAM = (16, 32, 16)   # chunk_frames, context, lookahead


@contextlib.contextmanager
def _bf16(port=True, jax=True):
    """Both packages' compute dtype bf16 inside, f32 (None) after."""
    try:
        if port:
            tnn.set_default_compute_dtype('bfloat16')
        if jax:
            jnn.set_default_compute_dtype('bfloat16')
        yield
    finally:
        tnn.set_default_compute_dtype(None)
        jnn.set_default_compute_dtype(None)


def _mean_rtol(key):
    """The mean bound of output ``key``: TRAJ_MEAN_RTOL for an MLPG
    trajectory, MEAN_RTOL for the rest."""
    return TRAJ_MEAN_RTOL if key in TRAJECTORIES else MEAN_RTOL


def _near(got, want, label='', keys=None):
    """Each of the port's bf16 outputs ``got`` against JAX's ``want`` (lists
    of arrays, named by ``keys``): mean |error| within its mean bound and
    largest |error| within MAX_RTOL of the output's largest |value|.
    Returns those values."""
    keys = keys or [None] * len(want)
    scales = []
    for key, g, w in zip(keys, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (label, key, g.shape, w.shape)
        scale = float(np.abs(w).max()) if w.size else 0.0
        err = np.abs(g - w)
        assert not w.size or (err.mean() <= _mean_rtol(key) * scale
                              and err.max() <= MAX_RTOL * scale), \
            (label, key, 'against JAX', err.mean() / scale, err.max() / scale)
        scales.append(scale)
    assert len(scales) == len(want)
    return scales


def _rounded(got, f32, scales, label='', keys=None):
    """The guard: the mean |difference| between the port's bf16 outputs
    ``got`` and its f32 outputs ``f32`` on the same inputs, each in units of
    its mean bound at its largest |value| (``scales``), above 1."""
    keys = keys or [None] * len(got)
    off = np.concatenate([
        np.abs(np.asarray(g, np.float64) - np.asarray(f, np.float64)).reshape(-1)
        / (scale * _mean_rtol(key)) for key, g, f, scale in zip(keys, got, f32, scales) if scale])
    assert off.mean() > 1, (label, 'no bf16 rounding', off.mean())


def _hold(got, want, f32, label='', keys=None):
    """:func:`_near` and :func:`_rounded`."""
    _rounded(got, f32, _near(got, want, label, keys), label, keys)


def _hold_dicts(got, want, f32, label=''):
    """:func:`_hold` over the outputs of ``want`` (dicts by name)."""
    keys = sorted(want)
    assert sorted(got) == keys, label
    _hold([got[k] for k in keys], [want[k] for k in keys], [f32[k] for k in keys], label, keys)


def _rng(name):
    return np.random.default_rng(sum(map(ord, name)))


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _t(array):
    return torch.from_numpy(np.asarray(array))


# ------------------------------------------------------------- the global

@pytest.mark.parametrize('name', [None, 'float32', 'f32', 'none', 'bfloat16'])
def test_compute_dtype_names_are_the_jax_packages(name):
    """Each name JAX's set_default_compute_dtype takes for f32 or bf16 sets
    the port's to None or torch.bfloat16 alike."""
    try:
        tnn.set_default_compute_dtype(name)
        jnn.set_default_compute_dtype(name)
        want = jnn.default_compute_dtype()
        got = tnn.default_compute_dtype()
        assert (got is None) == (want is None)
        assert got in (None, torch.bfloat16)
        assert (got is None) == (name != 'bfloat16')
    finally:
        tnn.set_default_compute_dtype(None)
        jnn.set_default_compute_dtype(None)


@pytest.mark.parametrize('name', ['float16', 'float64'])
def test_a_dtype_the_port_lacks_raises_naming_the_roadmap(name):
    """JAX computes in any dtype; the port refuses the others rather than
    computing them in f32, and leaves its compute dtype as it was."""
    with pytest.raises(ValueError, match='ROADMAP.md'):
        tnn.set_default_compute_dtype(name)
    assert tnn.default_compute_dtype() is None
    with pytest.raises(ValueError, match='ROADMAP.md'):
        tnn.Recurrent('gru', 4, 8, compute_dtype=name)


def test_engine_sets_the_process_dtype(voice_data, tmp_path):
    """InferenceEngine(compute_dtype='bfloat16') sets the process's compute
    dtype (serve.py:143-144); None leaves it as it is."""
    jnn.manual_seed(5)
    ckpt = JDur(**DUR_KWARGS).save_parameters(str(tmp_path / 'dur'), 0)
    common = dict(data_root=voice_data['data_root'], device='cpu', model_kwargs=DUR_KWARGS)
    try:
        TEngine(tduration.DurationModel, ckpt, compute_dtype='bfloat16', **common)
        assert tnn.default_compute_dtype() is torch.bfloat16
        TEngine(tduration.DurationModel, ckpt, **common)
        assert tnn.default_compute_dtype() is torch.bfloat16
        with pytest.raises(ValueError, match='ROADMAP.md'):
            TEngine(tduration.DurationModel, ckpt, compute_dtype='float16', **common)
    finally:
        tnn.set_default_compute_dtype(None)


# ------------------------------------------------------------ the modules

def test_linear_matches_jax():
    rng = _rng('linear')
    jnn.manual_seed(7)
    jlin = jnn.Linear(48, 40)
    tlin = tnn.Linear(48, 40)
    tnn.load_jax_params(tlin, jnn.state_dict(jlin))
    x = _normal(rng, 3, 11, 48)
    with torch.no_grad():
        f32 = tlin(_t(x)).numpy()
        with _bf16():
            got, want = tlin(_t(x)).numpy(), np.asarray(jlin(jnp.asarray(x)))
    assert got.dtype == np.float32
    _hold([got], [want], [f32], 'linear')


def _rnn_case(mode, hidden, with_state, seed):
    rng = np.random.default_rng(seed)
    gates = (4 if mode == 'lstm' else 3) * hidden
    bound = hidden ** -0.5
    x = _normal(rng, 3, 40, 24)
    weights = [rng.uniform(-bound, bound, shape).astype(np.float32)
               for shape in ((24, gates), (hidden, gates), (gates,), (gates,))]
    seq_len = np.array([40, 23, 0])
    state = [_normal(rng, 3, hidden, scale=0.5) for _ in range(2 if mode == 'lstm' else 1)]
    return x, weights, seq_len, state if with_state else None


@pytest.mark.parametrize('with_state', [False, True], ids=['zero-state', 'state'])
@pytest.mark.parametrize('hidden', [64, 128])
def test_lstm_layer_matches_jax(hidden, with_state):
    """lstm_layer(compute_dtype='bfloat16') against ops.rnn.lstm(compute_dtype=
    bf16): y and (hn, cn), with a ragged seq_len (a row of length 0)."""
    x, weights, seq_len, state = _rnn_case('lstm', hidden, with_state, hidden + with_state)
    kwargs = {} if state is None else {'h0': state[0], 'c0': state[1]}
    jy, (jh, jc) = jrnn.lstm(jnp.asarray(x), *weights, seq_len=jnp.asarray(seq_len),
                             compute_dtype=jnp.bfloat16, **kwargs)
    outputs = {}
    for compute in (None, 'bfloat16'):
        y, (h, c) = lstm_ops.lstm_layer(_t(x), *map(_t, weights), seq_len=_t(seq_len),
                                        compute_dtype=compute,
                                        **{k: _t(v) for k, v in kwargs.items()})
        outputs[compute] = [y.numpy(), h.numpy(), c.numpy()]
    _hold(outputs['bfloat16'], [jy, jh, jc], outputs[None], 'lstm')


@pytest.mark.parametrize('with_state', [False, True], ids=['zero-state', 'state'])
@pytest.mark.parametrize('hidden', [64, 128])
def test_gru_layer_matches_jax(hidden, with_state):
    """gru_layer(compute_dtype='bfloat16') against ops.rnn.gru(compute_dtype=
    bf16): y and hn, with a ragged seq_len (a row of length 0)."""
    x, weights, seq_len, state = _rnn_case('gru', hidden, with_state, 2 * hidden + with_state)
    h0 = None if state is None else state[0]
    jy, jh = jrnn.gru(jnp.asarray(x), *weights, seq_len=jnp.asarray(seq_len), h0=h0,
                      compute_dtype=jnp.bfloat16)
    outputs = {}
    for compute in (None, 'bfloat16'):
        y, h = gru_ops.gru_layer(_t(x), *map(_t, weights), seq_len=_t(seq_len),
                                 h0=None if h0 is None else _t(h0), compute_dtype=compute)
        outputs[compute] = [y.numpy(), h.numpy()]
    _hold(outputs['bfloat16'], [jy, jh], outputs[None], 'gru')


ATTENTION_MASKS = {'full': (False, None, False), 'padded': (False, None, True),
                   'causal': (True, None, True), 'window': (True, 5, True)}


@pytest.mark.parametrize('mask', list(ATTENTION_MASKS))
def test_attention_matches_jax(mask):
    """flash_attention(compute_dtype=bf16) (K5b's plain version on the CPU)
    and scaled_dot_product_attention(compute_dtype=bf16) against JAX's
    plain attention with the same biases, on the rows below seq_len."""
    causal, window, padded = ATTENTION_MASKS[mask]
    rng = _rng(mask)
    q, k, v = (_normal(rng, 3, 4, 33, 64) for _ in range(3))
    seq_len = np.array([33, 17, 0]) if padded else None
    bias = fa.attention_bias(None if seq_len is None else _t(seq_len), 33, causal, window)
    want = np.asarray(jattention.scaled_dot_product_attention(
        q, k, v, bias=None if bias is None else jnp.asarray(bias.numpy()),
        compute_dtype=jnp.bfloat16))
    args = (_t(q), _t(k), _t(v))
    got = fa.flash_attention(*args, seq_len=None if seq_len is None else _t(seq_len),
                             causal=causal, window=window, compute_dtype=torch.bfloat16)
    plain = tattention.scaled_dot_product_attention(*args, bias=bias,
                                                    compute_dtype=torch.bfloat16)
    f32 = fa.flash_attention(*args, seq_len=None if seq_len is None else _t(seq_len),
                             causal=causal, window=window)
    rows = np.arange(33)[None, :] < (np.full(3, 33) if seq_len is None else seq_len)[:, None]
    valid = rows[:, None, :, None]
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    _hold([got.numpy() * valid], [want * valid], [f32.numpy() * valid], mask)


def _attention_pair(seed, **kwargs):
    jnn.manual_seed(seed)
    jmha = jnn.MultiHeadAttention(64, 4, **kwargs)
    tmha = tnn.MultiHeadAttention(64, 4, **kwargs)
    tnn.load_jax_params(tmha, jnn.state_dict(jmha))
    return jmha, tmha.eval()


@pytest.mark.parametrize('causal,window', [(False, None), (True, 6)], ids=['full', 'window'])
def test_multi_head_attention_matches_jax(causal, window):
    """MultiHeadAttention.forward under both globals: the bf16 projections
    and attention, on the rows below seq_len."""
    jmha, tmha = _attention_pair(9)
    rng = _rng(f'mha{causal}')
    x = _normal(rng, 3, 29, 64)
    seq_len = np.array([29, 12, 3])
    with torch.no_grad():
        f32 = tmha(_t(x), seq_len=_t(seq_len), causal=causal, window=window).numpy()
        with _bf16():
            got = tmha(_t(x), seq_len=_t(seq_len), causal=causal, window=window).numpy()
            want = np.asarray(jmha(jnp.asarray(x), seq_len=jnp.asarray(seq_len), causal=causal,
                                   window=window))
    valid = (np.arange(29)[None, :] < seq_len[:, None])[..., None]
    _hold([got * valid], [want * valid], [f32 * valid], 'mha')


def test_multi_head_attention_step_matches_jax():
    """MultiHeadAttention.step, chunk after chunk over the KV cache, under
    both globals: the plain bf16 attention of the stream."""
    jmha, tmha = _attention_pair(10)
    x = _normal(_rng('step'), 2, 21, 64)
    window = 8
    outputs = {}
    for compute in (None, 'bfloat16'):
        cache = [np.zeros((2, window, 64), np.float32)] * 2
        jcache = [jnp.asarray(c) for c in cache]
        tcache = [_t(c) for c in cache]
        got, want = [], []
        with torch.no_grad(), (_bf16() if compute else contextlib.nullcontext()):
            for pos in range(0, 21, 7):
                chunk = x[:, pos:pos + 7]
                out, *tcache = tmha.step(_t(chunk), *tcache, pos, window)
                got.append(out.numpy())
                if compute:
                    jout, *jcache = jmha.step(jnp.asarray(chunk), *jcache, pos, window)
                    want.append(np.asarray(jout))
        outputs[compute] = (got, want)
    _hold(outputs['bfloat16'][0], outputs['bfloat16'][1], outputs[None][0], 'mha.step')


@pytest.mark.parametrize('mode', ['lstm', 'gru'])
def test_pallas_backend_ignores_the_global(mode):
    """A 'pallas' Recurrent under a bf16 global computes in f32, equal bit for
    bit to the same stack without it (nn.py:659-664); the 'scan' stack does
    round."""
    rnn = tnn.Recurrent(mode, 12, 32, num_layers=2, backend='pallas',
                        generator=torch.Generator().manual_seed(3))
    x = _t(_normal(_rng(mode), 2, 15, 12))
    seq_len = torch.tensor([15, 9])
    with torch.no_grad():
        f32, _ = rnn(x, seq_len=seq_len)
        with _bf16(jax=False):
            pallas, _ = rnn(x, seq_len=seq_len)
            rnn.backend = 'scan'
            scan, _ = rnn(x, seq_len=seq_len)
    torch.testing.assert_close(pallas, f32, rtol=0, atol=0)
    assert not torch.equal(scan, f32)


@pytest.mark.parametrize('mode,own,global_', [('lstm', 'float32', 'bfloat16'),
                                              ('gru', 'float32', 'bfloat16'),
                                              ('lstm', 'bfloat16', None),
                                              ('gru', 'bfloat16', None)],
                         ids=['lstm-f32-over-bf16', 'gru-f32-over-bf16',
                              'lstm-bf16-over-f32', 'gru-bf16-over-f32'])
def test_a_layers_own_compute_dtype_overrides_the_global(mode, own, global_):
    """Recurrent(compute_dtype=own) under the global ``global_`` computes as
    JAX's Recurrent(compute_dtype=own) does (nn.py:641-643), and as the
    same stack under the global ``own`` without a dtype of its own."""
    jnn.manual_seed(11)
    own_j = jnp.float32 if own == 'float32' else jnp.bfloat16
    jrec = jnn.Recurrent(mode, 12, 32, num_layers=2, compute_dtype=own_j)
    trec = tnn.Recurrent(mode, 12, 32, num_layers=2, compute_dtype=own)
    plain = tnn.Recurrent(mode, 12, 32, num_layers=2)
    tnn.load_jax_params(trec, jnn.state_dict(jrec))
    tnn.load_jax_params(plain, jnn.state_dict(jrec))
    x = _normal(_rng(f'{mode}{own}'), 2, 15, 12)
    seq_len = np.array([15, 9])
    with torch.no_grad():
        with _bf16() if global_ else contextlib.nullcontext():
            got, _ = trec(_t(x), seq_len=_t(seq_len))
            want, _ = jrec(jnp.asarray(x), seq_len=jnp.asarray(seq_len))
        with _bf16(jax=False) if own == 'bfloat16' else contextlib.nullcontext():
            same, _ = plain(_t(x), seq_len=_t(seq_len))
    torch.testing.assert_close(got, same, rtol=0, atol=0)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MAX_RTOL * scale)


# ------------------------------------------------------------ the engines

def _ids(root, split='test'):
    return file_io.get_file_ids(os.path.join(root, split, f'{split}_file_id_list.scp'))


def _checkpoint(name, base):
    jmodel, _, kwargs, seed = MODELS[name]
    jnn.manual_seed(seed)
    return jmodel(**kwargs).save_parameters(str(base / 'init'), 0)


@pytest.fixture(scope='module', params=list(MODELS))
def served(request, voice_data, tmp_path_factory):
    """One model's seeded checkpoint served by the port in f32 and by both
    packages in bf16 on the test split: batch predictions and each
    utterance's stream at STREAM."""
    name = request.param
    jmodel, tmodel, kwargs, _ = MODELS[name]
    root = voice_data['data_root']
    ckpt = _checkpoint(name, tmp_path_factory.mktemp(f'bf16_{name}'))
    common = dict(data_root=root, device='cpu', batch_size=2, model_kwargs=kwargs)
    ids = _ids(root)
    out = {'name': name, 'ids': ids}
    chunking = dict(zip(('chunk_frames', 'context', 'lookahead'), STREAM))

    def run(engine):
        return {'batch': engine.predict_ids(ids),
                'stream': {utt: list(engine.stream_id(utt, **chunking)) for utt in ids}}

    out['f32'] = run(TEngine(tmodel, ckpt, **common))
    try:
        out['port'] = run(TEngine(tmodel, ckpt, compute_dtype='bfloat16', **common))
        assert tnn.default_compute_dtype() is torch.bfloat16
        out['jax'] = run(JEngine(jmodel, ckpt, compute_dtype='bfloat16', **common))
    finally:
        tnn.set_default_compute_dtype(None)
        jnn.set_default_compute_dtype(None)
    return out


def test_engine_matches_jax(served):
    """Every output of every test utterance, unpadded, of the bf16 engines."""
    for utt in served['ids']:
        want = served['jax']['batch'][utt]
        got = served['port']['batch'][utt]
        _hold_dicts(got, want, served['f32']['batch'][utt], f"{served['name']} {utt}")


def _concat(chunks):
    return {k: np.concatenate([np.asarray(c[k]) for c in chunks], axis=0) for k in chunks[0]}


def test_stream_matches_jax(served):
    """The bf16 streams of the LSTM and F0 models (the recurrences with
    their carried state) and of the causal Transformer (the plain bf16
    attention over the KV cache) against JAX's: the same chunking, every
    streamed output."""
    for utt in served['ids']:
        got, want = served['port']['stream'][utt], served['jax']['stream'][utt]
        assert [sorted((k, v.shape) for k, v in c.items()) for c in got] == \
            [sorted((k, np.asarray(v).shape) for k, v in c.items()) for c in want]
        _hold_dicts(_concat(got), _concat(want), _concat(served['f32']['stream'][utt]),
                    f"{served['name']} stream {utt}")


def test_int8_voice_matches_jax(voice_data, tmp_path):
    """An int8 'scan' LSTM voice under bf16: the dequantised weights rounded
    as JAX's QuantizedArray.astype(bf16) gives them (quantize.py:123-128),
    against JAX's int8 bf16 engine; the guard against the port's int8 f32
    engine."""
    _, _, kwargs, _ = MODELS['lstm']
    ckpt = _checkpoint('lstm', tmp_path)
    common = dict(data_root=voice_data['data_root'], device='cpu', batch_size=2,
                  model_kwargs=kwargs, quantize='int8')
    ids = _ids(voice_data['data_root'])
    f32 = TEngine(trnn.LSTMAcousticModel, ckpt, **common).predict_ids(ids)
    try:
        port = TEngine(trnn.LSTMAcousticModel, ckpt, compute_dtype='bfloat16', **common)
        assert port.quantized
        got = port.predict_ids(ids)
        want = JEngine(JLSTM, ckpt, compute_dtype='bfloat16', **common).predict_ids(ids)
    finally:
        tnn.set_default_compute_dtype(None)
        jnn.set_default_compute_dtype(None)
    for utt in ids:
        _hold_dicts(got[utt], want[utt], f32[utt], f'int8 {utt}')


def test_pipeline_matches_jax(voice_data, tmp_path):
    """TTSPipeline over a DurationModel (GRU(16)) and the LSTM voice, both
    engines bf16 (the first sets the process's dtype, pipeline.py:404-411):
    integer durations equal to JAX's and every acoustic feature within the
    bounds; the guard on the utterances whose durations the f32 pipeline
    also gives (bf16 may move a duration by a frame, and then their
    features do not line up)."""
    root = voice_data['data_root']
    _, _, ac_kwargs, _ = MODELS['lstm']
    jnn.manual_seed(84)
    dur_ckpt = JDur(**DUR_KWARGS).save_parameters(str(tmp_path / 'dur'), 0)
    ac_ckpt = _checkpoint('lstm', tmp_path)
    common = dict(data_root=root, device='cpu', batch_size=2)
    ids = _ids(root, 'valid')
    results = {}
    try:
        for tag, engine, dur_model, ac_model, module in (
                ('f32', TEngine, tduration.DurationModel, trnn.LSTMAcousticModel, tpipeline),
                ('port', TEngine, tduration.DurationModel, trnn.LSTMAcousticModel, tpipeline),
                ('jax', JEngine, JDur, JLSTM, jpipeline)):
            compute = None if tag == 'f32' else 'bfloat16'
            pipe = module.TTSPipeline(
                engine(dur_model, dur_ckpt, model_kwargs=DUR_KWARGS, compute_dtype=compute,
                       **common),
                engine(ac_model, ac_ckpt, model_kwargs=ac_kwargs, **common))
            results[tag] = pipe.synthesize_ids(ids, data_dir='valid')
    finally:
        tnn.set_default_compute_dtype(None)
        jnn.set_default_compute_dtype(None)
    guarded = 0
    for utt in ids:
        got, want, f32 = results['port'][utt], results['jax'][utt], results['f32'][utt]
        np.testing.assert_array_equal(got['dur'], want['dur'])
        assert got['n_frames'] == want['n_frames']
        keys = sorted(k for k in want if k not in ('dur', 'n_frames', 'wav'))
        scales = _near([got[k] for k in keys], [want[k] for k in keys], f'pipeline {utt}', keys)
        if np.array_equal(f32['dur'], got['dur']):
            _rounded([got[k] for k in keys], [f32[k] for k in keys], scales, f'pipeline {utt}',
                     keys)
            guarded += 1
    assert guarded
