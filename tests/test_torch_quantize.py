"""Weight-only int8 / int4 quantization of the port against the JAX package
on the CPU: the arrays, the parameter filter, the checkpoint files each
package reads from the other, the quantized engine, its command line, the
pipeline's ``--quantize`` and a quantized stream.

Weights are seeded JAX parameters saved as ``epoch_0.npz`` (2 x LSTM(32)
``LSTMAcousticModel``, ``DurationModel(hidden_size=16)``), loaded by both
packages. Tolerances and why:

* ``q``, packed nibbles and scales: equal, bit for bit (both divide in f32
  and round half to even);
* a quantized engine against JAX's in the same mode: ``ENGINE_RTOL`` = 1e-5
  relative L2 per output (both dequantise the same q * scale, then f32 sums
  in another order);
* a quantized engine against the float one: JAX's bounds, below 2e-2
  (int8) and 0.15 (int4) relative L2 (``tests/test_quantize.py:183``,
  ``:465``), and above 0 (the weights did change);
* a quantized stream against the same engine's batch predict: JAX's 2e-3
  relative L2 on lf0 (``tests/test_quantize.py:294``).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from morgana_tpu import nn as jnn
from morgana_tpu import quantize as jq
from morgana_tpu.serve import InferenceEngine as JEngine

from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch import pipeline as tpipeline
from morgana_tpu_torch import quantize as tq
from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.models import duration_model as tduration
from morgana_tpu_torch.models import f0_test_model as tf0
from morgana_tpu_torch.models import rnn_spss as trnn
from morgana_tpu_torch.models import transformer_spss as ttransformer
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

ENGINE_RTOL = 1e-5
FLOAT_BOUND = {'int8': 2e-2, 'int4': 0.15}
STREAM_RTOL = 2e-3
AC_KWARGS = {'num_layers': 2, 'hidden_size': 32}
DUR_KWARGS = {'hidden_size': 16}
NET_KEYS = ('normalised_lf0_deltas', 'normalised_mcep_deltas', 'normalised_bap_deltas', 'vuv')


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _kind(value):
    """'int8', 'int4' or 'raw', by the class name of either package."""
    return {'QuantizedArray': 'int8', 'Int4QuantizedArray': 'int4'}.get(type(value).__name__,
                                                                        'raw')


def _ids(root, split='test'):
    return file_io.get_file_ids(os.path.join(root, split, f'{split}_file_id_list.scp'))


# ------------------------------------------------------------------ arrays

def _int8_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == 'normal':
        return rng.normal(0.0, 0.3, (64, 48)).astype(np.float32)
    if name == 'zero-channel':
        w = np.zeros((4, 3), np.float32)
        w[:, 0] = [1.0, -2.0, 0.5, 0.25]
        return w
    if name == 'odd-rows':
        return rng.normal(size=(13, 5)).astype(np.float32)
    if name == 'negative-extreme':
        return np.array([[-127.0, 3.0], [1.0, -3.0], [-63.5, 1.5]], np.float32)
    return rng.normal(size=(4, 8, 16)).astype(np.float32)   # 3-d


@pytest.mark.parametrize('case', ['normal', 'zero-channel', 'odd-rows', 'negative-extreme', '3-d'])
def test_quantize_array_is_bit_identical_to_jax(case):
    w = _int8_case(case)
    got, want = tq.quantize_array(w), jq.quantize_array(w)
    assert got.q.dtype == torch.int8 and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))
    assert got.dtype == torch.float32 and got.size == w.size and got.ndim == w.ndim


INT4_CASES = {
    'groups': ((128, 24), 32),
    'odd-rows': ((13, 5), 4),
    'ragged-last-group': ((100, 7), 64),
    'default-group': ((609, 16), tq.DEFAULT_INT4_GROUP),
    'one-row': ((1, 3), 64),
}


def _int4_case(name):
    shape, group = INT4_CASES.get(name, ((4, 2), 4))
    rng = np.random.default_rng(len(name))
    if name == 'negative-extreme':
        return np.array([[-7.0, 7.0], [7.0, -7.0], [-1.0, 1.0], [0.0, 0.0]], np.float32), group
    if name == 'zero-group':
        w = rng.normal(size=(12, 3)).astype(np.float32)
        w[4:8] = 0.0
        return w, 4
    return rng.normal(0.0, 0.3, shape).astype(np.float32), group


@pytest.mark.parametrize('case', list(INT4_CASES) + ['negative-extreme', 'zero-group'])
def test_quantize_array_int4_is_bit_identical_to_jax(case):
    w, group = _int4_case(case)
    got, want = tq.quantize_array_int4(w, group_size=group), jq.quantize_array_int4(w, group)
    assert got.packed.dtype == torch.int8
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert (got.rows, got.group_size, got.shape) == (want.rows, want.group_size, want.shape)
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))
    if case == 'negative-extreme':
        np.testing.assert_allclose(got.dequantize().numpy(), w, atol=1e-6)


def test_int4_takes_matrices_only():
    with pytest.raises(ValueError, match='2-d'):
        tq.quantize_array_int4(np.ones((2, 3, 4), np.float32))


MODELS = {
    'lstm': (JLSTM, trnn.LSTMAcousticModel, AC_KWARGS),
    'f0': (JF0, tf0.F0Model, {}),
    'duration': (JDur, tduration.DurationModel, DUR_KWARGS),
    'transformer': (JTransformer, ttransformer.TransformerAcousticModel,
                    {'num_layers': 2, 'd_model': 32, 'num_heads': 4}),
}


@pytest.mark.parametrize('name', list(MODELS))
def test_default_filter_picks_the_jax_names(name):
    """The same weights of every ported model are quantized: the matrices."""
    jmodel, tmodel, kwargs = MODELS[name]
    jnn.manual_seed(3)
    want = {n for n, v in jnn.parameters(jmodel(**kwargs)).items()
            if jq.default_should_quantize(n, v)}
    got = {n for n, v in tmodel(**kwargs).named_parameters() if tq.default_should_quantize(n, v)}
    assert got == want and got


@pytest.mark.parametrize('bits', [8, 4])
def test_quantize_params_matches_jax(bits):
    """Mixed leaves: each kind and tensor as JAX's; already-quantized leaves
    pass through; dequantize_params gives JAX's floats back."""
    rng = np.random.default_rng(bits)
    params = {'w': rng.normal(size=(64, 32)).astype(np.float32),
              'b': rng.normal(size=(32,)).astype(np.float32),
              'w3': rng.normal(size=(4, 8, 16)).astype(np.float32)}
    got = tq.quantize_params(params, bits=bits, group_size=16)
    want = jq.quantize_params(params, bits=bits, group_size=16)
    for name, value in want.items():
        assert _kind(got[name]) == _kind(value), name
        np.testing.assert_array_equal(tq._numpy(tq.dequantize_params(got)[name]),
                                      np.asarray(jq.dequantize_params(want)[name]))
    again = tq.quantize_params(got, bits=bits)
    assert all(again[k] is got[k] for k in ('w', 'w3'))
    with pytest.raises(ValueError, match='bits'):
        tq.quantize_params(params, bits=2)


# ------------------------------------------------------------------- files

def _file_params(rng):
    return {'layers.0.weight': rng.normal(size=(96, 40)).astype(np.float32),
            'layers.0.bias': rng.normal(size=(40,)).astype(np.float32),
            'conv': rng.normal(size=(3, 4, 8)).astype(np.float32)}


@pytest.mark.parametrize('writer', ['jax', 'port'])
@pytest.mark.parametrize('bits', [8, 4])
def test_each_package_reads_the_others_files(writer, bits, tmp_path):
    """A file written by one package (``.npz`` appended to an extensionless
    path) is detected and read by both, with the v1 marker for int8 and v2
    for int4, and holds the same arrays and manifest as the other's."""
    params = _file_params(np.random.default_rng(bits))
    paths = {}
    for tag, mod in (('jax', jq), ('port', tq)):
        paths[tag] = mod.save_quantized_checkpoint(params, str(tmp_path / f'{tag}_q'), bits=bits,
                                                   group_size=32)
        assert paths[tag].endswith('.npz') and os.path.isfile(paths[tag])
    with np.load(paths['jax']) as a, np.load(paths['port']) as b:
        assert sorted(a.files) == sorted(b.files)
        assert str(a['__quantized_format__']) == str(b['__quantized_format__']) == \
            (jq.QUANTIZED_FORMAT if bits == 8 else jq.QUANTIZED_FORMAT_V2)
        assert json.loads(str(a['__manifest__'])) == json.loads(str(b['__manifest__']))
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    path = paths[writer]
    assert tq.is_quantized_checkpoint(path) and jq.is_quantized_checkpoint(path)
    got, want = tq.load_quantized_checkpoint(path), jq.load_quantized_checkpoint(path)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert _kind(got[name]) == _kind(value), name
        if isinstance(value, jq.Int4QuantizedArray):
            assert (got[name].rows, got[name].group_size) == (value.rows, value.group_size)
        np.testing.assert_array_equal(tq._numpy(tq.dequantize_params(got)[name]),
                                      np.asarray(jq.dequantize_params(want)[name]))


def test_float_checkpoints_are_not_quantized_ones(tmp_path):
    path = str(tmp_path / 'epoch_1.npz')
    np.savez(path, w=np.ones((2, 2), np.float32))
    assert not tq.is_quantized_checkpoint(path)
    assert not tq.is_quantized_checkpoint(str(tmp_path / 'missing.npz'))
    with pytest.raises(ValueError, match='not a morgana_tpu quantized checkpoint'):
        tq.load_quantized_checkpoint(path)


def test_save_refuses_non_array_leaves(tmp_path):
    with pytest.raises(ValueError, match='nested'):
        tq.save_quantized_checkpoint({'nested': {'weight': np.ones((4, 4), np.float32)}},
                                     str(tmp_path / 'bad.npz'))


@pytest.mark.parametrize('bits,ratio', [(8, 3.8), (4, 6.5)])
def test_weight_dominated_checkpoint_compresses(bits, ratio, tmp_path):
    rng = np.random.default_rng(bits)
    params = {f'w_hh_l{i}': rng.normal(size=(512, 2048)).astype(np.float32) for i in range(2)}
    float_path = str(tmp_path / 'f32.npz')
    np.savez(float_path, **params)
    qpath = tq.save_quantized_checkpoint(params, str(tmp_path / 'q.npz'), bits=bits)
    assert os.path.getsize(float_path) / os.path.getsize(qpath) > ratio


@pytest.mark.parametrize('bits', [8, 4])
def test_cli_compresses_and_refuses_to_quantize_twice(bits, tmp_path, capsys):
    rng = np.random.default_rng(bits)
    src = str(tmp_path / 'epoch_1.npz')
    np.savez(src, **{'w': rng.normal(size=(256, 128)).astype(np.float32),
                     'b': rng.normal(size=(128,)).astype(np.float32)})
    tq.main(['--checkpoint', src, '--bits', str(bits)])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats['out'] == str(tmp_path / f'epoch_1_q{bits}.npz')
    assert stats['compression'] > (3.0 if bits == 8 else 5.0)
    jq_loaded = jq.load_quantized_checkpoint(stats['out'])
    want = jq.quantize_params({'w': np.load(src)['w']}, bits=bits)['w']
    np.testing.assert_array_equal(np.asarray(jq_loaded['w'].dequantize()),
                                  np.asarray(want.dequantize()))
    with pytest.raises(SystemExit) as exc:
        tq.main(['--checkpoint', stats['out'], '--out', str(tmp_path / 'qq.npz')])
    assert exc.value.code == 2 and 'already quantized' in capsys.readouterr().err


# ------------------------------------------------------------------ layers

def test_quantized_pallas_lstm_takes_f32_storage(monkeypatch):
    """With bf16 storage set for the 'pallas' backend, a quantized LSTM stack
    runs its recurrence in f32 (the JAX package falls back to its f32 scan),
    equal to the quantized 'scan' stack."""
    rnn = tnn.Recurrent('lstm', 8, 12, num_layers=2, backend='pallas',
                        generator=torch.Generator().manual_seed(5))
    tq.load_params(rnn, tq.quantize_params(dict(rnn.named_parameters())))
    stores = []
    real = lstm_ops.lstm_layer

    def spy(*args, **kwargs):
        stores.append(kwargs.get('store_dtype'))
        return real(*args, **kwargs)

    monkeypatch.setattr(lstm_ops, 'STORE_DTYPE', 'bfloat16')
    monkeypatch.setattr(lstm_ops, 'lstm_layer', spy)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 6, 8)).astype(np.float32))
    with torch.inference_mode():
        y_pallas, _ = rnn(x)
        rnn.backend = 'scan'
        y_scan, _ = rnn(x)
    assert stores == [None] * 4
    torch.testing.assert_close(y_pallas, y_scan, rtol=0, atol=0)


def test_load_params_is_strict_and_holds_only_the_quantized_tensors():
    model = trnn.LSTMAcousticModel(**AC_KWARGS, generator=torch.Generator().manual_seed(1))
    params = tq.quantize_params(tnn.state_dict(model))
    fresh = trnn.LSTMAcousticModel(**AC_KWARGS)
    tq.load_params(fresh, params)
    assert tq.is_quantized(fresh)
    held = dict(fresh.named_parameters())
    for name, value in params.items():
        if isinstance(value, tq.QuantizedArray):
            owner, _, attr = name.rpartition('.')
            assert name not in held
            q = held[f'{owner}.parametrizations.{attr}.original0']
            assert q.dtype == torch.int8 and torch.equal(q, value.q)
            assert torch.equal(getattr(fresh.get_submodule(owner), attr), value.dequantize())
        else:
            assert torch.equal(held[name], value if isinstance(value, torch.Tensor)
                               else torch.from_numpy(value))
    bad = dict(params)
    bad.pop('layers.0.bias')
    with pytest.raises(KeyError, match='missing'):
        tq.load_params(trnn.LSTMAcousticModel(**AC_KWARGS), bad)


# ----------------------------------------------------------------- engines

@pytest.fixture(scope='module')
def engines(voice_data, tmp_path_factory):
    """The float and quantized engines of both packages on one seeded
    LSTMAcousticModel checkpoint, and their predictions of the test split."""
    root = voice_data['data_root']
    base = tmp_path_factory.mktemp('quant')
    jnn.manual_seed(71)
    ckpt = JLSTM(**AC_KWARGS).save_parameters(str(base / 'ac'), 0)
    common = dict(data_root=root, device='cpu', batch_size=2, model_kwargs=AC_KWARGS)
    ids = _ids(root)
    out = {'root': root, 'base': base, 'ckpt': ckpt, 'ids': ids, 'port': {}, 'jax': {}}
    for mode in (None, 'int8', 'int4'):
        port = TEngine(trnn.LSTMAcousticModel, ckpt, quantize=mode, **common)
        jax_engine = JEngine(JLSTM, ckpt, quantize=mode, **common)
        out['port'][mode] = (port, port.predict_ids(ids))
        out['jax'][mode] = (jax_engine, jax_engine.predict_ids(ids))
    return out


@pytest.mark.parametrize('mode', ['int8', 'int4'])
def test_quantized_engine_matches_jax_and_stays_near_float(engines, mode):
    port, got = engines['port'][mode]
    _, want = engines['jax'][mode]
    _, floats = engines['port'][None]
    assert port.quantized and not engines['port'][None][0].quantized
    for utt in engines['ids']:
        for key in want[utt]:
            assert _rel(got[utt][key], want[utt][key]) <= ENGINE_RTOL, (utt, key)
        for key in NET_KEYS:
            rel = _rel(got[utt][key], floats[utt][key])
            assert 0 < rel < FLOAT_BOUND[mode], (utt, key, rel)


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_engine_detects_a_quantized_checkpoint(engines, writer, tmp_path):
    """A checkpoint quantized by either package's save_quantized_checkpoint is
    served quantized without the flag, bit-identical to quantize='int8'."""
    mod = jq if writer == 'jax' else tq
    with np.load(engines['ckpt']) as data:
        qpath = mod.save_quantized_checkpoint({k: data[k] for k in data.files},
                                              str(tmp_path / 'epoch_0_q8.npz'))
    engine = TEngine(trnn.LSTMAcousticModel, qpath, data_root=engines['root'], device='cpu',
                     batch_size=2, model_kwargs=AC_KWARGS)
    assert engine.quantized
    got = engine.predict_ids(engines['ids'])
    _, want = engines['port']['int8']
    for utt in engines['ids']:
        for key in want[utt]:
            np.testing.assert_array_equal(got[utt][key], want[utt][key], err_msg=key)


def test_engine_rejects_an_unknown_mode(engines):
    with pytest.raises(ValueError, match='quantize'):
        TEngine(trnn.LSTMAcousticModel, engines['ckpt'], data_root=engines['root'],
                device='cpu', model_kwargs=AC_KWARGS, quantize='int2')


def test_quantized_stream_stays_near_its_batch(engines):
    """JAX's ``test_streaming_composes_with_quantization``: the int8 engine's
    stream of lf0 within STREAM_RTOL of its batch predict."""
    port, batch = engines['port']['int8']
    utt = engines['ids'][0]
    lf0 = np.concatenate([c['lf0'] for c in port.stream_id(utt)], axis=0)
    assert lf0.shape == batch[utt]['lf0'].shape
    assert _rel(lf0, batch[utt]['lf0']) < STREAM_RTOL


def test_pipeline_cli_quantize_on_the_cpu(engines, capsys):
    """``python -m morgana_tpu_torch.pipeline --quantize int8 --device cpu``:
    both stages served quantized; the acoustic features it writes equal a
    TTSPipeline over int8 engines, and differ from the float pipeline's."""
    base, root = engines['base'], engines['root']
    dur_model = tduration.DurationModel(**DUR_KWARGS, generator=torch.Generator().manual_seed(72))
    dur_ckpt = dur_model.save_parameters(str(base / 'dur'), 0)
    out_dir = base / 'tts_q8'
    tpipeline.main([
        '--duration_model', 'morgana_tpu_torch.models.duration_model:DurationModel',
        '--duration_checkpoint', dur_ckpt,
        '--acoustic_model', 'morgana_tpu_torch.models.rnn_spss:LSTMAcousticModel',
        '--acoustic_checkpoint', engines['ckpt'], '--acoustic_model_kwargs', repr(AC_KWARGS),
        '--duration_model_kwargs', repr(DUR_KWARGS), '--data_root', root, '--out_dir',
        str(out_dir), '--device', 'cpu', '--batch_size', '2', '--quantize', 'int8'])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats['utterances'] == stats['wavs'] == len(engines['ids'])
    common = dict(data_root=root, device='cpu', batch_size=2)
    want = {}
    for mode in ('int8', None):
        pipe = tpipeline.TTSPipeline(
            TEngine(tduration.DurationModel, dur_ckpt, model_kwargs=DUR_KWARGS, quantize=mode,
                    **common),
            TEngine(trnn.LSTMAcousticModel, engines['ckpt'], model_kwargs=AC_KWARGS,
                    quantize=mode, **common))
        want[mode] = pipe.synthesize_ids(engines['ids'])
    for utt in engines['ids']:
        got = np.load(out_dir / 'feats' / 'mcep' / f'{utt}.npy')
        np.testing.assert_array_equal(got, want['int8'][utt]['mcep'])
        assert not np.array_equal(got, want[None][utt]['mcep'])
