"""The port's ``Conv1d`` and ``ConvAcousticModel`` against the JAX package on
the CPU, on the same seeded inputs and weights (carried by
``nn.load_jax_params``).

``Conv1d`` (B2 T23, 8 channels in, 12 out): the output and the gradients of
a weighted sum (input, weight, bias) within 1e-5 abs, over same and causal
padding, kernels 1, 2, 3 and 4, dilations 1 and 3, groups 1 and 4, with a
ragged ``seq_len``; the masked batch equal to the unpadded utterance at
1e-6; the causal ``step`` over chunks of 5 equal to the causal forward at
1e-6 (JAX's own bars, ``tests/test_conv.py``). ``ConvAcousticModel`` (2
blocks of 32, k 5; same and causal): ``predict`` within 1e-5 abs on the
network outputs and 5e-5 on the MLPG trajectories (the bars of
``tests/test_torch_slice.py``), the gradients of a train step within 1e-4
of each one's largest value. The causal model streamed through the port's
``InferenceEngine`` (chunk 16, context 32, lookahead 32) equals its batch
predict within JAX's streamed-against-batch tolerances (vuv 1e-6, lf0
1e-4, mcep and bap 1e-3; ``tests/test_streaming.py:493``)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu import nn as jnn
from morgana_tpu.training import numeric_features, staged_value_and_grad

from morgana_tpu_torch import data as tdata
from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.models.conv_spss import ConvAcousticModel as TModel
from morgana_tpu_torch.serve import InferenceEngine as TEngine
from morgana_tpu_torch.training import TrainLoop as TLoop
from morgana_tpu_torch.training import build_optimizer as tbuild_optimizer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'models'))
try:
    from conv_spss import ConvAcousticModel as JModel
finally:
    sys.path.pop(0)

ATOL = 1e-5
EXACT_ATOL = 1e-6
TRAJ_ATOL = 5e-5
MODEL_GRAD_RTOL = 1e-4
STREAM_ATOL = {'vuv': 1e-6, 'lf0': 1e-4, 'mcep': 1e-3, 'bap': 1e-3}
NET_KEYS = ('normalised_lf0_deltas', 'normalised_mcep_deltas', 'normalised_bap_deltas', 'vuv')
MODEL_KWARGS = {'num_layers': 2, 'hidden_size': 32}


def _t(array):
    return torch.from_numpy(np.asarray(array))


def _jax_predict(jm, features):
    """The JAX model's predict on a numeric batch, jitted as its engine
    runs it."""
    def predict(params, batch):
        with jnn.bind(jm, params):
            return jm.predict(batch)
    return jax.jit(predict)(jnn.parameters(jm), features)


def _conv_pair(kernel, dilation, groups, padding, seed=1):
    jnn.manual_seed(seed)
    jconv = jnn.Conv1d(8, 12, kernel, dilation=dilation, groups=groups, padding=padding)
    tconv = tnn.Conv1d(8, 12, kernel, dilation=dilation, groups=groups, padding=padding)
    assert sorted(jnn.state_dict(jconv)) == sorted(tnn.state_dict(tconv)) == ['bias', 'weight']
    tnn.load_jax_params(tconv, jnn.state_dict(jconv))
    return jconv, tconv


@pytest.mark.parametrize('groups', [1, 4])
@pytest.mark.parametrize('dilation', [1, 3])
@pytest.mark.parametrize('kernel', [1, 2, 3, 4])
@pytest.mark.parametrize('padding', ['same', 'causal'])
def test_conv1d_and_gradients_match_jax(padding, kernel, dilation, groups):
    """Output and the gradients of ``sum(y * weight)`` with a ragged
    seq_len (frames past it masked before the convolution)."""
    jconv, tconv = _conv_pair(kernel, dilation, groups, padding)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 23, 8)).astype(np.float32)
    weight = rng.normal(size=(2, 23, 12)).astype(np.float32)
    seq_len = np.array([23, 14], np.int32)

    def jax_loss(params, x):
        with jnn.bind(jconv, params):
            y = jconv(x, seq_len=jnp.asarray(seq_len))
        return jnp.sum(y * weight), y

    (_, want), (want_p, want_x) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnn.parameters(jconv), jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    got = tconv(tx, seq_len=_t(seq_len))
    (got * _t(weight)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), atol=ATOL)
    for name, param in tconv.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), np.asarray(want_p[name]), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize('padding', ['same', 'causal'])
def test_seq_len_masks_out_the_padding(padding):
    """An utterance padded with garbage past seq_len gives the output of the
    unpadded utterance on its frames."""
    _, tconv = _conv_pair(3, 2, 1, padding, seed=3)
    rng = np.random.default_rng(4)
    x = _t(rng.normal(size=(1, 10, 8)).astype(np.float32))
    padded = torch.cat([x, _t(rng.normal(size=(1, 6, 8)).astype(np.float32))], dim=1)
    with torch.no_grad():
        want = tconv(x)
        got = tconv(padded, seq_len=torch.tensor([10]))
    np.testing.assert_allclose(got[:, :10].numpy(), want.numpy(), atol=EXACT_ATOL)


def test_causal_step_equals_the_batch_and_same_refuses():
    """Chunks of 5 through step, the state carried, give the causal forward
    over the whole sequence; a same-padded convolution cannot stream."""
    _, tconv = _conv_pair(4, 3, 2, 'causal', seed=5)
    x = _t(np.random.default_rng(6).normal(size=(2, 23, 8)).astype(np.float32))
    state, chunks = None, []
    with torch.no_grad():
        want = tconv(x)
        for start in range(0, 23, 5):
            y, state = tconv.step(x[:, start:start + 5], state)
            chunks.append(y)
    np.testing.assert_allclose(torch.cat(chunks, dim=1).numpy(), want.numpy(), atol=EXACT_ATOL)
    with pytest.raises(NotImplementedError, match='cannot stream'):
        _conv_pair(3, 1, 1, 'same')[1].step(x[:, :5], None)


def _models(root, causal):
    kwargs = dict(MODEL_KWARGS, causal=causal)
    jnn.manual_seed(31)
    jm, tm = JModel(**kwargs), TModel(**kwargs)
    tnn.load_jax_params(tm, jnn.state_dict(jm))
    for model in (jm, tm):
        model.normalisers = model.normaliser_sources()
        for normaliser in model.normalisers.values():
            normaliser.load_params('train', root)
        model.mode = 'train'
    return jm, tm


@pytest.mark.parametrize('causal', [False, True], ids=['same', 'causal'])
def test_conv_model_predict_and_gradients_match_jax(voice_data, causal):
    """predict on two training utterances, then the gradients of a train
    step against staged_value_and_grad, the JAX train step's."""
    root = voice_data['data_root']
    jm, tm = _models(root, causal)
    dataset = tdata.FilesDataset(tm.train_data_sources(), 'train', 'train/train_file_id_list.scp',
                                 tm.normalisers, root)
    batch = tdata.collate([dataset[i] for i in range(2)])
    jbatch = dict(numeric_features(batch), global_step=jnp.asarray(0, jnp.int32))
    want = _jax_predict(jm, jbatch)
    tm.eval()
    with torch.no_grad():
        got = tm.predict(tdata.device_features(batch, 'cpu'))
    for key, value in want.items():
        atol = ATOL if key in NET_KEYS else TRAJ_ATOL
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value), atol=atol, err_msg=key)

    grad_fn = jax.jit(lambda p, b: staged_value_and_grad(jm, p, b, jax.random.PRNGKey(0)))
    want_g = grad_fn(jnn.parameters(jm), jbatch)[3]
    TLoop(tm, tbuild_optimizer('adam')).train_step(batch, 0.0)
    for name, param in tm.named_parameters():
        want = np.asarray(want_g[name])
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(param.grad.numpy() / scale, want / scale,
                                   atol=MODEL_GRAD_RTOL, err_msg=name)


def test_causal_engine_stream_equals_its_batch(voice_data, tmp_path):
    """The causal model's checkpoint served by the port's engine: each test
    utterance streamed in chunks of 16 equals the engine's batch predict;
    the same-padded model refuses to stream."""
    root = voice_data['data_root']
    kwargs = dict(MODEL_KWARGS, causal=True)
    jnn.manual_seed(41)
    ckpt = JModel(**kwargs).save_parameters(str(tmp_path), 0)
    engine = TEngine(TModel, ckpt, data_root=root, device='cpu', batch_size=2,
                     model_kwargs=kwargs)
    ids = file_io.get_file_ids(os.path.join(root, 'test', 'test_file_id_list.scp'))
    batch = engine.predict_ids(ids)
    for utt in ids:
        chunks = list(engine.stream_id(utt, chunk_frames=16, context=32, lookahead=32))
        assert len(chunks) > 1
        for key, atol in STREAM_ATOL.items():
            streamed = np.concatenate([c[key] for c in chunks], axis=0)
            assert streamed.shape == batch[utt][key].shape, key
            np.testing.assert_allclose(streamed, batch[utt][key], atol=atol, rtol=0, err_msg=key)
    same = TEngine(TModel, JModel(**MODEL_KWARGS).save_parameters(str(tmp_path), 1),
                   data_root=root, device='cpu', model_kwargs=MODEL_KWARGS)
    with pytest.raises(NotImplementedError, match='cannot stream'):
        list(same.stream_id(ids[0]))
