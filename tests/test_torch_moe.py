"""The port's mixture-of-experts FFN and the Transformer's MoE blocks against
the JAX package on the CPU, on the same seeded inputs and weights (carried
by ``nn.load_jax_params``).

``MoEFeedForward`` (d_model 16, d_ff 32, 4 experts, B3 T16, ragged seq_len):
the output within 1e-5 abs, the balance loss within 1e-6 relative, and the
gradients of a weighted sum of the output plus the balance loss within 1e-5
of each gradient's largest value, at capacity 1.25 and at 0.5 (tokens over
capacity). ``TransformerAcousticModel(moe_experts=2)`` (2 blocks, d_model 32,
2 heads): ``predict`` within 1e-5 abs on the network outputs and 5e-5 on
the MLPG trajectories (the bars of ``tests/test_torch_slice.py``), every
parameter's gradient of a train step (loss plus balance loss) within 1e-4
of its largest value, and the port's TrainLoop loss within 1e-5 relative of
the JAX TrainLoop's, which adds the balance loss to the task loss."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu import nn as jnn
from morgana_tpu.training import TrainLoop as JLoop
from morgana_tpu.training import build_optimizer as jbuild_optimizer
from morgana_tpu.training import numeric_features, staged_value_and_grad

from morgana_tpu_torch import data as tdata
from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch.models.transformer_spss import TransformerAcousticModel as TModel
from morgana_tpu_torch.training import TrainLoop as TLoop
from morgana_tpu_torch.training import build_optimizer as tbuild_optimizer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'models'))
try:
    from transformer_spss import TransformerAcousticModel as JModel
finally:
    sys.path.pop(0)

ATOL = 1e-5
AUX_RTOL = 1e-6
GRAD_RTOL = 1e-5
MODEL_GRAD_RTOL = 1e-4
TRAJ_ATOL = 5e-5
LOSS_RTOL = 1e-5
MODEL_KWARGS = {'num_layers': 2, 'd_model': 32, 'num_heads': 2, 'moe_experts': 2}
NET_KEYS = ('normalised_lf0_deltas', 'normalised_mcep_deltas', 'normalised_bap_deltas', 'vuv')


def _t(array):
    return torch.from_numpy(np.asarray(array))


def _jax_predict(jm, features):
    """The JAX model's predict on a numeric batch, jitted as its engine
    runs it."""
    def predict(params, batch):
        with jnn.bind(jm, params):
            return jm.predict(batch)
    return jax.jit(predict)(jnn.parameters(jm), features)


def _moe_pair(capacity_factor, seed=3):
    jnn.manual_seed(seed)
    jm = jnn.MoEFeedForward(16, 32, 4, capacity_factor=capacity_factor, aux_weight=0.01)
    tm = tnn.MoEFeedForward(16, 32, 4, capacity_factor=capacity_factor, aux_weight=0.01)
    tnn.load_jax_params(tm, jnn.state_dict(jm))
    return jm, tm


def _moe_inputs(seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 16, 16)).astype(np.float32)
    seq_len = np.array([16, 9, 3], np.int32)
    weight = rng.normal(size=(3, 16, 16)).astype(np.float32)
    return x, seq_len, weight


def _port_moe(tm, x, seq_len, train=True):
    tm.train(train)
    with tnn.collect_aux_losses():
        y = tm(x, seq_len=seq_len)
        aux = tnn.collected_aux_loss()
    return y, aux


@pytest.mark.parametrize('capacity_factor', [1.25, 0.5], ids=['capacity1.25', 'overflow'])
def test_moe_feed_forward_and_gradients_match_jax(capacity_factor):
    """Output, balance loss and the gradients (parameters and x) of
    ``sum(y * weight) + aux`` in training, against jax.value_and_grad."""
    jm, tm = _moe_pair(capacity_factor)
    x, seq_len, weight = _moe_inputs()

    def jax_loss(params, x):
        with jnn.bind(jm, params, rng=jax.random.PRNGKey(0), train=True):
            y = jm(x, seq_len=jnp.asarray(seq_len))
            aux = jnn.collected_aux_loss()
        return jnp.sum(y * weight) + aux, (y, aux)

    (_, (want_y, want_aux)), (want_p, want_x) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnn.parameters(jm), jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    y, aux = _port_moe(tm, tx, _t(seq_len))
    (y * _t(weight)).sum().add(aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), atol=ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), rtol=AUX_RTOL)
    grads = dict(tm.named_parameters())
    for name, want in list(want_p.items()) + [('x', want_x)]:
        got = tx.grad if name == 'x' else grads[name].grad
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(got.numpy() / scale, np.asarray(want) / scale,
                                   atol=GRAD_RTOL, err_msg=name)


def test_overflow_and_padded_frames_give_zero():
    """Frames past seq_len get 0, and so do the tokens past an expert's
    capacity of a row (in time order); the routed ones get the gated FFN of
    their expert. At capacity 0.5 (2 of 16 frames an expert) some tokens
    overflow; padded frames take no capacity."""
    _, tm = _moe_pair(0.5, seed=5)
    x, seq_len, _ = _moe_inputs(6)
    with torch.no_grad():
        y, aux = _port_moe(tm, _t(x), _t(seq_len), train=False)
        probs = torch.softmax(_t(x) @ tm.router.weight, dim=-1)
    assert aux == 0.0   # registered in training only
    cap = tm.capacity(16)
    assert cap == 2
    expert = probs.argmax(-1)
    overflowed = 0
    for b in range(3):
        taken = {}
        for t in range(16):
            row = y[b, t]
            if t >= seq_len[b]:
                assert torch.all(row == 0), (b, t)
                continue
            e = int(expert[b, t])
            taken[e] = taken.get(e, 0) + 1
            if taken[e] > cap:
                overflowed += 1
                assert torch.all(row == 0), (b, t)
                continue
            h = torch.nn.functional.gelu(_t(x)[b, t] @ tm.w_in[e] + tm.b_in[e])
            want = (h @ tm.w_out[e] + tm.b_out[e]) * probs[b, t, e]
            torch.testing.assert_close(row, want, atol=ATOL, rtol=0)
    assert overflowed > 0


def test_expert_parallelism_is_refused():
    """The mesh (expert parallelism) is a later slice: the layer and the
    model raise rather than run on one device."""
    with pytest.raises(NotImplementedError, match='expert parallelism'):
        tnn.MoEFeedForward(16, 32, 4, mesh=object())
    with pytest.raises(NotImplementedError, match='expert_parallel'):
        TModel(moe_experts=2, expert_parallel=True)


def _models(root):
    jnn.manual_seed(21)
    jm, tm = JModel(**MODEL_KWARGS), TModel(**MODEL_KWARGS)
    assert sorted(jnn.state_dict(jm)) == sorted(tnn.state_dict(tm))
    assert any('moe.w_in' in name for name in tnn.state_dict(tm))
    tnn.load_jax_params(tm, jnn.state_dict(jm))
    for model in (jm, tm):
        model.normalisers = model.normaliser_sources()
        for normaliser in model.normalisers.values():
            normaliser.load_params('train', root)
        model.mode = 'train'
    return jm, tm


def _train_batch(tm, root):
    dataset = tdata.FilesDataset(tm.train_data_sources(), 'train', 'train/train_file_id_list.scp',
                                 tm.normalisers, root)
    return tdata.collate([dataset[i] for i in range(2)])


def test_moe_transformer_predict_and_gradients_match_jax(voice_data):
    """predict on two training utterances, then the gradient of a train
    step (task loss plus the balance loss of blocks 2) against
    staged_value_and_grad, the JAX train step's."""
    root = voice_data['data_root']
    jm, tm = _models(root)
    batch = _train_batch(tm, root)
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
    loop = TLoop(tm, tbuild_optimizer('adam'))
    loop.train_step(batch, 0.0)
    for name, param in tm.named_parameters():
        want = np.asarray(want_g[name])
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(param.grad.numpy() / scale, want / scale,
                                   atol=MODEL_GRAD_RTOL, err_msg=name)


def test_train_loss_includes_the_balance_loss(voice_data):
    """The port's TrainLoop returns the task loss plus the MoE blocks'
    balance loss, as the JAX TrainLoop does; the eval loss is the task loss
    alone, and the two differ by the collected balance loss."""
    root = voice_data['data_root']
    jm, tm = _models(root)
    batch = _train_batch(tm, root)
    jloss, _, _ = JLoop(jm, jbuild_optimizer('adam')).train_step(batch, 0.01)
    tloop = TLoop(tm, tbuild_optimizer('adam'))
    eval_loss, _ = tloop.eval_step(batch)
    tm.train()
    with tnn.collect_aux_losses(), torch.no_grad():
        tm(tloop._batch(batch))
        aux = float(tnn.collected_aux_loss())
    tloss, _ = tloop.train_step(batch, 0.01)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    assert aux > 0
    np.testing.assert_allclose(float(tloss) - float(eval_loss), aux, rtol=1e-4)
