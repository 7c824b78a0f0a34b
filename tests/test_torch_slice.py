"""The port's serving slice against the JAX package on the CPU: one
``epoch_{N}.npz`` of the JAX ``LSTMAcousticModel`` (2 x LSTM(64)) served by
both ``InferenceEngine``s on the same synthetic voice data.

Tolerances: the network outputs (normalised deltas, vuv) 1e-5 abs, the bar
of the LSTM layer; the MLPG trajectories (lf0, mcep, bap), which both sides
solve by an f32 banded Cholesky over T + 200 frames, 5e-5 abs (measured about
6e-6 on values up to 5)."""
import os
import sys

import numpy as np
import pytest
import torch

from morgana_tpu import nn as jnn
from morgana_tpu.serve import InferenceEngine as JEngine

from morgana_tpu_torch.device import DeviceError
from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel as TModel
from morgana_tpu_torch.serve import InferenceEngine as TEngine

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'models'))
try:
    from rnn_spss import LSTMAcousticModel as JModel
finally:
    sys.path.pop(0)

MODEL_KWARGS = {'num_layers': 2, 'hidden_size': 64}
NET_ATOL = 1e-5
TRAJ_ATOL = 5e-5
NET_KEYS = ('normalised_lf0_deltas', 'normalised_mcep_deltas', 'normalised_bap_deltas', 'vuv')
TRAJ_KEYS = ('lf0', 'mcep', 'bap')


@pytest.fixture(scope='module')
def served(voice_data, tmp_path_factory):
    jnn.manual_seed(11)
    ckpt = JModel(**MODEL_KWARGS).save_parameters(str(tmp_path_factory.mktemp('ckpt')), 3)
    root = voice_data['data_root']
    engines = [cls(model, ckpt, data_root=root, model_kwargs=MODEL_KWARGS, device='cpu',
                   batch_size=2)
               for cls, model in ((JEngine, JModel), (TEngine, TModel))]
    with open(os.path.join(root, 'test', 'test_file_id_list.scp')) as f:
        ids = f.read().split()
    return {'engines': engines, 'ids': ids, 'root': root, 'ckpt': ckpt}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert sorted(got[name]) == sorted(NET_KEYS + TRAJ_KEYS)
        for key in NET_KEYS + TRAJ_KEYS:
            w = np.asarray(want[name][key])
            assert got[name][key].shape == w.shape, (name, key)
            np.testing.assert_allclose(got[name][key], w,
                                       atol=NET_ATOL if key in NET_KEYS else TRAJ_ATOL,
                                       err_msg=f'{name} {key}')


def test_predict_ids_matches_jax(served):
    jax_engine, port_engine = served['engines']
    _assert_same(port_engine.predict_ids(served['ids']), jax_engine.predict_ids(served['ids']))


def test_predict_items_matches_jax(served):
    """In-memory items: each test source's raw feature, read from disk."""
    jax_engine, port_engine = served['engines']
    sources = port_engine.model.test_data_sources()
    data_dir = os.path.join(served['root'], 'test')
    items = [dict({name: src.load_file(utt, data_dir) for name, src in sources.items()},
                  name=utt) for utt in served['ids']]
    got = port_engine.predict_items(items)
    _assert_same(got, jax_engine.predict_items(items))
    _assert_same(got, port_engine.predict_ids(served['ids']))


def test_engine_needs_a_gpu_unless_asked_for_the_cpu(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(DeviceError, match="device='cpu'"):
        TEngine(TModel, served['ckpt'], data_root=served['root'], model_kwargs=MODEL_KWARGS)


def test_checkpoint_of_another_shape_is_refused(served):
    with pytest.raises(ValueError, match='checkpoint shape'):
        TEngine(TModel, served['ckpt'], data_root=served['root'], device='cpu',
                model_kwargs={'num_layers': 2, 'hidden_size': 32})
