"""The builder's training machinery on the card: gradient accumulation of an
LSTM model through K1 and K2 against one step on the concatenated batch,
LAMB's trust-ratio update on the card against the CPU, and the batch-size
search's measured peak against its limit. Every test is marked ``cuda`` and
skips without a GPU. The file imports neither JAX nor the JAX package::

    python -m pytest --noconftest tests/test_torch_builder_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from morgana_tpu_torch import data
from morgana_tpu_torch import memory
from morgana_tpu_torch import nn
from morgana_tpu_torch.data.synthetic import generate_voice_data
from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
from morgana_tpu_torch.ops import lstm as lstm_ops
from morgana_tpu_torch.training import TrainLoop, build_optimizer

pytestmark = pytest.mark.cuda

# SGD's update is linear in the gradient: the accumulated and concatenated
# updates differ by lr times the f32 rounding of the gradient sums (TF32
# off), a few 1e-8 at lr 0.1 on parameters of order 0.1.
PARAM_ATOL = 1e-6
LR = 0.1
MODEL = {'num_layers': 2, 'hidden_size': 128}
# LAMB on the card and on the CPU: each trust ratio is a quotient of two
# norms of up to 1M values summed in other orders (a relative error up to
# ~1e-6 each): each value within LAMB_RTOL of its tensor's largest.
LAMB_RTOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.fixture
def corpus(tmp_path):
    root = str(tmp_path / 'data')
    generate_voice_data(root, num_train=8, num_valid=0, num_test=0, seed=3,
                        n_phones_range=(10, 20), dur_range=(3, 6))
    return root


def _loop(root, device, seed=4, **kwargs):
    model = LSTMAcousticModel(generator=torch.Generator().manual_seed(seed), **MODEL)
    model.normalisers = data.Normalisers(model.normaliser_sources(), 'train', root)
    model = model.to(device)
    model.mode = 'train'
    return TrainLoop(model, build_optimizer('sgd'), seed=0, **kwargs)


def _batches(root, model, sizes):
    dataset = data.FilesDataset(model.train_data_sources(), 'train', 'train/train_file_id_list.scp',
                                model.normalisers, root)
    items = [dataset[i] for i in range(len(dataset))]
    starts = np.cumsum((0,) + tuple(sizes))
    return [data.collate(items[a:b]) for a, b in zip(starts[:-1], starts[1:])]


@pytest.mark.parametrize('sizes', [(4, 4), (5, 3)])
def test_accumulated_lstm_step_matches_the_concatenated_batch(cuda_device, corpus, sizes):
    """Two micro-batches at grad_accum_steps 2 (K1 with gates and K2 for
    each layer, each micro-batch) apply the update of one step on the
    concatenated 8."""
    accum = _loop(corpus, cuda_device, grad_accum_steps=2, log_norms=True)
    micro = _batches(corpus, accum.model, sizes)
    lstm_ops.gate_launches = lstm_ops.bwd_launches = 0
    for batch in micro:
        accum.train_step(batch, LR)
    assert accum.last_step_applied
    assert lstm_ops.gate_launches == lstm_ops.bwd_launches == MODEL['num_layers'] * len(sizes)
    whole = _loop(corpus, cuda_device, log_norms=True)
    whole.train_step(_batches(corpus, whole.model, (sum(sizes),))[0], LR)
    got, want = nn.state_dict(accum.model), nn.state_dict(whole.model)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
    np.testing.assert_allclose(accum.model.metrics['train']['grad_norm'].result(),
                               whole.model.metrics['train']['grad_norm'].result(), rtol=1e-5)


def test_lamb_trust_ratio_on_the_card_is_the_cpus(cuda_device):
    """LAMB's update (AdamW, decay, the per-parameter trust ratio; one
    parameter all zeros) over three steps on the card and on the CPU, and
    the parameters after them, within LAMB_RTOL."""
    rng = np.random.default_rng(5)
    shapes = [(512, 2048), (2048,), (64, 3), (7,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    params[3][:] = 0
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(3)]
    updates = {}
    for device in (cuda_device, torch.device('cpu')):
        opt = build_optimizer('lamb', weight_decay=0.01)
        p = [torch.from_numpy(x.copy()).to(device) for x in params]
        state = opt.init(p)
        for g in grads:
            u = opt.update([torch.from_numpy(x).to(device) for x in g], state, p)
            torch._foreach_add_(p, u, alpha=-0.01)
        updates[device.type] = [t.cpu().numpy() for t in u + p]
    for got, want in zip(updates['cuda'], updates['cpu']):
        np.testing.assert_allclose(got, want, rtol=0, atol=LAMB_RTOL * np.abs(want).max())


def test_the_measured_peak_probe_stays_under_its_limit(cuda_device, corpus):
    """The search at a limit between two batch sizes' peaks: the size found
    measures at or under the limit on its own, and the next size probed above
    it measured over it."""
    loop = _loop(corpus, cuda_device)
    features = _batches(corpus, loop.model, (8,))[0]
    peaks = {b: memory.measure_train_step(loop, memory.batch_at(features, b)) for b in (4, 16)}
    limit = (peaks[4] + peaks[16]) // 2
    best, probes, failures = memory.search_train_batch_size(loop, features, limit, max_batch=64)
    assert not failures and best is not None and 4 <= best < 16
    assert probes[best] <= limit
    assert memory.measure_train_step(loop, memory.batch_at(features, best)) <= limit
    above = min(b for b in probes if b > best)
    assert probes[above] > limit
