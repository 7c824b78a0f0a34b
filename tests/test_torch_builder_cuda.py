"""The builder's training machinery on the card: gradient accumulation of an
LSTM model through K1 and K2 against one step on the concatenated batch,
LAMB's trust-ratio update on the card against the CPU, the batch-size
search's measured peak against its limit, and chains of steps captured in
CUDA graphs and replayed against the eager steps (a longer or wider chain
than those before making the chain buffers anew). Every test is marked ``cuda`` and
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


@pytest.mark.parametrize('dropout', [0.0, 0.3])
def test_a_captured_chain_replays_the_eager_steps(cuda_device, corpus, dropout):
    """train_chain on the device cache (the first step of the shape
    uncaptured, the second captured into a CUDA graph, the rest replays,
    with dropout drawing from the step generator) against the eager
    train_step on the same cached batches: per-step losses, the parameters
    and the metric results bit for bit; one graph captured."""
    from morgana_tpu_torch.data.device_cache import DeviceCorpusCache

    loops = []
    for _ in range(2):
        loop = _loop(corpus, cuda_device, seed=4)
        for module in loop.model.modules():
            if isinstance(module, nn.Dropout):
                module.p = dropout
        loops.append(loop)
    dataset = data.FilesDataset(loops[0].model.train_data_sources(), 'train',
                                'train/train_file_id_list.scp', loops[0].model.normalisers,
                                corpus)
    cache = DeviceCorpusCache(dataset, device=cuda_device)
    order = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [3, 2, 1, 0], [7, 6, 5, 4]])
    lengths = cache.padded_lengths(order.reshape(-1))
    lrs = [0.1, 0.05, 0.1, 0.02]
    chained, staged = loops[0].train_chain(cache, order, lrs, lengths=lengths)
    loops[0].model.metrics.apply_staged(staged, steps=len(order))
    eager = [loops[1].train_step(cache.assemble(idxs, lengths=lengths), lr)[0]
             for idxs, lr in zip(order, lrs)]
    assert loops[0]._graphs.captures == 1
    assert torch.equal(chained, torch.stack(eager))
    for a, b in zip(loops[0].model.parameters(), loops[1].model.parameters()):
        assert torch.equal(a, b)
    assert loops[0].model.metrics.results_as_json_dict('train') == \
        loops[1].model.metrics.results_as_json_dict('train')


def test_a_longer_or_wider_chain_makes_the_chain_buffers_anew(cuda_device, corpus):
    """Chains of 2 steps of B4, then 70 of B4 (longer than any before), then
    3 of B8 (wider): each longer or wider chain makes the loop's chain
    buffers anew and captures its steps again (three graphs in all); every
    step's loss and the parameters bit for bit the eager train_step's on
    the same cached batches."""
    from morgana_tpu_torch.data.device_cache import DeviceCorpusCache

    loops = [_loop(corpus, cuda_device, seed=5) for _ in range(2)]
    dataset = data.FilesDataset(loops[0].model.train_data_sources(), 'train',
                                'train/train_file_id_list.scp', loops[0].model.normalisers,
                                corpus)
    cache = DeviceCorpusCache(dataset, device=cuda_device)
    rng = np.random.default_rng(0)
    chains = [np.stack([rng.permutation(8)[:batch] for _ in range(n)])
              for n, batch in ((2, 4), (70, 4), (3, 8))]
    lengths = cache.padded_lengths(np.arange(8))
    chained, eager = [], []
    for order in chains:
        lrs = [0.01] * len(order)
        losses, staged = loops[0].train_chain(cache, order, lrs, lengths=lengths)
        loops[0].model.metrics.apply_staged(staged, steps=len(order))
        chained.append(losses)
        eager += [loops[1].train_step(cache.assemble(idxs, lengths=lengths), lr)[0]
                  for idxs, lr in zip(order, lrs)]
    graphs = loops[0]._graphs
    assert (graphs.captures, graphs.rows, graphs.max_batch) == (3, 70, 8)
    assert torch.equal(torch.cat(chained), torch.stack(eager))
    for a, b in zip(loops[0].model.parameters(), loops[1].model.parameters()):
        assert torch.equal(a, b)
