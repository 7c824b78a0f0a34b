"""The port's DataLoader against the JAX package's, on the CPU: the batch
order (shuffle, length-sorted windows, the partial batch, the remainder
dropped before the sort, the mid-epoch skip) is exactly equal for the same
seed, epoch, lengths, skip and drop_remainder, with and without threads; the
length maps move between the two packages; and the serving engine's
``num_data_threads`` reads the same batches as inline loading."""
import numpy as np
import pytest
import torch

from morgana_tpu.data.loader import DataLoader as JLoader

from morgana_tpu_torch import checkpointing as tckpt
from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch.data.loader import DataLoader as TLoader
from morgana_tpu_torch.models.f0_test_model import F0Model as TF0
from morgana_tpu_torch.serve import InferenceEngine


class _Items(object):
    """Items of distinct lengths; a batch is the list of its item indices,
    so the two loaders' batches compare exactly."""

    def __init__(self, n, seed):
        self.lengths = np.random.default_rng(seed).integers(5, 200, size=n)

    def __len__(self):
        return len(self.lengths)

    def __getitem__(self, index):
        return {'x': np.zeros((int(self.lengths[index]), 2), np.float32), 'index': int(index)}

    @staticmethod
    def collate_fn(items, bucket=True):
        return [item['index'] for item in items]


# (items, batch_size, length_sort_window, drop_remainder, skip in epoch 3)
CASES = [(23, 4, 0, False, 0), (23, 4, 2, False, 0), (23, 4, 2, True, 0), (24, 4, 3, False, 2),
         (23, 5, 1, True, 1), (7, 8, 2, False, 0), (40, 3, 4, False, 5)]


@pytest.mark.parametrize('threads', [0, 3])
@pytest.mark.parametrize('n,batch,window,drop,skip', CASES)
def test_batch_order_is_the_jax_loaders(n, batch, window, drop, skip, threads):
    """Four epochs of each loader, from epoch 2 on: the first is in shuffled
    order (the lengths are learned on it), the rest length-sorted; the third
    skips its first batches. The batches are equal, item for item."""
    loaders = [cls(_Items(n, 11), batch_size=batch, shuffle=True, num_data_threads=threads,
                   seed=7, drop_remainder=drop, length_sort_window=window)
               for cls in (JLoader, TLoader)]
    for loader in loaders:
        loader.set_epoch(2)
    for epoch in range(4):
        if epoch == 2:
            for loader in loaders:
                loader.set_skip_batches(skip)
        want, got = (list(loader) for loader in loaders)
        assert got == want, f'epoch {epoch}'
        assert all(len(b) == batch for b in got) or not drop
    assert loaders[1].lengths_state() == loaders[0].lengths_state()


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
def test_length_maps_replay_the_interrupted_epochs_order(direction):
    """A loader stopped mid-epoch (its lengths_state taken then) and a fresh
    one of the other package given that state and the skip replay the same
    remainder, and the epoch after it too."""
    source_cls, target_cls = (JLoader, TLoader) if direction == 'jax_to_port' else \
        (TLoader, JLoader)
    kwargs = dict(batch_size=4, shuffle=True, seed=3, length_sort_window=2)
    source = source_cls(_Items(22, 5), **kwargs)
    list(source)                             # epoch 0 learns the lengths
    it = iter(source)                        # epoch 1, length-sorted
    done = [next(it), next(it)]
    state = source.lengths_state()
    rest = list(it) + [None] + list(source)  # its remainder, then epoch 2
    target = target_cls(_Items(22, 5), **kwargs)
    target.set_epoch(1)
    target.set_lengths(state)
    target.set_skip_batches(len(done))
    assert list(target) + [None] + list(target) == rest


def test_a_flat_length_map_stands_for_both():
    """The legacy flat {index: length} form sets both maps, in either
    package alike."""
    flat = {i: int(v) for i, v in enumerate(_Items(12, 2).lengths)}
    loaders = [cls(_Items(12, 2), batch_size=3, seed=1, length_sort_window=1)
               for cls in (JLoader, TLoader)]
    for loader in loaders:
        loader.set_lengths({str(k): v for k, v in flat.items()})
    assert list(loaders[1]) == list(loaders[0])
    assert loaders[1].lengths_state() == loaders[0].lengths_state()


def test_serving_engine_reads_on_threads(voice_data, tmp_path):
    """InferenceEngine(num_data_threads=3) predicts the test set exactly as
    with inline reads."""
    model = TF0(generator=torch.Generator().manual_seed(3))
    ckpt = tckpt.save_state_dict(tnn.state_dict(model), str(tmp_path / 'epoch_1.npz'))
    outputs = []
    for threads in (0, 3):
        engine = InferenceEngine(TF0, ckpt, data_root=voice_data['data_root'], device='cpu',
                                 batch_size=2, num_data_threads=threads)
        outputs.append(engine.predict_ids(voice_data['id_lists']['test'], data_dir='test'))
    assert sorted(outputs[1]) == sorted(outputs[0])
    for name, want in outputs[0].items():
        for key, value in want.items():
            np.testing.assert_array_equal(outputs[1][name][key], value)
