"""Batching of a dataset (counterpart of ``morgana_tpu/data/loader.py``'s
``DataLoader``): a seeded per-epoch shuffle in the JAX package's order, so
the two packages see the same batches, then padded collation. Items load
inline; there are no worker threads, no length-sorted windows and no
device prefetch. The caller moves a batch to its device."""
import numpy as np

__all__ = ['DataLoader', 'batch']


class DataLoader(object):
    r"""Iterates padded batches of a dataset.

    Parameters
    ----------
    dataset : FilesDataset (or any indexable with ``collate_fn``)
    batch_size : int
    shuffle : bool
        Reshuffles the item order each epoch with
        ``np.random.default_rng((seed, epoch)).permutation`` (``loader.py:110``).
    seed : int
    drop_remainder : bool
        Drops the final partial batch.
    """

    def __init__(self, dataset, batch_size=32, shuffle=True, seed=0, drop_remainder=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch):
        """Sets the epoch counter that keys the next iteration's order (a
        resumed run passes ``start_epoch - 1``)."""
        self.epoch = int(epoch)

    def iter_batch_indices(self):
        """The epoch's batch index arrays; advances the epoch counter."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(n)
            if self.drop_remainder:
                order = order[:(n // self.batch_size) * self.batch_size]
        else:
            order = np.arange(n)
        self.epoch += 1
        batches = [order[start:start + self.batch_size]
                   for start in range(0, len(order), self.batch_size)]
        if self.drop_remainder and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self):
        for idxs in self.iter_batch_indices():
            yield self.dataset.collate_fn([self.dataset[int(i)] for i in idxs])


def batch(dataset, batch_size=32):
    r"""The dataset's items in order, ``batch_size`` at a time, as padded
    batches; the last batch may be short."""
    return DataLoader(dataset, batch_size=batch_size, shuffle=False)
