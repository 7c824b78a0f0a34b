"""Batching of a dataset (counterpart of ``morgana_tpu/data/loader.py``'s
``DataLoader``, ``:63-230``): a seeded per-epoch shuffle in the JAX package's
order, optionally sorted by length within windows of batches, a mid-epoch
skip, then padded collation. Items load inline or on a thread pool whose
``map`` keeps their order. The caller moves a batch to its device."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ['DataLoader', 'batch', 'load_items']


def load_items(dataset, idxs, pool=None):
    """The items at ``idxs`` in order, spread over ``pool`` when one is given
    (``loader.py:26``; the port's datasets have no native batch reader)."""
    if pool is not None:
        return list(pool.map(dataset.__getitem__, idxs))
    return [dataset[i] for i in idxs]


class DataLoader(object):
    r"""Iterates padded batches of a dataset.

    Parameters
    ----------
    dataset : FilesDataset (or any indexable with ``collate_fn``)
    batch_size : int
    shuffle : bool
        Reshuffles the item order each epoch with
        ``np.random.default_rng((seed, epoch)).permutation`` (``loader.py:110``).
    num_data_threads : int
        Threads that load a batch's items (0 loads them inline), started for
        each iteration.
    seed : int
    drop_remainder : bool
        Drops the final partial batch (the remainder is dropped before any
        length sort).
    length_sort_window : int
        When > 0 and every item's length is known (from a first epoch in
        shuffled order), sorts each window of ``length_sort_window`` batches
        by length and shuffles the full batches, the partial batch last.
    """

    def __init__(self, dataset, batch_size=32, shuffle=True, num_data_threads=0, seed=0,
                 drop_remainder=False, length_sort_window=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_data_threads = int(num_data_threads or 0)
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.length_sort_window = int(length_sort_window or 0)
        self.epoch = 0
        self.skip_batches = 0
        # Each item's longest sequence, learned as items load. The order of
        # an epoch is a function of the map _order saw (_order_lengths); a
        # resumed run replays one (_replay_lengths) once.
        self._lengths = {}
        self._order_lengths = None
        self._replay_lengths = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _order(self):
        """The epoch's item order (``loader.py:96``)."""
        n = len(self.dataset)
        if self._replay_lengths is not None:
            lengths, self._replay_lengths = self._replay_lengths, None
        else:
            lengths = dict(self._lengths)
        self._order_lengths = lengths
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.default_rng((self.seed, self.epoch))
        perm = rng.permutation(n)
        if self.drop_remainder:
            # Before the sort: a sorted window would put the longest items in
            # the partial batch that is dropped.
            perm = perm[:(n // self.batch_size) * self.batch_size]
        n_used = len(perm)
        if self.length_sort_window and len(lengths) == n:
            window = max(1, self.length_sort_window) * self.batch_size
            sorted_perm = np.concatenate([sorted(perm[s:s + window], key=lengths.__getitem__)
                                          for s in range(0, n_used, window)])
            # The full batches in shuffled order, the partial one last.
            starts = np.arange(0, n_used, self.batch_size)
            num_full = n_used // self.batch_size
            full_starts = starts[:num_full].copy()
            rng.shuffle(full_starts)
            ordered = np.concatenate([full_starts, starts[num_full:]])
            perm = np.concatenate([sorted_perm[s:s + self.batch_size]
                                   for s in ordered.astype(int)])
        return perm

    def _record_lengths(self, idxs, items):
        for idx, item in zip(idxs, items):
            max_len = 0
            for value in item.values():
                if isinstance(value, np.ndarray) and value.ndim > 1:
                    max_len = max(max_len, value.shape[0])
            self._lengths[int(idx)] = max_len

    def set_epoch(self, epoch):
        """Sets the epoch counter that keys the next iteration's order (a
        resumed run passes ``start_epoch - 1``)."""
        self.epoch = int(epoch)

    def lengths_state(self):
        """The learned length maps, for a step checkpoint (``loader.py:177``):
        ``epoch_start``, the map this epoch's order was computed from, and
        ``live``, everything recorded since."""
        return {'epoch_start': dict(self._order_lengths or {}), 'live': dict(self._lengths)}

    def set_lengths(self, state):
        """Restores a :meth:`lengths_state` snapshot; a flat ``{index:
        length}`` map (the legacy form) stands for both."""
        def clean(d):
            return {int(k): int(v) for k, v in (d or {}).items()}

        if isinstance(state, dict) and state and set(state) <= {'epoch_start', 'live'}:
            self._lengths = clean(state.get('live'))
            self._replay_lengths = clean(state.get('epoch_start'))
        else:
            self._lengths = clean(state)
            self._replay_lengths = dict(self._lengths)

    def set_skip_batches(self, n):
        """The next iteration (only) leaves out its first ``n`` batches
        without loading them (a mid-epoch resume)."""
        self.skip_batches = int(n)

    def iter_batch_indices(self):
        """The epoch's batch index arrays, after the skip; advances the epoch
        counter (``loader.py:211``)."""
        order = self._order()
        self.epoch += 1
        batches = []
        for start in range(0, len(order), self.batch_size):
            idxs = order[start:start + self.batch_size]
            if self.drop_remainder and len(idxs) < self.batch_size:
                break
            batches.append(idxs)
        skip, self.skip_batches = self.skip_batches, 0
        return batches[skip:]

    def __iter__(self):
        """The epoch's padded batches; with ``num_data_threads``, a pool of
        that many threads loads each batch's items and lives as long as the
        iteration."""
        batches = self.iter_batch_indices()
        pool = ThreadPoolExecutor(self.num_data_threads) if self.num_data_threads > 0 else None
        try:
            for idxs in batches:
                items = load_items(self.dataset, [int(i) for i in idxs], pool)
                if self.length_sort_window:
                    self._record_lengths(idxs, items)
                yield self.dataset.collate_fn(items)
        finally:
            if pool is not None:
                pool.shutdown()


def batch(dataset, batch_size=32, shuffle=False, num_data_threads=0):
    r"""The dataset's items in order (unless ``shuffle``), ``batch_size`` at a
    time, as padded batches; the last batch may be short."""
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                      num_data_threads=num_data_threads)
