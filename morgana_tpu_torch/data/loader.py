"""Batched loading with threaded reads and a device prefetch (counterpart
of ``morgana_tpu/data/loader.py``).

:class:`DataLoader` (``:63-230``) gives padded numpy batches: a seeded
per-epoch shuffle in the JAX package's order, optionally sorted by length
within windows of batches, a mid-epoch skip, then collation. Items load
through the dataset's native batch reader where it has one, else inline or
on a thread pool whose ``map`` keeps their order; with the native reader and
a pool, whole batches build on the pool ahead of the consumer.

:class:`ToDeviceWrapper` (``:261-478``) moves them to the device: a producer
thread keeps ``prefetch`` batches in flight, each copied from pinned host
memory by ``non_blocking`` copies on a side CUDA stream, with the device
transform of ``--device_normalise`` after them on that stream; the consumer
waits on the batch's event and hands the tensors to its own stream
(``record_stream``) before using them. With a
:class:`~morgana_tpu_torch.data.device_cache.DeviceCorpusCache` the batches
are assembled on the device instead and only index vectors cross the link.
"""
import contextlib
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from morgana_tpu_torch.data.dataset import DeviceBatch

__all__ = ['DataLoader', 'ToDeviceWrapper', 'batch', 'load_items', 'transfer_dtype_arg']


def load_items(dataset, idxs, pool=None):
    """The items at ``idxs`` in order (``loader.py:26``): through the
    dataset's native batch preload when it reads anything, else spread over
    ``pool`` when one is given, else inline. The one dispatch both the
    streaming loader and the device cache read items with."""
    preload = getattr(dataset, 'preload_batch', None)
    build = getattr(dataset, 'build_item', None)
    preloaded = preload(idxs) if preload is not None and build is not None else None
    if preloaded:
        return [build(i, {name: arrs[j] for name, arrs in preloaded.items()})
                for j, i in enumerate(idxs)]
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
        each iteration; with the native batch reader they build up to
        ``min(max(2, N), 4)`` whole batches ahead instead.
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

    def iter_known_batch_indices(self, item_lengths):
        """The epoch's batch index arrays (:meth:`iter_batch_indices`) for a
        corpus whose every item length is known (a device cache's
        ``item_lengths``): each batch's lengths are recorded as it is taken,
        at the cadence of the loading path, so that the length-sorted orders
        of later epochs are the loading path's."""
        for idxs in self.iter_batch_indices():
            if self.length_sort_window:
                for idx in idxs:
                    self._lengths[int(idx)] = int(item_lengths[int(idx)])
            yield idxs

    def _build_batch(self, idxs, pool=None):
        """One batch: its items loaded, their lengths recorded (for the
        length sort), collated."""
        items = load_items(self.dataset, [int(i) for i in idxs], pool)
        if self.length_sort_window:
            self._record_lengths(idxs, items)
        return self.dataset.collate_fn(items)

    def __iter__(self):
        """The epoch's padded batches; with ``num_data_threads``, a pool of
        that many threads lives as long as the iteration. With the native
        batch reader the pool builds whole batches ahead (``loader.py:230``:
        the reads release the interpreter lock); else it loads each batch's
        items."""
        batches = self.iter_batch_indices()
        pool = ThreadPoolExecutor(self.num_data_threads) if self.num_data_threads > 0 else None
        try:
            if pool is None or not getattr(self.dataset, 'supports_native_preload', False):
                for idxs in batches:
                    yield self._build_batch(idxs, pool)
                return
            depth = min(max(2, self.num_data_threads), 4)
            futures = deque(pool.submit(self._build_batch, idxs) for idxs in batches[:depth])
            next_batch = depth
            while futures:
                result = futures.popleft().result()
                if next_batch < len(batches):
                    futures.append(pool.submit(self._build_batch, batches[next_batch]))
                    next_batch += 1
                yield result
        finally:
            if pool is not None:
                pool.shutdown(cancel_futures=True)


def transfer_dtype_arg(value):
    """``--transfer_dtype``: None, or the torch dtype of a name
    ('bfloat16', 'float16', 'float32'); another name is a ``ValueError``."""
    if value is None or isinstance(value, torch.dtype):
        return value
    dtypes = {'bfloat16': torch.bfloat16, 'float16': torch.float16, 'float32': torch.float32}
    if str(value) not in dtypes:
        raise ValueError(f'transfer dtype {value!r}: the port takes {sorted(dtypes)}')
    return dtypes[str(value)]


def _host_tensor(value, wire):
    tensor = torch.from_numpy(np.ascontiguousarray(value))
    return tensor if wire is None else tensor.to(wire)


class ToDeviceWrapper(object):
    r"""Wraps a :class:`DataLoader`, moving each batch to ``device`` ahead of
    its use (``loader.py:261``); batches come as
    :class:`~morgana_tpu_torch.data.dataset.DeviceBatch` (the numeric values
    on the device, ``host`` the collated numpy batch;
    :func:`~morgana_tpu_torch.data.dataset.host_features` gives numpy for
    host work). Other attributes are the loader's.

    Parameters
    ----------
    data_loader : DataLoader
    prefetch : int
        Batches a producer thread keeps in flight.
    device : torch.device
    transfer_dtype : torch.dtype or None
        The wire dtype of float32 sequence features (ndim >= 3, e.g.
        bfloat16, half the bytes); per-utterance floats stay float32.
    device_transform : callable or None
        Runs on each batch once it is on the device (device-side
        normalisation); its ``pre_put`` and ``keep_f32`` shape the wire.
    device_cache : DeviceCorpusCache or None
        Batches are assembled from the device-resident corpus by index.
    """

    def __init__(self, data_loader, prefetch=2, device=None, transfer_dtype=None,
                 device_transform=None, device_cache=None):
        self.data_loader = data_loader
        self.prefetch = max(1, int(prefetch))
        self.device = torch.device(device if device is not None else 'cpu')
        self.transfer_dtype = transfer_dtype_arg(transfer_dtype)
        self.device_transform = device_transform
        self.device_cache = device_cache

    def __len__(self):
        return len(self.data_loader)

    def __getattr__(self, attr):
        if attr == 'data_loader':
            raise AttributeError(attr)
        return getattr(self.data_loader, attr)

    def _wire(self, key, value):
        """The dtype ``value`` crosses the link in: the transfer dtype for a
        float32 sequence feature the device transform does not keep in
        float32, else its own."""
        if (self.transfer_dtype is not None and value.dtype == np.float32 and value.ndim >= 3
                and key not in getattr(self.device_transform, 'keep_f32', ())):
            return self.transfer_dtype
        return None

    def stage(self, features, stream=None):
        """One collated batch on the device: the wire cast on the host, then
        (on the GPU) a pinned copy and a ``non_blocking`` copy on ``stream``,
        then the device transform on that stream. Returns ``(batch, event)``,
        ``event`` None off the GPU. On the CPU the host is the device: a
        batch with no wire cast and no transform passes through as
        collated."""
        cuda = self.device.type == 'cuda'
        if not cuda and self.transfer_dtype is None and self.device_transform is None:
            return features, None
        pre_put = getattr(self.device_transform, 'pre_put', None)
        host = features
        if pre_put is not None:
            features = pre_put(features)
        out = DeviceBatch()
        out.host = host
        with contextlib.nullcontext() if stream is None else torch.cuda.stream(stream):
            for key, value in features.items():
                if isinstance(value, np.ndarray) and value.dtype.kind in 'fiub':
                    tensor = _host_tensor(value, self._wire(key, value))
                    if cuda:
                        tensor = tensor.pin_memory().to(self.device, non_blocking=True)
                    out[key] = tensor
                else:
                    out[key] = value
            if self.device_transform is not None:
                out = self.device_transform(out)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
        return out, event

    def _hand_over(self, batch, event):
        """The consumer's side: its stream waits for the batch's copies, and
        each tensor is marked as used there, so that the allocator does not
        give its memory to the side stream while this stream reads it."""
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for value in batch.values():
                if isinstance(value, torch.Tensor):
                    value.record_stream(current)
        return batch

    def _iter_cached(self):
        """Batches assembled from the device cache by index (``loader.py:374``):
        the loader's order (shuffle, length sort, skip), only ``(B,)`` index
        vectors on the link, on the caller's thread and stream."""
        cache = self.device_cache
        for idxs in self.data_loader.iter_known_batch_indices(cache.item_lengths):
            yield cache.assemble(idxs, post=self.device_transform)

    def __iter__(self):
        if self.device_cache is not None:
            yield from self._iter_cached()
            return
        q = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error = []
        stop = threading.Event()
        cuda = self.device.type == 'cuda'

        def put_or_stop(item):
            # If the consumer abandons the iteration, the producer must not
            # block on a full queue.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with torch.cuda.device(self.device) if cuda else contextlib.nullcontext():
                    stream = torch.cuda.Stream(self.device) if cuda else None
                    for features in self.data_loader:
                        if not put_or_stop(self.stage(features, stream)):
                            return
            except BaseException as e:  # noqa: BLE001 - raised again in the consumer
                error.append(e)
            finally:
                put_or_stop(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield self._hand_over(*item)
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join()


def batch(dataset, batch_size=32, shuffle=False, num_data_threads=0, device=None, seed=0,
          drop_remainder=False, prefetch=2, length_sort_window=0, transfer_dtype=None,
          device_transform=None, device_cache=None):
    r"""The batched loader of a dataset, moving its batches to ``device``
    (``loader.py:480``): a :class:`DataLoader` (the items in order unless
    ``shuffle``; the last batch may be short) in a :class:`ToDeviceWrapper`."""
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                        num_data_threads=num_data_threads, seed=seed,
                        drop_remainder=drop_remainder, length_sort_window=length_sort_window)
    return ToDeviceWrapper(loader, prefetch=prefetch, device=device,
                           transfer_dtype=transfer_dtype, device_transform=device_transform,
                           device_cache=device_cache)
