"""Device-resident corpus cache (``--device_cache``; counterpart of
``morgana_tpu/data/device_cache.py``, single host).

The whole corpus lives in device memory, and every batch is assembled on the
device by a gather: after the one-time upload, a batch costs the host one
``(B,)`` index vector (8 bytes an utterance) instead of the collated arrays.

Layout, built once:

- sequence streams (``ndim > 1`` an item, collate's rule): one ``(sum_T,
  ...)`` arena a key, the utterances concatenated along time, with
  ``(N,)`` offset and length tables (on the device and on the host);
- scalar and per-utterance streams: one stacked ``(N, ...)`` tensor a key;
- anything else (names, speaker ids): host lists.

A batch for dataset indices ``idxs`` gathers rows ``offset[i] + t`` for
``t < len[i]`` of each sequence key (row 0 elsewhere, masked back to exact
zero: collate's padding), padded to the bucketed length
:func:`~morgana_tpu_torch.data.dataset.bucket_size` gives, so a cached batch
is bit-identical to the collated one moved to the device. With
``--device_normalise`` only raw streams are cached and the loader's device
transform (``post``) runs on the assembled batch; ``--transfer_dtype`` does
not apply (nothing crosses the link a batch) and the arenas stay float32.

Every step of :meth:`DeviceCorpusCache.scan_assemble`'s function is a device
operation without a host sync, so a captured train step (CUDA graphs,
``--steps_per_dispatch``) assembles its batch inside the graph from an index
row. The multi-host arms of the JAX module (each process caching its own
shard) are not ported: they raise ``NotImplementedError`` naming ROADMAP.md
Queue 1 item 10.
"""
import numpy as np
import torch

from morgana_tpu_torch.data.dataset import DeviceBatch, bucket_size

__all__ = ['DeviceCorpusCache', 'CacheOverBudget']

_MULTIHOST = ('multi-host device caching is not ported yet (ROADMAP.md, Queue 1 item 10: '
              'parallelism)')


class CacheOverBudget(RuntimeError):
    """The corpus would exceed the device-cache byte budget."""


def _iter_items(dataset, chunk=64):
    """Every item in dataset order, read through the loader's item-load
    dispatch (the native batch reader where it applies), so the cache holds
    exactly what the streaming path would load."""
    from morgana_tpu_torch.data.loader import load_items
    n = len(dataset)
    for start in range(0, n, chunk):
        yield from load_items(dataset, list(range(start, min(start + chunk, n))))


class DeviceCorpusCache(object):
    """Packs a dataset into device-resident arenas and assembles batches on
    the device (``device_cache.py:79``).

    Parameters
    ----------
    dataset : FilesDataset (or any indexable yielding feature dicts)
    max_bytes : int or None
        Raise :class:`CacheOverBudget`, before anything reaches the device,
        when the packed corpus would be larger.
    device : torch.device
    sharding : None
        A batch sharding (the JAX module's multi-host arms) is not ported.
    """

    def __init__(self, dataset, max_bytes=None, device=None, sharding=None):
        if sharding is not None:
            self._place_multihost(None, None)
        self.device = torch.device(device if device is not None else 'cpu')
        self.multihost = False
        self._fns = {}
        seq_data, stack_data, host_data, item_lens = {}, {}, {}, []
        n_items = 0
        for item in _iter_items(dataset):
            n_items += 1
            max_len = 0
            for key, value in item.items():
                numeric = isinstance(value, np.ndarray) and value.dtype.kind in 'fiub'
                if isinstance(value, np.ndarray) and value.ndim > 1:
                    max_len = max(max_len, value.shape[0])
                if numeric and value.ndim > 1:
                    seq_data.setdefault(key, []).append(value)
                elif numeric:
                    stack_data.setdefault(key, []).append(value)
                elif isinstance(value, bool):
                    # Before int: collate's uint8 rule for Python bools.
                    stack_data.setdefault(key, []).append(np.asarray(value, np.uint8))
                elif isinstance(value, (int, np.integer)):
                    stack_data.setdefault(key, []).append(np.asarray(value, np.int64))
                elif isinstance(value, (float, np.floating)):
                    stack_data.setdefault(key, []).append(np.asarray(value, np.float32))
                else:
                    host_data.setdefault(key, []).append(value)
            item_lens.append(max_len)
        for key, values in {**seq_data, **stack_data, **host_data}.items():
            if len(values) != n_items:
                raise ValueError(f'device_cache: key {key!r} present in only {len(values)}/'
                                 f'{n_items} items (uniform keys required, as for collate)')

        self.num_items = n_items
        self.item_lengths = np.asarray(item_lens, np.int64)
        self._host = host_data
        arenas, self._offsets, self._lens = {}, {}, {}
        total_bytes = 0
        for key, values in seq_data.items():
            lens = np.asarray([v.shape[0] for v in values], np.int64)
            offsets = np.zeros(len(values), np.int64)
            np.cumsum(lens[:-1], out=offsets[1:])
            arenas[key] = np.concatenate(values, axis=0)
            self._offsets[key] = offsets
            self._lens[key] = lens
            total_bytes += arenas[key].nbytes
        stacked = {key: np.stack(values) for key, values in stack_data.items()}
        total_bytes += sum(v.nbytes for v in stacked.values())
        # Host copies of the per-utterance streams, for host bookkeeping
        # (a chained epoch's frame count) without a device read.
        self._stacked_host = dict(stacked)
        self.bytes = int(total_bytes)
        if max_bytes is not None and total_bytes > max_bytes:
            raise CacheOverBudget(
                f'device_cache: corpus needs {total_bytes / 2**30:.2f} GiB on device, budget is '
                f'{max_bytes / 2**30:.2f} GiB (raise --device_cache_gb or drop --device_cache)')

        self._seq_keys = sorted(arenas)
        self._stack_keys = sorted(stacked)

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        self._arenas = {k: put(v) for k, v in arenas.items()}
        self._stacked = {k: put(v) for k, v in stacked.items()}
        # The tables on the device too: a batch uploads one index vector and
        # gathers the rest there.
        self._offsets_dev = {k: put(v) for k, v in self._offsets.items()}
        self._lens_dev = {k: put(v) for k, v in self._lens.items()}

    def _place_multihost(self, arenas, stacked):
        raise NotImplementedError(_MULTIHOST)

    def harmonise_lengths(self, lengths_list):
        """Cross-host agreement on padded lengths (``device_cache.py:400``):
        multi-host only, not ported."""
        raise NotImplementedError(_MULTIHOST)

    def _scan_assemble_multihost(self, lengths, post=None):
        raise NotImplementedError(_MULTIHOST)

    def __len__(self):
        return self.num_items

    def describe(self):
        return (f'{self.num_items} items, {len(self._seq_keys)} sequence + '
                f'{len(self._stacked)} stacked streams, '
                f'{self.bytes / 2**20:.1f} MiB device-resident')

    def host_stacked(self, key):
        """The host copy of a per-utterance stream, or None."""
        return self._stacked_host.get(key)

    def padded_lengths(self, idxs, bucket=True):
        """The padded frame count of each sequence key for a batch of
        dataset indices, from the host tables (``device_cache.py:531``)."""
        idxs = np.asarray(idxs)
        lengths = {}
        for key in self._seq_keys:
            padded = int(self._lens[key][idxs].max()) if len(idxs) else 0
            lengths[key] = bucket_size(padded) if bucket else padded
        return lengths

    def batch_signature(self, idxs, bucket=True, lengths=None):
        """``(batch_items, ((seq_key, padded_len), ...))``: batches that
        share it have the same shapes, and so share one captured step
        (``device_cache.py:545``)."""
        if lengths is None:
            lengths = self.padded_lengths(idxs, bucket=bucket)
        return (len(np.asarray(idxs)), tuple(sorted(lengths.items())))

    def scan_assemble(self, lengths, post=None):
        """The batch assembly of one shape signature as a function of a
        ``(B,)`` int64 index tensor on the device (``device_cache.py:555``),
        with the loader's device transform ``post`` after it: device
        operations only, so a captured step runs it."""
        seq_keys, stack_keys = self._seq_keys, self._stack_keys
        arenas, stacked = self._arenas, self._stacked
        offsets_dev, lens_dev = self._offsets_dev, self._lens_dev

        def fn(idxs):
            out = DeviceBatch()
            for key in seq_keys:
                frames = lengths[key]
                pos = torch.arange(frames, device=idxs.device)
                lens = lens_dev[key][idxs]
                valid = pos[None, :] < lens[:, None]
                rows = torch.where(valid, offsets_dev[key][idxs][:, None] + pos[None, :], 0)
                gathered = arenas[key][rows]
                mask = valid.reshape(valid.shape + (1,) * (gathered.ndim - 2))
                out[key] = torch.where(mask, gathered,
                                       torch.zeros((), dtype=gathered.dtype,
                                                   device=gathered.device))
            for key in stack_keys:
                out[key] = stacked[key][idxs]
            if post is not None:
                out = post(out)
            return out

        return fn

    def upload_indices(self, idxs):
        """``idxs`` as an int64 tensor on the device, copied from pinned
        memory without a host sync."""
        host = torch.from_numpy(np.ascontiguousarray(np.asarray(idxs, np.int64)))
        if self.device.type == 'cuda':
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def assemble(self, idxs, bucket=True, post=None, lengths=None):
        """The device batch of dataset indices ``idxs`` (``device_cache.py:666``):
        the cached equivalent of load, collate and the move to the device,
        with ``post`` (the loader's device transform) after it. The host
        values (names) are picked as collate would: stacked for arrays,
        lists otherwise."""
        idxs = np.asarray(idxs)
        if lengths is None:
            lengths = self.padded_lengths(idxs, bucket=bucket)
        sig = (len(idxs), id(post), tuple(sorted(lengths.items())))
        fn = self._fns.get(sig)
        if fn is None:
            fn = self._fns[sig] = self.scan_assemble(lengths, post=post)
        out = fn(self.upload_indices(idxs))
        for key, values in self._host.items():
            picked = [values[int(i)] for i in idxs]
            out[key] = np.stack(picked) if isinstance(picked[0], np.ndarray) else picked
        return out
