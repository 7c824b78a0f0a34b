"""Dataset and collate: length-bucketed padded batches (counterpart of
``morgana_tpu/data/dataset.py``, numpy path).

Padded lengths are rounded up to a ladder of at most 8 buckets per octave
(``bucket_size``), as in the JAX package, so a batch here has the same
padded shape as there.
"""
import os

import numpy as np
import torch

from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.data.normalisers import _SpeakerDependentNormaliser

__all__ = ['FilesDataset', 'assemble_item', 'bucket_size', 'collate', 'DeviceBatch',
           'device_features', 'host_features']


def bucket_size(n, minimum=16):
    """Rounds ``n`` up to a multiple of 1/8 of the previous power of two
    (``data/dataset.py:23``)."""
    n = int(n)
    if n <= minimum:
        return minimum
    step = max(minimum // 8, 1 << max(0, (n - 1).bit_length() - 4))
    return -(-n // step) * step


class FilesDataset(object):
    r"""Utterances of one split: each item combines the data sources' features
    for one id of ``id_list`` and adds the normalised keys
    (``data/dataset.py:35``). With ``device_normalise`` the eligible streams
    (:func:`~morgana_tpu_torch.data.device_normalise.eligible_names`) leave
    their normalised and delta keys to the loader's device transform and
    carry a ``{name}_seq_len`` length instead."""

    def __init__(self, data_sources, data_dir, id_list, normalisers, data_root='.',
                 device_normalise=False):
        for name, normaliser in (normalisers or {}).items():
            if isinstance(normaliser, _SpeakerDependentNormaliser) \
                    and 'speaker_id' not in data_sources:
                raise KeyError(f"{name} is a speaker-dependent normaliser, but no 'speaker_id' "
                               'data_source was defined')
            if name in data_sources and normaliser.use_deltas and not data_sources[name].use_deltas:
                raise ValueError(f'To normalise deltas of {name}, set `data_source.use_deltas` to True.')
        self.data_sources = data_sources
        self.data_root = data_root
        self.data_dir = os.path.join(data_root, data_dir)
        self.id_list = os.path.join(data_root, id_list)
        self.file_ids = file_io.get_file_ids(self.id_list)
        self.normalisers = normalisers or {}
        if device_normalise:
            from morgana_tpu_torch.data.device_normalise import eligible_names
            self.device_names = frozenset(eligible_names(self.data_sources, self.normalisers))
        else:
            self.device_names = frozenset()

    def __len__(self):
        return len(self.file_ids)

    def __getitem__(self, index):
        return self.build_item(index, None)

    def build_item(self, index, preloaded=None):
        """One utterance's feature dict (``data/dataset.py:75``); features
        that :meth:`preload_batch` read are taken from ``preloaded``."""
        base_name = self.file_ids[index]

        def get_packaged(name, data_source):
            if preloaded and name in preloaded:
                return data_source.package(preloaded[name])
            return data_source(base_name, self.data_dir)

        return assemble_item(self.data_sources, self.normalisers, get_packaged, base_name,
                             device_names=self.device_names)

    @property
    def supports_native_preload(self):
        """True when :meth:`preload_batch` reads at least one source with
        the native batch reader (``data/dataset.py:90``): then the loader
        builds whole batches on its threads."""
        from morgana_tpu_torch.data import native_io
        from morgana_tpu_torch.data.sources import NumpyBinarySource
        return native_io.native_available() and any(
            type(src) is NumpyBinarySource and not src.sentence_level
            for src in self.data_sources.values())

    def preload_batch(self, indices):
        """The batch's ``.npy`` sequence features, read by the native batch
        reader's thread pool with the interpreter lock released
        (``data/dataset.py:100``): ``{source_name: [per-item array]}``, empty
        when the library is not loaded. Text sources, deltas and
        normalisation stay with :meth:`build_item`."""
        from morgana_tpu_torch.data import native_io
        from morgana_tpu_torch.data.sources import NumpyBinarySource

        if not native_io.native_available():
            return {}
        indices = list(indices)
        out = {}
        for name, src in self.data_sources.items():
            # Exactly NumpyBinarySource: a subclass may read otherwise.
            if type(src) is not NumpyBinarySource or src.sentence_level:
                continue
            paths = [src.file_path(self.file_ids[i], self.data_dir) for i in indices]
            batch_arr, lens = native_io.load_npy_batch(paths)
            out[name] = [batch_arr[j, :lens[j]] for j in range(len(indices))]
        return out

    @staticmethod
    def collate_fn(batch):
        return collate(batch)


def assemble_item(data_sources, normalisers, get_packaged, base_name, device_names=()):
    """One utterance's feature dict from packaged source features, with
    ``normalised_{name}`` (and ``normalised_{name}_deltas``) keys
    (``data/dataset.py:130``); a speaker-dependent normaliser uses the
    utterance's ``speaker_id``, which is read first. ``get_packaged(name,
    data_source)`` supplies each source's packaged dict, from disk or from
    memory. Streams in ``device_names`` get no host normalised or delta keys
    but a ``{name}_seq_len`` length."""
    features = {'name': base_name}
    if 'speaker_id' in data_sources:
        features.update(get_packaged('speaker_id', data_sources['speaker_id']))

    def normalise(name, feature, deltas=False):
        normaliser = normalisers[name]
        if isinstance(normaliser, _SpeakerDependentNormaliser):
            out = normaliser.normalise(feature, features['speaker_id'], deltas=deltas)
        else:
            out = normaliser.normalise(feature, deltas=deltas)
        return np.asarray(out, np.float32)

    for name, data_source in data_sources.items():
        if name == 'speaker_id':
            continue
        packaged = get_packaged(name, data_source)
        if name in normalisers:
            if name in device_names:
                from morgana_tpu_torch.data.device_normalise import strip_host_keys
                strip_host_keys(packaged, name, packaged[name])
            else:
                packaged[f'normalised_{name}'] = normalise(name, packaged[name])
                if normalisers[name].use_deltas:
                    packaged[f'normalised_{name}_deltas'] = normalise(
                        name, packaged[f'{name}_deltas'], deltas=True)
        features.update(packaged)
    return features


def collate(batch):
    r"""Collates per-utterance feature dicts into one padded batch
    (``data/dataset.py:180``): sequences (ndim > 1) are zero-padded to the
    bucketed batch maximum, 1-d arrays and scalars stack, anything else
    passes through as a list."""
    batch_size = len(batch)
    batched = {}
    for key in batch[0].keys():
        values = [item[key] for item in batch]
        first = values[0]
        if isinstance(first, np.ndarray) and first.ndim > 1:
            max_len = bucket_size(max(v.shape[0] for v in values))
            if first.dtype == np.float32 and first.ndim == 2:
                # The native library's parallel pad-copy (the same array).
                from morgana_tpu_torch.data import native_io
                batched[key] = native_io.pad_collate(
                    [np.ascontiguousarray(v) for v in values], max_len)
                continue
            out = np.zeros((batch_size, max_len) + first.shape[1:], dtype=first.dtype)
            for i, v in enumerate(values):
                out[i, :v.shape[0]] = v
            batched[key] = out
        elif isinstance(first, np.ndarray):
            batched[key] = np.stack([np.asarray(v) for v in values])
        elif isinstance(first, bool):
            batched[key] = np.asarray(values, dtype=np.uint8)
        elif isinstance(first, (int, float, np.integer, np.floating)):
            dtype = np.int64 if isinstance(first, (int, np.integer)) else np.float32
            batched[key] = np.asarray(values, dtype=dtype)
        else:
            batched[key] = values
    return batched


class DeviceBatch(dict):
    """A collated batch whose numeric values are tensors on a device (and its
    names and other host values as they were). ``host`` is the collated
    numpy batch it was moved from, or None for a batch assembled on the
    device (:class:`~morgana_tpu_torch.data.device_cache.DeviceCorpusCache`)."""
    host = None


def device_features(features, device):
    """The numeric values of a batch as tensors on ``device``: numpy arrays
    of a collated batch are moved; tensors of a :class:`DeviceBatch` stay
    where they are if already there. Half-precision values (a
    ``--transfer_dtype`` wire) are cast to float32 on the device, as the JAX
    package's products promote them. Names and other host values
    are left out."""
    out = {}
    for key, value in features.items():
        if isinstance(value, np.ndarray) and value.dtype.kind in 'fiub':
            value = torch.from_numpy(value)
        elif not isinstance(value, torch.Tensor):
            continue
        value = value.to(device)
        if value.dtype in (torch.bfloat16, torch.float16):
            value = value.float()
        out[key] = value
    return out


def host_features(features):
    """A batch as numpy, for the analysis hooks and host bookkeeping: the
    collated host batch a :class:`DeviceBatch` was moved from, with any key
    made on the device (device-side normalisation) fetched; a batch
    assembled on the device is fetched whole (floating values as float32).
    A numpy batch is returned as it is."""
    host = getattr(features, 'host', None)
    out = dict(host) if host is not None else {}
    for key, value in features.items():
        if key in out:
            continue
        if isinstance(value, torch.Tensor):
            value = value.detach()
            if value.is_floating_point():
                value = value.float()
            value = value.cpu().numpy()
        out[key] = value
    return out
