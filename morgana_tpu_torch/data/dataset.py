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

__all__ = ['FilesDataset', 'assemble_item', 'bucket_size', 'collate', 'device_features']


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
    (``data/dataset.py:35``)."""

    def __init__(self, data_sources, data_dir, id_list, normalisers, data_root='.'):
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

    def __len__(self):
        return len(self.file_ids)

    def __getitem__(self, index):
        base_name = self.file_ids[index]
        return assemble_item(self.data_sources, self.normalisers,
                             lambda name, source: source(base_name, self.data_dir), base_name)

    @staticmethod
    def collate_fn(batch):
        return collate(batch)


def assemble_item(data_sources, normalisers, get_packaged, base_name):
    """One utterance's feature dict from packaged source features, with
    ``normalised_{name}`` (and ``normalised_{name}_deltas``) keys
    (``data/dataset.py:130``); a speaker-dependent normaliser uses the
    utterance's ``speaker_id``, which is read first. ``get_packaged(name,
    data_source)`` supplies each source's packaged dict, from disk or from
    memory."""
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


def device_features(features, device):
    """The numeric arrays of a collated batch as tensors on ``device``; names
    and other host values are left out."""
    return {key: torch.from_numpy(value).to(device)
            for key, value in features.items()
            if isinstance(value, np.ndarray) and value.dtype.kind in 'fiub'}
