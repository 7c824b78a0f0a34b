"""Data sources: per-utterance feature loaders (counterpart of
``morgana_tpu/data/sources.py``): ``source(base_name, data_dir) -> {name:
np.ndarray, ...}``, with ``{name}_deltas`` (static + delta + delta-delta)
when ``use_deltas``."""
import os

import numpy as np

from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.ops.deltas import compute_deltas

__all__ = ['_DataSource', 'NumpyBinarySource', 'TextSource', 'StringSource']


class _DataSource(object):
    r"""Loads one feature for one utterance.

    Parameters
    ----------
    name : str
        Feature name: the sub-directory of ``data_dir`` holding the files and
        the key in the returned dict.
    use_deltas : bool
        Also emit ``{name}_deltas``.
    ext : str
        File extension.
    sentence_level : bool
        The feature is one frame, squeezed to a scalar or vector.
    """

    def __init__(self, name, use_deltas=False, ext=None, sentence_level=False):
        self.name = name
        self.use_deltas = use_deltas
        self.ext = ext
        self.sentence_level = sentence_level

    def file_path(self, base_name, data_dir):
        ext = f'.{self.ext}' if self.ext else ''
        return os.path.join(data_dir, self.name, f'{base_name}{ext}')

    def load_file(self, base_name, data_dir):
        raise NotImplementedError

    def __call__(self, base_name, data_dir):
        return self.package(self.load_file(base_name, data_dir))

    def package(self, feature):
        """Turns one loaded feature into the emitted dict: sentence-level
        squeeze and delta expansion (``data/sources.py:58``)."""
        features = {self.name: feature}
        if self.sentence_level and isinstance(feature, np.ndarray):
            flat = np.asarray(feature).reshape(-1)
            features[self.name] = flat[0] if flat.size == 1 else flat
        if self.use_deltas:
            features[f'{self.name}_deltas'] = compute_deltas(feature)
        return features


class NumpyBinarySource(_DataSource):
    r"""``.npy`` per-utterance binary feature files."""

    def __init__(self, name, use_deltas=False, ext='npy', sentence_level=False):
        super().__init__(name, use_deltas, ext, sentence_level)

    def load_file(self, base_name, data_dir):
        feature = np.asarray(np.load(self.file_path(base_name, data_dir)), dtype=np.float32)
        if feature.ndim == 1 and not self.sentence_level:
            feature = feature[:, None]
        return feature


class TextSource(_DataSource):
    r"""Whitespace-separated numeric text files (e.g. phone durations
    ``dur``, sentence-level ``n_frames``)."""

    def __init__(self, name, use_deltas=False, ext='txt', sentence_level=False):
        super().__init__(name, use_deltas, ext, sentence_level)

    def load_file(self, base_name, data_dir):
        return np.asarray(file_io.load_txt(self.file_path(base_name, data_dir)), np.float32)


class StringSource(_DataSource):
    r"""One string per utterance, e.g. its ``speaker_id``
    (``data/sources.py:102``). Collate keeps it as a host list, and
    :func:`~morgana_tpu_torch.data.dataset.device_features` leaves it out."""

    def __init__(self, name, ext='txt'):
        super().__init__(name, use_deltas=False, ext=ext, sentence_level=True)

    def load_file(self, base_name, data_dir):
        with open(self.file_path(base_name, data_dir), 'r') as f:
            return f.read().strip()
