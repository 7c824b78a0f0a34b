"""Data sources: per-utterance feature loaders (counterpart of
``morgana_tpu/data/sources.py``): ``source(base_name, data_dir) -> {name:
np.ndarray, ...}``, with ``{name}_deltas`` (static + delta + delta-delta)
when ``use_deltas``."""
import os
import zlib

import numpy as np

from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.ops.deltas import compute_deltas

__all__ = ['_DataSource', 'NumpyBinarySource', 'TextSource', 'StringSource', 'ASCIISource',
           'WavSource', 'SyntheticSource']


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


class ASCIISource(_DataSource):
    r"""A text's characters as integer ids, ``(seq_len, 1)`` int64
    (``data/sources.py:116``)."""

    def __init__(self, name, ext='txt'):
        super().__init__(name, use_deltas=False, ext=ext, sentence_level=False)

    def load_file(self, base_name, data_dir):
        with open(self.file_path(base_name, data_dir), 'r') as f:
            text = f.read().strip()
        return np.array([ord(c) for c in text], dtype=np.int64)[:, None]


class WavSource(_DataSource):
    r"""Mono 16-bit PCM waveforms as float32 ``(samples, 1)`` in [-1, 1]
    (``data/sources.py:128``); a file of another rate than ``sample_rate``
    (when given) is a ``ValueError``."""

    def __init__(self, name, ext='wav', sample_rate=None):
        super().__init__(name, use_deltas=False, ext=ext, sentence_level=False)
        self.sample_rate = sample_rate

    def load_file(self, base_name, data_dir):
        wav, sr = file_io.load_wav(self.file_path(base_name, data_dir))
        if self.sample_rate is not None and sr != self.sample_rate:
            raise ValueError(f'{base_name}: expected sample rate {self.sample_rate}, got {sr}')
        # 1/32768 keeps a full-scale negative sample (-32768) at exactly -1.
        return (wav.astype(np.float32) / 32768.0)[:, None]


class SyntheticSource(_DataSource):
    r"""Deterministic synthetic features keyed by ``(base_name, name)``, for
    tests and benchmarks (``data/sources.py:146``): no file is read.

    The seeds are CRC32s of the names, so the features are the same in every
    process (Python's ``hash`` of a string is not). An utterance's length is
    seeded by its name alone, so every source of one utterance (sharing a
    ``seq_len_range``) has the same frame count; the content is seeded by
    the utterance and the feature. ``kind`` is ``'normal'``, ``'binary'``
    or ``'positive'``.
    """

    def __init__(self, name, feat_dim, use_deltas=False, sentence_level=False, kind='normal',
                 seq_len_range=(50, 200)):
        super().__init__(name, use_deltas, None, sentence_level)
        self.feat_dim = feat_dim
        self.kind = kind
        self.seq_len_range = seq_len_range

    def load_file(self, base_name, data_dir):
        len_rng = np.random.default_rng(zlib.crc32(base_name.encode()))
        lo, hi = self.seq_len_range
        n = int(len_rng.integers(lo, hi))
        rng = np.random.default_rng(zlib.crc32(f'{base_name}\x00{self.name}'.encode()))
        if self.sentence_level:
            return np.asarray([n], dtype=np.float32)
        if self.kind == 'binary':
            return (rng.random((n, self.feat_dim)) > 0.3).astype(np.float32)
        if self.kind == 'positive':
            return (0.5 + rng.random((n, self.feat_dim))).astype(np.float32)
        return rng.normal(size=(n, self.feat_dim)).astype(np.float32)
