"""Feature normalisers (counterpart of ``morgana_tpu/data/normalisers.py``),
with the same parameter-file contract: ``{name}_mvn.json`` (mean, std_dev)
and ``{name}_minmax.json`` (mmin, mmax), plus ``{name}_deltas_*.json`` when
``use_deltas``.

``normalise``/``denormalise`` take numpy arrays (the host data pipeline) or
tensors on any device (inside ``predict``); for a tensor the parameters are
moved to its device once and kept there.
"""
import os

import numpy as np
import torch

from morgana_tpu_torch.data import file_io

__all__ = ['MeanVarianceNormaliser', 'MinMaxNormaliser', 'fit_mvn_params', 'fit_minmax_params']


def _align(param, feature):
    """Inserts the time axis only when the feature has one (sentence-level
    ``(D,)`` features broadcast directly)."""
    if feature.ndim > param.ndim:
        return param[..., None, :]
    return param


def _safe_scale(mmin, mmax):
    scale = mmax - mmin
    if isinstance(scale, torch.Tensor):
        return torch.where(scale.abs() <= 1e-8, torch.ones_like(scale), scale)
    scale = scale.copy()
    scale[np.abs(scale) <= 1e-8] = 1.
    return scale


def _stack_frames(features):
    return np.concatenate([np.asarray(f, np.float64).reshape(-1, np.asarray(f).shape[-1])
                           for f in features], axis=0)


def fit_mvn_params(features):
    """MVN parameters over a list of (seq_len, feat_dim) arrays, in the
    ``{name}_mvn.json`` layout (``data/normalisers.py:68``)."""
    stacked = _stack_frames(features)
    return {'mean': stacked.mean(0).tolist(), 'std_dev': stacked.std(0).tolist()}


def fit_minmax_params(features):
    """Min-max parameters over a list of (seq_len, feat_dim) arrays, in the
    ``{name}_minmax.json`` layout (``data/normalisers.py:75``)."""
    stacked = _stack_frames(features)
    return {'mmin': stacked.min(0).tolist(), 'mmax': stacked.max(0).tolist()}


class _FeatureNormaliser(object):
    r"""Loads parameters from JSON into float32 numpy arrays and exposes
    ``normalise``/``denormalise``."""

    def __init__(self, name, use_deltas=False, file_pattern='{name}.json'):
        self.name = name
        self.use_deltas = use_deltas
        self.file_pattern = file_pattern
        self.params = None
        self.delta_params = None
        self._on_device = {}

    def _normalise(self, feature, **params):
        raise NotImplementedError

    def _denormalise(self, feature, **params):
        raise NotImplementedError

    def normalise(self, feature, deltas=False):
        return self._normalise(feature, **self.fetch_params(deltas, like=feature))

    def denormalise(self, feature, deltas=False):
        return self._denormalise(feature, **self.fetch_params(deltas, like=feature))

    def fetch_params(self, deltas=False, like=None):
        """The parameters as numpy arrays, or as tensors on the device and in
        the dtype of ``like`` when it is a tensor."""
        params = self.delta_params if deltas else self.params
        if params is None:
            hint = ('construct the normaliser with use_deltas=True'
                    if deltas and not self.use_deltas else 'call load_params')
            raise RuntimeError(f'Normaliser {self.name!r}: '
                               f'{"delta " if deltas else ""}parameters not loaded ({hint})')
        if not isinstance(like, torch.Tensor):
            return params
        key = (deltas, like.device, like.dtype)
        if key not in self._on_device:
            self._on_device[key] = {k: torch.as_tensor(v, dtype=like.dtype, device=like.device)
                                    for k, v in params.items()}
        return self._on_device[key]

    @staticmethod
    def _from_json(file_path):
        return {k: np.array(v, dtype=np.float32) for k, v in file_io.load_json(file_path).items()}

    def load_params(self, data_dir, data_root='.'):
        r"""Loads parameters from ``{data_root}/{data_dir}/{pattern}`` JSON files."""
        pattern = os.path.join(data_root, data_dir, self.file_pattern)
        self.params = self._from_json(pattern.format(name=self.name))
        if self.use_deltas:
            self.delta_params = self._from_json(pattern.format(name=self.name + '_deltas'))
        self._on_device = {}


class MeanVarianceNormaliser(_FeatureNormaliser):
    r"""Zero-mean unit-variance normalisation; params from ``{name}_mvn.json``."""

    def __init__(self, name, use_deltas=False):
        super().__init__(name, use_deltas, '{name}_mvn.json')

    def _normalise(self, feature, mean, std_dev):
        return (feature - _align(mean, feature)) / (_align(std_dev, feature) + 1e-8)

    def _denormalise(self, feature, mean, std_dev):
        return feature * _align(std_dev, feature) + _align(mean, feature)


class MinMaxNormaliser(_FeatureNormaliser):
    r"""[0, 1] min-max normalisation; params from ``{name}_minmax.json``."""

    def __init__(self, name, use_deltas=False):
        super().__init__(name, use_deltas, '{name}_minmax.json')

    def _normalise(self, feature, mmin, mmax):
        return (feature - _align(mmin, feature)) / _align(_safe_scale(mmin, mmax), feature)

    def _denormalise(self, feature, mmin, mmax):
        return feature * _align(_safe_scale(mmin, mmax), feature) + _align(mmin, feature)
