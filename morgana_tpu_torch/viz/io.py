"""Feature dumping (counterpart of ``morgana_tpu/viz/io.py``): batched
sequence features saved per utterance as
``{out_dir}/feats/{feat_name}/{utt}.npy``, padding removed."""
import os

import numpy as np

from morgana_tpu_torch import utils
from morgana_tpu_torch.data import file_io

__all__ = ['save_batched_seqs']


def save_batched_seqs(sequence_features, names, out_dir, seq_len=None, feat_names=None):
    r"""Saves sequence features of a batch of utterances (``viz/io.py:16``).

    ``sequence_features`` is a dict (its keys name the sub-directories,
    ``feat_names`` selecting a subset), or a list of features or one
    (batch, time, dim) feature with ``feat_names`` given. Tensors are moved
    to the host and each item is cut at its ``seq_len``.
    """
    pred_dir = os.path.join(out_dir, 'feats')
    os.makedirs(pred_dir, exist_ok=True)

    if isinstance(sequence_features, dict):
        if feat_names is None:
            feat_names = list(sequence_features.keys())
        sequence_features = [sequence_features[feat_name] for feat_name in feat_names]
    else:
        if feat_names is None:
            raise ValueError('If sequence features is not a dictionary, then feat_names must be '
                             'provided.')
        if not isinstance(sequence_features, (list, tuple)):
            sequence_features = [sequence_features]   # one (batch, time, dim) feature

    for feat_name, feature in zip(feat_names, sequence_features):
        values = utils.detach_batched_seqs(feature, seq_len=seq_len)
        if len(values) and isinstance(values[0], np.ndarray):
            file_io.save_dir(file_io.save_bin, path=os.path.join(pred_dir, feat_name),
                             data=values, file_ids=names)
