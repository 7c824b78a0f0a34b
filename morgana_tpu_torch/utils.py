"""Small helpers shared by the metrics, the experiment builder and the
analysis hooks (counterparts of the ones in ``morgana_tpu/utils.py``)."""
import re
from collections.abc import Sized

import numpy as np
import torch

__all__ = ['listify', 'format_float_tensor', 'to_numpy', 'detach_batched_seqs',
           'get_epoch_from_checkpoint_path']


def listify(object_or_list):
    r"""Wraps a value in a list unless it is a list or tuple already."""
    if not isinstance(object_or_list, (list, tuple)):
        object_or_list = [object_or_list]
    return object_or_list


def format_float_tensor(value):
    r"""Formats a scalar or 1-d vector as a short string (``utils.py:37``)."""
    def fmt(v):
        v = float(v)
        if abs(v) >= 1e-3 or v == 0.0:
            return f'{v:.3g}'
        return f'{v:.2e}'

    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    if isinstance(value, np.ndarray):
        if value.ndim == 0:
            return fmt(value)
        flat = value.reshape(-1)
    elif isinstance(value, Sized) and not isinstance(value, str):
        flat = list(value)
    else:
        return fmt(value)
    if len(flat) <= 1:
        return fmt(flat[0]) if len(flat) else '[]'
    if len(flat) <= 4:
        return '[{}]'.format(', '.join(fmt(v) for v in flat))
    return '[{}, {}, ..., {}]'.format(fmt(flat[0]), fmt(flat[1]), fmt(flat[-1]))


def detach_batched_seqs(*sequence_features, seq_len=None, squeeze=True):
    r"""Batched tensors or arrays -> host numpy, with padding removed per
    batch item (``utils.py:84``). Returns, per input feature, a list of
    per-item ``(seq_len_i, feat_dim)`` arrays (squeezed when ``squeeze``), or
    the whole array without ``seq_len``; one feature is returned bare."""
    if seq_len is not None:
        seq_len = to_numpy(seq_len).reshape(-1).astype(np.int64)

    detached = []
    for batchf in sequence_features:
        batchf = to_numpy(batchf)
        if seq_len is not None and batchf.ndim > 2:
            batchf = [feature[:n].squeeze() if squeeze else feature[:n]
                      for feature, n in zip(batchf, seq_len)]
        detached.append(batchf)

    if len(detached) == 1:
        return detached[0]
    return detached


def to_numpy(value):
    """A tensor on any device, or an array-like, as a host numpy array."""
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def get_epoch_from_checkpoint_path(checkpoint_path):
    r"""The epoch of ``.*checkpoints/epoch_(N)[_suffix].ext``, else 0."""
    match = re.match(r'.*checkpoints/epoch_(?P<epoch>\d+)(_\w+)?\.\w+', str(checkpoint_path))
    return 0 if match is None else int(match['epoch'])
