"""Checkpoint loading (counterpart of ``morgana_tpu/checkpointing.py``): the
JAX package's ``epoch_{N}.npz`` parameter files, read as ``{dotted_name:
np.ndarray}``; :func:`morgana_tpu_torch.nn.load_jax_params` copies them into
a model."""
import os

import numpy as np

__all__ = ['load_state_dict']


def load_state_dict(path):
    """Reads an ``.npz`` state dict (``checkpointing.py:53``); a path given
    without its ``.npz`` extension is found too."""
    if not os.path.exists(path) and os.path.exists(str(path) + '.npz'):
        path = str(path) + '.npz'
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
