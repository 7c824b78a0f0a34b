"""Checkpoints (counterpart of ``morgana_tpu/checkpointing.py``): the JAX
package's ``epoch_{N}.npz`` parameter files, ``{dotted_name: np.ndarray}``.
:func:`morgana_tpu_torch.nn.load_jax_params` copies one into a model and
:func:`morgana_tpu_torch.nn.state_dict` makes one from it. The JAX package's
``.train.pkl`` sidecar (optimiser state for exact resume) is not written."""
import os

import numpy as np

__all__ = ['save_state_dict', 'load_state_dict']


def save_state_dict(sd, path):
    """Saves a flat ``{name: array}`` dict as ``.npz`` (``checkpointing.py:31``)
    atomically: it writes a temporary file and renames it into place, so a
    crash mid-write leaves the previous file whole. Returns the path
    written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    target = str(path)
    if not target.endswith('.npz'):
        target += '.npz'  # np.savez would append it anyway
    write_path = target + '.tmp.npz'
    np.savez(write_path, **{k: np.asarray(v) for k, v in sd.items()})
    os.replace(write_path, target)
    return target


def load_state_dict(path):
    """Reads an ``.npz`` state dict (``checkpointing.py:53``); a path given
    without its ``.npz`` extension is found too."""
    if not os.path.exists(path) and os.path.exists(str(path) + '.npz'):
        path = str(path) + '.npz'
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
