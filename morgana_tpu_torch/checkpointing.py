"""Checkpoints (counterpart of ``morgana_tpu/checkpointing.py``): the JAX
package's ``epoch_{N}.npz`` parameter files, ``{dotted_name: np.ndarray}``.
:func:`morgana_tpu_torch.nn.load_jax_params` copies one into a model and
:func:`morgana_tpu_torch.nn.state_dict` makes one from it.

The JAX package also writes an ``epoch_{N}.train.pkl`` sidecar beside each
checkpoint (``checkpointing.py:66``): a plain pickle of the optimiser state
(optax's named tuples of numpy arrays), the EMA parameters, the step count
and the LR-schedule state, for exact resume. :func:`load_training_state`
reads it without optax or JAX; the port does not write one."""
import collections
import os
import pickle

import numpy as np

__all__ = ['save_state_dict', 'load_state_dict', 'training_state_path_for',
           'load_training_state', 'AdamState', 'EmptyState']

# optax's state classes, as plain named tuples with the same fields: the
# unpickler builds these in their place.
AdamState = collections.namedtuple('ScaleByAdamState', ['count', 'mu', 'nu'])
EmptyState = collections.namedtuple('EmptyState', [])

_OPTAX_STATES = {'ScaleByAdamState': AdamState, 'EmptyState': EmptyState}
# What a sidecar's numpy arrays and scalars unpickle through, under numpy 1's
# module names and numpy 2's.
_NUMPY_GLOBALS = {(module, name) for prefix in ('numpy.core', 'numpy._core')
                  for module, name in ((f'{prefix}.multiarray', '_reconstruct'),
                                       (f'{prefix}.multiarray', 'scalar'),
                                       (f'{prefix}.numeric', '_frombuffer'))}
_NUMPY_GLOBALS |= {('numpy', 'dtype'), ('numpy', 'ndarray')}


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


def training_state_path_for(checkpoint_path):
    """The sidecar of a parameter checkpoint: ``epoch_N.npz`` ->
    ``epoch_N.train.pkl`` (``checkpointing.py:60``)."""
    return os.path.splitext(str(checkpoint_path))[0] + '.train.pkl'


class _SidecarUnpickler(pickle.Unpickler):
    """Builds numpy arrays and optax's Adam and empty states (as
    :data:`AdamState` / :data:`EmptyState`); any other class is refused."""

    def find_class(self, module, name):
        if module.startswith('optax.') and name in _OPTAX_STATES:
            return _OPTAX_STATES[name]
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f'the training-state sidecar holds {module}.{name}, which the port does not '
            f'restore (it maps optax Adam state: {sorted(_OPTAX_STATES)})')


def load_training_state(path):
    """The sidecar's dict: ``params``, ``opt_state`` (a tuple of
    :data:`AdamState` / :data:`EmptyState`, or one of them), ``ema_params``
    (``{name: array}`` or None), ``step`` and ``extra`` (with
    ``lr_schedule``, a schedule's ``state_dict``)."""
    with open(path, 'rb') as f:
        return _SidecarUnpickler(f).load()
