"""Checkpoints (counterpart of ``morgana_tpu/checkpointing.py``): the JAX
package's ``epoch_{N}.npz`` parameter files, ``{dotted_name: np.ndarray}``.
:func:`morgana_tpu_torch.nn.load_jax_params` copies one into a model and
:func:`morgana_tpu_torch.nn.state_dict` makes one from it.

The JAX package also writes an ``epoch_{N}.train.pkl`` sidecar beside each
checkpoint (``checkpointing.py:66``): a plain pickle of the optimiser state
(optax's named tuples of numpy arrays), the EMA parameters, the step count
and the LR-schedule state, for exact resume. :func:`load_training_state`
reads it without optax or JAX, and :func:`save_training_state` writes the
port's in the same layout, optax's state classes named by their module
paths, so that the JAX builder resumes from it as from its own."""
import collections
import io
import os
import pickle

import numpy as np

__all__ = ['save_state_dict', 'load_state_dict', 'read_npz', 'training_state_path_for',
           'save_training_state', 'load_training_state', 'AdamState', 'EmptyState',
           'TraceState']

# optax's state classes, as plain named tuples with the same fields: the
# unpickler builds these in their place.
AdamState = collections.namedtuple('ScaleByAdamState', ['count', 'mu', 'nu'])
EmptyState = collections.namedtuple('EmptyState', [])
TraceState = collections.namedtuple('TraceState', ['trace'])

_OPTAX_STATES = {'ScaleByAdamState': AdamState, 'EmptyState': EmptyState,
                 'TraceState': TraceState}
# Where optax defines them: a sidecar the port writes names these.
_OPTAX_PATHS = {AdamState: ('optax._src.transform', 'ScaleByAdamState'),
                EmptyState: ('optax._src.base', 'EmptyState'),
                TraceState: ('optax.transforms._accumulation', 'TraceState')}
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
    with read_npz(path) as data:
        return {k: data[k] for k in data.files}


def read_npz(path):
    """``np.load`` (without pickles) of an ``.npz`` file read in one call.
    ``np.load`` on the path reads each array in 256 KiB pieces, and each
    read gives up the interpreter lock: a checkpoint reload in a serving
    process then waits behind the request threads once a piece. Returns
    the ``NpzFile``, a context manager."""
    with open(path, 'rb') as f:
        return np.load(io.BytesIO(f.read()), allow_pickle=False)


def training_state_path_for(checkpoint_path):
    """The sidecar of a parameter checkpoint: ``epoch_N.npz`` ->
    ``epoch_N.train.pkl`` (``checkpointing.py:60``)."""
    return os.path.splitext(str(checkpoint_path))[0] + '.train.pkl'


class _SidecarPickler(pickle._Pickler):
    """Pickles :data:`AdamState`, :data:`EmptyState` and :data:`TraceState`
    as optax's classes, by module path (optax need not be importable), and
    everything else as :mod:`pickle` does. It is the Python pickler, whose
    ``save_global`` can be given other names; the C one looks each class up
    in its module."""

    def save_global(self, obj, name=None):
        path = _OPTAX_PATHS.get(obj)
        if path is None:
            return super().save_global(obj, name)
        for part in path:
            self.save(part)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def save_training_state(path, params, opt_state=None, ema_params=None, step=0, extra=None):
    """Writes the ``.train.pkl`` sidecar (``checkpointing.py:66``) that
    :func:`load_training_state` and the JAX package read: ``{'params',
    'opt_state', 'ema_params', 'step', 'extra'}``, with numpy arrays, the
    optimiser state a tuple of :data:`AdamState` / :data:`EmptyState` /
    :data:`TraceState` (as optax's ``chain`` keeps it). Written to a
    temporary file and renamed into place. Returns the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    state = {'params': params, 'opt_state': opt_state, 'ema_params': ema_params,
             'step': int(step), 'extra': extra}
    target = str(path)
    with open(target + '.tmp', 'wb') as f:
        _SidecarPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(state)
    os.replace(target + '.tmp', target)
    return target


class _SidecarUnpickler(pickle.Unpickler):
    """Builds numpy arrays and optax's Adam, trace and empty states (as
    :data:`AdamState` / :data:`TraceState` / :data:`EmptyState`); any other
    class is refused."""

    def find_class(self, module, name):
        if module.startswith('optax.') and name in _OPTAX_STATES:
            return _OPTAX_STATES[name]
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f'the training-state sidecar holds {module}.{name}, which the port does not '
            f'restore (it maps the optax states {sorted(_OPTAX_STATES)})')


def load_training_state(path):
    """The sidecar's dict: ``params``, ``opt_state`` (a tuple of
    :data:`AdamState` / :data:`TraceState` / :data:`EmptyState`, or one of
    them), ``ema_params`` (``{name: array}`` or None), ``step`` and
    ``extra`` (with ``lr_schedule``, a schedule's ``state_dict``; a step
    checkpoint's also has ``epoch``, ``batches_done``, ``num_batches`` and
    ``loader_lengths``)."""
    with open(path, 'rb') as f:
        return _SidecarUnpickler(f).load()
