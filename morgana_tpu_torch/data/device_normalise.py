"""Device-side feature normalisation and delta computation
(``--device_normalise``; counterpart of ``morgana_tpu/data/device_normalise.py``).

The host path normalises every stream and expands its delta windows per
utterance, so a delta'd stream crosses the host-to-device link four times a
batch (raw, raw deltas, normalised, normalised deltas). With the flag:

- the dataset leaves out the host ``normalised_{name}`` / ``{name}_deltas``
  / ``normalised_{name}_deltas`` keys of every eligible stream and adds a
  ``{name}_seq_len`` length instead (:func:`strip_host_keys`);
- the loader moves only the raw stream and runs the transform of
  :func:`make_device_transform` on the device, which rebuilds the host
  keys: zero in the padding region, each item's own last frame replicated
  at its edge for the deltas.

Raw and delta keys are bit-identical to the host path; normalised keys are
within 2 float32 ulps of it (the JAX module's claim, ``:17-20``). Streams
with a speaker-dependent normaliser keep the host path, and so do streams
whose source emits deltas under a normaliser that does not take them.

Under a lossy wire (``--transfer_dtype bfloat16``), per stream: a stream
without deltas whose normaliser has a centre (MVN mean, min-max midpoint)
ships as the centred residual ``{name}_wire = x - shift``, so its rounding
scales with ``|x - shift|`` as the host path's normalise-then-round does; a
delta'd stream ships raw in float32 (its deltas are small differences,
which any wire rounding of the raw signal would swamp). Every derived key is
computed in float32 on the device and cast to the wire dtype last.
"""
import numpy as np
import torch

from morgana_tpu_torch.data.normalisers import (MeanVarianceNormaliser, MinMaxNormaliser,
                                                _SpeakerDependentNormaliser)
from morgana_tpu_torch.ops.deltas import compute_deltas_torch
from morgana_tpu_torch.ops.masking import sequence_mask

__all__ = ['eligible_names', 'seq_len_key', 'wire_key', 'make_device_transform',
           'strip_host_keys']


def seq_len_key(name):
    """The key of ``name``'s true per-item lengths, for the device-side mask
    and the deltas' edge replication."""
    return f'{name}_seq_len'


def eligible_names(data_sources, normalisers):
    """The streams whose normalised keys can move to the device
    (``device_normalise.py:70``): a normaliser that is not
    speaker-dependent over a source of this name, and deltas only where the
    normaliser takes them. The dataset's key stripping and the transform
    read this one list."""
    out = []
    for name, normaliser in (normalisers or {}).items():
        if isinstance(normaliser, _SpeakerDependentNormaliser):
            continue
        source = (data_sources or {}).get(name)
        if source is None:
            continue
        if getattr(source, 'use_deltas', False) and not normaliser.use_deltas:
            continue
        out.append(name)
    return out


def _wire_shift(normaliser):
    """The stream's centre, subtracted on the host before a lossy wire cast
    (``device_normalise.py:92``); None ships the raw stream."""
    params = getattr(normaliser, 'params', None) or {}
    if isinstance(normaliser, MeanVarianceNormaliser) and 'mean' in params:
        return np.asarray(params['mean'], np.float32)
    if isinstance(normaliser, MinMaxNormaliser) and 'mmin' in params and 'mmax' in params:
        return 0.5 * (np.asarray(params['mmin'], np.float32)
                      + np.asarray(params['mmax'], np.float32))
    return None


def wire_key(name):
    """The key of ``name``'s centred residual under a lossy wire."""
    return f'{name}_wire'


def _is_lossy(wire_dtype):
    return wire_dtype is not None and wire_dtype != torch.float32


def make_device_transform(data_sources, normalisers, names=None, wire_dtype=None):
    """The transform the loader runs on a batch once it is on the device
    (``device_normalise.py:111``). Returns ``(transform, names)``:
    ``transform(features)`` adds ``normalised_{name}`` (and ``{name}_deltas``
    and ``normalised_{name}_deltas`` for a delta'd stream) for every eligible
    ``name``, consuming the ``{name}_seq_len`` keys; ``names`` is the
    eligible list (empty: ``transform`` is None). ``names`` given (the
    dataset's ``device_names``) replaces :func:`eligible_names`.

    ``wire_dtype`` is the loader's ``transfer_dtype`` (a torch dtype). When
    lossy, ``transform.pre_put(features)`` replaces each shiftable stream of
    a host batch by its centred residual before the loader's cast, and
    ``transform.keep_f32`` names the streams the loader must not cast. Every
    operation is on the device without a host sync, so the transform runs
    inside a captured step too.
    """
    names = sorted(names) if names is not None else eligible_names(data_sources, normalisers)
    if not names:
        return None, []
    lossy = _is_lossy(wire_dtype)
    shifts = {}
    keep_f32 = frozenset()
    if lossy:
        for name in names:
            if not normalisers[name].use_deltas:
                shift = _wire_shift(normalisers[name])
                if shift is not None:
                    shifts[name] = shift
        keep_f32 = frozenset(set(names) - set(shifts))
    shift_on = {}

    def shift_tensor(name, device):
        key = (name, device)
        if key not in shift_on:
            shift_on[key] = torch.as_tensor(shifts[name], dtype=torch.float32, device=device)
        return shift_on[key]

    def core(inputs):
        out = {}
        for name in names:
            shifted = inputs.get(wire_key(name))
            feature = shifted if shifted is not None else inputs.get(name)
            if feature is None:
                continue
            normaliser = normalisers[name]
            seq_len = inputs.get(seq_len_key(name))
            valid = None
            if feature.ndim >= 3 and seq_len is not None:
                # Collate pads after normalising, so the padding region is
                # exactly zero (normalise(0) is not zero).
                valid = sequence_mask(seq_len, max_len=feature.shape[1], dtype=torch.bool)
                valid = valid.reshape(valid.shape[:2] + (1,) * (feature.ndim - 2))
            is_float = feature.is_floating_point()
            if lossy and is_float:
                out_dtype = wire_dtype
            else:
                out_dtype = feature.dtype if is_float else torch.float32
            # float32 work, rounded to the wire dtype last, as the host
            # path normalises then the loader casts.
            work = feature.float()
            if shifted is not None:
                work = work + shift_tensor(name, work.device)

            def finish(x):
                if valid is not None:
                    x = torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=x.device))
                return x.to(out_dtype)

            if lossy and is_float:
                out[name] = finish(work)
            out[f'normalised_{name}'] = finish(normaliser.normalise(work))
            if normaliser.use_deltas:
                deltas = compute_deltas_torch(work, seq_len=seq_len)
                out[f'{name}_deltas'] = finish(deltas)
                out[f'normalised_{name}_deltas'] = finish(normaliser.normalise(deltas,
                                                                               deltas=True))
        return out

    consumed = {seq_len_key(name) for name in names} | {wire_key(name) for name in shifts}

    def transform(features):
        inputs = {key: features[key] for name in names
                  for key in (name, wire_key(name), seq_len_key(name)) if key in features}
        if not inputs:
            return features
        out = type(features)((key, value) for key, value in features.items()
                             if key not in consumed)
        if hasattr(features, 'host'):
            out.host = features.host
        out.update(core(inputs))
        return out

    def pre_put(features):
        """Host side, before the loader's cast: each shiftable float32
        sequence stream becomes its centred residual."""
        out = dict(features)
        for name, shift in shifts.items():
            value = out.get(name)
            if isinstance(value, np.ndarray) and value.ndim >= 3 and value.dtype == np.float32:
                out[wire_key(name)] = value - shift
                del out[name]
        return out

    transform.pre_put = pre_put if shifts else None
    transform.keep_f32 = keep_f32
    return transform, names


def strip_host_keys(item_features, name, feature):
    """The dataset's per-item hook for an eligible stream
    (``device_normalise.py:274``): drops the host ``{name}_deltas`` and
    records the item's length under ``{name}_seq_len``."""
    item_features.pop(f'{name}_deltas', None)
    if getattr(feature, 'ndim', 0) >= 2:
        item_features[seq_len_key(name)] = np.int32(feature.shape[0])
    return item_features
