"""Weight-only int8 and packed int4 quantization for serving (counterpart of
``morgana_tpu/quantize.py``).

The recipe is the JAX package's: per-output-channel symmetric int8 scales
``max|w| / 127`` (:func:`quantize_array`), or two 4-bit values a byte with
one scale per ``group_size`` input rows and output channel
(:func:`quantize_array_int4`). Matrix-shaped float weights are quantized
(:func:`default_should_quantize`); biases, gains and other vectors stay
float. The values are bit-identical to the JAX package's: both divide in f32
and round half to even.

An engine (``serve.InferenceEngine(..., quantize='int8'|'int4')``) keeps the
quantized tensors on its device and nothing else of those weights: each
becomes a :mod:`torch.nn.utils.parametrize` parametrization
(:class:`Dequantize`, installed by :func:`load_params`) whose originals are
the int8 (or packed int4) tensor and its scales, so that a layer reading the
weight gets a float tensor dequantised at that read and freed after the
call. The LSTM layers of the ``'pallas'`` backend run their K1 launches in
f32 storage when quantized, as the JAX package's falls back to its f32 scan.
Dequantising is plain PyTorch, as it is plain XLA in the JAX package.

Quantized checkpoints use the JAX package's file format (the
``__quantized_format__`` markers ``morgana_tpu.int8.v1`` and
``morgana_tpu.quant.v2``, ``{name}.q`` / ``{name}.q4`` / ``{name}.scale``
arrays and a JSON manifest), so that a file written by either package is
served by the other. From the shell::

    python -m morgana_tpu_torch.quantize --checkpoint epoch_50.npz [--bits 4]

writes ``epoch_50_q8.npz`` (or ``_q4.npz``) and prints its stats as one
JSON line; the engine detects such a file and serves it quantized.
"""
import argparse
import json
import os

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from morgana_tpu_torch.checkpointing import read_npz
from morgana_tpu_torch.nn import load_jax_params

__all__ = [
    'QuantizedArray', 'Int4QuantizedArray', 'Dequantize', 'quantize_array',
    'quantize_array_int4', 'quantize_params', 'dequantize_params',
    'default_should_quantize', 'load_params', 'is_quantized',
    'save_quantized_checkpoint', 'load_quantized_checkpoint', 'is_quantized_checkpoint',
    'main',
]

# The JAX package's format markers (``quantize.py:68-72``): v1 files hold
# int8 and raw leaves only; a file with an int4 leaf carries v2.
QUANTIZED_FORMAT = 'morgana_tpu.int8.v1'
QUANTIZED_FORMAT_V2 = 'morgana_tpu.quant.v2'
_ACCEPTED_FORMATS = (QUANTIZED_FORMAT, QUANTIZED_FORMAT_V2)
_MARKER = '__quantized_format__'
DEFAULT_INT4_GROUP = 64

_DTYPES = {'float32': torch.float32, 'float64': torch.float64, 'float16': torch.float16,
           'bfloat16': torch.bfloat16}


def _dtype_name(dtype):
    return str(dtype).replace('torch.', '')


def _tensor(value):
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))


def _numpy(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _dequantize_int8(q, scale, dtype):
    return q.to(dtype) * scale.to(dtype)


def _dequantize_int4(packed, scale, rows, group_size, dtype):
    # Arithmetic shifts sign-extend the nibbles: low = (p << 4) >> 4.
    low = (packed << 4) >> 4
    high = packed >> 4
    # Interleave back to row order: [2r] = low, [2r + 1] = high.
    q = torch.stack([low, high], dim=1).reshape((2 * packed.shape[0],) + packed.shape[1:])[:rows]
    scale = scale.repeat_interleave(group_size, dim=0)[:rows]
    return q.to(dtype) * scale.to(dtype)


class QuantizedArray(object):
    """An int8 weight ``q`` with its f32 per-channel ``scale`` (broadcastable to
    ``q``; ``(1, ..., out)``), standing for the float array ``q * scale`` of
    ``float_dtype`` (``quantize.py:76``)."""
    __slots__ = ('q', 'scale', 'float_dtype')

    def __init__(self, q, scale, float_dtype=torch.float32):
        self.q = q
        self.scale = scale
        self.float_dtype = float_dtype

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self):
        return self.q.ndim

    @property
    def size(self):
        return int(np.prod(self.shape))

    @property
    def dtype(self):
        return self.float_dtype

    def tensors(self):
        """The tensors that hold the weight: ``(q, scale)``."""
        return self.q, self.scale

    def dequantize(self, dtype=None):
        return _dequantize_int8(self.q, self.scale, dtype or self.float_dtype)

    def __repr__(self):
        return f'QuantizedArray(shape={self.shape}, int8, float_dtype={_dtype_name(self.dtype)})'


class Int4QuantizedArray(object):
    """A 2-d ``(in, out)`` weight in int4, two values a byte, with one f32
    scale per ``group_size`` input rows and output channel
    (``quantize.py:140``): ``packed[r // 2, c]`` holds rows ``2r`` (low
    nibble) and ``2r + 1`` (high nibble); ``scale`` is ``(ceil(in / group),
    out)``; ``rows`` is the true input width."""
    __slots__ = ('packed', 'scale', 'rows', 'group_size', 'float_dtype')

    def __init__(self, packed, scale, rows, group_size, float_dtype=torch.float32):
        self.packed = packed
        self.scale = scale
        self.rows = int(rows)
        self.group_size = int(group_size)
        self.float_dtype = float_dtype

    @property
    def shape(self):
        return (self.rows,) + tuple(self.packed.shape[1:])

    @property
    def ndim(self):
        return self.packed.ndim

    @property
    def size(self):
        return int(np.prod(self.shape))

    @property
    def dtype(self):
        return self.float_dtype

    def tensors(self):
        """The tensors that hold the weight: ``(packed, scale)``."""
        return self.packed, self.scale

    def dequantize(self, dtype=None):
        return _dequantize_int4(self.packed, self.scale, self.rows, self.group_size,
                                dtype or self.float_dtype)

    def __repr__(self):
        return (f'Int4QuantizedArray(shape={self.shape}, int4 group={self.group_size}, '
                f'float_dtype={_dtype_name(self.dtype)})')


_QUANTIZED = (QuantizedArray, Int4QuantizedArray)


def quantize_array(w, axis=-1, float_dtype=None):
    """Per-channel symmetric int8 quantization of ``w`` (numpy or torch) over
    every axis but ``axis``: for an ``(in, out)`` kernel, one scale per
    output channel (``quantize.py:239``)."""
    w = _tensor(w)
    float_dtype = w.dtype if float_dtype is None else float_dtype
    w32 = w.to(torch.float32)
    reduce_axes = tuple(a for a in range(w.ndim) if a != axis % w.ndim)
    absmax = w32.abs().amax(dim=reduce_axes, keepdim=True)
    # An all-zero channel keeps q = 0 with scale 1.
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return QuantizedArray(q.to(torch.int8), scale, float_dtype)


def quantize_array_int4(w, group_size=DEFAULT_INT4_GROUP, float_dtype=None):
    """Group-wise symmetric int4 quantization of a 2-d ``(in, out)`` kernel:
    values in [-7, 7], one scale per (``group_size`` input rows, output
    channel), two values a byte (``quantize.py:202``)."""
    w = _tensor(w)
    if w.ndim != 2:
        raise ValueError(f'int4 quantization takes 2-d kernels, got shape {tuple(w.shape)} '
                         '(non-matrix leaves stay float or use int8)')
    float_dtype = w.dtype if float_dtype is None else float_dtype
    rows, out = int(w.shape[0]), int(w.shape[1])
    group_size = int(group_size)
    groups = -(-rows // group_size)
    # One padded buffer serves both the group grid and the nibble pairs.
    pad_to = max(groups * group_size, rows + rows % 2)
    pad_to += pad_to % 2
    w32 = torch.zeros((pad_to, out), dtype=torch.float32, device=w.device)
    w32[:rows] = w.to(torch.float32)
    absmax = w32[:groups * group_size].reshape(groups, group_size, out).abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    scale_rows = scale.repeat_interleave(group_size, dim=0)
    scale_rows = torch.cat([scale_rows, torch.ones((pad_to - scale_rows.shape[0], out),
                                                   dtype=torch.float32, device=w.device)])
    q = torch.clamp(torch.round(w32 / scale_rows), -7, 7).to(torch.int8)
    pairs = q.reshape(pad_to // 2, 2, out)
    packed = (pairs[:, 0] & 0x0F) | (pairs[:, 1] << 4)
    return Int4QuantizedArray(packed, scale, rows, group_size, float_dtype)


def default_should_quantize(name, value):
    """The default filter (``quantize.py:256``): matrix-shaped (ndim >= 2)
    float weights. Biases, gains and other vectors stay float."""
    dtype = getattr(value, 'dtype', None)
    if getattr(value, 'ndim', 0) < 2 or dtype is None:
        return False
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return np.issubdtype(dtype, np.floating)


def quantize_params(params, should_quantize=None, bits=8, group_size=DEFAULT_INT4_GROUP):
    """Quantizes a ``{name: array}`` dict (``quantize.py:267``): each leaf
    that ``should_quantize(name, value)`` picks becomes a
    :class:`QuantizedArray` (``bits=8``) or an :class:`Int4QuantizedArray`
    (``bits=4``; a leaf that is not 2-d takes int8); the others pass
    unchanged, and so do leaves quantized already."""
    if bits not in (4, 8):
        raise ValueError(f'bits must be 4 or 8, got {bits!r}')
    should_quantize = should_quantize or default_should_quantize
    out = {}
    for name, value in params.items():
        if isinstance(value, _QUANTIZED) or not should_quantize(name, value):
            out[name] = value
        elif bits == 4 and value.ndim == 2:
            out[name] = quantize_array_int4(value, group_size=group_size)
        else:
            out[name] = quantize_array(value)
    return out


def dequantize_params(params):
    """Back to a dict of float arrays and tensors."""
    return {name: value.dequantize() if isinstance(value, _QUANTIZED) else value
            for name, value in params.items()}


class Dequantize(nn.Module):
    """A parametrization (:func:`torch.nn.utils.parametrize.register_parametrization`)
    that stores a weight as its int8 (or packed int4) tensor and f32 scales,
    the two originals, and gives the layer the float weight, dequantised at
    each read. Assigning a float weight quantizes it (``right_inverse``)."""

    def __init__(self, value):
        super().__init__()
        self.int4 = isinstance(value, Int4QuantizedArray)
        self.rows = value.rows if self.int4 else None
        self.group_size = value.group_size if self.int4 else None
        self.float_dtype = value.float_dtype

    def forward(self, q, scale):
        return self.dequantize(q, scale, self.float_dtype)

    def dequantize(self, q, scale, dtype):
        """The weight in ``dtype``: q and the scales each cast to it, and
        their product (``QuantizedArray.dequantize(dtype)``,
        ``quantize.py:123``)."""
        if self.int4:
            return _dequantize_int4(q, scale, self.rows, self.group_size, dtype)
        return _dequantize_int8(q, scale, dtype)

    def right_inverse(self, weight):
        if self.int4:
            return quantize_array_int4(weight, self.group_size, self.float_dtype).tensors()
        return quantize_array(weight, float_dtype=self.float_dtype).tensors()


def load_params(module, params):
    """Loads a ``{name: array | QuantizedArray | Int4QuantizedArray}`` dict
    into ``module``, strictly (names and shapes, as
    :func:`morgana_tpu_torch.nn.load_jax_params`): float leaves are copied,
    and each quantized leaf becomes a :class:`Dequantize` parametrization
    holding exactly its tensors. No parameter changes when a name or shape
    does not match."""
    load_jax_params(module, {name: _numpy(value) for name, value in
                             dequantize_params(params).items()})
    for name, value in params.items():
        if not isinstance(value, _QUANTIZED):
            continue
        owner_name, _, attr = name.rpartition('.')
        owner = module.get_submodule(owner_name)
        getattr(owner, attr).requires_grad_(False)
        parametrize.register_parametrization(owner, attr, Dequantize(value), unsafe=True)
        originals = owner.parametrizations[attr]
        with torch.no_grad():
            originals.original0.copy_(value.tensors()[0])
            originals.original1.copy_(value.tensors()[1])


def is_quantized(module):
    """True when any weight of ``module`` is held quantized."""
    return any(isinstance(p, Dequantize) for p in module.modules())


# ----------------------------------------------------------- checkpoint files

def save_quantized_checkpoint(params, path, should_quantize=None, bits=8,
                              group_size=DEFAULT_INT4_GROUP):
    """Writes a quantized ``.npz`` checkpoint in the JAX package's format
    (``quantize.py:302``): the v2 marker when an int4 leaf is present, else
    v1. ``.npz`` is appended when ``path`` lacks it, as ``np.savez`` would;
    returns the path written."""
    if not path.endswith('.npz'):
        path = path + '.npz'
    qparams = quantize_params(params, should_quantize=should_quantize, bits=bits,
                              group_size=group_size)
    has_int4 = any(isinstance(v, Int4QuantizedArray) for v in qparams.values())
    arrays = {_MARKER: np.array(QUANTIZED_FORMAT_V2 if has_int4 else QUANTIZED_FORMAT)}
    manifest = {}
    for name, value in qparams.items():
        if isinstance(value, Int4QuantizedArray):
            arrays[f'{name}.q4'] = _numpy(value.packed)
            arrays[f'{name}.scale'] = _numpy(value.scale)
            manifest[name] = {'kind': 'int4', 'rows': value.rows, 'group_size': value.group_size,
                              'float_dtype': _dtype_name(value.float_dtype)}
        elif isinstance(value, QuantizedArray):
            arrays[f'{name}.q'] = _numpy(value.q)
            arrays[f'{name}.scale'] = _numpy(value.scale)
            manifest[name] = {'kind': 'int8', 'float_dtype': _dtype_name(value.float_dtype)}
        else:
            raw = _numpy(value)
            if raw.dtype == object:
                # np.savez would pickle it, and the loader reads without pickle.
                raise ValueError(f'parameter {name!r} is not an array (got '
                                 f'{type(value).__name__}); quantized checkpoints take a flat '
                                 '{dotted_name: array} dict')
            arrays[name] = raw
            manifest[name] = {'kind': 'raw'}
    arrays['__manifest__'] = np.array(json.dumps(manifest))
    np.savez(path, **arrays)
    return path


def is_quantized_checkpoint(path):
    """True when ``path`` is a quantized checkpoint of either package."""
    try:
        with np.load(path, allow_pickle=False) as data:
            return _MARKER in data.files and str(data[_MARKER]) in _ACCEPTED_FORMATS
    except (OSError, ValueError, KeyError):
        return False


def load_quantized_checkpoint(path):
    """A quantized checkpoint as ``{name: QuantizedArray | Int4QuantizedArray
    | tensor}``, on the CPU (``quantize.py:378``)."""
    with read_npz(path) as data:
        if _MARKER not in data.files or str(data[_MARKER]) not in _ACCEPTED_FORMATS:
            raise ValueError(f'{path} is not a morgana_tpu quantized checkpoint (write one with '
                             'python -m morgana_tpu_torch.quantize)')
        manifest = json.loads(str(data['__manifest__']))
        params = {}
        for name, spec in manifest.items():
            if spec['kind'] == 'int8':
                params[name] = QuantizedArray(_tensor(data[f'{name}.q']),
                                              _tensor(data[f'{name}.scale']),
                                              _DTYPES[spec['float_dtype']])
            elif spec['kind'] == 'int4':
                params[name] = Int4QuantizedArray(_tensor(data[f'{name}.q4']),
                                                  _tensor(data[f'{name}.scale']), spec['rows'],
                                                  spec['group_size'],
                                                  _DTYPES[spec['float_dtype']])
            elif spec['kind'] == 'raw':
                params[name] = _tensor(data[name])
            else:
                raise ValueError(f'{path}: unknown quantized-leaf kind {spec["kind"]!r} for '
                                 f'{name!r}, written by a newer release?')
        return params


def main(argv=None):
    """Quantizes a float ``epoch_{N}.npz`` into a deployment checkpoint on the
    host (``quantize.py:412``) and prints ``checkpoint``, ``out``,
    ``bytes_in``, ``bytes_out`` and ``compression`` as one JSON line. A
    checkpoint quantized already is an argparse error."""
    parser = argparse.ArgumentParser(
        description='Quantize a trained checkpoint to an int8 (or int4) deployment checkpoint '
                    '(weight-only, per-channel or group-wise scales).')
    parser.add_argument('--checkpoint', required=True,
                        help='Float epoch_{N}.npz checkpoint to quantize.')
    parser.add_argument('--out', default=None,
                        help="Output path (default: '<checkpoint>_q8.npz', or '_q4.npz' with "
                             '--bits 4).')
    parser.add_argument('--bits', type=int, default=8, choices=(4, 8),
                        help='4: packed int4 with group-wise scales; 8: per-channel int8 '
                             '(default).')
    parser.add_argument('--group_size', type=int, default=DEFAULT_INT4_GROUP,
                        help='Input rows per int4 scale group (--bits 4).')
    args = parser.parse_args(argv)

    out = args.out
    if out is None:
        root, ext = os.path.splitext(args.checkpoint)
        out = f'{root}_q{args.bits}{ext or ".npz"}'
    with np.load(args.checkpoint, allow_pickle=False) as data:
        if _MARKER in data.files:
            parser.error(f'{args.checkpoint} is already quantized')
        params = {name: data[name] for name in data.files}
    out = save_quantized_checkpoint(params, out, bits=args.bits, group_size=args.group_size)
    stats = {'checkpoint': args.checkpoint, 'out': out,
             'bytes_in': os.path.getsize(args.checkpoint), 'bytes_out': os.path.getsize(out)}
    stats['compression'] = round(stats['bytes_in'] / max(stats['bytes_out'], 1), 2)
    print(json.dumps(stats))


if __name__ == '__main__':
    main()
