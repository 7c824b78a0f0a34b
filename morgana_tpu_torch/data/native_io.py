"""ctypes bindings to the native data-path library (counterpart of
``morgana_tpu/data/native_io.py``): a threaded ``.npy`` batch reader and a
parallel padded collate, in ``csrc/batch_io.cpp`` (the port's own copy of
the JAX package's source), compiled by g++ on first use into the build
directory (``_build.build_cxx``).

Every entry point takes the NumPy path when the library cannot be built (no
g++), with one warning; :func:`native_available` says which path runs. Both
paths give the same arrays.
"""
import ctypes
import logging
import os
import threading

import numpy as np

__all__ = ['native_available', 'load_npy_batch', 'pad_collate', 'SOURCE']

#: The library's C++ source.
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc', 'batch_io.cpp')
#: The ABI version the bindings expect (``morgana_batch_io_abi``).
ABI = 1

_LIB = None
_LIB_TRIED = False
_LOCK = threading.Lock()


def _load():
    global _LIB, _LIB_TRIED
    with _LOCK:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        from morgana_tpu_torch import _build
        try:
            lib = ctypes.CDLL(_build.build_cxx('batch_io', SOURCE))
            lib.morgana_batch_io_abi.restype = ctypes.c_longlong
            if lib.morgana_batch_io_abi() != ABI:
                raise OSError(f'batch_io ABI {lib.morgana_batch_io_abi()} is not {ABI}')
            ll = ctypes.c_longlong
            lib.npy_batch_shapes.restype = ll
            lib.npy_batch_shapes.argtypes = [ctypes.POINTER(ctypes.c_char_p), ll,
                                             ctypes.POINTER(ll), ctypes.POINTER(ll)]
            lib.npy_batch_fill.restype = ll
            lib.npy_batch_fill.argtypes = [ctypes.POINTER(ctypes.c_char_p), ll,
                                           ctypes.POINTER(ctypes.c_float), ll, ll]
            lib.pad_collate_f32.restype = ll
            lib.pad_collate_f32.argtypes = [ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                            ctypes.POINTER(ll), ll, ll, ll,
                                            ctypes.POINTER(ctypes.c_float)]
        except (RuntimeError, OSError, AttributeError) as exc:
            logging.getLogger(__name__).warning(
                'native batch reader unavailable (%s); the data path reads with NumPy', exc)
            lib = None
        _LIB = lib
        return _LIB


def native_available():
    """True when the native library is built and loaded."""
    return _load() is not None


def _paths_array(paths):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [os.fsencode(p) for p in paths]
    return arr


def load_npy_batch(paths, max_len=None, feat_dim=None):
    r"""A batch of float32 ``.npy`` files as one zero-padded ``(len(paths),
    max_len, feat_dim)`` array, and their lengths (``native_io.py:58``).
    Files the native reader refuses (another dtype, more than 2 axes, a
    width other than the first file's) take ``np.load``."""
    lib = _load()
    n = len(paths)
    if lib is not None:
        ll = ctypes.c_longlong
        rows = (ll * n)()
        cols = (ll * n)()
        arr = _paths_array(paths)
        if lib.npy_batch_shapes(arr, n, rows, cols) == 0:
            lens = np.ctypeslib.as_array(rows, shape=(n,)).copy()
            dims = np.ctypeslib.as_array(cols, shape=(n,)).copy()
            if feat_dim is None:
                feat_dim = int(dims[0])
            if (dims == feat_dim).all():
                if max_len is None:
                    max_len = int(lens.max())
                out = np.empty((n, max_len, feat_dim), np.float32)
                status = lib.npy_batch_fill(
                    arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_len, feat_dim)
                if status == 0:
                    return out, lens

    items = [np.asarray(np.load(p), np.float32) for p in paths]
    items = [i[:, None] if i.ndim == 1 else i for i in items]
    lens = np.array([i.shape[0] for i in items], np.int64)
    if feat_dim is None:
        feat_dim = items[0].shape[-1]
    if max_len is None:
        max_len = int(lens.max())
    out = np.zeros((n, max_len, feat_dim), np.float32)
    for i, item in enumerate(items):
        out[i, :min(item.shape[0], max_len)] = item[:max_len]
    return out, lens


def pad_collate(arrays, max_len):
    r"""Pads float32 ``(len_i, feat_dim)`` arrays to ``(n, max_len,
    feat_dim)`` with zeros (``native_io.py:104``), in parallel threads when
    the library is loaded."""
    n = len(arrays)
    feat_dim = arrays[0].shape[-1]
    lib = _load()
    if lib is not None and all(
            a.dtype == np.float32 and a.flags['C_CONTIGUOUS'] and a.ndim == 2
            and a.shape[-1] == feat_dim for a in arrays):
        ll = ctypes.c_longlong
        srcs = (ctypes.POINTER(ctypes.c_float) * n)()
        lens = (ll * n)()
        for i, a in enumerate(arrays):
            srcs[i] = a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            lens[i] = a.shape[0]
        out = np.empty((n, max_len, feat_dim), np.float32)
        lib.pad_collate_f32(srcs, lens, n, feat_dim, max_len,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    out = np.zeros((n, max_len, feat_dim), arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, :min(a.shape[0], max_len)] = a[:max_len]
    return out
