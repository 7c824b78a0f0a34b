"""What the kernel wrappers share (``ops/lstm.py``, ``ops/gru.py``,
``ops/flash_attention.py``): the operand checks made before any launch,
loading a kernel's ``ctypes`` library and turning a returned ``cudaError_t``
into an exception; and, for the recurrent layers, the padding semantics
around a recurrence that runs on through padded frames
(``pallas_rnn.py:298-347``)."""
import ctypes

import torch

from morgana_tpu_torch import _build

__all__ = ['check_operands', 'load_library', 'raise_on_error', 'mask_past_seq_len',
           'state_at_seq_len']


def check_operands(kernel, operands, device, dtypes=(torch.float32,)):
    """Raises, before any launch, on what ``kernel`` does not take: each
    operand of ``{name: (tensor, shape[, dtype])}`` must have its shape, lie
    on ``device``, have its dtype (float32 when none is named), one of the
    ``dtypes`` the kernel is built for, and be contiguous."""
    for name, (tensor, shape, *dtype) in operands.items():
        want = dtype[0] if dtype else torch.float32
        if tuple(tensor.shape) != shape:
            raise ValueError(f'{kernel}: {name} must be {shape}, got {tuple(tensor.shape)}')
        if tensor.device != device:
            raise ValueError(f'{kernel}: {name} is on {tensor.device}, expected {device}')
        if want not in dtypes or tensor.dtype != want:
            raise TypeError(f'{kernel} takes {[str(d) for d in dtypes]}, {name} is '
                            f'{tensor.dtype} (expected {want})')
        if not tensor.is_contiguous():
            raise ValueError(f'{kernel}: {name} must be contiguous')


_ENTRIES = {}  # (name, entry, variant) -> (lib, fn), set up once


def load_library(name, entry, argtypes, variant=None):
    """``(lib, fn)``: kernel ``name``'s library (its ``variant``, see
    ``_build.VARIANTS``), built on first use, and its C entry point with
    ``argtypes`` set; every entry returns a cudaError_t."""
    if (name, entry, variant) not in _ENTRIES:
        lib = _build.load(name, variant)
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.morgana_cuda_error_string.argtypes = [ctypes.c_int]
        lib.morgana_cuda_error_string.restype = ctypes.c_char_p
        _ENTRIES[name, entry, variant] = lib, fn
    return _ENTRIES[name, entry, variant]


def raise_on_error(lib, err, what, hint):
    """Raises ``RuntimeError`` naming ``what`` failed, and why, when the
    cudaError_t ``err`` is not 0."""
    if err != 0:
        raise RuntimeError(f'{what} failed: {lib.morgana_cuda_error_string(err).decode()} '
                           f'(cudaError {err}); {hint}')


def mask_past_seq_len(y, seq_len):
    """``(y zeroed past seq_len, seq_len as a (B,) tensor)`` for a (B, T, H)
    output trace."""
    batch, time, _ = y.shape
    seq_len = torch.as_tensor(seq_len, device=y.device).reshape(batch)
    mask = torch.arange(time, device=y.device)[None, :] < seq_len[:, None]
    return y * mask[:, :, None].to(y.dtype), seq_len


def state_at_seq_len(trace, seq_len, state0):
    """Each row's state at ``seq_len - 1`` of a (B, T, H) trace, ``state0``
    for empty rows (``pallas_rnn.py:298``) and for an empty trace."""
    batch, time, hidden = trace.shape
    if time == 0:
        return state0
    idx = (seq_len - 1).clamp(0, time - 1).long()
    picked = torch.gather(trace, 1, idx[:, None, None].expand(batch, 1, hidden))[:, 0]
    return torch.where((seq_len > 0)[:, None], picked, state0)
