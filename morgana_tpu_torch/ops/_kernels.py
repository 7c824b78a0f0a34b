"""What the kernel wrappers share (``ops/lstm.py``, ``ops/gru.py``,
``ops/flash_attention.py``, ``ops/mlpg.py``, ``ops/weight_grad.py``): the
operand checks made before any launch, loading a kernel's ``ctypes``
library and turning a returned ``cudaError_t`` into an exception; the
outputs of a custom op, which may not alias its inputs; and, for the
recurrent layers, the padding semantics around a recurrence that runs on
through padded frames (``pallas_rnn.py:298-347``).

Every kernel is a ``torch.library`` custom op of the ``morgana`` namespace
(``torch.ops.morgana.*``): its ``cuda`` implementation launches the kernel,
its ``cpu`` one is the plain version, and a fake implementation gives the
output shapes, so that ``torch.export`` holds one op node for each kernel
call. Importing the module that defines an op registers it.
"""
import ctypes

import torch

from morgana_tpu_torch import _build

__all__ = ['check_device', 'check_operands', 'load_library', 'split_entry', 'raise_on_error',
           'no_alias', 'mask_past_seq_len', 'state_at_seq_len']


def check_device(what, tensor):
    """Raises ``ValueError`` unless ``tensor`` lies on the CPU (the plain
    version) or a CUDA device (the kernel): no other device has ``what``."""
    if tensor.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no {what} for device {tensor.device}')


def check_operands(kernel, operands, device, dtypes=(torch.float32,)):
    """Raises, before any launch, on what ``kernel`` does not take: each
    operand of ``{name: (tensor, shape[, dtype])}`` must have its shape, lie
    on ``device``, have its own dtype (float32 when none is named), which
    must be one of the ``dtypes`` the kernel is built for, and be
    contiguous."""
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


def split_entry(entry, split):
    """``(variant, entry, extra argtypes, extra args)`` of a launch of the C
    entry ``entry``: the main path's library, or with ``split`` (an int64
    tensor of two records of ``steps * 5 + 4``) the step_split build's
    ``<entry>_split``, which records the phases of the first ``steps`` steps
    of block 0 and of the middle block."""
    if split is None:
        return None, entry, [], []
    steps = (split.numel() // 2 - 4) // 5
    return 'step_split', f'{entry}_split', [ctypes.c_void_p, ctypes.c_int], \
        [split.data_ptr(), steps]


def raise_on_error(lib, err, what, hint):
    """Raises ``RuntimeError`` naming ``what`` failed, and why, when the
    cudaError_t ``err`` is not 0."""
    if err != 0:
        raise RuntimeError(f'{what} failed: {lib.morgana_cuda_error_string(err).decode()} '
                           f'(cudaError {err}); {hint}')


def no_alias(outputs, inputs):
    """``outputs`` as a tuple, each one that shares memory with one of
    ``inputs`` or with an earlier output (or is empty) replaced by a copy:
    a custom op returns tensors of its own, and a plain version may hand
    back an input unchanged (an empty sequence's state)."""
    seen = {t.untyped_storage().data_ptr() for t in inputs if t is not None and t.numel()}
    out = []
    for t in outputs:
        if not t.numel() or t.untyped_storage().data_ptr() in seen:
            t = t.clone()
        seen.add(t.untyped_storage().data_ptr())
        out.append(t)
    return tuple(out)


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
