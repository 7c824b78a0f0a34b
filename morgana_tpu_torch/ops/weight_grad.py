"""The hidden-side weight gradient of a recurrent layer under a bf16 compute
dtype: the bf16 carry (shared by ``ops/lstm.py`` and ``ops/gru.py``).

Under ``--compute_dtype bfloat16`` the JAX package's scan multiplies each
step's bf16 ``h_c`` by the bf16 constant ``w_hh_c`` (``ops/rnn.py:120``,
:351), and its autodiff carries the cotangent of ``w_hh_c`` through the
transposed scan in bf16: walking t from T-1 down to 0, each step's f32
product ``h_c[t]^T @ dg[t]`` (summed over the batch) is rounded to bf16 and
added into the carry with bf16 rounding; one conversion to f32 follows the
loop. A single f32 sum rounded once is another function: against JAX's
dW_hh of an LSTM at B4 I16 H32 T256 (seed 0, on the CPU) it is 4.7e-2 of
the largest |value| off, the carry 9.2e-5 (``tests/test_torch_bf16_train.py``
holds the carry to 5e-3).

:func:`bf16_weight_grad` is the custom op ``morgana::rnn_dw_bf16``: for CUDA
tensors kernel ``csrc/rnn_dw_bf16.cu``, or an error; for CPU tensors its
plain version, :func:`bf16_weight_grad_reference`, one ``torch.matmul`` a
step. The kernel takes the products off the chain: each step's product runs
on the bf16 tensor cores (h rounded to bf16, the f32 gate gradients as
three bf16 planes that add back to them exactly, so the product is the f32
one) while the next steps' rows are in flight, and only the rounding add
into the carry is sequential in t. Where the tiles of dW fill the card (the
LSTM's widths) a block owns a tile and keeps its carries in registers over
all T steps; for a small dW (F0Model's, DurationModel's) the products of a
window of steps run in parallel over tiles and steps into a bf16 scratch,
and a second kernel chains them, a thread an element.
"""
import ctypes

import torch

from morgana_tpu_torch.ops import precision
from morgana_tpu_torch.ops._kernels import check_device, load_library, raise_on_error

__all__ = ['bf16_weight_grad', 'bf16_weight_grad_reference', 'rnn_dw_bf16', 'launches']

# Launches of the carry kernel, counted where its wrapper launches it and
# nowhere else.
launches = 0


def _check(h_prev, dg):
    """``(T, B, H, G)`` of ``h_prev`` (T, B, H) and ``dg`` (T, B, G); raises
    on anything else."""
    if h_prev.ndim != 3 or dg.ndim != 3 or tuple(h_prev.shape[:2]) != tuple(dg.shape[:2]):
        raise ValueError(f'bf16 weight gradient: h_prev must be (T, B, H) and dg (T, B, G), got '
                         f'{tuple(h_prev.shape)} and {tuple(dg.shape)}')
    return (*h_prev.shape, dg.shape[2])


def bf16_weight_grad_reference(h_prev, dg):
    """Plain version of the kernel: ``dW`` (H, G), f32 holding bf16 values,
    the bf16 carry over t from T-1 down to 0 of ``bf16(bf16(h_prev[t])^T @
    dg[t])``, each product an f32 ``torch.matmul``."""
    _check(h_prev, dg)
    dw = h_prev.new_zeros((h_prev.shape[2], dg.shape[2]), dtype=torch.float32)
    for t in range(h_prev.shape[0] - 1, -1, -1):
        step = torch.matmul(precision.rounded(h_prev[t].float(), torch.bfloat16).t(),
                            dg[t].float())
        dw = precision.rounded(dw + precision.rounded(step, torch.bfloat16), torch.bfloat16)
    return dw


def _rnn_dw_cuda(h_prev, dg):
    """Launches the kernel on PyTorch's current stream; raises on what it
    does not take (f32 operands on one CUDA device, the last dimension
    contiguous, B >= 1) and on a refused or failed launch."""
    global launches
    time, batch, hidden, gates = _check(h_prev, dg)
    for name, t in (('h_prev', h_prev), ('dg', dg)):
        if t.dtype != torch.float32 or t.device != h_prev.device or \
                (t.numel() and t.stride(2) != 1):
            raise ValueError(f'bf16 weight gradient: {name} must be float32 on {h_prev.device} '
                             f'with its last dimension contiguous')
    if batch < 1 or hidden < 1 or gates < 1:
        raise ValueError(f'bf16 weight gradient: B, H and G must be >= 1, got {batch}, '
                         f'{hidden}, {gates}')
    dw = torch.empty((hidden, gates), dtype=torch.float32, device=h_prev.device)
    lib, fn = load_library('rnn_dw_bf16', 'morgana_rnn_dw_bf16',
                           [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
                           + [ctypes.c_int, ctypes.c_void_p])
    device = h_prev.device.index
    lib.morgana_rnn_dw_bf16_scratch.argtypes = [ctypes.c_int] * 4
    lib.morgana_rnn_dw_bf16_scratch.restype = ctypes.c_longlong
    # The rounded step products of a window of steps, where the carry takes
    # that route (small H * G): bf16 (steps, H, G).
    size = lib.morgana_rnn_dw_bf16_scratch(time, hidden, gates, device)
    scratch = torch.empty(size, dtype=torch.bfloat16, device=h_prev.device) if size else None
    with torch.cuda.device(h_prev.device):
        err = fn(h_prev.data_ptr(), dg.data_ptr(), dw.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), time, batch, hidden, gates,
                 h_prev.stride(0), h_prev.stride(1), dg.stride(0), dg.stride(1), device,
                 torch.cuda.current_stream(h_prev.device).cuda_stream)
    raise_on_error(lib, err, f'bf16 weight-gradient kernel at T={time} B={batch} H={hidden} '
                   f'G={gates}', 'a block of 256 threads with a 64 x 128 tile of dW and three '
                   'stages of two steps of 32 batch rows of h_prev and dg in shared memory '
                   '(150 KB), or of 128 threads with a 64 x 64 tile (104 KB); a scratch of '
                   'at most 2^25 bf16 step products')
    launches += 1
    return dw


@torch.library.custom_op('morgana::rnn_dw_bf16', mutates_args=(), device_types='cpu')
def rnn_dw_bf16(h_prev: torch.Tensor, dg: torch.Tensor) -> torch.Tensor:
    """``morgana::rnn_dw_bf16``: dW (H, G) of ``h_prev`` (T, B, H) and ``dg``
    (T, B, G). This is its ``cpu`` implementation, the plain version."""
    return bf16_weight_grad_reference(h_prev, dg)


@rnn_dw_bf16.register_kernel('cuda')
def _rnn_dw_bf16_op_cuda(h_prev, dg):
    return _rnn_dw_cuda(h_prev, dg)


@rnn_dw_bf16.register_fake
def _rnn_dw_bf16_fake(h_prev, dg):
    return h_prev.new_empty((h_prev.shape[2], dg.shape[2]), dtype=torch.float32)


def bf16_weight_grad(h_prev, dg):
    """dW of a recurrence's ``h @ w_hh`` under a bf16 compute dtype,
    :func:`rnn_dw_bf16`: the kernel for CUDA tensors, the plain version for
    CPU tensors. ``h_prev`` (T, B, H) and ``dg`` (T, B, G) may be views
    with any strides for t and b."""
    check_device('bf16 weight gradient', h_prev)
    return torch.ops.morgana.rnn_dw_bf16(h_prev, dg)
