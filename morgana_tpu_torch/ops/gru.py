"""One GRU layer over a padded batch (counterpart of
``morgana_tpu/ops/pallas_gru.py`` and ``ops/rnn.py::gru``).

``xg = x @ w_ih + b_ih`` is one ``torch.matmul`` over the whole sequence, as
the JAX package leaves it to XLA. ``b_hh`` is not folded into it: it sits
inside the reset product, ``n = tanh(xg_n + r * (h @ w_hh_n + b_hh_n))``. The
recurrence then runs through padded frames over ``xg``, in torch's gate form
with the gates ordered r, z, n:

* for a CUDA tensor, in kernel K3 (``csrc/gru_fwd.cu``: 4H threads a batch
  row, in one CTA or, at H = 128, a cluster of two, each thread a slice of
  ``w_hh`` in registers; K3c under a bf16 compute dtype, below), or an
  error: there is no fallback;
* for a CPU tensor, in its plain version, :func:`gru_recurrence_reference`
  (a Python loop over time with ``torch.matmul``).

When a gradient is needed, the recurrence is a :class:`torch.autograd.Function`
(the counterpart of ``_gru_layer_core``'s ``custom_vjp``): the forward runs
K3; the backward computes ``hg = h_{t-1} @ w_hh + b_hh`` for all T * B rows
in one ``torch.matmul`` (:func:`hidden_gates`, the product
``pallas_gru.py:183-185`` computes for dW_hh), then runs kernel K4
(``csrc/gru_bwd.cu``), whose only product a step is the carry through
``w_hh^T``, or its plain version for CPU tensors. K4 writes dxg and
``da_n * r``; ``dW_hh`` and ``db_hh`` read dxg's r and z columns and that.

K3 and K4 are the custom ops ``morgana::gru_fwd`` and ``morgana::gru_bwd``
(:func:`gru_fwd`, :func:`gru_bwd`; their ``cuda`` implementations launch the
kernels, their ``cpu`` ones are the plain versions).

Compute type (``compute_dtype`` bf16, the scan backend under
``--compute_dtype bfloat16``, ``ops/rnn.py:347-361``): the input GEMM
rounds x and w_ih to bf16 (:func:`~morgana_tpu_torch.ops.precision.matmul`),
and the recurrence rounds w_hh and each step's h to bf16 for ``h @ w_hh``,
whose sums, the bias, the gate math, the carried h and the outputs stay
f32: kernel K3c (``csrc/gru_fwd_bf16.cu``: one CTA of H / 8 compute warps
and its copy warps per 4 batch rows at every width, ``w_hh`` in bf16
``mma.sync`` fragments in registers, the batch rows the product's N side).
Its gradient is the JAX scan's autodiff: the backward's hg is computed on
the rounded operands, K4c (``csrc/gru_bwd_bf16.cu``: one CTA of 4H threads
a batch row at every width, ``w_hh`` as packed bf16 pairs in registers)
rounds w_hh and each step's carried ``[da_r, da_z, da_n * r] @ w_hh^T`` to
bf16, the gate gradients and dh0 staying f32, and dW_hh is the bf16 carry
of ``ops/weight_grad.py`` (db_hh an f32 sum, as the scan carries it in
f32).

Both kernels take the layer's batch-major layout and ``seq_len``: K3 zeroes
the outputs past ``seq_len`` and gathers the final ``h`` at ``seq_len - 1``
(``h0`` for empty rows), for a GRU ``y`` being the state trace
(``pallas_gru.py:221-225``); K4 is the backward of that.
"""
import ctypes
from typing import Optional

import torch

from morgana_tpu_torch.ops import precision
from morgana_tpu_torch.ops._kernels import (check_device, check_operands, load_library,
                                            mask_past_seq_len, no_alias, raise_on_error,
                                            split_entry, state_at_seq_len)
from morgana_tpu_torch.ops.weight_grad import bf16_weight_grad, bf16_weight_grad_reference

__all__ = ['gru_layer', 'gru_layer_reference', 'gru_recurrence', 'gru_recurrence_reference',
           'gru_backward', 'gru_backward_reference', 'layer_backward_reference', 'hidden_gates',
           'gru_fwd', 'gru_bwd',
           'launches', 'bwd_launches', 'bf16_compute_launches', 'bf16_compute_bwd_launches']

# Launches of K3 and of K4, each counted where its wrapper launches the
# kernel and nowhere else; a run reads them to show which path it took.
# bf16_compute_launches are those of K3c among K3's, bf16_compute_bwd_launches
# those of K4c among K4's.
launches = 0
bwd_launches = 0
bf16_compute_launches = 0
bf16_compute_bwd_launches = 0

# The kernels are built for H = 32, 64, 96 and 128: K3 and K4 with 4H
# threads a row, each with 3H/4 floats of w_hh, in one CTA up to H = 96 and
# in two above; K3c and K4c with w_hh in bf16 in one CTA.
_MAX_HIDDEN = 128


def _check_sizes(kernel, batch, hidden):
    """Raises ``ValueError``, before any launch, on a B or H that K3 and K4
    do not take: B >= 1 and H a multiple of 32 up to 128."""
    if batch < 1:
        raise ValueError(f'{kernel}: the GRU kernels take B >= 1, got B={batch}')
    if hidden < 32 or hidden % 32 or hidden > _MAX_HIDDEN:
        raise ValueError(f'{kernel}: the GRU kernels take H a multiple of 32 up to {_MAX_HIDDEN} '
                         f'(4H threads a row), got H={hidden}')


def _sizes(kernel, xg, time_major=False):
    """``(T, B, H)`` of a (B, T, 3H) ``xg`` (the kernels' layout), or of a
    (T, B, 3H) one."""
    if xg.ndim != 3 or xg.shape[2] % 3:
        layout = '(T, B, 3H)' if time_major else '(B, T, 3H)'
        raise ValueError(f'{kernel}: xg must be {layout}, got {tuple(xg.shape)}')
    first, second, gates3 = xg.shape
    time, batch = (first, second) if time_major else (second, first)
    return time, batch, gates3 // 3


def _launch(kernel, name, entry, pointers, time, batch, hidden, device, split=None):
    """Loads kernel ``name`` and calls its C entry on PyTorch's current
    stream of ``device`` with the device pointers (None for a null one), T,
    B, H and the device's index; with ``split``, the
    step_split build's entry (:func:`~morgana_tpu_torch.ops._kernels.split_entry`).
    Raises on a refused or failed launch."""
    ints = (time, batch, hidden, device.index)
    variant, entry, extra_types, extra = split_entry(entry, split)
    lib, fn = load_library(name, entry, [ctypes.c_void_p] * len(pointers)
                           + [ctypes.c_int] * len(ints) + [ctypes.c_void_p] + extra_types,
                           variant)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*pointers, *ints, stream, *extra)
    else:   # the entry sets the device; the context restores the caller's
        with torch.cuda.device(device):
            err = fn(*pointers, *ints, stream, *extra)
    raise_on_error(lib, err, f'GRU kernel {kernel} ({name}.cu) launch at T={time} B={batch} '
                   f'H={hidden}', 'H a multiple of 32 up to 128, B >= 1, inputs 16-byte aligned'
                   if name.endswith('_bf16') else
                   '4H threads a row keep w_hh in registers, in two CTAs above H = 96')


def _check_aligned(kernel, tensors):
    """Raises, before any launch, on an operand that K3c or K4c reads by
    16-byte copies and that does not start on 16 bytes."""
    for name, tensor in tensors.items():
        if tensor.data_ptr() % 16:
            raise ValueError(f'{kernel}: {name} must start on a 16-byte boundary')


def _seq_len_pointer(kernel, seq_len, batch, device):
    if seq_len is None:
        return None
    if tuple(seq_len.shape) != (batch,) or seq_len.dtype != torch.int64 \
            or seq_len.device != device or not seq_len.is_contiguous():
        raise ValueError(f'{kernel}: seq_len must be a contiguous int64 ({batch},) tensor on '
                         f'{device}')
    return seq_len.data_ptr()


def _gru_fwd_cuda(xg, w_hh, b_hh, h0, seq_len=None, compute_bf16=False, split=None):
    """Launches K3 (K3c with ``compute_bf16``: w_hh and the h each step's
    product reads rounded to bf16) on a batch-major ``xg`` (B, T, 3H) on
    PyTorch's current stream; raises on anything it does not take, and on a
    refused or failed launch. Returns ``(y, hn)``, y (B, T, H); with
    ``seq_len``, y is 0 past each row's length and hn the state there.
    ``split`` (K3c only): see :func:`~morgana_tpu_torch.ops._kernels.split_entry`."""
    global launches, bf16_compute_launches
    time, batch, hidden = _sizes('K3', xg)
    check_operands('K3', {'xg': (xg, tuple(xg.shape)), 'w_hh': (w_hh, (hidden, 3 * hidden)),
                          'b_hh': (b_hh, (3 * hidden,)), 'h0': (h0, (batch, hidden))}, xg.device)
    _check_sizes('K3', batch, hidden)
    seq = _seq_len_pointer('K3', seq_len, batch, xg.device)
    y = torch.empty((batch, time, hidden), dtype=torch.float32, device=xg.device)
    hn = torch.empty((batch, hidden), dtype=torch.float32, device=xg.device)
    pointers = (xg.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(), seq,
                y.data_ptr(), hn.data_ptr())
    if compute_bf16:
        _check_aligned('K3c', {'xg': xg})
        _launch('K3c', 'gru_fwd_bf16', 'morgana_gru_fwd_bf16', pointers, time, batch, hidden,
                xg.device, split)
    else:
        _launch('K3', 'gru_fwd', 'morgana_gru_fwd', pointers, time, batch, hidden, xg.device)
    launches += 1
    bf16_compute_launches += bool(compute_bf16)
    return y, hn


def _check_bwd_operands(xg, w_hh, h0, y, dy, dhn, time_major=False):
    """Raises on what K4 does not take among the operands it shares with
    :func:`gru_backward`; returns ``(T, B, H)``."""
    time, batch, hidden = _sizes('K4', xg, time_major)
    trace, state = tuple(xg.shape[:2]) + (hidden,), (batch, hidden)
    check_operands('K4', {'xg': (xg, tuple(xg.shape)), 'w_hh': (w_hh, (hidden, 3 * hidden)),
                          'h0': (h0, state), 'y': (y, trace), 'dy': (dy, trace),
                          'dhn': (dhn, state)}, xg.device)
    _check_sizes('K4', batch, hidden)
    return time, batch, hidden


def _gru_bwd_cuda(xg, hg, w_hh, h0, y, dy, dhn, seq_len=None, compute_bf16=False, split=None):
    """Launches K4 (K4c with ``compute_bf16``: w_hh and each step's carried
    product rounded to bf16) on batch-major operands on PyTorch's current stream; raises on anything
    it does not take, and on a refused or failed launch. Returns ``(dxg,
    dnr, dh0)``, ``dnr = da_n * r`` (B, T, H). ``split`` (K4c only): see
    :func:`~morgana_tpu_torch.ops._kernels.split_entry`."""
    global bwd_launches, bf16_compute_bwd_launches
    time, batch, hidden = _check_bwd_operands(xg, w_hh, h0, y, dy, dhn)
    check_operands('K4', {'hg': (hg, tuple(xg.shape))}, xg.device)
    seq = _seq_len_pointer('K4', seq_len, batch, xg.device)
    dxg = torch.empty_like(xg)
    dnr = torch.empty_like(y)
    dh0 = torch.empty((batch, hidden), dtype=torch.float32, device=xg.device)
    pointers = (xg.data_ptr(), hg.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), y.data_ptr(),
                dy.data_ptr(), dhn.data_ptr(), seq, dxg.data_ptr(), dnr.data_ptr(),
                dh0.data_ptr())
    if compute_bf16:
        _check_aligned('K4c', {'xg': xg, 'hg': hg, 'h0': h0, 'y': y, 'dy': dy})
        _launch('K4c', 'gru_bwd_bf16', 'morgana_gru_bwd_bf16', pointers, time, batch, hidden,
                xg.device, split)
    else:
        _launch('K4', 'gru_bwd', 'morgana_gru_bwd', pointers, time, batch, hidden, xg.device)
    bwd_launches += 1
    bf16_compute_bwd_launches += bool(compute_bf16)
    return dxg, dnr, dh0


def _gates(xg_t, hg, hidden):
    """r, z, n of one step from its input-side and hidden-side gate sums."""
    r = torch.sigmoid(xg_t[..., :hidden] + hg[..., :hidden])
    z = torch.sigmoid(xg_t[..., hidden:2 * hidden] + hg[..., hidden:2 * hidden])
    n = torch.tanh(xg_t[..., 2 * hidden:] + r * hg[..., 2 * hidden:])
    return r, z, n


def gru_recurrence_reference(xg, w_hh, b_hh, h0, compute_bf16=False):
    """Plain version of K3: ``(xg (T, B, 3H), w_hh, b_hh, h0) -> (y, hn)`` by
    a Python loop over time, the state carried in float32. With
    ``compute_bf16`` (K3c) w_hh and h are rounded to bf16 for the product."""
    time, batch, _ = xg.shape
    hidden = w_hh.shape[0]
    compute = torch.bfloat16 if compute_bf16 else None
    w = precision.rounded(w_hh.float(), compute)
    h = h0.float()
    ys = []
    for t in range(time):
        hg = torch.matmul(precision.rounded(h, compute), w) + b_hh.float()
        r, z, n = _gates(xg[t].float(), hg, hidden)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    if not ys:
        return xg.new_zeros((0, batch, hidden), dtype=torch.float32), h
    return torch.stack(ys), h


def hidden_gates(w_hh, b_hh, h0, y, batch_first=False, compute=None):
    """``(h_prev, hg)``: h_{t-1} for every step as rows of (T * B, H) (``y[t-1]``,
    ``h0`` at t = 0), and ``hg = h_prev @ w_hh + b_hh`` in the layout of
    ``y`` with 3H columns, by one ``torch.matmul`` over all the rows (the
    product ``pallas_gru.py:183-185`` computes outside its kernel), its
    operands rounded to ``compute`` as the forward's were. ``y`` is (T, B,
    H), or (B, T, H) with ``batch_first``."""
    if batch_first:
        batch, time, hidden = y.shape
        h_prev = torch.cat([h0[:, None], y], dim=1)[:, :time]
    else:
        time, batch, hidden = y.shape
        h_prev = torch.cat([h0[None], y])[:time]
    h_prev = h_prev.reshape(time * batch, hidden)
    hg = torch.matmul(precision.rounded(h_prev, compute), precision.rounded(w_hh, compute)) + b_hh
    return h_prev, hg.reshape(tuple(y.shape[:2]) + (3 * hidden,))


def gru_backward_reference(xg, hg, w_hh, h0, y, dy, dhn, compute_bf16=False):
    """Plain version of K4: the reverse-time loop of ``_gru_bwd_kernel``
    (``pallas_gru.py:68-91``), the gates taken from ``xg`` and the given
    ``hg`` (:func:`hidden_gates`) and ``h_{t-1}`` from ``y[t-1]`` (``h0`` at
    t = 0); the carry through ``w_hh^T`` is the one product a step. With
    ``compute_bf16`` (K4c) w_hh and each step's carried product are rounded
    to bf16, as the JAX scan's autodiff converts them. Returns ``(dxg,
    dh0)``."""
    time = xg.shape[0]
    hidden = w_hh.shape[0]
    compute = torch.bfloat16 if compute_bf16 else None
    w = precision.rounded(w_hh.float(), compute)
    dh = dhn.float()
    dxg = [None] * time
    for t in range(time - 1, -1, -1):
        h_prev = (y[t - 1] if t > 0 else h0).float()
        hg_t = hg[t].float()
        r, z, n = _gates(xg[t].float(), hg_t, hidden)
        dh = dy[t].float() + dh
        da_n = dh * (1.0 - z) * (1.0 - n * n)
        da_z = dh * (h_prev - n) * z * (1.0 - z)
        da_r = da_n * hg_t[..., 2 * hidden:] * r * (1.0 - r)
        dxg[t] = torch.cat([da_r, da_z, da_n], dim=-1)
        dh = dh * z + precision.rounded(
            torch.matmul(torch.cat([da_r, da_z, da_n * r], dim=-1), w.t()), compute)
    if not dxg:
        return xg.new_zeros(xg.shape, dtype=torch.float32), dh
    return torch.stack(dxg), dh


def _mask(y, hn, seq_len, h0):
    """(y zero past seq_len, the state at seq_len) of a (B, T, H) trace."""
    if seq_len is None:
        return y, hn
    y, seq_len = mask_past_seq_len(y, seq_len)
    return y, state_at_seq_len(y, seq_len, h0)


def layer_backward_reference(xg, hg, w_hh, h0, y, dy, dhn, seq_len=None, compute_bf16=False):
    """Plain version of K4 (K4c with ``compute_bf16``) as the layer launches
    it, on any device: on batch-major operands, the cotangents of the masking
    and gather (dy within seq_len, dhn at seq_len - 1, or at dh0 for an empty
    row), then :func:`gru_backward_reference`. Returns ``(dxg, dnr, dh0)``,
    ``dnr = da_n * r`` (B, T, H) with r from ``hg``."""
    hidden = w_hh.shape[0]
    empty = torch.zeros_like(dhn)
    if seq_len is not None:
        lens = seq_len.clamp(0, y.shape[1])
        steps = torch.arange(y.shape[1], device=y.device)[None, :]
        dy = dy * (steps < lens[:, None])[..., None].to(dy.dtype)
        dy = dy + (steps == lens[:, None] - 1)[..., None].to(dy.dtype) * dhn[:, None]
        empty = dhn * (lens == 0)[:, None].to(dhn.dtype)
        dhn = torch.zeros_like(dhn)
    dxg, dh0 = gru_backward_reference(xg.transpose(0, 1), hg.transpose(0, 1), w_hh, h0,
                                      y.transpose(0, 1), dy.transpose(0, 1), dhn, compute_bf16)
    dxg = dxg.transpose(0, 1)
    r = torch.sigmoid(xg[..., :hidden] + hg[..., :hidden])
    return dxg, dxg[..., 2 * hidden:] * r, dh0 + empty


@torch.library.custom_op('morgana::gru_fwd', mutates_args=(), device_types='cpu')
def gru_fwd(xg: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, h0: torch.Tensor,
            seq_len: Optional[torch.Tensor],
            compute_bf16: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``morgana::gru_fwd``, K3 (K3c with ``compute_bf16``): ``(y, hn)`` of a
    batch-major ``xg`` (B, T, 3H), y (B, T, H) zero past ``seq_len`` (an
    int64 (B,) tensor or None) and hn the state there. This is its ``cpu``
    implementation: the plain loop, then the masking and gather of
    ``pallas_gru.py:221-225``."""
    y, hn = _plain_layer_forward(xg, w_hh, b_hh, h0, seq_len, compute_bf16)
    return no_alias((y.contiguous(), hn), (xg, w_hh, b_hh, h0, seq_len))


def _plain_layer_forward(xg, w_hh, b_hh, h0, seq_len, compute_bf16=False):
    y, hn = gru_recurrence_reference(xg.transpose(0, 1), w_hh, b_hh, h0, compute_bf16)
    return _mask(y.transpose(0, 1), hn, seq_len, h0)


@gru_fwd.register_kernel('cuda')
def _gru_fwd_op_cuda(xg, w_hh, b_hh, h0, seq_len, compute_bf16=False):
    return _gru_fwd_cuda(xg, w_hh, b_hh, h0, seq_len, compute_bf16)


@gru_fwd.register_fake
def _gru_fwd_fake(xg, w_hh, b_hh, h0, seq_len, compute_bf16=False):
    batch, time, gates3 = xg.shape
    return (xg.new_empty((batch, time, gates3 // 3), dtype=torch.float32),
            xg.new_empty((batch, gates3 // 3), dtype=torch.float32))


@torch.library.custom_op('morgana::gru_bwd', mutates_args=(), device_types='cpu')
def gru_bwd(xg: torch.Tensor, hg: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
            y: torch.Tensor, dy: torch.Tensor, dhn: torch.Tensor, seq_len: Optional[torch.Tensor],
            compute_bf16: bool = False) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``morgana::gru_bwd``, K4 (K4c with ``compute_bf16``): ``(dxg, dnr,
    dh0)`` of :func:`gru_fwd`, batch-major. This is its ``cpu``
    implementation, :func:`layer_backward_reference`."""
    inputs = (xg, hg, w_hh, h0, y, dy, dhn, seq_len)
    return no_alias(tuple(t.contiguous() for t in layer_backward_reference(*inputs,
                                                                            compute_bf16)),
                    inputs)


@gru_bwd.register_kernel('cuda')
def _gru_bwd_op_cuda(xg, hg, w_hh, h0, y, dy, dhn, seq_len, compute_bf16=False):
    return _gru_bwd_cuda(xg, hg, w_hh, h0, y, dy, dhn, seq_len, compute_bf16)


@gru_bwd.register_fake
def _gru_bwd_fake(xg, hg, w_hh, h0, y, dy, dhn, seq_len, compute_bf16=False):
    return (xg.new_empty(xg.shape, dtype=torch.float32), y.new_empty(y.shape, dtype=torch.float32),
            dhn.new_empty(dhn.shape, dtype=torch.float32))


def gru_recurrence(xg, w_hh, b_hh, h0):
    """The recurrence over a time-major (T, B, 3H) ``xg``, through padding:
    :func:`gru_fwd` (kernel K3 for CUDA tensors, the plain version for CPU
    tensors) on a batch-major copy, ``xg`` checked as given first. Returns
    ``(y, hn)``, y (T, B, H)."""
    check_device('GRU recurrence', xg)
    if xg.device.type == 'cuda':
        _sizes('K3', xg, time_major=True)
        check_operands('K3', {'xg': (xg, tuple(xg.shape))}, xg.device)
    y, hn = torch.ops.morgana.gru_fwd(xg.transpose(0, 1).contiguous(), w_hh, b_hh, h0, None)
    return y.transpose(0, 1).contiguous(), hn


def gru_backward(xg, w_hh, b_hh, h0, y, dy, dhn):
    """The backward of :func:`gru_recurrence` (time-major): ``hg`` by
    :func:`hidden_gates`, then :func:`gru_bwd` (kernel K4 for CUDA tensors,
    the plain version for CPU tensors) on batch-major copies, the operands
    checked as given first. Returns ``(dxg, dh0)``."""
    check_device('GRU backward', xg)
    if xg.device.type == 'cuda':
        _check_bwd_operands(xg, w_hh, h0, y, dy, dhn, time_major=True)
    _, hg = hidden_gates(w_hh, b_hh, h0, y)
    xg, hg, y, dy = (t.transpose(0, 1).contiguous() for t in (xg, hg, y, dy))
    dxg, _, dh0 = torch.ops.morgana.gru_bwd(xg, hg, w_hh, h0, y, dy, dhn, None)
    return dxg.transpose(0, 1).contiguous(), dh0


def _layer_forward(xg, w_hh, b_hh, h0, seq_len, compute_bf16=False):
    """``(y, hn)`` of a batch-major ``xg`` (B, T, 3H): :func:`gru_fwd`; for
    CPU tensors that need a gradient, its plain version itself, which
    autograd differentiates through the loop."""
    check_device('GRU recurrence', xg)
    if xg.device.type == 'cpu' and torch.is_grad_enabled() and \
            any(t.requires_grad for t in (xg, w_hh, b_hh, h0)):
        return _plain_layer_forward(xg, w_hh, b_hh, h0, seq_len, compute_bf16)
    return torch.ops.morgana.gru_fwd(xg, w_hh, b_hh, h0, seq_len, compute_bf16)


def _layer_backward(xg, hg, w_hh, h0, y, dy, dhn, seq_len, compute_bf16=False):
    """``(dxg, dnr, dh0)`` of :func:`_layer_forward`: :func:`gru_bwd`."""
    check_device('GRU backward', xg)
    return torch.ops.morgana.gru_bwd(xg, hg, w_hh, h0, y, dy, dhn, seq_len, compute_bf16)


class _Recurrence(torch.autograd.Function):
    """``(xg, w_hh, b_hh, h0, seq_len) -> (y, hn)``, batch-major, with K3
    forward and K4 backward (``_core_fwd``/``_core_bwd``,
    ``pallas_gru.py:139-193``, with the layer's masking and gather inside),
    or with ``plain`` their plain versions on any device. With ``bf16``
    (bf16 products, the scan backend's autodiff under a bf16 compute dtype)
    K3c forward, hg on rounded operands, K4c, and dW_hh the bf16 carry.
    Saves ``xg, w_hh, b_hh, h0`` and ``y``. Absent cotangents arrive as zeros
    (autograd materialises them)."""

    @staticmethod
    def forward(ctx, xg, w_hh, b_hh, h0, seq_len, plain, bf16):
        layer_forward = _plain_layer_forward if plain else _layer_forward
        y, hn = layer_forward(xg, w_hh, b_hh, h0, seq_len, bf16)
        ctx.save_for_backward(xg, w_hh, b_hh, h0, y)
        ctx.seq_len, ctx.plain, ctx.bf16 = seq_len, plain, bf16
        return y, hn

    @staticmethod
    def backward(ctx, dy, dhn):
        xg, w_hh, b_hh, h0, y = ctx.saved_tensors
        hidden = w_hh.shape[0]
        # One GEMM gives hg to K4. The hidden-side gate gradients that dW_hh
        # and db_hh read are [da_r, da_z, da_n * r]: dxg's r and z columns
        # (a strided view, no copy), then K4's dnr.
        h_prev, hg = hidden_gates(w_hh, b_hh, h0, y, batch_first=True,
                                  compute=torch.bfloat16 if ctx.bf16 else None)
        backward = layer_backward_reference if ctx.plain else _layer_backward
        dxg, dnr, dh0 = backward(xg, hg, w_hh, h0, y, dy.contiguous(), dhn.contiguous(),
                                 ctx.seq_len, ctx.bf16)
        d_rz = dxg.reshape(-1, 3 * hidden)[:, :2 * hidden]
        dnr = dnr.reshape(-1, hidden)
        if ctx.bf16:
            # JAX's bf16 carry of w_hh_c's cotangent (ops/weight_grad.py),
            # over the batch-major rows as (T, B, .) views.
            batch, time = y.shape[:2]
            carry = bf16_weight_grad_reference if ctx.plain else bf16_weight_grad
            dg = torch.cat([d_rz, dnr], dim=1).reshape(batch, time, 3 * hidden)
            dw_hh = carry(h_prev.reshape(batch, time, hidden).transpose(0, 1), dg.transpose(0, 1))
        else:
            h_prev_t = h_prev.t()
            dw_hh = torch.cat([torch.matmul(h_prev_t, d_rz), torch.matmul(h_prev_t, dnr)], dim=1)
        return dxg, dw_hh, torch.cat([d_rz.sum(0), dnr.sum(0)]), dh0, None, None, None


def _input_gates(x, w_ih, b_ih, compute=None):
    """``xg = x @ w_ih + b_ih`` (B, T, 3H): one large GEMM, its inputs rounded
    to ``compute``. (``torch.addmm`` would save the add's launch but costs
    the host more than both on the card: cuBLASLt's bias epilogue is chosen
    anew at every call.)"""
    return precision.matmul(x, w_ih, compute) + b_ih


def gru_layer(x, w_ih, w_hh, b_ih, b_hh, seq_len=None, h0=None, compute_dtype=None):
    r"""Single-layer GRU over a padded batch, with the semantics of
    ``morgana_tpu.ops.pallas_gru.gru_layer`` and ``ops/rnn.py::gru``,
    differentiable in all six inputs.

    Parameters
    ----------
    x : torch.Tensor, shape (batch, time, in_dim)
    w_ih : (in_dim, 3H); w_hh : (H, 3H); b_ih, b_hh : (3H,)
        Gate order r, z, n (torch's), weights stored (in, gates).
    seq_len : (batch,), optional
    h0 : (batch, H), optional; zeros when absent.
    compute_dtype : None, 'bfloat16', ... (``precision.as_compute_dtype``)
        The products' input type (``ops/rnn.py::gru``'s ``compute_dtype``).

    Returns
    -------
    y : (batch, time, H), zero past ``seq_len``
    hn : the state at ``seq_len`` (at ``time`` without ``seq_len``)
    """
    return _layer(x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, compute_dtype, plain=False)


def gru_layer_reference(x, w_ih, w_hh, b_ih, b_hh, seq_len=None, h0=None, compute_dtype=None):
    """:func:`gru_layer` through the plain recurrence on any device, its
    gradient by autograd through the loop (in f32) or, with bf16 products,
    by the plain K4c and the plain bf16 carry: what the kernels are held
    against."""
    return _layer(x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, compute_dtype, plain=True)


def _layer(x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, compute_dtype, plain):
    """The layer: the input gates, then the recurrence through
    :class:`_Recurrence` when a gradient is needed (the f32 plain version
    excepted, which autograd differentiates through the loop), else its
    forward alone."""
    batch, dtype = x.shape[0], x.dtype
    compute = precision.as_compute_dtype(compute_dtype)
    bf16 = compute is not None
    xg = _input_gates(x, w_ih, b_ih, compute)
    h0 = x.new_zeros((batch, w_hh.shape[0])) if h0 is None else h0.contiguous()
    if seq_len is not None:
        seq_len = torch.as_tensor(seq_len, device=x.device).reshape(batch).long().contiguous()
    if (bf16 or not plain) and torch.is_grad_enabled() and \
            any(t.requires_grad for t in (xg, w_hh, b_hh, h0)):
        y, hn = _Recurrence.apply(xg, w_hh, b_hh, h0, seq_len, plain, bf16)
    else:
        layer_forward = _plain_layer_forward if plain else _layer_forward
        y, hn = layer_forward(xg, w_hh, b_hh, h0, seq_len, bf16)
    return y.to(dtype), hn.to(dtype)
