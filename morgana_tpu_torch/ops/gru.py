"""One GRU layer over a padded batch (counterpart of
``morgana_tpu/ops/pallas_gru.py`` and ``ops/rnn.py::gru``).

``xg = x @ w_ih + b_ih`` is one ``torch.matmul`` over the whole sequence, as
the JAX package leaves it to XLA. ``b_hh`` is not folded into it: it sits
inside the reset product, ``n = tanh(xg_n + r * (h @ w_hh_n + b_hh_n))``. The
recurrence then runs through padded frames over ``xg``, in torch's gate form
with the gates ordered r, z, n:

* for a CUDA tensor, in kernel K3 (``csrc/gru_fwd.cu``: 4H threads a batch
  row, in one CTA or, at H = 128, a cluster of two, each thread a slice of
  ``w_hh`` in registers), or an error: there is no fallback;
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

Both kernels take the layer's batch-major layout and ``seq_len``: K3 zeroes
the outputs past ``seq_len`` and gathers the final ``h`` at ``seq_len - 1``
(``h0`` for empty rows), for a GRU ``y`` being the state trace
(``pallas_gru.py:221-225``); K4 is the backward of that.
"""
import ctypes

import torch

from morgana_tpu_torch.ops._kernels import (check_operands, load_library,
                                            mask_past_seq_len, raise_on_error,
                                            state_at_seq_len)

__all__ = ['gru_layer', 'gru_layer_reference', 'gru_recurrence', 'gru_recurrence_reference',
           'gru_backward', 'gru_backward_reference', 'layer_backward_reference', 'hidden_gates',
           'launches', 'bwd_launches']

# Launches of K3 and of K4, each counted where its wrapper launches the
# kernel and nowhere else; a run reads them to show which path it took.
launches = 0
bwd_launches = 0

# The kernels are built for H = 32, 64, 96 and 128: 4H threads a row, each
# with 3H/4 floats of w_hh, in one CTA up to H = 96 and in two above.
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


def _launch(kernel, name, entry, pointers, time, batch, hidden, device):
    """Loads kernel ``name`` and calls its C entry on PyTorch's current
    stream of ``device`` with the device pointers (None for a null one), T,
    B, H and the device's index; raises on a refused or failed launch."""
    lib, fn = load_library(name, entry, [ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*pointers, time, batch, hidden, device.index, stream)
    else:   # the entry sets the device; the context restores the caller's
        with torch.cuda.device(device):
            err = fn(*pointers, time, batch, hidden, device.index, stream)
    raise_on_error(lib, err, f'GRU kernel {kernel} launch at T={time} B={batch} H={hidden}',
                   '4H threads a row keep w_hh in registers, in two CTAs above H = 96')


def _seq_len_pointer(kernel, seq_len, batch, device):
    if seq_len is None:
        return None
    if tuple(seq_len.shape) != (batch,) or seq_len.dtype != torch.int64 \
            or seq_len.device != device or not seq_len.is_contiguous():
        raise ValueError(f'{kernel}: seq_len must be a contiguous int64 ({batch},) tensor on '
                         f'{device}')
    return seq_len.data_ptr()


def _gru_fwd_cuda(xg, w_hh, b_hh, h0, seq_len=None):
    """Launches K3 on a batch-major ``xg`` (B, T, 3H) on PyTorch's current
    stream; raises on anything it does not take, and on a refused or failed
    launch. Returns ``(y, hn)``, y (B, T, H); with ``seq_len``, y is 0 past
    each row's length and hn the state there."""
    global launches
    time, batch, hidden = _sizes('K3', xg)
    check_operands('K3', {'xg': (xg, tuple(xg.shape)), 'w_hh': (w_hh, (hidden, 3 * hidden)),
                          'b_hh': (b_hh, (3 * hidden,)), 'h0': (h0, (batch, hidden))}, xg.device)
    _check_sizes('K3', batch, hidden)
    seq = _seq_len_pointer('K3', seq_len, batch, xg.device)
    y = torch.empty((batch, time, hidden), dtype=torch.float32, device=xg.device)
    hn = torch.empty((batch, hidden), dtype=torch.float32, device=xg.device)
    _launch('K3', 'gru_fwd', 'morgana_gru_fwd',
            (xg.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(), seq, y.data_ptr(),
             hn.data_ptr()), time, batch, hidden, xg.device)
    launches += 1
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


def _gru_bwd_cuda(xg, hg, w_hh, h0, y, dy, dhn, seq_len=None):
    """Launches K4 on batch-major operands on PyTorch's current stream;
    raises on anything it does not take, and on a refused or failed launch.
    Returns ``(dxg, dnr, dh0)``, ``dnr = da_n * r`` (B, T, H)."""
    global bwd_launches
    time, batch, hidden = _check_bwd_operands(xg, w_hh, h0, y, dy, dhn)
    check_operands('K4', {'hg': (hg, tuple(xg.shape))}, xg.device)
    seq = _seq_len_pointer('K4', seq_len, batch, xg.device)
    dxg = torch.empty_like(xg)
    dnr = torch.empty_like(y)
    dh0 = torch.empty((batch, hidden), dtype=torch.float32, device=xg.device)
    _launch('K4', 'gru_bwd', 'morgana_gru_bwd',
            (xg.data_ptr(), hg.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), y.data_ptr(),
             dy.data_ptr(), dhn.data_ptr(), seq, dxg.data_ptr(), dnr.data_ptr(), dh0.data_ptr()),
            time, batch, hidden, xg.device)
    bwd_launches += 1
    return dxg, dnr, dh0


def _gates(xg_t, hg, hidden):
    """r, z, n of one step from its input-side and hidden-side gate sums."""
    r = torch.sigmoid(xg_t[..., :hidden] + hg[..., :hidden])
    z = torch.sigmoid(xg_t[..., hidden:2 * hidden] + hg[..., hidden:2 * hidden])
    n = torch.tanh(xg_t[..., 2 * hidden:] + r * hg[..., 2 * hidden:])
    return r, z, n


def gru_recurrence_reference(xg, w_hh, b_hh, h0):
    """Plain version of K3: ``(xg (T, B, 3H), w_hh, b_hh, h0) -> (y, hn)`` by
    a Python loop over time, the state carried in float32."""
    time, batch, _ = xg.shape
    hidden = w_hh.shape[0]
    h = h0.float()
    ys = []
    for t in range(time):
        hg = torch.matmul(h, w_hh.float()) + b_hh.float()
        r, z, n = _gates(xg[t].float(), hg, hidden)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    if not ys:
        return xg.new_zeros((0, batch, hidden), dtype=torch.float32), h
    return torch.stack(ys), h


def hidden_gates(w_hh, b_hh, h0, y, batch_first=False):
    """``(h_prev, hg)``: h_{t-1} for every step as rows of (T * B, H) (``y[t-1]``,
    ``h0`` at t = 0), and ``hg = h_prev @ w_hh + b_hh`` in the layout of
    ``y`` with 3H columns, by one ``torch.matmul`` over all the rows (the
    product ``pallas_gru.py:183-185`` computes outside its kernel). ``y`` is
    (T, B, H), or (B, T, H) with ``batch_first``."""
    if batch_first:
        batch, time, hidden = y.shape
        h_prev = torch.cat([h0[:, None], y], dim=1)[:, :time]
    else:
        time, batch, hidden = y.shape
        h_prev = torch.cat([h0[None], y])[:time]
    h_prev = h_prev.reshape(time * batch, hidden)
    hg = torch.matmul(h_prev, w_hh) + b_hh
    return h_prev, hg.reshape(tuple(y.shape[:2]) + (3 * hidden,))


def gru_backward_reference(xg, hg, w_hh, h0, y, dy, dhn):
    """Plain version of K4: the reverse-time loop of ``_gru_bwd_kernel``
    (``pallas_gru.py:68-91``), the gates taken from ``xg`` and the given
    ``hg`` (:func:`hidden_gates`) and ``h_{t-1}`` from ``y[t-1]`` (``h0`` at
    t = 0); the carry through ``w_hh^T`` is the one product a step. Returns
    ``(dxg, dh0)``."""
    time = xg.shape[0]
    hidden = w_hh.shape[0]
    w = w_hh.float()
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
        dh = dh * z + torch.matmul(torch.cat([da_r, da_z, da_n * r], dim=-1), w.t())
    if not dxg:
        return xg.new_zeros(xg.shape, dtype=torch.float32), dh
    return torch.stack(dxg), dh


def gru_recurrence(xg, w_hh, b_hh, h0):
    """The recurrence over a time-major (T, B, 3H) ``xg``, through padding:
    kernel K3 for CUDA tensors, on a batch-major copy (the kernel takes the
    layer's layout; ``xg`` is checked as given first), the plain version for
    CPU tensors. Returns ``(y, hn)``, y (T, B, H)."""
    if xg.device.type == 'cuda':
        _sizes('K3', xg, time_major=True)
        check_operands('K3', {'xg': (xg, tuple(xg.shape))}, xg.device)
        y, hn = _gru_fwd_cuda(xg.transpose(0, 1).contiguous(), w_hh, b_hh, h0)
        return y.transpose(0, 1).contiguous(), hn
    if xg.device.type == 'cpu':
        return gru_recurrence_reference(xg, w_hh, b_hh, h0)
    raise ValueError(f'no GRU recurrence for device {xg.device}')


def gru_backward(xg, w_hh, b_hh, h0, y, dy, dhn):
    """The backward of :func:`gru_recurrence` (time-major): ``hg`` by
    :func:`hidden_gates`, then kernel K4 for CUDA tensors, on batch-major
    copies once the operands have been checked as given, or
    :func:`gru_backward_reference` for CPU tensors. Returns ``(dxg, dh0)``."""
    if xg.device.type == 'cuda':
        _check_bwd_operands(xg, w_hh, h0, y, dy, dhn, time_major=True)
        xg, y, dy = (t.transpose(0, 1).contiguous() for t in (xg, y, dy))
        _, hg = hidden_gates(w_hh, b_hh, h0, y, batch_first=True)
        dxg, _, dh0 = _gru_bwd_cuda(xg, hg, w_hh, h0, y, dy, dhn)
        return dxg.transpose(0, 1).contiguous(), dh0
    if xg.device.type == 'cpu':
        _, hg = hidden_gates(w_hh, b_hh, h0, y)
        return gru_backward_reference(xg, hg, w_hh, h0, y, dy, dhn)
    raise ValueError(f'no GRU backward for device {xg.device}')


def _mask(y, hn, seq_len, h0):
    """(y zero past seq_len, the state at seq_len) of a (B, T, H) trace."""
    if seq_len is None:
        return y, hn
    y, seq_len = mask_past_seq_len(y, seq_len)
    return y, state_at_seq_len(y, seq_len, h0)


def layer_backward_reference(xg, hg, w_hh, h0, y, dy, dhn, seq_len=None):
    """Plain version of K4 as the layer launches it, on any device: on
    batch-major operands, the cotangents of the masking and gather (dy
    within seq_len, dhn at seq_len - 1, or at dh0 for an empty row), then
    :func:`gru_backward_reference`. Returns ``(dxg, dnr, dh0)``, ``dnr =
    da_n * r`` (B, T, H) with r from ``hg``."""
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
                                      y.transpose(0, 1), dy.transpose(0, 1), dhn)
    dxg = dxg.transpose(0, 1)
    r = torch.sigmoid(xg[..., :hidden] + hg[..., :hidden])
    return dxg, dxg[..., 2 * hidden:] * r, dh0 + empty


def _layer_forward(xg, w_hh, b_hh, h0, seq_len):
    """``(y, hn)`` of a batch-major ``xg`` (B, T, 3H): y (B, T, H) zero past
    ``seq_len``, hn the state at ``seq_len``. K3 for CUDA tensors (masking
    and gather in the kernel); for CPU tensors the plain loop, then the
    masking and gather of ``pallas_gru.py:221-225``."""
    if xg.device.type == 'cuda':
        return _gru_fwd_cuda(xg, w_hh, b_hh, h0, seq_len)
    if xg.device.type == 'cpu':
        y, hn = gru_recurrence_reference(xg.transpose(0, 1), w_hh, b_hh, h0)
        return _mask(y.transpose(0, 1), hn, seq_len, h0)
    raise ValueError(f'no GRU recurrence for device {xg.device}')


def _layer_backward(xg, hg, w_hh, h0, y, dy, dhn, seq_len):
    """``(dxg, dnr, dh0)`` of :func:`_layer_forward`, batch-major: K4 for
    CUDA tensors, :func:`layer_backward_reference` for CPU tensors."""
    if xg.device.type == 'cuda':
        return _gru_bwd_cuda(xg, hg, w_hh, h0, y, dy, dhn, seq_len)
    if xg.device.type == 'cpu':
        return layer_backward_reference(xg, hg, w_hh, h0, y, dy, dhn, seq_len)
    raise ValueError(f'no GRU backward for device {xg.device}')


class _Recurrence(torch.autograd.Function):
    """``(xg, w_hh, b_hh, h0, seq_len) -> (y, hn)``, batch-major, with K3
    forward and K4 backward (``_core_fwd``/``_core_bwd``,
    ``pallas_gru.py:139-193``, with the layer's masking and gather inside).
    Saves ``xg, w_hh, b_hh, h0`` and ``y``. Absent cotangents arrive as zeros
    (autograd materialises them)."""

    @staticmethod
    def forward(ctx, xg, w_hh, b_hh, h0, seq_len):
        y, hn = _layer_forward(xg, w_hh, b_hh, h0, seq_len)
        ctx.save_for_backward(xg, w_hh, b_hh, h0, y)
        ctx.seq_len = seq_len
        return y, hn

    @staticmethod
    def backward(ctx, dy, dhn):
        xg, w_hh, b_hh, h0, y = ctx.saved_tensors
        hidden = w_hh.shape[0]
        # One GEMM gives hg to K4. The hidden-side gate gradients that dW_hh
        # and db_hh read are [da_r, da_z, da_n * r]: dxg's r and z columns
        # (a strided view, no copy), then K4's dnr.
        h_prev, hg = hidden_gates(w_hh, b_hh, h0, y, batch_first=True)
        dxg, dnr, dh0 = _layer_backward(xg, hg, w_hh, h0, y, dy.contiguous(), dhn.contiguous(),
                                        ctx.seq_len)
        d_rz = dxg.reshape(-1, 3 * hidden)[:, :2 * hidden]
        dnr = dnr.reshape(-1, hidden)
        h_prev_t = h_prev.t()
        dw_hh = torch.cat([torch.matmul(h_prev_t, d_rz), torch.matmul(h_prev_t, dnr)], dim=1)
        return dxg, dw_hh, torch.cat([d_rz.sum(0), dnr.sum(0)]), dh0, None


def _input_gates(x, w_ih, b_ih):
    """``xg = x @ w_ih + b_ih`` (B, T, 3H): one large GEMM. (``torch.addmm``
    would save the add's launch but costs the host more than both on the
    card: cuBLASLt's bias epilogue is chosen anew at every call.)"""
    return torch.matmul(x, w_ih) + b_ih


def gru_layer(x, w_ih, w_hh, b_ih, b_hh, seq_len=None, h0=None):
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

    Returns
    -------
    y : (batch, time, H), zero past ``seq_len``
    hn : the state at ``seq_len`` (at ``time`` without ``seq_len``)
    """
    batch, dtype = x.shape[0], x.dtype
    xg = _input_gates(x, w_ih, b_ih)
    h0 = x.new_zeros((batch, w_hh.shape[0])) if h0 is None else h0.contiguous()
    if seq_len is not None:
        seq_len = torch.as_tensor(seq_len, device=x.device).reshape(batch).long().contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xg, w_hh, b_hh, h0)):
        y, hn = _Recurrence.apply(xg, w_hh, b_hh, h0, seq_len)
    else:
        y, hn = _layer_forward(xg, w_hh, b_hh, h0, seq_len)
    return y.to(dtype), hn.to(dtype)


def gru_layer_reference(x, w_ih, w_hh, b_ih, b_hh, seq_len=None, h0=None):
    """:func:`gru_layer` through the plain recurrence on any device, its
    gradient by autograd through the loop: what the kernels are held
    against."""
    batch, dtype = x.shape[0], x.dtype
    xg = _input_gates(x, w_ih, b_ih).transpose(0, 1).contiguous()    # (T, B, 3H)
    h0 = x.new_zeros((batch, w_hh.shape[0])) if h0 is None else h0
    y, hn = gru_recurrence_reference(xg, w_hh, b_hh, h0.contiguous())
    y, hn = _mask(y.transpose(0, 1).to(dtype), hn, seq_len, h0)
    return y, hn.to(dtype)
