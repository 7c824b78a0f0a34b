"""One GRU layer over a padded batch (counterpart of
``morgana_tpu/ops/pallas_gru.py`` and ``ops/rnn.py::gru``).

``xg = x @ w_ih + b_ih`` is one ``torch.matmul`` over the whole sequence, as
the JAX package leaves it to XLA. ``b_hh`` is not folded into it: it sits
inside the reset product, ``n = tanh(xg_n + r * (h @ w_hh_n + b_hh_n))``. The
recurrence then runs through padded frames over ``xg``, in torch's gate form
with the gates ordered r, z, n:

* for a CUDA tensor, in kernel K3 (``csrc/gru_fwd.cu``, one block per batch
  row with ``w_hh`` resident in shared memory), or an error: there is no
  fallback;
* for a CPU tensor, in its plain version, :func:`gru_recurrence_reference`
  (a Python loop over time with ``torch.matmul``).

When a gradient is needed, the recurrence is a :class:`torch.autograd.Function`
(the counterpart of ``_gru_layer_core``'s ``custom_vjp``): the forward runs
K3 and the backward runs kernel K4 (``csrc/gru_bwd.cu``), which recomputes
the gates from the saved ``xg`` and the unmasked ``y`` (there is no gate
trace), or their plain versions for CPU tensors. ``dW_hh`` and ``db_hh`` come
from one ``torch.matmul`` and one sum over the (T * B) rows.

Outputs past ``seq_len`` are zeroed and the final ``h`` is gathered from the
masked ``y`` at ``seq_len - 1`` (``h0`` for empty rows): for a GRU, ``y`` is
the state trace (``pallas_gru.py:221-225``).
"""
import ctypes

import torch

from morgana_tpu_torch.ops._kernels import (check_operands, load_library,
                                            mask_past_seq_len, raise_on_error,
                                            state_at_seq_len)

__all__ = ['gru_layer', 'gru_layer_reference', 'gru_recurrence', 'gru_recurrence_reference',
           'gru_backward', 'gru_backward_reference', 'launches', 'bwd_launches']

# Launches of K3 and of K4, each counted where its wrapper launches the
# kernel and nowhere else; a run reads them to show which path it took.
launches = 0
bwd_launches = 0

# One block's shared memory on an H100 (227 KB, opt-in): K3 and K4 keep w_hh
# there with a row stride of 3H + 1, beside 4H floats of state.
_MAX_SMEM_BYTES = 232448
_MAX_HIDDEN = 128  # one thread per hidden unit


def _smem_bytes(hidden):
    return 4 * (hidden * (3 * hidden + 1) + 4 * hidden)


def _check_sizes(kernel, batch, hidden):
    """Raises ``ValueError``, before any launch, on a B or H that K3 and K4
    do not take: B >= 1, H a multiple of 32 up to 128 (one thread per unit),
    and w_hh with its row padding in one block's shared memory."""
    if batch < 1:
        raise ValueError(f'{kernel}: the GRU kernels take B >= 1, got B={batch}')
    if hidden < 32 or hidden % 32 or hidden > _MAX_HIDDEN:
        raise ValueError(f'{kernel}: the GRU kernels take H a multiple of 32 up to {_MAX_HIDDEN} '
                         f'(one thread per unit), got H={hidden}')
    if _smem_bytes(hidden) > _MAX_SMEM_BYTES:
        raise ValueError(f'{kernel}: w_hh at H={hidden} needs {_smem_bytes(hidden)} bytes of '
                         f'shared memory, over the {_MAX_SMEM_BYTES} of one block')


def _sizes(kernel, xg):
    """``(T, B, H)`` of a (T, B, 3H) ``xg``."""
    if xg.ndim != 3 or xg.shape[2] % 3:
        raise ValueError(f'{kernel}: xg must be (T, B, 3H), got {tuple(xg.shape)}')
    time, batch, gates3 = xg.shape
    return time, batch, gates3 // 3


def _gru_fwd_cuda(xg, w_hh, b_hh, h0):
    """Launches K3 on PyTorch's current stream; raises on anything it does not
    take, and on a refused or failed launch. Returns ``(y, hn)``."""
    global launches
    time, batch, hidden = _sizes('K3', xg)
    check_operands('K3', {'xg': (xg, tuple(xg.shape)), 'w_hh': (w_hh, (hidden, 3 * hidden)),
                          'b_hh': (b_hh, (3 * hidden,)), 'h0': (h0, (batch, hidden))}, xg.device)
    _check_sizes('K3', batch, hidden)

    lib, fn = load_library('gru_fwd', 'morgana_gru_fwd',
                           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    y = torch.empty((time, batch, hidden), dtype=torch.float32, device=xg.device)
    hn = torch.empty((batch, hidden), dtype=torch.float32, device=xg.device)
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        err = fn(xg.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(), y.data_ptr(),
                 hn.data_ptr(), time, batch, hidden, xg.device.index, stream)
    raise_on_error(lib, err, f'GRU kernel K3 launch at T={time} B={batch} H={hidden}',
                   'the kernel keeps w_hh (H x (3H + 1) floats) in one block\'s shared memory')
    launches += 1
    return y, hn


def _gru_bwd_cuda(xg, w_hh, b_hh, h0, y, dy, dhn):
    """Launches K4 on PyTorch's current stream; raises on anything it does not
    take, and on a refused or failed launch. Returns ``(dxg, dh0)``."""
    global bwd_launches
    time, batch, hidden = _sizes('K4', xg)
    trace, state = (time, batch, hidden), (batch, hidden)
    check_operands('K4', {'xg': (xg, tuple(xg.shape)), 'w_hh': (w_hh, (hidden, 3 * hidden)),
                          'b_hh': (b_hh, (3 * hidden,)), 'h0': (h0, state), 'y': (y, trace),
                          'dy': (dy, trace), 'dhn': (dhn, state)}, xg.device)
    _check_sizes('K4', batch, hidden)

    lib, fn = load_library('gru_bwd', 'morgana_gru_bwd',
                           [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    dxg = torch.empty_like(xg)
    dh0 = torch.empty(state, dtype=torch.float32, device=xg.device)
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        err = fn(xg.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(), y.data_ptr(),
                 dy.data_ptr(), dhn.data_ptr(), dxg.data_ptr(), dh0.data_ptr(), time, batch,
                 hidden, xg.device.index, stream)
    raise_on_error(lib, err, f'GRU kernel K4 launch at T={time} B={batch} H={hidden}',
                   'the kernel keeps w_hh (H x (3H + 1) floats) in one block\'s shared memory')
    bwd_launches += 1
    return dxg, dh0


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


def gru_backward_reference(xg, w_hh, b_hh, h0, y, dy, dhn):
    """Plain version of K4: the reverse-time loop of ``_gru_bwd_kernel``
    (``pallas_gru.py:68-91``), recomputing the gates from ``xg`` and
    ``h_{t-1}`` (``y[t-1]``, ``h0`` at t = 0). Returns ``(dxg, dh0)``."""
    time = xg.shape[0]
    hidden = w_hh.shape[0]
    w = w_hh.float()
    dh = dhn.float()
    dxg = [None] * time
    for t in range(time - 1, -1, -1):
        h_prev = (y[t - 1] if t > 0 else h0).float()
        hg = torch.matmul(h_prev, w) + b_hh.float()
        r, z, n = _gates(xg[t].float(), hg, hidden)
        dh = dy[t].float() + dh
        da_n = dh * (1.0 - z) * (1.0 - n * n)
        da_z = dh * (h_prev - n) * z * (1.0 - z)
        da_r = da_n * hg[..., 2 * hidden:] * r * (1.0 - r)
        dxg[t] = torch.cat([da_r, da_z, da_n], dim=-1)
        dh = dh * z + torch.matmul(torch.cat([da_r, da_z, da_n * r], dim=-1), w.t())
    if not dxg:
        return xg.new_zeros(xg.shape, dtype=torch.float32), dh
    return torch.stack(dxg), dh


def gru_recurrence(xg, w_hh, b_hh, h0):
    """The recurrence over ``xg``: kernel K3 for CUDA tensors, the plain
    version for CPU tensors. Returns ``(y, hn)``."""
    if xg.device.type == 'cuda':
        return _gru_fwd_cuda(xg, w_hh, b_hh, h0)
    if xg.device.type == 'cpu':
        return gru_recurrence_reference(xg, w_hh, b_hh, h0)
    raise ValueError(f'no GRU recurrence for device {xg.device}')


def gru_backward(xg, w_hh, b_hh, h0, y, dy, dhn):
    """The backward of the recurrence: kernel K4 for CUDA tensors, the plain
    version for CPU tensors. Returns ``(dxg, dh0)``."""
    args = (xg, w_hh, b_hh, h0, y, dy, dhn)
    if xg.device.type == 'cuda':
        return _gru_bwd_cuda(*args)
    if xg.device.type == 'cpu':
        return gru_backward_reference(*args)
    raise ValueError(f'no GRU backward for device {xg.device}')


class _Recurrence(torch.autograd.Function):
    """``(xg, w_hh, b_hh, h0) -> (y, hn)`` with K3 forward and K4 backward
    (``_core_fwd``/``_core_bwd``, ``pallas_gru.py:139-193``). Saves ``xg,
    w_hh, b_hh, h0`` and the unmasked ``y``, the JAX residuals. Absent
    cotangents arrive as zeros (autograd materialises them)."""

    @staticmethod
    def forward(ctx, xg, w_hh, b_hh, h0):
        y, hn = gru_recurrence(xg, w_hh, b_hh, h0)
        ctx.save_for_backward(xg, w_hh, b_hh, h0, y)
        return y, hn

    @staticmethod
    def backward(ctx, dy, dhn):
        xg, w_hh, b_hh, h0, y = ctx.saved_tensors
        time, batch, hidden = y.shape
        dxg, dh0 = gru_backward(xg, w_hh, b_hh, h0, y, dy.contiguous(), dhn.contiguous())
        # The hidden-side gate gradients differ from dxg only in the n
        # column, rescaled by r: recompute r over the flattened (T * B) rows,
        # with h_{t-1} from the unmasked y (h0 at t = 0).
        h_prev = torch.cat([h0[None], y])[:time].reshape(time * batch, hidden)
        xg_flat = xg.reshape(time * batch, 3 * hidden)
        dxg_flat = dxg.reshape(time * batch, 3 * hidden)
        hg_r = torch.matmul(h_prev, w_hh[:, :hidden]) + b_hh[:hidden]
        r = torch.sigmoid(xg_flat[:, :hidden] + hg_r)
        dhg = torch.cat([dxg_flat[:, :2 * hidden], dxg_flat[:, 2 * hidden:] * r], dim=-1)
        dw_hh = torch.matmul(h_prev.t(), dhg)
        db_hh = dhg.sum(0)
        return dxg, dw_hh, db_hh, dh0


def _recurrence(xg, w_hh, b_hh, h0):
    """The autograd Function when a gradient is needed (K3, then K4), else
    the recurrence alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xg, w_hh, b_hh, h0)):
        return _Recurrence.apply(xg, w_hh, b_hh, h0)
    return gru_recurrence(xg, w_hh, b_hh, h0)


def _layer(recurrence, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0):
    batch = x.shape[0]
    hidden = w_hh.shape[0]
    dtype = x.dtype

    xg = torch.matmul(x, w_ih) + b_ih                    # one large matmul
    xg = xg.transpose(0, 1).contiguous()                 # (T, B, 3H)
    h0 = x.new_zeros((batch, hidden)) if h0 is None else h0

    y, hn = recurrence(xg, w_hh, b_hh, h0.contiguous())
    y = y.transpose(0, 1).to(dtype)                      # (B, T, H)
    if seq_len is not None:
        y, seq_len = mask_past_seq_len(y, seq_len)
        # Position seq_len - 1 is valid, so gathering from the masked y is exact.
        hn = state_at_seq_len(y, seq_len, h0)
    return y, hn.to(dtype)


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
    return _layer(_recurrence, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0)


def gru_layer_reference(x, w_ih, w_hh, b_ih, b_hh, seq_len=None, h0=None):
    """:func:`gru_layer` through the plain recurrence on any device, its
    gradient by autograd through the loop: what the kernels are held
    against."""
    return _layer(gru_recurrence_reference, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0)
