"""One LSTM layer over a padded batch (counterpart of
``morgana_tpu/ops/pallas_rnn.py``).

``xg = x @ w_ih + (b_ih + b_hh)`` is one ``torch.matmul`` over the whole
sequence, as the JAX package leaves it to XLA. The recurrence then runs
through padded frames over ``xg``:

* for a CUDA tensor, in kernel K1 (``csrc/lstm_fwd.cu``, one persistent
  cooperative launch per layer), or an error: there is no fallback;
* for a CPU tensor, in its plain version, :func:`lstm_recurrence_reference`
  (a Python loop over time with ``torch.matmul``).

When a gradient is needed, the recurrence is a :class:`torch.autograd.Function`
(the counterpart of ``_lstm_layer_core``'s ``custom_vjp``): the forward runs
K1 with its gate trace ``g_all`` and the backward runs kernel K2
(``csrc/lstm_bwd.cu``) over the saved gates, or their plain versions for CPU
tensors. ``dW_hh = h_prev^T @ dxg`` is one ``torch.matmul`` over (T * B).
Without a gradient (serving, ``torch.inference_mode``) K1 writes no gates.

Outputs past ``seq_len`` are zeroed and the final ``(h, c)`` is gathered at
``seq_len - 1`` (``h0``/``c0`` for empty rows), which is exactly the state a
recurrence stopped at ``seq_len`` would hold (``pallas_rnn.py:298-347``).
"""
import ctypes

import torch

from morgana_tpu_torch.ops._kernels import (check_operands, load_library,
                                            mask_past_seq_len, raise_on_error,
                                            state_at_seq_len)

__all__ = ['lstm_layer', 'lstm_layer_reference', 'lstm_recurrence',
           'lstm_recurrence_reference', 'lstm_backward', 'lstm_backward_reference',
           'launches', 'gate_launches', 'bwd_launches']

# Launches of K1 (all, and those that wrote the gate trace) and of K2, each
# counted where its wrapper launches the kernel and nowhere else; a run reads
# them to show which path it took.
launches = 0
gate_launches = 0
bwd_launches = 0

_MAX_BATCH = 256  # one 32-row slice per warp of the kernels' 256 threads


def _check_sizes(kernel, batch, hidden):
    if not 1 <= batch <= _MAX_BATCH:
        raise ValueError(f'{kernel}: the LSTM kernels take 1 <= B <= {_MAX_BATCH}, got B={batch}')
    if hidden < 4 or hidden % 4:
        raise ValueError(f'{kernel}: the LSTM kernels take H a multiple of 4, got H={hidden}')


def _lstm_fwd_cuda(xg, w_hh, h0, c0, with_gates=False):
    """Launches K1 on PyTorch's current stream; raises on anything it does not
    take, and on a refused or failed launch. Returns ``(y, c_all, g_all, hn,
    cn)``, ``g_all`` None unless ``with_gates``."""
    global launches, gate_launches
    if xg.ndim != 3 or xg.shape[2] % 4:
        raise ValueError(f'K1: xg must be (T, B, 4H), got {tuple(xg.shape)}')
    time, batch, gates4 = xg.shape
    hidden = gates4 // 4
    check_operands('K1', {'xg': (xg, (time, batch, gates4)), 'w_hh': (w_hh, (hidden, gates4)),
                          'h0': (h0, (batch, hidden)), 'c0': (c0, (batch, hidden))}, xg.device)
    _check_sizes('K1', batch, hidden)
    if h0.data_ptr() % 16:
        h0 = h0.clone()  # read as float4: a fresh allocation is 16-byte aligned

    lib, fn = load_library('lstm_fwd', 'morgana_lstm_fwd',
                           [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    y = torch.empty((time, batch, hidden), dtype=torch.float32, device=xg.device)
    c_all = torch.empty_like(y)
    g_all = torch.empty_like(xg) if with_gates else None
    hn = torch.empty((batch, hidden), dtype=torch.float32, device=xg.device)
    cn = torch.empty_like(hn)
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        err = fn(xg.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                 y.data_ptr(), c_all.data_ptr(), None if g_all is None else g_all.data_ptr(),
                 hn.data_ptr(), cn.data_ptr(), time, batch, hidden, xg.device.index, stream)
    raise_on_error(lib, err, f'LSTM kernel K1 launch at T={time} B={batch} H={hidden}',
                   'the kernel keeps a (B, H + 4) copy of h in shared memory, which bounds B '
                   'for a given H')
    launches += 1
    if with_gates:
        gate_launches += 1
    return y, c_all, g_all, hn, cn


def _lstm_bwd_cuda(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn):
    """Launches K2 on PyTorch's current stream; raises on anything it does not
    take, and on a refused or failed launch. Returns ``(dxg, dh0, dc0)``."""
    global bwd_launches
    if g_all.ndim != 3 or g_all.shape[2] % 4:
        raise ValueError(f'K2: g_all must be (T, B, 4H), got {tuple(g_all.shape)}')
    time, batch, gates4 = g_all.shape
    hidden = gates4 // 4
    trace, state = (time, batch, hidden), (batch, hidden)
    check_operands('K2', {'g_all': (g_all, (time, batch, gates4)), 'w_hh': (w_hh, (hidden, gates4)),
                          'c0': (c0, state), 'c_all': (c_all, trace), 'dy': (dy, trace),
                          'dc_all': (dc_all, trace), 'dhn': (dhn, state), 'dcn': (dcn, state)},
                   g_all.device)
    _check_sizes('K2', batch, hidden)

    lib, fn = load_library('lstm_bwd', 'morgana_lstm_bwd',
                           [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    dxg = torch.empty_like(g_all)
    dh0 = torch.empty(state, dtype=torch.float32, device=g_all.device)
    dc0 = torch.empty_like(dh0)
    with torch.cuda.device(g_all.device):
        stream = torch.cuda.current_stream(g_all.device).cuda_stream
        err = fn(g_all.data_ptr(), w_hh.data_ptr(), c0.data_ptr(), c_all.data_ptr(),
                 dy.data_ptr(), dc_all.data_ptr(), dhn.data_ptr(), dcn.data_ptr(),
                 dxg.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), time, batch, hidden,
                 g_all.device.index, stream)
    raise_on_error(lib, err, f'LSTM kernel K2 launch at T={time} B={batch} H={hidden}',
                   'the kernel keeps 4H x U of w_hh and a (B, tile) slice of dxg in shared '
                   'memory, and one block per SM must fit')
    bwd_launches += 1
    return dxg, dh0, dc0


def lstm_recurrence_reference(xg, w_hh, h0, c0):
    """Plain version of K1: ``(xg (T, B, 4H), w_hh, h0, c0) -> (y, c_all,
    g_all, hn, cn)`` by a Python loop over time, state carried in float32;
    ``g_all`` holds the activated gates i, f, g, o of every step."""
    time, batch, _ = xg.shape
    hidden = w_hh.shape[0]
    h, c = h0.float(), c0.float()
    ys, cs, gs = [], [], []
    for t in range(time):
        gates = xg[t].float() + torch.matmul(h, w_hh.float())
        i, f, g, o = gates.split(hidden, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        cs.append(c)
        gs.append(torch.cat([i, f, g, o], dim=-1))
    if not ys:
        empty = xg.new_zeros((0, batch, hidden), dtype=torch.float32)
        return empty, empty.clone(), xg.new_zeros((0, batch, 4 * hidden)), h, c
    return torch.stack(ys), torch.stack(cs), torch.stack(gs), h, c


def lstm_backward_reference(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn):
    """Plain version of K2: the reverse-time loop of ``_lstm_bwd_kernel``
    (``pallas_rnn.py:127-158``) over the saved gates. Returns ``(dxg, dh0,
    dc0)``."""
    time = g_all.shape[0]
    hidden = w_hh.shape[0]
    dh, dc_carry = dhn.float(), dcn.float()
    dxg = [None] * time
    for t in range(time - 1, -1, -1):
        i, f, g, o = g_all[t].float().split(hidden, dim=-1)
        c_prev = c_all[t - 1] if t > 0 else c0
        tanh_c = torch.tanh(c_all[t].float())
        dh_total = dy[t].float() + dh
        d_o = dh_total * tanh_c
        dc = dh_total * o * (1.0 - tanh_c * tanh_c) + dc_carry + dc_all[t].float()
        dgates = torch.cat([dc * g * i * (1.0 - i), dc * c_prev.float() * f * (1.0 - f),
                            dc * i * (1.0 - g * g), d_o * o * (1.0 - o)], dim=-1)
        dxg[t] = dgates
        dh = torch.matmul(dgates, w_hh.float().t())
        dc_carry = dc * f
    if not dxg:
        return g_all.new_zeros(g_all.shape, dtype=torch.float32), dh, dc_carry
    return torch.stack(dxg), dh, dc_carry


def lstm_recurrence(xg, w_hh, h0, c0, with_gates=False):
    """The recurrence over ``xg``: kernel K1 for CUDA tensors, the plain
    version for CPU tensors. Returns ``(y, c_all, g_all, hn, cn)``; ``g_all``
    is None unless ``with_gates``."""
    if xg.device.type == 'cuda':
        return _lstm_fwd_cuda(xg, w_hh, h0, c0, with_gates)
    if xg.device.type == 'cpu':
        y, c_all, g_all, hn, cn = lstm_recurrence_reference(xg, w_hh, h0, c0)
        return y, c_all, g_all if with_gates else None, hn, cn
    raise ValueError(f'no LSTM recurrence for device {xg.device}')


def lstm_backward(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn):
    """The backward of the recurrence: kernel K2 for CUDA tensors, the plain
    version for CPU tensors. Returns ``(dxg, dh0, dc0)``."""
    args = (g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn)
    if g_all.device.type == 'cuda':
        return _lstm_bwd_cuda(*args)
    if g_all.device.type == 'cpu':
        return lstm_backward_reference(*args)
    raise ValueError(f'no LSTM backward for device {g_all.device}')


class _Recurrence(torch.autograd.Function):
    """``(xg, w_hh, h0, c0) -> (y, c_all, hn, cn)`` with K1 (gate trace on)
    forward and K2 backward (``_core_fwd``/``_core_bwd``, ``pallas_rnn.py:226``).
    Saves ``w_hh, h0, c0``, the unmasked ``y``, ``c_all`` and ``g_all``; not
    ``xg``. Absent cotangents arrive as zeros (autograd materialises them)."""

    @staticmethod
    def forward(ctx, xg, w_hh, h0, c0):
        y, c_all, g_all, hn, cn = lstm_recurrence(xg, w_hh, h0, c0, with_gates=True)
        ctx.save_for_backward(w_hh, h0, c0, y, c_all, g_all)
        return y, c_all, hn, cn

    @staticmethod
    def backward(ctx, dy, dc_all, dhn, dcn):
        w_hh, h0, c0, y, c_all, g_all = ctx.saved_tensors
        time, batch, hidden = y.shape
        dxg, dh0, dc0 = lstm_backward(g_all, w_hh, c0, c_all, dy.contiguous(),
                                      dc_all.contiguous(), dhn.contiguous(), dcn.contiguous())
        # dW_hh = sum_t h_{t-1}^T dxg_t over the flattened (T * B) rows, with
        # h_{t-1} from the kernel's unmasked y (h0 at t = 0).
        h_prev = torch.cat([h0[None], y])[:time]
        dw_hh = torch.matmul(h_prev.reshape(time * batch, hidden).t(),
                             dxg.reshape(time * batch, 4 * hidden))
        return dxg, dw_hh, dh0, dc0


def _recurrence(xg, w_hh, h0, c0):
    """The autograd Function when a gradient is needed (the gate-writing K1
    and K2), else the recurrence alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xg, w_hh, h0, c0)):
        return _Recurrence.apply(xg, w_hh, h0, c0)
    y, c_all, _, hn, cn = lstm_recurrence(xg, w_hh, h0, c0)
    return y, c_all, hn, cn


def _plain_recurrence(xg, w_hh, h0, c0):
    y, c_all, _, hn, cn = lstm_recurrence_reference(xg, w_hh, h0, c0)
    return y, c_all, hn, cn


def _layer(recurrence, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0):
    batch = x.shape[0]
    hidden = w_hh.shape[0]
    dtype = x.dtype

    xg = torch.matmul(x, w_ih) + (b_ih + b_hh)          # one large matmul
    xg = xg.transpose(0, 1).contiguous()                 # (T, B, 4H)
    h0 = x.new_zeros((batch, hidden)) if h0 is None else h0
    c0 = x.new_zeros((batch, hidden)) if c0 is None else c0

    y, c_all, hn, cn = recurrence(xg, w_hh, h0.contiguous(), c0.contiguous())
    y = y.transpose(0, 1).to(dtype)                      # (B, T, H)
    if seq_len is not None:
        y, seq_len = mask_past_seq_len(y, seq_len)
        # Position seq_len - 1 is valid, so gathering from the masked y is exact.
        hn = state_at_seq_len(y, seq_len, h0)
        cn = state_at_seq_len(c_all.transpose(0, 1).to(dtype), seq_len, c0)
    return y, (hn.to(dtype), cn.to(dtype))


def lstm_layer(x, w_ih, w_hh, b_ih, b_hh, seq_len=None, h0=None, c0=None):
    r"""Single-layer LSTM over a padded batch, with the semantics of
    ``morgana_tpu.ops.pallas_rnn.lstm_layer``, differentiable in all seven
    inputs.

    Parameters
    ----------
    x : torch.Tensor, shape (batch, time, in_dim)
    w_ih : (in_dim, 4H); w_hh : (H, 4H); b_ih, b_hh : (4H,)
        Gate order i, f, g, o (torch's), weights stored (in, gates).
    seq_len : (batch,), optional
    h0, c0 : (batch, H), optional; zeros when absent.

    Returns
    -------
    y : (batch, time, H), zero past ``seq_len``
    (hn, cn) : the state at ``seq_len`` (at ``time`` without ``seq_len``)
    """
    return _layer(_recurrence, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0)


def lstm_layer_reference(x, w_ih, w_hh, b_ih, b_hh, seq_len=None, h0=None, c0=None):
    """:func:`lstm_layer` through the plain recurrence on any device, its
    gradient by autograd through the loop: what the kernels are held
    against."""
    return _layer(_plain_recurrence, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0)
