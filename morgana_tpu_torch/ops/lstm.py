"""One LSTM layer over a padded batch (counterpart of
``morgana_tpu/ops/pallas_rnn.py``).

``xg = x @ w_ih + (b_ih + b_hh)`` is one ``torch.matmul`` over the whole
sequence, as the JAX package leaves it to XLA. The recurrence then runs
through padded frames over ``xg``:

* for a CUDA tensor, in kernel K1 (``csrc/lstm_fwd.cu``, one persistent
  cooperative launch per layer), or an error: there is no fallback;
* for a CPU tensor, in its plain version, :func:`lstm_recurrence_reference`
  (a Python loop over time with ``torch.matmul``).

Outputs past ``seq_len`` are zeroed and the final ``(h, c)`` is gathered at
``seq_len - 1`` (``h0``/``c0`` for empty rows), which is exactly the state a
recurrence stopped at ``seq_len`` would hold (``pallas_rnn.py:298-347``).
"""
import ctypes

import torch

from morgana_tpu_torch import _build

__all__ = ['lstm_layer', 'lstm_layer_reference', 'lstm_recurrence',
           'lstm_recurrence_reference', 'launches']

# Launches of kernel K1, counted where the wrapper launches it and nowhere
# else; a run reads it to show which path it took.
launches = 0

_MAX_BATCH = 256  # one 32-row slice per warp of the kernel's 256 threads


def _lstm_fwd_cuda(xg, w_hh, h0, c0):
    """Launches K1 on PyTorch's current stream; raises on anything it does not
    take, and on a refused or failed launch."""
    global launches
    if xg.ndim != 3 or xg.shape[2] % 4:
        raise ValueError(f'xg must be (T, B, 4H), got {tuple(xg.shape)}')
    time, batch, gates4 = xg.shape
    hidden = gates4 // 4
    expected = {'xg': (xg, (time, batch, gates4)), 'w_hh': (w_hh, (hidden, gates4)),
                'h0': (h0, (batch, hidden)), 'c0': (c0, (batch, hidden))}
    for name, (tensor, shape) in expected.items():
        if tuple(tensor.shape) != shape:
            raise ValueError(f'{name} must be {shape}, got {tuple(tensor.shape)}')
        if tensor.device != xg.device:
            raise ValueError(f'{name} is on {tensor.device}, xg on {xg.device}')
        if tensor.dtype != torch.float32:
            raise TypeError(f'the LSTM kernel takes float32, {name} is {tensor.dtype}')
        if not tensor.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if not 1 <= batch <= _MAX_BATCH:
        raise ValueError(f'the LSTM kernel takes 1 <= B <= {_MAX_BATCH}, got B={batch}')
    if hidden % 4:
        raise ValueError(f'the LSTM kernel takes H a multiple of 4, got H={hidden}')
    if h0.data_ptr() % 16:
        h0 = h0.clone()  # read as float4: a fresh allocation is 16-byte aligned

    lib = _build.load('lstm_fwd')
    lib.morgana_lstm_fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.morgana_lstm_fwd.restype = ctypes.c_int
    lib.morgana_cuda_error_string.argtypes = [ctypes.c_int]
    lib.morgana_cuda_error_string.restype = ctypes.c_char_p

    y = torch.empty((time, batch, hidden), dtype=torch.float32, device=xg.device)
    c_all = torch.empty_like(y)
    hn = torch.empty((batch, hidden), dtype=torch.float32, device=xg.device)
    cn = torch.empty_like(hn)
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream(xg.device).cuda_stream
        err = lib.morgana_lstm_fwd(
            xg.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            y.data_ptr(), c_all.data_ptr(), hn.data_ptr(), cn.data_ptr(),
            time, batch, hidden, xg.device.index, stream)
    if err != 0:
        raise RuntimeError(
            f'LSTM kernel launch failed at T={time} B={batch} H={hidden}: '
            f'{lib.morgana_cuda_error_string(err).decode()} (cudaError {err}); the kernel '
            'keeps a (B, H + 4) copy of h in shared memory, which bounds B for a given H')
    launches += 1
    return y, c_all, hn, cn


def lstm_recurrence_reference(xg, w_hh, h0, c0):
    """Plain version of K1: ``(xg (T, B, 4H), w_hh, h0, c0) -> (y, c_all, hn,
    cn)`` by a Python loop over time, state carried in float32."""
    time, batch, _ = xg.shape
    hidden = w_hh.shape[0]
    h, c = h0.float(), c0.float()
    ys, cs = [], []
    for t in range(time):
        gates = xg[t].float() + torch.matmul(h, w_hh.float())
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
        cs.append(c)
    if not ys:
        empty = xg.new_zeros((0, batch, hidden), dtype=torch.float32)
        return empty, empty.clone(), h, c
    return torch.stack(ys), torch.stack(cs), h, c


def lstm_recurrence(xg, w_hh, h0, c0):
    """The recurrence over ``xg``: kernel K1 for CUDA tensors, the plain
    version for CPU tensors."""
    if xg.device.type == 'cuda':
        return _lstm_fwd_cuda(xg, w_hh, h0, c0)
    if xg.device.type == 'cpu':
        return lstm_recurrence_reference(xg, w_hh, h0, c0)
    raise ValueError(f'no LSTM recurrence for device {xg.device}')


def _state_at_seq_len(trace, seq_len, state0):
    """Each row's state at ``seq_len - 1`` of a (B, T, H) trace, ``state0``
    for empty rows (``pallas_rnn.py:298``)."""
    batch, time, hidden = trace.shape
    idx = (seq_len - 1).clamp(0, time - 1).long()
    picked = torch.gather(trace, 1, idx[:, None, None].expand(batch, 1, hidden))[:, 0]
    return torch.where((seq_len > 0)[:, None], picked, state0)


def _layer(recurrence, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0):
    batch, time, _ = x.shape
    hidden = w_hh.shape[0]
    dtype = x.dtype

    xg = torch.matmul(x, w_ih) + (b_ih + b_hh)          # one large matmul
    xg = xg.transpose(0, 1).contiguous()                 # (T, B, 4H)
    h0 = x.new_zeros((batch, hidden)) if h0 is None else h0
    c0 = x.new_zeros((batch, hidden)) if c0 is None else c0

    y, c_all, hn, cn = recurrence(xg, w_hh, h0.contiguous(), c0.contiguous())
    y = y.transpose(0, 1).to(dtype)                      # (B, T, H)
    if seq_len is not None:
        seq_len = torch.as_tensor(seq_len, device=x.device).reshape(batch)
        mask = torch.arange(time, device=x.device)[None, :] < seq_len[:, None]
        y = y * mask[:, :, None].to(dtype)
        # Position seq_len - 1 is valid, so gathering from the masked y is exact.
        hn = _state_at_seq_len(y, seq_len, h0)
        cn = _state_at_seq_len(c_all.transpose(0, 1).to(dtype), seq_len, c0)
    return y, (hn.to(dtype), cn.to(dtype))


def lstm_layer(x, w_ih, w_hh, b_ih, b_hh, seq_len=None, h0=None, c0=None):
    r"""Single-layer LSTM over a padded batch, with the semantics of
    ``morgana_tpu.ops.pallas_rnn.lstm_layer``.

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
    return _layer(lstm_recurrence, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0)


def lstm_layer_reference(x, w_ih, w_hh, b_ih, b_hh, seq_len=None, h0=None, c0=None):
    """:func:`lstm_layer` through the plain recurrence on any device: what
    the kernel is held against."""
    return _layer(lstm_recurrence_reference, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0)
