"""One LSTM layer over a padded batch (counterpart of
``morgana_tpu/ops/pallas_rnn.py``).

``xg = x @ w_ih + (b_ih + b_hh)`` is one ``torch.matmul`` over the whole
sequence, as the JAX package leaves it to XLA. The recurrence then runs
through padded frames over ``xg``:

* for a CUDA tensor, in kernel K1 (``csrc/lstm_fwd.cu``, one persistent
  cooperative launch per layer), or an error: there is no fallback. The
  kernels are built for H = 64, 128, 256, 512 and 1024; a layer of another
  width up to 1024 runs padded with zero units to the next of them, which
  is exact: a zero unit's gates see xg = 0 and zero columns of w_hh, so its
  c and h stay 0, and its zero row of w_hh feeds no other unit (in the
  backward likewise, its dxg is 0);
* for a CPU tensor, in its plain version, :func:`lstm_recurrence_reference`
  (a Python loop over time with ``torch.matmul``).

When a gradient is needed, the recurrence is a :class:`torch.autograd.Function`
(the counterpart of ``_lstm_layer_core``'s ``custom_vjp``): the forward runs
K1 with its gate trace ``g_all`` and the backward runs kernel K2
(``csrc/lstm_bwd.cu``) over the saved gates, or their plain versions for CPU
tensors. ``dW_hh = h_prev^T @ dxg`` is one ``torch.matmul`` over (T * B).
Without a gradient (serving, ``torch.inference_mode``) K1 writes no gates.

Storage type (``pallas_rnn.py::_store_dtype``, "K1s"): with ``store_dtype``
``'bfloat16'`` the layer stores xg, w_hh, the y, c and gate traces, the
backward's dy, dc_all and dxg in bf16 and rounds h before ``h @ w_hh`` and
the gate gradients before ``dgates @ w_hh^T``, exactly where the Pallas
kernels do; the carried h and c, every product's sums and the returned
cotangents stay f32, and dh0 and dc0 pass through bf16. ``nn.Recurrent``
passes :data:`STORE_DTYPE` (``MORGANA_PALLAS_STORE``, read at import, read
again at each call) for its ``'pallas'`` backend only, as the JAX package's
scan path never reads it.

Outputs past ``seq_len`` are zeroed and the final ``(h, c)`` is gathered at
``seq_len - 1`` (``h0``/``c0`` for empty rows), which is exactly the state a
recurrence stopped at ``seq_len`` would hold (``pallas_rnn.py:298-347``).
"""
import ctypes
import os

import torch

from morgana_tpu_torch.ops._kernels import (check_operands, load_library,
                                            mask_past_seq_len, raise_on_error,
                                            state_at_seq_len)

__all__ = ['lstm_layer', 'lstm_layer_reference', 'lstm_recurrence',
           'lstm_recurrence_reference', 'lstm_backward', 'lstm_backward_reference',
           'STORE_DTYPE', 'launches', 'gate_launches', 'bwd_launches',
           'bf16_launches', 'bf16_bwd_launches']

# The storage type of the 'pallas' backend's LSTM layers, e.g. 'bfloat16'
# (pallas_rnn.py:59); None is the input's type, f32.
STORE_DTYPE = os.environ.get('MORGANA_PALLAS_STORE', None)

# Launches of K1 (all, and those that wrote the gate trace) and of K2, each
# counted where its wrapper launches the kernel and nowhere else; a run reads
# them to show which path it took. The bf16_ counts are those of the kernels
# built for bf16 storage, among the others.
launches = 0
gate_launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0

_MAX_BATCH = 256
_WIDTHS = (64, 128, 256, 512, 1024)  # the widths the kernels are built for
_STORES = {None: torch.float32, 'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _store(store_dtype):
    """The torch dtype of a ``store_dtype`` name."""
    if store_dtype not in _STORES:
        raise ValueError(f'LSTM storage type {store_dtype!r}: the port has '
                         f'{sorted(k for k in _STORES if k)}')
    return _STORES[store_dtype]


def _width(kernel, batch, hidden):
    """The built width a layer of ``hidden`` units runs at; raises on a B or
    H the kernels do not take."""
    if not 1 <= batch <= _MAX_BATCH:
        raise ValueError(f'{kernel}: the LSTM kernels take 1 <= B <= {_MAX_BATCH}, got B={batch}')
    for width in _WIDTHS:
        if hidden <= width:
            return width
    raise ValueError(f'{kernel}: the LSTM kernels take H up to {_WIDTHS[-1]}, got H={hidden}')


def _pad_units(t, width, gates=1):
    """``t`` (..., gates * H) with each gate's H units followed by zero units
    up to ``width``."""
    hidden = t.shape[-1] // gates
    if hidden == width:
        return t
    t = t.reshape(*t.shape[:-1], gates, hidden)
    return torch.nn.functional.pad(t, (0, width - hidden)).reshape(*t.shape[:-2], gates * width)


def _unpad_units(t, hidden, gates=1):
    """The first ``hidden`` units of each gate of ``t`` (..., gates * width)."""
    width = t.shape[-1] // gates
    if hidden == width:
        return t
    t = t.reshape(*t.shape[:-1], gates, width)[..., :hidden]
    return t.reshape(*t.shape[:-2], gates * hidden).contiguous()


def _pad_w_hh(w_hh, width):
    """w_hh (H, 4H) as (width, 4 width): zero rows and zero units."""
    hidden = w_hh.shape[0]
    w = _pad_units(w_hh, width, 4)
    return w if hidden == width else torch.nn.functional.pad(w, (0, 0, 0, width - hidden))


def _entry(kernel, split):
    """``(variant, entry, extra argtypes, extra args)`` of a launch: the main
    path's library, or with ``split`` (an int64 tensor of two records of
    ``steps * 5 + 4``) the step_split build, which records the phases of the
    first ``steps`` steps of block 0 and of the middle block."""
    if split is None:
        return None, f'morgana_{kernel}', [], []
    steps = (split.numel() // 2 - 4) // 5
    return 'step_split', f'morgana_{kernel}_split', [ctypes.c_void_p, ctypes.c_int], \
        [split.data_ptr(), steps]


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _lstm_fwd_cuda(xg, w_hh, h0, c0, with_gates=False, split=None):
    """Launches K1 on PyTorch's current stream, at H padded to the next built
    width; raises on anything it does not take, and on a refused or failed
    launch. ``xg`` and ``w_hh`` are f32 or bf16, the storage type of the
    traces; ``h0`` and ``c0`` f32. Returns ``(y, c_all, g_all, hn, cn)``,
    ``g_all`` None unless ``with_gates``. ``split``: see :func:`_entry`."""
    global launches, gate_launches, bf16_launches
    if xg.ndim != 3 or xg.shape[2] % 4:
        raise ValueError(f'K1: xg must be (T, B, 4H), got {tuple(xg.shape)}')
    time, batch, gates4 = xg.shape
    hidden = gates4 // 4
    store = xg.dtype
    check_operands('K1', {'xg': (xg, (time, batch, gates4), store),
                          'w_hh': (w_hh, (hidden, gates4), store),
                          'h0': (h0, (batch, hidden)), 'c0': (c0, (batch, hidden))}, xg.device,
                   dtypes=(torch.float32, torch.bfloat16))
    width = _width('K1', batch, hidden)

    variant, entry, extra_types, extra = _entry('lstm_fwd', split)
    lib, fn = load_library('lstm_fwd', entry,
                           [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                           + extra_types, variant)
    xg, w_hh = _pad_units(xg, width, 4), _pad_w_hh(w_hh, width)
    h0, c0 = _pad_units(h0, width), _pad_units(c0, width)
    y = torch.empty((time, batch, width), dtype=store, device=xg.device)
    c_all = torch.empty_like(y)
    g_all = torch.empty_like(xg) if with_gates else None
    hn = torch.empty((batch, width), dtype=torch.float32, device=xg.device)
    cn = torch.empty_like(hn)
    with torch.cuda.device(xg.device):
        err = fn(xg.data_ptr(), w_hh.data_ptr(), h0.data_ptr(), c0.data_ptr(), y.data_ptr(),
                 c_all.data_ptr(), None if g_all is None else g_all.data_ptr(), hn.data_ptr(),
                 cn.data_ptr(), time, batch, width, int(store == torch.bfloat16), xg.device.index,
                 _stream(xg.device), *extra)
    raise_on_error(lib, err, f'LSTM kernel K1 launch at T={time} B={batch} H={width}',
                   'one block of 256 threads a SM must fit, for every block of the layer')
    launches += 1
    gate_launches += with_gates
    bf16_launches += store == torch.bfloat16
    if g_all is not None:
        g_all = _unpad_units(g_all, hidden, 4)
    return (_unpad_units(y, hidden), _unpad_units(c_all, hidden), g_all,
            _unpad_units(hn, hidden), _unpad_units(cn, hidden))


def _part_floats(batch, width):
    """K2's scratch: two buffers of each of its blocks' (B, H) partial of dh
    (64 blocks, 128 at H = 1024)."""
    return 2 * (128 if width > 512 else 64) * batch * width


def _lstm_bwd_cuda(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, split=None):
    """Launches K2 on PyTorch's current stream, at H padded to the next built
    width; raises on anything it does not take, and on a refused or failed
    launch. ``g_all``, ``w_hh``, ``c0``, ``c_all``, ``dy`` and ``dc_all`` are
    all f32 or all bf16, the storage type; ``dhn`` and ``dcn`` f32. Returns
    ``(dxg, dh0, dc0)``, dxg in the storage type and dh0, dc0 in f32.
    ``split``: as :func:`_lstm_fwd_cuda`."""
    global bwd_launches, bf16_bwd_launches
    if g_all.ndim != 3 or g_all.shape[2] % 4:
        raise ValueError(f'K2: g_all must be (T, B, 4H), got {tuple(g_all.shape)}')
    time, batch, gates4 = g_all.shape
    hidden = gates4 // 4
    store = g_all.dtype
    trace, state = (time, batch, hidden), (batch, hidden)
    check_operands('K2', {'g_all': (g_all, (time, batch, gates4), store),
                          'w_hh': (w_hh, (hidden, gates4), store), 'c0': (c0, state, store),
                          'c_all': (c_all, trace, store), 'dy': (dy, trace, store),
                          'dc_all': (dc_all, trace, store), 'dhn': (dhn, state),
                          'dcn': (dcn, state)},
                   g_all.device, dtypes=(torch.float32, torch.bfloat16))
    width = _width('K2', batch, hidden)

    variant, entry, extra_types, extra = _entry('lstm_bwd', split)
    lib, fn = load_library('lstm_bwd', entry,
                           [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                           + extra_types, variant)
    g_all, w_hh = _pad_units(g_all, width, 4), _pad_w_hh(w_hh, width)
    c0, c_all, dy, dc_all, dhn, dcn = (_pad_units(t, width)
                                       for t in (c0, c_all, dy, dc_all, dhn, dcn))
    dxg = torch.empty_like(g_all)
    dh0 = torch.empty((batch, width), dtype=torch.float32, device=g_all.device)
    dc0 = torch.empty_like(dh0)
    part = torch.empty(_part_floats(batch, width), dtype=torch.float32, device=g_all.device)
    with torch.cuda.device(g_all.device):
        err = fn(g_all.data_ptr(), w_hh.data_ptr(), c0.data_ptr(), c_all.data_ptr(),
                 dy.data_ptr(), dc_all.data_ptr(), dhn.data_ptr(), dcn.data_ptr(),
                 dxg.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), part.data_ptr(), time, batch,
                 width, int(store == torch.bfloat16), g_all.device.index, _stream(g_all.device),
                 *extra)
    raise_on_error(lib, err, f'LSTM kernel K2 launch at T={time} B={batch} H={width}',
                   'one block of 256 threads a SM must fit, for every block of the layer')
    bwd_launches += 1
    bf16_bwd_launches += store == torch.bfloat16
    return _unpad_units(dxg, hidden, 4), _unpad_units(dh0, hidden), _unpad_units(dc0, hidden)


def lstm_recurrence_reference(xg, w_hh, h0, c0):
    """Plain version of K1: ``(xg (T, B, 4H), w_hh, h0, c0) -> (y, c_all,
    g_all, hn, cn)`` by a Python loop over time, state carried in float32;
    ``g_all`` holds the activated gates i, f, g, o of every step. The
    storage type is xg's: y, c_all and g_all are stored in it, and h is
    rounded to it before ``h @ w_hh`` (f32 sums of exact products); hn and
    cn are the f32 state."""
    time, batch, _ = xg.shape
    hidden = w_hh.shape[0]
    store = xg.dtype
    h, c = h0.float(), c0.float()
    ys, cs, gs = [], [], []
    for t in range(time):
        gates = xg[t].float() + torch.matmul(h.to(store).float(), w_hh.float())
        i, f, g, o = gates.split(hidden, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h.to(store))
        cs.append(c.to(store))
        gs.append(torch.cat([i, f, g, o], dim=-1).to(store))
    if not ys:
        empty = xg.new_zeros((0, batch, hidden))
        return empty, empty.clone(), xg.new_zeros((0, batch, 4 * hidden)), h, c
    return torch.stack(ys), torch.stack(cs), torch.stack(gs), h, c


def lstm_backward_reference(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn):
    """Plain version of K2: the reverse-time loop of ``_lstm_bwd_kernel``
    (``pallas_rnn.py:127-158``) over the saved gates. Returns ``(dxg, dh0,
    dc0)``. The storage type is g_all's: dxg is stored in it and rounded to
    it before ``dgates @ w_hh^T``; the carries, dh0 and dc0 are f32."""
    time = g_all.shape[0]
    hidden = w_hh.shape[0]
    store = g_all.dtype
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
                            dc * i * (1.0 - g * g), d_o * o * (1.0 - o)], dim=-1).to(store)
        dxg[t] = dgates
        dh = torch.matmul(dgates.float(), w_hh.float().t())
        dc_carry = dc * f
    if not dxg:
        return g_all.new_zeros(g_all.shape), dh, dc_carry
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


def _gates_recurrence(xg, w_hh, h0, c0):
    return lstm_recurrence(xg, w_hh, h0, c0, with_gates=True)


class _Recurrence(torch.autograd.Function):
    """``(xg, w_hh, h0, c0) -> (y, c_all, hn, cn)`` with K1 (gate trace on)
    forward and K2 backward (``_core_fwd``/``_core_bwd``, ``pallas_rnn.py:226``),
    or with ``plain`` their plain versions on any device. ``xg`` and ``w_hh``
    are stored as ``store`` (a torch dtype); y and c_all come back in it.
    Saves ``w_hh, h0, c0``, the unmasked ``y``, ``c_all`` and ``g_all``; not
    ``xg``. Absent cotangents arrive as zeros (autograd materialises them)."""

    @staticmethod
    def forward(ctx, xg, w_hh, h0, c0, store, plain):
        forward = lstm_recurrence_reference if plain else _gates_recurrence
        w_s = w_hh.to(store)
        y, c_all, g_all, hn, cn = forward(xg.to(store), w_s, h0, c0)
        ctx.plain = plain
        ctx.save_for_backward(w_s, h0, c0, y, c_all, g_all)
        return y, c_all, hn, cn

    @staticmethod
    def backward(ctx, dy, dc_all, dhn, dcn):
        w_s, h0, c0, y, c_all, g_all = ctx.saved_tensors
        time, batch, hidden = y.shape
        store = w_s.dtype
        backward = lstm_backward_reference if ctx.plain else lstm_backward
        dxg, dh0, dc0 = backward(g_all, w_s, c0.to(store).contiguous(), c_all,
                                 dy.to(store).contiguous(), dc_all.to(store).contiguous(),
                                 dhn.float().contiguous(), dcn.float().contiguous())
        # dW_hh = sum_t h_{t-1}^T dxg_t over the flattened (T * B) rows, with
        # h_{t-1} from the kernel's unmasked y (h0 at t = 0), both as stored:
        # the f32 product of stored values is exact, its sums f32.
        h_prev = torch.cat([h0.to(store)[None], y])[:time]
        dw_hh = torch.matmul(h_prev.reshape(time * batch, hidden).t().float(),
                             dxg.reshape(time * batch, 4 * hidden).float())
        # dh0 and dc0 pass through the storage type (pallas_rnn.py:272-273).
        return dxg.float(), dw_hh, dh0.to(store).float(), dc0.to(store).float(), None, None


def _recurrence(xg, w_hh, h0, c0, store):
    """The autograd Function when a gradient is needed (the gate-writing K1
    and K2), else the recurrence alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xg, w_hh, h0, c0)):
        return _Recurrence.apply(xg, w_hh, h0, c0, store, False)
    y, c_all, _, hn, cn = lstm_recurrence(xg.to(store), w_hh.to(store), h0, c0)
    return y, c_all, hn, cn


def _plain_recurrence(xg, w_hh, h0, c0, store):
    """The plain recurrence: in f32, autograd through its loop; in another
    storage type, the plain versions of K1 and K2 as the Function, since the
    rounding has a VJP of its own (``_core_bwd``)."""
    if store != torch.float32 and torch.is_grad_enabled() and \
            any(t.requires_grad for t in (xg, w_hh, h0, c0)):
        return _Recurrence.apply(xg, w_hh, h0, c0, store, True)
    y, c_all, _, hn, cn = lstm_recurrence_reference(xg.to(store), w_hh.to(store), h0, c0)
    return y, c_all, hn, cn


def _layer(recurrence, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0, store_dtype):
    batch = x.shape[0]
    hidden = w_hh.shape[0]
    dtype = x.dtype

    xg = torch.matmul(x, w_ih) + (b_ih + b_hh)          # one large matmul
    xg = xg.transpose(0, 1).contiguous()                 # (T, B, 4H)
    h0 = x.new_zeros((batch, hidden)) if h0 is None else h0
    c0 = x.new_zeros((batch, hidden)) if c0 is None else c0

    y, c_all, hn, cn = recurrence(xg, w_hh, h0.contiguous(), c0.contiguous(), _store(store_dtype))
    y = y.transpose(0, 1).to(dtype)                      # (B, T, H)
    if seq_len is not None:
        y, seq_len = mask_past_seq_len(y, seq_len)
        # Position seq_len - 1 is valid, so gathering from the masked y is exact.
        hn = state_at_seq_len(y, seq_len, h0)
        cn = state_at_seq_len(c_all.transpose(0, 1).to(dtype), seq_len, c0)
    return y, (hn.to(dtype), cn.to(dtype))


def lstm_layer(x, w_ih, w_hh, b_ih, b_hh, seq_len=None, h0=None, c0=None, store_dtype=None):
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
    store_dtype : None, 'float32' or 'bfloat16'
        The storage type of the recurrence (``pallas_rnn.STORE_DTYPE``).

    Returns
    -------
    y : (batch, time, H), zero past ``seq_len``
    (hn, cn) : the state at ``seq_len`` (at ``time`` without ``seq_len``)
    """
    return _layer(_recurrence, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0, store_dtype)


def lstm_layer_reference(x, w_ih, w_hh, b_ih, b_hh, seq_len=None, h0=None, c0=None,
                         store_dtype=None):
    """:func:`lstm_layer` through the plain recurrence on any device, its
    gradient by autograd through the loop (in f32) or by the plain K2: what
    the kernels are held against."""
    return _layer(_plain_recurrence, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0, store_dtype)
