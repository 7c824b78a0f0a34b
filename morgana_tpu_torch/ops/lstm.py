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

K1 and K2 are the custom ops ``morgana::lstm_fwd`` and ``morgana::lstm_bwd``
(:func:`lstm_fwd`, :func:`lstm_bwd`; their ``cuda`` implementations launch
the kernels, their ``cpu`` ones are the plain versions).

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

Compute type (``compute_dtype`` bf16, the scan backend under
``--compute_dtype bfloat16``, ``ops/rnn.py:113-135``, "K1c" and "K2c"): the input GEMM
rounds x and w_ih to bf16 (:func:`~morgana_tpu_torch.ops.precision.matmul`),
and the recurrence rounds w_hh and each step's h to bf16 for ``h @ w_hh``,
whose sums stay f32; xg, the gate math, the carried h and c and every
stored trace stay f32. Its gradient is the JAX scan's autodiff: K1c writes
its f32 gate trace, and K2c rounds w_hh to bf16 and each step's carried
``dgates @ w_hh^T`` to bf16 before it joins dy, the gate gradients, dxg,
dh0 and dc0 staying f32; dW_hh is the bf16 carry of
``ops/weight_grad.py`` over ``h_{t-1}`` and dxg. On the card K1c and K2c
take one of two routes by the layer's width alone (:func:`bf16_route`):
up to 512 (padded) the cluster kernels ``csrc/lstm_fwd_bf16.cu`` and
``csrc/lstm_bwd_bf16.cu`` (w_hh in bf16 in the registers of a thread-block
cluster, the step product on bf16 tensor cores, a cluster barrier a step),
at 1024 the bf16-compute builds of ``csrc/lstm_fwd.cu`` and
``csrc/lstm_bwd.cu``. Either raises on a refused launch; neither falls
back to the other.

Outputs past ``seq_len`` are zeroed and the final ``(h, c)`` is gathered at
``seq_len - 1`` (``h0``/``c0`` for empty rows), which is exactly the state a
recurrence stopped at ``seq_len`` would hold (``pallas_rnn.py:298-347``).
"""
import contextlib
import ctypes
import os
import threading

import torch

from morgana_tpu_torch.ops import precision
from morgana_tpu_torch.ops._kernels import (check_device, check_operands, load_library,
                                            mask_past_seq_len, no_alias, raise_on_error,
                                            split_entry, state_at_seq_len)
from morgana_tpu_torch.ops.weight_grad import bf16_weight_grad, bf16_weight_grad_reference

__all__ = ['lstm_layer', 'lstm_layer_reference', 'lstm_recurrence',
           'lstm_recurrence_reference', 'lstm_backward', 'lstm_backward_reference',
           'lstm_fwd', 'lstm_bwd',
           'STORE_DTYPE', 'launches', 'gate_launches', 'bwd_launches',
           'bf16_launches', 'bf16_bwd_launches', 'bf16_compute_launches',
           'bf16_compute_gate_launches', 'bf16_compute_bwd_launches', 'bf16_route',
           'cluster_plan', 'bf16_cluster_launches', 'bf16_cluster_gate_launches',
           'bf16_cluster_bwd_launches']

# The storage type of the 'pallas' backend's LSTM layers, e.g. 'bfloat16'
# (pallas_rnn.py:59); None is the input's type, f32.
STORE_DTYPE = os.environ.get('MORGANA_PALLAS_STORE', None)

# Launches of K1 (all, and those that wrote the gate trace) and of K2, each
# counted where its wrapper launches the kernel and nowhere else; a run reads
# them to show which path it took. The bf16_ counts are those of the kernels
# built for bf16 storage (K1s), among the others, and bf16_compute_launches
# those of K1c, f32 storage with bf16 products (bf16_compute_gate_launches
# those of them that wrote the gate trace), bf16_compute_bwd_launches those of
# K2c; the bf16_cluster_ counts those of K1c, K1c with its gate trace and K2c
# that took the cluster kernels (bf16_route), among them.
launches = 0
gate_launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0
bf16_compute_launches = 0
bf16_compute_gate_launches = 0
bf16_compute_bwd_launches = 0
bf16_cluster_launches = 0
bf16_cluster_gate_launches = 0
bf16_cluster_bwd_launches = 0

_MAX_BATCH = 256
_WIDTHS = (64, 128, 256, 512, 1024)  # the widths the kernels are built for
_CLUSTER_WIDTH = 512                 # the widest the cluster kernels take
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


def bf16_route(hidden):
    """The kernels a bf16-compute LSTM layer (K1c, K2c) of ``hidden`` units
    takes on the card, a rule of its width alone: ``'cluster'``
    (``csrc/lstm_fwd_bf16.cu``, ``csrc/lstm_bwd_bf16.cu``) when the width it
    is padded to is at most 512, so that its bf16 w_hh (2 MiB at 512) fits
    the registers of one cluster of H / 32 CTAs; ``'grid'`` (the
    bf16-compute builds of ``csrc/lstm_fwd.cu`` and ``csrc/lstm_bwd.cu``)
    at 1024."""
    return 'cluster' if _width('K1c', 1, hidden) <= _CLUSTER_WIDTH else 'grid'


def cluster_plan(batch, hidden, gates=False, backward=False, device=None):
    """What a cluster kernel's launch at (``batch``, ``hidden`` padded)
    takes on ``device`` (a CUDA device), launching nothing: ``(tiles,
    clusters, fit)``, the n8 tiles of batch rows a cluster, the clusters of
    the launch and how many of them the card holds at once
    (``cudaOccupancyMaxActiveClusters``). K1c with ``gates`` (its gate
    trace), K2c with ``backward``."""
    width = _width('K1c', batch, hidden)
    if width > _CLUSTER_WIDTH:
        raise ValueError(f'H={hidden} takes the grid kernels, not a cluster (bf16_route)')
    device = torch.device('cuda' if device is None else device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    name = 'lstm_bwd_bf16' if backward else 'lstm_fwd_bf16'
    out = (ctypes.c_int * 3)()
    lib, fn = load_library(name, f'morgana_{name}_plan',
                           [ctypes.c_int] * (3 if backward else 4) + [ctypes.c_void_p])
    args = (batch, width) + (() if backward else (int(gates),)) + (index, out)
    raise_on_error(lib, fn(*args), f'{name} plan at B={batch} H={width}', _CLUSTER_HINT)
    return tuple(out)


_CLUSTER_HINT = ('a cluster of H / 32 CTAs of 256 threads (128 at H = 64), one a SM, must fit '
                 '(cudaOccupancyMaxActiveClusters)')


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


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _lstm_fwd_cuda(xg, w_hh, h0, c0, with_gates=False, split=None, compute_bf16=False):
    """Launches K1 on PyTorch's current stream, at H padded to the next built
    width; raises on anything it does not take, and on a refused or failed
    launch. ``xg`` and ``w_hh`` are f32 or bf16, the storage type of the
    traces; ``h0`` and ``c0`` f32. With ``compute_bf16`` and f32 storage it
    launches K1c, which rounds w_hh and h to bf16 for the product (bf16
    storage rounds them so already), on the route :func:`bf16_route` gives.
    Returns ``(y, c_all, g_all, hn, cn)``, ``g_all`` None unless
    ``with_gates``. ``split``: see
    :func:`~morgana_tpu_torch.ops._kernels.split_entry`."""
    global launches, gate_launches, bf16_launches, bf16_compute_launches, \
        bf16_compute_gate_launches, bf16_cluster_launches, bf16_cluster_gate_launches
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
    k1c = compute_bf16 and store == torch.float32
    cluster = k1c and bf16_route(hidden) == 'cluster'
    name = 'lstm_fwd_bf16' if cluster else 'lstm_fwd'
    # The cluster kernel takes (T, B, H, gates), the grid one (T, B, H, bf16,
    # compute_bf16), then the device.
    flags = (int(with_gates),) if cluster else (int(store == torch.bfloat16), int(k1c))

    variant, entry, extra_types, extra = split_entry(f'morgana_{name}', split)
    lib, fn = load_library(name, entry,
                           [ctypes.c_void_p] * 9 + [ctypes.c_int] * (4 + len(flags))
                           + [ctypes.c_void_p] + extra_types, variant)
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
                 cn.data_ptr(), time, batch, width, *flags, xg.device.index,
                 _stream(xg.device), *extra)
    raise_on_error(lib, err, f'LSTM kernel {"K1c" if k1c else "K1"} ({name}.cu) launch at '
                   f'T={time} B={batch} H={width}',
                   _CLUSTER_HINT if cluster else
                   'one block of 256 threads a SM must fit, for every block of the layer')
    launches += 1
    gate_launches += with_gates
    bf16_launches += store == torch.bfloat16
    bf16_compute_launches += k1c
    bf16_compute_gate_launches += k1c and with_gates
    bf16_cluster_launches += cluster
    bf16_cluster_gate_launches += cluster and with_gates
    if g_all is not None:
        g_all = _unpad_units(g_all, hidden, 4)
    return (_unpad_units(y, hidden), _unpad_units(c_all, hidden), g_all,
            _unpad_units(hn, hidden), _unpad_units(cn, hidden))


def _part_floats(batch, width):
    """K2's scratch: two buffers of each of its blocks' (B, H) partial of dh
    (64 blocks, 128 at H = 1024)."""
    return 2 * (128 if width > 512 else 64) * batch * width


def _lstm_bwd_cuda(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, split=None,
                   compute_bf16=False):
    """Launches K2 on PyTorch's current stream, at H padded to the next built
    width; raises on anything it does not take, and on a refused or failed
    launch. ``g_all``, ``w_hh``, ``c0``, ``c_all``, ``dy`` and ``dc_all`` are
    all f32 or all bf16, the storage type; ``dhn`` and ``dcn`` f32. Returns
    ``(dxg, dh0, dc0)``, dxg in the storage type and dh0, dc0 in f32. With
    ``compute_bf16`` and f32 storage it launches K2c, which rounds w_hh and
    each step's carried ``dgates @ w_hh^T`` to bf16, on the route
    :func:`bf16_route` gives. ``split``: as :func:`_lstm_fwd_cuda`."""
    global bwd_launches, bf16_bwd_launches, bf16_compute_bwd_launches, bf16_cluster_bwd_launches
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
    k2c = compute_bf16 and store == torch.float32
    cluster = k2c and bf16_route(hidden) == 'cluster'
    name = 'lstm_bwd_bf16' if cluster else 'lstm_bwd'

    variant, entry, extra_types, extra = split_entry(f'morgana_{name}', split)
    # The cluster kernel takes no scratch and (T, B, H), the grid one the
    # scratch of its partials and (T, B, H, bf16, compute_bf16), then the
    # device.
    lib, fn = load_library(name, entry,
                           [ctypes.c_void_p] * (11 if cluster else 12)
                           + [ctypes.c_int] * (4 if cluster else 6) + [ctypes.c_void_p]
                           + extra_types, variant)
    g_all, w_hh = _pad_units(g_all, width, 4), _pad_w_hh(w_hh, width)
    c0, c_all, dy, dc_all, dhn, dcn = (_pad_units(t, width)
                                       for t in (c0, c_all, dy, dc_all, dhn, dcn))
    dxg = torch.empty_like(g_all)
    dh0 = torch.empty((batch, width), dtype=torch.float32, device=g_all.device)
    dc0 = torch.empty_like(dh0)
    if cluster:
        rest = (time, batch, width)
    else:
        part = torch.empty(_part_floats(batch, width), dtype=torch.float32, device=g_all.device)
        rest = (part.data_ptr(), time, batch, width, int(store == torch.bfloat16), int(k2c))
    with torch.cuda.device(g_all.device):
        err = fn(g_all.data_ptr(), w_hh.data_ptr(), c0.data_ptr(), c_all.data_ptr(),
                 dy.data_ptr(), dc_all.data_ptr(), dhn.data_ptr(), dcn.data_ptr(),
                 dxg.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), *rest, g_all.device.index,
                 _stream(g_all.device), *extra)
    raise_on_error(lib, err, f'LSTM kernel {"K2c" if k2c else "K2"} ({name}.cu) launch at '
                   f'T={time} B={batch} H={width}',
                   _CLUSTER_HINT if cluster else
                   'one block of 256 threads a SM must fit, for every block of the layer')
    bwd_launches += 1
    bf16_bwd_launches += store == torch.bfloat16
    bf16_compute_bwd_launches += k2c
    bf16_cluster_bwd_launches += cluster
    return _unpad_units(dxg, hidden, 4), _unpad_units(dh0, hidden), _unpad_units(dc0, hidden)


def lstm_recurrence_reference(xg, w_hh, h0, c0, compute_bf16=False):
    """Plain version of K1: ``(xg (T, B, 4H), w_hh, h0, c0) -> (y, c_all,
    g_all, hn, cn)`` by a Python loop over time, state carried in float32;
    ``g_all`` holds the activated gates i, f, g, o of every step. The
    storage type is xg's: y, c_all and g_all are stored in it, and h is
    rounded to it before ``h @ w_hh`` (f32 sums of exact products); hn and
    cn are the f32 state. With ``compute_bf16`` (K1c) w_hh and h are rounded
    to bf16 for the product whatever the storage type."""
    time, batch, _ = xg.shape
    hidden = w_hh.shape[0]
    store = xg.dtype
    compute = torch.bfloat16 if compute_bf16 else store
    w = w_hh.to(compute).float()
    h, c = h0.float(), c0.float()
    ys, cs, gs = [], [], []
    for t in range(time):
        gates = xg[t].float() + torch.matmul(h.to(compute).float(), w)
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


def lstm_backward_reference(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, compute_bf16=False):
    """Plain version of K2: the reverse-time loop of ``_lstm_bwd_kernel``
    (``pallas_rnn.py:127-158``) over the saved gates. Returns ``(dxg, dh0,
    dc0)``. The storage type is g_all's: dxg is stored in it and rounded to
    it before ``dgates @ w_hh^T``; the carries, dh0 and dc0 are f32. With
    ``compute_bf16`` (K2c, the JAX scan's autodiff under a bf16 compute
    dtype) w_hh is rounded to bf16 and so is each step's ``dgates @ w_hh^T``
    before it joins dy (``convert`` to bf16 and back)."""
    time = g_all.shape[0]
    hidden = w_hh.shape[0]
    store = g_all.dtype
    compute = torch.bfloat16 if compute_bf16 else None
    w = precision.rounded(w_hh.float(), compute)
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
        dh = precision.rounded(torch.matmul(dgates.float(), w.t()), compute)
        dc_carry = dc * f
    if not dxg:
        return g_all.new_zeros(g_all.shape), dh, dc_carry
    return torch.stack(dxg), dh, dc_carry


@torch.library.custom_op('morgana::lstm_fwd', mutates_args=(), device_types='cpu')
def lstm_fwd(xg: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
             with_gates: bool, compute_bf16: bool = False) -> tuple[
                 torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``morgana::lstm_fwd``, K1 (K1c with ``compute_bf16``): ``(y, c_all,
    g_all, hn, cn)`` of the recurrence over ``xg`` (T, B, 4H), ``g_all``
    empty (0,) unless ``with_gates``. This is its ``cpu`` implementation,
    the plain version."""
    y, c_all, g_all, hn, cn = lstm_recurrence_reference(xg, w_hh, h0, c0, compute_bf16)
    return no_alias((y, c_all, g_all if with_gates else xg.new_empty((0,)), hn, cn),
                    (xg, w_hh, h0, c0))


@lstm_fwd.register_kernel('cuda')
def _lstm_fwd_op_cuda(xg, w_hh, h0, c0, with_gates, compute_bf16=False):
    y, c_all, g_all, hn, cn = _lstm_fwd_cuda(xg, w_hh, h0, c0, with_gates,
                                             compute_bf16=compute_bf16)
    return y, c_all, xg.new_empty((0,)) if g_all is None else g_all, hn, cn


@lstm_fwd.register_fake
def _lstm_fwd_fake(xg, w_hh, h0, c0, with_gates, compute_bf16=False):
    time, batch, gates4 = xg.shape
    state = h0.new_empty((batch, gates4 // 4), dtype=torch.float32)
    y = xg.new_empty((time, batch, gates4 // 4))
    return (y, torch.empty_like(y), xg.new_empty(xg.shape if with_gates else (0,)), state,
            torch.empty_like(state))


@torch.library.custom_op('morgana::lstm_bwd', mutates_args=(), device_types='cpu')
def lstm_bwd(g_all: torch.Tensor, w_hh: torch.Tensor, c0: torch.Tensor, c_all: torch.Tensor,
             dy: torch.Tensor, dc_all: torch.Tensor, dhn: torch.Tensor, dcn: torch.Tensor,
             compute_bf16: bool = False) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``morgana::lstm_bwd``, K2 (K2c with ``compute_bf16``): ``(dxg, dh0,
    dc0)``. This is its ``cpu`` implementation, the plain version."""
    inputs = (g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn)
    return no_alias(lstm_backward_reference(*inputs, compute_bf16), inputs)


@lstm_bwd.register_kernel('cuda')
def _lstm_bwd_op_cuda(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, compute_bf16=False):
    return _lstm_bwd_cuda(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn,
                          compute_bf16=compute_bf16)


@lstm_bwd.register_fake
def _lstm_bwd_fake(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, compute_bf16=False):
    state = dhn.new_empty(dhn.shape, dtype=torch.float32)
    return torch.empty_like(g_all), state, torch.empty_like(state)


def lstm_recurrence(xg, w_hh, h0, c0, with_gates=False, compute_bf16=False):
    """The recurrence over ``xg``, :func:`lstm_fwd`: kernel K1 (K1c with
    ``compute_bf16``) for CUDA tensors, the plain version for CPU tensors.
    Returns ``(y, c_all, g_all, hn, cn)``; ``g_all`` is None unless
    ``with_gates``."""
    check_device('LSTM recurrence', xg)
    y, c_all, g_all, hn, cn = torch.ops.morgana.lstm_fwd(xg, w_hh, h0, c0, with_gates,
                                                         compute_bf16)
    return y, c_all, g_all if with_gates else None, hn, cn


def lstm_backward(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, compute_bf16=False):
    """The backward of the recurrence, :func:`lstm_bwd`: kernel K2 (K2c with
    ``compute_bf16``) for CUDA tensors, the plain version for CPU tensors.
    Returns ``(dxg, dh0, dc0)``."""
    check_device('LSTM backward', g_all)
    return torch.ops.morgana.lstm_bwd(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, compute_bf16)


class _Recurrence(torch.autograd.Function):
    """``(xg, w_hh, h0, c0) -> (y, c_all, hn, cn)`` with K1 (gate trace on)
    forward and K2 backward (``_core_fwd``/``_core_bwd``, ``pallas_rnn.py:226``),
    or with ``plain`` their plain versions on any device. ``xg`` and ``w_hh``
    are stored as ``store`` (a torch dtype); y and c_all come back in it.
    With ``bf16`` (f32 storage, bf16 products) K1c with its gate trace and
    K2c, and dW_hh the bf16 carry. Saves ``w_hh, h0, c0``, the unmasked
    ``y``, ``c_all`` and ``g_all``; not ``xg``. Absent cotangents arrive as
    zeros (autograd materialises them)."""

    @staticmethod
    def forward(ctx, xg, w_hh, h0, c0, store, plain, bf16):
        w_s = w_hh.to(store)
        if plain:
            y, c_all, g_all, hn, cn = lstm_recurrence_reference(xg.to(store), w_s, h0, c0, bf16)
        else:
            gates = not getattr(_SKIP_GATES, 'on', False)
            y, c_all, g_all, hn, cn = lstm_recurrence(xg.to(store), w_s, h0, c0,
                                                      with_gates=gates, compute_bf16=bf16)
            if g_all is None:
                g_all = xg.new_empty((0,))
        ctx.plain, ctx.bf16 = plain, bf16
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
                                 dhn.float().contiguous(), dcn.float().contiguous(), ctx.bf16)
        # h_{t-1} from the kernel's unmasked y (h0 at t = 0), as stored.
        h_prev = torch.cat([h0.to(store)[None], y])[:time]
        if ctx.bf16:
            # JAX's bf16 carry of w_hh_c's cotangent (ops/weight_grad.py).
            carry = bf16_weight_grad_reference if ctx.plain else bf16_weight_grad
            dw_hh = carry(h_prev, dxg)
        else:
            # dW_hh = sum_t h_{t-1}^T dxg_t over the flattened (T * B) rows:
            # the f32 product of stored values is exact, its sums f32.
            dw_hh = torch.matmul(h_prev.reshape(time * batch, hidden).t().float(),
                                 dxg.reshape(time * batch, 4 * hidden).float())
        # dh0 and dc0 pass through the storage type (pallas_rnn.py:272-273).
        return dxg.float(), dw_hh, dh0.to(store).float(), dc0.to(store).float(), None, None, None


_SKIP_GATES = threading.local()


@contextlib.contextmanager
def skip_gate_trace():
    """The first forward of a checkpointed layer (``nn`` remat): K1 runs
    without its gate trace, which the recomputation in the backward pass
    writes; what the forward saves in its place is never read."""
    before = getattr(_SKIP_GATES, 'on', False)
    _SKIP_GATES.on = True
    try:
        yield
    finally:
        _SKIP_GATES.on = before


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _recurrence(xg, w_hh, h0, c0, store, compute):
    """The autograd Function when a gradient is needed (the gate-writing K1
    or K1c, and K2 or K2c), else the recurrence alone."""
    if _needs_grad(xg, w_hh, h0, c0):
        return _Recurrence.apply(xg, w_hh, h0, c0, store, False,
                                 compute is not None and store == torch.float32)
    y, c_all, _, hn, cn = lstm_recurrence(xg.to(store), w_hh.to(store), h0, c0,
                                          compute_bf16=compute is not None)
    return y, c_all, hn, cn


def _plain_recurrence(xg, w_hh, h0, c0, store, compute):
    """The plain recurrence: in f32 with f32 products, autograd through its
    loop; in another storage type or with bf16 products, the plain versions
    of K1 and K2 as the Function, since the rounding has a VJP of its own
    (``_core_bwd``; with bf16 products the scan's autodiff, its bf16 carry
    of dW_hh included)."""
    if (store != torch.float32 or compute is not None) and _needs_grad(xg, w_hh, h0, c0):
        return _Recurrence.apply(xg, w_hh, h0, c0, store, True,
                                 compute is not None and store == torch.float32)
    y, c_all, _, hn, cn = lstm_recurrence_reference(xg.to(store), w_hh.to(store), h0, c0,
                                                    compute_bf16=compute is not None)
    return y, c_all, hn, cn


def _layer(recurrence, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0, store_dtype, compute_dtype):
    batch = x.shape[0]
    hidden = w_hh.shape[0]
    dtype = x.dtype
    compute = precision.as_compute_dtype(compute_dtype)

    xg = precision.matmul(x, w_ih, compute) + (b_ih + b_hh)   # one large matmul
    xg = xg.transpose(0, 1).contiguous()                       # (T, B, 4H)
    h0 = x.new_zeros((batch, hidden)) if h0 is None else h0
    c0 = x.new_zeros((batch, hidden)) if c0 is None else c0

    y, c_all, hn, cn = recurrence(xg, w_hh, h0.contiguous(), c0.contiguous(), _store(store_dtype),
                                  compute)
    y = y.transpose(0, 1).to(dtype)                      # (B, T, H)
    if seq_len is not None:
        y, seq_len = mask_past_seq_len(y, seq_len)
        # Position seq_len - 1 is valid, so gathering from the masked y is exact.
        hn = state_at_seq_len(y, seq_len, h0)
        cn = state_at_seq_len(c_all.transpose(0, 1).to(dtype), seq_len, c0)
    return y, (hn.to(dtype), cn.to(dtype))


def lstm_layer(x, w_ih, w_hh, b_ih, b_hh, seq_len=None, h0=None, c0=None, store_dtype=None,
               compute_dtype=None):
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
    compute_dtype : None, 'bfloat16', ... (``precision.as_compute_dtype``)
        The products' input type (``ops/rnn.py::lstm``'s ``compute_dtype``).

    Returns
    -------
    y : (batch, time, H), zero past ``seq_len``
    (hn, cn) : the state at ``seq_len`` (at ``time`` without ``seq_len``)
    """
    return _layer(_recurrence, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0, store_dtype,
                  compute_dtype)


def lstm_layer_reference(x, w_ih, w_hh, b_ih, b_hh, seq_len=None, h0=None, c0=None,
                         store_dtype=None, compute_dtype=None):
    """:func:`lstm_layer` through the plain recurrence on any device, its
    gradient by autograd through the loop (in f32) or by the plain K2 (and,
    with bf16 products, the plain bf16 carry): what the kernels are held
    against."""
    return _layer(_plain_recurrence, x, w_ih, w_hh, b_ih, b_hh, seq_len, h0, c0, store_dtype,
                  compute_dtype)
