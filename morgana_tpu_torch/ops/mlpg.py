"""Maximum-likelihood parameter generation (MLPG) as a batched banded solve
on device (counterpart of ``morgana_tpu/ops/mlpg.py``).

:func:`mlpg` is one call of the custom op ``morgana::mlpg``
(:func:`mlpg_op`), from the means and variances to the trajectory:

* on a CUDA tensor, one launch of ``csrc/mlpg.cu``, which forms each row of
  the banded systems from the means and variances itself, factors them as
  the plain loop does (float32, a thread a lane), substitutes in float64
  partitioned along time (32 segments a lane) and writes the unpadded,
  masked trajectory; or an error: there is no fallback;
* on a CPU tensor, its plain version: the Gaussian product-of-experts
  natural parameters (b, P) built with shift-and-add ops over all (batch x
  feature) lanes at once (:func:`banded_system`), the banded SPD system
  ``P x = b`` solved by the banded Cholesky of the JAX package, three
  sequential passes over frames, each step an elementwise op over the lanes
  (:func:`_banded_cholesky_solve`), then the unpad. The arithmetic follows
  the JAX version step for step, in float32.

The solve alone is ``morgana::mlpg_solve`` (:func:`mlpg_solve`) on given
(b, bands): the same device code on CUDA, the plain loop on the CPU. The
JAX package runs the passes as ``lax.scan``, no Pallas kernel.
"""
import ctypes
import functools
from typing import List, Optional

import torch

from morgana_tpu_torch.ops._kernels import (check_device, check_operands, load_library,
                                            no_alias, raise_on_error)
from morgana_tpu_torch.ops.deltas import DEFAULT_WINDOWS

__all__ = ['mlpg', 'mlpg_op', 'mlpg_solve', 'banded_system', 'DEFAULT_WINDOWS',
           'MAX_BANDWIDTH', 'MAX_WINDOWS', 'launches', 'fused_launches']

# Launches of csrc/mlpg.cu, counted where the wrappers launch it and nowhere
# else: `launches` those of both ops, `fused_launches` those of morgana::mlpg.
launches = 0
fused_launches = 0

#: The bandwidths the kernel is built for (a template each): 0 to 4.
MAX_BANDWIDTH = 4


def _shifted(x, s):
    """``out[i] = x[i + s]`` along dim 0, zero padded."""
    if s == 0:
        return x
    zeros = x.new_zeros((abs(s),) + x.shape[1:])
    if s > 0:
        return torch.cat([x[s:], zeros])
    return torch.cat([zeros, x[:s]])


def _build_banded_poe(b_frames, tau_frames, windows, bandwidth):
    """(T, L, W) mean/variance and 1/variance per window -> b (T, L) and the
    upper band ``p_band[m][i] = P[i, i + m]`` as a list of (T, L), zero beyond
    the matrix edge (``ops/mlpg.py:37``)."""
    num_frames = b_frames.shape[0]
    b = torch.zeros_like(b_frames[..., 0])
    p_band = [torch.zeros_like(b) for _ in range(bandwidth + 1)]
    for w, (l, u, coeffs) in enumerate(windows):
        width = l + u + 1
        for a in range(width):
            c = float(coeffs[a])
            if c != 0.0:
                b = b + c * _shifted(b_frames[..., w], l - a)
        for m in range(bandwidth + 1):
            for a in range(width - m):
                c2 = float(coeffs[a]) * float(coeffs[a + m])
                if c2 != 0.0:
                    p_band[m] = p_band[m] + c2 * _shifted(tau_frames[..., w], l - a)
    idx = torch.arange(num_frames, device=b.device)[:, None]
    for m in range(1, bandwidth + 1):
        p_band[m] = torch.where(idx + m < num_frames, p_band[m], 0.)
    return b, p_band


def _banded_cholesky_solve(b, p_band, bandwidth):
    """Solves ``P x = b`` over (T, L) lanes, ``P = L L^T`` (``ops/mlpg.py:88``)."""
    bw = bandwidth
    num_frames, lanes = b.shape
    zero = b.new_zeros((lanes,))
    one = b.new_ones((lanes,))

    # row_p[p][i] = P[i, i - p].
    row_p = [p_band[0]] + [_shifted(p_band[p], -p) for p in range(1, bw + 1)]

    # Factorise. Each row is stored as r[q] = L[i, i - bw + q] (q = bw is the
    # diagonal); prev[k] is row i-1-k, identity rows before frame 0.
    prev = [[zero] * bw + [one] for _ in range(bw)]
    l_rows = []
    for i in range(num_frames):
        r = [None] * (bw + 1)
        for p in range(bw, 0, -1):
            s = row_p[p][i]
            for qp in range(bw - p):
                s = s - r[qp] * prev[p - 1][qp + p]
            r[bw - p] = s / prev[p - 1][bw]
        s = row_p[0][i]
        for q in range(bw):
            s = s - r[q] * r[q]
        r[bw] = torch.sqrt(torch.clamp(s, min=1e-20))
        prev = [r] + prev[:-1]
        l_rows.append(r)

    # Forward substitution: L y = b.
    prev_y = [zero] * bw
    ys = []
    for i in range(num_frames):
        s = b[i]
        for p in range(1, bw + 1):
            s = s - l_rows[i][bw - p] * prev_y[p - 1]
        y_i = s / l_rows[i][bw]
        prev_y = [y_i] + prev_y[:-1]
        ys.append(y_i)

    # Back substitution: L^T x = y, x[i] = (y[i] - sum_p L[i+p, i] x[i+p]) / L[i, i].
    next_x = [zero] * bw
    xs = [None] * num_frames
    for i in range(num_frames - 1, -1, -1):
        s = ys[i]
        for p in range(1, bw + 1):
            if i + p < num_frames:
                s = s - l_rows[i + p][bw - p] * next_x[p - 1]
        x_i = s / l_rows[i][bw]
        next_x = [x_i] + next_x[:-1]
        xs[i] = x_i
    return torch.stack(xs)


def _scratch(lib, frames, lanes, bandwidth, device):
    """The kernel's scratch for lanes of at most ``frames`` rows, as bytes:
    every row's entries of L (float32) and of the substitutions (float64)."""
    size_of = lib.morgana_mlpg_scratch_bytes
    size_of.argtypes, size_of.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    return torch.empty(size_of(frames, lanes, bandwidth), dtype=torch.uint8, device=device)


def _mlpg_solve_cuda(b, bands):
    """Launches ``csrc/mlpg.cu``'s solve on PyTorch's current stream; raises
    on anything it does not take, and on a refused or failed launch. Returns
    x (T', lanes)."""
    global launches
    if b.ndim != 2 or bands.ndim != 3:
        raise ValueError(f'mlpg_solve: b must be (T\', lanes) and bands (BW + 1, T\', lanes), '
                         f'got {tuple(b.shape)} and {tuple(bands.shape)}')
    frames, lanes = b.shape
    bandwidth = bands.shape[0] - 1
    if bandwidth > MAX_BANDWIDTH:
        raise ValueError(f'mlpg_solve: the kernel takes bandwidths up to {MAX_BANDWIDTH}, got '
                         f'{bandwidth}')
    check_operands('mlpg_solve', {'b': (b, (frames, lanes)),
                                  'bands': (bands, (bandwidth + 1, frames, lanes))}, b.device)
    x = torch.empty_like(b)
    if not x.numel():
        return x
    lib, fn = load_library('mlpg', 'morgana_mlpg_solve',
                           [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    scratch = _scratch(lib, frames, lanes, bandwidth, b.device)
    with torch.cuda.device(b.device):
        err = fn(b.data_ptr(), bands.data_ptr(), scratch.data_ptr(), x.data_ptr(),
                 frames, lanes, bandwidth, b.device.index,
                 torch.cuda.current_stream(b.device).cuda_stream)
    raise_on_error(lib, err, f'MLPG solve kernel launch at T\'={frames} lanes={lanes} '
                   f'BW={bandwidth}', '32 segments a lane, 8 lanes a block')
    launches += 1
    return x


@torch.library.custom_op('morgana::mlpg_solve', mutates_args=(), device_types='cpu')
def mlpg_solve(b: torch.Tensor, bands: torch.Tensor) -> torch.Tensor:
    """``morgana::mlpg_solve``: x (T', lanes) with ``P x = b`` in every lane,
    ``bands[m][i] = P[i, i + m]`` (BW + 1, T', lanes). This is its ``cpu``
    implementation, the plain version."""
    x = _banded_cholesky_solve(b, list(bands.unbind(0)), bands.shape[0] - 1)
    return no_alias((x,), (b, bands))[0]


@mlpg_solve.register_kernel('cuda')
def _mlpg_solve_op_cuda(b, bands):
    return _mlpg_solve_cuda(b, bands)


@mlpg_solve.register_fake
def _mlpg_solve_fake(b, bands):
    return torch.empty_like(b)


def banded_system(means, variances, windows=DEFAULT_WINDOWS, padding_size=0, seq_len=None):
    """The banded systems that :func:`mlpg` solves, one a (batch x feature)
    lane: ``(b, bands, seq_len)``, b (T', B*D) and bands (BW + 1, T', B*D)
    as :func:`mlpg_solve` takes them, T' = T + 2 * ``padding_size``, and
    ``seq_len`` as a (B,) int64 tensor."""
    batch, num_frames, total_dim = means.shape
    num_windows = len(windows)
    feat_dim = total_dim // num_windows
    device = means.device
    variances = torch.as_tensor(variances, dtype=means.dtype, device=device).expand(means.shape)

    if seq_len is None:
        seq_len = torch.full((batch,), num_frames, dtype=torch.long, device=device)
    else:
        seq_len = torch.as_tensor(seq_len, device=device).reshape(batch).long()

    bandwidth = max(l + u for l, u, _ in windows)
    pad = int(padding_size)
    tp = num_frames + 2 * pad

    # Edge-replicated gather of positions -pad .. T+pad-1 clamped to
    # [0, seq_len-1]: the reference's crop to seq_len plus edge padding.
    pos = torch.arange(-pad, num_frames + pad, device=device)
    idx = torch.minimum(pos[None, :].clamp(min=0), (seq_len - 1)[:, None]).clamp(min=0)
    idx = idx[:, :, None].expand(batch, tp, total_dim)
    means_p = torch.gather(means, 1, idx)
    vars_p = torch.gather(variances, 1, idx)

    # (B, T', W, D) -> (T', B*D, W): time leads, so a step reads one row.
    def to_lanes(x):
        x = x.reshape(batch, tp, num_windows, feat_dim).permute(1, 0, 3, 2)
        return x.reshape(tp, batch * feat_dim, num_windows)

    means_l = to_lanes(means_p)
    taus_l = 1.0 / to_lanes(vars_p)

    # Solve boundary per lane in buffer coordinates; experts past it carry no
    # precision.
    valid = torch.repeat_interleave(seq_len + 2 * pad, feat_dim)       # (B*D,)
    pos_t = torch.arange(tp, device=device)[:, None]                   # (T', 1)
    taus_l = torch.where((pos_t < valid[None, :])[:, :, None], taus_l, 0.)

    b, p_band = _build_banded_poe(means_l * taus_l, taus_l, windows, bandwidth)
    inside = pos_t < valid[None, :]
    b = torch.where(inside, b, 0.)
    bands = [torch.where(inside, p_band[0], 1.)]
    for m in range(1, bandwidth + 1):
        bands.append(torch.where(pos_t + m < valid[None, :], p_band[m], 0.))
    return b.contiguous(), torch.stack(bands), seq_len


def _flat_windows(windows):
    """Windows as the op's schema takes them: every tap in one list, and
    (l, u) of each window in another."""
    coeffs, bounds = [], []
    for l, u, taps in windows:
        if len(taps) != l + u + 1:
            raise ValueError(f'a window (l={l}, u={u}) needs {l + u + 1} taps, got {len(taps)}')
        coeffs += [float(c) for c in taps]
        bounds += [int(l), int(u)]
    return coeffs, bounds


def _windows(coeffs, bounds):
    """The windows back from :func:`_flat_windows`."""
    out, start = [], 0
    for l, u in zip(bounds[::2], bounds[1::2]):
        out.append((l, u, tuple(coeffs[start:start + l + u + 1])))
        start += l + u + 1
    return tuple(out)


def _mlpg_plain(means, variances, seq_len, padding_size, windows):
    """The plain path: the banded systems, the plain loop, the unpad."""
    batch, num_frames, total_dim = means.shape
    feat_dim = total_dim // len(windows)
    b, bands, seq_len = banded_system(means, variances, windows, padding_size, seq_len)
    traj = _banded_cholesky_solve(b, list(bands.unbind(0)), bands.shape[0] - 1)   # (T', B*D)
    pad = int(padding_size)
    traj = traj.reshape(-1, batch, feat_dim).permute(1, 0, 2)[:, pad:pad + num_frames]
    mask = (torch.arange(num_frames, device=means.device)[None, :] < seq_len[:, None])[:, :, None]
    return torch.where(mask, traj, 0.).to(means.dtype)


# The windows the kernel takes: at most MAX_WINDOWS, l + u <= MAX_BANDWIDTH;
# DEFAULT_WINDOWS, the acoustic models', are compiled into a build of their own.
MAX_WINDOWS = 8
_TAPS = MAX_BANDWIDTH + 1
_DEFAULT = _windows(*_flat_windows(DEFAULT_WINDOWS))
# The types of seq_len the kernel reads (a float length truncated, as
# .long() does: the models' collated n_frames are float32).
_SEQ_KINDS = {torch.int32: 0, torch.int64: 1, torch.float32: 2}


@functools.lru_cache(maxsize=None)
def _taps(windows):
    """The windows as morgana_mlpg takes them (ctypes arrays, built once):
    (l, u) of each, its taps c_a, and the products c_a c_{a+p}."""
    num_windows = len(windows)
    lu = (ctypes.c_int * (2 * num_windows))(*[v for l, u, _ in windows for v in (l, u)])
    coeffs = (ctypes.c_float * (num_windows * _TAPS))()
    products = (ctypes.c_float * (num_windows * _TAPS * _TAPS))()
    for w, (_, _, taps) in enumerate(windows):
        for a, c in enumerate(taps):
            coeffs[w * _TAPS + a] = float(c)
        for p in range(len(taps)):
            for a in range(len(taps) - p):
                # As torch rounds c_a * c_{a+p} (a Python float) times an f32 tensor.
                products[(w * _TAPS + p) * _TAPS + a] = float(taps[a]) * float(taps[a + p])
    return lu, coeffs, products


def _mlpg_cuda(means, variances, seq_len, padding_size, windows):
    """Launches ``csrc/mlpg.cu``'s whole MLPG on PyTorch's current stream:
    the systems formed from ``means`` and ``variances`` (read through its
    strides), the solve and the unpadded, masked (B, T, D) trajectory, one
    launch; raises on anything it does not take, and on a refused or failed
    launch."""
    global launches, fused_launches
    if means.ndim != 3:
        raise ValueError(f'mlpg: means must be (batch, time, W * D), got {tuple(means.shape)}')
    batch, num_frames, total_dim = means.shape
    num_windows = len(windows)
    bandwidth = max(l + u for l, u, _ in windows)
    if bandwidth > MAX_BANDWIDTH or num_windows > MAX_WINDOWS or total_dim % num_windows:
        raise ValueError(f'mlpg: the kernel takes up to {MAX_WINDOWS} windows of bandwidths up '
                         f'to {MAX_BANDWIDTH} over W * D features, got {num_windows} of '
                         f'bandwidth {bandwidth} over {total_dim}')
    feat_dim = total_dim // num_windows
    check_operands('mlpg', {'means': (means, tuple(means.shape))}, means.device)
    if (variances.shape != means.shape or variances.dtype != torch.float32
            or variances.device != means.device):
        raise ValueError(f'mlpg: variances must be float32 {tuple(means.shape)} on '
                         f'{means.device} (any strides), got {variances.dtype} '
                         f'{tuple(variances.shape)} on {variances.device}')
    if seq_len is not None and (seq_len.shape != (batch,) or seq_len.device != means.device
                                or seq_len.dtype not in _SEQ_KINDS
                                or not seq_len.is_contiguous()):
        raise ValueError(f'mlpg: seq_len must be a contiguous int32, int64 or float32 '
                         f'({batch},) on {means.device}, got {seq_len.dtype} '
                         f'{tuple(seq_len.shape)} on {seq_len.device}')
    out = means.new_empty((batch, num_frames, feat_dim))
    if not out.numel():
        return out
    pad = int(padding_size)
    lanes = batch * feat_dim
    lu, coeffs, products = _taps(windows)
    lib, fn = load_library('mlpg', 'morgana_mlpg',
                           [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_longlong] * 3
                           + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    scratch = _scratch(lib, num_frames + 2 * pad, lanes, bandwidth, means.device)
    with torch.cuda.device(means.device):
        err = fn(means.data_ptr(), variances.data_ptr(), *variances.stride(),
                 None if seq_len is None else seq_len.data_ptr(),
                 0 if seq_len is None else _SEQ_KINDS[seq_len.dtype], out.data_ptr(),
                 scratch.data_ptr(), batch, num_frames, feat_dim, pad, num_windows, lu, coeffs,
                 products, bandwidth, int(windows == _DEFAULT), means.device.index,
                 torch.cuda.current_stream(means.device).cuda_stream)
    raise_on_error(lib, err, f'MLPG kernel launch at B={batch} T={num_frames} D={feat_dim} '
                   f'padding={pad} BW={bandwidth}', '32 segments a lane, 8 lanes a block')
    launches += 1
    fused_launches += 1
    return out


@torch.library.custom_op('morgana::mlpg', mutates_args=(), device_types='cpu')
def mlpg_op(means: torch.Tensor, variances: torch.Tensor, seq_len: Optional[torch.Tensor],
            padding_size: int, coeffs: List[float], bounds: List[int]) -> torch.Tensor:
    """``morgana::mlpg``: the (B, T, D) trajectory of :func:`mlpg` from the
    (B, T, W * D) ``means``, ``variances`` of the same shape (any strides),
    ``seq_len`` (B,) or None, and the windows as :func:`_flat_windows` gives
    them. This is its ``cpu`` implementation, the plain path."""
    out = _mlpg_plain(means, variances, seq_len, padding_size, _windows(coeffs, bounds))
    return no_alias((out,), (means, variances))[0]


@mlpg_op.register_kernel('cuda')
def _mlpg_op_cuda(means, variances, seq_len, padding_size, coeffs, bounds):
    return _mlpg_cuda(means, variances, seq_len, padding_size, _windows(coeffs, bounds))


@mlpg_op.register_fake
def _mlpg_op_fake(means, variances, seq_len, padding_size, coeffs, bounds):
    batch, num_frames, total_dim = means.shape
    return means.new_empty((batch, num_frames, total_dim // (len(bounds) // 2)))


def mlpg(means, variances, windows=DEFAULT_WINDOWS, padding_size=0, seq_len=None):
    r"""Batched MLPG on the device of ``means`` (``ops/mlpg.py:201``): one
    call of ``morgana::mlpg``, on a CUDA tensor one launch.

    Parameters
    ----------
    means : torch.Tensor, shape (batch, time, num_windows * feat_dim)
        Window-ordered ``[static | delta | delta-delta]`` means.
    variances : broadcastable to ``means``: (batch, time, W*D), (time, W*D)
        or (W*D,).
    windows : tuple of (l, u, coeffs)
    padding_size : int
        Edge burn-in frames replicating the first and last valid frame.
    seq_len : (batch,), optional
        Valid lengths: each item solves exactly its own cropped system (rows
        past it are decoupled identity rows) and frames past it are zero.

    Returns
    -------
    torch.Tensor, shape (batch, time, feat_dim)
    """
    check_device('MLPG solve', means)
    means = means.contiguous()
    variances = torch.as_tensor(variances, dtype=means.dtype, device=means.device)
    if seq_len is not None:
        seq_len = torch.as_tensor(seq_len, device=means.device).reshape(means.shape[0])
        if seq_len.dtype not in _SEQ_KINDS:
            seq_len = seq_len.long()
    coeffs, bounds = _flat_windows(windows)
    return torch.ops.morgana.mlpg(means, variances.expand(means.shape), seq_len,
                                  int(padding_size), coeffs, bounds)
