"""MLPG's public surface (counterpart of ``morgana_tpu/viz/synthesis.py``).

Two backends:

* ``'torch'`` (default): the batched banded Cholesky of
  :mod:`morgana_tpu_torch.ops.mlpg`, float32, on the device of the input;
* ``'numpy'``: an exact float64 banded solve on the host (scipy's
  ``solveh_banded``), :func:`mlpg_numpy`, the golden of the tests.
  ``MLPG(backend='numpy')`` returns float32 like the torch backend; call
  :func:`mlpg_numpy` for float64.
"""
import numpy as np
import torch

from morgana_tpu_torch.ops.mlpg import DEFAULT_WINDOWS, mlpg
from morgana_tpu_torch.utils import to_numpy

__all__ = ['MLPG', 'MLPG_streams', 'mlpg_numpy', 'DEFAULT_WINDOWS']


def MLPG(means, variances, windows=None, padding_size=0, seq_len=None, backend='torch'):
    r"""Maximum-likelihood parameter generation of one feature stream
    (``viz/synthesis.py:31``).

    ``means`` is one sequence ``(time, W*D)`` or a batch ``(batch, time,
    W*D)``; ``variances`` is per frame or a global ``(W*D,)`` vector;
    ``padding_size`` replicates the edge frames as burn-in; ``seq_len``
    masks padded frames. Returns the most probable trajectory, ``(batch,
    time, D)`` (or ``(time, D)`` for one sequence), a tensor on the input's
    device for a tensor input and a numpy array for a numpy one.
    """
    windows = DEFAULT_WINDOWS if windows is None else windows
    if backend not in ('torch', 'numpy'):
        raise ValueError(f"backend must be 'torch' or 'numpy', got {backend!r}")
    is_tensor = isinstance(means, torch.Tensor)
    using_batches = means.ndim == 3

    if backend == 'numpy':
        out = mlpg_numpy(to_numpy(means), to_numpy(variances), windows, padding_size=padding_size,
                         seq_len=None if seq_len is None else np.atleast_1d(to_numpy(seq_len)))
        out = out.astype(np.float32)
        if not using_batches:
            out = out[0]
        return torch.from_numpy(out).to(means.device) if is_tensor else out

    means_t = means if is_tensor else torch.from_numpy(np.asarray(means))
    if means_t.ndim == 2:
        means_t = means_t[None]
    if seq_len is not None and not isinstance(seq_len, torch.Tensor):
        seq_len = torch.from_numpy(np.asarray(seq_len))
    out = mlpg(means_t, variances, windows, int(padding_size), seq_len)
    if not using_batches:
        out = out[0]
    return out if is_tensor else out.numpy()


def MLPG_streams(streams, windows=None, padding_size=0, seq_len=None):
    r"""Runs MLPG for several feature streams in ONE batched solve
    (``viz/synthesis.py:72``).

    ``streams`` maps name -> (means, variances), means shaped
    (batch, time, W * D_name) and variances broadcastable to them. The
    streams share windows, padding and ``seq_len``, so their lanes are
    concatenated along the feature dim and solved together.

    Returns {name: trajectory (batch, time, D_name)}.
    """
    if not streams:
        return {}
    windows = DEFAULT_WINDOWS if windows is None else windows
    num_windows = len(windows)

    means_parts, var_parts, dims = [], [], []
    for means, variances in streams.values():
        batch, time = means.shape[0], means.shape[1]
        d = means.shape[-1] // num_windows
        dims.append(d)
        variances = torch.as_tensor(variances, dtype=means.dtype, device=means.device)
        means_parts.append(means.reshape(batch, time, num_windows, d))
        var_parts.append(variances.expand(means.shape).reshape(batch, time, num_windows, d))

    means_all = torch.cat(means_parts, dim=-1).reshape(batch, time, -1)
    vars_all = torch.cat(var_parts, dim=-1).reshape(batch, time, -1)
    traj = mlpg(means_all, vars_all, windows, int(padding_size), seq_len)

    out, start = {}, 0
    for name, d in zip(streams, dims):
        out[name] = traj[:, :, start:start + d]
        start += d
    return out


def mlpg_numpy(means, variances, windows=DEFAULT_WINDOWS, padding_size=0, seq_len=None):
    r"""Exact float64 MLPG on the host (``viz/synthesis.py:124``): the banded
    product-of-experts natural parameters, built with shift-and-add vector
    ops, solved by scipy's banded Cholesky (``solveh_banded``) for each item
    and feature. Returns float64 ``(batch, time, D)``."""
    from scipy.linalg import solveh_banded

    means = np.asarray(means, np.float64)
    if means.ndim == 2:
        means = means[None]
    batch, num_frames, total_dim = means.shape
    num_windows = len(windows)
    feat_dim = total_dim // num_windows

    variances = np.broadcast_to(np.asarray(variances, np.float64), means.shape)
    seq_len = [num_frames] * batch if seq_len is None else np.atleast_1d(np.asarray(seq_len))
    bandwidth = max(l + u for l, u, _ in windows)

    def pad(x, n):
        if n == 0:
            return x
        return np.concatenate([np.repeat(x[:1], n, 0), x, np.repeat(x[-1:], n, 0)], 0)

    def shifted(x, s):
        """``out[t] = x[t + s]``, zero padded."""
        if s == 0:
            return x
        out = np.zeros_like(x)
        if s > 0:
            out[:-s] = x[s:]
        else:
            out[-s:] = x[:s]
        return out

    out = np.zeros((batch, num_frames, feat_dim))
    for i in range(batch):
        n = int(seq_len[i])
        tn = n + 2 * padding_size
        m_i = pad(means[i, :n], padding_size).reshape(tn, num_windows, feat_dim)
        v_i = pad(variances[i, :n], padding_size).reshape(tn, num_windows, feat_dim)

        tau = 1.0 / v_i
        b_fr = m_i * tau
        b = np.zeros((tn, feat_dim))
        band = np.zeros((bandwidth + 1, tn, feat_dim))
        for w, (l, u, coeffs) in enumerate(windows):
            width = l + u + 1
            for a in range(width):
                ca = float(coeffs[a])
                if ca:
                    b += ca * shifted(b_fr[:, w], l - a)
            for mo in range(bandwidth + 1):
                for a in range(width - mo):
                    c2 = float(coeffs[a]) * float(coeffs[a + mo])
                    if c2:
                        band[mo] += c2 * shifted(tau[:, w], l - a)

        for d in range(feat_dim):
            # Upper banded storage: ab[bw - mo, j] = P[j - mo, j].
            ab = np.zeros((bandwidth + 1, tn))
            for mo in range(bandwidth + 1):
                ab[bandwidth - mo, mo:] = band[mo, :tn - mo, d]
            x = solveh_banded(ab, b[:, d])
            out[i, :n, d] = x[padding_size:padding_size + n]
    return out
