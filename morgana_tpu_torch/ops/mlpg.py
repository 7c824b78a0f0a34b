"""Maximum-likelihood parameter generation (MLPG) as a batched banded solve
on device (counterpart of ``morgana_tpu/ops/mlpg.py``).

The Gaussian product-of-experts natural parameters (b, P) are built with
shift-and-add ops over all (batch x feature) lanes at once, and the banded
SPD system ``P x = b`` is solved by a banded Cholesky: three sequential
passes over frames (factorise, forward and back substitution), each step an
elementwise op over the lanes. The arithmetic follows the JAX version step
for step, in float32.

The passes are Python loops of small PyTorch ops, so on the GPU they cost
thousands of launches per batch; the JAX package runs them as ``lax.scan``
with no Pallas kernel, and they stay plain PyTorch here.
"""
import torch

from morgana_tpu_torch.ops.deltas import DEFAULT_WINDOWS

__all__ = ['mlpg', 'DEFAULT_WINDOWS']


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


def mlpg(means, variances, windows=DEFAULT_WINDOWS, padding_size=0, seq_len=None):
    r"""Batched MLPG on the device of ``means`` (``ops/mlpg.py:201``).

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
    traj = _banded_cholesky_solve(b, bands, bandwidth)                 # (T', B*D)

    traj = traj.reshape(tp, batch, feat_dim).permute(1, 0, 2)[:, pad:pad + num_frames]
    mask = (torch.arange(num_frames, device=device)[None, :] < seq_len[:, None])[:, :, None]
    return torch.where(mask, traj, 0.).to(means.dtype)
