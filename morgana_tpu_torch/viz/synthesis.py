"""Fused-stream MLPG (counterpart of ``morgana_tpu/viz/synthesis.py``)."""
import torch

from morgana_tpu_torch.ops.mlpg import DEFAULT_WINDOWS, mlpg

__all__ = ['MLPG_streams', 'DEFAULT_WINDOWS']


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
