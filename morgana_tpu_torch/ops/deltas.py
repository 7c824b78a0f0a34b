"""Delta (dynamic) features (counterpart of ``morgana_tpu/ops/deltas.py``):
a NumPy path for the host data pipeline and a batched tensor path for the
device-side normalisation of ``--device_normalise``.

The standard SPSS windows, also MLPG's defaults::

    static:      [1.0]
    delta:       [-0.5, 0.0, 0.5]
    delta-delta: [1.0, -2.0, 1.0]
"""
import numpy as np

__all__ = ['DEFAULT_WINDOWS', 'compute_deltas', 'compute_deltas_torch']

# (left extent, right extent, coefficients).
DEFAULT_WINDOWS = (
    (0, 0, (1.0,)),
    (1, 1, (-0.5, 0.0, 0.5)),
    (1, 1, (1.0, -2.0, 1.0)),
)


def _apply_window_np(feature, l, u, coeffs):
    """Applies one window along the time axis with edge replication."""
    num_frames = feature.shape[0]
    padded = np.concatenate(
        [np.repeat(feature[:1], l, axis=0), feature, np.repeat(feature[-1:], u, axis=0)],
        axis=0)
    out = np.zeros_like(feature)
    for k, c in enumerate(coeffs):
        if c != 0.0:
            out += c * padded[k:k + num_frames]
    return out


def compute_deltas(feature, windows=DEFAULT_WINDOWS):
    r"""``[static, delta, delta-delta]`` of a ``(seq_len, feat_dim)`` track,
    concatenated along the feature dim: ``(seq_len, feat_dim * len(windows))``
    (``morgana_tpu/ops/deltas.py:41``)."""
    feature = np.asarray(feature, dtype=np.float32)
    if feature.ndim == 1:
        feature = feature[:, None]
    outs = [_apply_window_np(feature, l, u, np.asarray(c, np.float32)) for l, u, c in windows]
    return np.concatenate(outs, axis=-1)


def compute_deltas_torch(feature, windows=DEFAULT_WINDOWS, seq_len=None):
    r"""Batched :func:`compute_deltas` on tensors (``ops/deltas.py:63``):
    ``(batch, seq_len, feat_dim)`` to ``(batch, seq_len, feat_dim *
    len(windows))``.

    With ``seq_len`` (``(batch,)``) the edges replicate each item's own last
    frame (index ``seq_len - 1``), as the host path does before padding: one
    gather builds each item's edge-replicated window. Without it the batch's
    padded tail frame is replicated. Frames past ``seq_len`` are not zeroed
    here. The windows' products and sums run in the host path's order, so an
    item's frames are bit-identical to :func:`compute_deltas` of the item.
    """
    import torch

    num_frames = feature.shape[1]
    max_l = max(l for l, _, _ in windows)
    max_u = max(u for _, u, _ in windows)
    if seq_len is not None:
        # Position t in [-max_l, T + max_u) reads frame clip(t, 0, len - 1).
        pos = torch.arange(-max_l, num_frames + max_u, device=feature.device)
        last = torch.as_tensor(seq_len, device=feature.device).reshape(-1, 1).long() - 1
        idx = torch.clamp(torch.minimum(torch.clamp(pos[None, :], min=0), last), min=0)
        gathered = torch.gather(feature, 1,
                                idx[:, :, None].expand(-1, -1, feature.shape[-1]))
    else:
        gathered = torch.cat([feature[:, :1].expand(-1, max_l, -1), feature,
                              feature[:, -1:].expand(-1, max_u, -1)], dim=1)
    outs = []
    for l, _, coeffs in windows:
        acc = torch.zeros_like(feature)
        for k, c in enumerate(coeffs):
            if c != 0.0:
                start = max_l - l + k
                acc = acc + c * gathered[:, start:start + num_frames]
        outs.append(acc)
    return torch.cat(outs, dim=-1)
