"""Delta (dynamic) features for the host data pipeline (counterpart of
``morgana_tpu/ops/deltas.py``).

The standard SPSS windows, also MLPG's defaults::

    static:      [1.0]
    delta:       [-0.5, 0.0, 0.5]
    delta-delta: [1.0, -2.0, 1.0]
"""
import numpy as np

__all__ = ['DEFAULT_WINDOWS', 'compute_deltas']

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
