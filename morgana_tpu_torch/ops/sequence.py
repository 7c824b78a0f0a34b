"""Variable-length sequence rearrangement on device (counterpart of
``morgana_tpu/ops/sequence.py``)."""
import torch

__all__ = ['upsample_to_repetitions']


def upsample_to_repetitions(sequence_feature, repeats, max_len=None):
    r"""Repeats each sequence item ``repeats`` times along the time axis, as a
    per-item ``np.repeat`` would (``morgana_tpu/ops/sequence.py:20``): phone
    labels to frame rate by duration.

    Parameters
    ----------
    sequence_feature : torch.Tensor, shape (batch_size, max_seq_len, feat_dim)
    repeats : torch.Tensor, shape (batch_size, max_seq_len[, 1])
        Repetitions per item; padded positions must be 0.
    max_len : int, optional
        Output length; defaults to the largest total.

    Returns
    -------
    torch.Tensor, shape (batch_size, max_len, feat_dim)
        Zero past each row's total.
    """
    batch_size, max_seq_len, _ = sequence_feature.shape
    reps = torch.as_tensor(repeats, device=sequence_feature.device)
    reps = reps.reshape(batch_size, max_seq_len).long()

    ends = torch.cumsum(reps, dim=1)           # (B, S): frame where item i ends
    totals = ends[:, -1]
    if max_len is None:
        max_len = int(totals.max())

    positions = torch.arange(max_len, device=ends.device)
    # First i with ends[b, i] > t; the right side also skips zero-length items.
    idx = torch.searchsorted(ends, positions.expand(batch_size, max_len).contiguous(),
                             right=True)
    valid = positions[None, :] < totals[:, None]
    idx = torch.where(valid, idx.clamp(0, max_seq_len - 1), 0)

    gathered = torch.gather(
        sequence_feature, 1,
        idx[:, :, None].expand(batch_size, max_len, sequence_feature.shape[-1]))
    return torch.where(valid[:, :, None], gathered, torch.zeros((), dtype=gathered.dtype,
                                                                 device=gathered.device))
