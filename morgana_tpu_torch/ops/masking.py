"""Sequence masks for padded batches (counterpart of
``morgana_tpu/ops/masking.py``)."""
import torch

__all__ = ['sequence_mask']


def sequence_mask(seq_len, max_len=None, dtype=torch.float32):
    r"""Mask of shape ``(batch_size, max_len, 1)``: 1 where the position is
    inside the sequence (``morgana_tpu/ops/masking.py:18``).

    ``seq_len`` is ``(batch,)`` or ``(batch, 1)``; ``max_len`` defaults to its
    maximum.
    """
    seq_len = torch.as_tensor(seq_len)
    if seq_len.ndim == 2:
        seq_len = seq_len[:, 0]
    if max_len is None:
        max_len = int(seq_len.max())
    positions = torch.arange(max_len, device=seq_len.device)
    mask = positions[None, :] < seq_len[:, None]
    return mask[:, :, None].to(dtype)
