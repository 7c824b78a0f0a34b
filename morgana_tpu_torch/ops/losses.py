"""Masked sequence losses (counterpart of ``morgana_tpu/ops/losses.py``):
element-wise loss -> per-sequence mean over valid frames (masked) -> mean
over batch and feature dims. No host syncs."""
import functools

import torch

from morgana_tpu_torch.ops.masking import sequence_mask

__all__ = ['sequence_loss', 'mse', 'bce', 'ce', 'kld_standard_normal', 'KLD_standard_normal']

_EPS = 1e-12


def sequence_loss(loss_fn):
    r"""Adds an optional ``seq_len`` masking argument to an element-wise loss
    ``loss_fn(predictions, targets) -> (batch, seq_len, feat_dim)``
    (``ops/losses.py:19``): the mean over valid frames of each sequence, then
    over batch and feature dims."""
    @functools.wraps(loss_fn)
    def wrapped_loss(predictions, targets, seq_len=None):
        feature_loss = loss_fn(predictions, targets)

        if seq_len is None:
            feature_loss = torch.sum(feature_loss, dim=1) / feature_loss.shape[1]
        else:
            mask = sequence_mask(seq_len, max_len=feature_loss.shape[1], dtype=feature_loss.dtype)
            num_valid_frames = torch.sum(mask, dim=1)
            feature_loss = torch.sum(feature_loss * mask, dim=1) / torch.clamp(num_valid_frames, min=1.)

        return torch.mean(feature_loss)

    return wrapped_loss


@sequence_loss
def mse(predictions, targets):
    r"""Masked mean-squared error."""
    return torch.square(predictions - targets)


@sequence_loss
def bce(predictions, targets):
    r"""Masked binary cross-entropy on probabilities, written as the JAX
    package writes it: ``log(max(p, 1e-12))``, clamped at -100 (unlike
    ``torch.nn.functional.binary_cross_entropy``, which has no eps)."""
    log_p = torch.clamp(torch.log(torch.clamp(predictions, min=_EPS)), min=-100.0)
    log_1mp = torch.clamp(torch.log(torch.clamp(1.0 - predictions, min=_EPS)), min=-100.0)
    return -(targets * log_p + (1.0 - targets) * log_1mp)


@sequence_loss
def ce(predictions, targets):
    r"""Masked categorical cross-entropy on logits (batch, seq_len,
    num_classes) against integer class ids (batch, seq_len[, 1])."""
    targets = torch.as_tensor(targets, device=predictions.device)
    if targets.ndim == predictions.ndim:
        targets = targets[..., 0]
    log_probs = predictions - torch.logsumexp(predictions, dim=-1, keepdim=True)
    return -torch.gather(log_probs, -1, targets[..., None].long())


def kld_standard_normal(mean, log_variance):
    r"""KL divergence of N(mean, exp(log_variance)) from N(0, 1), summed over
    the latent dim and averaged over the batch."""
    kld = -0.5 * torch.sum(1. + log_variance - torch.square(mean) - torch.exp(log_variance), dim=-1)
    return torch.mean(kld)


KLD_standard_normal = kld_standard_normal
