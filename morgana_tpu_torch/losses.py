"""Masked sequence losses (the ``losses`` API path of the JAX package): a
re-export of :mod:`morgana_tpu_torch.ops.losses`."""
from morgana_tpu_torch.ops.losses import (  # noqa: F401
    sequence_loss, mse, bce, ce, kld_standard_normal, KLD_standard_normal,
)

__all__ = ['sequence_loss', 'mse', 'bce', 'ce', 'kld_standard_normal', 'KLD_standard_normal']
