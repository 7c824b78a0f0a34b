"""Model abstraction for serving (counterpart of
``morgana_tpu/base_models.py``): a model is an ``nn.Module`` with
``normaliser_sources``, data sources and ``predict``; its ``normalisers``
are set by the caller (``serve.InferenceEngine``)."""
from torch import nn

from morgana_tpu_torch import checkpointing
from morgana_tpu_torch.nn import load_jax_params

__all__ = ['BaseModel', 'BaseSPSS']


class BaseModel(nn.Module):
    r"""Abstract model (``base_models.py:24``).

    Attributes
    ----------
    normalisers : dict[str, normaliser]
        Filled from :meth:`normaliser_sources` with loaded parameters.
    """

    def __init__(self):
        super().__init__()
        self.normalisers = {}

    def normaliser_sources(self):
        r"""The normalisers the data sources use, by feature name."""
        return {}

    def train_data_sources(self):
        r"""The data loaded for training (dict of ``_DataSource``)."""
        raise NotImplementedError

    def valid_data_sources(self):
        return self.train_data_sources()

    def test_data_sources(self):
        return self.valid_data_sources()

    def predict(self, features):
        r"""Output features of one collated batch of tensors."""
        raise NotImplementedError('Prediction must be implemented in a subclass.')

    def load_parameters(self, checkpoint_path):
        r"""Loads an ``epoch_{N}.npz`` saved by the JAX package (strict names
        and shapes); returns the state dict read."""
        sd = checkpointing.load_state_dict(checkpoint_path)
        load_jax_params(self, sd)
        return sd


class BaseSPSS(BaseModel):
    r"""Abstract SPSS acoustic model (``base_models.py:124``)."""
