"""Model abstraction (counterpart of ``morgana_tpu/base_models.py``): a model
is an ``nn.Module`` with ``normaliser_sources``, data sources, ``predict``
and ``loss``. Its ``normalisers`` are set by the caller (the experiment
builder or ``serve.InferenceEngine``); ``mode``, ``metrics`` and ``step`` are
kept by the experiment builder."""
import os

from torch import nn

from morgana_tpu_torch import checkpointing
from morgana_tpu_torch import metrics
from morgana_tpu_torch.nn import load_jax_params, state_dict

__all__ = ['BaseModel', 'BaseSPSS']


class BaseModel(nn.Module):
    r"""Abstract model (``base_models.py:24``).

    Attributes
    ----------
    normalisers : dict[str, normaliser]
        Filled from :meth:`normaliser_sources` with loaded parameters.
    mode : {'', 'train', 'valid', 'test'}
    metrics : morgana_tpu_torch.metrics.Handler
    step : int
        Global step kept by the experiment builder.
    """

    def __init__(self):
        super().__init__()
        self.normalisers = {}
        self.mode = ''
        self.metrics = metrics.Handler(loss=metrics.Mean())
        self.step = 0

    def finalise_init(self):
        r"""Called at the end of the experiment builder's ``__init__``, when the
        normalisers are loaded."""

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

    def forward(self, features):
        r"""Computation including loss. Returns ``(loss, output_features)``."""
        raise NotImplementedError('Forward computation must be implemented in a subclass.')

    def predict(self, features):
        r"""Output features of one collated batch of tensors."""
        raise NotImplementedError('Prediction must be implemented in a subclass.')

    def loss(self, features, output_features):
        r"""Loss used to train the model. Wrap frame-level losses with
        ``morgana_tpu_torch.losses.sequence_loss`` to mask padding."""
        raise NotImplementedError('Loss must be implemented in a subclass.')

    def save_parameters(self, experiment_dir, epoch):
        r"""Saves the parameters to ``{experiment_dir}/checkpoints/epoch_{epoch}.npz``
        by the JAX package's names; the JAX package loads the file as its
        own. Returns the path."""
        path = os.path.join(experiment_dir, 'checkpoints', f'epoch_{epoch}.npz')
        return checkpointing.save_state_dict(state_dict(self), path)

    def load_parameters(self, checkpoint_path):
        r"""Loads an ``epoch_{N}.npz`` saved by either package (strict names
        and shapes); returns the state dict read."""
        sd = checkpointing.load_state_dict(checkpoint_path)
        load_jax_params(self, sd)
        return sd

    # Analysis hooks (``base_models.py:105-121``); each falls through test ->
    # valid -> train. The builder and ``serve.InferenceEngine.generate`` pass
    # their ``analysis_kwargs`` (e.g. ``sample_rate``) as keywords.

    def analysis_for_train_batch(self, features, output_features, out_dir, **kwargs):
        pass

    def analysis_for_valid_batch(self, features, output_features, out_dir, **kwargs):
        self.analysis_for_train_batch(features, output_features, out_dir, **kwargs)

    def analysis_for_test_batch(self, features, output_features, out_dir, **kwargs):
        self.analysis_for_valid_batch(features, output_features, out_dir, **kwargs)

    def analysis_for_train_epoch(self, out_dir, **kwargs):
        pass

    def analysis_for_valid_epoch(self, out_dir, **kwargs):
        self.analysis_for_train_epoch(out_dir, **kwargs)

    def analysis_for_test_epoch(self, out_dir, **kwargs):
        self.analysis_for_valid_epoch(out_dir, **kwargs)


class BaseSPSS(BaseModel):
    r"""Abstract SPSS acoustic model: ``forward = loss(features,
    predict(features))`` (``base_models.py:124``)."""

    def forward(self, features):
        output_features = self.predict(features)
        loss = self.loss(features, output_features)
        return loss, output_features
