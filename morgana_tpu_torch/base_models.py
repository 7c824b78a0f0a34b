"""Model abstraction (counterpart of ``morgana_tpu/base_models.py``): a model
is an ``nn.Module`` with ``normaliser_sources``, data sources, ``predict``
and ``loss``. Its ``normalisers`` are set by the caller (the experiment
builder or ``serve.InferenceEngine``); ``mode``, ``metrics`` and ``step`` are
kept by the experiment builder."""
import os

import torch
from torch import nn

from morgana_tpu_torch import checkpointing
from morgana_tpu_torch import metrics
from morgana_tpu_torch.nn import load_jax_params, state_dict

__all__ = ['BaseModel', 'BaseSPSS', 'BaseVAE']


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
    tensorboard : torch.utils.tensorboard.SummaryWriter or None
        The experiment builder's writer (None without the ``tensorboard``
        package or outside the builder).
    """

    def __init__(self):
        super().__init__()
        self.normalisers = {}
        self.mode = ''
        self.metrics = metrics.Handler(loss=metrics.Mean())
        self.step = 0
        self.tensorboard = None

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

    # The streaming contract (``base_models.py:133-170``): a model that
    # implements all three is driven chunk by chunk by
    # ``serve.StreamingSession``.

    def _no_streaming(self):
        return NotImplementedError(f'{type(self).__name__} does not implement streaming '
                                   '(stream_inputs/stream_step/stream_output_spec).')

    def stream_inputs(self, features):
        r"""The frame-rate network inputs ``(batch, max_frames, D_in)`` of a
        collated batch of tensors: ``predict``'s input preparation, so that
        the network can then run chunk by chunk."""
        raise self._no_streaming()

    def stream_step(self, inputs_chunk, state):
        r"""The network on one ``(batch, chunk, D_in)`` slice of
        :meth:`stream_inputs`' output. ``state`` is ``None`` for the first
        chunk, then what the previous call returned. Returns
        ``(outputs, new_state)``, each output ``(batch, chunk, D)``."""
        raise self._no_streaming()

    def stream_output_spec(self):
        r"""What the stream emits: ``{name: None | (means_key, variances,
        padding_size)}``. ``None`` passes ``outputs[name]`` through; a tuple
        smooths ``outputs[means_key]`` by a
        :class:`morgana_tpu_torch.streaming.StreamingMLPG` with those global
        variances and edge burn-in, emitted as ``name``."""
        raise self._no_streaming()


class BaseVAE(BaseSPSS):
    r"""Abstract VAE whose decoder is an SPSS model (``base_models.py:175``).

    The posterior sample's noise is drawn from ``self.generator`` (the
    default generator of the device when it is None), which the trainer sets
    at every train and eval step, seeded from the run's seed and the step
    count, as it sets the ``Dropout`` layers' (not the JAX package's bits).

    Parameters
    ----------
    z_dim : int
        Latent dimensionality.
    kld_weight : float
        Weight of the KL divergence term.
    """

    def __init__(self, z_dim=16, kld_weight=1.):
        super().__init__()
        self.z_dim = z_dim
        self.kld_weight = kld_weight
        self.generator = None
        self.metrics.add_metrics('all', kld=metrics.Mean())

    def encode(self, features):
        r"""Returns ``(mean, log_variance)``, each (batch, z_dim)."""
        raise NotImplementedError('Encoder must be implemented in a subclass.')

    def sample(self, mean, log_variance):
        r"""One reparameterised sample from the approximate posterior."""
        noise = torch.randn(mean.shape, generator=self.generator, dtype=mean.dtype,
                            device=mean.device)
        return mean + torch.exp(log_variance * 0.5) * noise

    def decode(self, latent, features):
        r"""Returns reconstruction output features."""
        raise NotImplementedError('Decoder must be implemented in a subclass.')

    def forward(self, features):
        mean, log_variance = self.encode(features)
        latent_sample = self.sample(mean, log_variance)
        output_features = self.decode(latent_sample, features)
        output_features['latent'] = latent_sample
        output_features['mean'] = mean
        output_features['log_variance'] = log_variance
        return self.loss(features, output_features), output_features

    def predict(self, features):
        r"""Decodes ``features['latent']``, or the zero vector when there is
        none (``base_models.py:219-230``)."""
        latent = features.get('latent')
        if latent is None:
            feature = next(v for v in features.values()
                           if isinstance(v, torch.Tensor) and v.ndim >= 1)
            latent = torch.zeros((feature.shape[0], self.z_dim), device=feature.device)
        return self.decode(latent, features)
