"""VAE prosody model: a sentence-level latent prosody embedding over lf0
(counterpart of the repo's ``models/vae_prosody.py``).

Encoder: GRU(3->H) over the normalised lf0 deltas, its final state at
``n_frames`` through Linear(H->2z) to the posterior's mean and log-variance.
Decoder: the latent, broadcast over the frames, beside the upsampled labels
and the counters, through Linear(609+z->H) + Sigmoid, GRU(H), Linear(H->3)
to the normalised lf0 deltas, then one lf0 stream through MLPG (no
gradient). The loss is the masked MSE of the deltas plus the KL divergence,
its weight annealed linearly from 0 to ``kld_weight`` over
``kld_anneal_steps`` train steps by the batch's ``global_step``. Train it
with::

    python -m morgana_tpu_torch.models.vae_prosody --experiment_name NAME \\
        --data_root DATA --train_id_list train/train_file_id_list.scp \\
        --valid_id_list valid/valid_file_id_list.scp --end_epoch 50 [--device cpu]

``predict`` decodes the zero latent (or ``features['latent']``); ``--test``
also writes, for each utterance, the lf0 of latents on a sphere around the
prior's mean to ``test/epoch_N/latent_samples/feats/lf0/``. On the GPU both GRU layers
are kernels K3 and K4 (the encoder's state gathered at ``n_frames`` by K3)
and the MLPG is ``morgana::mlpg``.
"""
import os

import torch

from morgana_tpu_torch import data
from morgana_tpu_torch import losses
from morgana_tpu_torch import metrics
from morgana_tpu_torch import nn
from morgana_tpu_torch import sampling
from morgana_tpu_torch.base_models import BaseVAE
from morgana_tpu_torch.data import data_sources
from morgana_tpu_torch.experiment_builder import ExperimentBuilder
from morgana_tpu_torch.ops.sequence import upsample_to_repetitions
from morgana_tpu_torch.viz import io as viz_io
from morgana_tpu_torch.viz.synthesis import MLPG

__all__ = ['VAEProsodyModel', 'main']


class VAEProsodyModel(BaseVAE):
    """Parameters as the JAX model's (``models/vae_prosody.py:31-49``)."""

    def __init__(self, z_dim=16, kld_weight=1., kld_anneal_steps=1000, hidden_size=64,
                 dropout_prob=0., generator=None):
        super().__init__(z_dim=z_dim, kld_weight=kld_weight)
        self.kld_anneal_steps = kld_anneal_steps

        self.encoder_rnn = nn.Recurrent('gru', 3, hidden_size, generator=generator)
        self.encoder_out = nn.Linear(hidden_size, 2 * z_dim, generator=generator)

        self.decoder = nn.SequentialWithRecurrent(
            nn.Linear(600 + 9 + z_dim, hidden_size, generator=generator),
            nn.Sigmoid(),
            nn.Dropout(p=dropout_prob),
            nn.Recurrent('gru', hidden_size, hidden_size, generator=generator),
            nn.Dropout(p=dropout_prob),
            nn.Linear(hidden_size, 3, generator=generator),
        )

        self.metrics.add_metrics('all', LF0_RMSE_Hz=metrics.LF0Distortion())

    def normaliser_sources(self):
        return {
            'dur': data.MeanVarianceNormaliser('dur'),
            'lab': data.MinMaxNormaliser('lab'),
            'counters': data.MinMaxNormaliser('counters'),
            'lf0': data.MeanVarianceNormaliser('lf0', use_deltas=True),
        }

    def train_data_sources(self):
        return {
            'n_frames': data_sources.TextSource('n_frames', sentence_level=True),
            'dur': data_sources.TextSource('dur'),
            'lab': data_sources.NumpyBinarySource('lab'),
            'counters': data_sources.NumpyBinarySource('counters'),
            'lf0': data_sources.NumpyBinarySource('lf0', use_deltas=True),
            'vuv': data_sources.NumpyBinarySource('vuv'),
        }

    def encode(self, features):
        _, h_final = self.encoder_rnn(features['normalised_lf0_deltas'],
                                      seq_len=features['n_frames'])
        stats = self.encoder_out(h_final)
        return stats[:, :self.z_dim], stats[:, self.z_dim:]

    def decode(self, latent, features):
        max_n_frames = features['normalised_counters'].shape[1]
        lab_frames = upsample_to_repetitions(features['normalised_lab'], features['dur'],
                                             max_len=max_n_frames)
        z = latent[:, None, :].expand(lab_frames.shape[:2] + (self.z_dim,))
        inputs = torch.cat((lab_frames, features['normalised_counters'], z), dim=-1)
        pred_norm_lf0_deltas = self.decoder(inputs, seq_len=features['n_frames'])

        # The MLPG is cut from the gradient, as the JAX model's stop_gradient.
        normaliser = self.normalisers['lf0']
        std_dev = normaliser.fetch_params(deltas=True, like=pred_norm_lf0_deltas)['std_dev']
        pred_lf0_deltas = normaliser.denormalise(pred_norm_lf0_deltas.detach(), deltas=True)
        with torch.no_grad():
            pred_lf0 = MLPG(pred_lf0_deltas, std_dev ** 2, padding_size=100,
                            seq_len=features['n_frames'])
        return {'normalised_lf0_deltas': pred_norm_lf0_deltas, 'lf0': pred_lf0}

    def kld_schedule(self, features):
        """The KL weight: linear from 0 to ``kld_weight`` over
        ``kld_anneal_steps`` by ``features['global_step']`` (a device
        scalar: no host sync), ``kld_weight`` without it."""
        if 'global_step' in features:
            return self.kld_weight * torch.clamp(features['global_step'] / self.kld_anneal_steps,
                                                 max=1.0)
        return self.kld_weight

    def loss(self, features, output_features):
        seq_len = features['n_frames']
        recon = losses.mse(output_features['normalised_lf0_deltas'],
                           features['normalised_lf0_deltas'], seq_len)
        kld = losses.kld_standard_normal(output_features['mean'], output_features['log_variance'])
        self.metrics.accumulate(
            self.mode,
            kld=kld.detach().reshape(1, 1, 1),
            LF0_RMSE_Hz=(features['lf0'], output_features['lf0'], features['vuv'], seq_len))
        return recon + self.kld_schedule(features) * kld

    def analysis_for_test_batch(self, features, output_features, out_dir, num_latent_samples=4,
                                latent_radius=1.0, **kwargs):
        """Decodes latents on a sphere of ``latent_radius`` around the prior's
        mean, one per utterance for each of ``num_latent_samples`` seeds
        (a generator on the model's device seeded with the sample's number),
        into ``{out_dir}/latent_samples/feats/lf0/{name}_sample{s}.npy``
        (``models/vae_prosody.py:125-146``)."""
        super().analysis_for_test_batch(features, output_features, out_dir, **kwargs)
        device = next(self.parameters()).device
        batch = data.device_features(features, device)
        sampler = sampling.UniformSphereSurfaceSampler(torch.zeros(self.z_dim, device=device),
                                                       latent_radius)
        sample_dir = os.path.join(out_dir, 'latent_samples')
        os.makedirs(sample_dir, exist_ok=True)
        names = features['name']
        for s in range(num_latent_samples):
            generator = torch.Generator(device=device).manual_seed(s)
            latent = sampler.rsample((len(names),), generator=generator)
            with torch.no_grad():
                out = self.decode(latent, batch)
            viz_io.save_batched_seqs({'lf0': out['lf0']}, [f'{name}_sample{s}' for name in names],
                                     sample_dir, seq_len=batch['n_frames'])


def main(argv=None):
    """The training CLI (``models/vae_prosody.py:149``)."""
    args = ExperimentBuilder.get_experiment_args(argv)
    experiment = ExperimentBuilder(VAEProsodyModel, **args)
    experiment.run_experiment()


if __name__ == '__main__':
    main()
