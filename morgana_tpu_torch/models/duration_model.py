"""Duration model: linguistic labels -> phone durations, one GRU(128) at the
phone rate (counterpart of the repo's ``models/duration_model.py``), the
first stage of the two-stage TTS pipeline.

Linear(600->128) + Sigmoid, GRU(128), Linear(128->1). It trains on the
masked MSE of the normalised durations; its metric is the duration RMSE in
frames. Its validation analysis writes each utterance's predicted durations
to ``valid/epoch_N/feats/dur/{utt}.npy``, so the builder's default
validation output runs. Train it with::

    python -m morgana_tpu_torch.models.duration_model --experiment_name NAME \\
        --data_root DATA --train_id_list train/train_file_id_list.scp \\
        --valid_id_list valid/valid_file_id_list.scp --end_epoch 50 [--device cpu]
"""
import torch

from morgana_tpu_torch import data
from morgana_tpu_torch import losses
from morgana_tpu_torch import metrics
from morgana_tpu_torch import nn
from morgana_tpu_torch.base_models import BaseSPSS
from morgana_tpu_torch.data import data_sources
from morgana_tpu_torch.experiment_builder import ExperimentBuilder
from morgana_tpu_torch.viz.io import save_batched_seqs

__all__ = ['DurationModel', 'main']


class DurationModel(BaseSPSS):
    """Parameters as the JAX model's (``models/duration_model.py:20-34``);
    the GRU runs kernels K3 and K4 on the GPU."""

    def __init__(self, input_dim=600, hidden_size=128, dropout_prob=0., generator=None):
        super().__init__()
        self.input_dim = input_dim

        self.layers = nn.SequentialWithRecurrent(
            nn.Linear(self.input_dim, hidden_size, generator=generator),
            nn.Sigmoid(),
            nn.Dropout(p=dropout_prob),
            nn.Recurrent('gru', hidden_size, hidden_size, generator=generator),
            nn.Dropout(p=dropout_prob),
            nn.Linear(hidden_size, 1, generator=generator),
        )

        self.metrics.add_metrics('all', dur_RMSE_frames=metrics.RMSE())

    def normaliser_sources(self):
        return {
            'lab': data.MinMaxNormaliser('lab'),
            'dur': data.MeanVarianceNormaliser('dur'),
        }

    def train_data_sources(self):
        return {
            'n_phones': data_sources.TextSource('n_phones', sentence_level=True),
            'dur': data_sources.TextSource('dur'),
            'lab': data_sources.NumpyBinarySource('lab'),
        }

    def predict(self, features):
        pred_norm_dur = self.layers(features['normalised_lab'], seq_len=features['n_phones'])
        return {
            'normalised_dur': pred_norm_dur,
            'dur': self.normalisers['dur'].denormalise(pred_norm_dur),
        }

    def loss(self, features, output_features):
        n_phones = features['n_phones']
        self.metrics.accumulate(
            self.mode,
            dur_RMSE_frames=(features['dur'].float(), output_features['dur'], n_phones))
        return losses.mse(output_features['normalised_dur'], features['normalised_dur'], n_phones)

    def analysis_for_valid_batch(self, features, output_features, out_dir, **kwargs):
        """Writes each utterance's predicted durations (frames, unrounded) to
        ``{out_dir}/feats/dur/{utt}.npy``."""
        save_batched_seqs({'dur': output_features['dur']}, features['name'], out_dir,
                          seq_len=features['n_phones'])


def main(argv=None):
    """The training CLI (``models/duration_model.py:74``)."""
    args = ExperimentBuilder.get_experiment_args(argv)
    experiment = ExperimentBuilder(DurationModel, **args)
    experiment.run_experiment()


if __name__ == '__main__':
    main()
