"""F0 model: 3 x GRU(64) regressor of lf0 deltas with MLPG trajectory
smoothing (counterpart of the repo's ``models/f0_test_model.py``).

Linear(609->256) + Sigmoid, GRU(256->64), GRU(64), GRU(64), Linear(64->64) +
Sigmoid, Linear(64->3), then a single-stream MLPG solve of lf0. It trains on
the masked MSE of the normalised lf0 deltas; its metric is the F0 RMSE in
Hz over the frames the target marks voiced. Train it with::

    python -m morgana_tpu_torch.models.f0_test_model --experiment_name NAME \\
        --data_root DATA --train_id_list train/train_file_id_list.scp \\
        --valid_id_list valid/valid_file_id_list.scp --end_epoch 50 \\
        --valid_output_interval 51 [--device cpu]

The validation analysis synthesises wavs with the vocoder, which is not
ported yet, so the builder refuses a ``--valid_output_interval`` that a
trained epoch reaches.
"""
import torch

from morgana_tpu_torch import data
from morgana_tpu_torch import losses
from morgana_tpu_torch import metrics
from morgana_tpu_torch import nn
from morgana_tpu_torch.base_models import BaseSPSS
from morgana_tpu_torch.data import data_sources
from morgana_tpu_torch.experiment_builder import ExperimentBuilder
from morgana_tpu_torch.ops.sequence import upsample_to_repetitions
from morgana_tpu_torch.viz.synthesis import MLPG

__all__ = ['F0Model', 'main']


class F0Model(BaseSPSS):
    """Parameters as the JAX model's (``models/f0_test_model.py:29-52``).
    ``rnn_backend`` 'scan' and 'pallas' both run kernels K3 and K4 on the GPU
    (the two JAX backends compute the same function); 'wavefront' is not
    ported yet. ``rnn_unroll`` is a knob of the JAX scan with no counterpart
    here; it is accepted so that the JAX model's ``model_kwargs`` carry
    over."""

    unported_valid_analysis = ('it synthesises wavs with the WORLD vocoder, which is not '
                               'ported yet')

    def __init__(self, dropout_prob=0., input_dim=600 + 9, output_dim=1 * 3,
                 rnn_backend='scan', rnn_unroll=8, generator=None):
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim

        def gru(in_dim):
            return nn.Recurrent('gru', in_dim, 64, backend=rnn_backend, generator=generator)

        self.layers = nn.SequentialWithRecurrent(
            nn.Linear(self.input_dim, 256, generator=generator),
            nn.Sigmoid(),
            nn.Dropout(p=dropout_prob),
            gru(256),
            nn.Dropout(p=dropout_prob),
            gru(64),
            nn.Dropout(p=dropout_prob),
            gru(64),
            nn.Dropout(p=dropout_prob),
            nn.Linear(64, 64, generator=generator),
            nn.Sigmoid(),
            nn.Dropout(p=dropout_prob),
            nn.Linear(64, self.output_dim, generator=generator),
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
            'n_phones': data_sources.TextSource('n_phones', sentence_level=True),
            'dur': data_sources.TextSource('dur'),
            'lab': data_sources.NumpyBinarySource('lab'),
            'counters': data_sources.NumpyBinarySource('counters'),
            'lf0': data_sources.NumpyBinarySource('lf0', use_deltas=True),
            'vuv': data_sources.NumpyBinarySource('vuv'),
        }

    def valid_data_sources(self):
        sources = self.train_data_sources()
        sources['sp'] = data_sources.NumpyBinarySource('sp')
        sources['ap'] = data_sources.NumpyBinarySource('ap')
        return sources

    def predict(self, features):
        model_inputs = self.stream_inputs(features)
        n_frames = features['n_frames']
        pred_norm_lf0_deltas = self.layers(model_inputs, seq_len=n_frames)

        # The MLPG solve is cut from the gradient, as the JAX model's
        # stop_gradient (the reference's .detach()) cuts it: the loss trains
        # on the normalised deltas and the trajectory feeds the metric only.
        normaliser = self.normalisers['lf0']
        std_dev = normaliser.fetch_params(deltas=True, like=pred_norm_lf0_deltas)['std_dev']
        pred_lf0_deltas = normaliser.denormalise(pred_norm_lf0_deltas.detach(), deltas=True)
        with torch.no_grad():
            pred_lf0 = MLPG(pred_lf0_deltas, std_dev ** 2, padding_size=100, seq_len=n_frames)

        return {
            'normalised_lf0_deltas': pred_norm_lf0_deltas,
            'lf0': pred_lf0,
        }

    def stream_inputs(self, features):
        """Frame-rate network inputs: phone labels upsampled by duration,
        concatenated with the frame-level counters."""
        max_n_frames = features['normalised_counters'].shape[1]
        norm_lab_at_frame_rate = upsample_to_repetitions(
            features['normalised_lab'], features['dur'], max_len=max_n_frames)
        return torch.cat((norm_lab_at_frame_rate, features['normalised_counters']), dim=-1)

    def loss(self, features, output_features):
        seq_len = features['n_frames']
        loss = losses.mse(output_features['normalised_lf0_deltas'],
                          features['normalised_lf0_deltas'], seq_len)
        self.metrics.accumulate(
            self.mode,
            LF0_RMSE_Hz=(features['lf0'], output_features['lf0'], features['vuv'], seq_len))
        return loss

    def analysis_for_valid_batch(self, features, output_features, out_dir, **kwargs):
        raise NotImplementedError(
            f'F0Model.analysis_for_valid_batch: {self.unported_valid_analysis}')


def main(argv=None):
    """The training CLI (``models/f0_test_model.py:174``)."""
    args = ExperimentBuilder.get_experiment_args(argv)
    experiment = ExperimentBuilder(F0Model, **args)
    experiment.run_experiment()


if __name__ == '__main__':
    main()
