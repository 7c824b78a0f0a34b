"""Acoustic model: LSTM stack predicting all vocoder parameter streams
(counterpart of the repo's ``models/rnn_spss.py``).

Linear(609->512) + Sigmoid, 8 x LSTM(512), Linear(512->256) + Sigmoid, then
Linear(256->199) heads (lf0: 3, vuv: 1, mcep: 180, bap: 15) and one fused
MLPG solve over the lf0, mcep and bap streams. It trains on the masked MSE
of the normalised deltas plus the BCE of vuv. Train it with::

    python -m morgana_tpu_torch.models.rnn_spss --experiment_name NAME \
        --data_root DATA --train_id_list train/train_file_id_list.scp \
        --valid_id_list valid/valid_file_id_list.scp --end_epoch 50 [--device cpu]

Every ``--valid_output_interval`` epochs (default 10) the validation analysis
synthesises each utterance's wav from the predicted features with the WORLD
vocoder into ``valid/epoch_N/synth/``; ``--test`` does the same for the test
set, and so does ``serve.InferenceEngine.generate``.
"""
import os

import numpy as np
import torch

from morgana_tpu_torch import data
from morgana_tpu_torch import losses
from morgana_tpu_torch import metrics
from morgana_tpu_torch import nn
from morgana_tpu_torch import utils
from morgana_tpu_torch import vocoder
from morgana_tpu_torch.base_models import BaseSPSS
from morgana_tpu_torch.data import data_sources
from morgana_tpu_torch.data import file_io
from morgana_tpu_torch.experiment_builder import ExperimentBuilder
from morgana_tpu_torch.ops.sequence import upsample_to_repetitions
from morgana_tpu_torch.viz.synthesis import MLPG_streams

__all__ = ['LSTMAcousticModel', 'main']


class LSTMAcousticModel(BaseSPSS):
    """Parameters as the JAX model's. ``rnn_backend`` 'scan' and 'pallas'
    both run kernel K1 on the GPU (the two JAX backends compute the same
    function); 'pallas' stores the recurrence in bf16 when
    ``MORGANA_PALLAS_STORE=bfloat16``, as the JAX kernels do; 'wavefront' is
    not ported yet. ``rnn_unroll`` is a knob of the
    JAX scan with no counterpart here; it is accepted so that the JAX
    model's ``model_kwargs`` carry over."""

    def __init__(self, input_dim=600 + 9, output_dims=None, dropout_prob=0.,
                 num_layers=8, hidden_size=512, rnn_backend='scan', rnn_unroll=8,
                 generator=None):
        super().__init__()
        if output_dims is None:
            output_dims = {'lf0': 1 * 3, 'vuv': 1, 'mcep': 60 * 3, 'bap': 5 * 3}
        self.output_dims = output_dims

        self.layers = nn.SequentialWithRecurrent(
            nn.Linear(input_dim, hidden_size, generator=generator),
            nn.Sigmoid(),
            nn.Dropout(p=dropout_prob),
            *[nn.Recurrent('lstm', hidden_size, hidden_size, dropout=dropout_prob,
                           backend=rnn_backend, generator=generator)
              for _ in range(num_layers)],
            nn.Linear(hidden_size, 256, generator=generator),
            nn.Sigmoid(),
            nn.Dropout(p=dropout_prob),
            nn.Linear(256, sum(output_dims.values()), generator=generator),
        )

        self.metrics.add_metrics('all',
                                 LF0_RMSE_Hz=metrics.LF0Distortion(),
                                 VUV_accuracy=metrics.Mean(),
                                 MCEP_distortion=metrics.MelCepDistortion(),
                                 BAP_distortion=metrics.Distortion())

    def normaliser_sources(self):
        return {
            'dur': data.MeanVarianceNormaliser('dur'),
            'lab': data.MinMaxNormaliser('lab'),
            'counters': data.MinMaxNormaliser('counters'),
            'lf0': data.MeanVarianceNormaliser('lf0', use_deltas=True),
            'mcep': data.MeanVarianceNormaliser('mcep', use_deltas=True),
            'bap': data.MeanVarianceNormaliser('bap', use_deltas=True),
        }

    def train_data_sources(self):
        return {
            'n_frames': data_sources.TextSource('n_frames', sentence_level=True),
            'dur': data_sources.TextSource('dur'),
            'lab': data_sources.NumpyBinarySource('lab'),
            'counters': data_sources.NumpyBinarySource('counters'),
            'lf0': data_sources.NumpyBinarySource('lf0', use_deltas=True),
            'vuv': data_sources.NumpyBinarySource('vuv'),
            'mcep': data_sources.NumpyBinarySource('mcep', use_deltas=True),
            'bap': data_sources.NumpyBinarySource('bap', use_deltas=True),
        }

    def predict(self, features):
        model_inputs = self.stream_inputs(features)
        n_frames = features['n_frames']
        pred_norm_deltas = self.layers(model_inputs, seq_len=n_frames)

        pred_norm_lf0_deltas, pred_vuv, pred_norm_mcep_deltas, pred_norm_bap_deltas = \
            self._split_heads(pred_norm_deltas)

        # The three streams' MLPG solves run as one batched solve, cut from
        # the gradient as the JAX model's stop_gradient (the reference's
        # .detach()) cuts it: no loss reads the trajectories.
        streams = {}
        for name, pred in (('lf0', pred_norm_lf0_deltas),
                           ('mcep', pred_norm_mcep_deltas),
                           ('bap', pred_norm_bap_deltas)):
            normaliser = self.normalisers[name]
            std_dev = normaliser.fetch_params(deltas=True, like=pred)['std_dev']
            streams[name] = (normaliser.denormalise(pred.detach(), deltas=True), std_dev ** 2)
        with torch.no_grad():
            trajs = MLPG_streams(streams, padding_size=100, seq_len=n_frames)

        return {
            'normalised_lf0_deltas': pred_norm_lf0_deltas,
            'normalised_mcep_deltas': pred_norm_mcep_deltas,
            'normalised_bap_deltas': pred_norm_bap_deltas,
            'lf0': trajs['lf0'],
            'vuv': torch.sigmoid(pred_vuv),
            'mcep': trajs['mcep'],
            'bap': trajs['bap'],
        }

    def _split_heads(self, pred_norm_deltas):
        """Splits the network output into the (lf0, vuv, mcep, bap) heads."""
        sizes = [self.output_dims[n] for n in ['lf0', 'vuv', 'mcep', 'bap']]
        return torch.split(pred_norm_deltas, sizes, dim=-1)

    def stream_inputs(self, features):
        """Frame-rate network inputs: phone labels upsampled by duration,
        concatenated with the frame-level counters."""
        max_n_frames = features['normalised_counters'].shape[1]
        norm_lab_at_frame_rate = upsample_to_repetitions(
            features['normalised_lab'], features['dur'], max_len=max_n_frames)
        return torch.cat((norm_lab_at_frame_rate, features['normalised_counters']), dim=-1)

    def loss(self, features, output_features):
        n_frames = features['n_frames']
        vuv = output_features['vuv'] > 0.5

        self.metrics.accumulate(
            self.mode,
            LF0_RMSE_Hz=(features['lf0'], output_features['lf0'], vuv, n_frames),
            VUV_accuracy=((features['vuv'] == vuv).float(), n_frames),
            MCEP_distortion=(features['mcep'], output_features['mcep'], n_frames),
            BAP_distortion=(features['bap'], output_features['bap'], n_frames))

        loss = 0.
        loss += losses.mse(output_features['normalised_lf0_deltas'],
                           features['normalised_lf0_deltas'], n_frames)
        loss += losses.mse(output_features['normalised_mcep_deltas'],
                           features['normalised_mcep_deltas'], n_frames)
        loss += losses.mse(output_features['normalised_bap_deltas'],
                           features['normalised_bap_deltas'], n_frames)
        loss += losses.bce(output_features['vuv'].float(), features['vuv'].float(), n_frames)
        return loss / 4.

    def analysis_for_valid_batch(self, features, output_features, out_dir, sample_rate=16000,
                                 **kwargs):
        """Synthesises ``{out_dir}/synth/{name}.wav`` for each utterance from
        its predicted features (``models/rnn_spss.py:195-217``): f0 is the
        smoothed ``exp(lf0)``, voiced where ``vuv > 0.5``; the mcep and bap
        go through :func:`vocoder.synthesize_world_feats` on the host."""
        kwargs['sample_rate'] = sample_rate
        super().analysis_for_valid_batch(features, output_features, out_dir, **kwargs)

        synth_dir = os.path.join(out_dir, 'synth')
        os.makedirs(synth_dir, exist_ok=True)
        lf0, vuv, mcep, bap = utils.detach_batched_seqs(
            output_features['lf0'], output_features['vuv'], output_features['mcep'],
            output_features['bap'], seq_len=features['n_frames'])
        for _lf0, _vuv, _mcep, _bap, file_id in zip(lf0, vuv, mcep, bap, features['name']):
            f0 = vocoder.smooth_f0(np.exp(_lf0))
            wav = vocoder.synthesize_world_feats(f0, _vuv > 0.5, _mcep, _bap, sample_rate)
            file_io.save_wav(wav, os.path.join(synth_dir, f'{file_id}.wav'),
                             sample_rate=sample_rate)


def main(argv=None):
    """The training CLI (``models/rnn_spss.py:221``)."""
    args = ExperimentBuilder.get_experiment_args(argv)
    experiment = ExperimentBuilder(LSTMAcousticModel, **args)
    experiment.run_experiment()


if __name__ == '__main__':
    main()
