"""Multi-speaker F0 model: one network for every speaker's lf0, each speaker
keeping their own mean and variance through a speaker-dependent normaliser
(counterpart of the repo's ``models/multispeaker_f0.py``).

Linear(9->4H) + Sigmoid, GRU(4H->H), Linear(H->1), H = 64 by default, on the
normalised frame counters; the target is the per-speaker normalised lf0.
It trains on the masked MSE in normalised space, its metric the RMSE there.
The corpus adds a ``speaker_id/{utt}.txt`` file per utterance, a
``speakers.scp`` list and ``{norm_dir}/{speaker_id}/lf0_mvn.json``
(``morgana_tpu_torch.data.synthetic.generate_voice_data(speakers=[...])``
writes all three). Train it with::

    python -m morgana_tpu_torch.models.multispeaker_f0 --experiment_name NAME \\
        --data_root DATA --train_id_list train/train_file_id_list.scp \\
        --valid_id_list valid/valid_file_id_list.scp --end_epoch 50 [--device cpu]

On the GPU its GRU layer is kernel K3 forward and K4 backward (K3c and K4c
under ``--compute_dtype bfloat16``).
"""
from morgana_tpu_torch import data
from morgana_tpu_torch import losses
from morgana_tpu_torch import metrics
from morgana_tpu_torch import nn
from morgana_tpu_torch import utils
from morgana_tpu_torch.base_models import BaseSPSS
from morgana_tpu_torch.data import data_sources
from morgana_tpu_torch.experiment_builder import ExperimentBuilder

__all__ = ['MultiSpeakerF0Model', 'main']


class MultiSpeakerF0Model(BaseSPSS):
    """Parameters as the JAX model's (``models/multispeaker_f0.py:30-44``).
    ``rnn_backend`` 'scan' and 'pallas' both run K3 and K4 on the GPU."""

    def __init__(self, dropout_prob=0., hidden=64, rnn_backend='scan', generator=None):
        super().__init__()
        self.layers = nn.SequentialWithRecurrent(
            nn.Linear(9, 4 * hidden, generator=generator),
            nn.Sigmoid(),
            nn.Dropout(p=dropout_prob),
            nn.Recurrent('gru', 4 * hidden, hidden, backend=rnn_backend, generator=generator),
            nn.Dropout(p=dropout_prob),
            nn.Linear(hidden, 1, generator=generator),
        )
        # Normalised-space RMSE: denormalising needs the host-side speaker
        # ids, which a step's device batch does not carry.
        self.metrics.add_metrics('all', RMSE_norm=metrics.RMSE())

    def normaliser_sources(self):
        return {
            'counters': data.MinMaxNormaliser('counters'),
            'lf0': data.SpeakerDependentMeanVarianceNormaliser('lf0', 'speakers.scp'),
        }

    def train_data_sources(self):
        return {
            'speaker_id': data_sources.StringSource('speaker_id'),
            'n_frames': data_sources.TextSource('n_frames', sentence_level=True),
            'counters': data_sources.NumpyBinarySource('counters'),
            'lf0': data_sources.NumpyBinarySource('lf0'),
            'vuv': data_sources.NumpyBinarySource('vuv'),
        }

    def predict(self, features):
        """The normalised lf0; also the lf0 itself, denormalised per row on
        the host, when ``features['speaker_id']`` is the collated list of
        ids (``models/multispeaker_f0.py:63-72``)."""
        pred = self.layers(features['normalised_counters'], seq_len=features['n_frames'])
        outputs = {'normalised_lf0': pred}
        if isinstance(features.get('speaker_id'), list):
            outputs['lf0'] = self.normalisers['lf0'].denormalise(utils.to_numpy(pred),
                                                                 features['speaker_id'])
        return outputs

    def loss(self, features, output_features):
        loss = losses.mse(output_features['normalised_lf0'], features['normalised_lf0'],
                          features['n_frames'])
        self.metrics.accumulate(self.mode,
                                RMSE_norm=(features['normalised_lf0'],
                                           output_features['normalised_lf0'],
                                           features['n_frames']))
        return loss


def main(argv=None):
    """The training CLI (``models/multispeaker_f0.py:88``)."""
    args = ExperimentBuilder.get_experiment_args(argv)
    experiment = ExperimentBuilder(MultiSpeakerF0Model, **args)
    experiment.run_experiment()


if __name__ == '__main__':
    main()
