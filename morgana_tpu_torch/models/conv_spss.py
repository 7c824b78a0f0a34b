"""Convolutional acoustic model: a dilated residual convolution stack
predicting all vocoder parameter streams (counterpart of the repo's
``models/conv_spss.py``).

The same task, data sources, normalisers, loss, metrics, MLPG and WORLD
analysis hooks as
:class:`~morgana_tpu_torch.models.rnn_spss.LSTMAcousticModel`; only the
network differs: Linear(609->512) + GELU, 6 residual blocks (LayerNorm,
Conv1d(512, k 5, dilations 1, 2, 4, 8, 1, 2), GELU, Dropout), LayerNorm,
Linear(512->256) + Sigmoid, Linear(256->199). Train it with::

    python -m morgana_tpu_torch.models.conv_spss --experiment_name NAME \\
        --data_root DATA --train_id_list train/train_file_id_list.scp \\
        --valid_id_list valid/valid_file_id_list.scp --end_epoch 50 [--device cpu]

``--model_kwargs "{'causal': True}"`` makes every convolution causal, and the
model then streams chunk by chunk (``serve.InferenceEngine.stream_item``),
each convolution carrying its last ``dilation * (k - 1)`` input frames. The
convolutions and products are library calls (the JAX package runs XLA ones
there); on the GPU the MLPG is ``morgana::mlpg``.
"""
import torch

from morgana_tpu_torch import metrics
from morgana_tpu_torch import nn
from morgana_tpu_torch.base_models import BaseSPSS
from morgana_tpu_torch.experiment_builder import ExperimentBuilder
from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel

__all__ = ['ConvAcousticModel', 'main']


class _ResidualConvBlock(torch.nn.Module):
    """LayerNorm -> Conv1d(k, dilated) -> GELU -> Dropout -> + residual
    (``models/conv_spss.py:33``); streams through :meth:`step`."""

    accepts_seq_len = True

    def __init__(self, channels, kernel_size, dilation, dropout_prob, padding, generator=None):
        super().__init__()
        self.norm = nn.LayerNorm(channels)
        self.conv = nn.Conv1d(channels, channels, kernel_size, dilation=dilation, padding=padding,
                              generator=generator)
        self.act = nn.GELU()
        self.drop = nn.Dropout(dropout_prob)

    def forward(self, x, seq_len=None):
        return x + self.drop(self.act(self.conv(self.norm(x), seq_len=seq_len)))

    def init_stream_state(self):
        return None

    def step(self, chunk, state):
        y, state = self.conv.step(self.norm(chunk), state)
        return chunk + self.drop(self.act(y)), state


class ConvAcousticModel(LSTMAcousticModel):
    """Parameters and keyword arguments as the JAX model's
    (``models/conv_spss.py:68-121``), so that its checkpoints and
    ``model_kwargs`` carry over. Streaming the default (same-padded)
    configuration raises in its first convolution's ``step``."""

    def __init__(self, input_dim=600 + 9, output_dims=None, dropout_prob=0., num_layers=6,
                 hidden_size=512, kernel_size=5, causal=False, generator=None):
        if output_dims is None:
            output_dims = {'lf0': 1 * 3, 'vuv': 1, 'mcep': 60 * 3, 'bap': 5 * 3}
        # LSTMAcousticModel.__init__ would build the LSTM stack.
        BaseSPSS.__init__(self)
        self.input_dim = input_dim
        self.output_dims = output_dims
        self.dropout_prob = dropout_prob
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.kernel_size = kernel_size
        self.causal = bool(causal)

        padding = 'causal' if causal else 'same'
        blocks = [_ResidualConvBlock(hidden_size, kernel_size, dilation=2 ** (i % 4),
                                     dropout_prob=dropout_prob, padding=padding,
                                     generator=generator)
                  for i in range(num_layers)]
        self.layers = nn.SequentialWithRecurrent(
            nn.Linear(input_dim, hidden_size, generator=generator),
            nn.GELU(),
            nn.Dropout(p=dropout_prob),
            *blocks,
            nn.LayerNorm(hidden_size),
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


def main(argv=None):
    """The training CLI (``models/conv_spss.py:124``)."""
    args = ExperimentBuilder.get_experiment_args(argv)
    experiment = ExperimentBuilder(ConvAcousticModel, **args)
    experiment.run_experiment()


if __name__ == '__main__':
    main()
