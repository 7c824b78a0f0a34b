"""Transformer acoustic model: a pre-LN self-attention stack predicting all
vocoder parameter streams (counterpart of the repo's
``models/transformer_spss.py``).

The same task, data sources, normalisers, loss, metrics and MLPG as
:class:`~morgana_tpu_torch.models.rnn_spss.LSTMAcousticModel`; only the
network differs: Linear(609->384), Dropout, a TransformerEncoder of 6 blocks
(d_model 384, 4 heads of 96, d_ff 1536, sinusoidal positions, final
LayerNorm), Linear(384->199). On the GPU every block's attention is one
launch of kernel K5/K6 forward (and one of its backward in training). Train
it with::

    python -m morgana_tpu_torch.models.transformer_spss --experiment_name NAME \\
        --data_root DATA --train_id_list train/train_file_id_list.scp \\
        --valid_id_list valid/valid_file_id_list.scp --end_epoch 50 \\
        --learning_rate 0.001 [--device cpu]

``--model_kwargs "{'num_layers': 2}"`` resizes it, ``{'causal': True}``
selects the sliding-window causal configuration (window 256), which also
streams chunk by chunk through per-block KV caches, and ``{'moe_experts':
8}`` makes every second block's FFN a mixture of 8 experts (top-1 routing,
capacity 1.25, balance loss 0.01 in the train loss). Its analysis
hooks are the LSTM model's: the validation analysis and ``--test``
synthesise wavs with the WORLD vocoder.
"""
from morgana_tpu_torch import metrics
from morgana_tpu_torch import nn
from morgana_tpu_torch.base_models import BaseSPSS
from morgana_tpu_torch.experiment_builder import ExperimentBuilder
from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel

__all__ = ['TransformerAcousticModel', 'main']


class TransformerAcousticModel(LSTMAcousticModel):
    """Parameters and keyword arguments as the JAX model's
    (``models/transformer_spss.py:57-157``), so that its checkpoints and
    ``model_kwargs`` carry over. ``attention_backend`` 'auto', 'xla',
    'splash' and 'flash' all run kernel K5/K6 on the GPU. ``moe_experts``
    makes every ``moe_every``-th block's FFN a
    :class:`~morgana_tpu_torch.nn.MoEFeedForward` with ``moe_capacity_factor``
    and ``moe_aux_weight``, on one device. Pipeline, expert and sequence
    parallelism and ``remat`` are not ported yet and raise;
    ``pipeline_microbatches`` only matters with them."""

    def __init__(self, input_dim=600 + 9, output_dims=None, dropout_prob=0.,
                 num_layers=6, d_model=384, num_heads=4, d_ff=None,
                 causal=False, attention_window=None, remat=None,
                 attention_backend='auto', pipeline_stages=None,
                 pipeline_microbatches=8, moe_experts=0, moe_every=2,
                 moe_capacity_factor=1.25, moe_aux_weight=0.01,
                 expert_parallel=False, sequence_parallel=0, generator=None):
        for name, value in (('pipeline_stages', pipeline_stages),
                            ('expert_parallel', expert_parallel),
                            ('sequence_parallel', sequence_parallel)):
            if value:
                raise NotImplementedError(f'TransformerAcousticModel {name}={value!r} '
                                          'is not ported yet (ROADMAP.md)')
        if output_dims is None:
            output_dims = {'lf0': 1 * 3, 'vuv': 1, 'mcep': 60 * 3, 'bap': 5 * 3}
        if d_ff is None:
            d_ff = 4 * d_model
        if causal and attention_window is None:
            attention_window = 256   # the streamable configuration's left context

        # LSTMAcousticModel.__init__ would build the LSTM stack.
        BaseSPSS.__init__(self)
        self.input_dim = input_dim
        self.output_dims = output_dims
        self.dropout_prob = dropout_prob
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.d_ff = d_ff
        self.causal = causal
        self.moe_experts = moe_experts
        self.attention_window = attention_window
        self.attention_backend = attention_backend

        moe = None
        if moe_experts:
            moe = {'num_experts': moe_experts, 'capacity_factor': moe_capacity_factor,
                   'aux_weight': moe_aux_weight}
        encoder = nn.TransformerEncoder(
            num_layers, d_model, num_heads, d_ff, dropout=dropout_prob, causal=causal,
            window=attention_window, remat=remat, attention_backend=attention_backend,
            moe=moe, moe_every=moe_every, generator=generator)
        self.layers = nn.SequentialWithRecurrent(
            nn.Linear(input_dim, d_model, generator=generator),
            nn.Dropout(p=dropout_prob),
            encoder,
            nn.Linear(d_model, sum(output_dims.values()), generator=generator),
        )

        self.metrics.add_metrics('all',
                                 LF0_RMSE_Hz=metrics.LF0Distortion(),
                                 VUV_accuracy=metrics.Mean(),
                                 MCEP_distortion=metrics.MelCepDistortion(),
                                 BAP_distortion=metrics.Distortion())

    def stream_step(self, inputs_chunk, state):
        """Chunked streaming of the causal configuration
        (``models/transformer_spss.py:161-177``): the container carries each
        block's KV caches in the encoder's state slot, so the LSTM model's
        step applies unchanged."""
        if self.moe_experts:
            raise NotImplementedError(
                'streaming with MoE blocks is not supported: expert capacity is computed per '
                'routed window, so chunked routing would not reproduce batch predictions exactly')
        if not self.causal:
            raise NotImplementedError(
                'chunked streaming needs the streamable configuration (model_kwargs '
                "\"{'causal': True}\" — sliding-window causal attention with per-layer KV "
                'caches); the default bidirectional model requires the full utterance. '
                'LSTMAcousticModel streams in any configuration.')
        return LSTMAcousticModel.stream_step(self, inputs_chunk, state)


def main(argv=None):
    """The training CLI (``models/transformer_spss.py:179``)."""
    args = ExperimentBuilder.get_experiment_args(argv)
    experiment = ExperimentBuilder(TransformerAcousticModel, **args)
    experiment.run_experiment()


if __name__ == '__main__':
    main()
