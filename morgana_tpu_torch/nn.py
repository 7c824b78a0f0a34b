"""Layers of the acoustic models, with the JAX package's parameter names and
layouts (counterpart of ``morgana_tpu/nn.py``).

Weights are stored as the JAX package stores them, ``(in, out)`` for
``Linear`` (and the attention projections) and ``(in, gates)`` for
``Recurrent``, so that
:func:`load_jax_params` copies an ``epoch_{N}.npz`` (or
``morgana_tpu.nn.state_dict``) into these modules by name, unchanged, and
:func:`state_dict` writes one back.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from morgana_tpu_torch.ops import attention as attention_ops
from morgana_tpu_torch.ops.flash_attention import attention_bias, flash_attention
from morgana_tpu_torch.ops.gru import gru_layer
from morgana_tpu_torch.ops import lstm as lstm_ops

__all__ = ['Linear', 'Sigmoid', 'Dropout', 'LayerNorm', 'GELU', 'ModuleList', 'Recurrent', 'GRU',
           'MultiHeadAttention', 'TransformerEncoderLayer', 'TransformerEncoder',
           'SequentialWithRecurrent', 'load_jax_params', 'state_dict', 'ema_update']

_NOT_PORTED = 'is not ported yet (ROADMAP.md)'

Sigmoid = nn.Sigmoid


class Dropout(nn.Module):
    """Inverted dropout that follows ``module.train()`` (``nn.py:386``).

    The noise is drawn from ``self.generator`` (the default generator when it
    is None); the trainer sets it every train step, seeded from the run's
    seed and the step count, so a step's noise does not depend on what ran
    before it. It does not give the JAX package's bits.
    """

    def __init__(self, p=0.5):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f'dropout probability must be in [0, 1], got {p}')
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        if self.p == 0.0 or not self.training:
            return x
        keep = 1.0 - self.p
        noise = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(noise < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self):
        return f'p={self.p}'


def _uniform(shape, bound, generator):
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


class Linear(nn.Module):
    """Dense layer with the kernel stored ``(in, out)`` (``nn.py:354``).
    Init U(-1/sqrt(in), 1/sqrt(in)), as ``torch.nn.Linear``."""

    def __init__(self, in_features, out_features, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = _uniform((in_features, out_features), bound, generator)
        self.bias = _uniform((out_features,), bound, generator)

    def forward(self, x):
        return torch.matmul(x, self.weight) + self.bias


class LayerNorm(nn.Module):
    """Layer normalisation over the last dim, population variance, eps 1e-5
    (``nn.py:406``); ``weight`` ones and ``bias`` zeros at init."""

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.eps)


class GELU(nn.Module):
    """The exact (erf) GELU (``nn.py:559``)."""

    def forward(self, x):
        return F.gelu(x)


class ModuleList(nn.Module):
    """A list of modules stored under ``items``, as the JAX package's
    ``ModuleList`` stores them, so that parameter names read
    ``<name>.items.<i>.…``."""

    def __init__(self, modules=()):
        super().__init__()
        self.items = nn.ModuleList(modules)

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class Recurrent(nn.Module):
    """Unidirectional LSTM or GRU stack (``nn.py:570``): parameters
    ``w_ih_l{i}`` (in, G*H), ``w_hh_l{i}`` (H, G*H), ``b_ih_l{i}``,
    ``b_hh_l{i}`` (G*H,), with G = 4 gates i, f, g, o for an LSTM and G = 3
    gates r, z, n for a GRU; dropout between layers.

    ``backend`` 'scan' and 'pallas' name the JAX package's two layer
    implementations, which compute the same function; here both run
    :func:`morgana_tpu_torch.ops.lstm.lstm_layer` (kernels K1 and K2 on the
    GPU) or :func:`morgana_tpu_torch.ops.gru.gru_layer` (K3 and K4). An LSTM
    layer of the 'pallas' backend stores its recurrence in
    ``ops.lstm.STORE_DTYPE`` (``MORGANA_PALLAS_STORE``, e.g. 'bfloat16'), read
    at each call, as ``pallas_rnn.lstm_layer`` does; 'scan' stays f32.
    """

    def __init__(self, mode, input_size, hidden_size, num_layers=1, dropout=0.0,
                 backend='scan', bidirectional=False, generator=None):
        super().__init__()
        mode = mode.lower()
        if mode not in ('lstm', 'gru'):
            raise ValueError(f'Unsupported recurrent mode {mode!r}')
        if bidirectional:
            raise NotImplementedError('bidirectional recurrent layers are not ported yet')
        if backend == 'wavefront':
            raise NotImplementedError("backend 'wavefront' is not ported yet")
        if backend not in ('scan', 'pallas'):
            raise ValueError(f'Unsupported backend {backend!r}')
        self.mode = mode
        self.backend = backend
        self.num_layers = num_layers
        self.dropout = Dropout(dropout) if dropout else None  # between layers
        gates = (4 if mode == 'lstm' else 3) * hidden_size
        bound = 1.0 / math.sqrt(hidden_size)
        for i in range(num_layers):
            in_dim = input_size if i == 0 else hidden_size
            self.register_parameter(f'w_ih_l{i}', _uniform((in_dim, gates), bound, generator))
            self.register_parameter(f'w_hh_l{i}', _uniform((hidden_size, gates), bound, generator))
            self.register_parameter(f'b_ih_l{i}', _uniform((gates,), bound, generator))
            self.register_parameter(f'b_hh_l{i}', _uniform((gates,), bound, generator))

    def forward(self, inputs, hidden=None, seq_len=None):
        """``hidden`` holds each layer's initial state, ``(h0, c0)`` for an
        LSTM and ``h0`` for a GRU (a bare state for one layer); returns the
        output and the states at ``seq_len`` in the same form."""
        squeeze_time = inputs.ndim == 2
        if squeeze_time:
            inputs = inputs[:, None, :]
        if hidden is None:
            hidden = [None] * self.num_layers
        elif self.num_layers == 1 and not isinstance(hidden, list):
            hidden = [hidden]

        x = inputs
        new_hidden = []
        for i in range(self.num_layers):
            weights = [getattr(self, f'{name}_l{i}') for name in ('w_ih', 'w_hh', 'b_ih', 'b_hh')]
            if self.mode == 'lstm':
                h0, c0 = (None, None) if hidden[i] is None else hidden[i]
                store = lstm_ops.STORE_DTYPE if self.backend == 'pallas' else None
                x, state = lstm_ops.lstm_layer(x, *weights, seq_len=seq_len, h0=h0, c0=c0,
                                               store_dtype=store)
            else:
                x, state = gru_layer(x, *weights, seq_len=seq_len, h0=hidden[i])
            new_hidden.append(state)
            if self.dropout is not None and i < self.num_layers - 1:
                x = self.dropout(x)
        if squeeze_time:
            x = x[:, 0, :]
        if self.num_layers == 1:
            new_hidden = new_hidden[0]
        return x, new_hidden


def GRU(input_size, hidden_size, num_layers=1, dropout=0.0):
    """``Recurrent('gru', ...)`` (``nn.py:814``)."""
    return Recurrent('gru', input_size, hidden_size, num_layers, dropout)


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention over a padded batch (``nn.py:823``): one
    fused ``in_proj`` (E, 3E), heads split as (B, H, T, E / H), and
    ``out_proj`` (E, E), both stored ``(in, out)``.

    ``backend`` 'auto', 'xla', 'splash' and 'flash' name the JAX package's
    implementations, which compute the same function; here all four run
    :func:`~morgana_tpu_torch.ops.flash_attention.flash_attention`: kernel
    K5/K6 on the GPU at any length (the TPU kernels' 256-frame floor and
    pad-to-block layout do not apply), the plain path on the CPU. Probability
    dropout in training (noise from ``generator``, which the trainer sets
    every step on the model's device) leaves the kernel on every device, as
    the JAX package leaves its TPU kernels: the exact path of
    :func:`~morgana_tpu_torch.ops.attention.scaled_dot_product_attention`
    with the same masks as biases.
    Cross-attention (``kv=``) and the streaming :meth:`step` are not ported
    yet.
    """

    def __init__(self, embed_dim, num_heads, dropout=0.0, backend='auto', generator=None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(f'embed_dim {embed_dim} not divisible by num_heads {num_heads}')
        if backend not in ('auto', 'xla', 'flash', 'splash'):
            raise ValueError(f'Unsupported attention backend {backend!r}')
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout_p = float(dropout)
        self.backend = backend
        self.generator = None
        self.in_proj = Linear(embed_dim, 3 * embed_dim, generator=generator)
        self.out_proj = Linear(embed_dim, embed_dim, generator=generator)

    def forward(self, x, seq_len=None, causal=False, kv=None, kv_seq_len=None, window=None):
        if window is not None and not causal:
            raise ValueError('window (sliding-window attention) requires causal=True')
        if kv is not None or kv_seq_len is not None:
            raise NotImplementedError(f'cross-attention (kv=) {_NOT_PORTED}')
        batch, time, _ = x.shape
        q, k, v = (t.reshape(batch, time, self.num_heads, self.head_dim).transpose(1, 2).contiguous()
                   for t in self.in_proj(x).split(self.embed_dim, dim=-1))
        # As the JAX package dispatches (nn.py:913-941): active probability
        # dropout takes the exact plain path on any device (the kernels have
        # no dropout hook); otherwise the kernel on the GPU.
        dropout_p = self.dropout_p if self.training else 0.0
        if dropout_p > 0.0:
            out = attention_ops.scaled_dot_product_attention(
                q, k, v, bias=attention_bias(seq_len, time, causal, window, device=x.device),
                dropout_p=dropout_p, generator=self.generator)
        else:
            out = flash_attention(q, k, v, seq_len=seq_len, causal=causal, window=window)
        return self.out_proj(out.transpose(1, 2).reshape(batch, time, self.embed_dim))

    def step(self, x, cache_k, cache_v, pos, window):
        raise NotImplementedError(f'MultiHeadAttention.step (the KV-cache stream) {_NOT_PORTED}')


class TransformerEncoderLayer(nn.Module):
    """Pre-LN block (``nn.py:1247``): ``x + attn(LN(x))`` then ``x +
    ffn(LN(x))``, the FFN ``Linear -> GELU -> Linear``, dropout on both
    residual branches. A mixture-of-experts FFN (``moe=``) is not ported
    yet."""

    accepts_seq_len = True

    def __init__(self, d_model, num_heads, d_ff, dropout=0.0, attention_backend='auto', moe=None,
                 generator=None):
        super().__init__()
        if moe:
            raise NotImplementedError(f'a mixture-of-experts FFN (moe=) {_NOT_PORTED}')
        self.attn_norm = LayerNorm(d_model)
        self.attn = MultiHeadAttention(d_model, num_heads, dropout=dropout,
                                       backend=attention_backend, generator=generator)
        self.ffn_norm = LayerNorm(d_model)
        self.ffn_in = Linear(d_model, d_ff, generator=generator)
        self.ffn_act = GELU()
        self.ffn_out = Linear(d_ff, d_model, generator=generator)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x, seq_len=None, causal=False, window=None):
        h = self.attn(self.attn_norm(x), seq_len=seq_len, causal=causal, window=window)
        if self.dropout is not None:
            h = self.dropout(h)
        x = x + h
        h = self.ffn_out(self.ffn_act(self.ffn_in(self.ffn_norm(x))))
        if self.dropout is not None:
            h = self.dropout(h)
        return x + h


class TransformerEncoder(nn.Module):
    """Pre-LN encoder blocks with sinusoidal positions added at entry and a
    final LayerNorm (``nn.py:1307``), called as ``(x, seq_len=None)`` like a
    ``Recurrent`` stack. The blocks are ``blocks.items.<i>``, as in the JAX
    package. ``remat``, ``moe`` and ``activation_sharding`` are not ported
    yet, nor is the streaming ``step``."""

    accepts_seq_len = True

    def __init__(self, num_layers, d_model, num_heads, d_ff, dropout=0.0, add_positions=True,
                 causal=False, window=None, remat=None, attention_backend='auto', moe=None,
                 activation_sharding=None, generator=None):
        super().__init__()
        if window is not None and not causal:
            raise ValueError('window (sliding-window attention) requires causal=True')
        if remat:
            raise NotImplementedError(f'remat (rematerialised blocks) {_NOT_PORTED}')
        if moe:
            raise NotImplementedError(f'mixture-of-experts blocks (moe=) {_NOT_PORTED}')
        if activation_sharding is not None:
            raise NotImplementedError(f'activation_sharding (sequence parallelism) {_NOT_PORTED}')
        self.d_model = d_model
        self.add_positions = add_positions
        self.causal = causal
        self.window = window
        self.blocks = ModuleList([
            TransformerEncoderLayer(d_model, num_heads, d_ff, dropout=dropout,
                                    attention_backend=attention_backend, generator=generator)
            for _ in range(num_layers)])
        self.norm = LayerNorm(d_model)

    def forward(self, x, seq_len=None):
        if self.add_positions:
            x = x + attention_ops.sinusoidal_positions(x.shape[1], self.d_model, dtype=x.dtype,
                                                       device=x.device)
        for block in self.blocks:
            x = block(x, seq_len=seq_len, causal=self.causal, window=self.window)
        return self.norm(x)

    def step(self, x, state):
        raise NotImplementedError(f'TransformerEncoder.step (the KV-cache stream) {_NOT_PORTED}')


class SequentialWithRecurrent(nn.Module):
    """Sequential container passing ``seq_len`` to its recurrent members and
    to the members that set ``accepts_seq_len`` (``nn.py:1424-1463``, without
    the streaming states); members are named ``0``, ``1``, ..."""

    def __init__(self, *modules):
        super().__init__()
        for i, module in enumerate(modules):
            self.add_module(str(i), module)

    def forward(self, input, seq_len=None):
        for module in self.children():
            if isinstance(module, Recurrent):
                input, _ = module(input, seq_len=seq_len)
            elif getattr(module, 'accepts_seq_len', False):
                input = module(input, seq_len=seq_len)
            else:
                input = module(input)
        return input


def load_jax_params(module, params):
    """Copies a ``{name: array}`` dict, as ``morgana_tpu.nn.state_dict``
    returns or an ``epoch_{N}.npz`` holds, into ``module``'s parameters.

    Strict: a missing or unexpected name raises ``KeyError`` (as
    ``morgana_tpu.nn.load_state_dict`` does) and a shape that differs raises
    ``ValueError``, before any parameter is written.
    """
    own = dict(module.named_parameters())
    missing = set(own) - set(params)
    unexpected = set(params) - set(own)
    if missing or unexpected:
        raise KeyError(f'state_dict mismatch: missing={sorted(missing)}, '
                       f'unexpected={sorted(unexpected)}')
    values = {name: np.asarray(value) for name, value in params.items()}
    for name, value in values.items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f'{name}: checkpoint shape {tuple(value.shape)}, '
                             f'module shape {tuple(own[name].shape)}')
    with torch.no_grad():
        for name, value in values.items():
            own[name].copy_(torch.tensor(value))


def state_dict(module):
    """``{name: np.ndarray}`` of ``module``'s parameters, by the JAX
    package's names: what an ``epoch_{N}.npz`` holds, and the inverse of
    :func:`load_jax_params`."""
    return {name: value.detach().cpu().numpy() for name, value in module.named_parameters()}


def ema_update(ema_params, params, decay):
    """One EMA step over dicts of tensors, ``shadow - (1 - decay) * (shadow -
    x)`` (``nn.py:1487``); returns the new dict."""
    return {name: shadow - (1.0 - decay) * (shadow - params[name])
            for name, shadow in ema_params.items()}
