"""Layers of the acoustic model, with the JAX package's parameter names and
layouts (counterpart of ``morgana_tpu/nn.py``).

Weights are stored as the JAX package stores them, ``(in, out)`` for
``Linear`` and ``(in, gates)`` for ``Recurrent``, so that
:func:`load_jax_params` copies an ``epoch_{N}.npz`` (or
``morgana_tpu.nn.state_dict``) into these modules by name, unchanged, and
:func:`state_dict` writes one back.
"""
import math

import numpy as np
import torch
from torch import nn

from morgana_tpu_torch.ops.gru import gru_layer
from morgana_tpu_torch.ops.lstm import lstm_layer

__all__ = ['Linear', 'Sigmoid', 'Dropout', 'Recurrent', 'GRU', 'SequentialWithRecurrent',
           'load_jax_params', 'state_dict', 'ema_update']

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


class Recurrent(nn.Module):
    """Unidirectional LSTM or GRU stack (``nn.py:570``): parameters
    ``w_ih_l{i}`` (in, G*H), ``w_hh_l{i}`` (H, G*H), ``b_ih_l{i}``,
    ``b_hh_l{i}`` (G*H,), with G = 4 gates i, f, g, o for an LSTM and G = 3
    gates r, z, n for a GRU; dropout between layers.

    ``backend`` 'scan' and 'pallas' name the JAX package's two layer
    implementations, which compute the same function; here both run
    :func:`morgana_tpu_torch.ops.lstm.lstm_layer` (kernels K1 and K2 on the
    GPU) or :func:`morgana_tpu_torch.ops.gru.gru_layer` (K3 and K4).
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
                x, state = lstm_layer(x, *weights, seq_len=seq_len, h0=h0, c0=c0)
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


class SequentialWithRecurrent(nn.Module):
    """Sequential container passing ``seq_len`` to its recurrent members
    (``nn.py:1424``, without the streaming states); members are named ``0``,
    ``1``, ..."""

    def __init__(self, *modules):
        super().__init__()
        for i, module in enumerate(modules):
            self.add_module(str(i), module)

    def forward(self, input, seq_len=None):
        for module in self.children():
            if isinstance(module, Recurrent):
                input, _ = module(input, seq_len=seq_len)
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
