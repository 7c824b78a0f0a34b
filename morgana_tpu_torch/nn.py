"""Layers of the acoustic models, with the JAX package's parameter names and
layouts (counterpart of ``morgana_tpu/nn.py``).

Weights are stored as the JAX package stores them, ``(in, out)`` for
``Linear`` (and the attention projections) and ``(in, gates)`` for
``Recurrent``, so that
:func:`load_jax_params` copies an ``epoch_{N}.npz`` (or
``morgana_tpu.nn.state_dict``) into these modules by name, unchanged, and
:func:`state_dict` writes one back.

The compute dtype (``nn.py:92-121``): :func:`set_default_compute_dtype`
('bfloat16') makes every dense product (``Linear``, the attention
projections, the recurrences' input GEMMs and, on the 'scan' backend, their
``h @ w_hh``) and both products of attention read their inputs rounded to
bf16 and sum in float32 (``ops/precision.py``); everything else stays
float32. It is a process global, read at each call, as the JAX package
reads its own while it traces. A 'pallas' ``Recurrent`` ignores it (f32, or
its storage type), as the JAX package's Pallas kernels do; a layer's own
``compute_dtype`` overrides it.

Rematerialisation (``--remat``, ``nn.py:83``): :func:`set_default_remat`
(or a layer's own ``remat``) checkpoints each layer of a ``Recurrent`` and
each block of a ``TransformerEncoder`` with
``torch.utils.checkpoint(use_reentrant=False)``: their activations are not
kept for the backward pass but recomputed in it, with the same noise (the
state of the step's generator is saved at the block's forward and restored
for its recomputation) and, for an LSTM layer on the GPU, kernel K1 writing
its gate trace in the recomputation only.
"""
import contextlib
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from morgana_tpu_torch.device import use_ieee_f32
from morgana_tpu_torch.ops import attention as attention_ops
from morgana_tpu_torch.ops import precision
from morgana_tpu_torch.ops.flash_attention import attention_bias, flash_attention
from morgana_tpu_torch.ops.gru import gru_layer
from morgana_tpu_torch.ops import lstm as lstm_ops
from morgana_tpu_torch.ops.masking import sequence_mask

__all__ = ['Linear', 'Sigmoid', 'Dropout', 'LayerNorm', 'GELU', 'Conv1d', 'ModuleList',
           'Recurrent', 'GRU', 'MultiHeadAttention', 'MoEFeedForward', 'TransformerEncoderLayer',
           'TransformerEncoder', 'SequentialWithRecurrent', 'load_jax_params', 'state_dict',
           'ema_update', 'set_default_compute_dtype', 'default_compute_dtype', 'aux_loss',
           'collected_aux_loss', 'collect_aux_losses', 'set_default_remat', 'default_remat']

_NOT_PORTED = 'is not ported yet (ROADMAP.md)'

_DEFAULT_COMPUTE_DTYPE = None
_DEFAULT_REMAT = False


def set_default_remat(enabled):
    """Sets the process's rematerialisation default (``nn.py:83``), which a
    layer's ``remat=None`` reads at each call."""
    global _DEFAULT_REMAT
    _DEFAULT_REMAT = bool(enabled)


def default_remat():
    return _DEFAULT_REMAT


def _noise_generators(module):
    """The generators ``module``'s noise is drawn from in this call: those
    of its modules that draw (dropout and attention dropout in training)."""
    if module is None:
        return []
    found = {}
    for m in module.modules():
        generator = getattr(m, 'generator', None)
        draws = m.training and (getattr(m, 'p', 0.0) or getattr(m, 'dropout_p', 0.0))
        if generator is not None and draws:
            found[id(generator)] = generator
    return list(found.values())


def _checkpointed(module, fn, *args):
    """``fn(*args)`` checkpointed (non-reentrant): recomputed in the
    backward pass. The noise generators of ``module`` (None: ``fn`` draws
    no noise) are restored to their
    state at the forward for the recomputation (``torch.utils.checkpoint``
    keeps only the global generators' states), and an LSTM kernel skips its
    gate trace in the forward (the recomputation writes it; the checkpoint
    then matches saved tensors by position, ``determinism_check='none'``)."""
    generators = _noise_generators(module)
    saved = []

    @contextlib.contextmanager
    def forward():
        if generators and torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise NotImplementedError('remat of a block that draws noise inside a captured CUDA '
                                      'graph: run --remat with --steps_per_dispatch 1')
        saved[:] = [g.get_state() for g in generators]
        with lstm_ops.skip_gate_trace():
            yield

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in generators]
        for g, state in zip(generators, saved):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(generators, now):
                g.set_state(state)

    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             context_fn=lambda: (forward(), recompute()),
                                             determinism_check='none')


def set_default_compute_dtype(dtype):
    """Sets the process's compute dtype (``nn.py:92``): None, 'float32',
    'f32' or 'none' for float32 products, 'bfloat16' for bf16 ones (or the
    torch dtypes). Another dtype raises ``ValueError`` naming ROADMAP.md."""
    global _DEFAULT_COMPUTE_DTYPE
    _DEFAULT_COMPUTE_DTYPE = precision.as_compute_dtype(dtype)


def default_compute_dtype():
    """The process's compute dtype: None (float32) or ``torch.bfloat16``."""
    return _DEFAULT_COMPUTE_DTYPE


def _matmul(x, w):
    """The dense product of every projection (``nn.py:110``): inputs
    rounded to the global compute dtype, sums and output in ``x.dtype``."""
    return precision.matmul(x, w, _DEFAULT_COMPUTE_DTYPE)


def _weight(module, name, compute_dtype):
    """``module``'s weight ``name`` as a product in ``compute_dtype`` reads
    it. A quantized weight (``quantize.Dequantize``) is dequantised in that
    dtype, q and scale each rounded and their product rounded, as the JAX
    package's ``QuantizedArray.astype`` does (``quantize.py:123-128``); held
    in float32, which holds those values exactly."""
    if compute_dtype is not None and parametrize.is_parametrized(module, name):
        param = module.parametrizations[name]
        return param[0].dequantize(param.original0, param.original1,
                                   compute_dtype).to(torch.float32)
    return getattr(module, name)

# Each thread's auxiliary losses of the open collect_aux_losses block; None
# outside one.
_AUX = threading.local()


@contextlib.contextmanager
def collect_aux_losses():
    """Collects the auxiliary losses that layers register with
    :func:`aux_loss` inside the block, in this thread, as the JAX package's
    ``nn.bind`` context of a train step collects them."""
    _AUX.losses = []
    try:
        yield
    finally:
        _AUX.losses = None


def aux_loss(value):
    """Registers an auxiliary training loss from inside a layer (the MoE
    router's balance term; ``nn.py:331``); nothing outside
    :func:`collect_aux_losses`."""
    losses = getattr(_AUX, 'losses', None)
    if losses is not None:
        losses.append(value)


def collected_aux_loss():
    """The sum of the auxiliary losses registered in the open
    :func:`collect_aux_losses` block, 0.0 when none (``nn.py:341``)."""
    losses = getattr(_AUX, 'losses', None)
    return sum(losses) if losses else 0.0


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

    def __init__(self, in_features, out_features, bias=True, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = _uniform((in_features, out_features), bound, generator)
        self.bias = _uniform((out_features,), bound, generator) if bias else None

    def forward(self, x):
        y = _matmul(x, _weight(self, 'weight', _DEFAULT_COMPUTE_DTYPE))
        return y if self.bias is None else y + self.bias


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


class Conv1d(nn.Module):
    """1-d convolution over ``(batch, time, channels)`` (``nn.py:427``),
    the weight stored ``(kernel, in / groups, out)`` as the JAX package
    stores it, init U(-b, b) with b = 1/sqrt(in / groups * kernel).

    ``padding='same'`` keeps the length (``dilation * (kernel - 1)`` frames
    split low and high, the low half rounded down); ``'causal'`` pads them
    all on the left, so frame t sees frames up to t, and streams through
    :meth:`step` with the last :attr:`context` input frames as its state.
    With ``seq_len`` the frames past it are zeroed before the convolution, so
    an utterance's output does not depend on the batch it is padded in.

    The JAX package convolves with XLA (``lax.conv_general_dilated``), no
    Pallas kernel; here ``torch.nn.functional.conv1d``. Under a bf16 compute
    dtype it reads x and the weight rounded to bf16 and sums in f32, as the
    JAX convolution's ``preferred_element_type`` does: the f32 convolution of
    the rounded operands, the same function. On the card it turns cuDNN's
    TF32 off first (:func:`~morgana_tpu_torch.device.use_ieee_f32`), so the
    convolution and its backward are IEEE f32 whatever the process allowed.
    """

    accepts_seq_len = True

    def __init__(self, in_channels, out_channels, kernel_size, dilation=1, groups=1, bias=True,
                 padding='same', generator=None):
        super().__init__()
        if padding not in ('same', 'causal'):
            raise ValueError(f"padding must be 'same' or 'causal', got {padding!r}")
        if in_channels % groups or out_channels % groups:
            raise ValueError(f'groups={groups} must divide in_channels={in_channels} and '
                             f'out_channels={out_channels}')
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = int(kernel_size)
        self.dilation = int(dilation)
        self.groups = int(groups)
        self.padding = padding
        bound = 1.0 / math.sqrt(in_channels // groups * kernel_size)
        self.weight = _uniform((self.kernel_size, in_channels // groups, out_channels), bound,
                               generator)
        self.bias = _uniform((out_channels,), bound, generator) if bias else None

    @property
    def context(self):
        """Frames of left context that one output needs."""
        return self.dilation * (self.kernel_size - 1)

    def _conv(self, x, pad_low, pad_high):
        if x.is_cuda:
            use_ieee_f32()
        compute = _DEFAULT_COMPUTE_DTYPE
        w = precision.rounded(self.weight, compute).permute(2, 1, 0)
        x = F.pad(precision.rounded(x, compute).transpose(1, 2), (pad_low, pad_high))
        y = F.conv1d(x, w, dilation=self.dilation, groups=self.groups).transpose(1, 2)
        return y if self.bias is None else y + self.bias

    def forward(self, x, seq_len=None):
        if seq_len is not None:
            x = x * sequence_mask(seq_len, max_len=x.shape[1], dtype=x.dtype)
        total = self.context
        if self.padding == 'causal':
            return self._conv(x, total, 0)
        return self._conv(x, total // 2, total - total // 2)

    def init_stream_state(self):
        """The streaming protocol's marker: the first chunk's state is None."""
        return None

    def step(self, chunk, state):
        """One streamed chunk of a causal convolution: ``[context tail |
        chunk]`` convolved without padding, which is the causal forward's
        output for these frames; returns it and the new tail."""
        if self.padding != 'causal':
            raise NotImplementedError("Conv1d(padding='same') cannot stream (it needs future "
                                      "frames); build streaming models with padding='causal'.")
        ctx = self.context
        if ctx == 0:
            return self._conv(chunk, 0, 0), state
        if state is None:
            state = chunk.new_zeros((chunk.shape[0], ctx, self.in_channels))
        x = torch.cat([state, chunk], dim=1)
        return self._conv(x, 0, 0), x[:, x.shape[1] - ctx:]


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

    ``compute_dtype`` (None, 'float32' or 'bfloat16'; ``nn.py:580``)
    overrides the global compute dtype on the 'scan' backend; the 'pallas'
    backend ignores both (``nn.py:659-664``).

    ``backend`` 'scan' and 'pallas' name the JAX package's two layer
    implementations, which compute the same function; here both run
    :func:`morgana_tpu_torch.ops.lstm.lstm_layer` (kernels K1 and K2 on the
    GPU) or :func:`morgana_tpu_torch.ops.gru.gru_layer` (K3 and K4). An LSTM
    layer of the 'pallas' backend stores its recurrence in
    ``ops.lstm.STORE_DTYPE`` (``MORGANA_PALLAS_STORE``, e.g. 'bfloat16'), read
    at each call, as ``pallas_rnn.lstm_layer`` does; 'scan' stays f32, and so
    does a layer with quantized weights (``quantize.Dequantize``), as the JAX
    package's 'pallas' backend falls back to its f32 scan for them
    (``nn.py:652``).
    """

    def __init__(self, mode, input_size, hidden_size, num_layers=1, dropout=0.0,
                 backend='scan', bidirectional=False, compute_dtype=None, generator=None,
                 remat=None):
        super().__init__()
        precision.as_compute_dtype(compute_dtype)   # raises on a dtype the port lacks
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
        self.compute_dtype = compute_dtype
        self.remat = remat
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

        # The dispatch of nn.py:641-664: the layer's own compute dtype, else
        # the global one, on the 'scan' backend; f32 (or the storage type)
        # on the 'pallas' one, quantized or not.
        if self.backend == 'pallas':
            compute = None
        elif self.compute_dtype is not None:
            compute = precision.as_compute_dtype(self.compute_dtype)
        else:
            compute = _DEFAULT_COMPUTE_DTYPE
        remat = self.remat if self.remat is not None else _DEFAULT_REMAT
        x = inputs
        new_hidden = []
        for i in range(self.num_layers):
            weights = [_weight(self, f'{name}_l{i}', compute)
                       for name in ('w_ih', 'w_hh', 'b_ih', 'b_hh')]
            if self.mode == 'lstm':
                h0, c0 = (None, None) if hidden[i] is None else hidden[i]
                store = lstm_ops.STORE_DTYPE if self.backend == 'pallas' \
                    and not parametrize.is_parametrized(self) else None

                def layer(x, *w, h0=h0, c0=c0, store=store):
                    return lstm_ops.lstm_layer(x, *w, seq_len=seq_len, h0=h0, c0=c0,
                                               store_dtype=store, compute_dtype=compute)
            else:
                def layer(x, *w, h0=hidden[i]):
                    return gru_layer(x, *w, seq_len=seq_len, h0=h0, compute_dtype=compute)
            # With remat each layer is checkpointed (nn.py:720-760); the
            # dropout between layers stays outside.
            x, state = (_checkpointed(None, layer, x, *weights) if remat
                        else layer(x, *weights))
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
    with the same masks as biases. The streaming :meth:`step` takes that
    plain path too, as the JAX step does (its queries sit at an offset into
    a KV cache, which the kernel does not take). Cross-attention (``kv=``)
    is not ported yet.
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
        compute = _DEFAULT_COMPUTE_DTYPE
        # bf16 heads are made contiguous by their cast (flash_attention).
        q, k, v = (t.reshape(batch, time, self.num_heads, self.head_dim).transpose(1, 2)
                   for t in self.in_proj(x).split(self.embed_dim, dim=-1))
        if compute is None:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        # As the JAX package dispatches (nn.py:913-941): active probability
        # dropout takes the exact plain path on any device (the kernels have
        # no dropout hook); otherwise the kernel on the GPU.
        dropout_p = self.dropout_p if self.training else 0.0
        if dropout_p > 0.0:
            out = attention_ops.scaled_dot_product_attention(
                q, k, v, bias=attention_bias(seq_len, time, causal, window, device=x.device),
                dropout_p=dropout_p, generator=self.generator, compute_dtype=compute)
        else:
            out = flash_attention(q, k, v, seq_len=seq_len, causal=causal, window=window,
                                  compute_dtype=compute)
        return self.out_proj(out.transpose(1, 2).reshape(batch, time, self.embed_dim))

    def step(self, x, cache_k, cache_v, pos, window):
        """One streamed chunk of sliding-window causal self-attention
        (``nn.py:1077-1107``). ``x`` (batch, chunk, E) sits at absolute
        positions ``pos + i`` (``pos`` an int); ``cache_k``/``cache_v`` hold
        the previous ``window`` frames' projected keys and values (batch,
        window, E), zeros before the stream starts (masked by
        :func:`~morgana_tpu_torch.ops.attention.streaming_bias` while their
        positions are negative). Returns ``(out, new_cache_k,
        new_cache_v)``: :meth:`forward` with ``causal=True, window=window``
        on the whole sequence, chunk boundaries included."""
        batch, chunk, _ = x.shape
        q, k, v = self.in_proj(x).split(self.embed_dim, dim=-1)
        k_full = torch.cat([cache_k, k], dim=1)            # (B, W+C, E)
        v_full = torch.cat([cache_v, v], dim=1)

        def to_heads(t):
            return t.reshape(batch, t.shape[1], self.num_heads, self.head_dim).transpose(1, 2)

        bias = attention_ops.streaming_bias(pos, chunk, window, device=x.device)
        out = attention_ops.scaled_dot_product_attention(to_heads(q), to_heads(k_full),
                                                         to_heads(v_full), bias=bias,
                                                         compute_dtype=_DEFAULT_COMPUTE_DTYPE)
        out = out.transpose(1, 2).reshape(batch, chunk, self.embed_dim)
        # The cache keeps the latest `window` frames.
        return self.out_proj(out), k_full[:, -cache_k.shape[1]:], v_full[:, -cache_v.shape[1]:]


class MoEFeedForward(nn.Module):
    """Mixture-of-experts FFN with Switch-Transformer top-1 routing
    (``nn.py:1114``), the sparse stand-in for ``Linear -> GELU -> Linear``,
    on one device.

    The router (``router.weight`` (d_model, E), no bias) runs in float32
    whatever the compute dtype; each token goes to its most probable expert,
    scaled by that probability. Every expert takes at most ``C =
    ceil(capacity_factor * T / E)`` tokens of a batch row, in time order;
    the tokens past it, and the frames past ``seq_len``, get 0 here (the
    block's residual carries them on), and padded frames take no capacity
    and no part in the balance loss. Routing is the JAX package's dense
    formulation, one-hot dispatch and combine products over ``(B, T, E, C)``
    and the experts' FFNs ``w_in`` (E, d_model, d_ff), ``b_in``, ``w_out``
    (E, d_ff, d_model), ``b_out`` as batched products; under a bf16 compute
    dtype their operands are rounded to bf16 and the sums stay f32
    (``nn.py:1183``). In training the balance loss ``aux_weight * E *
    sum_e f_e p_e`` (Fedus et al. 2021) is registered with :func:`aux_loss`.
    The JAX package's expert parallelism (``mesh``) is not ported yet."""

    accepts_seq_len = True

    def __init__(self, d_model, d_ff, num_experts, capacity_factor=1.25, aux_weight=0.01,
                 mesh=None, generator=None):
        super().__init__()
        if num_experts < 1:
            raise ValueError(f'num_experts must be >= 1, got {num_experts}')
        if mesh is not None:
            raise NotImplementedError(f'expert parallelism (mesh=) {_NOT_PORTED}')
        self.d_model = d_model
        self.d_ff = d_ff
        self.num_experts = int(num_experts)
        self.capacity_factor = float(capacity_factor)
        self.aux_weight = float(aux_weight)
        self.router = Linear(d_model, num_experts, bias=False, generator=generator)
        bound_in, bound_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
        self.w_in = _uniform((num_experts, d_model, d_ff), bound_in, generator)
        self.b_in = _uniform((num_experts, d_ff), bound_in, generator)
        self.w_out = _uniform((num_experts, d_ff, d_model), bound_out, generator)
        self.b_out = _uniform((num_experts, d_model), bound_out, generator)

    def capacity(self, frames):
        """Tokens an expert takes from one batch row of ``frames`` frames."""
        return max(1, min(frames, int(math.ceil(self.capacity_factor * frames / self.num_experts))))

    def forward(self, x, seq_len=None):
        batch, frames, _ = x.shape
        num_experts, cap = self.num_experts, self.capacity(frames)
        compute = _DEFAULT_COMPUTE_DTYPE

        def rounded(t):
            return precision.rounded(t, compute)

        probs = torch.softmax(torch.matmul(x.float(), self.router.weight.float()), dim=-1)
        gate = probs.max(dim=-1).values                       # (B, T)
        expert = torch.argmax(probs, dim=-1)                  # (B, T)
        if seq_len is None:
            valid = torch.ones((batch, frames), device=x.device)
        else:
            valid = sequence_mask(seq_len, max_len=frames, dtype=torch.float32)[..., 0]
        onehot = F.one_hot(expert, num_experts).float() * valid[..., None]
        # Each token's 1-based place in its expert's queue of its row.
        position = torch.cumsum(onehot, dim=1) * onehot
        keep = onehot * (position <= cap)
        place = (position - 1).clamp(min=0, max=cap - 1).long()
        slot = F.one_hot(place, cap).to(x.dtype) * keep[..., None].to(x.dtype)  # (B, T, E, C)

        dispatched = torch.einsum('btec,btd->becd', slot, rounded(x))
        h = torch.einsum('becd,edf->becf', rounded(dispatched), rounded(self.w_in))
        h = F.gelu(h + self.b_in[None, :, None, :])
        out = torch.einsum('becf,efd->becd', rounded(h), rounded(self.w_out))
        out = out + self.b_out[None, :, None, :]
        y = torch.einsum('btec,becd->btd', slot, rounded(out)) * gate[..., None].to(x.dtype)

        if self.training and self.aux_weight:
            denom = valid.sum().clamp(min=1.0)
            frac = onehot.sum(dim=(0, 1)) / denom
            mean_prob = (probs * valid[..., None]).sum(dim=(0, 1)) / denom
            aux_loss(self.aux_weight * num_experts * torch.sum(frac * mean_prob))
        return y


class TransformerEncoderLayer(nn.Module):
    """Pre-LN block (``nn.py:1247``): ``x + attn(LN(x))`` then ``x +
    ffn(LN(x))``, the FFN ``Linear -> GELU -> Linear``, or with ``moe`` (the
    :class:`MoEFeedForward` keyword dict, e.g. ``{'num_experts': 8}``) a
    mixture of experts routed within ``seq_len``; dropout on both residual
    branches."""

    accepts_seq_len = True

    def __init__(self, d_model, num_heads, d_ff, dropout=0.0, attention_backend='auto', moe=None,
                 generator=None):
        super().__init__()
        self.attn_norm = LayerNorm(d_model)
        self.attn = MultiHeadAttention(d_model, num_heads, dropout=dropout,
                                       backend=attention_backend, generator=generator)
        self.ffn_norm = LayerNorm(d_model)
        if moe:
            self.moe = MoEFeedForward(d_model, d_ff, generator=generator, **moe)
        else:
            self.moe = None
            self.ffn_in = Linear(d_model, d_ff, generator=generator)
            self.ffn_act = GELU()
            self.ffn_out = Linear(d_ff, d_model, generator=generator)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x, seq_len=None, causal=False, window=None):
        h = self.attn(self.attn_norm(x), seq_len=seq_len, causal=causal, window=window)
        if self.dropout is not None:
            h = self.dropout(h)
        x = x + h
        return x + self._ffn(x, seq_len)

    def _ffn(self, x, seq_len=None):
        if self.moe is not None:
            h = self.moe(self.ffn_norm(x), seq_len=seq_len)
        else:
            h = self.ffn_out(self.ffn_act(self.ffn_in(self.ffn_norm(x))))
        if self.dropout is not None:
            h = self.dropout(h)
        return h

    def step(self, x, cache, pos, window):
        """The streamed-chunk form of :meth:`forward` for inference
        (``nn.py:1291``); ``cache`` is this block's (k, v) pair."""
        cache_k, cache_v = cache
        h, cache_k, cache_v = self.attn.step(self.attn_norm(x), cache_k, cache_v, pos, window)
        x = x + h
        return x + self._ffn(x), (cache_k, cache_v)


class TransformerEncoder(nn.Module):
    """Pre-LN encoder blocks with sinusoidal positions added at entry and a
    final LayerNorm (``nn.py:1307``), called as ``(x, seq_len=None)`` like a
    ``Recurrent`` stack. The blocks are ``blocks.items.<i>``, as in the JAX
    package. A causal encoder with a window also streams, chunk by chunk
    through per-block KV caches (:meth:`init_stream_state`, :meth:`step`).
    With ``moe`` (the :class:`MoEFeedForward` keyword dict) every
    ``moe_every``-th block's FFN is a mixture of experts (``nn.py:1343``).
    ``remat`` (None: the process default) checkpoints each block
    (``nn.py:1353-1370``); ``activation_sharding`` is not ported yet."""

    accepts_seq_len = True

    def __init__(self, num_layers, d_model, num_heads, d_ff, dropout=0.0, add_positions=True,
                 causal=False, window=None, remat=None, attention_backend='auto', moe=None,
                 moe_every=2, activation_sharding=None, generator=None):
        super().__init__()
        if window is not None and not causal:
            raise ValueError('window (sliding-window attention) requires causal=True')
        if activation_sharding is not None:
            raise NotImplementedError(f'activation_sharding (sequence parallelism) {_NOT_PORTED}')
        self.d_model = d_model
        self.add_positions = add_positions
        self.causal = causal
        self.window = window
        self.remat = remat
        self.blocks = ModuleList([
            TransformerEncoderLayer(
                d_model, num_heads, d_ff, dropout=dropout, attention_backend=attention_backend,
                moe=moe if moe and i % moe_every == moe_every - 1 else None, generator=generator)
            for i in range(num_layers)])
        self.norm = LayerNorm(d_model)

    def forward(self, x, seq_len=None):
        if self.add_positions:
            x = x + attention_ops.sinusoidal_positions(x.shape[1], self.d_model, dtype=x.dtype,
                                                       device=x.device)
        remat = self.remat if self.remat is not None else _DEFAULT_REMAT
        for block in self.blocks:
            if remat:
                x = _checkpointed(block, lambda t, b=block: b(t, seq_len=seq_len,
                                                              causal=self.causal,
                                                              window=self.window), x)
            else:
                x = block(x, seq_len=seq_len, causal=self.causal, window=self.window)
        return self.norm(x)

    def init_stream_state(self, batch, dtype=torch.float32, device=None):
        """Zero KV caches and position 0 for :meth:`step` (``nn.py:1391``).
        The position is a host int, so a chunk costs no device read."""
        if not (self.causal and self.window):
            raise ValueError('streaming needs causal=True and a finite window '
                             '(bidirectional attention requires the full utterance)')
        caches = [(torch.zeros((batch, self.window, self.d_model), dtype=dtype, device=device),
                   torch.zeros((batch, self.window, self.d_model), dtype=dtype, device=device))
                  for _ in self.blocks]
        return {'pos': 0, 'caches': caches}

    def step(self, x, state):
        """A streamed chunk (batch, C, d_model) -> ``(y, new_state)``
        (``nn.py:1403``): chained chunks give :meth:`forward` on the whole
        sequence (the same windowed causal mask, positions at their true
        offsets)."""
        if state is None:
            state = self.init_stream_state(x.shape[0], dtype=x.dtype, device=x.device)
        pos, caches = state['pos'], state['caches']
        if self.add_positions:
            x = x + attention_ops.sinusoidal_positions_at(
                torch.arange(pos, pos + x.shape[1], device=x.device), self.d_model,
                dtype=x.dtype)
        new_caches = []
        for block, cache in zip(self.blocks, caches):
            x, cache = block.step(x, cache, pos, self.window)
            new_caches.append(cache)
        return self.norm(x), {'pos': pos + x.shape[1], 'caches': new_caches}


class SequentialWithRecurrent(nn.Module):
    """Sequential container threading ``(hiddens, seq_len)`` through its
    recurrent members and ``seq_len`` through the members that set
    ``accepts_seq_len`` (``nn.py:1424-1470``); members are named ``0``,
    ``1``, ..."""

    def __init__(self, *modules):
        super().__init__()
        for i, module in enumerate(modules):
            self.add_module(str(i), module)

    def forward(self, input, hiddens=None, seq_len=None, return_hiddens=False):
        """``hiddens`` holds one state slot per member (``None`` for the
        stateless ones). With ``return_hiddens`` (chunked streaming) returns
        ``(output, new_hiddens)``: each recurrent member's final state, and
        an attention member's KV caches when it has ``init_stream_state``
        (a member that cannot stream raises). The caller's list is never
        changed, so a client may keep the previous chunk's state."""
        modules = list(self.children())
        hiddens = [None] * len(modules) if hiddens is None else list(hiddens)
        for i, module in enumerate(modules):
            if isinstance(module, Recurrent):
                input, hiddens[i] = module(input, hiddens[i], seq_len)
            elif getattr(module, 'accepts_seq_len', False):
                if return_hiddens and hasattr(module, 'init_stream_state'):
                    input, hiddens[i] = module.step(input, hiddens[i])
                elif return_hiddens:
                    raise NotImplementedError(
                        f'{type(module).__name__} cannot stream: wrap attention blocks in a '
                        'TransformerEncoder (causal + window) for chunked inference.')
                else:
                    input = module(input, seq_len=seq_len)
            else:
                input = module(input)
        if return_hiddens:
            return input, hiddens
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
