"""Scaled dot-product attention, its additive masks and sinusoidal positions
(counterpart of ``morgana_tpu/ops/attention.py``).

Masking is additive: padding, causal and sliding-window structure enter as
a large negative bias on the logits (``_MASK_BIAS``), the logits and the
softmax run in float32. :func:`scaled_dot_product_attention` with these
biases is the plain version of the attention kernel
(``ops/flash_attention.py``), and the path that runs on the CPU.
"""
import torch

__all__ = ['padding_bias', 'causal_bias', 'local_causal_bias', 'streaming_bias',
           'scaled_dot_product_attention', 'sinusoidal_positions', 'sinusoidal_positions_at']

# Finite, so that a query row that sees no key still gives a defined
# (uniform) softmax and a zero gradient, never NaN (``attention.py:34``).
_MASK_BIAS = -1e9


def _where_allowed(allowed, dtype):
    zero = torch.zeros((), dtype=dtype, device=allowed.device)
    return torch.where(allowed, zero, torch.full((), _MASK_BIAS, dtype=dtype, device=allowed.device))


def padding_bias(seq_len, max_len, dtype=torch.float32):
    """(batch, 1, 1, max_len) bias: 0 at valid keys, ``_MASK_BIAS`` at padded
    keys. ``seq_len`` is (batch,) or (batch, 1)."""
    seq_len = torch.as_tensor(seq_len)
    if seq_len.ndim == 2:
        seq_len = seq_len[:, 0]
    positions = torch.arange(max_len, dtype=seq_len.dtype, device=seq_len.device)
    valid = positions[None, :] < seq_len[:, None]
    return _where_allowed(valid, dtype)[:, None, None, :]


def causal_bias(max_len, dtype=torch.float32, device=None):
    """(1, 1, max_len, max_len) bias hiding keys after each query."""
    q = torch.arange(max_len, device=device)
    return _where_allowed(q[:, None] >= q[None, :], dtype)[None, None]


def local_causal_bias(max_len, window, dtype=torch.float32, device=None):
    """(1, 1, max_len, max_len) sliding-window causal bias: query ``i`` sees
    keys ``j`` with ``i - window < j <= i``."""
    q = torch.arange(max_len, device=device)
    diff = q[:, None] - q[None, :]
    return _where_allowed((diff >= 0) & (diff < window), dtype)[None, None]


def streaming_bias(pos, chunk, window, dtype=torch.float32, device=None):
    """(1, 1, chunk, window + chunk) bias for one streamed chunk over
    ``[cache | chunk]`` keys: queries at absolute ``pos + i``, keys at
    ``pos - window + j``; a key is visible iff its position is >= 0 and it
    lies in the query's causal window."""
    q_abs = pos + torch.arange(chunk, device=device)
    k_abs = pos - window + torch.arange(window + chunk, device=device)
    diff = q_abs[:, None] - k_abs[None, :]
    allowed = (k_abs >= 0)[None, :] & (diff >= 0) & (diff < window)
    return _where_allowed(allowed, dtype)[None, None]


def scaled_dot_product_attention(q, k, v, bias=None, dropout_p=0.0, generator=None):
    """Attention over batched heads, ``q, k, v`` (batch, heads, T, head_dim)
    (``k`` and ``v`` may have another T). Logits ``q k^T / sqrt(head_dim)``
    plus ``bias`` and the softmax in float32; with ``dropout_p`` the
    probabilities are dropped with noise from ``generator`` and rescaled.
    Returns (batch, heads, Tq, head_dim) in ``q``'s dtype."""
    out_dtype = q.dtype
    scale = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=torch.float32))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale.to(q.device)
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = 1.0 - dropout_p
        noise = torch.rand(probs.shape, generator=generator, device=probs.device)
        probs = torch.where(noise < keep, probs / keep, torch.zeros((), device=probs.device))
    return torch.matmul(probs.to(v.dtype), v).to(out_dtype)


def sinusoidal_positions(max_len, dim, dtype=torch.float32, device=None):
    """The (max_len, dim) sinusoidal position table."""
    return sinusoidal_positions_at(torch.arange(max_len, dtype=torch.float32, device=device), dim,
                                   dtype=dtype)


def sinusoidal_positions_at(positions, dim, dtype=torch.float32):
    """(len(positions), dim) sinusoid encodings of absolute positions, in
    the interleaved (sin, cos, sin, cos, ...) layout."""
    if dim % 2 != 0:
        raise ValueError(f'sinusoidal position dim must be even, got {dim}')
    pos = torch.as_tensor(positions, dtype=torch.float32)[:, None]
    half = torch.arange(dim // 2, dtype=torch.float32, device=pos.device)[None, :]
    angles = pos / torch.pow(torch.tensor(10000.0, device=pos.device), 2.0 * half / dim)
    table = torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1)
    return table.reshape(pos.shape[0], dim).to(dtype)
