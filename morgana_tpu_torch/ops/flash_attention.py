"""Exact self-attention over a padded batch with key padding, causal and
sliding-window masks: the port of the JAX package's two TPU attention
kernels, ``MultiHeadAttention._splash`` (``morgana_tpu/nn.py:1001``, the
default 'auto' backend) and ``MultiHeadAttention._flash`` (``nn.py:1055``).

:func:`flash_attention` takes q, k, v in the JAX layout (B, H, T, dh) and
computes, per row ``i`` of batch row ``b``, the softmax of ``q_i . k_j /
sqrt(dh)`` over the keys ``j`` it sees (``j < seq_len[b]``; with ``causal``
also ``j <= i``; with ``window`` also ``i - j < window``) times v:

* for CUDA tensors, in kernel K5/K6: ``csrc/attn_fwd.cu`` forward and, when
  a gradient is needed, ``csrc/attn_bwd.cu`` backward inside a
  :class:`torch.autograd.Function`, or an error: there is no fallback;
* for CPU tensors, in its plain version, :func:`flash_attention_reference`
  (the additive biases of ``ops/attention.py`` and
  ``scaled_dot_product_attention``), differentiated by autograd.

The two agree on every row that sees a key. A row that sees none (a batch
row of length 0, a padded row past a window) is 0 from the kernel and a
uniform average from the plain version; such rows are padding, which the
JAX package leaves undefined too (``nn.py:1007-1012``) and the masked losses
discard.

What bounds the kernels: their products, 4 * P * dh flops forward and at
least 10 * P * dh backward for P visible (query, key) pairs, against
O(B * T * H * dh) bytes: they are bound by operations. So every product
runs on the tensor cores, as ``mma.sync`` in TF32 with each f32 operand
split into a TF32 high part and the low rest and three products summed in
f32 (3xTF32: within a few 2^-20 of f32, where one TF32 product alone misses
the 1e-4 the card checks hold them to). The kernels keep the T x T logits out of device
memory (an online softmax over key tiles of 64, recomputed in the backward
from the saved log-sum-exp), stream k and v (q and do in the dk/dv pass)
through a two-stage ``cp.async`` ring, and skip key tiles that no row of a
query tile sees, so windowed attention is linear in T.
"""
import ctypes

import torch

from morgana_tpu_torch.ops import attention as attention_ops
from morgana_tpu_torch.ops._kernels import check_operands, load_library, raise_on_error

__all__ = ['flash_attention', 'flash_attention_reference', 'attention_bias', 'attention_forward',
           'attention_backward', 'launches', 'bwd_launches', 'HEAD_DIMS']

# Launches of the forward kernel and of the backward (its two kernels count
# once), each counted where its wrapper launches and nowhere else.
launches = 0
bwd_launches = 0

#: The head widths the kernels are built for (a template each).
HEAD_DIMS = (64, 96, 128)
_MAX_BATCH_HEADS = 65535  # the grid's y dimension


def attention_bias(seq_len, max_len, causal=False, window=None, device=None):
    """The additive bias of the JAX package's exact path (``nn.py:931-937``):
    key padding from ``seq_len`` plus the causal or sliding-window mask, or
    None when there is neither."""
    bias = None
    if seq_len is not None:
        bias = attention_ops.padding_bias(torch.as_tensor(seq_len, device=device), max_len)
    if causal:
        mask = (attention_ops.local_causal_bias(max_len, window, device=device) if window
                else attention_ops.causal_bias(max_len, device=device))
        bias = mask if bias is None else bias + mask
    return bias


def flash_attention_reference(q, k, v, seq_len=None, causal=False, window=None):
    """Plain version of the kernel: the biases plus
    :func:`~morgana_tpu_torch.ops.attention.scaled_dot_product_attention`,
    on any device."""
    _check_window(causal, window)
    bias = attention_bias(seq_len, q.shape[2], causal, window, device=q.device)
    return attention_ops.scaled_dot_product_attention(q, k, v, bias=bias)


def _check_window(causal, window):
    if window is not None and not causal:
        raise ValueError('window (sliding-window attention) requires causal=True')


def _lengths(seq_len, batch, device):
    """``seq_len`` as the kernels' int32 (B,) tensor on ``device``, or None."""
    if seq_len is None:
        return None
    return torch.as_tensor(seq_len, device=device).reshape(batch).to(torch.int32).contiguous()


def _check(kernel, tensors, device):
    """Raises, before any launch, on what the kernels do not take; returns
    ``(B, H, T, dh)``."""
    q = tensors['q']
    if q.ndim != 4:
        raise ValueError(f'{kernel}: q must be (B, H, T, dh), got {tuple(q.shape)}')
    batch, heads, time, head_dim = q.shape
    if head_dim not in HEAD_DIMS:
        raise ValueError(f'{kernel}: the attention kernels take dh in {HEAD_DIMS}, got {head_dim}')
    if batch * heads > _MAX_BATCH_HEADS:
        raise ValueError(f'{kernel}: B * H must be at most {_MAX_BATCH_HEADS}, got {batch * heads}')
    shapes = {'lse': (batch, heads, time)}
    check_operands(kernel, {name: (t, shapes.get(name, tuple(q.shape)))
                            for name, t in tensors.items()}, device)
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f'{kernel}: {name} must be 16-byte aligned (the kernels read float4)')
    return batch, heads, time, head_dim


def attention_forward(q, k, v, seq_len=None, causal=False, window=None):
    """Launches the forward kernel on PyTorch's current stream; raises on
    anything it does not take, and on a refused or failed launch. Returns
    ``(o, lse)``, lse (B, H, T) the log-sum-exp of each row's scaled
    logits (+inf for a row that sees no key)."""
    global launches
    _check_window(causal, window)
    batch, heads, time, head_dim = _check('K5/K6 forward', {'q': q, 'k': k, 'v': v}, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((batch, heads, time), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse.fill_(float('inf'))
    lengths = _lengths(seq_len, batch, q.device)
    lib, fn = load_library('attn_fwd', 'morgana_attn_fwd',
                           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if lengths is None else lengths.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), batch, heads, time, head_dim, int(causal),
                 int(window or 0), q.device.index, stream)
    raise_on_error(lib, err, f'attention kernel K5/K6 forward at B={batch} H={heads} T={time} '
                   f'dh={head_dim}', 'a block keeps two stages of a 64 x (dh + 16) k and a '
                   '64 x (dh + 4) v f32 tile in shared memory (106 KB at dh 96)')
    launches += 1
    return o, lse


def attention_backward(q, k, v, o, lse, do, seq_len=None, causal=False, window=None):
    """Launches the backward (its two kernels) on PyTorch's current stream;
    raises on anything it does not take, and on a refused or failed launch.
    Returns ``(dq, dk, dv)``."""
    global bwd_launches
    _check_window(causal, window)
    batch, heads, time, head_dim = _check(
        'K5/K6 backward', {'q': q, 'k': k, 'v': v, 'o': o, 'lse': lse, 'do': do}, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((batch, heads, time), dtype=torch.float32, device=q.device)
    lengths = _lengths(seq_len, batch, q.device)
    lib, fn = load_library('attn_bwd', 'morgana_attn_bwd',
                           [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), None if lengths is None else lengths.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), batch, heads, time, head_dim, int(causal),
                 int(window or 0), q.device.index, stream)
    raise_on_error(lib, err, f'attention kernel K5/K6 backward at B={batch} H={heads} T={time} '
                   f'dh={head_dim}', 'a block of either kernel keeps two 64 x (dh + 16) f32 '
                   'tiles and two stages of two 32-row tiles in shared memory (109 KB at '
                   'dh 96)')
    bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``(q, k, v) -> o`` with the forward kernel, and the backward kernel
    over the saved q, k, v, o and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, seq_len, causal, window):
        o, lse = attention_forward(q, k, v, seq_len, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (seq_len, causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, o, lse, do.contiguous(), *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, seq_len=None, causal=False, window=None):
    r"""Exact attention over batched heads with the JAX package's masks.

    Parameters
    ----------
    q, k, v : torch.Tensor, shape (batch, heads, T, head_dim)
        On the GPU: float32, contiguous, head_dim in :data:`HEAD_DIMS`.
    seq_len : (batch,) or (batch, 1), optional
        Valid lengths: keys at or past ``seq_len`` are hidden.
    causal : bool
    window : int, optional
        With ``causal``, query ``i`` sees keys ``i - window < j <= i``.

    Returns
    -------
    o : (batch, heads, T, head_dim); rows at or past ``seq_len`` are padding.
    """
    if q.device.type == 'cuda':
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return _FlashAttention.apply(q, k, v, seq_len, causal, window)
        return attention_forward(q, k, v, seq_len, causal, window)[0]
    if q.device.type == 'cpu':
        return flash_attention_reference(q, k, v, seq_len, causal, window)
    raise ValueError(f'no attention for device {q.device}')
