"""Exact self-attention over a padded batch with key padding, causal and
sliding-window masks: the port of the JAX package's two TPU attention
kernels, ``MultiHeadAttention._splash`` (``morgana_tpu/nn.py:1001``, the
default 'auto' backend) and ``MultiHeadAttention._flash`` (``nn.py:1055``).

:func:`flash_attention` takes q, k, v in the JAX layout (B, H, T, dh) and
computes, per row ``i`` of batch row ``b``, the softmax of ``q_i . k_j /
sqrt(dh)`` over the keys ``j`` it sees (``j < seq_len[b]``; with ``causal``
also ``j <= i``; with ``window`` also ``i - j < window``) times v:

* for CUDA tensors, in kernel K5/K6: ``csrc/attn_fwd.cu`` forward
  (``csrc/attn_fwd_bf16.cu``, K5b, for bf16 q, k and v) and, when a gradient
  is needed, ``csrc/attn_bwd.cu`` backward (``csrc/attn_bwd_bf16.cu`` for
  bf16 q, k and v) inside a :class:`torch.autograd.Function`, or an error:
  there is no fallback;
* for CPU tensors, in its plain version, :func:`flash_attention_reference`
  (the additive biases of ``ops/attention.py`` and
  ``scaled_dot_product_attention``), differentiated by autograd when a
  gradient is needed.

With ``compute_dtype`` bf16 (the splash and flash calls on bf16 operands,
``nn.py:1018-1019``, :1063-1064) q, k and v go to the kernels as bf16, and
the forward runs in K5b: a block of 128 query rows, two warpgroups of 64
rows running both products as ``wgmma`` in bf16 with f32 sums (q.k^T from
shared memory, P.V with P from registers and v read as it lies), fed with
128-key tiles of k and v by a TMA producer through a ring of ``mbarrier``
stages; the unnormalised probabilities rounded to bf16 before P.V, the
softmax statistics and o in float32. o stays float32, as the JAX package's exact path returns it (its splash
kernel rounds o to bf16; the tests hold the port to the exact path). Its
plain version is ``scaled_dot_product_attention(compute_dtype=bf16)``. Its
backward, K5b's backward (``csrc/attn_bwd_bf16.cu``), is the autodiff of
that plain version, which rounds ``do @ v^T`` and the probabilities before
``dv`` to bf16, takes the softmax's row term ``D_i`` as ``sum_j P_ij
bf16(dP_ij)``, and returns dq, dk and dv rounded to bf16
(:func:`attention_backward_reference`): bf16 tiles in shared memory, q.k^T
as one bf16 ``mma.sync`` m16n8k16, and each product with an f32 operand
(do, dS) as three bf16 passes over the operand's three bf16 planes, which
add back to it exactly.

The kernels are the custom ops ``morgana::attn_fwd`` and ``morgana::attn_bwd``
(:func:`attn_fwd`, :func:`attn_bwd`; their ``cuda`` implementations launch
the kernels, their ``cpu`` ones are the plain version and its backward).

The two agree on every row that sees a key. A row that sees none (a batch
row of length 0, a padded row past a window) is 0 from the kernel and a
uniform average from the plain version; such rows are padding, which the
JAX package leaves undefined too (``nn.py:1007-1012``) and the masked losses
discard.

What bounds the kernels: their products, 4 * P * dh flops forward and at
least 10 * P * dh backward for P visible (query, key) pairs, against
O(B * T * H * dh) bytes: in f32 they are bound by operations (K5b, on
the bf16 tensor cores, by its bytes). So every product runs on the tensor
cores; in f32 as ``mma.sync`` in TF32 with each f32
operand split into a TF32 high part and the low rest and three products
summed in f32 (3xTF32: within a few 2^-20 of f32, where one TF32 product
alone misses the 1e-4 the card checks hold them to). The kernels keep the
T x T logits out of device memory (an online softmax over key tiles of 64,
128 in K5b, recomputed in the backward from the saved log-sum-exp), stream
k and v (q and do in the dk/dv pass) through a ``cp.async`` ring (K5b: TMA),
and skip key tiles
that no row of a query tile sees, so windowed attention is linear in T.
"""
import ctypes
import math
from typing import Optional

import torch

from morgana_tpu_torch.ops import attention as attention_ops
from morgana_tpu_torch.ops import precision
from morgana_tpu_torch.ops._kernels import (check_device, check_operands, load_library,
                                            no_alias, raise_on_error)

__all__ = ['flash_attention', 'flash_attention_reference', 'attention_bias', 'attention_forward',
           'attention_backward', 'attention_backward_reference', 'attn_fwd', 'attn_bwd',
           'launches', 'bwd_launches', 'bf16_launches', 'bf16_bwd_launches', 'HEAD_DIMS']

# Launches of the forward kernel and of the backward (its two kernels count
# once), each counted where its wrapper launches and nowhere else; among
# them, bf16_launches and bf16_bwd_launches are those of their bf16 builds
# (K5b and its backward).
launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0

#: The head widths the kernels are built for (a template each).
HEAD_DIMS = (64, 96, 128)

_MAX_BATCH_HEADS = 65535  # the f32 kernels' grid y dimension; the same bound for all

# morgana_attn_fwd_bf16's argument types: q, k, v, seq_len, o, lse, then B,
# H, T, dh, causal, window, device, then the stream.
FWD_BF16_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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


def flash_attention_reference(q, k, v, seq_len=None, causal=False, window=None,
                              compute_dtype=None):
    """Plain version of the kernel: the biases plus
    :func:`~morgana_tpu_torch.ops.attention.scaled_dot_product_attention`
    (with ``compute_dtype``), on any device."""
    _check_window(causal, window)
    bias = attention_bias(seq_len, q.shape[2], causal, window, device=q.device)
    return attention_ops.scaled_dot_product_attention(q, k, v, bias=bias,
                                                      compute_dtype=compute_dtype)


def _check_window(causal, window):
    if window is not None and not causal:
        raise ValueError('window (sliding-window attention) requires causal=True')


def _lengths(seq_len, batch, device):
    """``seq_len`` as the kernels' int32 (B,) tensor on ``device``, or None."""
    if seq_len is None:
        return None
    return torch.as_tensor(seq_len, device=device).reshape(batch).to(torch.int32).contiguous()


def _check(kernel, tensors, device, dtype=torch.float32):
    """Raises, before any launch, on what the kernels do not take: q, k and v
    in ``dtype`` (float32, or bf16 for K5b and its backward), every other
    operand float32; returns ``(B, H, T, dh)``."""
    q = tensors['q']
    if q.ndim != 4:
        raise ValueError(f'{kernel}: q must be (B, H, T, dh), got {tuple(q.shape)}')
    batch, heads, time, head_dim = q.shape
    if head_dim not in HEAD_DIMS:
        raise ValueError(f'{kernel}: the attention kernels take dh in {HEAD_DIMS}, got {head_dim}')
    if batch * heads > _MAX_BATCH_HEADS:
        raise ValueError(f'{kernel}: B * H must be at most {_MAX_BATCH_HEADS}, got {batch * heads}')
    shapes = {'lse': (batch, heads, time)}
    check_operands(kernel, {name: (t, shapes.get(name, tuple(q.shape)),
                                   dtype if name in 'qkv' else torch.float32)
                            for name, t in tensors.items()}, device,
                   dtypes=(torch.float32, torch.bfloat16))
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f'{kernel}: {name} must be 16-byte aligned (the kernels read 16 '
                             'bytes at a time)')
    return batch, heads, time, head_dim


def attention_forward(q, k, v, seq_len=None, causal=False, window=None):
    """Launches the forward kernel on PyTorch's current stream: K5 for f32
    q, k and v, K5b for bf16 ones; raises on anything it does not take, and
    on a refused or failed launch. Returns ``(o, lse)``, both float32, lse
    (B, H, T) the log-sum-exp of each row's scaled logits (+inf for a row
    that sees no key)."""
    global launches, bf16_launches
    _check_window(causal, window)
    bf16 = q.dtype == torch.bfloat16
    name = 'K5b forward' if bf16 else 'K5/K6 forward'
    batch, heads, time, head_dim = _check(name, {'q': q, 'k': k, 'v': v}, q.device,
                                          torch.bfloat16 if bf16 else torch.float32)
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((batch, heads, time), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse.fill_(float('inf'))
    lengths = _lengths(seq_len, batch, q.device)
    if bf16:
        lib, fn = load_library('attn_fwd_bf16', 'morgana_attn_fwd_bf16', FWD_BF16_ARGTYPES)
        hint = ('a block of 384 threads keeps 128 rows of q and three stages of a 128-key k '
                'and v tile in shared memory (225 KB at dh 96 and 128, 113 KB at dh 64), and '
                'encodes TMA tensor maps through the driver (libcuda.so.1)')
    else:
        lib, fn = load_library('attn_fwd', 'morgana_attn_fwd',
                               [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        hint = ('a block keeps two stages of a 64-row k and v tile in shared memory (106 KB at '
                'dh 96)')
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if lengths is None else lengths.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), batch, heads, time, head_dim, int(causal),
                 int(window or 0), q.device.index, stream)
    raise_on_error(lib, err, f'attention kernel {name} at B={batch} H={heads} T={time} '
                   f'dh={head_dim}', hint)
    launches += 1
    bf16_launches += bf16
    return o, lse


def attention_backward(q, k, v, o, lse, do, seq_len=None, causal=False, window=None):
    """Launches the backward (its two kernels) on PyTorch's current stream:
    K5/K6's for f32 q, k and v, K5b's (``csrc/attn_bwd_bf16.cu``) for bf16
    ones; raises on anything it does not take, and on a refused or failed
    launch. Returns ``(dq, dk, dv)`` in the type of q, k and v."""
    global bwd_launches, bf16_bwd_launches
    _check_window(causal, window)
    bf16 = q.dtype == torch.bfloat16
    name = 'K5b backward' if bf16 else 'K5/K6 backward'
    batch, heads, time, head_dim = _check(
        name, {'q': q, 'k': k, 'v': v, 'o': o, 'lse': lse, 'do': do}, q.device,
        torch.bfloat16 if bf16 else torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((batch, heads, time), dtype=torch.float32, device=q.device)
    lengths = _lengths(seq_len, batch, q.device)
    if bf16:
        # do's three bf16 planes, written by the dq kernel for the dk/dv one.
        scratch = torch.empty((3, *q.shape), dtype=torch.bfloat16, device=q.device)
        lib, fn = load_library('attn_bwd_bf16', 'morgana_attn_bwd_bf16',
                               [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        inputs = (q, k, v, do, lse, lengths, delta, scratch)
        hint = ('a dq block keeps the three bf16 planes of its 64 do rows and three stages of '
                'a 32-row k and v tile in shared memory (78 KB at dh 96), a dk/dv block its '
                "64 k and v rows and three stages of 32 q rows and do's planes (105 KB at dh "
                '96; two stages at dh 128)')
    else:
        lib, fn = load_library('attn_bwd', 'morgana_attn_bwd',
                               [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        inputs = (q, k, v, o, do, lse, lengths, delta)
        hint = ('a block of either kernel keeps two 64 x (dh + 16) f32 tiles and two stages '
                'of two 32-row tiles in shared memory (109 KB at dh 96)')
    with torch.cuda.device(q.device):
        err = fn(*(None if t is None else t.data_ptr() for t in inputs + (dq, dk, dv)),
                 batch, heads, time, head_dim, int(causal), int(window or 0), q.device.index,
                 torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(lib, err, f'attention kernel {name} at B={batch} H={heads} T={time} '
                   f'dh={head_dim}', hint)
    bwd_launches += 1
    bf16_bwd_launches += bf16
    return dq, dk, dv


def attention_backward_reference(q, k, v, do, seq_len=None, causal=False, window=None):
    """Plain version of the backward, on any device: ``(dq, dk, dv)`` of the
    plain version for the cotangent ``do``, written out step for step as
    autograd takes it (the softmax's backward as
    ``torch._softmax_backward_data``), in the type of q, k and v. For bf16
    q, k and v (K5b's backward) JAX's roundings: ``dP = bf16(do @ v^T)``,
    ``dv = bf16(bf16(P)^T @ do)``, the softmax's backward in f32 with the f32
    P, and ``dq = bf16(dS @ k)``, ``dk = bf16(dS^T @ q)``."""
    compute = torch.bfloat16 if q.dtype == torch.bfloat16 else None
    scale = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=torch.float32))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale.to(q.device)
    bias = attention_bias(seq_len, q.shape[2], causal, window, device=q.device)
    probs = torch.softmax(logits if bias is None else logits + bias.float(), dim=-1)
    dv = torch.matmul(precision.rounded(probs, compute).transpose(-1, -2), do.float())
    dprobs = precision.rounded(torch.matmul(do.float(), v.float().transpose(-1, -2)), compute)
    dlogits = torch._softmax_backward_data(dprobs, probs, -1, torch.float32) * scale.to(q.device)
    dq = torch.matmul(dlogits, k.float())
    dk = torch.matmul(dlogits.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@torch.library.custom_op('morgana::attn_fwd', mutates_args=(), device_types='cpu')
def attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_len: Optional[torch.Tensor],
             causal: bool, window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``morgana::attn_fwd``, the forward of K5/K6: ``(o, lse)`` with the
    masks of ``seq_len`` (int32 (B,) or None), ``causal`` and ``window`` (0
    for none); q, k and v all float32 (K5) or all bf16 (K5b), o and lse
    float32. This is its ``cpu`` implementation: the plain version, and the
    log-sum-exp of its biased logits."""
    window = window or None
    compute = torch.bfloat16 if q.dtype == torch.bfloat16 else None
    o = flash_attention_reference(q.float(), k.float(), v.float(), seq_len, causal, window,
                                  compute)
    bias = attention_bias(seq_len, q.shape[2], causal, window, device=q.device)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    lse = torch.logsumexp(logits if bias is None else logits + bias, dim=-1)
    return no_alias((o, lse), (q, k, v, seq_len))


@attn_fwd.register_kernel('cuda')
def _attn_fwd_op_cuda(q, k, v, seq_len, causal, window):
    return attention_forward(q, k, v, seq_len, causal, window or None)


@attn_fwd.register_fake
def _attn_fwd_fake(q, k, v, seq_len, causal, window):
    return torch.empty_like(q, dtype=torch.float32), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op('morgana::attn_bwd', mutates_args=(), device_types='cpu')
def attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
             lse: torch.Tensor, do: torch.Tensor, seq_len: Optional[torch.Tensor], causal: bool,
             window: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``morgana::attn_bwd``, the backward of K5/K6 (K5b's backward for bf16
    q, k and v): ``(dq, dk, dv)`` for the cotangent ``do``. This is its
    ``cpu`` implementation, :func:`attention_backward_reference` (``o`` and
    ``lse`` are not read)."""
    return no_alias(attention_backward_reference(q, k, v, do, seq_len, causal, window or None),
                    (q, k, v, o, lse, do, seq_len))


@attn_bwd.register_kernel('cuda')
def _attn_bwd_op_cuda(q, k, v, o, lse, do, seq_len, causal, window):
    return attention_backward(q, k, v, o, lse, do, seq_len, causal, window or None)


@attn_bwd.register_fake
def _attn_bwd_fake(q, k, v, o, lse, do, seq_len, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


class _FlashAttention(torch.autograd.Function):
    """``(q, k, v) -> o`` with :func:`attn_fwd`, and :func:`attn_bwd` over
    the saved q, k, v, o and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, window):
        o, lse = torch.ops.morgana.attn_fwd(q, k, v, lengths, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (lengths, causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = torch.ops.morgana.attn_bwd(q, k, v, o, lse, do.contiguous(), *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, seq_len=None, causal=False, window=None, compute_dtype=None):
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
    compute_dtype : None or torch.bfloat16
        bf16: q, k and v rounded to it, and the probabilities before P.V
        (K5b and its backward on the GPU).

    Returns
    -------
    o : (batch, heads, T, head_dim), float32; rows at or past ``seq_len``
        are padding.
    """
    check_device('attention', q)
    _check_window(causal, window)
    lengths = _lengths(seq_len, q.shape[0], q.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.device.type == 'cpu':
            return flash_attention_reference(q, k, v, seq_len, causal, window, compute_dtype)
        if compute_dtype is not None:   # autograd takes the casts' backward
            q, k, v = (t.to(compute_dtype, memory_format=torch.contiguous_format)
                       for t in (q, k, v))
        return _FlashAttention.apply(q, k, v, lengths, causal, int(window or 0))
    if compute_dtype is not None:
        q, k, v = (t.to(compute_dtype, memory_format=torch.contiguous_format) for t in (q, k, v))
    return torch.ops.morgana.attn_fwd(q, k, v, lengths, causal, int(window or 0))[0]
