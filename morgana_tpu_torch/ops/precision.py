"""The compute dtype of the products (counterpart of the compute-dtype recipe of
``morgana_tpu/nn.py:92-121`` and ``ops/rnn.py::_cast_for_matmul``).

Under a bf16 compute dtype the inputs of a product are rounded to bf16 (round
to nearest even, as XLA's ``astype``) and the products are summed, and
returned, in the input's dtype, float32. A product of two bf16 values is
exact in float32, so "bf16 inputs, f32 accumulation" is the float32 product
of the rounded operands, whichever unit sums it. Only the products round:
gate math, carried states, softmax, normalisation and everything else stay
float32.
"""
import argparse

import torch

__all__ = ['as_compute_dtype', 'compute_dtype_arg', 'matmul', 'rounded']

# The names the JAX package's set_default_compute_dtype takes for "no
# compute dtype" (nn.py:96), and bf16.
_NAMES = {'float32': None, 'f32': None, 'none': None, 'bfloat16': torch.bfloat16}


def as_compute_dtype(dtype):
    """None (float32 products) or ``torch.bfloat16`` for ``dtype``: None,
    ``'float32'``, ``'f32'``, ``'none'``, ``'bfloat16'`` or the torch
    dtypes float32 and bfloat16. Any other dtype raises ``ValueError``:
    the JAX package also computes in e.g. float16, which is not ported."""
    if dtype is None or dtype == torch.float32:
        return None
    if dtype == torch.bfloat16:
        return torch.bfloat16
    if isinstance(dtype, str) and dtype in _NAMES:
        return _NAMES[dtype]
    raise ValueError(f'compute dtype {dtype!r} is not ported: the port computes in float32 or '
                     'bfloat16 (the other dtypes are a gap listed in ROADMAP.md)')


def compute_dtype_arg(value):
    """The argparse type of ``--compute_dtype``: a name
    :func:`morgana_tpu_torch.nn.set_default_compute_dtype` takes, else an
    argparse error naming ROADMAP.md."""
    try:
        as_compute_dtype(value)
    except ValueError as exc:
        raise argparse.ArgumentTypeError(str(exc)) from None
    return value


def rounded(t, compute_dtype):
    """``t`` with its values rounded to ``compute_dtype`` and kept in its own
    dtype (``t`` itself when there is none): what a product under that
    compute dtype reads."""
    return t if compute_dtype is None else t.to(compute_dtype).to(t.dtype)


class _Bf16Matmul(torch.autograd.Function):
    """``x @ w`` (both 2-D, f32) as one GEMM of their roundings to
    ``compute`` with f32 sums and output (``aten::mm.dtype``, which has no
    derivative of its own), and the gradient that JAX's autodiff of
    ``_matmul`` gives: ``dx = round(dout @ w_c^T)`` and ``dw = round(x_c^T @
    dout)``, each the f32 product of the f32 cotangent and a rounded operand
    (an SGEMM of the upcast operand), rounded to ``compute`` as the
    transpose of the cast rounds it. Saves the rounded operands."""

    @staticmethod
    def forward(ctx, x, w, compute):
        x_c, w_c = x.to(compute), w.to(compute)
        ctx.save_for_backward(x_c, w_c)
        ctx.compute = compute
        return torch.mm(x_c, w_c, out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, dout):
        x_c, w_c = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(dout, w_c.to(dout.dtype).t()).to(ctx.compute).to(dout.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x_c.to(dout.dtype).t(), dout).to(ctx.compute).to(dout.dtype)
        return dx, dw, None


def matmul(x, w, compute_dtype=None):
    """``x @ w`` (``w`` 2-D) with both inputs rounded to ``compute_dtype`` and
    the sums and the result in ``x.dtype`` (``nn.py:110-121``, ``_matmul``).
    On the GPU one bf16 GEMM with float32 output (``aten::mm.dtype``, a
    library GEMM as the JAX package leaves its dense products to XLA), its
    gradient by :class:`_Bf16Matmul`; on the CPU the float32 product of the
    rounded operands, the same function, differentiated by autograd through
    the roundings."""
    if compute_dtype is None:
        return torch.matmul(x, w)
    if x.device.type == 'cuda':
        x2 = x.reshape(-1, x.shape[-1])
        # Serving (and torch.export of its programs) keeps the bare GEMM.
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            out = _Bf16Matmul.apply(x2, w, compute_dtype)
        else:
            out = torch.mm(x2.to(compute_dtype), w.to(compute_dtype), out_dtype=x.dtype)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(rounded(x, compute_dtype), w.to(compute_dtype).to(x.dtype))
