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
import torch

__all__ = ['as_compute_dtype', 'matmul', 'rounded']

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


def rounded(t, compute_dtype):
    """``t`` with its values rounded to ``compute_dtype`` and kept in its own
    dtype (``t`` itself when there is none): what a product under that
    compute dtype reads."""
    return t if compute_dtype is None else t.to(compute_dtype).to(t.dtype)


def matmul(x, w, compute_dtype=None):
    """``x @ w`` (``w`` 2-D) with both inputs rounded to ``compute_dtype`` and
    the sums and the result in ``x.dtype`` (``nn.py:110-121``, ``_matmul``).
    On the GPU one bf16 GEMM with float32 output (``aten::mm.dtype``, a
    library GEMM as the JAX package leaves its dense products to XLA); on the
    CPU the float32 product of the rounded operands, the same function."""
    if compute_dtype is None:
        return torch.matmul(x, w)
    if x.device.type == 'cuda':
        out = torch.mm(x.reshape(-1, x.shape[-1]).to(compute_dtype), w.to(compute_dtype),
                       out_dtype=x.dtype)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(rounded(x, compute_dtype), w.to(compute_dtype).to(x.dtype))
