"""The arithmetic of the bf16 tensor-core kernels, on the CPU.

K5b's backward (``csrc/attn_bwd_bf16.cu``) and the bf16 weight-gradient
carry (``csrc/rnn_dw_bf16.cu``) multiply an f32 operand (do, dS, the gate
gradients) by a bf16 one on bf16 tensor cores: the f32 operand goes in as
three bf16 planes, hi = x truncated to bf16, mid = (x - hi) truncated, lo
= x - hi - mid (``split3_pack`` in ``csrc/attn_common.cuh``), one
``mma.sync.m16n8k16`` a plane, lo first, each summing 16 products in f32.
The kernels run only on the card; these tests check here that the split is
exact and that each kernel's order of operations, emulated in plain torch,
meets the bounds its card tests hold it to: against its plain version
(``bf16_weight_grad_reference``, ``attention_backward_reference``) within
``BF16_ULPS`` bf16 ulps of the largest |value| and nearer in the mean to
it than to the f32 plain version, and against the JAX package's autodiff
under bf16 with the tolerances of ``tests/test_torch_bf16_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu.ops import attention as jattention
from morgana_tpu.ops import rnn as jrnn

from morgana_tpu_torch.ops import flash_attention as fa
from morgana_tpu_torch.ops import gru as gru_ops
from morgana_tpu_torch.ops import lstm as lstm_ops
from morgana_tpu_torch.ops import weight_grad

BF16_ULPS = 4             # tests/test_torch_kernels.py, chip_smoke.py
CARRY_RTOL = 5e-3         # tests/test_torch_bf16_train.py
CARRY_OFF = 0.05
GRAD_MAX_RTOL = 2.0 ** -7
GRAD_MEAN_RTOL = 2e-4
K_STEP = 16               # the depth of mma.sync.m16n8k16
CHUNK = 32                # the carry's batch rows an item
STREAM = 32               # K5b's backward: keys (dq) or queries (dk/dv) a streamed tile


def split3(x):
    """The three bf16 planes of f32 ``x`` (any shape), as the kernels make
    them: each a float32 tensor holding bf16 values."""
    def trunc(y):
        return (y.view(torch.int32) & -65536).view(torch.float32)

    hi = trunc(x)
    rest = x - hi
    mid = trunc(rest)
    return hi, mid, rest - mid


def round_bf16(x):
    return x.to(torch.bfloat16).float()


def is_bf16(x):
    return bool(((x.view(torch.int32) & 0xffff) == 0).all())


def _split_inputs():
    """f32 values across magnitudes (2^-100 .. 2^100), both signs, zeros,
    powers of two, bf16 values, the bf16 rounding ties between two bf16
    neighbours and the f32 values either side of each tie, and the largest
    f32 below the overflow of bf16's rounding."""
    rng = np.random.default_rng(140)
    mags = rng.normal(size=4000) * 2.0 ** rng.integers(-100, 100, 4000)
    bf = round_bf16(torch.from_numpy(rng.normal(size=2000).astype(np.float32)))
    half_ulp = 2.0 ** (torch.floor(torch.log2(bf.abs())) - 8)
    ties = bf + torch.sign(bf) * half_ulp
    near = torch.cat([torch.nextafter(ties, ties + 1), torch.nextafter(ties, ties - 1)])
    special = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0 ** -126, 2.0 ** 127, -2.0 ** 100,
                            float(np.float32(3.4028235e38)), 1.0 + 2.0 ** -23, 1.0 - 2.0 ** -24])
    return torch.cat([torch.from_numpy(mags.astype(np.float32)), bf, ties, near, special])


def test_three_plane_split_is_exact():
    """hi, mid and lo are bf16 values whose sum is x exactly (in f64), and
    hi + mid + lo in f32 gives x back, for every input of _split_inputs."""
    x = _split_inputs()
    planes = split3(x)
    assert all(is_bf16(p) for p in planes)
    total = sum(p.double() for p in planes)
    torch.testing.assert_close(total, x.double(), rtol=0, atol=0)
    torch.testing.assert_close((planes[2] + planes[1]) + planes[0], x, rtol=0, atol=0)


def test_plane_products_sum_to_the_f32_product():
    """Each plane times a bf16 value is exact in f32, and the three products
    summed in f64 are the f64 product of x and that value: three bf16
    passes compute the f32 operand's product, not a rounded one."""
    x = _split_inputs()
    rng = np.random.default_rng(141)
    b = round_bf16(torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)))
    b = b * 2.0 ** torch.from_numpy(rng.integers(-8, 8, x.shape)).float()
    keep = (x.double() * b.double()).abs() < 1e38   # inside f32's range
    x, b = x[keep], b[keep]
    products = [p * b for p in split3(x)]
    for p, prod in zip(split3(x), products):
        torch.testing.assert_close(prod.double(), p.double() * b.double(), rtol=0, atol=0)
    torch.testing.assert_close(sum(prod.double() for prod in products),
                               x.double() * b.double(), rtol=0, atol=0)


# ----------------------------------------------------------------- the carry

def planes_product(a, b_f32, acc):
    """acc += a^T . b over the depth in 16-row k-steps, b as its three bf16
    planes, lo first: one mma.sync a plane and k-step, f32 sums. a (K, M)
    holds bf16 values, b_f32 (K, N) f32; the depth is padded to a whole
    k-step with zeros."""
    depth = a.shape[0]
    pad = (-depth) % K_STEP
    a = torch.cat([a, a.new_zeros((pad, a.shape[1]))])
    b_f32 = torch.cat([b_f32, b_f32.new_zeros((pad, b_f32.shape[1]))])
    hi, mid, lo = split3(b_f32)
    for k0 in range(0, depth + pad, K_STEP):
        for plane in (lo, mid, hi):
            acc = acc + torch.matmul(a[k0:k0 + K_STEP].t(), plane[k0:k0 + K_STEP])
    return acc


def emulated_carry(h_prev, dg):
    """csrc/rnn_dw_bf16.cu's order of operations: t from T-1 down, each
    step's batch in 32-row items of two 16-deep k-steps, h rounded to bf16,
    dg in three planes, one f32 accumulator a step, rounded and added into
    the bf16 carry with bf16 rounding."""
    time_steps, batch, hidden = h_prev.shape
    carry = torch.zeros((hidden, dg.shape[2]))
    for t in range(time_steps - 1, -1, -1):
        acc = torch.zeros_like(carry)
        for b0 in range(0, batch, CHUNK):
            acc = planes_product(round_bf16(h_prev[t, b0:b0 + CHUNK]), dg[t, b0:b0 + CHUNK], acc)
        carry = round_bf16(carry + round_bf16(acc))
    return carry


def _hold_bf16(got, want, f32, steps_act=True):
    """got within BF16_ULPS bf16 ulps of the largest |want| and, where the
    roundings have a step to act on, nearer in the mean to want than to
    f32."""
    got, want, f32 = ([t.float() for t in ts] for ts in (got, want, f32))
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert err <= BF16_ULPS * 2.0 ** -7 * scale, (err, scale)
    if steps_act:
        near = sum(float((g - w).abs().sum()) for g, w in zip(got, want))
        far = sum(float((g - o).abs().sum()) for g, o in zip(got, f32))
        assert near < far, (near, far)


@pytest.mark.parametrize('steps,batch,hidden,gates', [(64, 4, 32, 128), (33, 40, 20, 60),
                                                      (9, 17, 8, 24), (1, 32, 16, 64)])
def test_emulated_carry_matches_its_plain_version(steps, batch, hidden, gates):
    """The carry's emulation against bf16_weight_grad_reference: bf16 values
    within BF16_ULPS ulps of the largest |value| and nearer in the mean to
    it than to the f32 sum rounded once; at B4 H32 T64, one k-step of 4
    rows, and at batches past one item (40) and no multiple of a k-step."""
    rng = np.random.default_rng(142)
    h_prev = torch.from_numpy(rng.normal(size=(steps, batch, hidden)).astype(np.float32))
    dg = torch.from_numpy(1e-2 * rng.normal(size=(steps, batch, gates)).astype(np.float32))
    got = emulated_carry(h_prev, dg)
    assert is_bf16(got)
    want = weight_grad.bf16_weight_grad_reference(h_prev, dg)
    once = round_bf16(torch.einsum('tbh,tbg->hg', round_bf16(h_prev), dg))
    _hold_bf16([got], [want], [once], steps_act=steps > 1)


@pytest.mark.parametrize('mode', ['lstm', 'gru'])
def test_emulated_carry_in_the_layer_matches_jax(mode, monkeypatch):
    """dW_hh of the layer's plain version with the carry's emulation in
    place of its plain carry, at B4 H32 T64 I16 under bf16, against jax.grad
    of ops.rnn.lstm / gru(compute_dtype=bf16): the bounds of
    tests/test_torch_bf16_train.py (largest error within CARRY_RTOL of the
    largest |JAX|, at most CARRY_OFF of the elements more than one bf16 ulp
    off)."""
    ops = lstm_ops if mode == 'lstm' else gru_ops
    monkeypatch.setattr(ops, 'bf16_weight_grad_reference', emulated_carry)
    jax_fn = jrnn.lstm if mode == 'lstm' else jrnn.gru
    rng = np.random.default_rng(143)
    hidden, gates = 32, (4 if mode == 'lstm' else 3) * 32
    x = rng.normal(size=(4, 64, 16)).astype(np.float32)
    weights = [rng.uniform(-hidden ** -0.5, hidden ** -0.5, shape).astype(np.float32)
               for shape in ((16, gates), (hidden, gates), (gates,), (gates,))]
    seq_len = np.array([64, 59, 32, 1])
    dy = rng.normal(size=(4, 64, hidden)).astype(np.float32)

    def loss(*w):
        y = jax_fn(jnp.asarray(x), *w, seq_len=jnp.asarray(seq_len),
                   compute_dtype=jnp.bfloat16)[0]
        return jnp.sum(y * dy)

    want = np.asarray(jax.grad(loss, argnums=1)(*map(jnp.asarray, weights)), np.float64)
    leaves = [torch.from_numpy(w).requires_grad_(True) for w in weights]
    y = ops.__dict__[f'{mode}_layer_reference'](torch.from_numpy(x), *leaves,
                                                seq_len=torch.from_numpy(seq_len),
                                                compute_dtype='bfloat16')[0]
    (y * torch.from_numpy(dy)).sum().backward()
    got = leaves[1].grad.numpy().astype(np.float64)
    err = np.abs(got - want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert err.max() <= CARRY_RTOL * np.abs(want).max(), err.max() / np.abs(want).max()
    assert np.mean(err > ulp) <= CARRY_OFF, np.mean(err > ulp)


# ------------------------------------------------------- K5b's backward

def emulated_k5b_backward(q, k, v, do, seq_len=None, causal=False, window=None):
    """csrc/attn_bwd_bf16.cu's order of operations on bf16 q, k, v and f32
    do (B, H, T, dh): S = q.k^T in one pass a 16-feature k-step, dP = do.v^T
    a pass a plane of do, lo first; P = 2^(S s log2e - lse log2e) with the
    forward's lse; D summed over the 32-key streamed tiles (the first sweep)
    from the f32 P and bf16(dP); dS = P (bf16(dP) - D); dq = bf16(s sum
    dS.k) over 16-key k-steps a plane of dS; dv = bf16(sum bf16(P)^T.do)
    and dk = bf16(s sum dS^T.q) over 16-query k-steps a plane of do or dS."""
    time_steps, head_dim = q.shape[2:]
    qf, kf, vf = (t.float() for t in (q, k, v))
    scale, log2e = 1.0 / np.sqrt(head_dim), 1.4426950408889634
    bias = fa.attention_bias(seq_len, time_steps, causal, window)
    seen = torch.ones((1, 1, time_steps, time_steps), dtype=torch.bool)
    if bias is not None:
        seen = bias.float() == 0
    do_planes, s, dp = split3(do.float()), 0.0, 0.0
    for c in range(0, head_dim, K_STEP):
        s = s + torch.matmul(qf[..., c:c + K_STEP], kf[..., c:c + K_STEP].transpose(-1, -2))
        for plane in do_planes[::-1]:
            dp = dp + torch.matmul(plane[..., c:c + K_STEP],
                                   vf[..., c:c + K_STEP].transpose(-1, -2))
    lse = torch.logsumexp(torch.where(seen, s * scale, -torch.inf), -1, keepdim=True)
    p = torch.where(seen, torch.exp2(s * (scale * log2e) - lse * log2e), 0.0)
    dpr = round_bf16(dp)
    delta = 0.0
    for k0 in range(0, time_steps, STREAM):
        delta = delta + (p[..., k0:k0 + STREAM] * dpr[..., k0:k0 + STREAM]).sum(-1, keepdim=True)
    ds_planes, pb = split3(p * (dpr - delta)), round_bf16(p)
    dq = dk = dv = 0.0
    for j in range(0, time_steps, K_STEP):
        rows = slice(j, j + K_STEP)
        for plane in ds_planes[::-1]:
            dq = dq + torch.matmul(plane[..., rows], kf[..., rows, :])
            dk = dk + torch.matmul(plane[..., rows, :].transpose(-1, -2), qf[..., rows, :])
        for plane in do_planes[::-1]:
            dv = dv + torch.matmul(pb[..., rows, :].transpose(-1, -2), plane[..., rows, :])
    return tuple(t.to(torch.bfloat16) for t in (dq * scale, dk * scale, dv))


K5B_MASKS = {'full': (False, None, False), 'padded': (False, None, True),
             'causal': (True, None, True), 'window': (True, 7, True)}


def _attention_case(mask):
    causal, window, padded = K5B_MASKS[mask]
    rng = np.random.default_rng(144 + len(mask))
    q, k, v = (rng.normal(size=(2, 2, 40, 64)).astype(np.float32) for _ in range(3))
    seq_len = np.array([40, 23]) if padded else None
    rows = np.arange(40)[None, :] < (np.full(2, 40) if seq_len is None else seq_len)[:, None]
    do = rng.normal(size=q.shape).astype(np.float32) * rows[:, None, :, None]
    return q, k, v, do, seq_len, causal, window


@pytest.mark.parametrize('mask', list(K5B_MASKS))
def test_emulated_k5b_backward_matches_plain_version_and_jax(mask):
    """K5b's backward emulated at B2 H2 T40 dh64 against
    attention_backward_reference on the same bf16 q, k, v (within BF16_ULPS
    ulps of the largest |value| of the three gradients, nearer in the mean
    than the f32 plain version) and against jax.grad of JAX's plain
    attention under bf16 (GRAD_MAX_RTOL, GRAD_MEAN_RTOL)."""
    q, k, v, do, seq_len, causal, window = _attention_case(mask)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    sl = None if seq_len is None else torch.from_numpy(seq_len)
    mask_kw = dict(seq_len=sl, causal=causal, window=window)
    got = emulated_k5b_backward(qb, kb, vb, torch.from_numpy(do), **mask_kw)
    want = fa.attention_backward_reference(qb, kb, vb, torch.from_numpy(do), **mask_kw)
    f32 = fa.attention_backward_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                          torch.from_numpy(do), **mask_kw)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _hold_bf16(got, want, f32)

    bias = fa.attention_bias(sl, 40, causal, window)

    def loss(q, k, v):
        out = jattention.scaled_dot_product_attention(
            q, k, v, bias=None if bias is None else jnp.asarray(bias.numpy()),
            compute_dtype=jnp.bfloat16)
        return jnp.sum(out * do)

    jax_grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, g, w in zip('qkv', got, jax_grads):
        g, w = g.float().numpy().astype(np.float64), np.asarray(w, np.float64)
        err, top = np.abs(g - w), np.abs(w).max()
        assert err.max() <= GRAD_MAX_RTOL * top and err.mean() <= GRAD_MEAN_RTOL * top, \
            (f'd{name}', err.max() / top, err.mean() / top)
