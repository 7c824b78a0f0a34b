"""The arithmetic of the bf16 GRU kernels, on the CPU.

K3c (``csrc/gru_fwd_bf16.cu``) and K4c (``csrc/gru_bwd_bf16.cu``) run a
bf16-compute GRU layer of width 32 to 128 in one CTA a group of batch
rows, ``w_hh`` held in bf16 (``csrc/gru_bf16.cuh``). The kernels run only
on the card; these tests emulate, in plain torch, each one's order of
operations:

* K3c: ``hg = bf16(h) @ bf16(w_hh)`` as ``mma.sync.m16n8k16`` products of
  16-deep k-steps, bf16 inputs and f32 sums, the k-steps in four (H up to
  64) or two accumulator chains summed in pairs, then b_hh; h carried in
  f32 and rounded to bf16 once a step, when it is published for the next
  product;
* K4c: its carried product ``dg @ bf16(w_hh)^T`` (dg = ``[da_r, da_z,
  da_n * r]`` in f32) with ``w_hh`` in bf16 widened exactly, each unit's
  3H columns in four slices of 4-column groups, a slice's even and odd
  groups in two chains, the slices summed in pairs as two
  ``__shfl_xor_sync`` do; the product rounded to bf16 before it joins dy.

Each emulation is held to its plain version (``gru_recurrence_reference``,
``gru_backward_reference`` with ``compute_bf16``, through the layer's
masking and gather, ``_plain_layer_forward`` and
``layer_backward_reference``) within ``BF16_ULPS`` bf16 ulps of each
output's largest |value| and, where the roundings have a step to act on,
``BF16_CLOSER`` times nearer in the mean to it than to the f32 plain
version; and, in the layer, to the JAX package's GRU scan under
``compute_dtype=bfloat16`` (the bounds of ``tests/test_torch_bf16.py``)
and to its ``jax.vjp`` (those of ``tests/test_torch_bf16_train.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu.ops import rnn as jrnn
from test_torch_bf16_kernel_design import (BF16_ULPS, CARRY_OFF, CARRY_RTOL, GRAD_MAX_RTOL,
                                           GRAD_MEAN_RTOL, K_STEP, round_bf16)

from morgana_tpu_torch.ops import gru as gru_ops

BF16_CLOSER = 2           # tests/test_torch_kernels.py, chip_smoke.py
MEAN_RTOL = 3e-5          # tests/test_torch_bf16.py: the port's bf16 layers against JAX's
MAX_RTOL = 2.0 ** -8
SLICES = 4                # K4c: threads a unit, each a slice of its 3H columns

_plain_recurrence = gru_ops.gru_recurrence_reference
_plain_backward = gru_ops.gru_backward_reference


def _gates(xg_t, hg, hidden):
    r = torch.sigmoid(xg_t[:, :hidden] + hg[:, :hidden])
    z = torch.sigmoid(xg_t[:, hidden:2 * hidden] + hg[:, hidden:2 * hidden])
    n = torch.tanh(xg_t[:, 2 * hidden:] + r * hg[:, 2 * hidden:])
    return r, z, n


def k3c_product(h_bf16, w):
    """bf16(h) (B, H) times bf16 w_hh (H, 3H) in 16-deep k-steps, f32 sums,
    k-step kk into chain kk % 4 (H <= 64 with a multiple of 4 k-steps) or
    kk % 2, the chains summed in pairs."""
    hidden = w.shape[0]
    steps = hidden // K_STEP
    count = 4 if hidden <= 64 and steps % 4 == 0 else 2
    chains = [torch.zeros(h_bf16.shape[0], w.shape[1]) for _ in range(count)]
    for step, k0 in enumerate(range(0, hidden, K_STEP)):
        chains[step % count] = chains[step % count] + h_bf16[:, k0:k0 + K_STEP] @ w[k0:k0 + K_STEP]
    if count == 4:
        return (chains[0] + chains[1]) + (chains[2] + chains[3])
    return chains[0] + chains[1]


def emulated_k3c(xg, w_hh, b_hh, h0, compute_bf16=False):
    """csrc/gru_fwd_bf16.cu's order of operations on a time-major xg (T, B,
    3H); ``(y, hn)`` as gru_recurrence_reference gives them. Without
    ``compute_bf16``, that plain version."""
    if not compute_bf16:
        return _plain_recurrence(xg, w_hh, b_hh, h0)
    time, batch, gates3 = xg.shape
    hidden = gates3 // 3
    w = round_bf16(w_hh.float())
    h = h0.float()
    ys = []
    for t in range(time):
        hg = k3c_product(round_bf16(h), w) + b_hh.float()
        r, z, n = _gates(xg[t].float(), hg, hidden)
        h = z * (h - n) + n
        ys.append(h)
    if not ys:
        return xg.new_zeros((0, batch, hidden)), h
    return torch.stack(ys), h


def k4c_carry(dg, w):
    """K4c's carried product: each unit's 3H columns in SLICES slices (columns q * 16 +
    s * 4 .. + 3 of group q to slice s), a slice's even and odd groups in
    two f32 chains added, then the slices summed (s0 + s1) + (s2 + s3)."""
    partial = []
    for s in range(SLICES):
        chains = [torch.zeros(dg.shape[0], w.shape[0]) for _ in range(2)]
        for q in range(dg.shape[1] // 16):
            cols = slice(q * 16 + s * 4, q * 16 + s * 4 + 4)
            chains[q % 2] = chains[q % 2] + dg[:, cols] @ w[:, cols].t()
        partial.append(chains[0] + chains[1])
    return (partial[0] + partial[1]) + (partial[2] + partial[3])


def emulated_k4c(xg, hg, w_hh, h0, y, dy, dhn, compute_bf16=False):
    """csrc/gru_bwd_bf16.cu's order of operations, with
    gru_backward_reference's signature and outputs ``(dxg, dh0)``
    (time-major). Without ``compute_bf16``, that plain version."""
    if not compute_bf16:
        return _plain_backward(xg, hg, w_hh, h0, y, dy, dhn)
    time = xg.shape[0]
    hidden = w_hh.shape[0]
    w = round_bf16(w_hh.float())
    dh = dhn.float()
    dxg = [None] * time
    for t in range(time - 1, -1, -1):
        h_prev = (y[t - 1] if t > 0 else h0).float()
        hg_t = hg[t].float()
        r, z, n = _gates(xg[t].float(), hg_t, hidden)
        dh = dy[t].float() + dh
        da_n = dh * (1.0 - z) * (1.0 - n * n)
        da_z = dh * (h_prev - n) * z * (1.0 - z)
        da_r = da_n * hg_t[:, 2 * hidden:] * r * (1.0 - r)
        dxg[t] = torch.cat([da_r, da_z, da_n], dim=-1)
        dh = dh * z + round_bf16(k4c_carry(torch.cat([da_r, da_z, da_n * r], dim=-1), w))
    if not dxg:
        return xg.new_zeros(xg.shape), dh
    return torch.stack(dxg), dh


def _hold(got, want, f32, steps_act):
    """Each of ``got`` within BF16_ULPS bf16 ulps of the largest |value| of
    its ``want``; where the roundings have a step to act on, the mean
    |error| against ``want`` BF16_CLOSER times smaller than against
    ``f32``."""
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        assert err <= BF16_ULPS * 2.0 ** -7 * scale, (err, scale)
    if steps_act:
        near = sum(float((g - w).abs().sum()) for g, w in zip(got, want))
        far = sum(float((g - o).abs().sum()) for g, o in zip(got, f32))
        assert far > 0 and near * BF16_CLOSER <= far, (near, far)


def _layer_operands(batch, steps, hidden, ragged, seed):
    """Seeded batch-major operands of the layer's recurrence: xg (B, T, 3H),
    w_hh, b_hh, h0 and seq_len; with ``ragged`` a given h0 and lengths T,
    1, 0 (an empty row) and then random, else zeros and no seq_len."""
    rng = np.random.default_rng(seed)

    def tensor(array):
        return torch.from_numpy(np.asarray(array, np.float32))

    bound = hidden ** -0.5
    xg = tensor(0.5 * rng.normal(size=(batch, steps, 3 * hidden)))
    w_hh = tensor(rng.uniform(-bound, bound, (hidden, 3 * hidden)))
    b_hh = tensor(rng.uniform(-bound, bound, 3 * hidden))
    if not ragged:
        return xg, w_hh, b_hh, torch.zeros(batch, hidden), None
    h0 = tensor(0.5 * rng.normal(size=(batch, hidden)))
    lens = rng.integers(0, steps + 1, batch)
    lens[:3] = [steps, min(1, steps), 0][:batch]
    return xg, w_hh, b_hh, h0, torch.from_numpy(lens.astype(np.int64))


SIZES = [(batch, steps, hidden) for batch in (1, 5, 9) for steps in (0, 1, 17)
         for hidden in (32, 64, 128)]


@pytest.mark.parametrize('ragged', [False, True], ids=['zero-state', 'state-seq_len'])
@pytest.mark.parametrize('batch,steps,hidden', SIZES)
def test_emulated_k3c_matches_its_plain_version(batch, steps, hidden, ragged, monkeypatch):
    """K3c's emulation in the layer's forward (y zero past seq_len, hn the
    state there) against _plain_layer_forward with bf16 products on the
    same inputs: within BF16_ULPS ulps, and past T = 1 BF16_CLOSER times
    nearer in the mean than to the f32 plain version; B 1, 5, 9, T 0, 1,
    17, H 32, 64, 128, with and without h0 and a ragged seq_len."""
    xg, w_hh, b_hh, h0, seq_len = _layer_operands(batch, steps, hidden, ragged, 180 + hidden)
    want = gru_ops._plain_layer_forward(xg, w_hh, b_hh, h0, seq_len, True)
    f32 = gru_ops._plain_layer_forward(xg, w_hh, b_hh, h0, seq_len)
    monkeypatch.setattr(gru_ops, 'gru_recurrence_reference', emulated_k3c)
    got = gru_ops._plain_layer_forward(xg, w_hh, b_hh, h0, seq_len, True)
    _hold(got, want, f32, steps > 1)


@pytest.mark.parametrize('ragged', [False, True], ids=['zero-state', 'state-seq_len'])
@pytest.mark.parametrize('batch,steps,hidden', SIZES)
def test_emulated_k4c_matches_its_plain_version(batch, steps, hidden, ragged, monkeypatch):
    """K4c's emulation, as the layer launches it (dy within
    seq_len, dhn at seq_len - 1 or at dh0 for an empty row), against
    layer_backward_reference with bf16 products on the plain bf16 forward's
    trace, hg on rounded operands and seeded cotangents (dxg, dnr, dh0):
    within BF16_ULPS ulps, and past T = 1 BF16_CLOSER times nearer in the
    mean than to the f32 plain version; the sizes of the K3c test."""
    xg, w_hh, b_hh, h0, seq_len = _layer_operands(batch, steps, hidden, ragged, 190 + hidden)
    y, _ = gru_ops._plain_layer_forward(xg, w_hh, b_hh, h0, seq_len, True)
    _, hg = gru_ops.hidden_gates(w_hh, b_hh, h0, y, batch_first=True, compute=torch.bfloat16)
    rng = np.random.default_rng(191)
    dy, dhn = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((batch, steps, hidden), (batch, hidden)))
    args = (xg, hg, w_hh, h0, y, dy, dhn, seq_len)
    want = gru_ops.layer_backward_reference(*args, compute_bf16=True)
    f32 = gru_ops.layer_backward_reference(*args)
    monkeypatch.setattr(gru_ops, 'gru_backward_reference', emulated_k4c)
    got = gru_ops.layer_backward_reference(*args, compute_bf16=True)
    _hold(got, want, f32, steps > 1)


def test_the_carry_is_the_f32_product():
    """K4c's carried product equals, within the f32 rounding of its sums,
    the f64 product of the f32 dg and the bf16 w_hh: the widened pairs lose
    nothing of either operand."""
    rng = np.random.default_rng(192)
    dg = torch.from_numpy(rng.normal(size=(9, 384)).astype(np.float32))
    w = round_bf16(torch.from_numpy(rng.normal(size=(128, 384)).astype(np.float32)))
    got = k4c_carry(dg, w).double()
    exact = dg.double() @ w.double().t()
    bound = 64 * 2.0 ** -24 * float((dg.double().abs() @ w.double().abs().t()).max())
    assert float((got - exact).abs().max()) <= bound


def _jax_case(hidden, with_state, seed):
    rng = np.random.default_rng(seed)
    bound = hidden ** -0.5
    x = rng.normal(size=(4, 24, 16)).astype(np.float32)
    weights = [rng.uniform(-bound, bound, shape).astype(np.float32)
               for shape in ((16, 3 * hidden), (hidden, 3 * hidden), (3 * hidden,),
                             (3 * hidden,))]
    seq_len = np.array([24, 19, 0, 1])
    h0 = (0.5 * rng.normal(size=(4, hidden))).astype(np.float32) if with_state \
        else np.zeros((4, hidden), np.float32)
    dy = rng.normal(size=(4, 24, hidden)).astype(np.float32)
    dhn = rng.normal(size=(4, hidden)).astype(np.float32)
    return x, weights, seq_len, h0, dy, dhn


def _near(got, want, max_rtol, mean_rtol, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert err.max() <= max_rtol * scale and err.mean() <= mean_rtol * scale, \
        (label, err.max() / scale, err.mean() / scale)


@pytest.mark.parametrize('with_state', [False, True], ids=['zero-state', 'state'])
@pytest.mark.parametrize('hidden', [32, 64, 128])
def test_emulated_layer_matches_the_jax_scan_and_its_vjp(hidden, with_state, monkeypatch):
    """gru_layer_reference(compute_dtype='bfloat16') with the emulations of
    K3c and K4c in place of the plain recurrence and
    backward, at B4 T24 I16, seq_len with an empty row, against
    ops.rnn.gru(compute_dtype=bf16): y and hn within MAX_RTOL (largest
    error) and MEAN_RTOL (mean) of each one's largest |value| (the bounds
    of tests/test_torch_bf16.py); the cotangents of (y, hn) pulled back by
    jax.vjp: dx, dW_ih and dW_hh within CARRY_RTOL, at most CARRY_OFF of
    the elements more than one bf16 ulp off, db_ih, db_hh and dh0 within
    GRAD_MAX_RTOL and GRAD_MEAN_RTOL (tests/test_torch_bf16_train.py)."""
    monkeypatch.setattr(gru_ops, 'gru_recurrence_reference', emulated_k3c)
    monkeypatch.setattr(gru_ops, 'gru_backward_reference', emulated_k4c)
    x, weights, seq_len, h0, dy, dhn = _jax_case(hidden, with_state, 200 + hidden + with_state)

    def forward(x, w_ih, w_hh, b_ih, b_hh, h0):
        return jrnn.gru(x, w_ih, w_hh, b_ih, b_hh, seq_len=jnp.asarray(seq_len), h0=h0,
                        compute_dtype=jnp.bfloat16)

    (jy, jh), pullback = jax.vjp(forward, *map(jnp.asarray, (x, *weights, h0)))
    want = pullback((jnp.asarray(dy), jnp.asarray(dhn)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, *weights, h0)]
    y, h = gru_ops.gru_layer_reference(*leaves[:5], seq_len=torch.from_numpy(seq_len),
                                       h0=leaves[5], compute_dtype='bfloat16')
    for name, got, ref in (('y', y, jy), ('hn', h, jh)):
        _near(got.detach().numpy(), ref, MAX_RTOL, MEAN_RTOL, name)
    ((y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dhn)).sum()).backward()
    for name, leaf, ref in zip(('dx', 'dW_ih', 'dW_hh', 'db_ih', 'db_hh', 'dh0'), leaves, want):
        got, ref = leaf.grad.numpy().astype(np.float64), np.asarray(ref, np.float64)
        if name.startswith(('dx', 'dW')):
            err = np.abs(got - ref)
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
            assert err.max() <= CARRY_RTOL * np.abs(ref).max(), \
                (name, err.max() / np.abs(ref).max())
            assert np.mean(err > ulp) <= CARRY_OFF, (name, np.mean(err > ulp))
        else:
            _near(got, ref, GRAD_MAX_RTOL, GRAD_MEAN_RTOL, name)
