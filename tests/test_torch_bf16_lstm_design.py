"""The arithmetic of the bf16 cluster LSTM kernels, on the CPU.

K1c (``csrc/lstm_fwd_bf16.cu``) and K2c (``csrc/lstm_bwd_bf16.cu``) run a
bf16-compute LSTM layer of width up to 512 on a thread-block cluster of
H / 32 CTAs (``csrc/lstm_cluster.cuh``); CTA r owns the 32 units from 32 r
and their 128 gate columns (c = gate * 32 + unit). The kernels run only
on the card; these tests emulate, in plain torch, each one's order of
operations:

* K1c: every CTA holds the whole bf16 h_{t-1}, which each CTA publishes
  for its own units (the all-gather); a CTA's gate sums are
  ``mma.sync.m16n8k16`` products of 16-deep k-steps, bf16 inputs and f32
  sums, in two chains (even and odd k-steps) added at the end, then xg;
* K2c: a CTA's dxg columns, f32, go in as three bf16 planes (hi, mid, lo,
  ``split3_pack`` of ``csrc/attn_common.cuh``), k-steps in pairs, a pair's
  planes lo first; each CTA's (B, H) partial is summed over the CTAs in
  rank order (the reduce-scatter) and rounded to bf16 before it joins dy.

Each emulation is held to its plain version (``lstm_recurrence_reference``,
``lstm_backward_reference`` with ``compute_bf16``) within ``BF16_ULPS``
bf16 ulps of the largest |value| and, where the roundings have a step to
act on, ``BF16_CLOSER`` times nearer in the mean to it than to the f32
plain version (an emulation of K2c that skipped the rounding of its
carried product comes only 1.2-1.4 times nearer, one that keeps it 170
times and more); and, in the layer, to the
JAX package's LSTM scan under ``compute_dtype=bfloat16`` and to its
``jax.grad`` with the tolerances of ``tests/test_torch_bf16_train.py``.
The width rule that sends a layer to these kernels or to the grid builds
of ``csrc/lstm_fwd.cu`` / ``csrc/lstm_bwd.cu`` is a function of shape and
is tested here too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu.ops import rnn as jrnn
from test_torch_bf16_kernel_design import (BF16_ULPS, CARRY_OFF, CARRY_RTOL, GRAD_MAX_RTOL,
                                           GRAD_MEAN_RTOL, K_STEP, round_bf16, split3)

from morgana_tpu_torch.ops import lstm as lstm_ops

BF16_CLOSER = 2           # tests/test_torch_kernels.py, chip_smoke.py
UNITS = 32                # hidden units a CTA of the cluster


def cta_columns(width, rank):
    """The 4H indices of CTA ``rank``'s 128 gate columns, c = gate * 32 +
    unit."""
    return torch.tensor([gate * width + rank * UNITS + unit
                         for gate in range(4) for unit in range(UNITS)])


def k1c_product(h_bf16, w_cols):
    """A CTA's gate sums: ``h_bf16`` (B, H) times ``w_cols`` (H, 128) in
    16-deep k-steps, f32 sums, even and odd k-steps in two chains added at
    the end."""
    chains = [torch.zeros(h_bf16.shape[0], w_cols.shape[1]) for _ in range(2)]
    for step, k0 in enumerate(range(0, h_bf16.shape[1], K_STEP)):
        chains[step % 2] = chains[step % 2] + h_bf16[:, k0:k0 + K_STEP] @ w_cols[k0:k0 + K_STEP]
    return chains[0] + chains[1]


def k2c_partial(d_cols, w_cols):
    """A CTA's (B, H) partial of dh: its f32 dxg columns ``d_cols`` (B, 128)
    as three bf16 planes times its bf16 ``w_cols`` (H, 128) transposed,
    k-steps in pairs, a pair's planes lo first, one f32 accumulator."""
    hi, mid, lo = split3(d_cols)
    acc = torch.zeros(d_cols.shape[0], w_cols.shape[0])
    for k0 in range(0, d_cols.shape[1], 2 * K_STEP):
        for plane in (lo, mid, hi):
            for k in (k0, k0 + K_STEP):
                acc = acc + plane[:, k:k + K_STEP] @ w_cols[:, k:k + K_STEP].t()
    return acc


def _padded(hidden):
    width = lstm_ops._width('emulation', 1, hidden)
    assert lstm_ops.bf16_route(hidden) == 'cluster'
    return width


_plain_recurrence = lstm_ops.lstm_recurrence_reference
_plain_backward = lstm_ops.lstm_backward_reference


def emulated_k1c(xg, w_hh, h0, c0, compute_bf16=False):
    """csrc/lstm_fwd_bf16.cu's order of operations at the width the wrapper
    pads to; ``(y, c_all, g_all, hn, cn)`` as lstm_recurrence_reference
    gives them. Without ``compute_bf16``, that plain version."""
    if not compute_bf16:
        return _plain_recurrence(xg, w_hh, h0, c0)
    time, batch, gates4 = xg.shape
    hidden = gates4 // 4
    width = _padded(hidden)
    xg = lstm_ops._pad_units(xg.float(), width, 4)
    w = round_bf16(lstm_ops._pad_w_hh(w_hh.float(), width))
    h, c = lstm_ops._pad_units(h0.float(), width), lstm_ops._pad_units(c0.float(), width)
    ctas = width // UNITS
    columns = [cta_columns(width, r) for r in range(ctas)]
    published = round_bf16(h)
    ys, cs, gs = [], [], []
    for t in range(time):
        sums = torch.empty((batch, 4 * width))
        for cols in columns:
            sums[:, cols] = k1c_product(published, w[:, cols]) + xg[t][:, cols]
        i, f, g, o = sums.split(width, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        # The all-gather: every CTA's 32 units of bf16(h_t) into every CTA.
        published = torch.cat([round_bf16(h[:, r * UNITS:(r + 1) * UNITS]) for r in range(ctas)],
                              dim=1)
        ys.append(h)
        cs.append(c)
        gs.append(torch.cat([i, f, g, o], dim=-1))
    hn, cn = lstm_ops._unpad_units(h, hidden), lstm_ops._unpad_units(c, hidden)
    if not ys:
        empty = xg.new_zeros((0, batch, hidden))
        return empty, empty.clone(), xg.new_zeros((0, batch, 4 * hidden)), hn, cn
    return (lstm_ops._unpad_units(torch.stack(ys), hidden),
            lstm_ops._unpad_units(torch.stack(cs), hidden),
            lstm_ops._unpad_units(torch.stack(gs), hidden, 4), hn, cn)


def emulated_k2c(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, compute_bf16=False):
    """csrc/lstm_bwd_bf16.cu's order of operations at the padded width;
    ``(dxg, dh0, dc0)`` as lstm_backward_reference gives them. Without
    ``compute_bf16``, that plain version."""
    if not compute_bf16:
        return _plain_backward(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn)
    time, batch, gates4 = g_all.shape
    hidden = gates4 // 4
    width = _padded(hidden)
    g_all = lstm_ops._pad_units(g_all.float(), width, 4)
    w = round_bf16(lstm_ops._pad_w_hh(w_hh.float(), width))
    c0, c_all, dy, dc_all, dh, dc_carry = (lstm_ops._pad_units(t.float(), width)
                                           for t in (c0, c_all, dy, dc_all, dhn, dcn))
    columns = [cta_columns(width, r) for r in range(width // UNITS)]
    dxg = [None] * time
    for t in range(time - 1, -1, -1):
        i, f, g, o = g_all[t].split(width, dim=-1)
        c_prev = c_all[t - 1] if t > 0 else c0
        tanh_c = torch.tanh(c_all[t])
        dh_total = dy[t] + dh
        d_o = dh_total * tanh_c
        dc = dh_total * o * (1.0 - tanh_c * tanh_c) + dc_carry + dc_all[t]
        dgates = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g * g), d_o * o * (1.0 - o)], dim=-1)
        dxg[t] = dgates
        # The reduce-scatter: each destination sums the CTAs' partials of
        # its units in rank order.
        total = None
        for cols in columns:
            part = k2c_partial(dgates[:, cols], w[:, cols])
            total = part if total is None else total + part
        dh = round_bf16(total)
        dc_carry = dc * f
    dh0, dc0 = lstm_ops._unpad_units(dh, hidden), lstm_ops._unpad_units(dc_carry, hidden)
    if not dxg:
        return torch.zeros((0, batch, gates4)), dh0, dc0
    return lstm_ops._unpad_units(torch.stack(dxg), hidden, 4), dh0, dc0


def _hold(got, want, f32, steps_act, closer_by):
    """Each of ``got`` within BF16_ULPS bf16 ulps of the largest |value| of
    its ``want``; where the roundings have a step to act on, the mean
    |error| against ``want`` ``closer_by`` times smaller than against
    ``f32``."""
    for g, w in zip(got, want):
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        assert err <= BF16_ULPS * 2.0 ** -7 * scale, (err, scale)
    if steps_act:
        near = sum(float((g - w).abs().sum()) for g, w in zip(got, want))
        far = sum(float((g - o).abs().sum()) for g, o in zip(got, f32))
        assert far > 0 and near * closer_by <= far, (near, far)


def _recurrence_inputs(batch, steps, hidden, with_state, seed):
    rng = np.random.default_rng(seed)

    def tensor(array):
        return torch.from_numpy(array.astype(np.float32))

    xg = tensor(0.5 * rng.normal(size=(steps, batch, 4 * hidden)))
    w_hh = tensor(rng.uniform(-hidden ** -0.5, hidden ** -0.5, (hidden, 4 * hidden)))
    state = [tensor(0.5 * rng.normal(size=(batch, hidden))) if with_state
             else torch.zeros(batch, hidden) for _ in range(2)]
    return xg, w_hh, state


SIZES = [(batch, steps, hidden) for batch in (1, 4, 9) for steps in (0, 1, 32)
         for hidden in (64, 128, 96)]


@pytest.mark.parametrize('with_state', [False, True], ids=['zero-state', 'state'])
@pytest.mark.parametrize('batch,steps,hidden', SIZES)
def test_emulated_k1c_matches_its_plain_version(batch, steps, hidden, with_state):
    """K1c's emulation against lstm_recurrence_reference(compute_bf16=True)
    on the same inputs (y, c_all, the gate trace, hn, cn): within
    BF16_ULPS ulps, and past T = 1 BF16_CLOSER times nearer in the mean than
    to the f32 plain version; B 1, 4, 9, T 0, 1, 32, H 64, 128 and 96
    (padded to 128, 4 CTAs)."""
    xg, w_hh, (h0, c0) = _recurrence_inputs(batch, steps, hidden, with_state, 150 + hidden)
    got = emulated_k1c(xg, w_hh, h0, c0, True)
    want = _plain_recurrence(xg, w_hh, h0, c0, True)
    f32 = _plain_recurrence(xg, w_hh, h0, c0)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    _hold(got, want, f32, steps > 1, BF16_CLOSER)


@pytest.mark.parametrize('with_state', [False, True], ids=['zero-state', 'state'])
@pytest.mark.parametrize('batch,steps,hidden', SIZES)
def test_emulated_k2c_matches_its_plain_version(batch, steps, hidden, with_state):
    """K2c's emulation against lstm_backward_reference(compute_bf16=True) on
    the gate and c traces of the plain bf16 forward and seeded cotangents
    (dxg, dh0, dc0): within BF16_ULPS ulps, and past T = 1 BF16_CLOSER
    times nearer in the mean than to the f32 plain version; the sizes of the
    K1c test."""
    xg, w_hh, (h0, c0) = _recurrence_inputs(batch, steps, hidden, with_state, 160 + hidden)
    _, c_all, g_all, _, _ = _plain_recurrence(xg, w_hh, h0, c0, True)
    rng = np.random.default_rng(161)
    cot = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
           for shape in ((steps, batch, hidden),) * 2 + ((batch, hidden),) * 2]
    args = (g_all, w_hh, c0, c_all, *cot)
    got = emulated_k2c(*args, compute_bf16=True)
    want = _plain_backward(*args, compute_bf16=True)
    f32 = _plain_backward(*args)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    _hold(got, want, f32, steps > 1, BF16_CLOSER)


def test_three_planes_of_dxg_are_its_f32_product():
    """A CTA's partial from dxg's three bf16 planes equals, within the f32
    rounding of its sums, the f64 product of the f32 dxg and the bf16
    w_hh: the planes lose nothing of the f32 operand (a two-plane split
    would leave an error of about 2^-16 relative)."""
    rng = np.random.default_rng(162)
    d = torch.from_numpy(rng.normal(size=(9, 128)).astype(np.float32))
    w = round_bf16(torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32)))
    got = k2c_partial(d, w).double()
    exact = d.double() @ w.double().t()
    scale = float(exact.abs().max())
    assert float((got - exact).abs().max()) <= 64 * 2.0 ** -24 * float(
        (d.double().abs() @ w.double().abs().t()).max()), scale
    two = (split3(d)[0] + split3(d)[1]).double() @ w.double().t()
    assert float((two - exact).abs().max()) > float((got - exact).abs().max())


def _layer_case(batch, steps, hidden, with_state, seed):
    rng = np.random.default_rng(seed)
    bound = hidden ** -0.5
    x = rng.normal(size=(batch, steps, 16)).astype(np.float32)
    weights = [rng.uniform(-bound, bound, shape).astype(np.float32)
               for shape in ((16, 4 * hidden), (hidden, 4 * hidden), (4 * hidden,),
                             (4 * hidden,))]
    seq_len = np.array([steps, steps - 5, steps // 2, 1][:batch])
    state = [(0.5 * rng.normal(size=(batch, hidden))).astype(np.float32) for _ in range(2)]
    dy = rng.normal(size=(batch, steps, hidden)).astype(np.float32)
    return x, weights, seq_len, state if with_state else None, dy


def _near_jax(got, want, max_rtol, mean_rtol, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert err.max() <= max_rtol * scale and err.mean() <= mean_rtol * scale, \
        (label, err.max() / scale, err.mean() / scale)


@pytest.mark.parametrize('with_state', [False, True], ids=['zero-state', 'state'])
@pytest.mark.parametrize('hidden', [64, 96])
def test_emulated_layer_matches_the_jax_scan_and_its_grad(hidden, with_state, monkeypatch):
    """lstm_layer_reference(compute_dtype='bfloat16') with the emulations of
    K1c and K2c in place of the plain recurrence and backward, at B4 T32
    I16, ragged seq_len, against ops.rnn.lstm(compute_dtype=bf16): y, hn and
    cn within GRAD_MAX_RTOL (largest error) and GRAD_MEAN_RTOL (mean) of
    each one's largest |value|; dx, dW_ih and dW_hh of sum(y * dy) against
    its jax.grad within CARRY_RTOL, at most CARRY_OFF of the elements more
    than one bf16 ulp off (the bounds of tests/test_torch_bf16_train.py);
    dh0 and dc0 within GRAD_MAX_RTOL and GRAD_MEAN_RTOL."""
    monkeypatch.setattr(lstm_ops, 'lstm_recurrence_reference', emulated_k1c)
    monkeypatch.setattr(lstm_ops, 'lstm_backward_reference', emulated_k2c)
    x, weights, seq_len, state, dy = _layer_case(4, 32, hidden, with_state, 170 + hidden)
    state = state or [np.zeros((4, hidden), np.float32)] * 2

    def forward(x, w_ih, w_hh, b_ih, b_hh, h0, c0):
        return jrnn.lstm(x, w_ih, w_hh, b_ih, b_hh, seq_len=jnp.asarray(seq_len), h0=h0, c0=c0,
                         compute_dtype=jnp.bfloat16)

    def loss(*args):
        return jnp.sum(forward(*args)[0] * dy)

    jy, (jh, jc) = forward(*map(jnp.asarray, (x, *weights, *state)))
    want = jax.grad(loss, argnums=(0, 1, 2, 5, 6))(*map(jnp.asarray, (x, *weights, *state)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, *weights, *state)]
    y, (h, c) = lstm_ops.lstm_layer_reference(*leaves[:5], seq_len=torch.from_numpy(seq_len),
                                              h0=leaves[5], c0=leaves[6],
                                              compute_dtype='bfloat16')
    for name, got, ref in (('y', y, jy), ('hn', h, jh), ('cn', c, jc)):
        _near_jax(got.detach().numpy(), ref, GRAD_MAX_RTOL, GRAD_MEAN_RTOL, name)
    (y * torch.from_numpy(dy)).sum().backward()
    grads = [leaves[i].grad for i in (0, 1, 2, 5, 6)]
    for name, got, ref in zip(('dx', 'dW_ih', 'dW_hh'), grads[:3], want[:3]):
        got, ref = got.numpy().astype(np.float64), np.asarray(ref, np.float64)
        err = np.abs(got - ref)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
        assert err.max() <= CARRY_RTOL * np.abs(ref).max(), (name, err.max() / np.abs(ref).max())
        assert np.mean(err > ulp) <= CARRY_OFF, (name, np.mean(err > ulp))
    for name, got, ref in zip(('dh0', 'dc0'), grads[3:], want[3:]):
        _near_jax(got.numpy(), ref, GRAD_MAX_RTOL, GRAD_MEAN_RTOL, name)


@pytest.mark.parametrize('hidden,route', [(1, 'cluster'), (64, 'cluster'), (96, 'cluster'),
                                          (128, 'cluster'), (200, 'cluster'), (256, 'cluster'),
                                          (512, 'cluster'), (513, 'grid'), (600, 'grid'),
                                          (1024, 'grid')])
def test_width_rule_picks_the_cluster_kernels_up_to_512(hidden, route):
    """bf16_route: the cluster kernels for every width padded to at most 512
    (64, 128, 256, 512), the grid builds at 1024; a rule of the width
    alone."""
    assert lstm_ops.bf16_route(hidden) == route


def test_width_rule_refuses_what_no_kernel_takes():
    """Past 1024 no LSTM kernel takes the layer: bf16_route raises, as the
    wrappers do."""
    with pytest.raises(ValueError, match='H up to 1024'):
        lstm_ops.bf16_route(1025)
