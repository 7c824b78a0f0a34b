"""The port's GRU layer (the counterpart of ops/pallas_gru.py, kernels K3 and
K4 on the GPU), its nn modules and single-stream MLPG against the JAX
package on the CPU. The layer's outputs agree within 1e-5 abs and its
gradients within 2e-5 of each gradient's max |value|, the bar of
tests/test_pallas_rnn.py:145. The kernels themselves are held against the
plain versions on the GPU by tests/test_torch_kernels.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu import nn as jnn
from morgana_tpu.ops import rnn as rnn_ops
from morgana_tpu.ops.pallas_gru import gru_layer as pallas_gru_layer
from morgana_tpu.viz.synthesis import MLPG as jMLPG
from morgana_tpu.viz.synthesis import mlpg_numpy as jmlpg_numpy

from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch.ops import gru as gru_ops
from morgana_tpu_torch.viz.synthesis import MLPG, mlpg_numpy

B, T, I, H = 4, 24, 8, 64
ATOL = 1e-5
GRAD_RTOL = 2e-5
SEQ_LENS = [None, [T, 13, 1, 0], [1, 1, 1, 1]]
SEQ_IDS = ['no_seq_len', 'ragged_with_0_and_1', 'all_1']


def _inputs(seed, batch=B, steps=T):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, steps, I)).astype(np.float32)
    weights = [(0.3 * rng.normal(size=shape)).astype(np.float32)
               for shape in ((I, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))]
    h0 = rng.normal(size=(batch, H)).astype(np.float32)
    return x, weights, h0


def _jseq(seq_len):
    return None if seq_len is None else jnp.asarray(seq_len)


def _tseq(seq_len):
    return None if seq_len is None else torch.tensor(seq_len)


@pytest.mark.parametrize('seq_len', SEQ_LENS, ids=SEQ_IDS)
@pytest.mark.parametrize('with_state', [False, True], ids=['zero_state', 'h0'])
def test_gru_layer_matches_pallas_interpret_and_scan(seq_len, with_state):
    """Outputs (zero past seq_len) and the final h at seq_len, h0 for an
    empty row; 1e-5 abs against the Pallas kernel in interpret mode and
    against ops/rnn.gru."""
    x, weights, h0 = _inputs(0)
    jh0 = jnp.asarray(h0) if with_state else None
    want_pl = pallas_gru_layer(jnp.asarray(x), *map(jnp.asarray, weights), seq_len=_jseq(seq_len),
                               h0=jh0, interpret=True)
    want_scan = rnn_ops.gru(jnp.asarray(x), *map(jnp.asarray, weights), seq_len=_jseq(seq_len),
                            h0=jh0)
    y, hn = gru_ops.gru_layer(torch.from_numpy(x), *map(torch.from_numpy, weights),
                              seq_len=_tseq(seq_len),
                              h0=torch.from_numpy(h0) if with_state else None)
    for wy, wh in (want_pl, want_scan):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=ATOL)
        np.testing.assert_allclose(hn.numpy(), np.asarray(wh), atol=ATOL)
    if seq_len is not None:
        for b, n in enumerate(seq_len):
            assert (y[b, n:] == 0).all()
        if with_state and 0 in seq_len:
            empty = seq_len.index(0)
            np.testing.assert_array_equal(hn[empty].numpy(), h0[empty])


def _loss_weights(seed, batch=B, steps=T):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in ((batch, steps, H), (batch, H))]


@pytest.mark.parametrize('seq_len', SEQ_LENS, ids=SEQ_IDS)
@pytest.mark.parametrize('with_state', [False, True], ids=['zero_state', 'h0'])
def test_gru_layer_gradients_match_pallas_interpret(seq_len, with_state):
    """Gradients of a loss on y and hn with respect to all six inputs: the
    port's autograd Function (plain K3, plain K4, dW_hh and db_hh outside)
    against jax.grad through the Pallas kernels in interpret mode and through
    the scan; each within 2e-5 of the gradient's max |value|."""
    x, weights, h0 = _inputs(2)
    wy, wh = _loss_weights(3)
    h0 = h0 if with_state else np.zeros_like(h0)
    jseq = _jseq(seq_len)

    def jax_grads(layer):
        def loss(x, w_ih, w_hh, b_ih, b_hh, h0):
            y, hn = layer(x, w_ih, w_hh, b_ih, b_hh, seq_len=jseq, h0=h0)
            return jnp.sum(y * wy) + jnp.sum(hn * wh)
        return jax.grad(loss, argnums=tuple(range(6)))(*[jnp.asarray(a) for a in (x, *weights, h0)])

    want_pl = jax_grads(lambda *a, **k: pallas_gru_layer(*a, interpret=True, **k))
    want_scan = jax_grads(rnn_ops.gru)

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, *weights, h0)]
    y, hn = gru_ops.gru_layer(*leaves[:5], seq_len=_tseq(seq_len), h0=leaves[5])
    loss = (y * torch.from_numpy(wy)).sum() + (hn * torch.from_numpy(wh)).sum()
    got = torch.autograd.grad(loss, leaves)
    for want in (want_pl, want_scan):
        for g, w in zip(got, want):
            w = np.asarray(w)
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=GRAD_RTOL)


def test_backward_reference_matches_autograd_through_the_plain_loop():
    """gru_backward_reference (the plain K4, fed hg from hidden_gates) and the
    Function's dW_hh and db_hh against torch autograd through
    gru_recurrence_reference, with cotangents on y and hn; 1e-5 abs."""
    rng = np.random.default_rng(4)

    def leaf(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).requires_grad_(True)

    xg, w_hh, b_hh, h0 = leaf(T, B, 3 * H), leaf(H, 3 * H, scale=0.3), leaf(3 * H), leaf(B, H)
    y, hn = gru_ops.gru_recurrence_reference(xg, w_hh, b_hh, h0)
    dy, dhn = (torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)) for t in (y, hn))
    want = torch.autograd.grad((y * dy).sum() + (hn * dhn).sum(), (xg, w_hh, b_hh, h0))

    saved = [t.detach() for t in (xg, w_hh, b_hh, h0, y)]
    _, hg = gru_ops.hidden_gates(saved[1], saved[2], saved[3], saved[4])
    dxg, dh0 = gru_ops.gru_backward_reference(saved[0], hg, saved[1], saved[3], saved[4], dy, dhn)
    for g, w in zip((dxg, dh0), (want[0], want[3])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)
    for g, w in zip(gru_ops.gru_backward(*saved, dy, dhn), (dxg, dh0)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)

    # The Function holds the layer's batch-major tensors.
    class Ctx:
        saved_tensors = [t.transpose(0, 1) if t.ndim == 3 else t for t in saved]
        seq_len = None
        plain = bf16 = False
    got = gru_ops._Recurrence.backward(Ctx(), dy.transpose(0, 1), dhn)
    assert len(got) == 7 and all(g is None for g in got[4:])
    for g, w in zip((got[0].transpose(0, 1), *got[1:4]), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)


def test_kernels_run_only_when_needed_and_not_on_the_cpu():
    """The autograd Function runs only when an input requires grad and grad
    mode is on; on CPU tensors the layer runs the plain versions, equal to
    gru_layer_reference, and launches nothing."""
    x, weights, _ = _inputs(5)
    calls = []
    apply = gru_ops._Recurrence.apply
    before = (gru_ops.launches, gru_ops.bwd_launches)
    try:
        gru_ops._Recurrence.apply = lambda *a: calls.append(1) or apply(*a)
        w = [torch.from_numpy(a).requires_grad_(True) for a in weights]
        with torch.inference_mode():
            gru_ops.gru_layer(torch.from_numpy(x), *w)
        with torch.no_grad():
            gru_ops.gru_layer(torch.from_numpy(x), *w)
        assert not calls
        got = gru_ops.gru_layer(torch.from_numpy(x), *w)
        assert calls == [1]
        got[0].sum().backward()
    finally:
        gru_ops._Recurrence.apply = apply
    want = gru_ops.gru_layer_reference(torch.from_numpy(x), *w)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert (gru_ops.launches, gru_ops.bwd_launches) == before


def test_empty_sequence_keeps_the_initial_state():
    """T = 0 with seq_len given (all rows empty): y is (B, 0, H), hn is h0,
    and h0's gradient is the cotangent of hn."""
    x, weights, h0 = _inputs(9, steps=0)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (*weights, h0)]
    y, hn = gru_ops.gru_layer(torch.from_numpy(x), *leaves[:4],
                              seq_len=torch.zeros(B, dtype=torch.long), h0=leaves[4])
    assert y.shape == (B, 0, H)
    torch.testing.assert_close(hn, leaves[4], rtol=0, atol=0)
    hn.sum().backward()
    torch.testing.assert_close(leaves[4].grad, torch.ones(B, H), rtol=0, atol=0)


def _jax_gru(num_layers, seed):
    jnn.manual_seed(seed)
    return jnn.Recurrent('gru', I, H, num_layers=num_layers, backend='pallas', interpret=True)


@pytest.mark.parametrize('streaming', [False, True], ids=['sequence', 'one_frame_2d'])
def test_gru_stack_matches_jax(streaming):
    """Two stacked GRU layers with the JAX names carried across by
    load_jax_params, against the JAX Recurrent on the Pallas kernels in
    interpret mode; a 2-d input is one frame and threads given states
    through; 1e-5 abs."""
    jmod = _jax_gru(2, 5)
    tmod = tnn.Recurrent('gru', I, H, num_layers=2)
    tnn.load_jax_params(tmod, jnn.state_dict(jmod))
    rng = np.random.default_rng(6)
    if streaming:
        x = rng.normal(size=(B, I)).astype(np.float32)
        states = [rng.normal(size=(B, H)).astype(np.float32) for _ in range(2)]
        jy, jh = jmod(jnp.asarray(x), [jnp.asarray(s) for s in states])
        ty, th = tmod(torch.from_numpy(x), [torch.from_numpy(s) for s in states])
    else:
        x = rng.normal(size=(B, T, I)).astype(np.float32)
        seq_len = np.array([T, 9, 1, 0])
        jy, jh = jmod(jnp.asarray(x), seq_len=jnp.asarray(seq_len))
        ty, th = tmod(torch.from_numpy(x), seq_len=torch.from_numpy(seq_len))
    assert ty.shape == tuple(jy.shape)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=ATOL)
    for th_i, jh_i in zip(th, jh):
        np.testing.assert_allclose(th_i.detach().numpy(), np.asarray(jh_i), atol=ATOL)


def test_gru_state_dict_round_trips_the_jax_names():
    """state_dict writes the JAX names and shapes (w_ih_l0 (I, 3H), ...,
    b_hh_l1 (3H,)); the JAX module loads them back unchanged; nn.GRU is
    Recurrent('gru')."""
    tmod = tnn.GRU(I, H, num_layers=2)
    sd = tnn.state_dict(tmod)
    jmod = _jax_gru(2, 7)
    assert {k: v.shape for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in jnn.state_dict(jmod).items()}
    jnn.load_state_dict(jmod, sd)
    for name, value in jnn.state_dict(jmod).items():
        np.testing.assert_array_equal(np.asarray(value), sd[name])
    assert tmod.mode == 'gru'


def test_unported_recurrent_options_are_refused():
    with pytest.raises(NotImplementedError):
        tnn.Recurrent('gru', I, H, backend='wavefront')
    with pytest.raises(NotImplementedError):
        tnn.Recurrent('gru', I, H, bidirectional=True)
    with pytest.raises(ValueError, match='rnn'):
        tnn.Recurrent('rnn', I, H)


def _mlpg_case(seed, batched, per_frame):
    rng = np.random.default_rng(seed)
    shape = (3, 40, 6) if batched else (40, 6)
    means = rng.normal(size=shape).astype(np.float32)
    var_shape = shape if per_frame else (6,)
    variances = rng.uniform(0.2, 2.0, size=var_shape).astype(np.float32)
    seq_len = np.array([40, 27, 1]) if batched else None
    return means, variances, seq_len


@pytest.mark.parametrize('per_frame', [False, True], ids=['global_var', 'per_frame_var'])
@pytest.mark.parametrize('batched', [True, False], ids=['batched', 'one_sequence'])
@pytest.mark.parametrize('padding_size', [0, 100])
def test_mlpg_matches_jax_and_float64(batched, per_frame, padding_size):
    """Single-stream MLPG, batched (ragged seq_len) or one sequence, a global
    or per-frame variance: a tensor in gives a tensor out and numpy gives
    numpy; the torch backend within 5e-6 of the JAX backend and within 2e-5
    of the float64 solve, relative to the largest |value| (both f32 banded
    Choleskys, the same steps); the numpy backend equals the JAX numpy
    backend's float32 output, and mlpg_numpy the JAX float64 one, within
    1e-12."""
    means, variances, seq_len = _mlpg_case(8, batched, per_frame)
    kwargs = dict(padding_size=padding_size)
    got = MLPG(torch.from_numpy(means), torch.from_numpy(variances),
               seq_len=None if seq_len is None else torch.from_numpy(seq_len), **kwargs)
    assert isinstance(got, torch.Tensor)
    want = np.asarray(jMLPG(jnp.asarray(means), jnp.asarray(variances),
                            seq_len=None if seq_len is None else jnp.asarray(seq_len), **kwargs))
    exact = jmlpg_numpy(means, variances, padding_size=padding_size, seq_len=seq_len)
    exact = exact if batched else exact[0]
    assert got.shape == want.shape == exact.shape
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=5e-6)
    np.testing.assert_allclose(got.numpy() / scale, exact / scale, atol=2e-5)

    from_numpy = MLPG(means, variances, seq_len=seq_len, **kwargs)
    assert isinstance(from_numpy, np.ndarray)
    np.testing.assert_array_equal(from_numpy, got.numpy())
    on_host = MLPG(means, variances, seq_len=seq_len, backend='numpy', **kwargs)
    assert on_host.dtype == np.float32
    np.testing.assert_allclose(on_host, jMLPG(means, variances, seq_len=seq_len, backend='numpy',
                                              **kwargs), atol=1e-12)
    np.testing.assert_allclose(mlpg_numpy(means, variances, padding_size=padding_size,
                                          seq_len=seq_len),
                               jmlpg_numpy(means, variances, padding_size=padding_size,
                                           seq_len=seq_len), atol=1e-12)


def _recompute_per_step_backward(xg, w_hh, b_hh, h0, y, dy, dhn):
    """K4's plain version as it was before hg was given: each step recomputes
    hg = h_{t-1} @ w_hh + b_hh inside the reverse loop."""
    hidden = w_hh.shape[0]
    dh = dhn
    dxg = [None] * xg.shape[0]
    for t in range(xg.shape[0] - 1, -1, -1):
        h_prev = y[t - 1] if t > 0 else h0
        hg = torch.matmul(h_prev, w_hh) + b_hh
        r, z, n = gru_ops._gates(xg[t], hg, hidden)
        dh = dy[t] + dh
        da_n = dh * (1.0 - z) * (1.0 - n * n)
        da_z = dh * (h_prev - n) * z * (1.0 - z)
        da_r = da_n * hg[..., 2 * hidden:] * r * (1.0 - r)
        dxg[t] = torch.cat([da_r, da_z, da_n], dim=-1)
        dh = dh * z + torch.matmul(torch.cat([da_r, da_z, da_n * r], dim=-1), w_hh.t())
    return (torch.stack(dxg) if dxg else torch.zeros_like(xg)), dh


def _scaled_close(got, want, rtol):
    """Each array within rtol of its own max |value| (abs below 1)."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()) if want.size else 1.0, 1.0)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=rtol)


@pytest.mark.parametrize('steps', [0, 1, 17])
@pytest.mark.parametrize('with_state', [False, True], ids=['zero_state', 'h0'])
@pytest.mark.parametrize('empty_rows', [False, True], ids=['full_rows', 'rows_of_length_0'])
def test_plain_k4_fed_hg_matches_jax_backward_and_the_recompute_formula(steps, with_state,
                                                                        empty_rows):
    """The plain K4 fed hg from the one GEMM (hidden_gates) against
    jax.vjp through the Pallas core in interpret mode (dxg, dh0; at T = 0,
    where the Pallas call takes no empty grid, dh0 = dhn and dxg is empty)
    and against the per-step recompute formula it replaced; then the layer's
    gradients (x through an identity w_ih, so dx is dxg; h0, w_hh, b_hh)
    under a seq_len with rows of length 0 against jax.vjp through
    pallas_gru.gru_layer(..., interpret=True), or through ops/rnn.gru at
    T = 0. Each within 1e-5 of its max |value| (abs below 1)."""
    from morgana_tpu.ops import pallas_gru

    rng = np.random.default_rng(20 + steps)
    xg = rng.normal(size=(steps, B, 3 * H)).astype(np.float32)
    w_hh = (0.3 * rng.normal(size=(H, 3 * H))).astype(np.float32)
    b_hh = rng.normal(size=(3 * H,)).astype(np.float32)
    h0 = (rng.normal(size=(B, H)) if with_state else np.zeros((B, H))).astype(np.float32)
    dy = rng.normal(size=(steps, B, H)).astype(np.float32)
    dhn = rng.normal(size=(B, H)).astype(np.float32)

    t_xg, t_w, t_b, t_h0, t_dy, t_dhn = map(torch.from_numpy, (xg, w_hh, b_hh, h0, dy, dhn))
    y, _ = gru_ops.gru_recurrence_reference(t_xg, t_w, t_b, t_h0)
    _, hg = gru_ops.hidden_gates(t_w, t_b, t_h0, y)
    dxg, dh0 = gru_ops.gru_backward_reference(t_xg, hg, t_w, t_h0, y, t_dy, t_dhn)
    assert dxg.shape == (steps, B, 3 * H) and dh0.shape == (B, H)

    old = _recompute_per_step_backward(t_xg, t_w, t_b, t_h0, y, t_dy, t_dhn)
    for g, w in zip((dxg, dh0), old):
        _scaled_close(g.numpy(), w.numpy(), ATOL)
    if steps:
        _, vjp = jax.vjp(lambda a, c: pallas_gru._gru_layer_core(a, jnp.asarray(w_hh),
                                                                 jnp.asarray(b_hh)[None], c, True),
                         jnp.asarray(xg), jnp.asarray(h0))
        want = vjp((jnp.asarray(dy), jnp.asarray(dhn)))
    else:
        want = (np.zeros_like(xg), dhn)
    for g, w in zip((dxg, dh0), want):
        _scaled_close(g.numpy(), w, ATOL)

    # The layer, with xg = x @ I + 0 exactly, so that dx is dxg.
    seq_len = np.array([steps, 0, min(steps, 1), 0]) if empty_rows else None
    x = xg.transpose(1, 0, 2).copy()
    eye, zero = np.eye(3 * H, dtype=np.float32), np.zeros(3 * H, np.float32)
    wy = rng.normal(size=(B, steps, H)).astype(np.float32)
    wh = rng.normal(size=(B, H)).astype(np.float32)
    jlayer = (functools.partial(pallas_gru.gru_layer, interpret=True) if steps
              else rnn_ops.gru)

    def jloss(x, w_hh, b_hh, h0):
        yy, hh = jlayer(x, jnp.asarray(eye), w_hh, jnp.asarray(zero), b_hh,
                        seq_len=_jseq(None if seq_len is None else list(seq_len)), h0=h0)
        return jnp.sum(yy * wy) + jnp.sum(hh * wh)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, w_hh, b_hh, h0)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w_hh, b_hh, h0)]
    yy, hh = gru_ops.gru_layer(leaves[0], torch.from_numpy(eye), leaves[1], torch.from_numpy(zero),
                               leaves[2], seq_len=_tseq(None if seq_len is None else list(seq_len)),
                               h0=leaves[3])
    loss = (yy * torch.from_numpy(wy)).sum() + (hh * torch.from_numpy(wh)).sum()
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    for g, w, leaf in zip(got, want, leaves):
        _scaled_close(torch.zeros_like(leaf).numpy() if g is None else g.numpy(), w, ATOL)


@pytest.mark.parametrize('seq_len', [[T, 11, 0, 1], None, [1, 1, 1, 1]],
                         ids=['ragged_with_0', 'no_seq_len', 'all_1'])
def test_backward_computes_hg_once_and_feeds_the_same_tensor_to_k4_and_dw_hh(monkeypatch,
                                                                             seq_len):
    """_Recurrence.backward makes hg with one product against the whole w_hh
    (no separate product for the r columns), hands that very tensor to the
    recurrence's backward, and takes dW_hh and db_hh from dxg's r and z
    columns and the dnr it returns, dnr being dxg_n * sigmoid(xg_r + hg_r):
    bit for bit against the two products and sums, and within 1e-6 of each
    max of the one product h_prev^T @ [dxg_r, dxg_z, dnr]."""
    rng = np.random.default_rng(30)
    xg, w_hh, b_hh, h0 = (torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32))
                          for s, shape in ((1, (B, T, 3 * H)), (0.3, (H, 3 * H)), (1, (3 * H,)),
                                           (1, (B, H))))
    seq_len = None if seq_len is None else torch.tensor(seq_len)
    y, hn = gru_ops._layer_forward(xg, w_hh, b_hh, h0, seq_len)
    dy, dhn = (torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)) for t in (y, hn))

    made, fed, products = [], [], []
    hidden_gates, layer_backward = gru_ops.hidden_gates, gru_ops._layer_backward
    matmul, addmm = torch.matmul, torch.addmm

    def spy_hidden_gates(*args, **kwargs):
        out = hidden_gates(*args, **kwargs)
        made.append(out)
        return out

    def spy_backward(xg_, hg, *rest):
        fed.append(hg)
        out = layer_backward(xg_, hg, *rest)
        fed.append(out)
        return out

    def spy_matmul(a, b, *rest):
        products.append(b)
        return matmul(a, b, *rest)

    def spy_addmm(bias, a, b, *rest):
        products.append(b)
        return addmm(bias, a, b, *rest)

    monkeypatch.setattr(gru_ops, 'hidden_gates', spy_hidden_gates)
    monkeypatch.setattr(gru_ops, '_layer_backward', spy_backward)
    monkeypatch.setattr(torch, 'matmul', spy_matmul)
    monkeypatch.setattr(torch, 'addmm', spy_addmm)

    class Ctx:
        saved_tensors = (xg, w_hh, b_hh, h0, y)
        plain = bf16 = False
    ctx = Ctx()
    ctx.seq_len = seq_len
    dxg, dw_hh, db_hh, _, _, _, _ = gru_ops._Recurrence.backward(ctx, dy, dhn)
    monkeypatch.undo()

    assert len(made) == 1 and len(fed) == 2 and fed[0] is made[0][1]
    assert sum(b is w_hh for b in products) == 1
    # No product with the r columns alone (w_hh[:, :H]).
    assert not any(b.data_ptr() == w_hh.data_ptr() and tuple(b.shape) == (H, H) for b in products)
    h_prev, hg = made[0]
    dnr = fed[1][1]
    assert dnr.shape == (B, T, H) and fed[1][0] is dxg
    r = torch.sigmoid(xg[..., :H] + hg[..., :H])
    torch.testing.assert_close(dnr, dxg[..., 2 * H:] * r, rtol=0, atol=0)
    d_rz, dnr = dxg.reshape(B * T, 3 * H)[:, :2 * H], dnr.reshape(B * T, H)
    assert torch.equal(dw_hh, torch.cat([h_prev.t() @ d_rz, h_prev.t() @ dnr], dim=1))
    assert torch.equal(db_hh, torch.cat([d_rz.sum(0), dnr.sum(0)]))
    dhg = torch.cat([d_rz, dnr], dim=1)
    for got, want in ((dw_hh, h_prev.t() @ dhg), (db_hh, dhg.sum(0))):
        scale = float(want.abs().max())
        torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=1e-6)
    if seq_len is not None:
        for b, n in enumerate(seq_len.tolist()):
            assert (dxg[b, n:] == 0).all()


@pytest.mark.parametrize('seq_len', SEQ_LENS, ids=SEQ_IDS)
@pytest.mark.parametrize('with_state', [False, True], ids=['zero_state', 'h0'])
def test_layer_backward_reference_matches_autograd_through_the_masked_plain_layer(seq_len,
                                                                                   with_state):
    """layer_backward_reference (the plain K4 as the layer launches it:
    batch-major, seq_len, dnr out) against torch autograd through the plain
    forward with its masking and gather (_layer_forward on the CPU): dxg and
    dh0 within 1e-5 abs; dnr is dxg's n block times r, and with dxg's r and
    z blocks it gives autograd's dW_hh and db_hh within 2e-5 of each max."""
    rng = np.random.default_rng(40)

    def leaf(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).requires_grad_(True)

    xg, w_hh, b_hh = leaf(B, T, 3 * H), leaf(H, 3 * H, scale=0.3), leaf(3 * H)
    h0 = leaf(B, H) if with_state else torch.zeros(B, H, requires_grad=True)
    tseq = _tseq(seq_len)
    y, hn = gru_ops._layer_forward(xg, w_hh, b_hh, h0, tseq)
    dy, dhn = (torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)) for t in (y, hn))
    want = torch.autograd.grad((y * dy).sum() + (hn * dhn).sum(), (xg, w_hh, b_hh, h0))

    saved = [t.detach() for t in (xg, w_hh, b_hh, h0, y)]
    h_prev, hg = gru_ops.hidden_gates(saved[1], saved[2], saved[3], saved[4], batch_first=True)
    dxg, dnr, dh0 = gru_ops.layer_backward_reference(saved[0], hg, saved[1], saved[3], saved[4],
                                                     dy, dhn, tseq)
    for g, w in ((dxg, want[0]), (dh0, want[3])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)
    r = torch.sigmoid(saved[0][..., :H] + hg[..., :H])
    torch.testing.assert_close(dnr, dxg[..., 2 * H:] * r, rtol=0, atol=0)
    dhg = torch.cat([dxg[..., :2 * H], dnr], dim=-1).reshape(B * T, 3 * H)
    for g, w in ((h_prev.t() @ dhg, want[1]), (dhg.sum(0), want[2])):
        scale = max(float(w.abs().max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, w.numpy() / scale, atol=GRAD_RTOL)


@pytest.mark.parametrize('batch,hidden,message', [(0, 64, 'B >= 1'), (4, 48, 'multiple of 32'),
                                                  (4, 16, 'multiple of 32'),
                                                  (4, 160, 'up to 128')])
def test_gru_kernel_limits_are_refused_before_any_launch(batch, hidden, message):
    """The B and H that K3 and K4 do not take raise ValueError in the
    wrappers' own checks, which need no card."""
    with pytest.raises(ValueError, match=message):
        gru_ops._check_sizes('K3', batch, hidden)
    for ok in (32, 64, 96, 128):
        gru_ops._check_sizes('K4', 1, ok)


@pytest.mark.parametrize('time_major', [False, True], ids=['batch_major', 'time_major'])
def test_gru_sizes_read_the_layout_they_are_given(time_major):
    """(T, B, H) from a batch-major (B, T, 3H) xg, the kernels' layout, or a
    time-major (T, B, 3H) one; a last axis not a multiple of 3 raises naming
    the layout expected."""
    xg = torch.zeros((5, 7, 3 * 32)) if time_major else torch.zeros((7, 5, 3 * 32))
    assert gru_ops._sizes('K3', xg, time_major) == (5, 7, 32)
    layout = r'\(T, B, 3H\)' if time_major else r'\(B, T, 3H\)'
    with pytest.raises(ValueError, match=layout):
        gru_ops._sizes('K3', torch.zeros((5, 7, 95)), time_major)
