"""The port's GRU layer (the counterpart of ops/pallas_gru.py, kernels K3 and
K4 on the GPU), its nn modules and single-stream MLPG against the JAX
package on the CPU. The layer's outputs agree within 1e-5 abs and its
gradients within 2e-5 of each gradient's max |value|, the bar of
tests/test_pallas_rnn.py:145. The kernels themselves are held against the
plain versions on the GPU by tests/test_torch_kernels.py."""
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
    """gru_backward_reference (the plain K4) and the Function's dW_hh and
    db_hh against torch autograd through gru_recurrence_reference, with
    cotangents on y and hn; 1e-5 abs."""
    rng = np.random.default_rng(4)

    def leaf(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).requires_grad_(True)

    xg, w_hh, b_hh, h0 = leaf(T, B, 3 * H), leaf(H, 3 * H, scale=0.3), leaf(3 * H), leaf(B, H)
    y, hn = gru_ops.gru_recurrence_reference(xg, w_hh, b_hh, h0)
    dy, dhn = (torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)) for t in (y, hn))
    want = torch.autograd.grad((y * dy).sum() + (hn * dhn).sum(), (xg, w_hh, b_hh, h0))

    saved = [t.detach() for t in (xg, w_hh, b_hh, h0, y)]
    dxg, dh0 = gru_ops.gru_backward_reference(*saved, dy, dhn)
    for g, w in zip((dxg, dh0), (want[0], want[3])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)

    class Ctx:
        saved_tensors = saved
    got = gru_ops._Recurrence.backward(Ctx(), dy, dhn)
    for g, w in zip(got, want):
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
