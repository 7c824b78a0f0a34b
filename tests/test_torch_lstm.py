"""The port's LSTM layer (the counterpart of ops/pallas_rnn.py, kernels K1
and K2 on the GPU) and its nn modules against the JAX package on the CPU, at
the bar of tests/test_pallas_rnn.py: 1e-5 abs in f32, for the outputs and for
the gradients. The kernels themselves are held against the plain versions on
the GPU by tests/test_torch_kernels.py.

bf16 storage (MORGANA_PALLAS_STORE=bfloat16, pallas_rnn.STORE_DTYPE) is held
against the Pallas kernels in interpret mode with the same storage: within
BF16_ULPS units in the last place of bf16 at each tensor's largest |value|
(where f32 sums are taken in another order, a stored value can round to the
other bf16 neighbour; measured on the CPU: the values bit-equal, the
gradients within 2.7e-6 abs), and at least 10x closer in mean |error| to
JAX's bf16 path than to its f32 path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu import nn as jnn
from morgana_tpu.ops import pallas_rnn
from morgana_tpu.ops import rnn as rnn_ops
from morgana_tpu.ops.pallas_rnn import lstm_layer as pallas_lstm_layer

from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch.ops import lstm as lstm_ops

B, T, I, H = 4, 24, 8, 64
ATOL = 1e-5
BF16_ULPS = 4


def _inputs(seed, batch=B, steps=T):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, steps, I)).astype(np.float32)
    weights = [(0.3 * rng.normal(size=shape)).astype(np.float32)
               for shape in ((I, 4 * H), (H, 4 * H), (4 * H,), (4 * H,))]
    h0 = rng.normal(size=(batch, H)).astype(np.float32)
    c0 = rng.normal(size=(batch, H)).astype(np.float32)
    return x, weights, h0, c0


@pytest.mark.parametrize('seq_len', [None, [T, 13, 1, 0], [1, 1, 1, 1]],
                         ids=['no_seq_len', 'ragged_with_0_and_1', 'all_1'])
@pytest.mark.parametrize('with_state', [False, True], ids=['zero_state', 'h0_c0'])
def test_lstm_layer_matches_pallas_interpret_and_scan(seq_len, with_state):
    """Outputs (zero past seq_len) and the final (h, c) at seq_len, h0/c0 for
    an empty row."""
    x, weights, h0, c0 = _inputs(0)
    state = (h0, c0) if with_state else (None, None)
    jargs = dict(seq_len=None if seq_len is None else jnp.asarray(seq_len),
                 h0=None if state[0] is None else jnp.asarray(h0),
                 c0=None if state[1] is None else jnp.asarray(c0))
    want_pl = pallas_lstm_layer(jnp.asarray(x), *map(jnp.asarray, weights), interpret=True, **jargs)
    want_scan = rnn_ops.lstm(jnp.asarray(x), *map(jnp.asarray, weights), **jargs)
    got = lstm_ops.lstm_layer(
        torch.from_numpy(x), *map(torch.from_numpy, weights),
        seq_len=None if seq_len is None else torch.tensor(seq_len),
        h0=None if state[0] is None else torch.from_numpy(h0),
        c0=None if state[1] is None else torch.from_numpy(c0))
    (y, (hn, cn)) = got
    for want in (want_pl, want_scan):
        wy, (wh, wc) = want
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=ATOL)
        np.testing.assert_allclose(hn.numpy(), np.asarray(wh), atol=ATOL)
        np.testing.assert_allclose(cn.numpy(), np.asarray(wc), atol=ATOL)
    if seq_len is not None:
        for b, n in enumerate(seq_len):
            assert (y[b, n:] == 0).all()
        if with_state and 0 in seq_len:
            empty = seq_len.index(0)
            np.testing.assert_array_equal(hn[empty].numpy(), h0[empty])
            np.testing.assert_array_equal(cn[empty].numpy(), c0[empty])


def _loss_weights(seed, batch=B, steps=T):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((batch, steps, H), (batch, H), (batch, H))]


@pytest.mark.parametrize('seq_len', [None, [T, 13, 1, 0]], ids=['no_seq_len', 'ragged_with_0_and_1'])
@pytest.mark.parametrize('with_state', [False, True], ids=['zero_state', 'h0_c0'])
def test_lstm_layer_gradients_match_pallas_interpret_and_scan(seq_len, with_state):
    """Gradients of a loss on y, hn and cn with respect to all seven inputs:
    the port's autograd Function (plain K1 with gates, plain K2) against
    jax.grad through the Pallas kernels in interpret mode and through the
    scan; 1e-5 abs."""
    x, weights, h0, c0 = _inputs(2)
    wy, wh, wc = _loss_weights(3)
    h0 = h0 if with_state else np.zeros_like(h0)
    c0 = c0 if with_state else np.zeros_like(c0)
    jseq = None if seq_len is None else jnp.asarray(seq_len)

    def jax_loss(layer):
        def loss(x, w_ih, w_hh, b_ih, b_hh, h0, c0):
            y, (hn, cn) = layer(x, w_ih, w_hh, b_ih, b_hh, seq_len=jseq, h0=h0, c0=c0)
            return jnp.sum(y * wy) + jnp.sum(hn * wh) + jnp.sum(cn * wc)
        return jax.grad(loss, argnums=tuple(range(7)))

    jargs = [jnp.asarray(a) for a in (x, *weights, h0, c0)]
    want_pl = jax_loss(lambda *a, **k: pallas_lstm_layer(*a, interpret=True, **k))(*jargs)
    want_scan = jax_loss(rnn_ops.lstm)(*jargs)

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, *weights, h0, c0)]
    y, (hn, cn) = lstm_ops.lstm_layer(*leaves[:5], seq_len=None if seq_len is None else
                                      torch.tensor(seq_len), h0=leaves[5], c0=leaves[6])
    loss = (y * torch.from_numpy(wy)).sum() + (hn * torch.from_numpy(wh)).sum() \
        + (cn * torch.from_numpy(wc)).sum()
    got = torch.autograd.grad(loss, leaves)
    for want in (want_pl, want_scan):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_backward_reference_matches_autograd_through_the_plain_loop():
    """lstm_backward_reference (the plain K2) against torch autograd through
    lstm_recurrence_reference, with cotangents on every output, 1e-5 abs."""
    rng = np.random.default_rng(4)
    xg = torch.from_numpy(rng.normal(size=(T, B, 4 * H)).astype(np.float32)).requires_grad_(True)
    w_hh = torch.from_numpy((0.3 * rng.normal(size=(H, 4 * H))).astype(np.float32)).requires_grad_(True)
    h0, c0 = (torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32)).requires_grad_(True)
              for _ in range(2))
    y, c_all, g_all, hn, cn = lstm_ops.lstm_recurrence_reference(xg, w_hh, h0, c0)
    cot = [torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)) for t in (y, c_all, hn, cn)]
    want = torch.autograd.grad(sum((t * c).sum() for t, c in zip((y, c_all, hn, cn), cot)),
                               (xg, w_hh, h0, c0))
    dy, dc_all, dhn, dcn = cot
    dxg, dh0, dc0 = lstm_ops.lstm_backward_reference(g_all.detach(), w_hh.detach(), c0.detach(),
                                                     c_all.detach(), dy, dc_all, dhn, dcn)
    h_prev = torch.cat([h0[None], y]).detach()[:T]
    dw_hh = h_prev.reshape(T * B, H).t() @ dxg.reshape(T * B, 4 * H)
    for g, w in zip((dxg, dw_hh, dh0, dc0), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)


def test_gate_trace_only_when_a_gradient_is_needed():
    """The autograd Function (gate-writing K1, then K2) runs only when an
    input requires grad and grad mode is on; inference runs the recurrence
    alone."""
    x, weights, _, _ = _inputs(5)
    calls = []
    apply = lstm_ops._Recurrence.apply
    try:
        lstm_ops._Recurrence.apply = lambda *a: calls.append(1) or apply(*a)
        w = [torch.from_numpy(a).requires_grad_(True) for a in weights]
        with torch.inference_mode():
            lstm_ops.lstm_layer(torch.from_numpy(x), *w)
        with torch.no_grad():
            lstm_ops.lstm_layer(torch.from_numpy(x), *w)
        assert not calls
        lstm_ops.lstm_layer(torch.from_numpy(x), *w)
        assert calls == [1]
    finally:
        lstm_ops._Recurrence.apply = apply


def test_recurrence_reference_is_the_cpu_path():
    """On CPU tensors lstm_layer runs the plain version and launches nothing."""
    x, weights, h0, c0 = _inputs(1)
    before = (lstm_ops.launches, lstm_ops.gate_launches, lstm_ops.bwd_launches)
    w = [torch.from_numpy(a).requires_grad_(True) for a in weights]
    got = lstm_ops.lstm_layer(torch.from_numpy(x), *w)
    got[0].sum().backward()
    want = lstm_ops.lstm_layer_reference(torch.from_numpy(x), *w)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert (lstm_ops.launches, lstm_ops.gate_launches, lstm_ops.bwd_launches) == before


def _jax_recurrent(num_layers, seed):
    jnn.manual_seed(seed)
    return jnn.Recurrent('lstm', I, H, num_layers=num_layers)


@pytest.mark.parametrize('streaming', [False, True], ids=['sequence', 'one_frame_2d'])
def test_recurrent_stack_matches_jax(streaming):
    """Two stacked layers with the JAX names (w_ih_l0, ..., b_hh_l1) carried
    across by load_jax_params; a 2-d input is one frame (the streaming
    call) and threads given states through."""
    jmod = _jax_recurrent(2, 5)
    tmod = tnn.Recurrent('lstm', I, H, num_layers=2)
    tnn.load_jax_params(tmod, jnn.state_dict(jmod))
    rng = np.random.default_rng(6)
    if streaming:
        x = rng.normal(size=(B, I)).astype(np.float32)
        states = [tuple(rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
                  for _ in range(2)]
        jy, jh = jmod(jnp.asarray(x), [tuple(map(jnp.asarray, s)) for s in states])
        ty, th = tmod(torch.from_numpy(x), [tuple(map(torch.from_numpy, s)) for s in states])
    else:
        x = rng.normal(size=(B, T, I)).astype(np.float32)
        seq_len = np.array([T, 9, 1, 0])
        jy, jh = jmod(jnp.asarray(x), seq_len=jnp.asarray(seq_len))
        ty, th = tmod(torch.from_numpy(x), seq_len=torch.from_numpy(seq_len))
    assert ty.shape == tuple(jy.shape)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=ATOL)
    for (th_i, tc_i), (jh_i, jc_i) in zip(th, jh):
        np.testing.assert_allclose(th_i.detach().numpy(), np.asarray(jh_i), atol=ATOL)
        np.testing.assert_allclose(tc_i.detach().numpy(), np.asarray(jc_i), atol=ATOL)


def test_load_jax_params_is_strict():
    """A missing, unexpected or misshapen entry raises before anything is
    written."""
    params = jnn.state_dict(_jax_recurrent(1, 7))
    tmod = tnn.Recurrent('lstm', I, H)
    before = {k: v.detach().clone() for k, v in tmod.named_parameters()}

    missing = dict(params)
    del missing['b_hh_l0']
    with pytest.raises(KeyError, match='b_hh_l0'):
        tnn.load_jax_params(tmod, missing)
    with pytest.raises(KeyError, match='w_ih_l1'):
        tnn.load_jax_params(tmod, dict(params, w_ih_l1=params['w_ih_l0']))
    bad = dict(params, w_hh_l0=params['w_hh_l0'].T[:, :H])
    with pytest.raises(ValueError, match='w_hh_l0'):
        tnn.load_jax_params(tmod, bad)
    for name, value in tmod.named_parameters():
        torch.testing.assert_close(value, before[name], rtol=0, atol=0)

    tnn.load_jax_params(tmod, params)
    np.testing.assert_array_equal(tmod.w_hh_l0.detach().numpy(), params['w_hh_l0'])


def test_wavefront_backend_is_not_ported():
    with pytest.raises(NotImplementedError):
        tnn.Recurrent('lstm', I, H, backend='wavefront')


def _bf16_close(got, want, other):
    """got within BF16_ULPS bf16 ulps of want at its largest |value|, and at
    least 10x closer to it in mean |error| than to `other` (f32)."""
    got, want, other = (np.asarray(a, np.float32) for a in (got, want, other))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ULPS * 2.0 ** -7 * scale)
    assert np.abs(got - want).mean() * 10 <= np.abs(got - other).mean()


@pytest.mark.parametrize('with_state', [False, True], ids=['zero_state', 'h0_c0'])
def test_bf16_storage_matches_pallas_interpret(with_state, monkeypatch):
    """store_dtype='bfloat16' (the value of STORE_DTYPE with the variable set)
    against pallas_rnn.lstm_layer(interpret=True) with its STORE_DTYPE set, at
    B4 T32 H128 with a ragged seq_len: y, hn, cn and the gradients of a loss
    on them with respect to all seven inputs."""
    batch, steps, in_dim, hidden = 4, 32, 16, 128
    rng = np.random.default_rng(11)
    x = rng.normal(size=(batch, steps, in_dim)).astype(np.float32)
    weights = [(0.3 * rng.normal(size=shape)).astype(np.float32)
               for shape in ((in_dim, 4 * hidden), (hidden, 4 * hidden), (4 * hidden,),
                             (4 * hidden,))]
    weights[1] *= 0.3
    h0, c0 = (rng.normal(size=(batch, hidden)).astype(np.float32) if with_state
              else np.zeros((batch, hidden), np.float32) for _ in range(2))
    seq_len = np.array([steps, 13, 1, 0])
    loss_weights = [rng.normal(size=shape).astype(np.float32)
                    for shape in ((batch, steps, hidden), (batch, hidden), (batch, hidden))]

    def jax_run(store):
        monkeypatch.setattr(pallas_rnn, 'STORE_DTYPE', store)

        def loss(*args):
            outs = pallas_lstm_layer(*args[:5], seq_len=jnp.asarray(seq_len), h0=args[5],
                                     c0=args[6], interpret=True)
            y, (hn, cn) = outs
            return sum(jnp.sum(o * w) for o, w in zip((y, hn, cn), loss_weights)), (y, hn, cn)

        (_, outs), grads = jax.value_and_grad(loss, argnums=tuple(range(7)), has_aux=True)(
            *map(jnp.asarray, (x, *weights, h0, c0)))
        return [np.asarray(a) for a in (*outs, *grads)]

    want, f32 = jax_run('bfloat16'), jax_run(None)
    monkeypatch.setattr(lstm_ops, 'STORE_DTYPE', 'bfloat16')
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, *weights, h0, c0)]
    y, (hn, cn) = lstm_ops.lstm_layer(*leaves[:5], seq_len=torch.from_numpy(seq_len),
                                      h0=leaves[5], c0=leaves[6],
                                      store_dtype=lstm_ops.STORE_DTYPE)
    assert y.dtype == hn.dtype == cn.dtype == torch.float32
    loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip((y, hn, cn), loss_weights))
    grads = torch.autograd.grad(loss, leaves)
    assert all(g.dtype == torch.float32 for g in grads)
    got = [t.detach().numpy() for t in (y, hn, cn, *grads)]
    for name, g, w, o in zip(('y', 'hn', 'cn', 'dx', 'dw_ih', 'dw_hh', 'db_ih', 'db_hh', 'dh0',
                              'dc0'), got, want, f32):
        try:
            _bf16_close(g, w, o)
        except AssertionError as err:
            raise AssertionError(f'{name}: {err}') from None


def test_bf16_plain_kernels_round_where_pallas_does():
    """The plain K1 on bf16 xg and w_hh stores y, c_all and g_all in bf16 and
    keeps hn, cn in f32; the plain K2 stores dxg in bf16: the stored values
    are those of the f32 computation on the rounded h and dgates."""
    rng = np.random.default_rng(12)
    xg = torch.from_numpy(rng.normal(size=(T, B, 4 * H)).astype(np.float32)).bfloat16()
    w_hh = torch.from_numpy((0.3 * rng.normal(size=(H, 4 * H))).astype(np.float32)).bfloat16()
    h0, c0 = (torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32)) for _ in range(2))
    y, c_all, g_all, hn, cn = lstm_ops.lstm_recurrence_reference(xg, w_hh, h0, c0)
    assert (y.dtype, c_all.dtype, g_all.dtype, hn.dtype, cn.dtype) == (torch.bfloat16,) * 3 + \
        (torch.float32,) * 2
    # The last step again, by hand, from the stored h_{T-2}.
    gates = xg[-1].float() + y[-2].float() @ w_hh.float()
    i, f, g, o = gates.split(H, dim=-1)
    c = torch.sigmoid(f) * lstm_ops.lstm_recurrence_reference(xg[:-1], w_hh, h0, c0)[4] \
        + torch.sigmoid(i) * torch.tanh(g)
    torch.testing.assert_close(cn, c, rtol=0, atol=0)
    torch.testing.assert_close(y[-1], (torch.sigmoid(o) * torch.tanh(c)).bfloat16(), rtol=0, atol=0)
    cot = [torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)).bfloat16()
           for t in (y, c_all)] + [torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32))
                                   for _ in range(2)]
    dxg, dh0, dc0 = lstm_ops.lstm_backward_reference(g_all, w_hh, c0.bfloat16(), c_all, *cot)
    assert (dxg.dtype, dh0.dtype, dc0.dtype) == (torch.bfloat16, torch.float32, torch.float32)
    torch.testing.assert_close(dh0, dxg[0].float() @ w_hh.float().t(), rtol=0, atol=0)


def test_recurrent_pallas_backend_with_bf16_storage_matches_jax(monkeypatch):
    """Two stacked layers of Recurrent(backend='pallas') with STORE_DTYPE
    'bfloat16' against the JAX Recurrent(backend='pallas', interpret=True)
    with pallas_rnn.STORE_DTYPE 'bfloat16': y and each layer's (h, c) at a
    ragged seq_len, held as the layer is, against the JAX scan in f32."""
    jnn.manual_seed(13)
    jmods = {backend: jnn.Recurrent('lstm', I, H, num_layers=2, backend=backend,
                                    interpret=backend == 'pallas')
             for backend in ('pallas', 'scan')}
    params = jnn.state_dict(jmods['pallas'])
    jnn.load_state_dict(jmods['scan'], params)
    tmod = tnn.Recurrent('lstm', I, H, num_layers=2, backend='pallas')
    tnn.load_jax_params(tmod, params)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(B, T, I)).astype(np.float32)
    seq_len = np.array([T, 9, 1, 0])
    monkeypatch.setattr(pallas_rnn, 'STORE_DTYPE', 'bfloat16')
    monkeypatch.setattr(lstm_ops, 'STORE_DTYPE', 'bfloat16')
    jy, jh = jmods['pallas'](jnp.asarray(x), seq_len=jnp.asarray(seq_len))
    fy, fh = jmods['scan'](jnp.asarray(x), seq_len=jnp.asarray(seq_len))
    ty, th = tmod(torch.from_numpy(x), seq_len=torch.from_numpy(seq_len))
    _bf16_close(ty.detach().numpy(), jy, fy)
    for (t_h, t_c), (j_h, j_c), (f_h, f_c) in zip(th, jh, fh):
        _bf16_close(t_h.detach().numpy(), j_h, f_h)
        _bf16_close(t_c.detach().numpy(), j_c, f_c)


def test_scan_backend_ignores_the_storage_type(monkeypatch):
    """With STORE_DTYPE 'bfloat16' the 'scan' backend stays f32: its outputs
    and gradients are bit-equal to a run with the variable unset."""
    x, weights, _, _ = _inputs(15)
    mod = tnn.Recurrent('lstm', I, H, num_layers=2, backend='scan')
    seq_len = torch.tensor([T, 13, 1, 0])

    def run():
        mod.zero_grad()
        y, states = mod(torch.from_numpy(x), seq_len=seq_len)
        (y.sum() + sum(h.sum() + c.sum() for h, c in states)).backward()
        return [y.detach()] + [p.grad.clone() for p in mod.parameters()]

    unset = run()
    monkeypatch.setattr(lstm_ops, 'STORE_DTYPE', 'bfloat16')
    for got, want in zip(run(), unset):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize('hidden,width', [(40, 64), (96, 128)])
def test_zero_units_change_nothing(hidden, width):
    """The padding the kernels' wrappers apply to a width they are not built
    for is exact: the plain K1 and K2 on inputs padded with zero units give
    the unpadded results on the real units (1e-6 abs: the sums only gain
    zero terms) and exactly 0 on the zero units, in f32 and in bf16."""
    rng = np.random.default_rng(16)
    steps, batch = 9, 3
    for store in (torch.float32, torch.bfloat16):
        xg = torch.from_numpy(rng.normal(size=(steps, batch, 4 * hidden)).astype(np.float32))
        w_hh = torch.from_numpy((0.3 * rng.normal(size=(hidden, 4 * hidden))).astype(np.float32))
        h0, c0 = (torch.from_numpy(rng.normal(size=(batch, hidden)).astype(np.float32))
                  for _ in range(2))
        xg, w_hh = xg.to(store), w_hh.to(store)
        want = lstm_ops.lstm_recurrence_reference(xg, w_hh, h0, c0)
        padded = lstm_ops.lstm_recurrence_reference(
            lstm_ops._pad_units(xg, width, 4), lstm_ops._pad_w_hh(w_hh, width),
            lstm_ops._pad_units(h0, width), lstm_ops._pad_units(c0, width))
        for got, w, gates in zip(padded, want, (1, 1, 4, 1, 1)):
            assert got.shape[-1] == gates * width
            torch.testing.assert_close(lstm_ops._unpad_units(got, hidden, gates), w,
                                       rtol=0, atol=1e-6)
            if gates == 1:
                assert not got[..., hidden:].float().any()
        y, c_all, g_all = want[:3]
        cot = [torch.from_numpy(rng.normal(size=y.shape).astype(np.float32)).to(store)
               for _ in range(2)] + [torch.from_numpy(rng.normal(size=(batch, hidden))
                                                      .astype(np.float32)) for _ in range(2)]
        args = (g_all, w_hh, c0.to(store), c_all, *cot)
        want = lstm_ops.lstm_backward_reference(*args)
        pad_args = [lstm_ops._pad_units(g_all, width, 4), lstm_ops._pad_w_hh(w_hh, width)] + \
            [lstm_ops._pad_units(t, width) for t in args[2:]]
        padded = lstm_ops.lstm_backward_reference(*pad_args)
        for got, w, gates in zip(padded, want, (4, 1, 1)):
            torch.testing.assert_close(lstm_ops._unpad_units(got, hidden, gates), w,
                                       rtol=0, atol=1e-6)
            assert not got.reshape(*got.shape[:-1], gates, width)[..., hidden:].float().any()


def test_kernel_width_of_a_layer():
    """The built width a layer runs at on the GPU: its own where the kernels
    are built for it, else the next one up; B outside 1..256 and H above 1024
    raise."""
    for hidden, width in ((1, 64), (64, 64), (65, 128), (200, 256), (512, 512), (513, 1024),
                          (1024, 1024)):
        assert lstm_ops._width('K1', 16, hidden) == width
    with pytest.raises(ValueError, match='H up to 1024'):
        lstm_ops._width('K1', 16, 1028)
    for batch in (0, 257):
        with pytest.raises(ValueError, match='B <= 256'):
            lstm_ops._width('K2', batch, 512)
