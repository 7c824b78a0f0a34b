"""The port's hand-written CUDA kernels (K1, the LSTM layer forward with and
without its gate trace, K2, its backward, K3, the GRU layer forward, K4, its
backward, and K5/K6, attention forward and backward) against their plain
PyTorch versions, and the batched vocoder's determinism on the card, on the
GPU only (a CUDA kernel has no CPU mode): every test here is marked
``cuda`` and skips without a GPU. The file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed::

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from morgana_tpu_torch import nn
from morgana_tpu_torch.ops import attention as attention_ops
from morgana_tpu_torch.ops import flash_attention as fa
from morgana_tpu_torch.ops import gru as gru_ops
from morgana_tpu_torch.ops import lstm as lstm_ops
from morgana_tpu_torch.vocoder import torch_world
from morgana_tpu_torch.vocoder import world

pytestmark = pytest.mark.cuda

HIDDEN = 512
# bf16 storage: kernel and plain version sum in f32 in other orders, so a
# stored value may round to the other bf16 neighbour and carry that through
# the chain: within BF16_ULPS units in the last place at each tensor's
# largest |value|. And at least BF16_CLOSER times closer in mean |error| to
# that plain version than to the plain version with f32 storage on the same
# inputs: a kernel that skipped the rounding of h or of the gate gradients
# before a product would sit near the second (on the H100, K2 built without
# the rounding of the gate gradients passed the ulp bound and was ~4000x
# further from the bf16 plain version than from the f32 one; the kernels
# are 7-9x closer at T = 64, 3.7-4.6x at T = 1024).
BF16_ULPS = 4
BF16_CLOSER = 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _layer_inputs(device, batch, steps, seed=8, hidden=HIDDEN):
    rng = np.random.default_rng(seed)
    bound = hidden ** -0.5

    def tensor(array):
        return torch.from_numpy(array.astype(np.float32)).to(device)

    x = tensor(rng.normal(size=(batch, steps, hidden)))
    weights = [tensor(rng.uniform(-bound, bound, size=shape))
               for shape in ((hidden, 4 * hidden), (hidden, 4 * hidden), (4 * hidden,), (4 * hidden,))]
    seq_len = rng.integers(1, steps + 1, batch) if steps else np.zeros(batch, np.int64)
    seq_len[0] = min(steps, 1)
    if batch > 2:
        seq_len[-1] = 0  # an empty row: its state is h0/c0, its gradient goes there
    state = [tensor(0.5 * rng.normal(size=(batch, hidden))) for _ in range(2)]
    return x, weights, torch.from_numpy(seq_len).to(device), state


def _assert_bf16_close(got, want):
    assert got.dtype == want.dtype
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=BF16_ULPS * 2.0 ** -7 * scale)


def _assert_closer(got, want, f32):
    """The tensors `got` BF16_CLOSER times closer in mean |error| to `want`
    (the bf16 plain version) than to `f32` (the f32 one, cast to got's
    types), which they differ from."""
    def mean_err(others):
        total = sum(float((g.float() - o.to(g.dtype).float()).abs().sum())
                    for g, o in zip(got, others))
        return total / sum(g.numel() for g in got)

    near, far = mean_err(want), mean_err(f32)
    assert far > 0 and near * BF16_CLOSER <= far, (near, far)


# (B, T): the training batch, edge shapes (T = 1, B not a multiple of 32,
# T = 0) and large batches (B = 88, 128, 256), which a K1 staging all of h
# in shared memory could not take.
LSTM_SHAPES = [(32, 64), (5, 1), (40, 33), (16, 0), (88, 9), (128, 9), (256, 5)]


@pytest.mark.parametrize('batch,steps', LSTM_SHAPES)
def test_k1_matches_plain_version(cuda_device, batch, steps):
    """K1 through lstm_layer against lstm_layer_reference on the same GPU
    tensors: ragged seq_len with rows of length 1 and 0, a given initial state,
    B not a multiple of 32, T = 1 and T = 0, B up to 256; f32 with TF32 off,
    1e-4 abs."""
    x, weights, seq_len, (h0, c0) = _layer_inputs(cuda_device, batch, steps)
    if steps == 0:
        seq_len = None
    before = lstm_ops.launches
    y, (hn, cn) = lstm_ops.lstm_layer(x, *weights, seq_len=seq_len, h0=h0, c0=c0)
    torch.cuda.synchronize()
    assert lstm_ops.launches == before + 1
    wy, (wh, wc) = lstm_ops.lstm_layer_reference(x, *weights, seq_len=seq_len, h0=h0, c0=c0)
    for got, want in ((y, wy), (hn, wh), (cn, wc)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def _loss_grads(layer, x, weights, seq_len, state, seed=9):
    """Gradients of a loss that reads y, hn and cn, with respect to x, the
    four weights and (h0, c0)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, *weights, *state)]
    y, (hn, cn) = layer(*leaves[:5], seq_len=seq_len, h0=leaves[5], c0=leaves[6])
    rng = np.random.default_rng(seed)
    loss = sum((out * torch.from_numpy(rng.normal(size=out.shape).astype(np.float32)).to(out.device)).sum()
               for out in (y, hn, cn))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # At T = 0 the plain loop never reads xg, so x has no path to the loss.
    return [torch.zeros_like(leaf) if g is None else g for g, leaf in zip(grads, leaves)]


@pytest.mark.parametrize('batch,steps', LSTM_SHAPES)
def test_k1_gates_and_k2_match_plain_versions(cuda_device, batch, steps):
    """The gradient-enabled path (K1 writing the gate trace, then K2) against
    autograd through the plain recurrence, for dx, dw_ih, dw_hh, db_ih,
    db_hh, dh0 and dc0: each within 1e-4 of its own max |value| (f32, TF32
    off; dW_hh sums T * B terms). The gate trace itself within 1e-4 abs."""
    x, weights, seq_len, state = _layer_inputs(cuda_device, batch, steps)
    if steps == 0:
        seq_len = None
    before = (lstm_ops.launches, lstm_ops.gate_launches, lstm_ops.bwd_launches)
    got = _loss_grads(lstm_ops.lstm_layer, x, weights, seq_len, state)
    torch.cuda.synchronize()
    assert (lstm_ops.launches, lstm_ops.gate_launches, lstm_ops.bwd_launches) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
    want = _loss_grads(lstm_ops.lstm_layer_reference, x, weights, seq_len, state)
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30) if w.numel() else 1.0
        torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=1e-4)

    xg = (x @ weights[0] + weights[2] + weights[3]).transpose(0, 1).contiguous()
    _, _, g_kernel, _, _ = lstm_ops.lstm_recurrence(xg, weights[1], *state, with_gates=True)
    _, _, g_plain, _, _ = lstm_ops.lstm_recurrence_reference(xg, weights[1], *state)
    torch.testing.assert_close(g_kernel, g_plain, rtol=0, atol=1e-4)


def test_k2_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    """float64, a non-contiguous input and an H above the widest built one
    (1024) raise before any launch; the K2 counter does not move."""
    batch, steps, hidden = 4, 3, 8
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)

    args = [t(steps, batch, 4 * hidden), t(hidden, 4 * hidden), t(batch, hidden),
            t(steps, batch, hidden), t(steps, batch, hidden), t(steps, batch, hidden),
            t(batch, hidden), t(batch, hidden)]
    before = lstm_ops.bwd_launches
    with pytest.raises(TypeError):
        lstm_ops.lstm_backward(*[a.double() for a in args])
    with pytest.raises(ValueError, match='contiguous'):
        lstm_ops.lstm_backward(*args[:3], args[3].transpose(0, 1).contiguous().transpose(0, 1),
                               *args[4:])
    wide = 1028
    bad = [t(steps, batch, 4 * wide), t(wide, 4 * wide), t(batch, wide), t(steps, batch, wide),
           t(steps, batch, wide), t(steps, batch, wide), t(batch, wide), t(batch, wide)]
    with pytest.raises(ValueError, match='take H up to 1024'):
        lstm_ops.lstm_backward(*bad)
    assert lstm_ops.bwd_launches == before


def test_k1_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    """float64, a non-contiguous xg, an H above the widest built one (1024)
    and B = 257 raise before any launch; nothing falls back to the plain
    version."""
    x, (w_ih, w_hh, b_ih, b_hh), _, (h0, c0) = _layer_inputs(cuda_device, 4, 3)
    xg = (x @ w_ih + b_ih + b_hh).transpose(0, 1).contiguous()
    before = lstm_ops.launches
    with pytest.raises(TypeError):
        lstm_ops.lstm_recurrence(xg.double(), w_hh.double(), h0.double(), c0.double())
    with pytest.raises(ValueError):
        lstm_ops.lstm_recurrence(xg.transpose(0, 1).contiguous().transpose(0, 1), w_hh, h0, c0)
    too_wide = torch.zeros((3, 4, 4 * 1028), device=cuda_device)
    with pytest.raises(ValueError, match='take H up to 1024'):
        lstm_ops.lstm_recurrence(too_wide, torch.zeros((1028, 4 * 1028), device=cuda_device),
                                 too_wide[0, :, :1028].contiguous(),
                                 too_wide[0, :, :1028].contiguous())
    wide = torch.zeros((3, 257, 4 * HIDDEN), device=cuda_device)
    state = torch.zeros((257, HIDDEN), device=cuda_device)
    with pytest.raises(ValueError, match='B <= 256'):
        lstm_ops.lstm_recurrence(wide, w_hh, state, state)
    assert lstm_ops.launches == before


@pytest.mark.parametrize('hidden', [64, 96, 128, 200, 256, 600, 1024])
def test_lstm_kernels_at_the_other_widths(cuda_device, hidden):
    """K1 and K2 at the other widths they are built for (1 or 2 units a
    block; 8 at 1024, K2 over 128 blocks) and at widths the wrapper pads
    with zero units to the next built one (96, 200, 600): the layer's values
    (1e-4 abs) and gradients (1e-4 of each max) against the plain versions,
    B = 40, T = 33; one launch of each kernel."""
    x, weights, seq_len, state = _layer_inputs(cuda_device, 40, 33, hidden=hidden)
    with torch.inference_mode():
        got = lstm_ops.lstm_layer(x, *weights, seq_len=seq_len, h0=state[0], c0=state[1])
        want = lstm_ops.lstm_layer_reference(x, *weights, seq_len=seq_len, h0=state[0],
                                             c0=state[1])
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)
    before = (lstm_ops.gate_launches, lstm_ops.bwd_launches)
    got = _loss_grads(lstm_ops.lstm_layer, x, weights, seq_len, state)
    torch.cuda.synchronize()
    assert (lstm_ops.gate_launches, lstm_ops.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = _loss_grads(lstm_ops.lstm_layer_reference, x, weights, seq_len, state)
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30)
        torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=1e-4)


@pytest.mark.parametrize('batch,steps', [(16, 64), (32, 64), (5, 1), (88, 9), (256, 5)])
def test_bf16_storage_kernels_match_plain_versions(cuda_device, batch, steps):
    """K1 and K2 built for bf16 storage against the plain versions on the same
    bf16 tensors, in the working type: K1's y, c_all and g_all (bf16) within
    BF16_ULPS ulps, hn and cn (f32) likewise; K2's dxg (bf16), dh0 and dc0.
    Each kernel's outputs BF16_CLOSER times closer to its bf16 plain version
    than to the f32 one on the same inputs (where T > 1, so that a rounded h
    or dgates reaches a product)."""
    x, (w_ih, w_hh, b_ih, b_hh), _, (h0, c0) = _layer_inputs(cuda_device, batch, steps)
    xg = (x @ w_ih + b_ih + b_hh).transpose(0, 1).contiguous().bfloat16()
    w_s = w_hh.bfloat16()
    before = (lstm_ops.launches, lstm_ops.bwd_launches)
    got = lstm_ops.lstm_recurrence(xg, w_s, h0, c0, with_gates=True)
    want = lstm_ops.lstm_recurrence_reference(xg, w_s, h0, c0)
    for g, w in zip(got, want):
        _assert_bf16_close(g, w)
    if steps > 1:
        _assert_closer(got, want, lstm_ops.lstm_recurrence_reference(xg.float(), w_s.float(), h0, c0))
    _, c_all, g_all, _, _ = got
    rng = np.random.default_rng(17)
    cot = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
           for shape in ((steps, batch, HIDDEN),) * 2 + ((batch, HIDDEN),) * 2]
    args = (g_all, w_s, c0.bfloat16(), c_all, cot[0].bfloat16(), cot[1].bfloat16(), *cot[2:])
    got = lstm_ops.lstm_backward(*args)
    torch.cuda.synchronize()
    assert (lstm_ops.launches, lstm_ops.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = lstm_ops.lstm_backward_reference(*args)
    for g, w in zip(got, want):
        _assert_bf16_close(g, w)
    if steps > 1:
        _assert_closer(got, want, lstm_ops.lstm_backward_reference(*(a.float() for a in args)))


def test_bf16_storage_layer_gradients_match_plain_versions(cuda_device):
    """lstm_layer with store_dtype='bfloat16' (K1 and K2 built for bf16)
    against lstm_layer_reference with the same storage (the plain versions
    in the same autograd Function): values and the seven gradients, each
    within BF16_ULPS bf16 ulps of its max |value| and BF16_CLOSER times closer
    to it than to the f32 plain layer's; B32 T64, ragged seq_len."""
    x, weights, seq_len, state = _layer_inputs(cuda_device, 32, 64)

    def layer(reference):
        fn = lstm_ops.lstm_layer_reference if reference else lstm_ops.lstm_layer
        return lambda *a, **k: fn(*a, store_dtype='bfloat16', **k)

    got = _loss_grads(layer(False), x, weights, seq_len, state)
    want = _loss_grads(layer(True), x, weights, seq_len, state)
    f32 = _loss_grads(lstm_ops.lstm_layer_reference, x, weights, seq_len, state)
    for g, w, o in zip(got, want, f32):
        _assert_bf16_close(g, w)
        _assert_closer([g], [w], [o])


# (B, T): the training batch, edge shapes (T = 1, T = 0, B = 1, B not a
# multiple of 32, B above the SM count) and F0Model's serving shape, whose
# 1024-step chain carries each split-k rounding through the whole sequence.
GRU_SHAPES = [(32, 64), (5, 1), (40, 33), (16, 0), (1, 17), (256, 9), (16, 1024)]
GRU_HIDDEN = [32, 64, 96, 128]


def _gru_inputs(device, batch, steps, hidden, seed=10):
    """Seeded inputs of one GRU(hidden) layer fed by 48 features: x, the four
    weights, a ragged seq_len with rows of length 1 and 0, and h0."""
    rng = np.random.default_rng(seed)
    bound = hidden ** -0.5

    def tensor(array):
        return torch.from_numpy(array.astype(np.float32)).to(device)

    x = tensor(rng.normal(size=(batch, steps, 48)))
    weights = [tensor(rng.uniform(-bound, bound, size=shape))
               for shape in ((48, 3 * hidden), (hidden, 3 * hidden), (3 * hidden,), (3 * hidden,))]
    seq_len = rng.integers(1, steps + 1, batch) if steps else np.zeros(batch, np.int64)
    seq_len[0] = min(steps, 1)
    if batch > 2:
        seq_len[-1] = 0  # an empty row: its state is h0, its gradient goes there
    h0 = tensor(0.5 * rng.normal(size=(batch, hidden)))
    return x, weights, (None if steps == 0 else torch.from_numpy(seq_len).to(device)), h0


@pytest.mark.parametrize('hidden', GRU_HIDDEN)
@pytest.mark.parametrize('batch,steps', GRU_SHAPES)
def test_k3_matches_plain_version(cuda_device, batch, steps, hidden):
    """K3 through gru_layer against gru_layer_reference on the same GPU
    tensors, under no_grad (K3 alone): ragged seq_len with rows of length 1
    and 0, a given h0, B = 1, 5, 16, 40 and 256, T = 0, 1 and 1024, every H
    the kernel is built for; f32 with TF32 off, 1e-4 abs."""
    x, weights, seq_len, h0 = _gru_inputs(cuda_device, batch, steps, hidden)
    before = gru_ops.launches
    with torch.no_grad():
        y, hn = gru_ops.gru_layer(x, *weights, seq_len=seq_len, h0=h0)
        torch.cuda.synchronize()
        assert gru_ops.launches == before + 1
        wy, wh = gru_ops.gru_layer_reference(x, *weights, seq_len=seq_len, h0=h0)
    torch.testing.assert_close(y, wy, rtol=0, atol=1e-4)
    torch.testing.assert_close(hn, wh, rtol=0, atol=1e-4)


def _gru_loss_grads(layer, x, weights, seq_len, h0, seed=11):
    """Gradients of a loss that reads y and hn, with respect to x, the four
    weights and h0."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, *weights, h0)]
    y, hn = layer(*leaves[:5], seq_len=seq_len, h0=leaves[5])
    rng = np.random.default_rng(seed)
    loss = sum((out * torch.from_numpy(rng.normal(size=out.shape).astype(np.float32)).to(out.device)).sum()
               for out in (y, hn))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # At T = 0 the plain loop never reads xg, so x has no path to the loss.
    return [torch.zeros_like(leaf) if g is None else g for g, leaf in zip(grads, leaves)]


@pytest.mark.parametrize('hidden', GRU_HIDDEN)
@pytest.mark.parametrize('batch,steps', GRU_SHAPES)
def test_k4_gradients_match_plain_versions(cuda_device, batch, steps, hidden):
    """The gradient-enabled path (K3, then K4) against autograd through the
    plain recurrence, for dx, dw_ih, dw_hh, db_ih, db_hh and dh0: each within
    1e-4 of its own max |value| (f32, TF32 off; dW_hh sums T * B terms). K4
    alone, on the layer's batch-major operands and seq_len, fed hg from the
    one GEMM, against layer_backward_reference (dxg, dnr, dh0), and through
    the time-major gru_backward against gru_backward_reference: 1e-4 of each
    output's max |value|."""
    x, weights, seq_len, h0 = _gru_inputs(cuda_device, batch, steps, hidden)
    before = (gru_ops.launches, gru_ops.bwd_launches)
    got = _gru_loss_grads(gru_ops.gru_layer, x, weights, seq_len, h0)
    torch.cuda.synchronize()
    assert (gru_ops.launches, gru_ops.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = _gru_loss_grads(gru_ops.gru_layer_reference, x, weights, seq_len, h0)
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30) if w.numel() else 1.0
        torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=1e-4)

    w_ih, w_hh, b_ih, b_hh = weights
    xg = x @ w_ih + b_ih
    y, _ = gru_ops._gru_fwd_cuda(xg, w_hh, b_hh, h0, seq_len)
    rng = np.random.default_rng(12)
    dy, dhn = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
               for shape in (tuple(y.shape), tuple(h0.shape)))
    _, hg = gru_ops.hidden_gates(w_hh, b_hh, h0, y, batch_first=True)
    args = (xg, hg, w_hh, h0, y, dy, dhn, seq_len)
    xg_t, y_t, dy_t = (t.transpose(0, 1).contiguous() for t in (xg, y, dy))
    _, hg_t = gru_ops.hidden_gates(w_hh, b_hh, h0, y_t)
    for got, want in ((gru_ops._gru_bwd_cuda(*args), gru_ops.layer_backward_reference(*args)),
                      (gru_ops.gru_backward(xg_t, w_hh, b_hh, h0, y_t, dy_t, dhn),
                       gru_ops.gru_backward_reference(xg_t, hg_t, w_hh, h0, y_t, dy_t, dhn))):
        for g, w in zip(got, want):
            scale = max(float(w.abs().max()), 1e-30) if w.numel() else 1.0
            torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=1e-4)


@pytest.mark.parametrize('hidden', GRU_HIDDEN)
@pytest.mark.parametrize('extra', [1, 5])
def test_gru_kernels_past_one_wave(cuda_device, extra, hidden):
    """B past the rows one wave of the card holds at one row a CTA (a
    2-CTA cluster at H = 128), odd: K3 against the plain layer (1e-4 abs)
    and the gradient path against autograd through the plain recurrence
    (1e-4 of each gradient's max |value|)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    batch = sms // (2 if hidden > 96 else 1) + extra
    batch += 1 - batch % 2
    x, weights, seq_len, h0 = _gru_inputs(cuda_device, batch, 21, hidden)
    with torch.no_grad():
        y, hn = gru_ops.gru_layer(x, *weights, seq_len=seq_len, h0=h0)
        wy, wh = gru_ops.gru_layer_reference(x, *weights, seq_len=seq_len, h0=h0)
    torch.testing.assert_close(y, wy, rtol=0, atol=1e-4)
    torch.testing.assert_close(hn, wh, rtol=0, atol=1e-4)
    got = _gru_loss_grads(gru_ops.gru_layer, x, weights, seq_len, h0)
    want = _gru_loss_grads(gru_ops.gru_layer_reference, x, weights, seq_len, h0)
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30)
        torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=1e-4)


def test_gru_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """float64, a non-contiguous operand, an operand on another device, an H
    that is not a multiple of 32 or above 128, and B = 0 raise before any
    launch; the counters do not move and nothing falls back."""
    rng = np.random.default_rng(13)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)

    def fwd_args(batch, steps, hidden):
        return [t(steps, batch, 3 * hidden), t(hidden, 3 * hidden), t(3 * hidden), t(batch, hidden)]

    def bwd_args(batch, steps, hidden):
        return fwd_args(batch, steps, hidden) + [t(steps, batch, hidden), t(steps, batch, hidden),
                                                 t(batch, hidden)]

    before = (gru_ops.launches, gru_ops.bwd_launches)
    for op, make in ((gru_ops.gru_recurrence, fwd_args), (gru_ops.gru_backward, bwd_args)):
        args = make(4, 3, 64)
        with pytest.raises(TypeError, match='float32'):
            op(*[a.double() for a in args])
        with pytest.raises(ValueError, match='contiguous'):
            op(args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:])
        with pytest.raises(ValueError, match='is on cpu'):
            op(args[0], args[1].cpu(), *args[2:])
        for batch, hidden, limit in ((4, 48, 'multiple of 32'), (4, 160, 'up to 128'),
                                     (0, 64, 'B >= 1')):
            with pytest.raises(ValueError, match=limit):
                op(*make(batch, 3, hidden))
    assert (gru_ops.launches, gru_ops.bwd_launches) == before


# (B, H, T, dh, causal, window): the model's heads (dh 96), the other two
# widths, T not a multiple of the 64-row tile, T = 1, and a small window with
# padded rows past it that see no key. Then, for each dh, the edges of the
# tiles: T one past a 64-row query tile and 64-key forward stage (65, 129),
# one past a 32-row backward stage (33, 97), seq_len ending inside a tile,
# and windows narrower than a stage (5, 31) or just wider (33).
ATTN_SHAPES = [(4, 2, 130, 96, False, None), (3, 4, 77, 64, True, None),
               (2, 2, 200, 128, True, 16), (1, 1, 1, 96, False, None),
               (3, 2, 77, 96, True, 8), (2, 4, 300, 96, True, 256),
               (3, 2, 65, 64, False, None), (3, 2, 65, 96, True, None),
               (3, 2, 65, 128, False, None), (3, 2, 33, 64, True, None),
               (3, 2, 33, 96, False, None), (3, 2, 97, 128, True, None),
               (3, 2, 129, 64, True, 5), (3, 2, 129, 96, True, 31),
               (3, 2, 161, 128, True, 33), (2, 1, 257, 96, True, 40)]


def _attn_inputs(device, batch, heads, steps, head_dim, seed=14):
    """Seeded q, k, v (B, H, T, dh) and a ragged seq_len with a full row and,
    for B > 2, an empty one."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(batch, heads, steps, head_dim)).astype(np.float32))
               .to(device) for _ in range(3))
    seq_len = rng.integers(1, steps + 1, batch)
    seq_len[0] = steps
    if batch > 2:
        seq_len[-1] = 0
    return q, k, v, torch.from_numpy(seq_len).to(device)


def _valid_rows(seq_len, steps):
    return (torch.arange(steps, device=seq_len.device)[None, :] < seq_len[:, None])[:, None, :, None]


@pytest.mark.parametrize('batch,heads,steps,head_dim,causal,window', ATTN_SHAPES)
def test_attention_forward_matches_plain_version(cuda_device, batch, heads, steps, head_dim,
                                                 causal, window):
    """The forward kernel through flash_attention against
    flash_attention_reference on the same GPU tensors, on the rows below
    seq_len (the others are padding): 1e-4 abs, f32 with TF32 off. Rows that
    see no key are 0, never NaN."""
    q, k, v, seq_len = _attn_inputs(cuda_device, batch, heads, steps, head_dim)
    before = fa.launches
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, seq_len=seq_len, causal=causal, window=window)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        want = fa.flash_attention_reference(q, k, v, seq_len=seq_len, causal=causal, window=window)
    assert torch.isfinite(got).all()
    valid = _valid_rows(seq_len, steps)
    torch.testing.assert_close(got * valid, want * valid, rtol=0, atol=1e-4)
    if batch > 2:
        assert (got[-1] == 0).all()  # the empty row sees no key


@pytest.mark.parametrize('batch,heads,steps,head_dim,causal,window', ATTN_SHAPES)
def test_attention_backward_matches_autograd_through_the_plain_version(
        cuda_device, batch, heads, steps, head_dim, causal, window):
    """dq, dk, dv of a loss on the rows below seq_len: the kernels (forward,
    then backward) against autograd through the plain version, each within
    1e-4 of the largest |value| of the three; two runs of the backward are
    bit-identical (no atomics)."""
    q, k, v, seq_len = _attn_inputs(cuda_device, batch, heads, steps, head_dim)
    rng = np.random.default_rng(15)
    weight = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(cuda_device)
    weight = weight * _valid_rows(seq_len, steps)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, seq_len=seq_len, causal=causal, window=window)
        return torch.autograd.grad((out * weight).sum(), leaves)

    before = (fa.launches, fa.bwd_launches)
    got = grads(fa.flash_attention)
    again = grads(fa.flash_attention)
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_launches) == (before[0] + 2, before[1] + 2)
    want = grads(fa.flash_attention_reference)
    # dq and dk are exactly 0 where every row sees one key (T = 1): each
    # gradient is held relative to the largest |value| of the three.
    scale = max(max(float(w.abs().max()) for w in want), 1e-30)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g / scale, w / scale, rtol=0, atol=1e-4)


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """dh 80, float64, a non-contiguous operand and an operand on the CPU
    raise before any launch; T = 0 returns an empty output without one; the
    counters do not move and nothing falls back."""
    q, k, v, seq_len = _attn_inputs(cuda_device, 2, 2, 9, 64)
    before = (fa.launches, fa.bwd_launches)
    with pytest.raises(ValueError, match='dh in'):
        fa.flash_attention(*(torch.zeros(2, 2, 9, 80, device=cuda_device) for _ in range(3)))
    with pytest.raises(TypeError, match='float32'):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match='contiguous'):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match='is on cpu'):
        fa.flash_attention(q, k.cpu(), v)
    o, lse = fa.attention_forward(q, k, v, seq_len=seq_len)
    with pytest.raises(ValueError, match='contiguous'):
        fa.attention_backward(q, k, v, o, lse, o.transpose(2, 3).contiguous().transpose(2, 3))
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1])
    empty = torch.zeros(2, 2, 0, 96, device=cuda_device)
    assert fa.flash_attention(empty, empty, empty).shape == (2, 2, 0, 96)
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1])


def test_attention_dropout_takes_the_plain_path_in_training(cuda_device):
    """As in the JAX package, probability dropout in training leaves the
    kernels: MultiHeadAttention launches no attention kernel, forward or
    backward, and equals the plain exact path with the same CUDA generator
    bit for bit; in eval mode it launches the forward kernel."""
    torch.manual_seed(16)
    mha = nn.MultiHeadAttention(384, 4, dropout=0.1).to(cuda_device)
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.normal(size=(2, 70, 384)).astype(np.float32)).to(cuda_device)
    seq_len = torch.tensor([70, 41], device=cuda_device)
    before = (fa.launches, fa.bwd_launches)
    mha.generator = torch.Generator(device=cuda_device).manual_seed(3)
    got = mha(x, seq_len=seq_len)
    got.sum().backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_launches) == before
    with torch.no_grad():
        q, k, v = (t.reshape(2, 70, 4, 96).transpose(1, 2).contiguous()
                   for t in mha.in_proj(x).split(384, dim=-1))
        bias = fa.attention_bias(seq_len, 70, device=cuda_device)
        o = attention_ops.scaled_dot_product_attention(
            q, k, v, bias=bias, dropout_p=0.1,
            generator=torch.Generator(device=cuda_device).manual_seed(3))
        want = mha.out_proj(o.transpose(1, 2).reshape(2, 70, 384))
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
    mha.eval()
    with torch.no_grad():
        mha(x, seq_len=seq_len)
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1])


def test_batched_vocoder_is_deterministic_and_matches_the_cpu(cuda_device):
    """torch_world.synthesize_batch at B3 T96 (16 kHz, hop 80): two runs on
    the card give the same bits (the overlap-add uses no atomics), and each
    row agrees with the CPU run within 1e-5 relative L2 (f0 200 and 100 Hz,
    whose phase steps are exact in float32, so the pulse trains agree)."""
    rng = np.random.default_rng(12)
    lens, steps, hop = (96, 72, 50), 96, 80
    bins = np.linspace(0, 8000, 513)
    env = (0.6 * np.exp(-0.5 * ((bins - 700) / 180.0) ** 2)
           + 0.4 * np.exp(-0.5 * ((bins - 1800) / 260.0) ** 2) + 1e-3)
    f0, vuv = np.zeros((2, 3, steps))
    mcep, bap = np.zeros((3, steps, 60)), np.zeros((3, steps, 5))
    noise = np.zeros((3, steps * hop))
    for i, n in enumerate(lens):
        sp = np.tile(env ** 2, (n, 1)) * (1 + 0.05 * rng.standard_normal((n, 1)))
        f0[i, :n], vuv[i, :n] = (200.0, 100.0, 200.0)[i], 1.0
        mcep[i, :n] = world.spectrum_to_mcep(sp, order=59, fs=16000)
        bap[i, :n] = -8.0 + 0.3 * rng.standard_normal((n, 5))
        noise[i, :n * hop] = rng.standard_normal(n * hop)
    vuv[2, 20:35] = 0.0
    args = (f0, vuv, mcep, bap, np.array(lens), 16000)
    runs = [torch_world.synthesize_batch(*args, noise=noise, device=cuda_device)[0].cpu()
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    cpu = torch_world.synthesize_batch(*args, noise=noise, device='cpu')[0]
    for i in range(3):
        rel = float((runs[0][i] - cpu[i]).norm() / cpu[i].norm())
        assert rel < 1e-5, (i, rel)
