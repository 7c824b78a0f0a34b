"""The port's hand-written CUDA kernels (K1, the LSTM layer forward with and
without its gate trace, K2, its backward, K3, the GRU layer forward, K4, its
backward, K5/K6, attention forward and backward, their bf16-compute builds
K1c (with and without its gate trace), K2c, K3c, K4c, K5b (at the edges of
its tiles too) and K5b's backward, the bf16 weight-gradient carry, and
MLPG: its banded solve and the whole op from the means to the trajectory)
against their plain PyTorch versions, K1c and K2c's cluster kernels at
every width up to 512 and in an exported bf16 voice, K3c in an exported
bf16 F0 voice, and the batched vocoder's determinism
on the card, on the GPU only (a CUDA kernel has no CPU mode): every test
here is marked ``cuda`` and skips without a GPU. The file imports neither JAX nor the JAX
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
from morgana_tpu_torch.ops import precision
from morgana_tpu_torch.ops import weight_grad
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


# bf16 compute (K1c, K3c, K5b: the scan backend's and the attention's bf16
# products under --compute_dtype bfloat16) against the plain versions with
# the same rounding, on the same GPU tensors: within BF16_ULPS bf16 ulps of
# each output's largest |value| (a sum in another order may round h, or a
# probability, to the other bf16 neighbour), and closer in mean |error| to
# that plain version than to the f32 one: BF16_CLOSER times for K1c and K3c;
# for K5b merely closer (K5B_CLOSER), since it rounds the unnormalised
# probabilities of its online softmax where the plain version rounds the
# normalised ones, an independent rounding of the same size (measured on the
# H100: 0.68 of the error against f32 at every shape).
K5B_CLOSER = 1
# And o within K5B_O_OF_CONTROL times the largest |error| of the control, the
# plain version in f32 on the same bf16 q, k, v (no rounding of p):
# chip_smoke.py's constant (sound runs on the H100: 0.98-1.17); plus
# F32_SLACK of the largest |value| for the f32 sums alone (at T = 1 the
# control rounds nothing).
K5B_O_OF_CONTROL = 2.0
F32_SLACK = 2.0 ** -20


def _assert_bf16_compute(got, want, f32, closer=BF16_CLOSER):
    for g, w in zip(got, want):
        _assert_bf16_close(g, w)
    if closer == BF16_CLOSER:
        _assert_closer(got, want, f32)
        return
    near = sum(float((g - w).abs().sum()) for g, w in zip(got, want))
    far = sum(float((g - o).abs().sum()) for g, o in zip(got, f32))
    assert far > 0 and near * closer < far, (near, far)


@pytest.mark.parametrize('batch,steps,with_state', [(16, 64, False), (1, 64, True),
                                                    (40, 33, True), (5, 1, False),
                                                    (16, 0, False), (256, 5, True)])
def test_k1c_matches_plain_version(cuda_device, batch, steps, with_state):
    """lstm_layer(compute_dtype='bfloat16') (the bf16 input GEMM, then K1c)
    against lstm_layer_reference with the same compute dtype: y, hn and cn,
    ragged seq_len, with and without the carried state of a stream; one K1c
    launch."""
    x, weights, seq_len, (h0, c0) = _layer_inputs(cuda_device, batch, steps)
    state = {'h0': h0, 'c0': c0} if with_state else {}
    seq_len = seq_len if steps else None
    before = (lstm_ops.launches, lstm_ops.bf16_compute_launches)
    with torch.no_grad():
        y, (hn, cn) = lstm_ops.lstm_layer(x, *weights, seq_len=seq_len, compute_dtype='bfloat16',
                                          **state)
        torch.cuda.synchronize()
        assert (lstm_ops.launches, lstm_ops.bf16_compute_launches) == \
            (before[0] + 1, before[1] + 1)
        wy, (wh, wc) = lstm_ops.lstm_layer_reference(x, *weights, seq_len=seq_len,
                                                     compute_dtype='bfloat16', **state)
        fy, (fh, fc) = lstm_ops.lstm_layer_reference(x, *weights, seq_len=seq_len, **state)
    if steps > 1:
        _assert_bf16_compute([y, hn, cn], [wy, wh, wc], [fy, fh, fc])
    else:
        for g, w in ((y, wy), (hn, wh), (cn, wc)):
            _assert_bf16_close(g, w)


# K3c and K4c (csrc/gru_fwd_bf16.cu, csrc/gru_bwd_bf16.cu): F0Model's
# serving and training batches at T1024, DurationModel's at T128, B = 1, 40
# and 200 (50 CTAs of 4 rows), T = 17, 1 and 0, every width the kernels
# are built for.
K3C_SHAPES = [(16, 1024), (32, 1024), (32, 128), (1, 17), (40, 17), (200, 17), (5, 1), (16, 0)]


@pytest.mark.parametrize('hidden', GRU_HIDDEN)
@pytest.mark.parametrize('batch,steps', K3C_SHAPES)
def test_k3c_matches_plain_version(cuda_device, hidden, batch, steps):
    """gru_layer(compute_dtype='bfloat16') (the bf16 input GEMM, then K3c)
    against gru_layer_reference with the same compute dtype: y and hn,
    ragged seq_len with rows of length 1 and 0, a given h0; one K3c launch."""
    x, weights, seq_len, h0 = _gru_inputs(cuda_device, batch, steps, hidden)
    before = (gru_ops.launches, gru_ops.bf16_compute_launches)
    with torch.no_grad():
        y, hn = gru_ops.gru_layer(x, *weights, seq_len=seq_len, h0=h0, compute_dtype='bfloat16')
        torch.cuda.synchronize()
        assert (gru_ops.launches, gru_ops.bf16_compute_launches) == (before[0] + 1, before[1] + 1)
        wy, wh = gru_ops.gru_layer_reference(x, *weights, seq_len=seq_len, h0=h0,
                                             compute_dtype='bfloat16')
        fy, fh = gru_ops.gru_layer_reference(x, *weights, seq_len=seq_len, h0=h0)
    if steps > 1:
        _assert_bf16_compute([y, hn], [wy, wh], [fy, fh])
    else:
        _assert_bf16_close(y, wy)
        _assert_bf16_close(hn, wh)


@pytest.mark.parametrize('batch,heads,steps,head_dim,causal,window', ATTN_SHAPES)
def test_k5b_matches_plain_version(cuda_device, batch, heads, steps, head_dim, causal, window):
    """flash_attention(compute_dtype=bf16) (K5b on bf16 q, k and v) against
    the plain bf16 attention on the rows below seq_len; o in f32; rows that
    see no key are 0; one K5b launch."""
    q, k, v, seq_len = _attn_inputs(cuda_device, batch, heads, steps, head_dim)
    mask = {'seq_len': seq_len, 'causal': causal, 'window': window}
    before = (fa.launches, fa.bf16_launches)
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, compute_dtype=torch.bfloat16, **mask)
        torch.cuda.synchronize()
        assert (fa.launches, fa.bf16_launches) == (before[0] + 1, before[1] + 1)
        want = fa.flash_attention_reference(q, k, v, compute_dtype=torch.bfloat16, **mask)
        f32 = fa.flash_attention_reference(q, k, v, **mask)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    valid = _valid_rows(seq_len, steps)
    _assert_bf16_compute([got * valid], [want * valid], [f32 * valid],
                         BF16_CLOSER if steps == 1 else K5B_CLOSER)
    if batch > 2:
        assert (got[-1] == 0).all()


# K5b (csrc/attn_fwd_bf16.cu) at the edges of its 128-row query tiles, its
# two 64-row warpgroups and its 128-key tiles: T = 1, 63, 64, 65 and 130,
# every dh, full, causal and windowed masks (a window inside one key tile
# and one across two), B3 with a ragged row and an empty one.
K5B_EDGES = [(steps, head_dim, causal, window) for steps in (1, 63, 64, 65, 130)
             for head_dim in fa.HEAD_DIMS
             for causal, window in ((False, None), (True, None), (True, 8), (True, 100))]


@pytest.mark.parametrize('steps,head_dim,causal,window', K5B_EDGES)
def test_k5b_edges_match_plain_version(cuda_device, steps, head_dim, causal, window):
    """attention_forward on bf16 q, k and v (K5b alone) against the plain
    bf16 attention on the rows below seq_len, as chip_smoke.py's k5b_case
    holds it (BF16_ULPS bf16 ulps, nearer in the mean than the f32 plain
    version, within K5B_O_OF_CONTROL times the largest |error| of the plain
    version in f32 on the same bf16 q, k, v), and lse against the
    log-sum-exp of the bf16 logits; o and lse f32, the empty row o = 0 with
    lse +inf; one launch of the bf16 build."""
    q, k, v, seq_len = _attn_inputs(cuda_device, 3, 2, steps, head_dim, seed=19)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    mask = {'seq_len': seq_len, 'causal': causal, 'window': window}
    before = (fa.launches, fa.bf16_launches)
    with torch.no_grad():
        o, lse = fa.attention_forward(qb, kb, vb, **mask)
        torch.cuda.synchronize()
        assert (fa.launches, fa.bf16_launches) == (before[0] + 1, before[1] + 1)
        want = fa.flash_attention_reference(q, k, v, compute_dtype=torch.bfloat16, **mask)
        f32 = fa.flash_attention_reference(q, k, v, **mask)
        control = fa.flash_attention_reference(qb.float(), kb.float(), vb.float(), **mask)
        bias = fa.attention_bias(seq_len, steps, causal, window, device=cuda_device)
        logits = torch.matmul(qb.float(), kb.float().transpose(-1, -2)) / head_dim ** 0.5
        want_lse = torch.logsumexp(logits if bias is None else logits + bias, -1)
    assert o.dtype == lse.dtype == torch.float32 and torch.isfinite(o).all()
    valid = _valid_rows(seq_len, steps)
    _assert_bf16_compute([o * valid], [want * valid], [f32 * valid],
                         BF16_CLOSER if steps == 1 else K5B_CLOSER)
    err, control_err = (float(((t - want) * valid).abs().max()) for t in (o, control))
    assert err <= (K5B_O_OF_CONTROL * control_err
                   + F32_SLACK * float((want * valid).abs().max())), (err, control_err)
    rows = valid[..., 0].expand_as(lse)
    torch.testing.assert_close(torch.where(rows, lse, 0.), torch.where(rows, want_lse, 0.),
                               rtol=0, atol=1e-5 * max(1.0, float(want_lse[rows].abs().max())))
    assert (o[-1] == 0).all() and torch.isinf(lse[-1]).all()


def test_bf16_gradients_launch_the_backward_kernels(cuda_device):
    """A bf16 gradient on CUDA tensors raises nothing and falls back to
    nothing: lstm_layer, gru_layer and flash_attention with compute_dtype
    bf16 launch K1c with its gate trace, K2c and the bf16 carry; K3c, K4c
    and the carry; K5b and its backward, one each."""
    x, weights, seq_len, _ = _layer_inputs(cuda_device, 4, 6)
    gx, gweights, gseq_len, _ = _gru_inputs(cuda_device, 4, 6, 64)
    q, k, v, _ = _attn_inputs(cuda_device, 2, 2, 9, 64)
    counters = ((lstm_ops, 'bf16_compute_gate_launches'), (lstm_ops, 'bf16_compute_bwd_launches'),
                (gru_ops, 'bf16_compute_launches'), (gru_ops, 'bf16_compute_bwd_launches'),
                (fa, 'bf16_launches'), (fa, 'bf16_bwd_launches'), (weight_grad, 'launches'))
    before = [getattr(m, c) for m, c in counters]
    y, _ = lstm_ops.lstm_layer(x.requires_grad_(True), *weights, seq_len=seq_len,
                               compute_dtype='bfloat16')
    y.sum().backward()
    y, _ = gru_ops.gru_layer(gx.requires_grad_(True), *gweights, seq_len=gseq_len,
                             compute_dtype='bfloat16')
    y.sum().backward()
    o = fa.flash_attention(q.requires_grad_(True), k, v, compute_dtype=torch.bfloat16)
    o.sum().backward()
    torch.cuda.synchronize()
    launched = [getattr(m, c) - b for (m, c), b in zip(counters, before)]
    assert launched == [1, 1, 1, 1, 1, 1, 2], launched
    assert all(torch.isfinite(t.grad).all() for t in (x, gx, q))


def test_bf16_matmul_gradient_is_the_cpus(cuda_device):
    """precision.matmul's gradient on the GPU (the bf16 GEMM, then SGEMMs of
    the upcast operands, each rounded to bf16) against autograd through the
    roundings on the CPU: dx and dw bf16 values within BF16_ULPS ulps."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(3, 37, 96)).astype(np.float32)
    w = rng.normal(size=(96, 80)).astype(np.float32)
    dout = rng.normal(size=(3, 37, 80)).astype(np.float32)
    grads = {}
    for device in ('cpu', cuda_device):
        leaves = [torch.from_numpy(a).to(device).requires_grad_(True) for a in (x, w)]
        out = precision.matmul(*leaves, torch.bfloat16)
        (out * torch.from_numpy(dout).to(device)).sum().backward()
        grads[str(device)] = [t.grad.cpu() for t in leaves]
    for got, want in zip(grads['cuda'], grads['cpu']):
        torch.testing.assert_close(got, got.to(torch.bfloat16).float(), rtol=0, atol=0)
        _assert_bf16_close(got, want)


def _assert_bf16_grads(got, want, f32, steps, common_scale=False):
    """A bf16 backward's outputs `got` against its plain version's `want`:
    within BF16_ULPS ulps at each one's max |value| (with `common_scale`, at
    the largest of them all: attention's dq and dk are exactly 0 in the
    plain version where a row sees one key, and the kernel's rounding
    residue there is held to dv's scale), and, past T = 1, where the bf16
    roundings have a step to act on, closer in the mean to `want` than to
    `f32`, the f32 plain version's (K5B_CLOSER)."""
    scale = max(max((float(w.float().abs().max()) for w in want if w.numel()), default=0.0),
                1e-30)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        own = float(w.float().abs().max()) if w.numel() else 0.0
        tol = BF16_ULPS * 2.0 ** -7 * (scale if common_scale else own)
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol)
    if steps > 1:
        near = sum(float((g.float() - w.float()).abs().sum()) for g, w in zip(got, want))
        far = sum(float((g.float() - o.float()).abs().sum()) for g, o in zip(got, f32))
        assert far > 0 and near * K5B_CLOSER < far, (near, far)


# (B, T, H): the LSTM's training batch, B = 1, T = 1, T = 0, a width padded
# to the next built one (96 -> 128, 600 -> 1024) and B = 256.
K2C_SHAPES = [(32, 64, 512), (1, 33, 512), (5, 1, 512), (16, 0, 512), (40, 33, 96),
              (3, 9, 600), (256, 5, 512)]


@pytest.mark.parametrize('batch,steps,hidden', K2C_SHAPES)
def test_k1c_gates_k2c_and_carry_match_plain_versions(cuda_device, batch, steps, hidden):
    """The bf16 gradient path of lstm_layer (the bf16 input GEMM, K1c writing
    its gate trace, K2c, the bf16 carry of dW_hh) against the plain versions
    in the same autograd Function (lstm_layer_reference with compute_dtype
    bf16), for dx, the four weights, h0 and c0: within BF16_ULPS ulps at each
    gradient's max and closer in the mean to them than to the f32 plain
    gradients (K5B_CLOSER); K1c's gate trace and K2c alone against their
    plain versions on the same inputs likewise."""
    x, weights, seq_len, state = _layer_inputs(cuda_device, batch, steps, hidden=hidden)
    if steps == 0:
        seq_len = None

    def bf16(fn):
        return lambda *a, **k: fn(*a, compute_dtype='bfloat16', **k)

    counters = ('bf16_compute_gate_launches', 'bf16_compute_bwd_launches')
    before = [getattr(lstm_ops, c) for c in counters] + [weight_grad.launches]
    got = _loss_grads(bf16(lstm_ops.lstm_layer), x, weights, seq_len, state)
    torch.cuda.synchronize()
    assert [getattr(lstm_ops, c) for c in counters] + [weight_grad.launches] == \
        [b + 1 for b in before]
    want = _loss_grads(bf16(lstm_ops.lstm_layer_reference), x, weights, seq_len, state)
    f32 = _loss_grads(lstm_ops.lstm_layer_reference, x, weights, seq_len, state)
    _assert_bf16_grads(got, want, f32, steps)

    w_ih, w_hh, b_ih, b_hh = weights
    xg = (precision.matmul(x, w_ih, torch.bfloat16) + (b_ih + b_hh)).transpose(0, 1).contiguous()
    _, c_all, gates, _, _ = lstm_ops.lstm_recurrence(xg, w_hh, *state, with_gates=True,
                                                     compute_bf16=True)
    _, _, plain_gates, _, _ = lstm_ops.lstm_recurrence_reference(xg, w_hh, *state, True)
    _assert_bf16_close(gates, plain_gates)
    rng = np.random.default_rng(18)
    cot = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
           for shape in ((steps, batch, hidden),) * 2 + ((batch, hidden),) * 2]
    args = (gates, w_hh, state[1], c_all, *cot)
    _assert_bf16_grads(lstm_ops.lstm_backward(*args, compute_bf16=True),
                       lstm_ops.lstm_backward_reference(*args, compute_bf16=True),
                       lstm_ops.lstm_backward_reference(*args), steps)


# The bf16 cluster kernels (csrc/lstm_fwd_bf16.cu, csrc/lstm_bwd_bf16.cu),
# which K1c and K2c take at every width padded to at most 512
# (lstm_ops.bf16_route): B 1 to 256, H 64 to 512 and 200 (padded to 256),
# T 0, 1, 64 and 1024, with a carried state.
CLUSTER_WIDTHS = [64, 128, 256, 512, 200]
CLUSTER_SHAPES = [(1, 64), (16, 1024), (32, 64), (87, 33), (256, 5), (5, 1), (16, 0)]
CLUSTER_COUNTERS = ('bf16_cluster_launches', 'bf16_cluster_gate_launches',
                    'bf16_cluster_bwd_launches')


def _cluster_counts():
    return [getattr(lstm_ops, c) for c in CLUSTER_COUNTERS]


@pytest.mark.parametrize('hidden', CLUSTER_WIDTHS)
@pytest.mark.parametrize('batch,steps', CLUSTER_SHAPES)
def test_cluster_k1c_and_k2c_match_plain_versions(cuda_device, batch, steps, hidden):
    """lstm_layer(compute_dtype='bfloat16') with a carried state, forward
    (K1c without its gate trace, one cluster launch) and its gradient (K1c
    with the gate trace and K2c, one cluster launch each), against
    lstm_layer_reference with the same compute dtype: y, hn, cn within
    BF16_ULPS ulps and past T = 1 BF16_CLOSER times closer in the mean than
    to the f32 plain version; the gradients as
    test_k1c_gates_k2c_and_carry_match_plain_versions holds them; K2c alone
    on the layer's saved traces likewise."""
    x, weights, seq_len, state = _layer_inputs(cuda_device, batch, steps, hidden=hidden)
    seq_len = seq_len if steps else None
    kwargs = {'seq_len': seq_len, 'h0': state[0], 'c0': state[1]}
    before = _cluster_counts()
    with torch.no_grad():
        y, (hn, cn) = lstm_ops.lstm_layer(x, *weights, compute_dtype='bfloat16', **kwargs)
        torch.cuda.synchronize()
        assert _cluster_counts() == [before[0] + 1, before[1], before[2]]
        wy, (wh, wc) = lstm_ops.lstm_layer_reference(x, *weights, compute_dtype='bfloat16',
                                                     **kwargs)
        fy, (fh, fc) = lstm_ops.lstm_layer_reference(x, *weights, **kwargs)
    if steps > 1:
        _assert_bf16_compute([y, hn, cn], [wy, wh, wc], [fy, fh, fc])
    else:
        for g, w in ((y, wy), (hn, wh), (cn, wc)):
            _assert_bf16_close(g, w)

    def bf16(fn):
        return lambda *a, **k: fn(*a, compute_dtype='bfloat16', **k)

    before = _cluster_counts()
    got = _loss_grads(bf16(lstm_ops.lstm_layer), x, weights, seq_len, state)
    torch.cuda.synchronize()
    assert _cluster_counts() == [before[0] + 1, before[1] + 1, before[2] + 1]
    want = _loss_grads(bf16(lstm_ops.lstm_layer_reference), x, weights, seq_len, state)
    f32 = _loss_grads(lstm_ops.lstm_layer_reference, x, weights, seq_len, state)
    _assert_bf16_grads(got, want, f32, steps)

    w_ih, w_hh, b_ih, b_hh = weights
    xg = (precision.matmul(x, w_ih, torch.bfloat16) + (b_ih + b_hh)).transpose(0, 1).contiguous()
    _, c_all, gates, _, _ = lstm_ops.lstm_recurrence(xg, w_hh, *state, with_gates=True,
                                                     compute_bf16=True)
    rng = np.random.default_rng(19)
    cot = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
           for shape in ((steps, batch, hidden),) * 2 + ((batch, hidden),) * 2]
    args = (gates, w_hh, state[1], c_all, *cot)
    _assert_bf16_grads(lstm_ops.lstm_backward(*args, compute_bf16=True),
                       lstm_ops.lstm_backward_reference(*args, compute_bf16=True),
                       lstm_ops.lstm_backward_reference(*args), steps)


@pytest.mark.parametrize('hidden,route', [(512, 'cluster'), (96, 'cluster'), (600, 'grid'),
                                          (1024, 'grid')])
def test_bf16_width_rule_routes_the_launches(cuda_device, hidden, route):
    """A bf16 layer's K1c, K1c with its gate trace and K2c launch the
    cluster kernels at widths padded to at most 512 and the grid builds at
    1024, by the width alone: the cluster counters move with the route, the
    bf16-compute counters always; each route's outputs against the plain
    versions."""
    x, weights, seq_len, state = _layer_inputs(cuda_device, 4, 9, hidden=hidden)
    assert lstm_ops.bf16_route(hidden) == route
    compute = ('bf16_compute_launches', 'bf16_compute_gate_launches', 'bf16_compute_bwd_launches')
    before = _cluster_counts() + [getattr(lstm_ops, c) for c in compute]
    with torch.no_grad():
        y, _ = lstm_ops.lstm_layer(x, *weights, seq_len=seq_len, compute_dtype='bfloat16')
    _assert_bf16_close(y, lstm_ops.lstm_layer_reference(x, *weights, seq_len=seq_len,
                                                        compute_dtype='bfloat16')[0])
    grads = _loss_grads(lambda *a, **k: lstm_ops.lstm_layer(*a, compute_dtype='bfloat16', **k),
                        x, weights, seq_len, state)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g).all() for g in grads)
    moved = [a - b for a, b in zip(_cluster_counts() + [getattr(lstm_ops, c) for c in compute],
                                   before)]
    cluster = int(route == 'cluster')
    assert moved == [2 * cluster, cluster, cluster, 2, 1, 1], moved


def test_cluster_plan_fits_the_card(cuda_device):
    """cluster_plan: at H 512 a cluster of 16 CTAs fits (at least once);
    B = 16 and 32 take one n8 tile a cluster in one wave; B = 256 takes
    the largest tiles (4 forward, 2 backward)."""
    for gates in (False, True):
        tiles, clusters, fit = lstm_ops.cluster_plan(16, 512, gates)
        assert fit >= 2 and (tiles, clusters) == (1, 2)
        assert lstm_ops.cluster_plan(256, 512, gates)[0] == 4
    assert lstm_ops.cluster_plan(32, 512, backward=True)[:2] == (1, 4)
    assert lstm_ops.cluster_plan(256, 512, backward=True)[0] == 2


def test_bf16_lstm_bundle_launches_the_cluster_kernel(cuda_device, tmp_path):
    """A torch.export bundle of a bf16 LSTMAcousticModel voice (2 x LSTM(64),
    seeded) exported on the card: its morgana.lstm_fwd nodes carry
    compute_bf16 and resolve in ExportedVoice, each batch launches the
    cluster kernel once a layer, and its outputs are the bf16 engine's."""
    from morgana_tpu_torch import checkpointing
    from morgana_tpu_torch.data.synthetic import generate_voice_data
    from morgana_tpu_torch.export import ExportedVoice, export_bundle
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel
    from morgana_tpu_torch.serve import InferenceEngine

    data_root = str(tmp_path / 'data')
    generate_voice_data(data_root, num_train=4, num_valid=2, num_test=3, seed=21)
    kwargs = {'num_layers': 2, 'hidden_size': 64}
    model = LSTMAcousticModel(generator=torch.Generator().manual_seed(22), **kwargs)
    ckpt = checkpointing.save_state_dict(nn.state_dict(model), str(tmp_path / 'epoch_0.npz'))
    try:
        engine = InferenceEngine(LSTMAcousticModel, ckpt, data_root=data_root,
                                 model_kwargs=kwargs, device='cuda', batch_size=2,
                                 compute_dtype='bfloat16')
        manifest = export_bundle(engine, str(tmp_path / 'bundle'), data_dir='test',
                                 id_list='test/test_file_id_list.scp')
        batches = list(engine._loader('test', id_list='test/test_file_id_list.scp'))
        wants = [engine.predict_batch(features) for features in batches]
    finally:
        nn.set_default_compute_dtype(None)
    for prog in manifest['programs']:
        graph = torch.export.load(str(tmp_path / 'bundle' / prog['file'])).graph
        nodes = [n for n in graph.nodes if str(n.target).startswith('morgana.lstm_fwd')]
        assert len(nodes) == 2 and all(n.args[5] is True for n in nodes)
    voice = ExportedVoice(str(tmp_path / 'bundle'), device='cuda')
    for features, want in zip(batches, wants):
        before = lstm_ops.bf16_cluster_launches
        _, got = voice.run(features)
        torch.cuda.synchronize()
        assert lstm_ops.bf16_cluster_launches == before + 2
        for key in want:
            scale = max(float(want[key].abs().max()), 1e-30)
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize('hidden', GRU_HIDDEN)
@pytest.mark.parametrize('batch,steps', [(32, 64), (32, 1024), (1, 17), (5, 1), (16, 0),
                                         (40, 33), (200, 9)])
def test_k4c_and_carry_match_plain_versions(cuda_device, batch, steps, hidden):
    """The bf16 gradient path of gru_layer (K3c, hg on rounded operands, K4c,
    the bf16 carry of dW_hh) against the plain versions in the same autograd
    Function (gru_layer_reference with compute_dtype bf16): within
    BF16_ULPS ulps at each gradient's max and closer in the mean to them
    than to the f32 plain gradients; K4c alone against its plain version on
    the layer's operands likewise."""
    x, weights, seq_len, h0 = _gru_inputs(cuda_device, batch, steps, hidden)

    def bf16(fn):
        return lambda *a, **k: fn(*a, compute_dtype='bfloat16', **k)

    before = (gru_ops.bf16_compute_bwd_launches, weight_grad.launches)
    got = _gru_loss_grads(bf16(gru_ops.gru_layer), x, weights, seq_len, h0)
    torch.cuda.synchronize()
    assert (gru_ops.bf16_compute_bwd_launches, weight_grad.launches) == \
        (before[0] + 1, before[1] + 1)
    want = _gru_loss_grads(bf16(gru_ops.gru_layer_reference), x, weights, seq_len, h0)
    f32 = _gru_loss_grads(gru_ops.gru_layer_reference, x, weights, seq_len, h0)
    _assert_bf16_grads(got, want, f32, steps)

    w_ih, w_hh, b_ih, b_hh = weights
    xg = precision.matmul(x, w_ih, torch.bfloat16) + b_ih
    y, _ = gru_ops._gru_fwd_cuda(xg, w_hh, b_hh, h0, seq_len, compute_bf16=True)
    rng = np.random.default_rng(19)
    dy, dhn = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
               for shape in (tuple(y.shape), tuple(h0.shape)))
    _, hg = gru_ops.hidden_gates(w_hh, b_hh, h0, y, batch_first=True, compute=torch.bfloat16)
    args = (xg, hg, w_hh, h0, y, dy, dhn, seq_len)
    want = gru_ops.layer_backward_reference(*args, compute_bf16=True)
    f32 = gru_ops.layer_backward_reference(*args)
    _assert_bf16_grads(gru_ops._gru_bwd_cuda(*args, compute_bf16=True), want, f32, steps)


def test_bf16_f0_bundle_launches_k3c(cuda_device, tmp_path):
    """A torch.export bundle of a bf16 F0Model voice (seeded) exported on the
    card: its three morgana.gru_fwd nodes carry compute_bf16 and resolve in
    ExportedVoice, each batch launches K3c once a layer, and its outputs are
    the bf16 engine's."""
    from morgana_tpu_torch import checkpointing
    from morgana_tpu_torch.data.synthetic import generate_voice_data
    from morgana_tpu_torch.export import ExportedVoice, export_bundle
    from morgana_tpu_torch.models.f0_test_model import F0Model
    from morgana_tpu_torch.serve import InferenceEngine

    data_root = str(tmp_path / 'data')
    generate_voice_data(data_root, num_train=4, num_valid=2, num_test=3, seed=23)
    model = F0Model(generator=torch.Generator().manual_seed(24))
    ckpt = checkpointing.save_state_dict(nn.state_dict(model), str(tmp_path / 'epoch_0.npz'))
    try:
        engine = InferenceEngine(F0Model, ckpt, data_root=data_root, device='cuda',
                                 batch_size=2, compute_dtype='bfloat16')
        manifest = export_bundle(engine, str(tmp_path / 'bundle'), data_dir='test',
                                 id_list='test/test_file_id_list.scp')
        batches = list(engine._loader('test', id_list='test/test_file_id_list.scp'))
        wants = [engine.predict_batch(features) for features in batches]
    finally:
        nn.set_default_compute_dtype(None)
    for prog in manifest['programs']:
        graph = torch.export.load(str(tmp_path / 'bundle' / prog['file'])).graph
        nodes = [n for n in graph.nodes if str(n.target).startswith('morgana.gru_fwd')]
        assert len(nodes) == 3 and all(n.args[5] is True for n in nodes)
    voice = ExportedVoice(str(tmp_path / 'bundle'), device='cuda')
    for features, want in zip(batches, wants):
        before = gru_ops.bf16_compute_launches
        _, got = voice.run(features)
        torch.cuda.synchronize()
        assert gru_ops.bf16_compute_launches == before + 3
        for key in want:
            scale = max(float(want[key].abs().max()), 1e-30)
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-6 * scale)


# K5b's backward: every ATTN_SHAPES case, then each dh at T no multiple of
# its 32-row streamed tile, each with an empty batch row (no visible key)
# and, with a window, padded rows past it.
K5B_BWD_SHAPES = ATTN_SHAPES + [(3, 2, 45, 64, False, None), (3, 2, 100, 96, True, 20),
                                (3, 1, 47, 128, True, None), (3, 2, 150, 128, True, 64)]


@pytest.mark.parametrize('batch,heads,steps,head_dim,causal,window', K5B_BWD_SHAPES)
def test_k5b_backward_matches_plain_version(cuda_device, batch, heads, steps, head_dim, causal,
                                            window):
    """dq, dk, dv of a loss on the rows below seq_len through
    flash_attention(compute_dtype=bf16) (K5b, then its backward) against
    autograd through the plain bf16 attention, and K5b's backward alone on
    bf16 q, k and v against attention_backward_reference: within BF16_ULPS
    ulps at each gradient's max, closer in the mean to the bf16 plain
    version than to the f32 one; one backward launch of the bf16 build."""
    q, k, v, seq_len = _attn_inputs(cuda_device, batch, heads, steps, head_dim)
    mask = {'seq_len': seq_len, 'causal': causal, 'window': window}
    rng = np.random.default_rng(16)
    weight = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(cuda_device)
    weight = weight * _valid_rows(seq_len, steps)

    def grads(fn, **kwargs):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, **mask, **kwargs)
        return torch.autograd.grad((out * weight).sum(), leaves)

    before = fa.bf16_bwd_launches
    got = grads(fa.flash_attention, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fa.bf16_bwd_launches == before + 1
    want = grads(fa.flash_attention_reference, compute_dtype=torch.bfloat16)
    f32 = grads(fa.flash_attention_reference)
    _assert_bf16_grads(got, want, f32, steps, common_scale=True)

    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    o, lse = fa.attention_forward(qb, kb, vb, **mask)
    alone = fa.attention_backward(qb, kb, vb, o, lse, weight, **mask)
    plain = fa.attention_backward_reference(qb, kb, vb, weight, **mask)
    assert all(t.dtype == torch.bfloat16 for t in alone)
    _assert_bf16_grads(alone, plain, f32, steps, common_scale=True)


# (T, B, H, G, batch_major): the LSTM's training shape, the GRU's (G = 3H)
# as the layer hands it over (batch-major views), B past one staged chunk,
# T = 0, B = 1 and sizes no tile divides; then batches no multiple of the
# 16-deep k-step (17, 40), G below one 8-column tile, DurationModel's shape
# (H128 G384 T128, batch-major), T = 1, and T * H * G past the kernel's
# scratch of step products (two windows of steps).
CARRY_SHAPES = [(1024, 32, 512, 2048, False), (1024, 32, 64, 192, True), (9, 40, 33, 99, True),
                (0, 4, 64, 256, False), (17, 1, 128, 384, False), (5, 70, 20, 60, False),
                (33, 17, 64, 192, True), (17, 40, 128, 384, False), (9, 8, 20, 6, False),
                (128, 32, 128, 384, True), (1, 32, 512, 2048, False), (520, 32, 128, 512, False)]


@pytest.mark.parametrize('steps,batch,hidden,gates,batch_major', CARRY_SHAPES)
def test_bf16_carry_kernel_matches_plain_version(cuda_device, steps, batch, hidden, gates,
                                                 batch_major):
    """The bf16 weight-gradient carry against its plain version (one f32
    GEMM a step, the carry rounded to bf16): bf16 values within BF16_ULPS
    ulps at the max, closer in the mean to the plain version than to the
    f32 sum rounded once; one launch."""
    rng = np.random.default_rng(20)

    def tensor(*shape):
        array = rng.normal(size=shape).astype(np.float32)
        t = torch.from_numpy(array).to(cuda_device)
        return t.transpose(0, 1).contiguous().transpose(0, 1) if batch_major else t

    h_prev, dg = tensor(steps, batch, hidden), 1e-2 * tensor(steps, batch, gates)
    before = weight_grad.launches
    got = weight_grad.bf16_weight_grad(h_prev, dg)
    torch.cuda.synchronize()
    assert weight_grad.launches == before + 1
    want = weight_grad.bf16_weight_grad_reference(h_prev, dg)
    torch.testing.assert_close(got, got.to(torch.bfloat16).float(), rtol=0, atol=0)
    once = torch.einsum('tbh,tbg->hg', h_prev.to(torch.bfloat16).float(), dg)
    once = once.to(torch.bfloat16).float()
    _assert_bf16_grads([got], [want], [once], steps)


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


MLPG_SHAPES = [(16, 1024, 66, 2), (16, 1024, 1, 2), (3, 17, 4, 0), (2, 40, 5, 4)]
# csrc/mlpg.cu against its plain loop, relative to the largest |x|
# (chip_smoke.py's MLPG_RTOL): the kernel takes the loop's factor but
# substitutes in float64, partitioned along time.
MLPG_RTOL = 1e-6


def _banded_f64(b, bands, valid):
    """Float64 solutions of the f32 systems (T', lanes), lane by lane over
    each lane's first ``valid`` rows (x = 0 past them)."""
    import scipy.linalg
    bw = bands.shape[0] - 1
    b64, bands64 = b.double().cpu().numpy(), bands.double().cpu().numpy()
    x = np.zeros(b64.shape)
    for lane, n in enumerate(valid):
        if n == 0:
            continue
        upper = np.zeros((bw + 1, n))
        for m in range(min(bw + 1, n)):
            upper[bw - m, m:] = bands64[m, :n - m, lane]
        x[:n, lane] = scipy.linalg.solveh_banded(upper, b64[:n, lane])
    return x


def _assert_mlpg_close(got, plain, exact):
    """Within MLPG_RTOL of the plain loop's largest |x|; against float64,
    max and mean |error| at most twice the plain loop's own plus one f32
    ulp of the largest |x|."""
    got, plain = got.double().cpu().numpy(), plain.double().cpu().numpy()
    scale = np.abs(plain).max() if plain.size else 0.0
    assert np.isfinite(got).all()
    assert np.abs(got - plain).max(initial=0.0) <= MLPG_RTOL * scale
    if not exact.size:
        return
    ulp = float(np.spacing(np.float32(np.abs(exact).max())))
    err, own = np.abs(got - exact), np.abs(plain - exact)
    assert err.max() <= 2 * own.max() + ulp, (err.max(), own.max(), ulp)
    assert err.mean() <= 2 * own.mean() + ulp, (err.mean(), own.mean(), ulp)


@pytest.mark.parametrize('batch,frames,feats,bandwidth', MLPG_SHAPES)
def test_mlpg_solve_kernel_is_its_plain_version(cuda_device, batch, frames, feats, bandwidth):
    """csrc/mlpg.cu's solve alone on (T', lanes) systems of MLPG's sizes, T'
    = T + 200 (padding 100): the LSTM's three streams at B16 (1,056 lanes),
    F0's one, and small ones at bandwidths 0 and 4; diagonally dominant, so
    SPD. The kernel factors as the loop does and substitutes in float64,
    partitioned along time, so the two agree within MLPG_RTOL of the
    largest |x| (they agreed bit for bit while the kernel repeated the
    loop's order), and against a float64 solve of the same system the
    kernel's error is the loop's order of error; one launch."""
    from morgana_tpu_torch.ops import mlpg as mlpg_ops
    rng = np.random.default_rng(frames + feats)
    lanes, tp = batch * feats, frames + 200
    bands = rng.normal(scale=0.05, size=(bandwidth + 1, tp, lanes))
    bands[0] = rng.uniform(2.0, 3.0, size=(tp, lanes))
    for m in range(1, bandwidth + 1):
        bands[m, tp - m:] = 0.0
    bands = torch.from_numpy(bands.astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.normal(size=(tp, lanes)).astype(np.float32)).to(cuda_device)
    before = mlpg_ops.launches
    got = torch.ops.morgana.mlpg_solve(b, bands)
    torch.cuda.synchronize()
    assert mlpg_ops.launches == before + 1
    want = mlpg_ops._banded_cholesky_solve(b, list(bands.unbind(0)), bandwidth)
    _assert_mlpg_close(got, want, _banded_f64(b, bands, [tp] * lanes))


def test_mlpg_root_and_reciprocal_are_the_ieee_ones(cuda_device):
    """csrc/mlpg.cu's factor takes its roots and the reciprocals of its
    pivots by the fast paths of sqrt.rn and rcp.rn without their branches:
    bit for bit __fsqrt_rn's at every finite float32 from 1e-20 up (the
    pivots are clamped at 1e-20) and __frcp_rn's from 1e-20 to 2^126 (a
    root of a float32 is below 2^64)."""
    import ctypes

    from morgana_tpu_torch.ops._kernels import load_library, raise_on_error
    lib, fn = load_library('mlpg', 'morgana_mlpg_check_fast_paths',
                           [ctypes.c_uint] * 3 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
                           variant='mlpg_check')
    bad = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    lo = int(np.array(1e-20, np.float32).view(np.uint32))
    finite = int(np.array(np.finfo(np.float32).max, np.float32).view(np.uint32))
    err = fn(lo, finite, int(np.array(2.0 ** 126, np.float32).view(np.uint32)),
             bad.data_ptr(), cuda_device.index or 0, torch.cuda.current_stream().cuda_stream)
    raise_on_error(lib, err, 'the root and reciprocal check', '')
    assert bad.tolist() == [0, 0]


# (batch, frames, static features, padding, windows' bandwidth, seq_len
# kind): the LSTM's three streams and F0's one at B16 T1024 with ragged
# seq_len; small ones at bandwidths 0 and 4, with padding 0, an item of
# length 0, no seq_len, and float32 lengths (the models' collated n_frames).
MLPG_OP_SHAPES = [(16, 1024, 66, 100, 2, 'ragged'), (16, 1024, 1, 100, 2, 'ragged'),
                  (3, 17, 4, 0, 0, 'empty_row'), (2, 40, 5, 100, 4, 'empty_row'),
                  (4, 33, 3, 0, 2, 'none'), (3, 9, 2, 5, 4, 'ragged'),
                  (5, 60, 3, 100, 2, 'float')]
MLPG_WINDOWS = {0: ((0, 0, (1.0,)),),
                4: ((0, 0, (1.0,)), (1, 1, (-0.5, 0.0, 0.5)),
                    (2, 2, (0.1, -0.2, 0.2, -0.2, 0.1)))}


@pytest.mark.parametrize('batch,frames,feats,padding,bandwidth,lengths', MLPG_OP_SHAPES)
def test_mlpg_op_is_its_plain_path(cuda_device, batch, frames, feats, padding, bandwidth,
                                   lengths):
    """morgana::mlpg on the card (the systems formed from the means and
    variances in the kernel, the loop's factor, the partitioned float64
    substitutions, the unpad) against the
    plain path on the same inputs (banded_system, the plain loop, the
    unpad): within MLPG_RTOL of the largest |value|, and against a float64
    solve of the systems banded_system builds its error is the plain
    loop's order of error; 0 past seq_len; one launch per mlpg() call.
    Variances per item and frame for the small cases, global for MLPG's."""
    from morgana_tpu_torch.ops import mlpg as mlpg_ops
    windows = MLPG_WINDOWS.get(bandwidth, mlpg_ops.DEFAULT_WINDOWS)
    rng = np.random.default_rng(frames + feats + bandwidth)
    width = len(windows) * feats
    means = torch.from_numpy(rng.normal(size=(batch, frames, width)).astype(np.float32))
    vshape = (width,) if frames == 1024 else (batch, frames, width)
    variances = torch.from_numpy(rng.uniform(0.2, 2.0, size=vshape).astype(np.float32))
    seq_len = None
    if lengths != 'none':
        seq_len = torch.from_numpy(rng.integers(1, frames + 1, batch))
        seq_len[0] = frames
        if lengths == 'empty_row':
            seq_len[-1] = 0
        if lengths == 'float':
            seq_len = seq_len.float()
    dev = [t if t is None else t.to(cuda_device) for t in (means, variances, seq_len)]
    before, fused = mlpg_ops.launches, mlpg_ops.fused_launches
    got = mlpg_ops.mlpg(dev[0], dev[1], windows, padding, dev[2])
    torch.cuda.synchronize()
    assert (mlpg_ops.launches, mlpg_ops.fused_launches) == (before + 1, fused + 1)
    want = mlpg_ops._mlpg_plain(means, variances.expand(means.shape), seq_len, padding, windows)
    assert got.shape == want.shape == (batch, frames, feats)

    b, bands, lens = mlpg_ops.banded_system(means, variances, windows, padding, seq_len)
    valid = [int(n) + 2 * padding if n > 0 else 0 for n in lens for _ in range(feats)]
    exact = _banded_f64(b, bands, valid).reshape(-1, batch, feats).transpose(1, 0, 2)
    exact = exact[:, padding:padding + frames]
    exact = np.where((np.arange(frames)[None, :] < lens.numpy()[:, None])[:, :, None], exact, 0.)
    _assert_mlpg_close(got, want, exact)
    for item, n in enumerate(lens.tolist()):
        assert (got[item, n:] == 0).all()


