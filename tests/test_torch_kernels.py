"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the GPU only (a CUDA kernel has no CPU mode): every test here is marked
``cuda`` and skips without a GPU. The file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed::

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from morgana_tpu_torch.ops import lstm as lstm_ops

pytestmark = pytest.mark.cuda

HIDDEN = 512


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _layer_inputs(device, batch, steps, seed=8):
    rng = np.random.default_rng(seed)
    bound = HIDDEN ** -0.5

    def tensor(array):
        return torch.from_numpy(array.astype(np.float32)).to(device)

    x = tensor(rng.normal(size=(batch, steps, HIDDEN)))
    weights = [tensor(rng.uniform(-bound, bound, size=shape))
               for shape in ((HIDDEN, 4 * HIDDEN), (HIDDEN, 4 * HIDDEN), (4 * HIDDEN,), (4 * HIDDEN,))]
    seq_len = rng.integers(1, steps + 1, batch) if steps else np.zeros(batch, np.int64)
    seq_len[0] = min(steps, 1)
    state = [tensor(0.5 * rng.normal(size=(batch, HIDDEN))) for _ in range(2)]
    return x, weights, torch.from_numpy(seq_len).to(device), state


@pytest.mark.parametrize('batch,steps', [(32, 64), (5, 1), (40, 33), (16, 0)])
def test_k1_matches_plain_version(cuda_device, batch, steps):
    """K1 through lstm_layer against lstm_layer_reference on the same GPU
    tensors: ragged seq_len with a row of length 1, a given initial state,
    B not a multiple of 32, T = 1 and T = 0; f32 with TF32 off, 1e-4 abs."""
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


def test_k1_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    """float64, a non-contiguous xg and an H that is not a multiple of 4
    raise before any launch; nothing falls back to the plain version."""
    x, (w_ih, w_hh, b_ih, b_hh), _, (h0, c0) = _layer_inputs(cuda_device, 4, 3)
    xg = (x @ w_ih + b_ih + b_hh).transpose(0, 1).contiguous()
    before = lstm_ops.launches
    with pytest.raises(TypeError):
        lstm_ops.lstm_recurrence(xg.double(), w_hh.double(), h0.double(), c0.double())
    with pytest.raises(ValueError):
        lstm_ops.lstm_recurrence(xg.transpose(0, 1).contiguous().transpose(0, 1), w_hh, h0, c0)
    with pytest.raises(ValueError):
        lstm_ops.lstm_recurrence(xg[..., :4 * 6].contiguous(), w_hh[:6, :4 * 6].contiguous(),
                                 h0[:, :6].contiguous(), c0[:, :6].contiguous())
    assert lstm_ops.launches == before
