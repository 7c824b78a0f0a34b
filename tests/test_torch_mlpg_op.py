"""MLPG's banded solve as the custom op ``morgana::mlpg_solve``
(``morgana_tpu_torch.ops.mlpg``) on the CPU, where it runs its plain
version, the Python loop of small ops that the kernel ``csrc/mlpg.cu``
follows rounding for rounding (the card's check is in
``tests/test_torch_kernels.py``).

Inputs are seeded numpy: banded SPD systems ``P = L L^T`` over (T', lanes),
and MLPG batches. The op gives its plain version's bits; against the JAX
package's ``_banded_cholesky_solve`` (vmapped over the lanes) it is within
5e-6 of the largest |x| (both f32, the same steps), and against a float64
solve within 2e-5 (the ROADMAP's bars for MLPG). Bandwidths 0 to 4, the
kernel's templates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from morgana_tpu.ops.mlpg import _banded_cholesky_solve as jsolve
from morgana_tpu.ops.mlpg import mlpg as jmlpg
from morgana_tpu.viz.synthesis import mlpg_numpy

from morgana_tpu_torch.ops import mlpg as tmlpg

JAX_RTOL = 5e-6
F64_RTOL = 2e-5


def _system(seed, bandwidth, frames=60, lanes=7):
    """``(b, bands)`` of seeded banded SPD systems, f32, with ``bands[m][i] =
    P[i, i + m]``; and the float64 solutions."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(frames, lanes))
    bands = np.zeros((bandwidth + 1, frames, lanes))
    x = np.zeros((frames, lanes))
    for lane in range(lanes):
        low = np.zeros((frames, frames))
        for m in range(bandwidth + 1):
            low += np.diag(rng.uniform(0.5, 1.5, frames - m) if m == 0
                           else rng.normal(scale=0.3, size=frames - m), -m)
        p = (low @ low.T).astype(np.float32).astype(np.float64)
        for m in range(bandwidth + 1):
            bands[m, :frames - m, lane] = np.diag(p, m)
        upper = np.stack([np.concatenate([np.zeros(bandwidth - m), np.diag(p, bandwidth - m)])
                          for m in range(bandwidth + 1)])
        x[:, lane] = scipy.linalg.solveh_banded(upper, b[:, lane].astype(np.float32))
    return b.astype(np.float32), bands.astype(np.float32), x


@pytest.mark.parametrize('bandwidth', [0, 1, 2, 3, 4])
def test_op_is_its_plain_version_and_holds_to_jax_and_float64(bandwidth):
    b, bands, exact = _system(bandwidth, bandwidth)
    got = torch.ops.morgana.mlpg_solve(torch.from_numpy(b), torch.from_numpy(bands))
    plain = tmlpg._banded_cholesky_solve(torch.from_numpy(b),
                                         list(torch.from_numpy(bands).unbind(0)), bandwidth)
    assert torch.equal(got, plain)
    want = jax.vmap(lambda bb, pb: jsolve(bb, pb, bandwidth), in_axes=(1, 1), out_axes=1)(
        jnp.asarray(b), jnp.asarray(np.moveaxis(bands, 0, -1)))
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got.numpy() / scale, np.asarray(want) / scale, atol=JAX_RTOL)
    np.testing.assert_allclose(got.numpy() / scale, exact / scale, atol=F64_RTOL)


def test_op_returns_a_tensor_of_its_own_and_its_fake_shape():
    b, bands, _ = _system(5, 2, frames=3, lanes=3)
    b, bands = torch.from_numpy(b), torch.from_numpy(bands)
    x = torch.ops.morgana.mlpg_solve(b, bands)
    assert x.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    torch.library.opcheck(torch.ops.morgana.mlpg_solve.default, (b, bands),
                          test_utils=('test_schema', 'test_faketensor'))


WINDOWS_BW4 = ((0, 0, (1.0,)), (1, 1, (-0.5, 0.0, 0.5)), (2, 2, (0.1, -0.2, 0.2, -0.2, 0.1)))


@pytest.mark.parametrize('windows', [None, WINDOWS_BW4], ids=['deltas', 'bandwidth4'])
def test_mlpg_through_the_op_matches_jax_and_float64(windows):
    """Ragged seq_len, padding 100 as the acoustic models use."""
    rng = np.random.default_rng(11)
    num_windows = 3
    means = rng.normal(size=(3, 40, num_windows * 4)).astype(np.float32)
    variances = rng.uniform(0.2, 2.0, size=(num_windows * 4,)).astype(np.float32)
    seq_len = np.array([40, 27, 1])
    kwargs = {} if windows is None else {'windows': windows}
    got = tmlpg.mlpg(torch.from_numpy(means), torch.from_numpy(variances), padding_size=100,
                     seq_len=torch.from_numpy(seq_len), **kwargs).numpy()
    want = np.asarray(jmlpg(jnp.asarray(means), jnp.asarray(variances), padding_size=100,
                            seq_len=jnp.asarray(seq_len), **kwargs))
    exact = mlpg_numpy(means, variances, padding_size=100, seq_len=seq_len, **kwargs)
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=JAX_RTOL)
    np.testing.assert_allclose(got / scale, exact / scale, atol=F64_RTOL)


class _Mlpg(torch.nn.Module):
    def forward(self, means, variances, seq_len):
        return tmlpg.mlpg(means, variances, padding_size=100, seq_len=seq_len)


def test_export_holds_one_node_per_solve():
    """torch.export of mlpg: the three passes over T' frames are one
    morgana::mlpg_solve node (the plain loop would unroll into thousands)."""
    rng = np.random.default_rng(2)
    args = (torch.from_numpy(rng.normal(size=(2, 30, 6)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0.2, 2.0, size=(6,)).astype(np.float32)),
            torch.tensor([30, 11]))
    with torch.no_grad():
        program = torch.export.export(_Mlpg(), args, strict=False)
    targets = [str(n.target) for n in program.graph.nodes if n.op == 'call_function']
    assert [t for t in targets if t.startswith('morgana.')] == ['morgana.mlpg_solve.default']
    assert len(targets) < 200
    torch.testing.assert_close(program.module()(*args), _Mlpg()(*args), rtol=0, atol=0)


def test_the_kernel_refuses_what_it_does_not_take():
    b = torch.zeros(4, 3)
    with pytest.raises(ValueError, match='bandwidths up to 4'):
        tmlpg._mlpg_solve_cuda(b, torch.zeros(6, 4, 3))
    with pytest.raises(ValueError, match='bands'):
        tmlpg._mlpg_solve_cuda(b, torch.zeros(4, 3))
    with pytest.raises(ValueError, match='no MLPG solve for device'):
        tmlpg.mlpg(torch.zeros(1, 4, 3, device='meta'), torch.ones(3, device='meta'))
