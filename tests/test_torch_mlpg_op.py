"""MLPG's custom ops (``morgana_tpu_torch.ops.mlpg``) on the CPU:
``morgana::mlpg``, the whole of MLPG from the means and variances to the
trajectory, and ``morgana::mlpg_solve``, the banded solve alone. On the CPU
each runs its plain version (the system build, the Python loop of small ops,
the unpad); on the card each is one launch of ``csrc/mlpg.cu`` (its checks
are in ``tests/test_torch_kernels.py``, the CPU model of its partition
solve in ``tests/test_torch_mlpg_partition.py``).

Inputs are seeded numpy: banded SPD systems ``P = L L^T`` over (T', lanes),
and MLPG batches. The solve gives its plain version's bits; against the JAX
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
    """torch.export of mlpg: the system build, the three passes over T'
    frames and the unpad are one morgana::mlpg node (the plain loop would
    unroll into thousands)."""
    rng = np.random.default_rng(2)
    args = (torch.from_numpy(rng.normal(size=(2, 30, 6)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0.2, 2.0, size=(6,)).astype(np.float32)),
            torch.tensor([30, 11]))
    with torch.no_grad():
        program = torch.export.export(_Mlpg(), args, strict=False)
    targets = [str(n.target) for n in program.graph.nodes if n.op == 'call_function']
    assert [t for t in targets if t.startswith('morgana.')] == ['morgana.mlpg.default']
    assert len(targets) < 200
    torch.testing.assert_close(program.module()(*args), _Mlpg()(*args), rtol=0, atol=0)


def _op_args(seed, variance_shape, seq_len=True, batch=3, frames=12, feat=2):
    rng = np.random.default_rng(seed)
    means = torch.from_numpy(rng.normal(size=(batch, frames, 3 * feat)).astype(np.float32))
    shape = {'global': (3 * feat,), 'per_frame': (frames, 3 * feat),
             'per_item': (batch, frames, 3 * feat)}[variance_shape]
    variances = torch.from_numpy(rng.uniform(0.2, 2.0, size=shape).astype(np.float32))
    lengths = torch.tensor([frames, 5, 0])[:batch] if seq_len else None
    coeffs, bounds = tmlpg._flat_windows(tmlpg.DEFAULT_WINDOWS)
    return means, variances.expand(means.shape), lengths, 4, coeffs, bounds


@pytest.mark.parametrize('variance_shape', ['global', 'per_frame', 'per_item'])
@pytest.mark.parametrize('seq_len', [True, False], ids=['seq_len', 'no_seq_len'])
def test_mlpg_op_returns_a_tensor_of_its_own_and_its_fake_shape(variance_shape, seq_len):
    """``morgana::mlpg`` on variances expanded to the means (strides of 0,
    not copied): (B, T, D) of its own, the schema and the fake shape hold
    (opcheck), and it is mlpg()'s output."""
    args = _op_args(4, variance_shape, seq_len)
    out = torch.ops.morgana.mlpg(*args)
    assert out.shape == (3, 12, 2) and out.dtype == torch.float32
    assert all(out.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
               for t in args[:2])
    torch.testing.assert_close(out, tmlpg.mlpg(args[0], args[1], padding_size=4,
                                               seq_len=args[2]), rtol=0, atol=0)
    torch.library.opcheck(torch.ops.morgana.mlpg.default, args,
                          test_utils=('test_schema', 'test_faketensor'))
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = torch.ops.morgana.mlpg(*(mode.from_tensor(a) if torch.is_tensor(a) else a
                                        for a in args))
    assert fake.shape == (3, 12, 2)


def test_the_windows_go_through_the_schema_exactly():
    """Taps are passed as Python floats (doubles), so a window's products
    c_a c_{a+m} round to f32 from the same doubles as the plain build's."""
    windows = ((0, 0, (1.0,)), (1, 1, (-0.5, 0.0, 0.5)), (2, 2, (0.1, -0.2, 0.2, -0.2, 0.1)))
    coeffs, bounds = tmlpg._flat_windows(windows)
    assert tmlpg._windows(coeffs, bounds) == windows
    assert bounds == [0, 0, 1, 1, 2, 2] and len(coeffs) == 9
    with pytest.raises(ValueError, match='needs 3 taps'):
        tmlpg._flat_windows(((1, 1, (0.5, 0.5)),))


def _streams(rng, batch, frames):
    return {name: (torch.from_numpy(rng.normal(size=(batch, frames, 3 * d)).astype(np.float32)),
                   torch.from_numpy(rng.uniform(0.2, 2.0, size=(3 * d,)).astype(np.float32)))
            for name, d in (('lf0', 1), ('mcep', 6), ('bap', 2))}


class _Acoustic(torch.nn.Module):
    """The MLPG of LSTMAcousticModel's and TransformerAcousticModel's
    predict: three streams in one call."""

    def forward(self, lf0, lf0_var, mcep, mcep_var, bap, bap_var, seq_len):
        from morgana_tpu_torch.viz.synthesis import MLPG_streams
        streams = {'lf0': (lf0, lf0_var), 'mcep': (mcep, mcep_var), 'bap': (bap, bap_var)}
        return tuple(MLPG_streams(streams, padding_size=100, seq_len=seq_len).values())


class _F0(torch.nn.Module):
    """The MLPG of F0Model's predict: one stream."""

    def forward(self, lf0, lf0_var, seq_len):
        from morgana_tpu_torch.viz.synthesis import MLPG
        return MLPG(lf0, lf0_var, padding_size=100, seq_len=seq_len)


@pytest.mark.parametrize('model', ['acoustic', 'f0'])
def test_an_exported_models_mlpg_is_one_node(model):
    """The MLPG calls of the models' predict (three streams for the LSTM
    and Transformer voices, one for F0) export to exactly one morgana.mlpg
    node (the exported bundles' programs: tests/test_torch_export.py), and
    the program gives the eager outputs."""
    rng = np.random.default_rng(6)
    streams = _streams(rng, 2, 30)
    seq_len = torch.tensor([30, 11])
    if model == 'acoustic':
        module, args = _Acoustic(), tuple(t for pair in streams.values() for t in pair)
    else:
        module, args = _F0(), streams['lf0']
    args = args + (seq_len,)
    with torch.no_grad():
        program = torch.export.export(module, args, strict=False)
    targets = [str(n.target) for n in program.graph.nodes if n.op == 'call_function']
    assert [t for t in targets if t.startswith('morgana.')] == ['morgana.mlpg.default']
    got, want = program.module()(*args), module(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_the_kernel_refuses_what_it_does_not_take():
    b = torch.zeros(4, 3)
    with pytest.raises(ValueError, match='bandwidths up to 4'):
        tmlpg._mlpg_solve_cuda(b, torch.zeros(6, 4, 3))
    with pytest.raises(ValueError, match='bands'):
        tmlpg._mlpg_solve_cuda(b, torch.zeros(4, 3))
    with pytest.raises(ValueError, match='no MLPG solve for device'):
        tmlpg.mlpg(torch.zeros(1, 4, 3, device='meta'), torch.ones(3, device='meta'))
    means = torch.zeros(2, 4, 6)
    wide = ((0, 0, (1.0,)), (0, 5, (1.0,) * 6))
    with pytest.raises(ValueError, match='bandwidths up to 4'):
        tmlpg._mlpg_cuda(means, means, None, 0, wide)
    with pytest.raises(ValueError, match='variances must be float32'):
        tmlpg._mlpg_cuda(means, means[:1], None, 0, tmlpg.DEFAULT_WINDOWS)
    with pytest.raises(ValueError, match='seq_len must be'):
        tmlpg._mlpg_cuda(means, means, torch.zeros(3, dtype=torch.long), 0,
                         tmlpg.DEFAULT_WINDOWS)
