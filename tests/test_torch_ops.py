"""The port's ops and data pipeline against the JAX package on the CPU:
masks, duration upsampling, deltas, normalisers, bucketing and collation,
MLPG, plus the port's device and import rules. Inputs come from seeded numpy
and go to both sides; each test states its tolerance."""
import ast
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu import data as jdata
from morgana_tpu.ops import deltas as jdeltas
from morgana_tpu.ops import masking as jmasking
from morgana_tpu.ops import sequence as jsequence
from morgana_tpu.ops.mlpg import mlpg as jmlpg
from morgana_tpu.viz.synthesis import MLPG_streams as jMLPG_streams
from morgana_tpu.viz.synthesis import mlpg_numpy

from morgana_tpu_torch import data as tdata
from morgana_tpu_torch.device import DeviceError, resolve_device
from morgana_tpu_torch.ops import deltas as tdeltas
from morgana_tpu_torch.ops import masking as tmasking
from morgana_tpu_torch.ops import sequence as tsequence
from morgana_tpu_torch.ops.mlpg import mlpg as tmlpg
from morgana_tpu_torch.viz.synthesis import MLPG_streams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('max_len', [None, 12])
def test_sequence_mask_matches_jax(max_len):
    seq_len = np.array([5, 0, 3, 7])
    want = np.asarray(jmasking.sequence_mask(jnp.asarray(seq_len), max_len=max_len))
    got = tmasking.sequence_mask(torch.from_numpy(seq_len), max_len=max_len).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('max_len', [None, 64])
def test_upsample_to_repetitions_matches_jax(max_len):
    """Exact: a gather of the same rows (zero-length items and zero padding
    included)."""
    rng = np.random.default_rng(0)
    feature = rng.normal(size=(3, 6, 5)).astype(np.float32)
    repeats = rng.integers(0, 5, size=(3, 6, 1)).astype(np.float32)
    repeats[1, 4:] = 0          # padded phones
    repeats[2, 2] = 0           # a zero-length phone inside the sequence
    want = np.asarray(jsequence.upsample_to_repetitions(
        jnp.asarray(feature), jnp.asarray(repeats), max_len=max_len))
    got = tsequence.upsample_to_repetitions(
        torch.from_numpy(feature), torch.from_numpy(repeats), max_len=max_len).numpy()
    np.testing.assert_array_equal(got, want)


def test_compute_deltas_matches_jax():
    feature = np.random.default_rng(1).normal(size=(17, 4)).astype(np.float32)
    np.testing.assert_array_equal(tdeltas.compute_deltas(feature),
                                  jdeltas.compute_deltas(feature))
    assert tdeltas.DEFAULT_WINDOWS == jdeltas.DEFAULT_WINDOWS


@pytest.mark.parametrize('kind', ['mvn', 'minmax'])
def test_normaliser_round_trip_matches_jax(kind, tmp_path):
    """Same JSON contract; normalise on numpy equals JAX exactly, denormalise
    of a tensor matches JAX within 1e-6 and inverts normalise within 1e-5."""
    rng = np.random.default_rng(2)
    dim = 6
    if kind == 'mvn':
        params = {'mean': rng.normal(size=dim), 'std_dev': rng.uniform(0.5, 2, dim)}
        delta_params = {'mean': rng.normal(size=3 * dim), 'std_dev': rng.uniform(0.5, 2, 3 * dim)}
        jcls, tcls = jdata.MeanVarianceNormaliser, tdata.MeanVarianceNormaliser
    else:
        low = rng.normal(size=dim)
        high = low + rng.uniform(0.5, 2, dim)
        high[0] = low[0]        # a constant column: scale falls back to 1
        params = {'mmin': low, 'mmax': high}
        delta_params = {'mmin': np.tile(low, 3), 'mmax': np.tile(high, 3)}
        jcls, tcls = jdata.MinMaxNormaliser, tdata.MinMaxNormaliser
    for name, p in (('feat', params), ('feat_deltas', delta_params)):
        with open(tmp_path / f'{name}_{kind}.json', 'w') as f:
            json.dump({k: v.tolist() for k, v in p.items()}, f)
    jnorm, tnorm = jcls('feat', use_deltas=True), tcls('feat', use_deltas=True)
    jnorm.load_params('.', str(tmp_path))
    tnorm.load_params('.', str(tmp_path))

    for deltas, d in ((False, dim), (True, 3 * dim)):
        feature = rng.normal(size=(11, d)).astype(np.float32)
        np.testing.assert_array_equal(tnorm.normalise(feature, deltas=deltas),
                                      jnorm.normalise(feature, deltas=deltas))
        batch = rng.normal(size=(2, 11, d)).astype(np.float32)
        got = tnorm.denormalise(torch.from_numpy(batch), deltas=deltas)
        want = np.asarray(jnorm.denormalise(jnp.asarray(batch), deltas=deltas))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        back = tnorm.normalise(got, deltas=deltas)
        np.testing.assert_allclose(back.numpy(), batch, atol=1e-5)


def test_bucket_size_matches_jax():
    assert [tdata.bucket_size(n) for n in range(1, 2100)] == \
        [jdata.bucket_size(n) for n in range(1, 2100)]


def test_dataset_and_collate_match_jax(voice_data):
    """The port's FilesDataset + collate give the JAX pipeline's padded batch,
    key for key (sources and normalisers of the acoustic model)."""
    import sys
    sys.path.insert(0, os.path.join(REPO, 'models'))
    try:
        from rnn_spss import LSTMAcousticModel as JModel
    finally:
        sys.path.pop(0)
    from morgana_tpu_torch.models.rnn_spss import LSTMAcousticModel as TModel

    root = voice_data['data_root']
    datasets = []
    for model, pkg in ((JModel(num_layers=1, hidden_size=8), jdata),
                       (TModel(num_layers=1, hidden_size=8), tdata)):
        normalisers = model.normaliser_sources()
        for normaliser in normalisers.values():
            normaliser.load_params('train', root)
        datasets.append(pkg.FilesDataset(model.train_data_sources(), 'train',
                                         'train/train_file_id_list.scp', normalisers, root))
    want, got = (pkg.collate([ds[i] for i in range(len(ds))])
                 for pkg, ds in zip((jdata, tdata), datasets))
    assert sorted(got) == sorted(want)
    for key in want:
        if isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            assert got[key] == want[key], key
    loaded = list(tdata.batch(datasets[1], batch_size=3))
    assert [b['name'] for b in loaded] == [want['name'][i:i + 3] for i in range(0, 8, 3)]


def _mlpg_inputs(seed, batch=3, frames=40, feat_dim=4):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(batch, frames, 3 * feat_dim)).astype(np.float32)
    variances = rng.uniform(0.2, 2.0, size=(3 * feat_dim,)).astype(np.float32)
    seq_len = np.array([frames, frames - 13, 1][:batch])
    return means, variances, seq_len


@pytest.mark.parametrize('ragged', [True, False], ids=['ragged', 'no_seq_len'])
@pytest.mark.parametrize('padding_size', [0, 5, 100])
def test_mlpg_matches_jax_and_float64(padding_size, ragged):
    """Ragged seq_len (full, cut, one frame), or none. Against the JAX f32
    banded Cholesky: 5e-6 relative to the largest |value| (both sides f32,
    the same steps). Against the float64 solve: 2e-5, JAX's own order of
    error (measured about 1e-6 at these shapes)."""
    means, variances, seq_len = _mlpg_inputs(3)
    if not ragged:
        seq_len = None
    got = tmlpg(torch.from_numpy(means), torch.from_numpy(variances), padding_size=padding_size,
                seq_len=None if seq_len is None else torch.from_numpy(seq_len)).numpy()
    want = np.asarray(jmlpg(jnp.asarray(means), jnp.asarray(variances), padding_size=padding_size,
                            seq_len=None if seq_len is None else jnp.asarray(seq_len)))
    exact = mlpg_numpy(means, variances, padding_size=padding_size, seq_len=seq_len)
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=5e-6)
    np.testing.assert_allclose(got / scale, exact / scale, atol=2e-5)
    if ragged:
        assert (got[1, seq_len[1]:] == 0).all() and (got[2, 1:] == 0).all()


def test_mlpg_streams_matches_jax():
    """Three streams fused into one solve, per-stream global variances,
    padding 100 as the acoustic model uses; 5e-6 relative."""
    rng = np.random.default_rng(4)
    seq_len = np.array([48, 30])
    streams = {name: (rng.normal(size=(2, 48, 3 * d)).astype(np.float32),
                      rng.uniform(0.2, 2.0, size=(3 * d,)).astype(np.float32))
               for name, d in (('lf0', 1), ('mcep', 6), ('bap', 2))}
    got = MLPG_streams({k: (torch.from_numpy(m), torch.from_numpy(v))
                        for k, (m, v) in streams.items()},
                       padding_size=100, seq_len=torch.from_numpy(seq_len))
    want = jMLPG_streams({k: (jnp.asarray(m), jnp.asarray(v)) for k, (m, v) in streams.items()},
                         padding_size=100, seq_len=jnp.asarray(seq_len))
    assert list(got) == list(want)
    for name in want:
        w = np.asarray(want[name])
        scale = np.abs(w).max()
        assert got[name].shape == w.shape
        np.testing.assert_allclose(got[name].numpy() / scale, w / scale, atol=5e-6)


def test_device_none_means_cuda_and_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(DeviceError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(DeviceError):
        resolve_device('cuda:0')
    assert resolve_device('cpu') == torch.device('cpu')


def _port_files():
    files = glob.glob(os.path.join(REPO, 'morgana_tpu_torch', '**', '*.py'), recursive=True)
    return sorted(files) + [os.path.join(REPO, 'chip_smoke.py')]


def test_port_imports_neither_jax_nor_the_jax_package():
    """AST scan: no module of the port, and not chip_smoke.py, imports jax or
    anything of morgana_tpu (the port keeps its own copies)."""
    files = _port_files()
    assert len(files) > 10
    offenders = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                continue
            for name in names:
                root = name.split('.')[0]
                if root in ('jax', 'jaxlib', 'morgana_tpu'):
                    offenders.append(f'{os.path.relpath(path, REPO)}: {name}')
    assert not offenders, offenders
