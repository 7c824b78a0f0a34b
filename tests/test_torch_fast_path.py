"""The builder's device-side fast path against the JAX package on the CPU:
the batched deltas, the remaining data sources and the native batch reader,
the device-resident corpus cache, the device-side normalisation (float32 and
bf16 wires), the prefetching loader, the chained train and eval steps
(``--steps_per_dispatch``, a plain loop on the CPU) with and without
gradient accumulation, rematerialisation, ``Handler.apply_staged`` and the
automatic defaults of a GPU. Shapes are small (F0Model's 3 x GRU(64) on the
``voice_data`` corpus, B4).

Tolerances: the cache's batches, the raw and delta keys and the sources are
bit for bit; normalised keys within 2 float32 ulps of the host path and of
JAX (the JAX module's own claim, ``device_normalise.py:17-20``); the chains
bit for bit against the port's per-batch loop and within the train-parity
tolerance of ``tests/test_torch_train.py`` (1e-3 relative) of JAX's chains.
"""
import json
import os
import sys
import types
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu import nn as jnn
from morgana_tpu.data import dataset as jdataset
from morgana_tpu.data import native_io as jnative
from morgana_tpu.data import sources as jsources
from morgana_tpu.data.device_cache import DeviceCorpusCache as JCache
from morgana_tpu.data.device_normalise import make_device_transform as jmake_transform
from morgana_tpu.experiment_builder import ExperimentBuilder as JBuilder
from morgana_tpu.ops.deltas import compute_deltas_jax
from morgana_tpu.training import TrainLoop as JLoop
from morgana_tpu.training import build_optimizer as jbuild_optimizer

from morgana_tpu_torch import data as tdata
from morgana_tpu_torch import metrics as tmetrics
from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch.data import native_io as tnative
from morgana_tpu_torch.data import sources as tsources
from morgana_tpu_torch.data.device_cache import CacheOverBudget
from morgana_tpu_torch.data.device_cache import DeviceCorpusCache as TCache
from morgana_tpu_torch.data.device_normalise import make_device_transform as tmake_transform
from morgana_tpu_torch.experiment_builder import ExperimentBuilder as TBuilder
from morgana_tpu_torch.models import f0_test_model as tf0
from morgana_tpu_torch.ops.deltas import compute_deltas, compute_deltas_torch
from morgana_tpu_torch.training import TrainLoop as TLoop
from morgana_tpu_torch.training import build_optimizer as tbuild_optimizer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'models'))
try:
    from f0_test_model import F0Model as JF0
finally:
    sys.path.pop(0)

ULPS = 2
TRAIN_RTOL = 1e-3
# SGD's update is linear in the gradient: parameters as the accumulation
# tests hold them (tests/test_torch_builder_accum.py).
PARAM_ATOL = 2e-6
LR = 0.01
B = 4


def _ulps(got, want):
    def ordered(a):
        bits = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
        return np.where(bits < 0, -(bits & 0x7FFFFFFF), bits)
    return int(np.abs(ordered(got) - ordered(want)).max()) if np.size(got) else 0


def _np(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().numpy() if value.dtype == torch.bfloat16 \
            else value.detach().numpy()
    return np.asarray(value, np.float32) if str(getattr(value, 'dtype', '')) == 'bfloat16' \
        else np.asarray(value)


def _models(root):
    """The JAX and port F0Model on the same seeded weights, with the corpus'
    normalisers, in train mode."""
    jnn.manual_seed(21)
    jm, tm = JF0(), tf0.F0Model()
    tnn.load_jax_params(tm, jnn.state_dict(jm))
    for model in (jm, tm):
        model.normalisers = model.normaliser_sources()
        for normaliser in model.normalisers.values():
            normaliser.load_params('train', root)
        model.mode = 'train'
    return jm, tm


def _datasets(root, jm, tm, device_normalise=False, split='train'):
    args = (split, f'{split}/{split}_file_id_list.scp')
    return (jdataset.FilesDataset(jm.train_data_sources(), *args, jm.normalisers, root,
                                  device_normalise=device_normalise),
            tdata.FilesDataset(tm.train_data_sources(), *args, tm.normalisers, root,
                               device_normalise=device_normalise))


# ----------------------------------------------------------- deltas, sources

def test_batched_deltas_match_jax_and_the_host_path():
    """compute_deltas_torch with ragged seq_len: each item's frames bit for
    bit the host path's deltas of the item, and JAX's batched version's."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 11, 4)).astype(np.float32)
    seq_len = np.array([11, 6, 1])
    got = compute_deltas_torch(torch.from_numpy(x), seq_len=torch.from_numpy(seq_len)).numpy()
    want = np.asarray(compute_deltas_jax(jnp.asarray(x), seq_len=jnp.asarray(seq_len)))
    for b, n in enumerate(seq_len):
        np.testing.assert_array_equal(got[b, :n], compute_deltas(x[b, :n]))
        np.testing.assert_array_equal(got[b, :n], want[b, :n])
    unpadded = compute_deltas_torch(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(unpadded, np.asarray(compute_deltas_jax(jnp.asarray(x))))


def _write_wav(path, samples, rate):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(path, 'wb') as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(samples.astype('<i2').tobytes())


@pytest.mark.parametrize('kind', ['ascii', 'wav', 'synthetic', 'synthetic_sentence'])
def test_sources_match_jax(kind, tmp_path):
    """ASCIISource (character ids), WavSource (1/32768, -32768 at exactly
    -1; another rate an error) and SyntheticSource (CRC32 seeds: the same
    features in every process): the port's item as JAX's, bit for bit."""
    root = str(tmp_path)
    if kind == 'ascii':
        os.makedirs(os.path.join(root, 'text'))
        with open(os.path.join(root, 'text', 'u0.txt'), 'w') as f:
            f.write('Hello, world.\n')
        pair = jsources.ASCIISource('text'), tsources.ASCIISource('text')
    elif kind == 'wav':
        samples = np.array([-32768, -1, 0, 1, 32767, 1234], np.int16)
        _write_wav(os.path.join(root, 'wav', 'u0.wav'), samples, 16000)
        pair = jsources.WavSource('wav', sample_rate=16000), tsources.WavSource('wav',
                                                                                sample_rate=16000)
        with pytest.raises(ValueError, match='sample rate'):
            tsources.WavSource('wav', sample_rate=22050)('u0', root)
    else:
        sentence = kind == 'synthetic_sentence'
        pair = (jsources.SyntheticSource('lf0', 3, use_deltas=not sentence,
                                         sentence_level=sentence, kind='positive'),
                tsources.SyntheticSource('lf0', 3, use_deltas=not sentence,
                                         sentence_level=sentence, kind='positive'))
    want, got = (source('u0', root) for source in pair)
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if kind == 'wav':
        assert got['wav'].min() == -1.0


def test_native_reader_matches_jax(tmp_path):
    """load_npy_batch (the native reader; a float64 file takes np.load) and
    pad_collate as JAX's, and the library built by build_cxx."""
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=(n, 3)).astype(np.float32) for n in (5, 1, 9)]
    paths = []
    for i, a in enumerate(arrays):
        paths.append(str(tmp_path / f'a{i}.npy'))
        np.save(paths[-1], a)
    assert tnative.native_available()
    for max_len in (None, 7):
        got, want = tnative.load_npy_batch(paths, max_len), jnative.load_npy_batch(paths, max_len)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    np.save(tmp_path / 'f64.npy', arrays[0].astype(np.float64))
    got = tnative.load_npy_batch([str(tmp_path / 'f64.npy'), paths[1]])
    np.testing.assert_array_equal(got[0], jnative.load_npy_batch(
        [str(tmp_path / 'f64.npy'), paths[1]])[0])
    np.testing.assert_array_equal(tnative.pad_collate(arrays, 12),
                                  jnative.pad_collate(arrays, 12))


# ----------------------------------------------------------- the cache

def test_device_cache_assembles_as_jax(voice_data):
    """DeviceCorpusCache (CPU device): for ragged index sets, every key of
    the assembled batch as JAX's cache assembles it and as the port's
    collate gives it, bit for bit; padded lengths, signatures and bytes as
    JAX's; a budget under the corpus raises CacheOverBudget in both."""
    root = voice_data['data_root']
    jm, tm = _models(root)
    jds, tds = _datasets(root, jm, tm)
    jcache, tcache = JCache(jds), TCache(tds, device='cpu')
    assert tcache.bytes == jcache.bytes and tcache.num_items == jcache.num_items
    np.testing.assert_array_equal(tcache.item_lengths, jcache.item_lengths)
    for idxs in ([0, 1, 2, 3], [7, 2, 5, 0], [6, 4], [3]):
        assert tcache.padded_lengths(idxs) == jcache.padded_lengths(idxs)
        assert tcache.batch_signature(idxs) == jcache.batch_signature(idxs)
        got, want = tcache.assemble(idxs), jcache.assemble(idxs)
        collated = tdata.collate([tds[i] for i in idxs])
        assert sorted(got) == sorted(want) == sorted(collated)
        for key in want:
            if isinstance(want[key], list):
                assert got[key] == want[key] == collated[key], key
                continue
            assert _np(got[key]).dtype == np.asarray(want[key]).dtype, key
            np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]), err_msg=key)
            np.testing.assert_array_equal(_np(got[key]), collated[key], err_msg=key)
    with pytest.raises(CacheOverBudget):
        TCache(tds, max_bytes=100, device='cpu')
    with pytest.raises(NotImplementedError, match='item 10'):
        tcache.harmonise_lengths([])


@pytest.mark.parametrize('wire', ['float32', 'bfloat16'])
def test_device_transform_matches_jax_and_the_host_path(voice_data, wire):
    """The device transform after the cache's gather: with a float32 wire
    the raw and delta keys bit for bit the host path's collated batch, the
    normalised keys within 2 ulps of it and of JAX's transform; with a bf16
    wire the same shifted residuals, float32 keys and outputs as JAX's."""
    root = voice_data['data_root']
    jm, tm = _models(root)
    jds, tds = _datasets(root, jm, tm, device_normalise=True)
    _, host_ds = _datasets(root, jm, tm)
    assert tds.device_names == jds.device_names and tds.device_names
    wire_dtype = None if wire == 'float32' else torch.bfloat16
    ttransform, tnames = tmake_transform(tds.data_sources, tds.normalisers,
                                         names=tds.device_names, wire_dtype=wire_dtype)
    jtransform, jnames = jmake_transform(jds.data_sources, jds.normalisers,
                                         names=jds.device_names,
                                         wire_dtype=None if wire == 'float32' else wire)
    assert tnames == jnames
    assert ttransform.keep_f32 == jtransform.keep_f32
    idxs = [5, 0, 3, 6]
    raw = tdata.collate([tds[i] for i in idxs])
    host = tdata.collate([host_ds[i] for i in idxs])
    if wire == 'float32':
        got = ttransform(tTensors(raw))
        want = jtransform({k: jnp.asarray(v) for k, v in raw.items()
                           if isinstance(v, np.ndarray)})
        for key, value in host.items():
            if not isinstance(value, np.ndarray):
                continue
            if key.startswith('normalised_'):
                assert _ulps(_np(got[key]), value) <= ULPS, key
                assert _ulps(_np(got[key]), np.asarray(want[key])) <= ULPS, key
            else:
                np.testing.assert_array_equal(_np(got[key]), value, err_msg=key)
        return
    tput = ttransform.pre_put(raw)
    jput = jtransform.pre_put(raw)
    assert sorted(tput) == sorted(jput)
    for key in jput:
        if isinstance(jput[key], np.ndarray):
            np.testing.assert_array_equal(tput[key], jput[key], err_msg=key)
    loader = tdata.ToDeviceWrapper(None, transfer_dtype='bfloat16', device_transform=ttransform)
    staged, _ = loader.stage(raw)
    jwire = {}
    for key, value in jput.items():
        if isinstance(value, np.ndarray) and value.dtype.kind in 'fiub':
            if value.dtype == np.float32 and value.ndim >= 3 and key not in jtransform.keep_f32:
                value = value.astype(jnp.bfloat16)
            jwire[key] = jnp.asarray(value)
    want = jtransform(jwire)
    for key, value in want.items():
        assert str(staged[key].dtype).replace('torch.', '') == str(value.dtype), key
        np.testing.assert_array_equal(_np(staged[key]), _np(value), err_msg=key)


def tTensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}


# ----------------------------------------------------------- the loader

@pytest.mark.parametrize('threads', [0, 2])
def test_to_device_wrapper_keeps_order_contents_and_wire(voice_data, threads):
    """The prefetching loader yields the DataLoader's batches in order (the
    JAX loader's shuffled order), its float32 sequence features on the
    bf16 wire and its per-utterance ones float32, ``host`` the collated
    batch; with threads the native reader builds whole batches ahead; an
    iteration left early stops its producer."""
    root = voice_data['data_root']
    jm, tm = _models(root)
    jds, tds = _datasets(root, jm, tm)
    assert tds.supports_native_preload
    loader = tdata.batch(tds, batch_size=3, shuffle=True, num_data_threads=threads, seed=4,
                         transfer_dtype='bfloat16')
    want = list(tdata.DataLoader(tds, batch_size=3, shuffle=True, seed=4))
    jorder = [b['name'] for b in jdataset_loader(jds)]
    got = list(loader)
    assert [b['name'] for b in got] == [b['name'] for b in want] == jorder
    for batch, host in zip(got, want):
        assert batch.host is not None and batch.host['name'] == host['name']
        for key, value in host.items():
            if not isinstance(value, np.ndarray):
                assert batch[key] == value
                continue
            wire = torch.bfloat16 if value.dtype == np.float32 and value.ndim >= 3 \
                else torch.from_numpy(value).dtype
            assert batch[key].dtype == wire, key
            np.testing.assert_array_equal(batch[key].numpy() if wire != torch.bfloat16 else
                                          batch[key].float().numpy(),
                                          torch.from_numpy(value).to(wire).float().numpy()
                                          if wire == torch.bfloat16 else value, err_msg=key)
    it = iter(loader)
    next(it)
    it.close()


def jdataset_loader(jds):
    from morgana_tpu.data.loader import DataLoader as JLoader
    return list(JLoader(jds, batch_size=3, shuffle=True, seed=4))


# ----------------------------------------------------------- metrics

def test_apply_staged_steps_merge_as_separate_accumulations():
    """Partials stacked over 3 steps merge row by row: the accumulators hold
    the same floats as 3 separate accumulations; a list per step takes each
    step's own row."""
    values = torch.tensor([0.1, 0.7, 1e-8])
    a, b = tmetrics.Handler(loss=tmetrics.Mean()), tmetrics.Handler(loss=tmetrics.Mean())
    for v in values:
        a.accumulate('train', loss=v)
    staged = [('train', 'loss', {'sum': values, 'count': torch.ones(3)})]
    b.apply_staged(staged, steps=3)
    assert a['train']['loss'].sum == b['train']['loss'].sum
    assert a['train']['loss'].count == b['train']['loss'].count == 3
    c = tmetrics.Handler(loss=tmetrics.Mean())
    c.apply_staged([staged, staged, staged], steps=3)
    assert c['train']['loss'].sum == a['train']['loss'].sum


# ----------------------------------------------------------- chains

def _chain_case(root, accum, force):
    jm, tm = _models(root)
    jds, tds = _datasets(root, jm, tm)
    jcache, tcache = JCache(jds), TCache(tds, device='cpu')
    order = np.array([[5, 0, 3, 6], [1, 7, 2, 4], [2, 3, 0, 1]])
    # One shape signature a chain: the rows' padded lengths.
    lengths = tcache.padded_lengths(order.reshape(-1))
    lrs = [0.01, 0.005, 0.02]
    return jm, tm, tds, jcache, tcache, order, lengths, lrs


@pytest.mark.parametrize('accum,force', [(1, False), (2, False), (2, True)],
                         ids=['plain', 'accum', 'accum_force_apply_last'])
def test_train_chain_matches_jax_and_the_per_batch_loop(voice_data, accum, force):
    """train_chain (3 SGD steps of B4 with momentum, per-step learning rates,
    the cycle closed by force_apply_last or left open) against JAX's
    train_chain: losses within 1e-3 relative, parameters within 2e-6; against the port's per-batch
    train_step loop on the same cached batches: losses, parameters, the
    metric partials and the cycle's state bit for bit; then eval_chain
    likewise."""
    root = voice_data['data_root']
    jm, tm, tds, jcache, tcache, order, lengths, lrs = _chain_case(root, accum, force)
    jloop = JLoop(jm, jbuild_optimizer('sgd', momentum=0.9), grad_accum_steps=accum)
    jlosses, jstaged = jloop.train_chain(jcache, order, lrs, force_apply_last=force,
                                         lengths=lengths)
    tloop = TLoop(tm, tbuild_optimizer('sgd', momentum=0.9), grad_accum_steps=accum)
    tlosses, staged = tloop.train_chain(tcache, order, lrs, force_apply_last=force,
                                        lengths=lengths)
    assert staged is None
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), rtol=TRAIN_RTOL)
    for name, param in tm.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jloop.params[name]),
                                   atol=PARAM_ATOL, err_msg=name)
    assert tloop.last_step_applied == jloop.last_step_applied
    assert (tloop._micro_count, tloop.step_count) == (jloop._micro_count, jloop.step_count)

    _, tm2 = _models(root)
    loop2 = TLoop(tm2, tbuild_optimizer('sgd', momentum=0.9), grad_accum_steps=accum)
    losses2 = [loop2.train_step(tcache.assemble(idxs, lengths=lengths), lr,
                                force_apply=force and k == len(order) - 1)[0]
               for k, (idxs, lr) in enumerate(zip(order, lrs))]
    np.testing.assert_array_equal(torch.stack(losses2).numpy(), tlosses.numpy())
    for (name, a), b in zip(tm.named_parameters(), tm2.parameters()):
        assert torch.equal(a, b), name
    assert tm.metrics.results_as_json_dict('train') == tm2.metrics.results_as_json_dict('train')

    elosses, _ = tloop.eval_chain(tcache, order, lengths=lengths)
    want = [loop2.eval_step(tcache.assemble(idxs, lengths=lengths))[0] for idxs in order]
    np.testing.assert_array_equal(elosses.numpy(), torch.stack(want).numpy())
    jeval, _ = jloop.eval_chain(jcache, order, lengths=lengths)
    np.testing.assert_allclose(elosses.numpy(), np.asarray(jeval), rtol=TRAIN_RTOL)


# ----------------------------------------------------------- remat

@pytest.mark.parametrize('layer', ['lstm', 'gru', 'transformer'])
def test_remat_gradients_equal_no_remat_and_jax(layer):
    """A checkpointed layer stack (every recurrent layer, every Transformer
    block) with dropout on gives the same gradients as without remat, bit
    for bit (the step generator's state restored for the recomputation);
    with dropout off, JAX's remat gradients within 1e-4 relative."""
    from morgana_tpu import nn as jnn_mod
    import jax

    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 9, 8)).astype(np.float32)
    seq_len = np.array([9, 5, 2])
    grads = {}
    for dropout in (0.3, 0.0):
        jnn.manual_seed(11)
        if layer == 'transformer':
            jmod = jnn_mod.TransformerEncoder(2, 8, 2, 16, dropout=dropout, remat=True)
            tmod = tnn.TransformerEncoder(2, 8, 2, 16, dropout=dropout)
        else:
            jmod = jnn_mod.Recurrent(layer, 8, 12, num_layers=2, dropout=dropout, remat=True)
            tmod = tnn.Recurrent(layer, 8, 12, num_layers=2, dropout=dropout)
        tnn.load_jax_params(tmod, jnn.state_dict(jmod))
        tmod.train()
        for remat in (False, True):
            tmod.remat = remat
            gen = torch.Generator().manual_seed(3)
            for m in tmod.modules():
                if hasattr(m, 'generator'):
                    m.generator = gen
            xt = torch.from_numpy(x).requires_grad_()
            y = tmod(xt, seq_len=torch.from_numpy(seq_len))
            y = y[0] if isinstance(y, tuple) else y
            grads[dropout, remat] = torch.autograd.grad(y.square().sum(),
                                                        [xt] + list(tmod.parameters()))
        for a, b in zip(grads[dropout, False], grads[dropout, True]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    params = jnn.parameters(jmod)

    def loss(p, x):
        with jnn.bind(jmod, p, rng=jax.random.PRNGKey(0), train=False):
            y = jmod(x, seq_len=jnp.asarray(seq_len))
        y = y[0] if isinstance(y, tuple) else y
        return jnp.sum(jnp.square(y))

    jgx = jax.grad(loss, argnums=1)(params, jnp.asarray(x))
    np.testing.assert_allclose(grads[0.0, True][0].numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)


# ----------------------------------------------------------- the defaults

class _Logger(object):
    def __init__(self):
        self.lines = []

    def info(self, fmt, *args):
        self.lines.append(fmt % args)


@pytest.mark.parametrize('case', [
    ('cpu', None, None, None, 0.3), ('cuda', None, None, None, 0.3),
    ('cuda', None, None, None, 7.0), ('cuda', None, None, 4, 0.3),
    ('cuda', False, False, None, 7.0), ('cpu', None, None, 3, 0.3)],
    ids=['cpu', 'gpu_local', 'gpu_remote', 'explicit_chain', 'opted_out', 'cpu_chain'])
def test_fast_path_defaults_resolve_as_jax(case, monkeypatch):
    """The automatic defaults with the round-trip probe injected: on the
    CPU (a JAX 'cpu' backend) all off; on a CUDA device (an accelerator
    backend) the cache and device normalisation on, and 16 steps a dispatch
    when the probe reads 5 ms or more; an explicit chain implies the cache;
    turned off stays off, without a probe. The same settings as JAX's
    resolver; the log line names what was turned on."""
    import jax

    device, cache, normalise, spd, rtt = case
    port = types.SimpleNamespace(device=torch.device(device), device_cache=cache,
                                 device_normalise=normalise, steps_per_dispatch=spd,
                                 dispatch_rtt_ms=None, logger=_Logger(),
                                 _dispatch_rtt_ms=lambda: rtt)
    TBuilder._resolve_fast_path_defaults(port)
    monkeypatch.setattr(jax, 'default_backend', lambda: 'cpu' if device == 'cpu' else 'tpu')
    jax_side = types.SimpleNamespace(device_cache=cache, device_normalise=normalise,
                                     steps_per_dispatch=spd, logger=_Logger(),
                                     _dispatch_rtt_ms=lambda: rtt)
    JBuilder._resolve_fast_path_defaults(jax_side, {})
    got = (port.device_cache, port.device_normalise, port.steps_per_dispatch)
    assert got == (jax_side.device_cache, jax_side.device_normalise,
                   jax_side.steps_per_dispatch)
    if device == 'cuda' and cache is None and spd is None:
        assert port.dispatch_rtt_ms == rtt
        assert any('--device_cache' in line for line in port.logger.lines)
    if cache is False:
        assert port.dispatch_rtt_ms is None


# ----------------------------------------------------------- the builder

FLAG_RUNS = {
    'base': [],
    'chain': ['--device_cache', '--steps_per_dispatch', '2', '--remat'],
    'wire': ['--device_normalise', '--transfer_dtype', 'bfloat16', '--no-device_cache'],
    'over_budget': ['--device_cache', '--device_cache_gb', '1e-9', '--no-device_normalise'],
    'normalise': ['--device_normalise', '--device_cache'],
}
#: Which run shows each option at work.
FLAG_CASES = {'--device_cache': 'chain', '--no-device_cache': 'wire',
              '--device_cache_gb': 'over_budget', '--device_normalise': 'normalise',
              '--no-device_normalise': 'over_budget', '--steps_per_dispatch': 'chain',
              '--remat': 'chain', '--transfer_dtype': 'wire'}


@pytest.fixture(scope='module')
def flag_runs(tmp_path_factory):
    """F0Model through the port's builder on the CPU, one epoch with
    validation (B4, 8 short utterances), once a FLAG_RUNS entry, from one
    init."""
    from morgana_tpu.data.synthetic import generate_voice_data
    root = str(tmp_path_factory.mktemp('fast_flags') / 'data')
    generate_voice_data(root, num_train=8, num_valid=4, num_test=0, seed=1,
                        n_phones_range=(4, 8), dur_range=(2, 4))
    base = tmp_path_factory.mktemp('fast_flag_runs')
    init = tf0.F0Model(generator=torch.Generator().manual_seed(3))
    from morgana_tpu_torch import checkpointing
    ckpt = checkpointing.save_state_dict(tnn.state_dict(init), str(base / 'init' / 'epoch_0.npz'))
    runs = {}
    try:
        for name, flags in FLAG_RUNS.items():
            args = TBuilder.get_experiment_args([
                '--experiment_name', name, '--experiments_base', str(base), '--data_root', root,
                '--train_id_list', 'train/train_file_id_list.scp',
                '--valid_id_list', 'valid/valid_file_id_list.scp', '--batch_size', '4',
                '--end_epoch', '1', '--device', 'cpu', '--checkpoint_path', ckpt, *flags])
            exp = TBuilder(tf0.F0Model, **args)
            remat = tnn.default_remat()
            exp.run_experiment()
            with open(os.path.join(exp.experiment_dir, 'valid', 'epoch_1', 'metrics.json')) as f:
                valid_loss = json.load(f)['loss']
            runs[name] = {'exp': exp, 'remat': remat, 'losses': exp.train_losses[1],
                          'valid_loss': valid_loss}
    finally:
        tnn.set_default_remat(False)
    return runs


@pytest.mark.parametrize('option', sorted(FLAG_CASES))
def test_a_fast_path_option_runs_on_the_cpu(flag_runs, option):
    """Each option in a CPU run, as the JAX builder means it: the cache (its
    batches, its chains of 2 and remat give the per-batch run's losses bit
    for bit), its budget (a corpus over it falls back to the streaming
    loader), device normalisation (losses within 1e-5 of the host path's),
    the bf16 wire (batches arrive bf16; losses within 1e-2)."""
    base, run = flag_runs['base'], flag_runs[FLAG_CASES[option]]
    exp = run['exp']
    loader = exp.train_loader
    if option == '--device_cache':
        assert loader.device_cache is not None and base['exp'].train_loader.device_cache is None
        assert run['losses'] == base['losses']
    elif option == '--no-device_cache':
        assert loader.device_cache is None and exp.device_cache is False
    elif option == '--device_cache_gb':
        assert exp.device_cache and loader.device_cache is None
        assert exp.valid_loader.device_cache is None
        assert run['losses'] == base['losses']
    elif option == '--device_normalise':
        assert loader.device_transform is not None and loader.dataset.device_names
        np.testing.assert_allclose(run['losses'], base['losses'], rtol=1e-5)
    elif option == '--no-device_normalise':
        assert loader.device_transform is None and not loader.dataset.device_names
    elif option == '--steps_per_dispatch':
        assert exp.steps_per_dispatch == 2 and run['losses'] == base['losses']
        assert run['valid_loss'] == base['valid_loss']
    elif option == '--remat':
        assert run['remat'] is True and run['losses'] == base['losses']
    else:
        batch = next(iter(loader))
        assert batch['normalised_lab'].dtype == torch.bfloat16
        assert batch['n_frames'].dtype == torch.float32
        np.testing.assert_allclose(run['losses'], base['losses'], rtol=1e-2)
