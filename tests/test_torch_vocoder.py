"""The port's vocoder against the JAX package's on the CPU.

Host path (``vocoder/world.py``, ``vocoder/analysis.py``): the same float64
NumPy on the same inputs, so every function is bit-identical, and so is the
port's native library (its own byte-identical copy of ``world_synth.cpp``,
built by g++ with the JAX package's flags) against the JAX package's.

Batched path (``vocoder/torch_world.py`` against ``vocoder/jax_world.py``),
B = 3, T = 96 (never B = 1 with T = 40: ``test_jax_vocoder.py`` counts the
compiled programs of that signature), 16 kHz, hop 80, 60 mcep, 5 bands, the
host path's seeded noise given to both. Both sum in float32, in other
orders (XLA's and PyTorch's FFTs, cumsums and the overlap-add), so:
- unvoiced audio, and voiced audio whose pulse positions agree (f0 200 and
  100 Hz, whose phase steps are exact in float32): relative L2 error within
  ``BATCH_RTOL`` = 1e-5 of JAX (measured 1.1e-6 to 1.2e-6);
- voiced audio in any case: the ratios of energy and of peak within
  ``RATIO_TOL`` = 1e-4 of 1 (a pulse may move by one sample where a phase
  crossing lands in an ulp gap; ``test_jax_vocoder.py:56-93`` holds JAX to
  the host path so);
- against the float64 host path: relative L2 error below ``HOST_RTOL`` =
  1e-3 (``test_jax_vocoder.py:42-54``; measured 6.4e-7).
"""
import filecmp
import os

import numpy as np
import pytest
import torch

from morgana_tpu.vocoder import analysis as janalysis
from morgana_tpu.vocoder import jax_world
from morgana_tpu.vocoder import world as jworld

from morgana_tpu_torch import _build
from morgana_tpu_torch.device import DeviceError
from morgana_tpu_torch.vocoder import analysis as tanalysis
from morgana_tpu_torch.vocoder import torch_world
from morgana_tpu_torch.vocoder import world as tworld

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 16000
HOP = 80
B = 3
T = 96
LENS = (96, 72, 50)
BATCH_RTOL = 1e-5
RATIO_TOL = 1e-4
HOST_RTOL = 1e-3


def _vowel(num_frames, f0_hz=140.0, vibrato=8.0, seed=0, bap_level=-8.0):
    """Model-space features (f0, vuv, mcep, bap) of a two-formant vowel."""
    rng = np.random.default_rng(seed)
    t = np.arange(num_frames)
    f0 = f0_hz + vibrato * np.sin(2 * np.pi * t / 40.0)
    bins = np.linspace(0, FS / 2, 513)
    env = (0.6 * np.exp(-0.5 * ((bins - 700) / 180.0) ** 2)
           + 0.4 * np.exp(-0.5 * ((bins - 1800) / 260.0) ** 2) + 1e-3)
    sp = np.tile((env ** 2)[None, :], (num_frames, 1))
    sp *= 1.0 + 0.05 * rng.standard_normal((num_frames, 1))
    mcep = jworld.spectrum_to_mcep(sp, order=59, fs=FS)
    bap = bap_level + 0.3 * rng.standard_normal((num_frames, 5))
    return f0, np.ones(num_frames), mcep, bap


def _spectra(seed=0, num_frames=T):
    """(f0 with an unvoiced stretch, sp, ap) in WORLD conventions."""
    f0, _, mcep, bap = _vowel(num_frames, seed=seed, bap_level=-3.0)
    f0[40:55] = 0.0
    return f0, jworld.mcep_to_spectrum(mcep, fs=FS), jworld.bap_to_aperiodicity(bap, fs=FS)


def _streamed(module):
    f0, sp, ap = _spectra(4)
    stream = module.StreamingSynthesizer(FS, seed=4)
    chunks = [stream.push(f0[i:i + 13], sp[i:i + 13], ap[i:i + 13]) for i in range(0, T, 13)]
    return np.concatenate(chunks + [stream.flush()])


HOST_CASES = {
    'mcep_to_spectrum': lambda m: m.mcep_to_spectrum(_vowel(T, seed=1)[2], fs=FS),
    'spectrum_to_mcep': lambda m: m.spectrum_to_mcep(_spectra(2)[1], order=59, fs=FS),
    'bap_to_aperiodicity': lambda m: m.bap_to_aperiodicity(_vowel(T, seed=3)[3], fs=FS),
    'smooth_f0': lambda m: m.smooth_f0(_spectra(5)[0]),
    '_synthesize_numpy': lambda m: m._synthesize_numpy(*_spectra(6), FS, HOP, seed=6),
    'synthesize_world_feats': lambda m: m.synthesize_world_feats(*_vowel(T, seed=7), FS),
    'StreamingSynthesizer': _streamed,
}


@pytest.mark.parametrize('name', list(HOST_CASES))
def test_host_path_is_bit_identical_to_jax(name):
    """The same float64 NumPy: identical arrays."""
    np.testing.assert_array_equal(HOST_CASES[name](tworld), HOST_CASES[name](jworld))


def test_native_library_builds_and_loads():
    """g++ is installed here: the port's copy builds into
    morgana_tpu_torch/build/ and loads, so the native path does not give way
    to NumPy unseen."""
    assert tworld.native_available()
    path = _build.build_cxx('world_synth', tworld.SOURCE)
    assert os.path.dirname(path) == _build.BUILD_DIR and os.path.exists(path)


def test_native_source_is_a_byte_identical_copy():
    assert filecmp.cmp(tworld.SOURCE, os.path.join(REPO, 'morgana_tpu', 'vocoder', 'csrc',
                                                   'world_synth.cpp'), shallow=False)


@pytest.mark.parametrize('seed', [0, 1])
def test_native_synthesis_is_bit_identical_to_jax(seed):
    assert tworld.native_available() and jworld.native_available()
    f0, sp, ap = _spectra(seed)
    got = tworld.synthesize(f0, sp, ap, FS, seed=seed)
    np.testing.assert_array_equal(got, jworld.synthesize(f0, sp, ap, FS, seed=seed))
    assert got.shape == (T * HOP,) and np.isfinite(got).all()


def test_synthesize_checks_its_arguments_before_the_native_call():
    f0, sp, ap = _spectra(0)
    with pytest.raises(ValueError, match='f0 frames'):
        tworld.synthesize(f0[:-1], sp, ap, FS)
    with pytest.raises(ValueError, match='non-positive hop'):
        tworld.synthesize(f0, sp, ap, FS, frame_period=0.01)


def _vowel_wav():
    return jworld._synthesize_numpy(*_spectra(8), FS, HOP, seed=8)


ANALYSIS_CASES = {
    'estimate_f0': lambda m, wav: m.estimate_f0(wav, FS),
    'spectral_envelope': lambda m, wav: m.spectral_envelope(wav, FS),
    'band_aperiodicity': lambda m, wav: m.band_aperiodicity(wav, m.estimate_f0(wav, FS)[0], FS),
    'analyze': lambda m, wav: m.analyze(wav, FS),
    'features_from_wav': lambda m, wav: m.features_from_wav(wav, FS),
}


@pytest.mark.parametrize('name', list(ANALYSIS_CASES))
def test_analysis_is_bit_identical_to_jax(name):
    wav = _vowel_wav()
    got, want = ANALYSIS_CASES[name](tanalysis, wav), ANALYSIS_CASES[name](janalysis, wav)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        got, want = [got[k] for k in sorted(got)], [want[k] for k in sorted(want)]
    for g, w in zip(got if isinstance(got, (tuple, list)) else [got],
                    want if isinstance(want, (tuple, list)) else [want]):
        np.testing.assert_array_equal(g, w)


# 'vibrato': voiced rows whose f0 moves, so a pulse may move by a sample;
# 'steady': voiced at 200 and 100 Hz, where a frame's phase step (f0 * hop /
# fs = 1 or 0.5) is exact in float32 and the pulses agree; 'unvoiced': vuv 0
# and fully aperiodic bands. The last row has an unvoiced stretch.
MODES = ('vibrato', 'steady', 'unvoiced')


def _batch(mode):
    """B = 3 utterances of LENS frames zero-padded to T, and the host
    path's seeded noise of each row (default_rng(10 + row))."""
    f0 = np.zeros((B, T))
    vuv = np.zeros((B, T))
    mcep = np.zeros((B, T, 60))
    bap = np.zeros((B, T, 5))
    noise = np.zeros((B, T * HOP))
    for i, n in enumerate(LENS):
        if mode == 'steady':
            f, v, m, b = _vowel(n, f0_hz=(200.0, 100.0, 200.0)[i], vibrato=0.0, seed=i)
        else:
            f, v, m, b = _vowel(n, f0_hz=130.0 + 30 * i, seed=i)
        if i == 2:
            v[20:35] = 0.0
        f0[i, :n], vuv[i, :n], mcep[i, :n], bap[i, :n] = f, v, m, b
        noise[i, :n * HOP] = np.random.default_rng(10 + i).standard_normal(n * HOP)
    if mode == 'unvoiced':
        vuv[:] = 0.0
        bap[:] = -1e-3
    return (f0, vuv, mcep, bap, np.array(LENS)), noise


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check_voiced(got, want):
    """Energy and peak within RATIO_TOL; the waveforms correlate."""
    energy = np.sqrt((got ** 2).mean()) / np.sqrt((want ** 2).mean())
    peak = np.abs(got).max() / np.abs(want).max()
    assert abs(energy - 1.0) < RATIO_TOL and abs(peak - 1.0) < RATIO_TOL, (energy, peak)
    assert np.corrcoef(got, want)[0, 1] > 0.99


@pytest.mark.parametrize('mode', MODES)
def test_batch_matches_jax_with_shared_noise(mode):
    args, noise = _batch(mode)
    want, want_lens = jax_world.synthesize_batch(*args, FS, noise=noise)
    got, got_lens = torch_world.synthesize_batch(*args, FS, noise=noise, device='cpu')
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (B, T * HOP) and got.dtype == np.float32
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.array(LENS) * HOP)
    for i, n in enumerate(LENS):
        if mode == 'vibrato':
            _check_voiced(got[i], want[i])
        else:
            assert _rel(got[i], want[i]) < BATCH_RTOL, (i, _rel(got[i], want[i]))
        # Padding frames are silenced: past the last valid frame's fft_size
        # samples nothing is written.
        assert not got[i, n * HOP + 1024:].any() and not want[i, n * HOP + 1024:].any()


@pytest.mark.parametrize('mode', ['vibrato', 'unvoiced'])
def test_batch_rows_match_the_float64_host_path(mode):
    """Each row against world._synthesize_numpy on its own frames, which
    draws the same noise: unvoiced within HOST_RTOL, voiced in energy and
    peak."""
    args, noise = _batch(mode)
    f0, vuv, mcep, bap, lens = args
    got, _ = torch_world.synthesize_batch(*args, FS, noise=noise, device='cpu')
    for i, n in enumerate(lens):
        sp = jworld.mcep_to_spectrum(mcep[i, :n], fs=FS)
        ap = jworld.bap_to_aperiodicity(bap[i, :n], fs=FS)
        want = jworld._synthesize_numpy(np.where(vuv[i, :n] > 0.5, f0[i, :n], 0.0), sp, ap, FS,
                                        HOP, seed=10 + i)
        row = got[i, :n * HOP].double().numpy()
        if mode == 'unvoiced':
            assert _rel(row, want) < HOST_RTOL, _rel(row, want)
        else:
            _check_voiced(row, want)


@pytest.mark.parametrize('mode', ['vibrato', 'steady'])
def test_single_utterance_entries_match_jax(mode):
    """synthesize_world_feats_torch and synthesize_torch against their JAX
    counterparts."""
    f0, vuv, mcep, bap = _vowel(T, seed=11, **({'f0_hz': 200.0, 'vibrato': 0.0}
                                               if mode == 'steady' else {}))
    noise = np.random.default_rng(11).standard_normal(T * HOP)
    sp, ap = jworld.mcep_to_spectrum(mcep, fs=FS), jworld.bap_to_aperiodicity(bap, fs=FS)
    pairs = [(torch_world.synthesize_world_feats_torch(f0, vuv, mcep, bap, FS, noise=noise,
                                                       device='cpu'),
              jax_world.synthesize_world_feats_jax(f0, vuv, mcep, bap, FS, noise=noise)),
             (torch_world.synthesize_torch(f0, sp, ap, FS, noise=noise, device='cpu'),
              jax_world.synthesize_jax(f0, sp, ap, FS, noise=noise))]
    for got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape == (T * HOP,)
        if mode == 'steady':
            assert _rel(got, want) < BATCH_RTOL
        else:
            _check_voiced(got, want)


def test_batch_noise_from_a_generator_is_seeded():
    args, _ = _batch('vibrato')
    runs = [torch_world.synthesize_batch(*args, FS, device='cpu',
                                         generator=torch.Generator().manual_seed(s))[0]
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    default = torch_world.synthesize_batch(*args, FS, device='cpu')[0]
    assert torch.isfinite(default).all() and float(default.abs().max()) <= 0.9 + 1e-6


def test_f0_tracks_through_the_batched_synthesis():
    """Analysis round trip (``test_jax_vocoder.py:97-106``): a 150 Hz vowel
    synthesised by the batched path is tracked within 3 Hz RMS."""
    f0, vuv, mcep, bap = _vowel(140, f0_hz=150.0, vibrato=0.0)
    wav = torch_world.synthesize_batch(f0[None], vuv[None], mcep[None], bap[None],
                                       np.array([140]), FS, device='cpu')[0][0]
    feats = tanalysis.features_from_wav(wav.double().numpy(), FS)
    voiced = feats['vuv'][:, 0] > 0.5
    assert voiced.mean() > 0.6
    assert np.sqrt(np.mean((np.exp(feats['lf0'][voiced, 0]) - 150.0) ** 2)) < 3.0


def test_batch_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args, noise = _batch('vibrato')
    with pytest.raises(DeviceError, match="device='cpu'"):
        torch_world.synthesize_batch(*args, FS, noise=noise)
