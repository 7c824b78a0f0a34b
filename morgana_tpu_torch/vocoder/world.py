"""WORLD-style synthesis and spectral conversions on the host (counterpart
of ``morgana_tpu/vocoder/world.py``, the same float64 NumPy, operation for
operation, and the same C++ library).

The synthesis model matches WORLD's structure: the spectral envelope is
split into a periodic part ``sp * (1 - ap)`` excited by a glottal pulse
train at f0, and an aperiodic part ``sp * ap`` excited by white noise; both
are filtered with the minimum-phase reconstruction of the envelope and
overlap-added.

:func:`synthesize` runs the native library first: this package's copy of
``world_synth.cpp`` (``vocoder/csrc/``, a C interface), built by g++ at first
use into ``morgana_tpu_torch/build/`` (:func:`morgana_tpu_torch._build.build_cxx`)
and loaded with ``ctypes``. Where it cannot be built or loaded, or returns an
error, the NumPy path runs; :func:`native_available` says which.
"""
import ctypes
import logging
import os

import numpy as np
from scipy.signal import savgol_filter

from morgana_tpu_torch import _build

__all__ = [
    'synthesize', 'synthesize_world_feats', 'smooth_f0',
    'mcep_to_spectrum', 'spectrum_to_mcep', 'bap_to_aperiodicity',
    'native_available', 'StreamingSynthesizer',
]

logger = logging.getLogger('morgana_tpu_torch')

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc', 'world_synth.cpp')
# world_synthesize's argument layout: 2 = the noise seed before out/out_capacity.
ABI_VERSION = 2

_LIB = None
_LIB_TRIED = False


def _load_native():
    """The native library, built and loaded once; ``None`` (the NumPy path)
    when it cannot be built or loaded or its ABI marker is not
    :data:`ABI_VERSION`, which the log says."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        lib = ctypes.CDLL(_build.build_cxx('world_synth', SOURCE))
        abi = lib.morgana_world_synth_abi
        abi.restype = ctypes.c_longlong
        abi.argtypes = []
        if abi() != ABI_VERSION:
            raise RuntimeError(f'ABI {abi()} != {ABI_VERSION}')
        lib.world_synthesize.restype = ctypes.c_longlong
        lib.world_synthesize.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # f0 (T)
            ctypes.POINTER(ctypes.c_double),  # sp (T*K)
            ctypes.POINTER(ctypes.c_double),  # ap (T*K)
            ctypes.c_longlong,                # T
            ctypes.c_longlong,                # K
            ctypes.c_longlong,                # fs
            ctypes.c_double,                  # frame_period ms
            ctypes.c_longlong,                # noise seed
            ctypes.POINTER(ctypes.c_double),  # out wav
            ctypes.c_longlong,                # out capacity
        ]
    except (OSError, RuntimeError, AttributeError) as e:
        logger.warning('world_synth: native library unavailable (%s); using the NumPy '
                       'synthesis', e)
        return None
    _LIB = lib
    return _LIB


def native_available():
    return _load_native() is not None


def smooth_f0(f0, window_length=7, polyorder=1):
    """Savitzky-Golay smoothing of an f0 track (reference post-processing,
    ``models/f0_test_model.py:128``)."""
    f0 = np.asarray(f0, np.float64)
    if f0.shape[0] < window_length:
        return f0
    return savgol_filter(f0, window_length, polyorder)


# ---------------------------------------------------------------------------
# Mel-cepstrum <-> spectrum
# ---------------------------------------------------------------------------

def _freqt_recursion(c, order_out, alpha):
    """Frequency transform of a (batched) cepstrum: warping by ``alpha``
    (the standard Oppenheim recursion, vectorised over frames)."""
    c = np.atleast_2d(np.asarray(c, np.float64))
    num_frames, order_in = c.shape
    out = np.zeros((num_frames, order_out + 1))
    for i in range(order_in - 1, -1, -1):
        prev = out
        out = np.zeros_like(prev)
        out[:, 0] = c[:, i] + alpha * prev[:, 0]
        if order_out >= 1:
            out[:, 1] = (1 - alpha ** 2) * prev[:, 0] + alpha * prev[:, 1]
        for m in range(2, order_out + 1):
            out[:, m] = prev[:, m - 1] + alpha * (prev[:, m] - out[:, m - 1])
    return out


_FREQT_MATRICES = {}
_BAP_INTERP_MATRICES = {}


def _freqt(c, order_out, alpha):
    """Frequency transform as one matmul: the Oppenheim recursion is linear
    in the cepstrum, so its (order_in, order_out+1) matrix — the recursion
    applied to the identity, cached per (order_in, order_out, alpha) — turns
    the per-call O(order_in * order_out) Python loop into a single BLAS
    GEMM. This is the synthesis hot path (every mcep_to_spectrum call, once
    per streamed chunk)."""
    c = np.atleast_2d(np.asarray(c, np.float64))
    order_in = c.shape[1]
    key = (order_in, int(order_out), float(alpha))
    mat = _FREQT_MATRICES.get(key)
    if mat is None:
        mat = _freqt_recursion(np.eye(order_in), order_out, alpha)
        _FREQT_MATRICES[key] = mat
    return c @ mat


def default_alpha(fs):
    """Common all-pass warping constants per sample rate."""
    if fs >= 48000:
        return 0.77
    if fs >= 44100:
        return 0.76
    if fs >= 22050:
        return 0.58
    return 0.42  # 16 kHz


def mcep_to_spectrum(mcep, fft_size=1024, alpha=None, fs=16000):
    """Mel-cepstrum (T, M+1) -> power spectral envelope (T, fft_size//2 + 1)."""
    if alpha is None:
        alpha = default_alpha(fs)
    mcep = np.atleast_2d(np.asarray(mcep, np.float64))
    # Unwarp to a linear-frequency cepstrum, then exponentiate its Fourier
    # transform: log|H(w)| = c0 + 2 sum_m c_m cos(m w).
    c_lin = _freqt(mcep, fft_size // 2, -alpha)
    buf = np.zeros((c_lin.shape[0], fft_size))
    buf[:, :fft_size // 2 + 1] = c_lin
    buf[:, fft_size // 2 + 1:] = c_lin[:, 1:fft_size // 2][:, ::-1]
    log_sp = np.fft.rfft(buf, axis=-1).real
    # log amplitude -> power
    return np.exp(2.0 * log_sp)


def spectrum_to_mcep(sp, order=59, alpha=None, fs=16000):
    """Power spectral envelope -> mel-cepstrum (least-squares-free cepstral
    method: log, IFFT, warp). Used for data prep and round-trip tests."""
    if alpha is None:
        alpha = default_alpha(fs)
    sp = np.atleast_2d(np.asarray(sp, np.float64))
    fft_size = (sp.shape[-1] - 1) * 2
    log_amp = 0.5 * np.log(np.maximum(sp, 1e-100))
    # log_amp is the half spectrum of a real, even signal: irfft gives the
    # symmetric real cepstrum; keep the one-sided part (cos-series convention
    # matching mcep_to_spectrum).
    cep = np.fft.irfft(log_amp, n=fft_size, axis=-1)[:, :fft_size // 2 + 1]
    return _freqt(cep, order, alpha)


def bap_to_aperiodicity(bap, fft_size=1024, fs=16000):
    """Band aperiodicity (T, B), log-amplitude per band -> per-bin
    aperiodicity in (0, 1]: linear interpolation of the band values across
    frequency, then exp.

    Band value ``b`` is placed at its band's CENTRE frequency
    ``(b + 0.5) / B * nyquist`` — the same equal-width edge intervals
    ``analysis.band_aperiodicity`` measures over (``np.interp`` extends the
    first/last band's value to the spectrum edges). Placing them at
    ``linspace(0, nyquist, B)`` instead would warp the aperiodicity-vs-
    frequency curve by up to half a band width on every analysis->synthesis
    round trip."""
    bap = np.atleast_2d(np.asarray(bap, np.float64))
    num_bins = fft_size // 2 + 1
    num_bands = bap.shape[-1]
    # The interpolation is a CONSTANT linear map per (num_bands, num_bins):
    # one cached (B, K) weight matrix turns the per-frame np.interp loop
    # into a single BLAS matmul (same caching as _FREQT_MATRICES; this runs
    # per chunk on the streaming-serving hot path).
    key = (num_bands, num_bins)
    weights = _BAP_INTERP_MATRICES.get(key)
    if weights is None:
        band_pos = (np.arange(num_bands) + 0.5) / num_bands * (num_bins - 1)
        bins = np.arange(num_bins)
        weights = np.stack([np.interp(bins, band_pos, row)
                            for row in np.eye(num_bands)])
        _BAP_INTERP_MATRICES[key] = weights
    ap = bap @ weights
    return np.clip(np.exp(ap), 1e-16, 1.0)


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------

def _minimum_phase_spectra(power_sp):
    """Batched minimum-phase complex spectra from power envelopes (T, K)."""
    fft_size = (power_sp.shape[-1] - 1) * 2
    log_amp = 0.5 * np.log(np.maximum(power_sp, 1e-100))
    cep = np.fft.irfft(log_amp, n=fft_size, axis=-1)
    # Fold anticausal part onto causal part (minimum phase).
    cep[:, 1:fft_size // 2] *= 2.0
    cep[:, fft_size // 2 + 1:] = 0.0
    return np.exp(np.fft.rfft(cep, axis=-1))


def synthesize(f0, sp, ap, fs, frame_period=5.0, seed=0):
    r"""Synthesises a waveform from WORLD-style frame features.

    Parameters
    ----------
    f0 : np.ndarray (T,) — fundamental frequency per frame, 0 = unvoiced.
    sp : np.ndarray (T, K) — power spectral envelope (K = fft/2 + 1).
    ap : np.ndarray (T, K) — per-bin aperiodicity in [0, 1].
    fs : int — sample rate.
    frame_period : float — frame hop in milliseconds.

    Returns
    -------
    np.ndarray, float64 waveform of length ``T * hop``.
    """
    f0 = np.asarray(f0, np.float64).reshape(-1)
    sp = np.atleast_2d(np.asarray(sp, np.float64))
    ap = np.atleast_2d(np.asarray(ap, np.float64))
    num_frames, num_bins = sp.shape
    ap = np.broadcast_to(ap, (num_frames, num_bins))
    # Validate BEFORE the native call: the C library trusts these (a short
    # f0 buffer would be read out of bounds); the numpy path would raise a
    # clean IndexError, but the fast path must not turn a caller mistake
    # into memory corruption.
    if f0.shape[0] != num_frames:
        raise ValueError(f'{f0.shape[0]} f0 frames vs {num_frames} sp rows')
    hop = int(fs * frame_period / 1000.0)
    if hop <= 0:
        raise ValueError(f'frame_period {frame_period} ms at fs {fs} gives a '
                         f'non-positive hop ({hop})')
    num_samples = num_frames * hop

    lib = _load_native()
    if lib is not None:
        out = np.zeros(num_samples + 2 * (num_bins - 1) * 2, np.float64)
        f0_c = np.ascontiguousarray(f0)
        sp_c = np.ascontiguousarray(sp)
        ap_c = np.ascontiguousarray(ap)
        n = lib.world_synthesize(
            f0_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            sp_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ap_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            num_frames, num_bins, fs, float(frame_period), int(seed),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), out.shape[0])
        if n >= 0:
            return out[:num_samples]
        # fall through to numpy on native error

    return _synthesize_numpy(f0, sp, ap, fs, hop, seed)


def _synthesize_numpy(f0, sp, ap, fs, hop, seed=0):
    # Canonicalise to float64 FIRST: a float32 f0 would otherwise flow into
    # the phase cumsum below in float32, whose accumulated rounding shifts
    # glottal pulse positions over long signals (and diverges from
    # StreamingSynthesizer, which converts on entry).
    f0 = np.asarray(f0, np.float64)
    sp = np.asarray(sp, np.float64)
    ap = np.asarray(ap, np.float64)
    num_frames, num_bins = sp.shape
    fft_size = (num_bins - 1) * 2
    num_samples = num_frames * hop
    rng = np.random.default_rng(seed)

    # Per-frame minimum-phase filters for the periodic and aperiodic parts.
    h_per = _minimum_phase_spectra(sp * np.maximum(1.0 - ap ** 2, 1e-12))
    h_apr = _minimum_phase_spectra(sp * np.maximum(ap ** 2, 1e-12))

    # Sample-level excitation: glottal pulse train by phase accumulation.
    f0_per_sample = np.repeat(f0, hop)[:num_samples]
    voiced = f0_per_sample > 0
    phase = np.cumsum(np.where(voiced, f0_per_sample / fs, 0.0))
    pulse_pos = np.nonzero(np.diff(np.floor(phase), prepend=0.0) > 0)[0]
    periodic_exc = np.zeros(num_samples)
    if pulse_pos.size:
        # Energy normalisation: each pulse carries sqrt(T0 * fs).
        amp = np.sqrt(np.maximum(fs / np.maximum(f0_per_sample[pulse_pos], 1.0), 1.0))
        periodic_exc[pulse_pos] = amp
    # Unvoiced regions get pure-noise excitation (the aperiodicity there is
    # ~1, routing nearly all energy through the noise filter anyway).
    noise_exc = rng.standard_normal(num_samples)
    periodic_exc[~voiced] = 0.0

    # Frame both excitations (window length = fft_size), filter, overlap-add.
    win_len = min(fft_size, 4 * hop)
    window = np.hanning(win_len)
    # Normalise OLA gain for this hop/window combination.
    ola_gain = np.sum(window[::hop]) if hop < win_len else 1.0

    out = np.zeros(num_samples + fft_size)
    pad_exc_p = np.concatenate([periodic_exc, np.zeros(fft_size)])
    pad_exc_n = np.concatenate([noise_exc, np.zeros(fft_size)])

    starts = np.arange(num_frames) * hop
    frames_p = np.stack([pad_exc_p[s:s + win_len] for s in starts]) * window
    frames_n = np.stack([pad_exc_n[s:s + win_len] for s in starts]) * window

    spec_p = np.fft.rfft(frames_p, n=fft_size, axis=-1) * h_per
    spec_n = np.fft.rfft(frames_n, n=fft_size, axis=-1) * h_apr
    filt = np.fft.irfft(spec_p + spec_n, n=fft_size, axis=-1)

    for i, s in enumerate(starts):
        out[s:s + fft_size] += filt[i]

    out = out[:num_samples] / max(ola_gain, 1e-12)
    peak = np.max(np.abs(out))
    if peak > 1e-12:
        out = out / max(1.0, peak / 0.9)  # protect against clipping only
    return out


def synthesize_world_feats(f0, vuv, mcep, bap, sample_rate, frame_period=5.0,
                           fft_size=1024):
    r"""Synthesis from model-space features (reference:
    ``world_with_reaper_f0.synthesis(f0, vuv, mcep, bap, sr)``,
    ``models/RNN_SPSS.py:160``)."""
    f0 = np.asarray(f0, np.float64).reshape(-1)
    vuv = np.asarray(vuv).reshape(-1)
    sp = mcep_to_spectrum(mcep, fft_size=fft_size, fs=sample_rate)
    ap = bap_to_aperiodicity(bap, fft_size=fft_size, fs=sample_rate)
    num_frames = min(len(f0), len(vuv), sp.shape[0], ap.shape[0])
    f0 = np.where(vuv[:num_frames] > 0.5, f0[:num_frames], 0.0)
    return synthesize(f0, sp[:num_frames], ap[:num_frames], sample_rate,
                      frame_period=frame_period)


class StreamingSynthesizer(object):
    """Incremental waveform synthesis: push vocoder-feature frames chunk by
    chunk, receive finalised audio samples with a few frames of delay.

    Mirrors ``_synthesize_numpy`` operation-for-operation — same excitation
    (phase-accumulated glottal pulses + streamed white noise), same
    per-frame minimum-phase filters, same overlap-add — with all
    cross-chunk coupling carried as explicit state: the phase accumulator,
    the noise RNG mid-stream, unconsumed excitation samples, and the
    overlap-add tail. The streamed waveform equals the NUMPY batch path
    (``_synthesize_numpy`` with the same seed) on the concatenated features
    exactly, up to the batch path's final clip-protection rescale (which
    needs the global peak and is therefore skipped here; apply your own
    gain control downstream). The native library's batch output differs in
    its noise stream (XorShift vs numpy's PCG64), so :func:`synthesize`
    with the native backend matches in spectrum, not sample-for-sample.

    A frame is synthesisable once its excitation window (``min(fft_size,
    4*hop)`` samples) is available, so emission lags the pushed features by
    at most 4 frames (+ the final ``flush()``); each pushed chunk costs the
    same per-frame work as the batch path.

    Parameters match :func:`synthesize`; feed either ``push(f0, sp, ap)``
    with spectral features or :meth:`push_world_feats` with model-space
    (f0, vuv, mcep, bap) chunks.
    """

    def __init__(self, fs, frame_period=5.0, seed=0, fft_size=1024):
        self.fs = int(fs)
        self.frame_period = float(frame_period)
        self.hop = int(fs * frame_period / 1000.0)
        self.fft_size = int(fft_size)
        self._rng = np.random.default_rng(seed)

        self._phase = 0.0            # cumulative phase at the last sample
        self._prev_floor = 0.0       # floor(phase) at the last sample
        self._frames_pushed = 0
        self._frames_done = 0        # frames filtered + overlap-added
        self._emitted = 0            # samples returned to the caller
        # Excitation samples >= _frames_done * hop (windows still need them).
        self._exc_p = np.zeros(0)
        self._exc_n = np.zeros(0)
        self._pending = []           # (sp, ap) rows awaiting filtering
        # Overlap-add accumulator for samples >= _emitted.
        self._ola = np.zeros(0)
        self._finished = False

        win_len = min(self.fft_size, 4 * self.hop)
        self._window = np.hanning(win_len)
        self._ola_gain = (np.sum(self._window[::self.hop])
                          if self.hop < win_len else 1.0)

    # ------------------------------------------------------------------ api

    def push(self, f0, sp, ap):
        """Feeds frames (f0 (c,), sp (c, K), ap (c, K) or broadcastable) and
        returns the newly finalised float64 samples (possibly empty)."""
        if self._finished:
            raise RuntimeError('push() after flush()')
        f0 = np.asarray(f0, np.float64).reshape(-1)
        sp = np.atleast_2d(np.asarray(sp, np.float64))
        ap = np.broadcast_to(np.atleast_2d(np.asarray(ap, np.float64)), sp.shape)
        if sp.shape[0] != f0.shape[0]:
            raise ValueError(f'{f0.shape[0]} f0 frames vs {sp.shape[0]} sp rows')
        if sp.shape[1] != self.fft_size // 2 + 1:
            raise ValueError(f'sp has {sp.shape[1]} bins, expected '
                             f'{self.fft_size // 2 + 1} for fft_size {self.fft_size}')
        if f0.shape[0]:
            self._extend_excitation(f0)
            # Copy: atleast_2d/broadcast_to can alias the CALLER's buffer,
            # and these rows sit in _pending for up to 4 frames — a client
            # reusing one preallocated chunk buffer would silently corrupt
            # the deferred frames' spectra.
            self._pending.extend(zip(np.array(sp, copy=True),
                                     np.array(ap, copy=True)))
            self._frames_pushed += f0.shape[0]
        self._process(exc_end=self._frames_pushed * self.hop)
        return self._emit(final_upto=self._frames_done * self.hop)

    def flush(self):
        """Synthesises the remaining frames (zero excitation beyond the last
        pushed sample, as the batch path pads) and returns the tail; the
        total emitted length is exactly ``frames_pushed * hop``."""
        if self._finished:
            raise RuntimeError('flush() called twice')
        self._finished = True
        pad = np.zeros(self.fft_size)
        self._exc_p = np.concatenate([self._exc_p, pad])
        self._exc_n = np.concatenate([self._exc_n, pad])
        self._process(exc_end=self._frames_pushed * self.hop + self.fft_size)
        return self._emit(final_upto=self._frames_pushed * self.hop)

    @property
    def delay_frames(self):
        """Worst-case frames between a push and its samples emerging."""
        return -(-min(self.fft_size, 4 * self.hop) // self.hop)

    # ------------------------------------------------------------ internals

    def _extend_excitation(self, f0):
        hop, fs = self.hop, self.fs
        f0_per_sample = np.repeat(f0, hop)
        voiced = f0_per_sample > 0
        steps = np.where(voiced, f0_per_sample / fs, 0.0)
        # Bitwise-identical phase continuation: cumsum with the carry as the
        # leading element reproduces the batch path's single left-to-right
        # cumsum association exactly. `carry + cumsum(steps)` would NOT —
        # it sums the chunk first and re-rounds, shifting floor() crossings
        # (= glottal pulse positions) near ties.
        phase = np.cumsum(np.concatenate([[self._phase], steps]))[1:]
        floors = np.floor(phase)
        pulse = np.diff(floors, prepend=self._prev_floor) > 0
        self._phase = float(phase[-1])
        self._prev_floor = float(floors[-1])

        exc_p = np.zeros(f0_per_sample.shape[0])
        pulse_pos = np.nonzero(pulse)[0]
        if pulse_pos.size:
            amp = np.sqrt(np.maximum(
                fs / np.maximum(f0_per_sample[pulse_pos], 1.0), 1.0))
            exc_p[pulse_pos] = amp
        exc_p[~voiced] = 0.0
        exc_n = self._rng.standard_normal(f0_per_sample.shape[0])

        self._exc_p = np.concatenate([self._exc_p, exc_p])
        self._exc_n = np.concatenate([self._exc_n, exc_n])

    def _process(self, exc_end):
        """Filters every pending frame whose excitation window fits in
        [0, exc_end) and overlap-adds it into the accumulator."""
        hop, fft_size = self.hop, self.fft_size
        win_len = self._window.shape[0]
        ready = []
        while (self._pending
               and (self._frames_done + len(ready) + 1) * hop - hop + win_len
               <= exc_end):
            ready.append(self._pending.pop(0))
        if not ready:
            return
        sp = np.stack([r[0] for r in ready])
        ap = np.stack([r[1] for r in ready])
        h_per = _minimum_phase_spectra(sp * np.maximum(1.0 - ap ** 2, 1e-12))
        h_apr = _minimum_phase_spectra(sp * np.maximum(ap ** 2, 1e-12))

        exc_base = self._frames_done * hop    # sample index of _exc_*[0]
        starts = (self._frames_done + np.arange(len(ready))) * hop
        rel = starts - exc_base
        frames_p = np.stack([self._exc_p[r:r + win_len] for r in rel]) * self._window
        frames_n = np.stack([self._exc_n[r:r + win_len] for r in rel]) * self._window
        spec = (np.fft.rfft(frames_p, n=fft_size, axis=-1) * h_per
                + np.fft.rfft(frames_n, n=fft_size, axis=-1) * h_apr)
        filt = np.fft.irfft(spec, n=fft_size, axis=-1)

        # Grow the accumulator to cover the last write, then add in frame
        # order (same floating-point accumulation order as the batch loop).
        last = starts[-1] + fft_size - self._emitted
        if self._ola.shape[0] < last:
            self._ola = np.concatenate(
                [self._ola, np.zeros(last - self._ola.shape[0])])
        for i, s in enumerate(starts):
            lo = s - self._emitted
            self._ola[lo:lo + fft_size] += filt[i]

        self._frames_done += len(ready)
        # Drop excitation the remaining frames no longer need.
        consumed = self._frames_done * hop - exc_base
        self._exc_p = self._exc_p[consumed:]
        self._exc_n = self._exc_n[consumed:]

    def _emit(self, final_upto):
        n = final_upto - self._emitted
        if n <= 0:
            return np.zeros(0)
        if self._ola.shape[0] < n:
            # hop > window: the inter-frame gap samples received no writes —
            # they are zeros, exactly as the batch path's full-length zero
            # output array leaves them.
            self._ola = np.concatenate(
                [self._ola, np.zeros(n - self._ola.shape[0])])
        out = self._ola[:n] / max(self._ola_gain, 1e-12)
        self._ola = self._ola[n:]
        self._emitted = final_upto
        return out

    # ------------------------------------------------------- model features

    def push_world_feats(self, f0, vuv, mcep, bap):
        """Feeds model-space feature chunks (the acoustic model's outputs:
        lf0 already exp()'d to Hz, vuv in [0,1], mel-cepstra, band
        aperiodicities) — the streaming counterpart of
        :func:`synthesize_world_feats`."""
        f0 = np.asarray(f0, np.float64).reshape(-1)
        vuv = np.asarray(vuv).reshape(-1)
        sp = mcep_to_spectrum(mcep, fft_size=self.fft_size, fs=self.fs)
        ap = bap_to_aperiodicity(bap, fft_size=self.fft_size, fs=self.fs)
        num = min(len(f0), len(vuv), sp.shape[0], ap.shape[0])
        f0 = np.where(vuv[:num] > 0.5, f0[:num], 0.0)
        return self.push(f0, sp[:num], ap[:num])
