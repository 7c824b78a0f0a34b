"""Vocoder analysis on the host: wav -> (f0, spectral envelope, aperiodicity)
-> model features (lf0, vuv, mcep, bap); counterpart of
``morgana_tpu/vocoder/analysis.py``, the same float64 NumPy.

* f0: normalised-autocorrelation pitch tracker with parabolic refinement and
  an energy+periodicity voicing decision,
* spectral envelope: STFT power with cepstral-liftering smoothing,
* aperiodicity: per-band noise-to-total energy ratio from the normalised
  autocorrelation peak.
"""
import numpy as np

from morgana_tpu_torch.vocoder.world import spectrum_to_mcep

__all__ = ['estimate_f0', 'spectral_envelope', 'band_aperiodicity', 'analyze',
           'features_from_wav', 'default_fft_size']


def _frame_signal(wav, frame_len, hop, num_frames, center=True,
                  frame_indices=None):
    """Extracts (num_frames, frame_len) windows at hop intervals.

    ``center=True`` places frame ``t``'s window symmetrically around sample
    ``t * hop`` (zero-padded at the edges), so every per-frame estimate is
    aligned with its nominal time — an uncentred window lags by
    ``frame_len / 2`` (~21 ms at the f0 window size), which alone costs
    ~8 Hz RMSE on a 3 Hz vibrato and misaligns features with labels.
    ``frame_indices`` gathers only the given frame rows (same window
    placement), for estimators that touch a subset of frames.
    """
    rows = (np.arange(num_frames) if frame_indices is None
            else np.asarray(frame_indices))
    offsets = hop * rows[:, None]
    lead = frame_len // 2 if center else 0
    idx = np.arange(frame_len)[None, :] + offsets
    padded = np.concatenate([np.zeros(lead, wav.dtype), wav,
                             np.zeros(frame_len, wav.dtype)])
    return padded[idx]


def estimate_f0(wav, fs, frame_period=5.0, f0_min=60.0, f0_max=400.0,
                voicing_threshold=0.45):
    r"""Normalised-autocorrelation f0 tracking.

    Returns ``(f0, vuv)`` per frame; ``f0`` is 0 in unvoiced frames.
    """
    wav = np.asarray(wav, np.float64)
    hop = int(fs * frame_period / 1000.0)
    num_frames = int(np.ceil(len(wav) / hop))
    # 2.5 periods of f0_min, so the longest candidate lag still overlaps
    # ~1.5 periods of signal. The memory cap binds only at extreme sample
    # rates (>196 kHz at f0_min=60); lag_max scales down WITH it below so
    # the overlap guarantee survives capping (a fixed 2048 cap would leave
    # <1 period of overlap at 96 kHz, making low-pitch tracking noisy).
    frame_len = min(int(2.5 * fs / f0_min), 8192)

    frames = _frame_signal(wav, frame_len, hop, num_frames)
    frames = frames - frames.mean(axis=1, keepdims=True)

    lag_min = int(fs / f0_max)
    lag_max = min(int(fs / f0_min), int(frame_len / 2.5))

    # Autocorrelation via FFT (batched).
    nfft = 1
    while nfft < 2 * frame_len:
        nfft *= 2
    spec = np.fft.rfft(frames, n=nfft, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), n=nfft, axis=1)[:, :lag_max + 1]

    energy = ac[:, 0] + 1e-12
    # PROPER normalisation nac(l) = ac(l) / sqrt(E[x_0:N-l] * E[x_l:N]):
    # the ac(l)/ac(0) shortcut caps a pure tone's peak at (N-l)/N (~0.8 at
    # speech lags), squashing the voiced/unvoiced confidence margin the
    # threshold below depends on. With it, periodic peaks sit at ~1.0.
    cum = np.cumsum(frames ** 2, axis=1)
    total = cum[:, -1:]
    l_idx = np.arange(lag_max + 1)
    e_head = cum[:, frame_len - 1 - l_idx]
    e_tail = np.concatenate(
        [total, total - cum[:, :lag_max]], axis=1)
    nac = ac / (np.sqrt(e_head * e_tail) + 1e-12)

    window = nac[:, lag_min:lag_max + 1]
    best = np.argmax(window, axis=1)
    peak = window[np.arange(num_frames), best]

    # Octave-error guard: a periodic signal's nac is ~equally high at every
    # multiple of the true period (the biased ac(0) normalisation used to
    # hide this by penalising long lags), so the global argmax can land on
    # 2x/3x/4x the period. RAPT-style fix: if a SUB-multiple of the chosen
    # lag is nearly as periodic (within 0.15, searched over a +/-2-sample
    # neighbourhood for the fractional true lag), prefer the shortest one.
    frame_idx = np.arange(num_frames)
    abs_lag = best + lag_min
    resolved = np.zeros(num_frames, dtype=bool)
    for k in (4, 3, 2):
        sub = np.round(abs_lag / k).astype(int)
        offs = np.stack([nac[frame_idx, np.clip(sub + d, 0, lag_max)]
                         for d in range(-2, 3)])                  # (5, F)
        j = np.argmax(offs, axis=0)
        val = offs[j, frame_idx]
        cand_lag = sub + j - 2
        accept = (~resolved & (sub >= lag_min + 1)
                  & (cand_lag >= lag_min) & (cand_lag <= lag_max)
                  & (val >= peak - 0.15))
        best = np.where(accept, cand_lag - lag_min, best)
        peak = np.where(accept, val, peak)
        resolved |= accept

    # Parabolic interpolation around the peak for sub-sample lag precision.
    lags = (best + lag_min).astype(np.float64)
    valid = (best > 0) & (best < window.shape[1] - 1)
    b_idx = np.clip(best, 1, window.shape[1] - 2)
    y0 = window[np.arange(num_frames), b_idx - 1]
    y1 = window[np.arange(num_frames), b_idx]
    y2 = window[np.arange(num_frames), b_idx + 1]
    denom = (y0 - 2 * y1 + y2)
    nonzero = np.abs(denom) > 1e-12
    shift = np.where(nonzero, 0.5 * (y0 - y2) / np.where(nonzero, denom, 1.0), 0.0)
    lags = np.where(valid, b_idx + lag_min + np.clip(shift, -1, 1), lags)

    f0 = fs / np.maximum(lags, 1.0)

    frame_rms = np.sqrt(energy / frame_len)
    loud = frame_rms > max(1e-4, 0.05 * np.median(frame_rms[frame_rms > 1e-6]) if
                           (frame_rms > 1e-6).any() else 1e-4)
    vuv = (peak > voicing_threshold) & loud & (f0 >= f0_min) & (f0 <= f0_max)

    return np.where(vuv, f0, 0.0), vuv.astype(np.float64)



def default_fft_size(fs):
    """Smallest power of two holding ~4 pitch periods at the 120 Hz f0
    floor (WORLD's CheapTrick scales its FFT with fs the same way): 1024 at
    16 kHz, 4096 at 96 kHz. A sample-rate-independent FFT would make the
    cepstral envelope cutoff impossible to honour at high rates."""
    n = 1
    while n < 4 * fs / 120.0:
        n *= 2
    return n

def spectral_envelope(wav, fs, frame_period=5.0, fft_size=None, lifter_quefrency=None):
    r"""STFT power spectrum smoothed by cepstral liftering -> envelope
    (num_frames, fft_size//2 + 1). ``fft_size=None`` scales with ``fs``
    (:func:`default_fft_size`)."""
    wav = np.asarray(wav, np.float64)
    if fft_size is None:
        fft_size = default_fft_size(fs)
    hop = int(fs * frame_period / 1000.0)
    num_frames = int(np.ceil(len(wav) / hop))
    frame_len = min(fft_size, 4 * hop)

    frames = _frame_signal(wav, frame_len, hop, num_frames) * np.hanning(frame_len)
    power = np.abs(np.fft.rfft(frames, n=fft_size, axis=1)) ** 2 / frame_len
    power = np.maximum(power, 1e-12)

    # Cepstral smoothing: keep quefrencies below ~1/f0_floor. Clamp to the
    # fft window: at high sample rates int(fs/120) can exceed fft_size/2,
    # which would zero NOTHING and silently return the raw harmonic
    # spectrum instead of an envelope.
    if lifter_quefrency is None:
        lifter_quefrency = int(fs / 120.0)
    lifter_quefrency = min(int(lifter_quefrency), (fft_size - 1) // 2)
    log_power = np.log(power)
    cep = np.fft.irfft(log_power, n=fft_size, axis=1)
    cep[:, lifter_quefrency:fft_size - lifter_quefrency] = 0.0
    smoothed = np.fft.rfft(cep, axis=1).real
    return np.exp(smoothed)


def band_aperiodicity(wav, f0, fs, frame_period=5.0, num_bands=5):
    r"""Per-band log aperiodicity (num_frames, num_bands), <= 0.

    Estimated from the normalised autocorrelation at the pitch lag computed
    per band-passed signal: ap^2 ~ 1 - nac (noise-to-total energy ratio).
    Unvoiced frames saturate to 0 (fully aperiodic).
    """
    wav = np.asarray(wav, np.float64)
    hop = int(fs * frame_period / 1000.0)
    num_frames = len(f0)
    frame_len = min(int(4.0 * fs / 60.0), 4096)

    spectrum = np.fft.rfft(wav)
    freqs = np.fft.rfftfreq(len(wav), 1.0 / fs)
    edges = np.linspace(0, fs / 2, num_bands + 1)

    lags = np.where(f0 > 0, np.clip(fs / np.maximum(f0, 1.0), 1,
                                    frame_len // 2).astype(int), 1)
    voiced = np.flatnonzero(f0 > 0)

    bap = np.zeros((num_frames, num_bands))
    for b in range(num_bands):
        mask = (freqs >= edges[b]) & (freqs < edges[b + 1])
        band = np.fft.irfft(spectrum * mask, n=len(wav))
        # Only voiced rows are read below, so only they are gathered —
        # framing all num_frames rows would materialise a (T, frame_len)
        # float64 matrix per band regardless of the voiced fraction.
        frames = _frame_signal(band, frame_len, hop, num_frames,
                               frame_indices=voiced)
        frames = frames - frames.mean(axis=1, keepdims=True)

        # Per voiced frame: normalised cross-correlation of the first ~3.5
        # periods against themselves one period later, maximised over a small
        # lag neighbourhood with parabolic refinement. Three deliberate
        # choices, each worth ~0.3-0.5 of spurious aperiodicity:
        # * PROPER normalisation ac(l)/sqrt(E_head * E_tail) — the classic
        #   ac(l)/ac(0) shortcut caps nac at (N-l)/N, i.e. reads a pure tone
        #   as ~40% noise at speech lags;
        # * a PITCH-ADAPTIVE window (~3.5 periods, not a fixed 40 ms) — over
        #   a long window natural f0 drift decoheres the high bands;
        # * lag-neighbourhood max + parabolic peak — the true lag is
        #   fractional, and one sample of lag error at 6 kHz is a ~2 rad
        #   phase error.
        nac = np.zeros(num_frames)
        for row, i in enumerate(voiced):
            lag = lags[i]
            seg_len = min(int(3.5 * lag), frame_len - lag - 3)
            if seg_len <= 4:
                continue
            x = frames[row]
            head = x[:seg_len]
            e_head = head @ head
            vals = np.empty(5)
            for j, d in enumerate(range(-2, 3)):
                l = min(max(lag + d, 1), frame_len - seg_len - 1)
                tail = x[l:l + seg_len]
                vals[j] = (head @ tail) / (np.sqrt(e_head * (tail @ tail)) + 1e-12)
            k = int(np.argmax(vals))
            peak = vals[k]
            if 0 < k < 4:
                denom = vals[k - 1] - 2.0 * vals[k] + vals[k + 1]
                if denom < -1e-12:
                    refined = vals[k] - 0.125 * (vals[k + 1] - vals[k - 1]) ** 2 / denom
                    if np.isfinite(refined):
                        peak = max(peak, refined)
            nac[i] = peak

        periodic_fraction = np.clip(nac, 0.0, 1.0 - 1e-6)
        ap2 = np.where(f0 > 0, 1.0 - periodic_fraction, 1.0 - 1e-6)
        bap[:, b] = 0.5 * np.log(np.maximum(ap2, 1e-12))

    return np.clip(bap, -20.0, 0.0)


def analyze(wav, fs, frame_period=5.0, fft_size=None):
    r"""wav -> ``(f0, sp, ap)`` in WORLD conventions (power envelope,
    per-bin aperiodicity in (0, 1])."""
    from morgana_tpu_torch.vocoder.world import bap_to_aperiodicity

    if fft_size is None:
        fft_size = default_fft_size(fs)
    f0, _vuv = estimate_f0(wav, fs, frame_period)
    sp = spectral_envelope(wav, fs, frame_period, fft_size)
    num_frames = min(len(f0), sp.shape[0])
    f0, sp = f0[:num_frames], sp[:num_frames]
    bap = band_aperiodicity(wav, f0, fs, frame_period)[:num_frames]
    ap = bap_to_aperiodicity(bap, fft_size=fft_size, fs=fs)
    return f0, sp, ap


def features_from_wav(wav, fs, frame_period=5.0, fft_size=None,
                      mcep_order=59, num_bands=5):
    r"""wav -> model-feature dict ``{lf0, vuv, mcep, bap, n_frames}`` in the
    shapes/conventions the example models train on (``models/rnn_spss.py``).
    ``fft_size=None`` scales with ``fs`` (:func:`default_fft_size`)."""
    if fft_size is None:
        fft_size = default_fft_size(fs)
    f0, vuv = estimate_f0(wav, fs, frame_period)
    sp = spectral_envelope(wav, fs, frame_period, fft_size)
    num_frames = min(len(f0), sp.shape[0])
    f0, vuv, sp = f0[:num_frames], vuv[:num_frames], sp[:num_frames]

    # Interpolate f0 through unvoiced regions for a continuous lf0 track.
    voiced_idx = np.nonzero(f0 > 0)[0]
    if voiced_idx.size:
        f0_interp = np.interp(np.arange(num_frames), voiced_idx, f0[voiced_idx])
    else:
        f0_interp = np.full(num_frames, 100.0)

    lf0 = np.log(np.maximum(f0_interp, 1.0)).astype(np.float32)[:, None]
    mcep = spectrum_to_mcep(sp, order=mcep_order, fs=fs).astype(np.float32)
    bap = band_aperiodicity(wav, f0, fs, frame_period, num_bands)[:num_frames]

    return {
        'lf0': lf0,
        'vuv': vuv.astype(np.float32)[:, None],
        'mcep': mcep,
        'bap': bap.astype(np.float32),
        'n_frames': np.array([num_frames], np.float32),
    }
