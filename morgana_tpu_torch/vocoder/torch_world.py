"""Batched WORLD-style waveform synthesis on the device (counterpart of
``morgana_tpu/vocoder/jax_world.py``).

The same source-filter algorithm as :func:`world._synthesize_numpy`, step
for step as ``jax_world._core`` writes it, in float32 PyTorch: minimum-phase
filters by ``torch.fft``, a closed-form glottal pulse train, windowed FFT
filtering and an overlap-add, for a whole batch of utterances at once on the
GPU where the acoustic model's features already are. The JAX package runs it
as plain XLA (no Pallas kernel), so this module holds no kernel either.

- **Pulse positions without a sample-level cumsum.** Phase is summed per
  frame (T terms) and expanded within each frame in closed form; the last
  in-frame phase is the next frame's anchor, so a pulse can move by a
  sample where float32 rounds a crossing, but never drops.
- **A deterministic overlap-add.** ``jax_world`` scatter-adds the filtered
  frames; on CUDA, ``index_add_`` adds floats by atomics, in an order that
  changes from run to run. Here each frame's ``fft_size`` samples are padded
  to ``ceil(fft_size / hop)`` hops and summed as that many shifted
  ``(T, hop)`` slices, frame by frame in the host path's order, so two runs
  give the same bits.
- **Padding frames are silenced** by a mask (an all-zero mcep row is a
  unity filter, not silence), and each utterance is peak-normalised as the
  host path is.
- **Noise** is passed in (the tests give both packages the host path's
  seeded numpy noise) or drawn from a ``torch.Generator`` on the device.
"""
import math

import numpy as np
import torch

from morgana_tpu_torch.device import resolve_device
from morgana_tpu_torch.vocoder import world as _world

__all__ = ['synthesize_torch', 'synthesize_world_feats_torch', 'synthesize_batch',
           'pulse_train']


def _conversion_constants(num_mcep, num_bands, fft_size, fs):
    """The mcep->spectrum freqt matrix and the bap->aperiodicity
    interpolation weights: world.py's float64 caches, cast to float32
    (``jax_world.py:46-65``)."""
    alpha = _world.default_alpha(fs)
    key = (num_mcep, fft_size // 2, float(-alpha))
    mat = _world._FREQT_MATRICES.get(key)
    if mat is None:
        mat = _world._freqt_recursion(np.eye(num_mcep), fft_size // 2, -alpha)
        _world._FREQT_MATRICES[key] = mat
    num_bins = fft_size // 2 + 1
    bkey = (num_bands, num_bins)
    weights = _world._BAP_INTERP_MATRICES.get(bkey)
    if weights is None:
        band_pos = (np.arange(num_bands) + 0.5) / num_bands * (num_bins - 1)
        bins = np.arange(num_bins)
        weights = np.stack([np.interp(bins, band_pos, row) for row in np.eye(num_bands)])
        _world._BAP_INTERP_MATRICES[bkey] = weights
    return mat.astype(np.float32), weights.astype(np.float32)


def _mcep_to_spectrum(mcep, freqt_mat, fft_size):
    """world.mcep_to_spectrum on (..., T, M): unwarp (one matmul), cosine
    series by the rfft of the symmetrised cepstrum, exponentiate."""
    c_lin = mcep @ freqt_mat
    half = fft_size // 2
    buf = torch.cat([c_lin, c_lin[..., 1:half].flip(-1)], dim=-1)
    return torch.exp(2.0 * torch.fft.rfft(buf, dim=-1).real)


def _minimum_phase_spectra(power_sp, fft_size):
    """world._minimum_phase_spectra on (..., T, K): fold the real cepstrum
    onto its causal part and exponentiate its spectrum."""
    log_amp = 0.5 * torch.log(torch.clamp_min(power_sp, 1e-38))
    cep = torch.fft.irfft(log_amp, n=fft_size, dim=-1)
    half = fft_size // 2
    fold = torch.cat([cep[..., :1], cep[..., 1:half] * 2.0, cep[..., half:half + 1],
                      torch.zeros_like(cep[..., half + 1:])], dim=-1)
    return torch.exp(torch.fft.rfft(fold, dim=-1))


def pulse_train(f0, fs, hop):
    """(B, T) f0 in Hz (0 unvoiced) -> (B, T*hop) glottal pulse excitation,
    each pulse ``sqrt(fs / f0)`` high (``jax_world.py:113-127``). Phase is
    summed per frame (anchors) and expanded within a frame in closed form,
    its last sample forced to the next anchor, so each frame finds exactly
    the integer crossings in (anchor_t, anchor_t+1]."""
    batch, num_frames = f0.shape
    rate = f0 / float(fs)                                           # cycles/sample
    anchors = torch.cat([torch.zeros_like(rate[:, :1]),
                         torch.cumsum(rate * hop, dim=1)], dim=1)  # (B, T+1)
    r_eff = (anchors[:, 1:] - anchors[:, :-1]) / hop
    j = torch.arange(hop, dtype=rate.dtype, device=rate.device)
    ph_at = anchors[:, :-1, None] + (j + 1.0) * r_eff[..., None]   # (B, T, hop)
    ph_at[..., -1] = anchors[:, 1:]
    ph_before = torch.cat([anchors[:, :-1, None], ph_at[..., :-1]], dim=-1)
    pulses = torch.floor(ph_at) > torch.floor(ph_before)
    voiced = (f0 > 0)[..., None]
    amp = torch.sqrt(torch.clamp_min(float(fs) / torch.clamp_min(f0, 1.0), 1.0))[..., None]
    periodic = torch.where(pulses & voiced, amp, torch.zeros_like(amp))
    return periodic.reshape(batch, num_frames * hop)


def _core(f0, sp, ap, noise, frame_mask, fs, hop, fft_size):
    """(B, T) f0, (B, T, K) sp and ap, (B, >= T*hop) noise, (B, T) frame
    mask -> (B, T*hop) waveforms; ``jax_world._core`` (``:94-161``) over a
    batch."""
    batch, num_frames = f0.shape
    num_samples = num_frames * hop

    f0 = f0 * frame_mask
    h_per = _minimum_phase_spectra(sp * torch.clamp_min(1.0 - ap ** 2, 1e-12), fft_size)
    h_apr = _minimum_phase_spectra(sp * torch.clamp_min(ap ** 2, 1e-12), fft_size)
    periodic = pulse_train(f0, fs, hop)

    win_len = min(fft_size, 4 * hop)
    hann = np.hanning(win_len)
    window = torch.as_tensor(hann, dtype=torch.float32, device=f0.device)
    ola_gain = float(np.sum(hann[::hop])) if hop < win_len else 1.0

    # Frame t's window starts at sample t*hop of the excitation padded by
    # fft_size zeros: unfold gives the rows jax_world gathers.
    exc_p = torch.nn.functional.pad(periodic, (0, fft_size))
    exc_n = torch.nn.functional.pad(noise[:, :num_samples], (0, fft_size))
    frames_p = exc_p.unfold(-1, win_len, hop)[:, :num_frames] * window
    frames_n = exc_n.unfold(-1, win_len, hop)[:, :num_frames] * window
    spec = (torch.fft.rfft(frames_p, n=fft_size, dim=-1) * h_per
            + torch.fft.rfft(frames_n, n=fft_size, dim=-1) * h_apr)
    filt = torch.fft.irfft(spec, n=fft_size, dim=-1) * frame_mask[..., None]

    # Overlap-add without atomics: frame t's samples, padded to `segments`
    # hops, land on hops t .. t+segments-1 of the output. Slice k of every
    # frame is added at once; k runs down, so each output hop sums its
    # frames in ascending order, as the host loop does.
    segments = math.ceil(fft_size / hop)
    filt = torch.nn.functional.pad(filt, (0, segments * hop - fft_size))
    filt = filt.reshape(batch, num_frames, segments, hop)
    out = filt.new_zeros(batch, num_frames + segments, hop)
    for k in range(segments - 1, -1, -1):
        out[:, k:k + num_frames] += filt[:, :, k]
    out = out.reshape(batch, -1)[:, :num_samples] / max(ola_gain, 1e-12)

    peak = out.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(peak > 1e-12, 1.0 / torch.clamp_min(peak / 0.9, 1.0),
                        torch.ones_like(peak))
    return out * scale


def _hop(fs, frame_period):
    hop = int(fs * frame_period / 1000.0)
    if hop <= 0:
        raise ValueError(f'frame_period {frame_period} ms at fs {fs} gives a non-positive '
                         f'hop ({hop})')
    return hop


def _noise(noise, shape, generator, device):
    """The given noise as float32 on ``device``, or a standard normal draw
    of ``shape`` from ``generator`` (default: a generator on the device
    seeded 0)."""
    if noise is not None:
        return torch.as_tensor(noise, dtype=torch.float32).to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randn(shape, generator=generator, device=device)


def synthesize_torch(f0, sp, ap, fs, frame_period=5.0, noise=None, generator=None,
                     device=None):
    """One utterance (counterpart of ``jax_world.synthesize_jax``): (T,) f0,
    (T, K) sp, (T, K) or broadcastable ap -> (T*hop,) float32 waveform on
    ``device`` (``None``: the GPU). ``noise``: optional (T*hop,) excitation
    noise, else drawn from ``generator``."""
    device = resolve_device(device)
    f0 = torch.as_tensor(f0, dtype=torch.float32).to(device).reshape(1, -1)
    sp = torch.atleast_2d(torch.as_tensor(sp, dtype=torch.float32).to(device))
    ap = torch.atleast_2d(torch.as_tensor(ap, dtype=torch.float32).to(device)).expand(sp.shape)
    if f0.shape[1] != sp.shape[0]:
        raise ValueError(f'{f0.shape[1]} f0 frames vs {sp.shape[0]} sp rows')
    hop = _hop(fs, frame_period)
    fft_size = (sp.shape[-1] - 1) * 2
    num_samples = f0.shape[1] * hop
    noise = _noise(noise, (num_samples,), generator, device).reshape(1, -1)
    mask = torch.ones_like(f0)
    return _core(f0, sp[None], ap[None], noise, mask, int(fs), hop, fft_size)[0]


def synthesize_world_feats_torch(f0, vuv, mcep, bap, sample_rate, frame_period=5.0,
                                 fft_size=1024, noise=None, generator=None, device=None):
    """Model-space features of one utterance (counterpart of
    ``jax_world.synthesize_world_feats_jax``)."""
    device = resolve_device(device)
    f0 = torch.as_tensor(f0, dtype=torch.float32).to(device).reshape(-1)
    vuv = torch.as_tensor(vuv, dtype=torch.float32).to(device).reshape(-1)
    mcep = torch.atleast_2d(torch.as_tensor(mcep, dtype=torch.float32).to(device))
    bap = torch.atleast_2d(torch.as_tensor(bap, dtype=torch.float32).to(device))
    freqt_mat, bap_w = (torch.from_numpy(c).to(device) for c in _conversion_constants(
        mcep.shape[-1], bap.shape[-1], fft_size, sample_rate))
    sp = _mcep_to_spectrum(mcep, freqt_mat, fft_size)
    ap = torch.clamp(torch.exp(bap @ bap_w), 1e-16, 1.0)
    f0 = torch.where(vuv > 0.5, f0, torch.zeros_like(f0))
    return synthesize_torch(f0, sp, ap, sample_rate, frame_period=frame_period, noise=noise,
                            generator=generator, device=device)


def synthesize_batch(f0, vuv, mcep, bap, seq_len, sample_rate, frame_period=5.0,
                     fft_size=1024, noise=None, generator=None, device=None):
    """Batched synthesis from model-space features (counterpart of
    ``jax_world.synthesize_batch``).

    Parameters
    ----------
    f0, vuv : (B, T) or (B, T, 1); mcep : (B, T, M); bap : (B, T, bands)
        Zero-padded to a shared T (the model's output layout); tensors or
        arrays.
    seq_len : (B,) valid frame counts.
    noise : optional (B, T*hop) excitation noise; else drawn from
        ``generator`` (default: a generator on the device seeded 0).
    device : ``None`` means the GPU (:func:`resolve_device`); ``'cpu'`` runs
        on the CPU.

    Returns
    -------
    (waves, wave_lens): (B, T*hop) float32 waveforms on ``device`` and the
    (B,) sample counts ``seq_len * hop``. Frames past ``seq_len`` are
    silenced; the samples past ``seq_len * hop`` hold the decaying tails of
    the last frames' filters, as in ``jax_world``.
    """
    device = resolve_device(device)

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32).to(device)

    f0, vuv, mcep, bap = tensor(f0), tensor(vuv), tensor(mcep), tensor(bap)
    if f0.ndim == 3:
        f0 = f0[..., 0]
    if vuv.ndim == 3:
        vuv = vuv[..., 0]
    seq_len = torch.as_tensor(seq_len).to(device=device, dtype=torch.int64).reshape(-1)
    batch, num_frames = f0.shape
    hop = _hop(sample_rate, frame_period)
    noise = _noise(noise, (batch, num_frames * hop), generator, device)

    freqt_mat, bap_w = (torch.from_numpy(c).to(device) for c in _conversion_constants(
        int(mcep.shape[-1]), int(bap.shape[-1]), fft_size, sample_rate))
    sp = _mcep_to_spectrum(mcep, freqt_mat, fft_size)
    ap = torch.clamp(torch.exp(bap @ bap_w), 1e-16, 1.0)
    voiced_f0 = torch.where(vuv > 0.5, f0, torch.zeros_like(f0))
    mask = (torch.arange(num_frames, device=device)[None, :] < seq_len[:, None]).float()
    waves = _core(voiced_f0, sp, ap, noise, mask, int(sample_rate), hop, fft_size)
    return waves, seq_len * hop
