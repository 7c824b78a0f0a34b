"""WORLD-style vocoder of the port (counterpart of ``morgana_tpu/vocoder``):
waveform synthesis from (f0, spectral envelope, aperiodicity), the
mel-cepstrum and band-aperiodicity conversions, and the analysis back to
model features.

* ``world``: the host path, float64 NumPy with a native C++ library
  (``csrc/world_synth.cpp``, built by g++ at first use, loaded by
  ``ctypes``); the NumPy synthesis runs where the library is not built;
* ``analysis``: wav -> features, host NumPy;
* ``torch_world`` (imported by name): the same synthesis for a batch of
  utterances in float32 on the GPU (``synthesize_batch``).

Synthesis model: per-frame excitation (glottal pulses at f0, white noise for
the aperiodic band) filtered by the minimum-phase reconstruction of the
spectral envelope, overlap-added.
"""
from morgana_tpu_torch.vocoder.world import (
    synthesize, synthesize_world_feats, smooth_f0,
    mcep_to_spectrum, spectrum_to_mcep, bap_to_aperiodicity, native_available,
    StreamingSynthesizer,
)
from morgana_tpu_torch.vocoder.analysis import (
    analyze, estimate_f0, spectral_envelope, band_aperiodicity,
    features_from_wav,
)

__all__ = [
    'synthesize', 'synthesize_world_feats', 'smooth_f0',
    'mcep_to_spectrum', 'spectrum_to_mcep', 'bap_to_aperiodicity',
    'native_available', 'StreamingSynthesizer',
    'analyze', 'estimate_f0', 'spectral_envelope',
    'band_aperiodicity', 'features_from_wav',
]
