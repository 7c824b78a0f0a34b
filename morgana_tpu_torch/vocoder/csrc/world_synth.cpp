// WORLD-style vocoder synthesis — native implementation.
//
// Mirrors morgana_tpu/vocoder/world.py::_synthesize_numpy: per-frame
// minimum-phase reconstruction of the spectral envelope, split into a
// periodic part sp*(1-ap^2) excited by a glottal pulse train at f0 and an
// aperiodic part sp*ap^2 excited by white noise, filtered and overlap-added.
//
// Replaces the reference's external C++ vocoder dependency (pyworld /
// tts_data_tools WORLD bindings) with a dependency-free library exposed
// through a C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 world_synth.cpp
//        -o ../libworld_synth.so -pthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------------------
// Iterative radix-2 complex FFT (in-place, interleaved re/im).
// ---------------------------------------------------------------------------

struct FFTPlan {
  int n = 0;
  std::vector<int> rev;
  std::vector<double> wre, wim;  // twiddles per stage, packed

  explicit FFTPlan(int n_) : n(n_) {
    rev.resize(n);
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    for (int i = 0; i < n; ++i) {
      int r = 0;
      for (int b = 0; b < log2n; ++b)
        if (i & (1 << b)) r |= 1 << (log2n - 1 - b);
      rev[i] = r;
    }
    wre.resize(n / 2);
    wim.resize(n / 2);
    for (int k = 0; k < n / 2; ++k) {
      wre[k] = std::cos(-2.0 * kPi * k / n);
      wim[k] = std::sin(-2.0 * kPi * k / n);
    }
  }

  void run(double* re, double* im, bool inverse) const {
    for (int i = 0; i < n; ++i) {
      int j = rev[i];
      if (j > i) {
        std::swap(re[i], re[j]);
        std::swap(im[i], im[j]);
      }
    }
    for (int len = 2; len <= n; len <<= 1) {
      int half = len >> 1;
      int step = n / len;
      for (int start = 0; start < n; start += len) {
        for (int k = 0; k < half; ++k) {
          double tw_re = wre[k * step];
          double tw_im = inverse ? -wim[k * step] : wim[k * step];
          int a = start + k, b = start + k + half;
          double xr = re[b] * tw_re - im[b] * tw_im;
          double xi = re[b] * tw_im + im[b] * tw_re;
          re[b] = re[a] - xr;
          im[b] = im[a] - xi;
          re[a] += xr;
          im[a] += xi;
        }
      }
    }
    if (inverse) {
      double inv = 1.0 / n;
      for (int i = 0; i < n; ++i) {
        re[i] *= inv;
        im[i] *= inv;
      }
    }
  }
};

// xorshift RNG for the noise excitation (deterministic, seedable).
struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
  double normal() {
    // Sum of 4 uniforms, mean 0 var ~1/3*4 -> scale to unit-ish variance.
    double acc = 0.0;
    for (int i = 0; i < 4; ++i) {
      s ^= s << 13;
      s ^= s >> 7;
      s ^= s << 17;
      acc += (double)(s >> 11) * (1.0 / 9007199254740992.0) - 0.5;
    }
    return acc * 1.732;  // approx unit variance
  }
};

// Minimum-phase complex spectrum from a power envelope (one frame).
// power: K bins. Outputs h_re/h_im with K bins. Uses scratch of size n=2(K-1).
void MinimumPhase(const double* power, int num_bins, const FFTPlan& plan,
                  double* scratch_re, double* scratch_im,
                  double* h_re, double* h_im) {
  int n = plan.n;
  // log-amplitude, even extension.
  for (int k = 0; k < num_bins; ++k) {
    double p = power[k] > 1e-100 ? power[k] : 1e-100;
    scratch_re[k] = 0.5 * std::log(p);
    scratch_im[k] = 0.0;
  }
  for (int k = num_bins; k < n; ++k) {
    scratch_re[k] = scratch_re[n - k];
    scratch_im[k] = 0.0;
  }
  // Real cepstrum (inverse FFT of the even-real spectrum).
  plan.run(scratch_re, scratch_im, /*inverse=*/true);
  // Fold anticausal onto causal.
  for (int k = 1; k < n / 2; ++k) scratch_re[k] *= 2.0;
  for (int k = n / 2 + 1; k < n; ++k) scratch_re[k] = 0.0;
  for (int k = 0; k < n; ++k) scratch_im[k] = 0.0;
  // FFT -> complex log spectrum -> exp.
  plan.run(scratch_re, scratch_im, /*inverse=*/false);
  for (int k = 0; k < num_bins; ++k) {
    double mag = std::exp(scratch_re[k]);
    h_re[k] = mag * std::cos(scratch_im[k]);
    h_im[k] = mag * std::sin(scratch_im[k]);
  }
}

}  // namespace

extern "C" {

// ABI version of this library's entry points. Bump whenever a signature
// changes; the ctypes loader refuses to use a library whose version does not
// match (a stale prebuilt .so called through a newer signature would read
// shifted pointer arguments). Version 2 = world_synthesize with the noise
// seed before out/out_capacity.
long long morgana_world_synth_abi() { return 2; }

// Synthesises a waveform. Returns the number of output samples, or -1 on
// unsupported input (caller falls back to the NumPy path).
static long long world_synthesize_impl(
    const double* f0, const double* sp, const double* ap,
    long long num_frames, long long num_bins,
    long long fs, double frame_period, long long seed,
    double* out, long long out_capacity) {
  const int fft_size = (int)(num_bins - 1) * 2;
  if (fft_size <= 0 || (fft_size & (fft_size - 1)) != 0) return -1;  // need pow2
  const int hop = (int)(fs * frame_period / 1000.0);
  // hop <= 0 would make num_samples negative: the capacity check below
  // would pass and std::vector's size_t conversion would throw (or worse).
  if (hop <= 0 || num_frames < 0) return -1;
  const long long num_samples = num_frames * hop;
  if (num_samples < 0 || num_samples > out_capacity) return -1;

  FFTPlan plan(fft_size);

  // --- excitation ---------------------------------------------------------
  std::vector<double> periodic_exc(num_samples, 0.0);
  std::vector<double> noise_exc(num_samples);
  XorShift rng((uint64_t)seed + 12345ULL);
  for (long long i = 0; i < num_samples; ++i) noise_exc[i] = rng.normal();

  double phase = 0.0;
  double prev_floor = 0.0;
  for (long long i = 0; i < num_samples; ++i) {
    double f = f0[i / hop];
    if (f > 0.0) {
      phase += f / (double)fs;
      double fl = std::floor(phase);
      if (fl > prev_floor) {
        double amp = std::sqrt(fs / (f > 1.0 ? f : 1.0));
        periodic_exc[i] = amp >= 1.0 ? amp : 1.0;
      }
      prev_floor = fl;
    } else {
      periodic_exc[i] = 0.0;
    }
  }

  // --- per-frame filtering + OLA -------------------------------------------
  const int win_len = std::min(fft_size, 4 * hop);
  std::vector<double> window(win_len);
  for (int i = 0; i < win_len; ++i)
    window[i] = 0.5 - 0.5 * std::cos(2.0 * kPi * i / (win_len - 1));
  double ola_gain = 0.0;
  if (hop < win_len) {
    for (int i = 0; i < win_len; i += hop) ola_gain += window[i];
  } else {
    ola_gain = 1.0;
  }
  if (ola_gain < 1e-12) ola_gain = 1.0;

  std::vector<double> out_acc(num_samples + fft_size, 0.0);

  const int num_threads =
      std::max(1u, std::min(std::thread::hardware_concurrency(), 16u));
  std::vector<std::vector<double>> partials(num_threads);
  std::vector<std::thread> workers;

  // Contiguous frame ranges per thread: each partial accumulator spans only
  // its own range (+ fft_size of overlap), not the whole signal — strided
  // frames would multiply peak memory by num_threads on long utterances.
  const long long frames_per = (num_frames + num_threads - 1) / num_threads;

  // A throw inside a std::thread (e.g. bad_alloc sizing a partial) would
  // std::terminate the process; trap it and fail the call instead.
  std::atomic<bool> failed{false};

  auto work = [&](int tid) {
   try {
    const long long t_begin = (long long)tid * frames_per;
    const long long t_end = std::min(num_frames, t_begin + frames_per);
    if (t_begin >= t_end) return;
    std::vector<double> h_re(num_bins), h_im(num_bins);
    std::vector<double> s_re(fft_size), s_im(fft_size);
    std::vector<double> fr_re(fft_size), fr_im(fft_size);
    std::vector<double> power(num_bins);
    // Hoisted out of the frame loop (like h_re/s_re above): per-frame
    // vector construction is 6 allocator round-trips per frame, contended
    // across threads. y needs a per-frame zero fill (it accumulates +=).
    std::vector<double> y_re(fft_size), y_im(fft_size);
    std::vector<double> g_re(num_bins), g_im(num_bins);
    std::vector<double> tmp_re(fft_size), tmp_im(fft_size);
    std::vector<double>& acc = partials[tid];
    const long long acc_base = t_begin * hop;
    acc.assign((t_end - t_begin) * hop + fft_size, 0.0);

    for (long long t = t_begin; t < t_end; ++t) {
      const double* sp_t = sp + t * num_bins;
      const double* ap_t = ap + t * num_bins;
      long long start = t * hop;

      // Frame both excitations into one complex buffer:
      //   periodic in the real part, noise in the imaginary part.
      for (int i = 0; i < fft_size; ++i) {
        long long idx = start + i;
        double w = (i < win_len) ? window[i] : 0.0;
        fr_re[i] = (idx < num_samples && i < win_len) ? periodic_exc[idx] * w : 0.0;
        fr_im[i] = (idx < num_samples && i < win_len) ? noise_exc[idx] * w : 0.0;
      }
      plan.run(fr_re.data(), fr_im.data(), false);

      // Periodic filter.
      for (int k = 0; k < num_bins; ++k) {
        double a = ap_t[k];
        double v = 1.0 - a * a;
        power[k] = sp_t[k] * (v > 1e-12 ? v : 1e-12);
      }
      MinimumPhase(power.data(), (int)num_bins, plan, s_re.data(), s_im.data(),
                   h_re.data(), h_im.data());

      // Separate the two real signals' spectra from the packed FFT:
      //   P(k) = (F(k) + conj(F(n-k))) / 2 ; N(k) = (F(k) - conj(F(n-k))) / 2i
      std::fill(y_re.begin(), y_re.end(), 0.0);
      std::fill(y_im.begin(), y_im.end(), 0.0);
      for (int k = 0; k < num_bins; ++k) {
        int km = (fft_size - k) % fft_size;
        double pr = 0.5 * (fr_re[k] + fr_re[km]);
        double pi = 0.5 * (fr_im[k] - fr_im[km]);
        double nr = 0.5 * (fr_im[k] + fr_im[km]);
        double ni = -0.5 * (fr_re[k] - fr_re[km]);
        // periodic * h_per
        double ar = pr * h_re[k] - pi * h_im[k];
        double ai = pr * h_im[k] + pi * h_re[k];
        y_re[k] += ar;
        y_im[k] += ai;
        if (k != 0 && k != fft_size / 2) {
          y_re[km] += ar;
          y_im[km] -= ai;
        }
        // stash noise spectrum for the second filter in s_re/s_im
        s_re[k] = nr;
        s_im[k] = ni;
      }
      // Aperiodic filter.
      for (int k = 0; k < num_bins; ++k) {
        double a = ap_t[k];
        power[k] = sp_t[k] * (a * a > 1e-12 ? a * a : 1e-12);
      }
      MinimumPhase(power.data(), (int)num_bins, plan, tmp_re.data(),
                   tmp_im.data(), g_re.data(), g_im.data());
      for (int k = 0; k < num_bins; ++k) {
        int km = (fft_size - k) % fft_size;
        double br = s_re[k] * g_re[k] - s_im[k] * g_im[k];
        double bi = s_re[k] * g_im[k] + s_im[k] * g_re[k];
        y_re[k] += br;
        y_im[k] += bi;
        if (k != 0 && k != fft_size / 2) {
          y_re[km] += br;
          y_im[km] -= bi;
        }
      }

      plan.run(y_re.data(), y_im.data(), true);
      for (int i = 0; i < fft_size; ++i) acc[start - acc_base + i] += y_re[i];
    }
   } catch (...) {
    failed.store(true);
   }
  };

  for (int tid = 0; tid < num_threads; ++tid) workers.emplace_back(work, tid);
  for (auto& th : workers) th.join();
  if (failed.load()) return -1;
  for (int tid = 0; tid < num_threads; ++tid) {
    const long long base = (long long)tid * frames_per * hop;
    for (long long i = 0; i < (long long)partials[tid].size(); ++i)
      out_acc[base + i] += partials[tid][i];
  }

  double peak = 0.0;
  for (long long i = 0; i < num_samples; ++i) {
    out_acc[i] /= ola_gain;
    peak = std::max(peak, std::fabs(out_acc[i]));
  }
  double scale = peak > 1e-12 && peak > 0.9 ? 0.9 / peak : 1.0;
  for (long long i = 0; i < num_samples; ++i) out[i] = out_acc[i] * scale;
  return num_samples;
}

// C-ABI entry point: exceptions must not cross the extern "C" boundary —
// an escaping std::bad_alloc/length_error would std::terminate the whole
// host process instead of letting the caller fall back to the NumPy path.
long long world_synthesize(const double* f0, const double* sp, const double* ap,
                           long long num_frames, long long num_bins,
                           long long fs, double frame_period, long long seed,
                           double* out, long long out_capacity) {
  try {
    return world_synthesize_impl(f0, sp, ap, num_frames, num_bins, fs,
                                 frame_period, seed, out, out_capacity);
  } catch (...) {
    return -1;
  }
}

}  // extern "C"
