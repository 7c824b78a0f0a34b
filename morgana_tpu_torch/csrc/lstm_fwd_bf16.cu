// K1c: one LSTM layer's recurrence with bf16 products, forward, as one
// cluster launch on Hopper (sm_90a), with or without its gate trace.
//
// Replaces, as the 'scan' backend's bf16 recurrence (morgana_tpu/ops/rnn.py:
// 113-135 under compute_dtype bfloat16), morgana_tpu/ops/pallas_rnn.py::
// _lstm_fwd_kernel (driven there by _fwd_call) at the widths whose bf16
// w_hh fits one cluster (H = 64, 128, 256, 512); H = 1024 keeps K1c's build
// of csrc/lstm_fwd.cu. Same function as that build: with gates ordered
// i, f, g, o,
//
//     gates_t = xg_t + bf16(h_{t-1}) @ bf16(w_hh)     (f32 sums)
//     c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//     h_t = sigmoid(o) * tanh(c_t)
//
// over the whole padded time axis, h and c carried in f32. Inputs: xg (T,
// B, 4H), w_hh (H, 4H), h0 and c0 (B, H), all f32. Outputs: y = h trace and
// c_all = c trace (T, B, H), with kGates the activated gates g_all (T, B,
// 4H) that K2c (lstm_bwd_bf16.cu) reads, and hn, cn (B, H), all f32.
//
// What bounds it. 2*B*H*4H flops a step on the bf16 tensor cores and only
// a (B, H) vector from the step before: the step-to-step latency (PERF.md
// §6-7). K1c's build of lstm_fwd.cu spent it on 128 blocks of f32 FMAs on
// rounded values and a grid.sync a step.
//
// Design (lstm_cluster.cuh has the split: clusters of H / 32 CTAs of 32
// units, kRows = 8 NT batch rows a cluster). CTA r keeps the bf16 A
// fragments of its (128 columns, H) slice of w_hh^T in registers: warp w
// owns the gate columns 16w .. 16w + 15 (an m16 tile) over the whole depth
// H, 4 H / 16 registers a thread. Every CTA holds the whole bf16 h_{t-1} of
// its cluster's rows in shared memory, in two buffers. A step:
//   product   per n8 tile of batch rows, H / 16 mma.sync.m16n8k16 (bf16 in,
//             f32 sums; B fragments by ldmatrix from the staged h, which
//             is h rounded to bf16 once, when its owner published it), in
//             two accumulator chains (even and odd k-steps) added at the
//             end, into the gate sums in shared memory;
//   gates     thread (row, unit) adds xg (brought in kRing - 1 steps ahead
//             by cp.async) to its four gate sums, activates them (exp2
//             based, lstm_common.cuh), updates c and h in registers and
//             stages bf16(h) for the hand-over;
//   exchange  the CTA's 32 units of bf16(h_t), 64 bytes a row, go into the
//             other buffer of every CTA of the cluster (DSMEM, 16-byte
//             stores);
//   barrier   arrive at the cluster barrier (release); y, c_all and the
//             gate trace are stored and the next xg is put in flight while
//             the others arrive; wait (acquire).
// Rows past B carry zeros (xg zero-filled, h0 and c0 0) and store nothing.
// No step waits for anything outside its cluster.

#include "lstm_cluster.cuh"

namespace {

using lstmc::kCols;
using lstmc::kRing;
using lstmc::kUnits;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // warp w: the m16 tile of gate columns 16w ..

template <int H, int NT>
struct Fwd {
  static constexpr int kCtas = lstmc::Width<H>::kCtas;
  static constexpr int kRows = 8 * NT;       // batch rows a cluster
  static constexpr int kSteps = H / 16;      // k-steps of the product
  static constexpr int kHStride = H + 8;     // bf16; 16 bytes mod 128: ldmatrix conflict-free
  static constexpr int kGStride = kCols + 4; // f32; the fragment stores conflict-free
  static constexpr int kItems = kRows * kUnits / kThreads;  // (row, unit) items a thread
  // Shared memory, bytes: h [2][kRows][kHStride] bf16, the xg ring
  // [kRing][kRows][kCols] f32, the gate sums [kRows][kGStride] f32, the
  // staged bf16(h_t) [kRows][kUnits].
  static constexpr size_t kHBytes = size_t(2) * kRows * kHStride * 2;
  static constexpr size_t kRingBytes = size_t(kRing) * kRows * kCols * 4;
  static constexpr size_t kSumBytes = size_t(kRows) * kGStride * 4;
  static constexpr size_t kOutBytes = size_t(kRows) * kUnits * 2;
  static constexpr size_t kSmem = kHBytes + kRingBytes + kSumBytes + kOutBytes;
  static_assert(kSteps % 2 == 0 && kItems >= 1, "shape");
};

// Step t's xg of the cluster's rows b0 .. b0 + kRows - 1 and the CTA's
// columns into ring slot `slot` ([row][gate][unit]), rows past B as zeros;
// committed as one group even when t is past T.
template <int H, int NT>
__device__ __forceinline__ void fetch_xg(float* slot, const float* __restrict__ xg, int t, int T,
                                         int B, int b0, int u0) {
  using F = Fwd<H, NT>;
  if (t < T) {
    for (int q = threadIdx.x; q < F::kRows * 4 * (kUnits / 4); q += kThreads) {
      const int row = q / (4 * (kUnits / 4)), gate = (q / (kUnits / 4)) % 4, v = q % (kUnits / 4);
      const bool valid = b0 + row < B;
      const float* src = xg + (size_t(t) * B + (valid ? b0 + row : 0)) * 4 * H + gate * H + u0 + 4 * v;
      attn::cp_async16(slot + row * kCols + gate * kUnits + 4 * v, src, valid);
    }
  }
  attn::cp_async_commit();
}

template <int H, int NT, bool kGates, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_bf16_kernel(const float* __restrict__ xg, const float* __restrict__ w_hh,
                     const float* __restrict__ h0, const float* __restrict__ c0,
                     float* __restrict__ y, float* __restrict__ c_all, float* __restrict__ g_all,
                     float* __restrict__ hn, float* __restrict__ cn, int T, int B,
                     long long* split, int split_steps) {
  using F = Fwd<H, NT>;
  constexpr int kCtas = F::kCtas, kRows = F::kRows, G = 4 * H;
  lstm::StepClock<kSplit> clock(split, split_steps);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ring = reinterpret_cast<float*>(smem + F::kHBytes);
  float* gsum = ring + kRing * kRows * kCols;
  __nv_bfloat16* hout = reinterpret_cast<__nv_bfloat16*>(gsum + kRows * F::kGStride);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rank = lstmc::cluster_rank();
  const int u0 = rank * kUnits, b0 = int(blockIdx.x) / kCtas * kRows;

  // The prologue's loads first: the ring's first kRing - 1 steps.
  for (int s = 0; s < kRing - 1; ++s)
    fetch_xg<H, NT>(ring + s * kRows * kCols, xg, s, T, B, b0, u0);

  // A fragments of w_hh^T: rows m = 16 warp + g (+ 8) are the CTA's gate
  // columns (gate m / 32, unit u0 + m % 32), columns the depth k.
  uint32_t a[F::kSteps][4];
  {
    const int m = 16 * warp + g;
    const float* lo = w_hh + (m / kUnits) * H + u0 + m % kUnits;
    const float* hi = w_hh + ((m + 8) / kUnits) * H + u0 + (m + 8) % kUnits;
#pragma unroll
    for (int kk = 0; kk < F::kSteps; ++kk) {
      const size_t k = size_t(16 * kk + 2 * t4) * G;
      a[kk][0] = attn::pack_bf16(lo[k], lo[k + G]);
      a[kk][1] = attn::pack_bf16(hi[k], hi[k + G]);
      a[kk][2] = attn::pack_bf16(lo[k + 8 * G], lo[k + 9 * G]);
      a[kk][3] = attn::pack_bf16(hi[k + 8 * G], hi[k + 9 * G]);
    }
  }
  // bf16(h0) of the cluster's rows, whole, into buffer 0; rows past B 0.
  for (int q = tid; q < kRows * H; q += kThreads) {
    const int row = q / H, k = q % H;
    hbuf[row * F::kHStride + k] =
        __float2bfloat16_rn(b0 + row < B ? h0[size_t(b0 + row) * H + k] : 0.f);
  }
  // The thread's items (row, unit) = (tid / 32 + 8 i, lane): c and h in f32.
  float c[F::kItems], h[F::kItems];
#pragma unroll
  for (int i = 0; i < F::kItems; ++i) {
    const int b = b0 + warp + kWarps * i;
    c[i] = b < B ? c0[size_t(b) * H + u0 + lane] : 0.f;
    h[i] = b < B ? h0[size_t(b) * H + u0 + lane] : 0.f;
  }
  attn::cp_async_wait<kRing - 2>();  // step 0's xg
  // Every CTA of the cluster has started (before any DSMEM store) and
  // every thread's part of the ring and of h is visible.
  lstmc::cluster_arrive();
  lstmc::cluster_wait();

  for (int t = 0; t < T; ++t) {
    clock.begin();
    const __nv_bfloat16* hb = hbuf + (t & 1) * kRows * F::kHStride;
    const float* xs = ring + (t % kRing) * kRows * kCols;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float acc[2][4] = {};
      const __nv_bfloat16* rows = hb + (nt * 8 + (lane & 7)) * F::kHStride + (lane >> 3) * 8;
#pragma unroll
      for (int kk = 0; kk < F::kSteps; kk += 2) {
        uint32_t r[4];
        attn::ldmatrix_x4(r, rows + 16 * kk);
        attn::mma_bf16(acc[0], a[kk], r[0], r[1]);
        attn::mma_bf16(acc[1], a[kk + 1], r[2], r[3]);
      }
      // C: rows (gate columns) 16 warp + g, + 8; columns (batch rows)
      // nt * 8 + 2 t4, + 1.
      float* out = gsum + (nt * 8 + 2 * t4) * F::kGStride + 16 * warp + g;
      out[0] = acc[0][0] + acc[1][0];
      out[F::kGStride] = acc[0][1] + acc[1][1];
      out[8] = acc[0][2] + acc[1][2];
      out[F::kGStride + 8] = acc[0][3] + acc[1][3];
    }
    __syncthreads();
    clock.mark(lstm::kProduct);

    float act[F::kItems][4];
#pragma unroll
    for (int i = 0; i < F::kItems; ++i) {
      const int row = warp + kWarps * i;
      const float* sum = gsum + row * F::kGStride + lane;
      const float* x = xs + row * kCols + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = sum[q * kUnits] + x[q * kUnits];
        act[i][q] = q == 2 ? lstm::tanh_fast(v) : lstm::sigmoid_fast(v);
      }
      c[i] = act[i][1] * c[i] + act[i][0] * act[i][2];
      h[i] = act[i][3] * lstm::tanh_fast(c[i]);
      hout[row * kUnits + lane] = __float2bfloat16_rn(h[i]);
    }
    __syncthreads();
    clock.mark(lstm::kGates);

    const bool more = t + 1 < T;
    if (more) {
      __nv_bfloat16* next = hbuf + ((t + 1) & 1) * kRows * F::kHStride;
      lstmc::publish(kCtas, kRows * (kUnits / 8), kThreads,
                     [&](int, int q) { return hout + q * 8; },
                     [&](int, int q) { return next + (q / 4) * F::kHStride + u0 + (q % 4) * 8; });
      attn::cp_async_wait<kRing - 3>();  // step t + 1's xg
    }
    clock.mark(lstm::kExchange);
    if (more) lstmc::cluster_arrive();
#pragma unroll
    for (int i = 0; i < F::kItems; ++i) {
      const int b = b0 + warp + kWarps * i;
      if (b < B) {
        const size_t at = (size_t(t) * B + b) * H + u0 + lane;
        y[at] = h[i];
        c_all[at] = c[i];
        if constexpr (kGates) {
          float* gp = g_all + (size_t(t) * B + b) * G + u0 + lane;
#pragma unroll
          for (int q = 0; q < 4; ++q) gp[q * H] = act[i][q];
        }
      }
    }
    fetch_xg<H, NT>(ring + ((t + kRing - 1) % kRing) * kRows * kCols, xg, t + kRing - 1, T, B,
                    b0, u0);
    if (more) lstmc::cluster_wait();
    clock.mark(lstm::kBarrierWait);
    clock.end_step(t);
  }
  clock.finish();
  attn::cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < F::kItems; ++i) {
    const int b = b0 + warp + kWarps * i;
    if (b < B) {
      hn[size_t(b) * H + u0 + lane] = h[i];
      cn[size_t(b) * H + u0 + lane] = c[i];
    }
  }
}

template <int H, int NT, bool kGates, bool kSplit>
cudaError_t fit(int device, int& clusters) {
  static int cached[lstmc::kMaxDevices] = {};
  return lstmc::fit(lstm_fwd_bf16_kernel<H, NT, kGates, kSplit>, Fwd<H, NT>::kCtas, kThreads,
                    Fwd<H, NT>::kSmem, device, clusters, cached);
}

constexpr int kTiles[] = {1, 2, 4};  // the NT a launch may take

template <int H, bool kGates, bool kSplit>
cudaError_t fits(int device, int (&out)[3]) {
  cudaError_t err = fit<H, 1, kGates, kSplit>(device, out[0]);
  if (err == cudaSuccess) err = fit<H, 2, kGates, kSplit>(device, out[1]);
  if (err == cudaSuccess) err = fit<H, 4, kGates, kSplit>(device, out[2]);
  return err;
}

template <int H, bool kGates, bool kSplit>
int run(const float* xg, const float* w_hh, const float* h0, const float* c0, float* y,
        float* c_all, float* g_all, float* hn, float* cn, int T, int B, int device,
        cudaStream_t stream, long long* split, int split_steps, int* plan_out) {
  int f[3];
  cudaError_t err = fits<H, kGates, kSplit>(device, f);
  if (err != cudaSuccess) return err;
  const int pick = lstmc::plan(B, kTiles, f, 3);
  if (f[pick] < 1) return cudaErrorInvalidConfiguration;
  const int nt = kTiles[pick], clusters = (B + 8 * nt - 1) / (8 * nt);
  if (plan_out != nullptr) {
    plan_out[0] = nt;
    plan_out[1] = clusters;
    plan_out[2] = f[pick];
    return cudaSuccess;
  }
#define K1C_LAUNCH(NT)                                                                        \
  return lstmc::launch(lstm_fwd_bf16_kernel<H, NT, kGates, kSplit>, Fwd<H, NT>::kCtas,        \
                       clusters, kThreads, Fwd<H, NT>::kSmem, stream, xg, w_hh, h0, c0, y,    \
                       c_all, g_all, hn, cn, T, B, split, split_steps)
  if (nt == 1) K1C_LAUNCH(1);
  if (nt == 2) K1C_LAUNCH(2);
  K1C_LAUNCH(4);
#undef K1C_LAUNCH
}

template <bool kSplit>
int dispatch(const float* xg, const float* w_hh, const float* h0, const float* c0, float* y,
             float* c_all, float* g_all, float* hn, float* cn, int T, int B, int H, int gates,
             int device, void* stream, long long* split, int split_steps, int* plan_out) {
  if (T < 0 || B < 1 || B > lstm::kMaxBatch) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K1C_H(HH)                                                                          \
  case HH:                                                                                 \
    if (gates)                                                                             \
      return run<HH, true, kSplit>(xg, w_hh, h0, c0, y, c_all, g_all, hn, cn, T, B, device, \
                                   s, split, split_steps, plan_out);                       \
    return run<HH, false, kSplit>(xg, w_hh, h0, c0, y, c_all, g_all, hn, cn, T, B, device,  \
                                  s, split, split_steps, plan_out);
  switch (H) {
    K1C_H(64)
    K1C_H(128)
    K1C_H(256)
    K1C_H(512)
  }
#undef K1C_H
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches K1c on `stream` (a cudaStream_t) of `device`; returns a
// cudaError_t (0 on success). Pointers are device pointers to contiguous f32
// arrays; g_all is written when `gates` is non-zero (null otherwise). H is
// 64, 128, 256 or 512 and B at most 256.
int morgana_lstm_fwd_bf16(const float* xg, const float* w_hh, const float* h0, const float* c0,
                          float* y, float* c_all, float* g_all, float* hn, float* cn, int T,
                          int B, int H, int gates, int device, void* stream) {
  return dispatch<false>(xg, w_hh, h0, c0, y, c_all, g_all, hn, cn, T, B, H, gates, device,
                         stream, nullptr, 0, nullptr);
}

// What a launch at (B, H, gates) would take, launching nothing: out[0] the
// n8 tiles of batch rows a cluster, out[1] the clusters, out[2] how many of
// them fit at once (cudaOccupancyMaxActiveClusters).
int morgana_lstm_fwd_bf16_plan(int B, int H, int gates, int device, int* out) {
  return dispatch<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, 0, B, H, gates, device, nullptr, nullptr, 0, out);
}

#ifdef MORGANA_STEP_SPLIT
// As morgana_lstm_fwd_bf16, recording the phases of the first split_steps
// steps into split (two records of lstm::split_record(split_steps) entries:
// CTA 0 and the middle CTA of the grid).
int morgana_lstm_fwd_bf16_split(const float* xg, const float* w_hh, const float* h0,
                                const float* c0, float* y, float* c_all, float* g_all, float* hn,
                                float* cn, int T, int B, int H, int gates, int device,
                                void* stream, long long* split, int split_steps) {
  return dispatch<true>(xg, w_hh, h0, c0, y, c_all, g_all, hn, cn, T, B, H, gates, device,
                        stream, split, split_steps, nullptr);
}
#endif

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
