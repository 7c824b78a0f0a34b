// K1: one LSTM layer, forward, as one persistent launch on Hopper (sm_90a).
//
// Replaces morgana_tpu/ops/pallas_rnn.py::_lstm_fwd_kernel (driven there by
// _fwd_call), with its storage type (K1s, pallas_rnn.py::_store_dtype). Same
// function: with gates ordered i, f, g, o,
//
//     gates_t = xg_t + round(h_{t-1}) @ w_hh
//     c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//     h_t = sigmoid(o) * tanh(c_t)
//
// over the whole padded time axis, with h and c carried in f32 and round()
// the rounding to the storage type Store (none for f32, bf16 under
// MORGANA_PALLAS_STORE=bfloat16). Inputs: xg (T, B, 4H) and w_hh (H, 4H) in
// Store, h0 and c0 (B, H) in f32. Outputs: y = h trace and c_all = c trace
// (T, B, H) in Store, hn and cn (B, H) in f32 from the carried state. When
// g_all is given (training), the kernel also writes the activated gates i,
// f, g, o of every step, (T, B, 4H) in Store, which only its backward K2
// (lstm_bwd.cu) reads: a template flag, not a runtime branch. Masking past
// seq_len and the final-state gather happen outside (ops/lstm.py).
//
// What bounds it. 2*B*H*4H flops a step and only a (B, H) vector from the
// previous step: at serving shapes the step-to-step latency, not the
// card's rates (PERF.md §6-7).
//
// Design (lstm_common.cuh has the split over the blocks: 128 of U = H / 128
// units at H >= 128). Block j keeps its (H, 4U) slice of w_hh in registers:
// warp w reduces the rows k of [w H/8, (w+1) H/8), lane (cslice, klane) =
// (lane % 4, lane / 4) holds the H/64 rows from w H/8 + klane H/64 of the U
// columns of gate cslice. A step:
//   exchange   each warp copies its H/8 columns of h_{t-1} (rows of y[t-1],
//              which every block wrote) into its own part of shared memory
//              with cp.async through L2 (h0, rounded, at t = 0); no block
//              barrier, as no other warp reads them;
//   product    each lane multiplies its rows into the U partial sums of its
//              columns, kRows batch rows at a time (their chains interleave),
//              and three shuffle levels reduce over the 8 klanes, leaving
//              every lane one column's sum (two lanes each) for the warp's
//              partial in shared memory;
//   reduction  gate item (row, unit, gate) on its own thread sums the 8
//              warps' partials and adds xg, loaded a step ahead;
//   gates      the item's activation (exp2-based, lstm_common.cuh); the
//              pair's four gates meet by shuffles in four neighbouring lanes,
//              and the gate-0 lane updates c and h and stores y, c_all (and
//              each lane its g_all);
//   barrier    all blocks meet at grid.sync (lstm_common.cuh) before y[t]
//              is read.
// Batch rows go through the product in tiles of kTile rows, so any B up to
// 256 fits shared memory (the staged h is (kTile, H) in Store). H is 64,
// 128, 256, 512 or 1024; the wrapper pads other widths to the next of them.

#include "lstm_common.cuh"

namespace {

using lstm::kThreads;
using lstm::kWarps;

constexpr int kTile = 32;  // batch rows a pass of the product

template <int H, typename Store>
struct Fwd {
  using S = lstm::Split<H, 128>;
  static constexpr int U = S::U;
  static constexpr int kCols = S::kCols;
  static constexpr int KW = H / kWarps;  // rows of w_hh a warp reduces
  static constexpr int KPL = KW / 8;     // of them a lane's
  // Batch rows a lane's product handles at once (their chains interleave);
  // fewer at U = 8, whose slice of w_hh takes 128 registers.
  static constexpr int kRows = U >= 8 ? 4 : 8;
  static constexpr int kRounds = (4 * U * kTile + kThreads - 1) / kThreads;  // gate items a thread a tile
  // Lanes that hold the same column sum after klane_sum (the shuffle levels
  // that added rather than split).
  static constexpr int kDup = U >= 8 ? 0 : (U == 4 ? 4 : (U == 2 ? 12 : 28));
  // Shared memory, bytes: stage [kWarps][kTile][KW] Store, red [kWarps][kTile][kCols]
  // f32, then cs, hs [B * U] f32 (the block's c and h, pair p = row * U + unit).
  static size_t smem(int B) {
    return size_t(kWarps) * kTile * KW * sizeof(Store) + size_t(kWarps) * kTile * kCols * 4 +
           2 * size_t(B) * U * 4;
  }
};

// Sums v over the 8 klanes of a column slice (lanes 4 apart): the levels by
// 16 and 8 split the N sums between the lanes while they add, and the rest
// add; returns the sum of index `which` of v that this lane ends with.
template <int N>
__device__ __forceinline__ float klane_sum(float (&v)[N], int lane, int& which) {
  which = 0;
  int n = N;
#pragma unroll
  for (int mask = 16; mask >= 4; mask >>= 1) {
    if (n > 1) {
      const int half = n / 2;
      const bool upper = (lane & mask) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        if (i < half) {
          const float send = upper ? v[i] : v[half + i];
          const float keep = upper ? v[half + i] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
        }
      }
      which = 2 * which + (upper ? 1 : 0);
      n = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], mask);
    }
  }
  return v[0];
}

// xg of this thread's gate items of rows b0 .. b0 + bt - 1 of step t: item i
// is row i / 4U, unit (i / 4) % U, gate i % 4.
template <int H, typename Store>
__device__ __forceinline__ void load_x(float (&x)[Fwd<H, Store>::kRounds], const Store* xg, int t,
                                       int B, int b0, int bt, int u0) {
  constexpr int U = Fwd<H, Store>::U;
#pragma unroll
  for (int r = 0; r < Fwd<H, Store>::kRounds; ++r) {
    const int i = b0 * 4 * U + r * kThreads + int(threadIdx.x);
    if (i < (b0 + bt) * 4 * U)
      x[r] = lstm::to_f32(xg[(size_t(t) * B + i / (4 * U)) * 4 * H + (i % 4) * H + u0 + (i / 4) % U]);
  }
}

template <int H, typename Store, bool kGates, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const Store* __restrict__ xg, const Store* __restrict__ w_hh,
                const float* __restrict__ h0, const float* __restrict__ c0, Store* y,
                Store* __restrict__ c_all, Store* __restrict__ g_all, float* __restrict__ hn,
                float* __restrict__ cn, int T, int B, long long* split, int split_steps) {
  using F = Fwd<H, Store>;
  constexpr int U = F::U, kCols = F::kCols, KW = F::KW, KPL = F::KPL, kRows = F::kRows, G = 4 * H;
  lstm::StepClock<kSplit> clock(split, split_steps);
  extern __shared__ float4 smem4[];
  Store* stage = reinterpret_cast<Store*>(smem4);
  float* red = reinterpret_cast<float*>(stage + kWarps * kTile * KW);
  float* cs = red + kWarps * kTile * kCols;
  float* hs = cs + B * U;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cslice = lane % 4, klane = lane / 4;
  const int u0 = blockIdx.x * U;
  const int k0 = warp * KW + klane * KPL;  // the lane's first row of w_hh
  Store* my_stage = stage + warp * kTile * KW;

  float w[KPL][U];
#pragma unroll
  for (int kk = 0; kk < KPL; ++kk)
#pragma unroll
    for (int j = 0; j < U; ++j) w[kk][j] = lstm::to_f32(w_hh[size_t(k0 + kk) * G + cslice * H + u0 + j]);
  for (int p = tid; p < B * U; p += kThreads) {
    const size_t at = size_t(p / U) * H + u0 + p % U;
    cs[p] = c0[at];
    hs[p] = h0[at];
  }
  __syncthreads();

  const int tiles = (B + kTile - 1) / kTile;
  float x[F::kRounds];
  if (T > 0) load_x<H, Store>(x, xg, 0, B, 0, min(B, kTile), u0);
  for (int t = 0; t < T; ++t) {
    clock.begin();
    for (int tile = 0; tile < tiles; ++tile) {
      const int b0 = tile * kTile, bt = min(kTile, B - b0);
      if (t == 0) {
        for (int q = lane; q < bt * KW; q += 32)
          my_stage[q] = lstm::from_f32<Store>(h0[size_t(b0 + q / KW) * H + warp * KW + q % KW]);
      } else {
        constexpr int kPer = 16 / int(sizeof(Store)), kChunks = KW / kPer;  // 16-byte chunks a row
        const Store* src = y + (size_t(t - 1) * B + b0) * H + warp * KW;
        for (int q = lane; q < bt * kChunks; q += 32)
          lstm::cp_async16(my_stage + (q / kChunks) * KW + (q % kChunks) * kPer,
                           src + size_t(q / kChunks) * H + (q % kChunks) * kPer);
        lstm::cp_async_wait_all();
      }
      __syncwarp();
      clock.mark(lstm::kExchange);

      // kRows rows at a time, whose chains interleave; rows past the tile
      // repeat its last row and store nothing.
      for (int b1 = 0; b1 < bt; b1 += kRows) {
        float acc[kRows][U];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float hv[KPL];
          lstm::load_f32<KPL>(my_stage + min(b1 + r, bt - 1) * KW + klane * KPL, hv);
#pragma unroll
          for (int j = 0; j < U; ++j) acc[r][j] = 0.f;
#pragma unroll
          for (int kk = 0; kk < KPL; ++kk)
#pragma unroll
            for (int j = 0; j < U; ++j) acc[r][j] = fmaf(hv[kk], w[kk][j], acc[r][j]);
        }
        int which;
        float s[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) s[r] = klane_sum<U>(acc[r], lane, which);
        if ((lane & F::kDup) == 0) {
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (b1 + r < bt) red[(warp * kTile + b1 + r) * kCols + cslice * U + which] = s[r];
        }
      }
      __syncthreads();
      clock.mark(lstm::kProduct);

      float sum[F::kRounds];
#pragma unroll
      for (int r = 0; r < F::kRounds; ++r) {
        const int i = b0 * 4 * U + r * kThreads + tid;
        sum[r] = 0.f;
        if (i < (b0 + bt) * 4 * U) {
          const float* col = red + (i / (4 * U) - b0) * kCols + (i % 4) * U + (i / 4) % U;
          float s = x[r];
#pragma unroll
          for (int q = 0; q < kWarps; ++q) s += col[q * kTile * kCols];
          sum[r] = s;
        }
      }
      clock.mark(lstm::kReduction);

      // The item's activation; the pair's four gates meet in its gate-0
      // lane (items i .. i + 3 sit in lanes 4k .. 4k + 3).
      float act[F::kRounds], gate[F::kRounds][4];
      const int g = tid % 4;
#pragma unroll
      for (int r = 0; r < F::kRounds; ++r)
        act[r] = g == 2 ? lstm::tanh_fast(sum[r]) : lstm::sigmoid_fast(sum[r]);
#pragma unroll
      for (int r = 0; r < F::kRounds; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) gate[r][q] = __shfl_sync(0xffffffffu, act[r], (lane & ~3) + q);
#pragma unroll
      for (int r = 0; r < F::kRounds; ++r) {
        const int i = b0 * 4 * U + r * kThreads + tid;
        if (i >= (b0 + bt) * 4 * U) continue;
        const int b = i / (4 * U), j = (i / 4) % U;
        if (g == 0) {
          const int p = b * U + j;
          const float c = gate[r][1] * cs[p] + gate[r][0] * gate[r][2];
          const float h = gate[r][3] * lstm::tanh_fast(c);
          cs[p] = c;
          hs[p] = h;
          const size_t out = (size_t(t) * B + b) * H + u0 + j;
          y[out] = lstm::from_f32<Store>(h);
          c_all[out] = lstm::from_f32<Store>(c);
        }
        if constexpr (kGates) g_all[(size_t(t) * B + b) * G + g * H + u0 + j] = lstm::from_f32<Store>(act[r]);
      }
      // xg of the next tile, or of the next step's first: it lands while
      // the barrier and the next exchange and product run.
      if (tile + 1 < tiles)
        load_x<H, Store>(x, xg, t, B, b0 + kTile, min(kTile, B - b0 - kTile), u0);
      else if (t + 1 < T)
        load_x<H, Store>(x, xg, t + 1, B, 0, min(B, kTile), u0);
      clock.mark(lstm::kGates);
      if (tile + 1 < tiles) __syncthreads();  // the next tile rewrites red
    }
    // Publishes y[t] to every block before any block stages it; also the
    // block barrier before red is rewritten.
    if (t + 1 < T) lstm::grid_barrier();
    clock.mark(lstm::kBarrierWait);
    clock.end_step(t);
  }
  clock.finish();
  __syncthreads();
  for (int p = tid; p < B * U; p += kThreads) {
    const size_t at = size_t(p / U) * H + u0 + p % U;
    hn[at] = hs[p];
    cn[at] = cs[p];
  }
}

template <int H, typename Store, bool kSplit>
int run(const void* xg, const void* w_hh, const float* h0, const float* c0, void* y, void* c_all,
        void* g_all, float* hn, float* cn, int T, int B, int device, cudaStream_t stream,
        long long* split, int split_steps) {
  const size_t smem = Fwd<H, Store>::smem(B);
  const auto* x = static_cast<const Store*>(xg);
  const auto* w = static_cast<const Store*>(w_hh);
  auto* ys = static_cast<Store*>(y);
  auto* cs = static_cast<Store*>(c_all);
  auto* gs = static_cast<Store*>(g_all);
  if (g_all != nullptr)
    return lstm::launch(lstm_fwd_kernel<H, Store, true, kSplit>, Fwd<H, Store>::S::kBlocks, smem,
                        device, stream, x, w, h0, c0, ys, cs, gs, hn, cn, T, B, split,
                        split_steps);
  return lstm::launch(lstm_fwd_kernel<H, Store, false, kSplit>, Fwd<H, Store>::S::kBlocks, smem,
                      device, stream, x, w, h0, c0, ys, cs, gs, hn, cn, T, B, split, split_steps);
}

template <bool kSplit>
int dispatch(const void* xg, const void* w_hh, const float* h0, const float* c0, void* y,
             void* c_all, void* g_all, float* hn, float* cn, int T, int B, int H, int bf16,
             int device, void* stream, long long* split, int split_steps) {
  if (T < 0 || B < 1 || B > lstm::kMaxBatch) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K1_RUN(HH, STORE)                                                                     \
  return run<HH, STORE, kSplit>(xg, w_hh, h0, c0, y, c_all, g_all, hn, cn, T, B, device, s, \
                                split, split_steps)
#define K1_H(HH)                         \
  case HH:                               \
    if (bf16) K1_RUN(HH, __nv_bfloat16); \
    K1_RUN(HH, float);
  switch (H) {
    K1_H(64)
    K1_H(128)
    K1_H(256)
    K1_H(512)
    K1_H(1024)
  }
#undef K1_H
#undef K1_RUN
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches K1 on `stream` (a cudaStream_t) of `device`; returns a cudaError_t
// (0 on success). Pointers are device pointers to contiguous arrays: xg,
// w_hh, y, c_all and g_all in bf16 when `bf16` is non-zero, else f32, with
// g_all null when the gate trace is not written; h0, c0, hn and cn in f32.
// H is 64, 128, 256, 512 or 1024 and B at most 256.
int morgana_lstm_fwd(const void* xg, const void* w_hh, const float* h0, const float* c0, void* y,
                     void* c_all, void* g_all, float* hn, float* cn, int T, int B, int H,
                     int bf16, int device, void* stream) {
  return dispatch<false>(xg, w_hh, h0, c0, y, c_all, g_all, hn, cn, T, B, H, bf16, device,
                         stream, nullptr, 0);
}

#ifdef MORGANA_STEP_SPLIT
// As morgana_lstm_fwd, recording the phases of the first split_steps steps
// into split (two records of lstm::split_record(split_steps) entries).
int morgana_lstm_fwd_split(const void* xg, const void* w_hh, const float* h0, const float* c0,
                           void* y, void* c_all, void* g_all, float* hn, float* cn, int T, int B,
                           int H, int bf16, int device, void* stream, long long* split,
                           int split_steps) {
  return dispatch<true>(xg, w_hh, h0, c0, y, c_all, g_all, hn, cn, T, B, H, bf16, device, stream,
                        split, split_steps);
}
#endif

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
