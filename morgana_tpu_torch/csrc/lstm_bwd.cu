// K2: one LSTM layer, backward through time, as one persistent launch on
// Hopper (sm_90a).
//
// Replaces morgana_tpu/ops/pallas_rnn.py::_lstm_bwd_kernel (driven there by
// _core_bwd), with its storage type (K1s, pallas_rnn.py::_store_dtype), and,
// as K2c at H = 1024, the autodiff of the scan backend's bf16 recurrence
// (K1c; morgana_tpu/ops/rnn.py:113-135 under compute_dtype bfloat16;
// narrower layers take csrc/lstm_bwd_bf16.cu, ops/lstm.py::bf16_route). Same
// function: with the activated gates i, f, g, o that K1 saved (g_all),
// running t from T-1 down to 0,
//
//     dh      = dy[t] + dh_carry
//     do      = dh * tanh(c_t)
//     dc      = dh * o * (1 - tanh(c_t)^2) + dc_carry + dc_all[t]
//     dxg[t]  = [dc * g * i(1-i), dc * c_{t-1} * f(1-f), dc * i(1-g^2), do * o(1-o)]
//     dh_carry = rc(round(dxg[t]) @ rc(w_hh)^T)
//     dc_carry = dc * f
//
// with the carries (f32) starting from dhn and dcn and ending as dh0 and dc0,
// round() the rounding to the storage type Store, in which dxg is stored, and
// rc() the rounding to Compute: none for K2 <float, float> and K2s <bf16,
// float>; bf16 for K2c <float, bf16>, where the scan's autodiff rounds
// w_hh_c and converts the carried product to bf16 and back before it joins
// dy, while dxg, dh0 and dc0 stay f32 (dxg is not rounded). Inputs: g_all (T, B, 4H), w_hh (H, 4H), c0 (B, H), c_all, dy and
// dc_all (T, B, H) in Store, dhn and dcn (B, H) in f32. Outputs: dxg (T, B,
// 4H) in Store, dh0 and dc0 (B, H) in f32. c_{t-1} is read from c_all (c0 at
// t = 0). dW_hh = h_{t-1}^T dxg is one large GEMM outside (ops/lstm.py), or
// after K2c the bf16 carry (csrc/rnn_dw_bf16.cu).
//
// What bounds it. 2*B*4H*H flops a step and only the step after it: like
// K1, the step-to-step latency.
//
// Design (lstm_common.cuh has the split over the blocks): the transposed
// product, over 64 blocks of U = H / 64 units (128 blocks of 8 at H = 1024,
// whose slice of w_hh would not fit 64 blocks' registers; the wrapper pads
// other widths to the next built one). The elementwise part of a unit needs
// only that unit's carries, which stay in shared memory with one
// owner thread per (row, unit) pair, pairs numbered unit-fastest so that
// the dxg stores of a warp coalesce. The block's 4U columns of dxg[t] then
// multiply its own (H, 4U) slice of w_hh, kept in registers: the result is
// the block's partial of the whole (B, H) dh_carry, and no block waits for
// another block's dxg before its product. The partials are exchanged as a
// reduce-scatter: each block writes its partial (B, H) to an L2 scratch, all
// meet at one barrier, and each block sums the 64 partials of its own U
// units, 32 contiguous bytes (a whole sector) a partial and row at U = 8.
// What the exchange moves, 2 x 64 x B x H floats a step, is what holds the
// step (PERF.md §6): 64 blocks move half of what 128 would. A step:
//   reduction  the previous step's partials of the block's units, summed
//              (vector loads through L2, the sources split over the threads,
//              then over shared memory) into dh_carry;
//   gates      the pair's dxg[t] (stored, and kept rounded in shared
//              memory), its dc carry; next step's inputs of every pair
//              loaded into registers;
//   product    the kTPD = 4 threads of a destination block (2 at H = 1024)
//              hold its U rows of w_hh at 4U / kTPD of the block's columns
//              each: per batch row (kRows rows at a time) U x 4U / kTPD
//              FMAs, then log2(kTPD) shuffle levels leave each lane its share
//              of the destination's U sums to store;
//   barrier    all blocks meet (lstm_common.cuh) before the partials are
//              read. Partials alternate between two buffers, so a step's
//              writes never meet a slower block's reads of the step before.

#include "lstm_common.cuh"

namespace {

using lstm::kThreads;

constexpr int kRows = 4;  // batch rows a thread's product handles at once

template <int H, typename Store>
struct Bwd {
  using S = lstm::Split<H, (H > 512 ? 128 : 64)>;
  static constexpr int U = S::U;
  static constexpr int kCols = S::kCols;
  static constexpr int kBlocks = S::kBlocks;
  static constexpr int kTPD = kThreads * U / H;  // threads sharing a destination's U rows: 4 (2)
  static constexpr int kCPT = kCols / kTPD;      // the block's columns a thread: U (2U)
  static constexpr int kOut = U >= kTPD ? U / kTPD : 1;  // sums a lane stores a row
  // Lanes that hold the same sums after part_sum (its levels that added).
  static constexpr int kDup = U >= 4 ? 0 : (U == 2 ? 2 : 3);
  // Shared memory, bytes: dxs [B][kCols] (the block's columns of dxg[t],
  // rounded), red [kThreads][U] (the reduce-scatter's per-thread sums), dhs,
  // dcs [B * U] (the carries, pair p = row * U + unit); all f32.
  static size_t smem(int B) {
    return (size_t(B) * kCols + size_t(kThreads) * U + 2 * size_t(B) * U) * 4;
  }
};

// The per-step inputs of one (row, unit) pair, in f32.
struct StepIn {
  float i, f, g, o, c, c_prev, dy, dc_ext;
};

template <typename Store>
__device__ __forceinline__ StepIn load_step(const Store* __restrict__ g_all,
                                            const Store* __restrict__ c_all,
                                            const Store* __restrict__ c0,
                                            const Store* __restrict__ dy,
                                            const Store* __restrict__ dc_all, int t, int b,
                                            int unit, int B, int H) {
  const size_t row = size_t(t) * B + b;
  const Store* gp = g_all + row * 4 * H + unit;
  StepIn s;
  s.i = lstm::to_f32(gp[0]);
  s.f = lstm::to_f32(gp[size_t(H)]);
  s.g = lstm::to_f32(gp[2 * size_t(H)]);
  s.o = lstm::to_f32(gp[3 * size_t(H)]);
  s.c = lstm::to_f32(c_all[row * H + unit]);
  s.c_prev = lstm::to_f32(t > 0 ? c_all[(row - B) * H + unit] : c0[size_t(b) * H + unit]);
  s.dy = lstm::to_f32(dy[row * H + unit]);
  s.dc_ext = lstm::to_f32(dc_all[row * H + unit]);
  return s;
}

// acc += the N floats at p (aligned to 16 bytes when N is a multiple of 4),
// read through L2.
template <int N>
__device__ __forceinline__ void load_sum(const float* p, float (&acc)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p) + q);
      acc[4 * q] += v.x;
      acc[4 * q + 1] += v.y;
      acc[4 * q + 2] += v.z;
      acc[4 * q + 3] += v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
    acc[0] += v.x;
    acc[1] += v.y;
  } else {
    acc[0] += __ldcg(p);
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// Sums v over the kTPD neighbouring lanes of a destination (xor 1, 2 up to
// kTPD / 2): the levels split the N sums between the lanes while they add,
// and the rest add; the lane ends with sums which * kOut .. (which * kOut +
// kOut) of v in v[0 .. kOut).
template <int kTPD, int N>
__device__ __forceinline__ void part_sum(float (&v)[N], int lane, int& which) {
  which = 0;
  int n = N;
#pragma unroll
  for (int mask = 1; mask < kTPD; mask <<= 1) {
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
}

// dhs = the sum of the kBlocks partials (B, H) at `in` over this block's
// units, rounded to Compute: thread (slice, row) = (tid / B, tid % B) adds
// the sources of its slice, then the pair owners add the slices.
template <int H, typename Store, typename Compute>
__device__ __forceinline__ void reduce_partials(const float* in, float* red, float* dhs, int B,
                                                int u0) {
  using F = Bwd<H, Store>;
  constexpr int U = F::U;
  const int tid = threadIdx.x, slices = kThreads / B;
  if (tid < slices * B) {
    float acc[U];
#pragma unroll
    for (int j = 0; j < U; ++j) acc[j] = 0.f;
#pragma unroll 8
    for (int v = tid; v < F::kBlocks * B; v += slices * B) load_sum<U>(in + size_t(v) * H + u0, acc);
#pragma unroll
    for (int j = 0; j < U; ++j) red[tid * U + j] = acc[j];
  }
  __syncthreads();
  for (int p = tid; p < B * U; p += kThreads) {
    float s = 0.f;
    for (int q = 0; q < slices; ++q) s += red[q * B * U + p];
    dhs[p] = lstm::rounded<Compute>(s);
  }
}

template <int H, typename Store, typename Compute, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const Store* __restrict__ g_all, const Store* __restrict__ w_hh,
                const Store* __restrict__ c0, const Store* __restrict__ c_all,
                const Store* __restrict__ dy, const Store* __restrict__ dc_all,
                const float* __restrict__ dhn, const float* __restrict__ dcn,
                Store* __restrict__ dxg, float* __restrict__ dh0, float* __restrict__ dc0,
                float* part, int T, int B, long long* split, int split_steps) {
  using F = Bwd<H, Store>;
  constexpr int U = F::U, kCols = F::kCols, kTPD = F::kTPD, kCPT = F::kCPT, G = 4 * H;
  lstm::StepClock<kSplit> clock(split, split_steps);
  extern __shared__ float4 smem4[];
  float* dxs = reinterpret_cast<float*>(smem4);
  float* red = dxs + B * kCols;
  float* dhs = red + kThreads * U;
  float* dcs = dhs + B * U;
  const int tid = threadIdx.x, lane = tid % 32;
  const int u0 = blockIdx.x * U;
  const int dest = tid / kTPD, part_idx = tid % kTPD;

  // Rows dest * U .. of w_hh, at the thread's columns c = part_idx * kCPT ..
  // (gate c / U, unit u0 + c % U).
  float w[U][kCPT];
#pragma unroll
  for (int k = 0; k < U; ++k)
#pragma unroll
    for (int cc = 0; cc < kCPT; ++cc) {
      const int c = part_idx * kCPT + cc;
      w[k][cc] = lstm::rounded<Compute>(
          lstm::to_f32(w_hh[size_t(dest * U + k) * G + (c / U) * H + u0 + c % U]));
    }
  for (int p = tid; p < B * U; p += kThreads) {
    const size_t at = size_t(p / U) * H + u0 + p % U;
    dhs[p] = dhn[at];
    dcs[p] = dcn[at];
  }

  // The inputs of the thread's pairs p = tid + m * kThreads (at most U of
  // them), loaded a step ahead.
  StepIn next[U];
  auto prefetch = [&](int t) {
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int p = tid + m * kThreads;
      if (p < B * U) next[m] = load_step(g_all, c_all, c0, dy, dc_all, t, p / U, u0 + p % U, B, H);
    }
  };
  if (T > 0) prefetch(T - 1);
  __syncthreads();

  // One buffer of the scratch: [source block][B][H].
  const size_t part_size = size_t(F::kBlocks) * B * H;
  for (int t = T - 1; t >= 0; --t) {
    const int step = T - 1 - t;
    clock.begin();
    if (step > 0) reduce_partials<H, Store, Compute>(part + size_t((step - 1) & 1) * part_size, red, dhs, B, u0);
    clock.mark(lstm::kReduction);

#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int p = tid + m * kThreads;
      if (p < B * U) {
        const int b = p / U, j = p % U;
        const StepIn s = next[m];
        const float dh = s.dy + dhs[p];
        const float tc = lstm::tanh_fast(s.c);
        const float d_o = dh * tc;
        const float dc = dh * s.o * (1.f - tc * tc) + dcs[p] + s.dc_ext;
        const float dg[4] = {dc * s.g * s.i * (1.f - s.i), dc * s.c_prev * s.f * (1.f - s.f),
                             dc * s.i * (1.f - s.g * s.g), d_o * s.o * (1.f - s.o)};
        Store* out = dxg + (size_t(t) * B + b) * G + u0 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const Store v = lstm::from_f32<Store>(dg[g]);
          out[size_t(g) * H] = v;
          dxs[b * kCols + g * U + j] = lstm::to_f32(v);
        }
        dcs[p] = dc * s.f;
      }
    }
    if (t > 0) prefetch(t - 1);
    __syncthreads();
    clock.mark(lstm::kGates);

    // This block's partial, row b at out + b * H; destination dest's sums at
    // dest * U, a lane's kOut of them after `which` * kOut.
    float* out = part + size_t(step & 1) * part_size + size_t(blockIdx.x) * B * H + dest * U;
    // Rows past B repeat the last row and store nothing.
    for (int b1 = 0; b1 < B; b1 += kRows) {
      float acc[kRows][U];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float dv[kCPT];
        lstm::load_f32<kCPT>(dxs + min(b1 + r, B - 1) * kCols + part_idx * kCPT, dv);
#pragma unroll
        for (int k = 0; k < U; ++k) {
          acc[r][k] = 0.f;
#pragma unroll
          for (int cc = 0; cc < kCPT; ++cc) acc[r][k] = fmaf(dv[cc], w[k][cc], acc[r][k]);
        }
      }
      int which = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) part_sum<kTPD, U>(acc[r], lane, which);
      if ((lane & F::kDup) == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (b1 + r < B) store_vec<F::kOut>(out + size_t(b1 + r) * H + which * F::kOut, acc[r]);
      }
    }
    clock.mark(lstm::kProduct);
    // Publishes the partials to every block before any block reads them;
    // also the block barrier before dxs and red are rewritten.
    lstm::grid_barrier();
    clock.mark(lstm::kBarrierWait);
    clock.end_step(step);
  }
  clock.finish();
  if (T > 0) reduce_partials<H, Store, Compute>(part + size_t((T - 1) & 1) * part_size, red, dhs, B, u0);
  __syncthreads();
  for (int p = tid; p < B * U; p += kThreads) {
    const size_t at = size_t(p / U) * H + u0 + p % U;
    dh0[at] = dhs[p];
    dc0[at] = dcs[p];
  }
}

template <int H, typename Store, typename Compute, bool kSplit>
int run(const void* g_all, const void* w_hh, const void* c0, const void* c_all, const void* dy,
        const void* dc_all, const float* dhn, const float* dcn, void* dxg, float* dh0,
        float* dc0, float* part, int T, int B, int device, cudaStream_t stream, long long* split,
        int split_steps) {
  using P = const Store*;
  return lstm::launch(lstm_bwd_kernel<H, Store, Compute, kSplit>, Bwd<H, Store>::kBlocks,
                      Bwd<H, Store>::smem(B), device, stream, static_cast<P>(g_all),
                      static_cast<P>(w_hh), static_cast<P>(c0), static_cast<P>(c_all),
                      static_cast<P>(dy), static_cast<P>(dc_all), dhn, dcn,
                      static_cast<Store*>(dxg), dh0, dc0, part, T, B, split, split_steps);
}

template <bool kSplit>
int dispatch(const void* g_all, const void* w_hh, const void* c0, const void* c_all,
             const void* dy, const void* dc_all, const float* dhn, const float* dcn, void* dxg,
             float* dh0, float* dc0, float* part, int T, int B, int H, int bf16,
             int compute_bf16, int device, void* stream, long long* split, int split_steps) {
  if (T < 0 || B < 1 || B > lstm::kMaxBatch) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K2_RUN(HH, STORE, COMPUTE)                                                     \
  return run<HH, STORE, COMPUTE, kSplit>(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, dxg, \
                                         dh0, dc0, part, T, B, device, s, split, split_steps)
#define K2_H(HH)                                  \
  case HH:                                        \
    if (bf16) K2_RUN(HH, __nv_bfloat16, float);   \
    if (compute_bf16) K2_RUN(HH, float, __nv_bfloat16); \
    K2_RUN(HH, float, float);
  switch (H) {
    K2_H(64)
    K2_H(128)
    K2_H(256)
    K2_H(512)
    K2_H(1024)
  }
#undef K2_H
#undef K2_RUN
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches K2 on `stream` (a cudaStream_t) of `device`; returns a cudaError_t
// (0 on success). Pointers are device pointers to contiguous arrays: g_all,
// w_hh, c0, c_all, dy, dc_all and dxg in bf16 when `bf16` is non-zero, else
// f32; dhn, dcn, dh0 and dc0 in f32; `part` f32 scratch of 2 * blocks * B * H
// floats (two buffers of the blocks' partials; 64 blocks, 128 at H = 1024).
// With f32 storage, a non-zero `compute_bf16` launches K2c. H is 64, 128,
// 256, 512 or 1024 and B at most 256.
int morgana_lstm_bwd(const void* g_all, const void* w_hh, const void* c0, const void* c_all,
                     const void* dy, const void* dc_all, const float* dhn, const float* dcn,
                     void* dxg, float* dh0, float* dc0, float* part, int T, int B, int H,
                     int bf16, int compute_bf16, int device, void* stream) {
  return dispatch<false>(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, dxg, dh0, dc0, part, T, B,
                         H, bf16, compute_bf16, device, stream, nullptr, 0);
}

#ifdef MORGANA_STEP_SPLIT
// As morgana_lstm_bwd, recording the phases of the first split_steps steps
// into split (two records of lstm::split_record(split_steps) entries).
int morgana_lstm_bwd_split(const void* g_all, const void* w_hh, const void* c0,
                           const void* c_all, const void* dy, const void* dc_all,
                           const float* dhn, const float* dcn, void* dxg, float* dh0, float* dc0,
                           float* part, int T, int B, int H, int bf16, int compute_bf16,
                           int device, void* stream, long long* split, int split_steps) {
  return dispatch<true>(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, dxg, dh0, dc0, part, T, B,
                        H, bf16, compute_bf16, device, stream, split, split_steps);
}
#endif

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
