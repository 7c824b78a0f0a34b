// K2: one LSTM layer, backward through time, as one persistent launch on
// Hopper (sm_90a).
//
// Replaces morgana_tpu/ops/pallas_rnn.py::_lstm_bwd_kernel (driven there by
// _core_bwd). Same function: with the activated gates i, f, g, o that K1
// saved (g_all), running t from T-1 down to 0,
//
//     dh      = dy[t] + dh_carry
//     do      = dh * tanh(c_t)
//     dc      = dh * o * (1 - tanh(c_t)^2) + dc_carry + dc_all[t]
//     dxg[t]  = [dc * g * i(1-i), dc * c_{t-1} * f(1-f), dc * i(1-g^2), do * o(1-o)]
//     dh_carry = dxg[t] @ w_hh^T
//     dc_carry = dc * f
//
// with the carries starting from dhn and dcn (the cotangents of the final
// state) and ending as dh0 and dc0. Inputs: g_all (T, B, 4H), w_hh (H, 4H),
// c0 (B, H), c_all (T, B, H), dy and dc_all (T, B, H), dhn and dcn (B, H).
// Outputs: dxg (T, B, 4H), dh0 and dc0 (B, H). c_{t-1} is read from c_all
// (c0 at t = 0) rather than from a shifted copy. dW_hh = h_{t-1}^T dxg is one
// large GEMM outside the kernel (ops/lstm.py), as the JAX package leaves it
// to XLA.
//
// What bounds it. Each step needs 2*B*4H*H flops for dh_carry and only the
// (B, 4H) row dxg[t] of the step after it, so like K1 it is bound by the
// step-to-step latency: nothing of step t-1 can start before dxg[t] is
// complete everywhere.
//
// Design, mirroring K1. The hidden units are split over the blocks: block b
// owns U consecutive units (at H = 512: 128 blocks, U = 4). The elementwise
// part of a unit needs only that unit's own dh and dc carries, which stay in
// shared memory with one owner thread per (unit, batch row) pair. Each step
// the block writes the 4U columns of dxg[t] it owns, all blocks meet at a
// grid-wide barrier, and then each block computes its units' dh_carry =
// dxg[t] @ w_hh[own units, :]^T, keeping those U rows of w_hh (transposed,
// (4H, U): 32 KB at U = 4) resident in shared memory for the whole launch.
// One (B, 4H) row of dxg does not fit shared memory at B = 32 (256 KB), so
// the reduction dimension is streamed through a shared tile: each tile is
// read through L2 (__ldcg, never the non-coherent L1, since other blocks
// wrote it during this launch) with all of a thread's loads in flight
// before the first store. One grid barrier per step. The launch is
// cooperative, so a grid whose blocks cannot all be resident is refused
// rather than left to deadlock. Tensor cores, TMA and clusters are left for
// later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBatch = 32 * kWarps;
constexpr int kStage = 8;  // float4 loads a thread keeps in flight when staging a tile

// Shared memory, in floats:
//   ws   [4H][U]       the block's rows of w_hh, transposed: ws[k * U + j] = w_hh[u0 + j][k]
//   red  [KS][U][BP]   per-warp partial sums of dxg[t] @ ws (KS * BP <= 256)
//   tile [B][KT + 4]   KT columns of dxg[t]; with the row stride KT + 4 the
//                      16-byte reads of eight lanes (eight batch rows) cover
//                      all 32 banks
//   dhs, dcs [U][B]    the block's dh and dc carries
template <int U>
size_t fixed_floats(int B, int H) {
  return size_t(4) * H * U + size_t(kThreads) * U + 2 * size_t(U) * B;
}

// The per-step inputs of one (unit, batch row) pair.
struct StepIn {
  float i, f, g, o, c, c_prev, dy, dc_ext;
};

__device__ __forceinline__ StepIn load_step(const float* __restrict__ g_all,
                                            const float* __restrict__ c_all,
                                            const float* __restrict__ c0,
                                            const float* __restrict__ dy,
                                            const float* __restrict__ dc_all, int t, int b,
                                            int unit, int B, int H) {
  const size_t row = size_t(t) * B + b;
  const float* gp = g_all + row * 4 * H + unit;
  StepIn s;
  s.i = __ldg(gp);
  s.f = __ldg(gp + size_t(H));
  s.g = __ldg(gp + 2 * size_t(H));
  s.o = __ldg(gp + 3 * size_t(H));
  s.c = __ldg(c_all + row * H + unit);
  s.c_prev = t > 0 ? __ldg(c_all + (row - B) * H + unit) : __ldg(c0 + size_t(b) * H + unit);
  s.dy = __ldg(dy + row * H + unit);
  s.dc_ext = __ldg(dc_all + row * H + unit);
  return s;
}

template <int U>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const float* __restrict__ g_all, const float* __restrict__ w_hh,
                const float* __restrict__ c0, const float* __restrict__ c_all,
                const float* __restrict__ dy, const float* __restrict__ dc_all,
                const float* __restrict__ dhn, const float* __restrict__ dcn, float* dxg,
                float* __restrict__ dh0, float* __restrict__ dc0, int T, int B, int H, int KT) {
  const int G = 4 * H;
  const int KTP = KT + 4;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* red = ws + size_t(G) * U;
  float* tile = red + size_t(kThreads) * U;
  float* dhs = tile + size_t(B) * KTP;
  float* dcs = dhs + size_t(U) * B;
  const int u0 = blockIdx.x * U;
  const int tid = threadIdx.x;

  // Coalesced reads along w_hh's rows, scattered into the transposed slice.
  for (int idx = tid; idx < U * G; idx += kThreads) {
    const int j = idx / G, k = idx % G, unit = u0 + j;
    ws[size_t(k) * U + j] = unit < H ? w_hh[size_t(unit) * G + k] : 0.f;
  }
  // Pair p = j * B + b is (unit u0 + j, batch row b); one thread owns it for
  // the whole launch, so dhs/dcs need no barrier between its steps.
  for (int p = tid; p < U * B; p += kThreads) {
    const int j = p / B, b = p % B, unit = u0 + j;
    dhs[p] = unit < H ? dhn[size_t(b) * H + unit] : 0.f;
    dcs[p] = unit < H ? dcn[size_t(b) * H + unit] : 0.f;
  }

  // Product dxg[t] @ ws: lane = batch row within a 32-row slice, warps split
  // the slices and then the columns of each tile.
  const int nbs = (B + 31) / 32, KS = kWarps / nbs, BP = nbs * 32;
  const int warp = tid / 32, lane = tid % 32;
  const int ks = warp / nbs, b_mv = (warp % nbs) * 32 + lane;
  const bool mv_warp = ks < KS;

  // The inputs of a thread's first pair do not depend on the recurrence:
  // they are loaded one step ahead, while the product of the step runs.
  const bool first_pair = tid < U * B && u0 + tid / B < H;
  StepIn next{};
  if (first_pair && T > 0) next = load_step(g_all, c_all, c0, dy, dc_all, T - 1, tid % B, u0 + tid / B, B, H);
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  for (int t = T - 1; t >= 0; --t) {
    for (int p = tid; p < U * B; p += kThreads) {
      const int j = p / B, b = p % B, unit = u0 + j;
      if (unit >= H) continue;
      const StepIn s = p == tid ? next : load_step(g_all, c_all, c0, dy, dc_all, t, b, unit, B, H);
      const float dh = s.dy + dhs[p];
      const float tc = tanhf(s.c);
      const float d_o = dh * tc;
      const float dc = dh * s.o * (1.f - tc * tc) + dcs[p] + s.dc_ext;
      float* out = dxg + (size_t(t) * B + b) * G + unit;
      out[0] = dc * s.g * s.i * (1.f - s.i);
      out[size_t(H)] = dc * s.c_prev * s.f * (1.f - s.f);
      out[2 * size_t(H)] = dc * s.i * (1.f - s.g * s.g);
      out[3 * size_t(H)] = d_o * s.o * (1.f - s.o);
      dcs[p] = dc * s.f;
    }
    // Publishes dxg[t] to every block before any block reads it; also the
    // block-level barrier that lets tile and red be overwritten.
    grid.sync();
    if (first_pair && t > 0) next = load_step(g_all, c_all, c0, dy, dc_all, t - 1, tid % B, u0 + tid / B, B, H);

    float acc[U];
#pragma unroll
    for (int q = 0; q < U; ++q) acc[q] = 0.f;
    const float* row0 = dxg + size_t(t) * B * G;
    for (int k0 = 0; k0 < G; k0 += KT) {
      const int kt = min(KT, G - k0);
      const int c4 = kt / 4, n4 = B * c4;
      for (int base = tid; base < n4; base += kThreads * kStage) {
        float4 v[kStage];
#pragma unroll
        for (int s = 0; s < kStage; ++s) {
          const int e = base + s * kThreads;
          if (e < n4)
            v[s] = __ldcg(reinterpret_cast<const float4*>(row0 + size_t(e / c4) * G + k0) + e % c4);
        }
#pragma unroll
        for (int s = 0; s < kStage; ++s) {
          const int e = base + s * kThreads;
          if (e < n4) *reinterpret_cast<float4*>(tile + (e / c4) * KTP + 4 * (e % c4)) = v[s];
        }
      }
      __syncthreads();
      if (mv_warp && b_mv < B) {
        const int kc = ((kt + KS - 1) / KS + 3) / 4 * 4;
        const int k_lo = min(kt, ks * kc), k_hi = min(kt, k_lo + kc);
        const float* drow = tile + b_mv * KTP;
        for (int k = k_lo; k < k_hi; k += 4) {
          const float4 d4 = *reinterpret_cast<const float4*>(drow + k);
          const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float* wk = ws + size_t(k0 + k + kk) * U;
            if constexpr (U % 4 == 0) {
#pragma unroll
              for (int q = 0; q < U; q += 4) {
                const float4 w4 = *reinterpret_cast<const float4*>(wk + q);
                acc[q + 0] = fmaf(dv[kk], w4.x, acc[q + 0]);
                acc[q + 1] = fmaf(dv[kk], w4.y, acc[q + 1]);
                acc[q + 2] = fmaf(dv[kk], w4.z, acc[q + 2]);
                acc[q + 3] = fmaf(dv[kk], w4.w, acc[q + 3]);
              }
            } else {
#pragma unroll
              for (int q = 0; q < U; ++q) acc[q] = fmaf(dv[kk], wk[q], acc[q]);
            }
          }
        }
      }
      // The next tile overwrites this one.
      __syncthreads();
    }
    if (mv_warp) {
#pragma unroll
      for (int q = 0; q < U; ++q) red[(ks * U + q) * BP + b_mv] = acc[q];
    }
    __syncthreads();
    // Each carry is written by the thread that reads it in the next step;
    // red and tile are rewritten only after the next grid barrier.
    for (int p = tid; p < U * B; p += kThreads) {
      const int j = p / B, b = p % B;
      float s = 0.f;
      for (int q = 0; q < KS; ++q) s += red[(q * U + j) * BP + b];
      dhs[p] = s;
    }
  }

  for (int p = tid; p < U * B; p += kThreads) {
    const int j = p / B, b = p % B, unit = u0 + j;
    if (unit >= H) continue;
    dh0[size_t(b) * H + unit] = dhs[p];
    dc0[size_t(b) * H + unit] = dcs[p];
  }
}

template <int U>
int launch(const float* g_all, const float* w_hh, const float* c0, const float* c_all,
           const float* dy, const float* dc_all, const float* dhn, const float* dcn, float* dxg,
           float* dh0, float* dc0, int T, int B, int H, int device, cudaStream_t stream) {
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  // The widest tile that fits beside the fixed buffers, then split evenly.
  const int G = 4 * H;
  const long long fixed = static_cast<long long>(fixed_floats<U>(B, H)) * sizeof(float);
  const long long widest = (max_smem - fixed) / (static_cast<long long>(B) * sizeof(float)) - 4;
  if (widest < 4) return cudaErrorInvalidValue;
  const int widest4 = static_cast<int>(widest < G ? widest : G) / 4 * 4;
  const int tiles = (G + widest4 - 1) / widest4;
  int KT = ((G + tiles - 1) / tiles + 3) / 4 * 4;
  const size_t smem = static_cast<size_t>(fixed) + size_t(B) * (KT + 4) * sizeof(float);
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  auto kernel = lstm_bwd_kernel<U>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {&g_all, &w_hh, &c0, &c_all, &dy, &dc_all, &dhn, &dcn,
                  &dxg, &dh0, &dc0, &T, &B, &H, &KT};
  const int blocks = (H + U - 1) / U;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K2 on `stream` (a cudaStream_t) of `device`; returns a cudaError_t
// (0 on success). All pointers are device pointers to contiguous f32 arrays,
// dxg 16-byte aligned; H must be a multiple of 4.
int morgana_lstm_bwd(const float* g_all, const float* w_hh, const float* c0, const float* c_all,
                     const float* dy, const float* dc_all, const float* dhn, const float* dcn,
                     float* dxg, float* dh0, float* dc0, int T, int B, int H, int device,
                     void* stream) {
  if (T < 0 || B < 1 || B > kMaxBatch || H < 4 || H % 4) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // The fewest units per block that keep one block per SM, as K1.
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= sms) return launch<1>(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, dxg, dh0, dc0, T, B, H, device, s);
  if (H <= 2 * sms) return launch<2>(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, dxg, dh0, dc0, T, B, H, device, s);
  if (H <= 4 * sms) return launch<4>(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, dxg, dh0, dc0, T, B, H, device, s);
  if (H <= 8 * sms) return launch<8>(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, dxg, dh0, dc0, T, B, H, device, s);
  return cudaErrorInvalidValue;
}

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
