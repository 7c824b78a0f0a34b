// K1: one LSTM layer, forward, as one persistent launch on Hopper (sm_90a).
//
// Replaces morgana_tpu/ops/pallas_rnn.py::_lstm_fwd_kernel (driven there by
// _fwd_call). Same function: with gates ordered i, f, g, o,
//
//     gates_t = xg_t + h_{t-1} @ w_hh
//     c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//     h_t = sigmoid(o) * tanh(c_t)
//
// over the whole padded time axis, with h and c carried in f32. Inputs: xg
// (T, B, 4H), w_hh (H, 4H), h0 and c0 (B, H). Outputs: y = h trace and c_all
// = c trace (T, B, H), hn and cn (B, H). Masking past seq_len and the
// final-state gather at seq_len - 1 happen outside (ops/lstm.py), as in
// pallas_rnn.py. When g_all is given (training), the kernel also writes the
// activated gates i, f, g, o of every step, (T, B, 4H), which only its
// backward K2 (lstm_bwd.cu) reads. That is a template flag, not a runtime
// branch: serving passes a null g_all and runs the variant without the
// stores, with the same arithmetic and registers as without the flag.
//
// What bounds it. The recurrence needs 2*B*H*4H flops per step and only a
// (B, H) vector from the previous step, so at serving shapes it is bound by
// the step-to-step latency: the whole of w_hh must be applied every step and
// nothing of step t+1 can start before step t is complete everywhere.
//
// Design. The TPU kernel keeps w_hh resident in VMEM and walks time in a
// sequential grid. Here w_hh (4 MiB in f32 at H = 512) does not fit one
// block's shared memory, so the hidden units are split over the blocks: each
// block owns U consecutive units with all four of their gates and keeps that
// (H, 4U) slice of w_hh resident in shared memory for the whole launch (at
// H = 512: 128 blocks, U = 4, 32 KB each). The cell update of a unit then
// stays inside its block. One launch runs every step; the blocks exchange
// h_t through y itself (step t reads y[t-1], written by every block, and
// writes y[t]) and meet at a grid-wide barrier after each step. The launch is
// cooperative, so a grid whose blocks cannot all be resident at once is
// refused rather than left to deadlock. Tensor cores, TMA and clusters are
// left for later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBatch = 32 * kWarps;
constexpr int kStage = 16;  // float4 loads a thread keeps in flight when staging h

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.f / (1.f + expf(-x)); }

// Shared memory, in floats:
//   ws  [H][4U]          the block's slice of w_hh, column r = gate * U + j
//   red [KS][4U][BP]     per-warp partial sums of h_{t-1} @ ws (KS * BP <= 256)
//   hs  [B][H + 4]       h_{t-1}; with the row stride H + 4 the 16-byte reads
//                        of eight lanes (eight batch rows) cover all 32 banks
//   cs, hl [U][B]        the block's c_t and h_t
template <int U>
size_t smem_floats(int B, int H) {
  return size_t(H) * 4 * U + size_t(kThreads) * 4 * U + size_t(B) * (H + 4) + 2 * size_t(U) * B;
}

template <int U, bool kGates>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ w_hh,
                const float* __restrict__ h0, const float* __restrict__ c0,
                float* y, float* __restrict__ c_all, float* __restrict__ g_all,
                float* __restrict__ hn, float* __restrict__ cn, int T, int B, int H) {
  constexpr int G4 = 4 * U;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* red = ws + size_t(H) * G4;
  float* hs = red + size_t(kThreads) * G4;
  float* cs = hs + size_t(B) * (H + 4);
  float* hl = cs + size_t(U) * B;
  const int HP = H + 4;
  const int u0 = blockIdx.x * U;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < H * G4; idx += kThreads) {
    const int k = idx / G4, r = idx % G4, g = r / U, unit = u0 + r % U;
    ws[idx] = unit < H ? w_hh[size_t(k) * 4 * H + size_t(g) * H + unit] : 0.f;
  }
  // Pair p = j * B + b is (unit u0 + j, batch row b); one thread owns it for
  // the whole launch, so cs/hl need no barrier between its steps.
  for (int p = tid; p < U * B; p += kThreads) {
    const int j = p / B, b = p % B, unit = u0 + j;
    cs[p] = unit < H ? c0[size_t(b) * H + unit] : 0.f;
    hl[p] = unit < H ? h0[size_t(b) * H + unit] : 0.f;
  }

  // Product h_{t-1} @ ws: lane = batch row within a 32-row slice, warps split
  // the slices and then the reduction dimension k.
  const int nbs = (B + 31) / 32, KS = kWarps / nbs, BP = nbs * 32;
  const int warp = tid / 32, lane = tid % 32;
  const int ks = warp / nbs, b_mv = (warp % nbs) * 32 + lane;
  const bool mv_warp = ks < KS;
  const int kc = ((H + KS - 1) / KS + 3) / 4 * 4;  // H is a multiple of 4
  const int k_lo = min(H, ks * kc), k_hi = min(H, k_lo + kc);

  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T; ++t) {
    // xg does not depend on the recurrence: start the loads for the first
    // owned pair now so that they land while the product runs.
    float xpre[4] = {0.f, 0.f, 0.f, 0.f};
    if (tid < U * B && u0 + tid / B < H) {
      const float* row = xg + (size_t(t) * B + tid % B) * 4 * H + u0 + tid / B;
#pragma unroll
      for (int g = 0; g < 4; ++g) xpre[g] = __ldg(row + size_t(g) * H);
    }

    // Stage h_{t-1}. y is written by other blocks during this launch, so it
    // is read through L2 (__ldcg), never through the non-coherent L1. All of
    // a thread's loads are in flight before the first store waits on one.
    const float4* hprev = reinterpret_cast<const float4*>(t == 0 ? h0 : y + size_t(t - 1) * B * H);
    const int n4 = B * H / 4;
    for (int base = tid; base < n4; base += kThreads * kStage) {
      float4 v[kStage];
#pragma unroll
      for (int s = 0; s < kStage; ++s)
        if (base + s * kThreads < n4) v[s] = __ldcg(hprev + base + s * kThreads);
#pragma unroll
      for (int s = 0; s < kStage; ++s) {
        const int e = 4 * (base + s * kThreads);
        if (e < B * H) *reinterpret_cast<float4*>(hs + (e / H) * HP + e % H) = v[s];
      }
    }
    __syncthreads();

    if (mv_warp) {
      float acc[G4];
#pragma unroll
      for (int r = 0; r < G4; ++r) acc[r] = 0.f;
      if (b_mv < B) {
        const float* hrow = hs + b_mv * HP;
        for (int k = k_lo; k < k_hi; k += 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(hrow + k);
          const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4* wk = reinterpret_cast<const float4*>(ws + size_t(k + kk) * G4);
#pragma unroll
            for (int q = 0; q < U; ++q) {
              const float4 w4 = wk[q];
              acc[4 * q + 0] = fmaf(hv[kk], w4.x, acc[4 * q + 0]);
              acc[4 * q + 1] = fmaf(hv[kk], w4.y, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(hv[kk], w4.z, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(hv[kk], w4.w, acc[4 * q + 3]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < G4; ++r) red[(ks * G4 + r) * BP + b_mv] = acc[r];
    }
    __syncthreads();

    for (int p = tid; p < U * B; p += kThreads) {
      const int j = p / B, b = p % B, unit = u0 + j;
      if (unit >= H) continue;
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = 0.f;
        for (int q = 0; q < KS; ++q) s += red[(q * G4 + g * U + j) * BP + b];
        const float x = p == tid ? xpre[g]
                                 : __ldg(xg + (size_t(t) * B + b) * 4 * H + size_t(g) * H + unit);
        gate[g] = x + s;
      }
      const float ig = sigmoid_f32(gate[0]), fg = sigmoid_f32(gate[1]);
      const float gg = tanhf(gate[2]), og = sigmoid_f32(gate[3]);
      const float c = fg * cs[p] + ig * gg;
      const float h = og * tanhf(c);
      cs[p] = c;
      hl[p] = h;
      const size_t out = (size_t(t) * B + b) * H + unit;
      y[out] = h;
      c_all[out] = c;
      if constexpr (kGates) {
        float* gp = g_all + (size_t(t) * B + b) * 4 * H + unit;
        gp[0] = ig;
        gp[size_t(H)] = fg;
        gp[2 * size_t(H)] = gg;
        gp[3 * size_t(H)] = og;
      }
    }
    // Publishes y[t] to every block before any block stages it; also the
    // block-level barrier that lets hs and red be overwritten next step.
    if (t + 1 < T) grid.sync();
  }

  for (int p = tid; p < U * B; p += kThreads) {
    const int j = p / B, b = p % B, unit = u0 + j;
    if (unit >= H) continue;
    hn[size_t(b) * H + unit] = hl[p];
    cn[size_t(b) * H + unit] = cs[p];
  }
}

template <int U, bool kGates>
int launch_variant(const float* xg, const float* w_hh, const float* h0, const float* c0, float* y,
                   float* c_all, float* g_all, float* hn, float* cn, int T, int B, int H,
                   int device, cudaStream_t stream) {
  const size_t smem = smem_floats<U>(B, H) * sizeof(float);
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  auto kernel = lstm_fwd_kernel<U, kGates>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {&xg, &w_hh, &h0, &c0, &y, &c_all, &g_all, &hn, &cn, &T, &B, &H};
  const int blocks = (H + U - 1) / U;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int U>
int launch(const float* xg, const float* w_hh, const float* h0, const float* c0, float* y,
           float* c_all, float* g_all, float* hn, float* cn, int T, int B, int H, int device,
           cudaStream_t stream) {
  if (g_all != nullptr)
    return launch_variant<U, true>(xg, w_hh, h0, c0, y, c_all, g_all, hn, cn, T, B, H, device, stream);
  return launch_variant<U, false>(xg, w_hh, h0, c0, y, c_all, g_all, hn, cn, T, B, H, device, stream);
}

}  // namespace

extern "C" {

// Launches K1 on `stream` (a cudaStream_t) of `device`; returns a cudaError_t
// (0 on success). All pointers are device pointers to contiguous f32 arrays,
// h0 16-byte aligned; H must be a multiple of 4. g_all, (T, B, 4H), may be
// null: then the gate trace is not written.
int morgana_lstm_fwd(const float* xg, const float* w_hh, const float* h0, const float* c0,
                     float* y, float* c_all, float* g_all, float* hn, float* cn, int T, int B,
                     int H, int device, void* stream) {
  if (T < 0 || B < 1 || B > kMaxBatch || H < 4 || H % 4) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // The fewest units per block that keep one block per SM.
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= sms) return launch<1>(xg, w_hh, h0, c0, y, c_all, g_all, hn, cn, T, B, H, device, s);
  if (H <= 2 * sms) return launch<2>(xg, w_hh, h0, c0, y, c_all, g_all, hn, cn, T, B, H, device, s);
  if (H <= 4 * sms) return launch<4>(xg, w_hh, h0, c0, y, c_all, g_all, hn, cn, T, B, H, device, s);
  if (H <= 8 * sms) return launch<8>(xg, w_hh, h0, c0, y, c_all, g_all, hn, cn, T, B, H, device, s);
  return cudaErrorInvalidValue;
}

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
