// K4: one GRU layer, backward, on Hopper (sm_90a).
//
// Replaces morgana_tpu/ops/pallas_gru.py::_gru_bwd_kernel (driven there by
// _core_bwd). Same function: walking time backwards from dh = dhn, each step
// recomputes hg = h_{t-1} @ w_hh + b_hh and the gates r, z, n of K3 (there is
// no gate trace), then
//
//     dh   = dy_t + dh
//     da_n = dh * (1 - z) * (1 - n^2)
//     da_z = dh * (h_{t-1} - n) * z * (1 - z)
//     da_r = da_n * hg_n * r * (1 - r)
//     dxg_t = [da_r, da_z, da_n]
//     dh   = dh * z + [da_r, da_z, da_n * r] @ w_hh^T
//
// and returns dh0 = dh after step 0. Inputs: xg (T, B, 3H), w_hh (H, 3H),
// b_hh (3H), h0 (B, H), y (T, B, H), the unmasked h trace of K3, whose step t
// is h_t (h_{t-1} is y[t-1], h0 at t = 0), dy (T, B, H) and dhn (B, H).
// Outputs: dxg (T, B, 3H) and dh0 (B, H). dW_hh and db_hh are batched GEMMs
// outside (ops/gru.py), as in pallas_gru.py.
//
// What bounds it. Two dependent products a step (the recompute of hg and the
// carry), 4*H*3H flops per batch row, each waiting on the one before: the
// step-to-step latency bounds the layer, far above the flops.
//
// Design. As K3 (csrc/gru_fwd.cu): block b owns batch row b and walks all T
// steps with w_hh resident in shared memory; no grid barrier. w_hh is stored
// once, with a row stride of 3H + 1, and serves both products without bank
// conflicts: for the recompute, thread j (unit j) reads row k at columns j,
// H + j, 2H + j (lanes on consecutive columns); for the carry, thread k reads
// its own row k of w_hh, which is column k of w_hh^T (lanes on rows 3H + 1
// floats apart, which fall in distinct banks because 3H is a multiple of 32).
// Each step stages h_{t-1} and then [da_r, da_z, da_n * r] in shared memory,
// with one block barrier after each; the next step's xg, dy and h_{t-1} are
// loaded while the products run.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxHidden = 128;  // one thread per hidden unit

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.f / (1.f + expf(-x)); }

// Shared memory, in floats: ws [H][3H + 1] (w_hh), hp [H] (h_{t-1}),
// dg [3H] (the hidden-side gate gradients).
size_t smem_bytes(int H) { return sizeof(float) * (size_t(H) * (3 * H + 1) + 4 * size_t(H)); }

struct StepInputs {
  float x_r, x_z, x_n, dy, h_prev;
};

__device__ __forceinline__ StepInputs load_step(const float* __restrict__ xg,
                                                const float* __restrict__ h0,
                                                const float* __restrict__ y,
                                                const float* __restrict__ dy, int t, int B, int H,
                                                int b, int j) {
  const float* row = xg + (size_t(t) * B + b) * 3 * H;
  StepInputs s;
  s.x_r = __ldg(row + j);
  s.x_z = __ldg(row + H + j);
  s.x_n = __ldg(row + 2 * H + j);
  s.dy = __ldg(dy + (size_t(t) * B + b) * H + j);
  s.h_prev = t > 0 ? __ldg(y + (size_t(t - 1) * B + b) * H + j) : __ldg(h0 + size_t(b) * H + j);
  return s;
}

__global__ void __launch_bounds__(kMaxHidden)
gru_bwd_kernel(const float* __restrict__ xg, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, const float* __restrict__ h0,
               const float* __restrict__ y, const float* __restrict__ dy,
               const float* __restrict__ dhn, float* __restrict__ dxg, float* __restrict__ dh0,
               int T, int B, int H) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  const int WS = 3 * H + 1;
  float* hp = ws + size_t(H) * WS;  // H * (3H + 1) is a multiple of 4: float4-aligned
  float* dg = hp + H;
  const int j = threadIdx.x;
  const int b = blockIdx.x;

  for (int idx = j; idx < H * 3 * H; idx += H) ws[(idx / (3 * H)) * WS + idx % (3 * H)] = w_hh[idx];
  const float b_r = b_hh[j], b_z = b_hh[H + j], b_n = b_hh[2 * H + j];
  float dh = dhn[size_t(b) * H + j];
  StepInputs cur = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (T > 0) cur = load_step(xg, h0, y, dy, T - 1, B, H, b, j);

  for (int t = T - 1; t >= 0; --t) {
    hp[j] = cur.h_prev;
    StepInputs next = cur;
    if (t > 0) next = load_step(xg, h0, y, dy, t - 1, B, H, b, j);
    // Publishes h_{t-1}; also, every thread is past the last step's carry
    // product, so dg may be overwritten.
    __syncthreads();

    float a_r = b_r, a_z = b_z, a_n = b_n;
#pragma unroll 4
    for (int k = 0; k < H; k += 4) {
      const float4 h4 = *reinterpret_cast<const float4*>(hp + k);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* w = ws + size_t(k + kk) * WS + j;
        a_r = fmaf(hv[kk], w[0], a_r);
        a_z = fmaf(hv[kk], w[H], a_z);
        a_n = fmaf(hv[kk], w[2 * H], a_n);
      }
    }
    const float r = sigmoid_f32(cur.x_r + a_r);
    const float z = sigmoid_f32(cur.x_z + a_z);
    const float n = tanhf(cur.x_n + r * a_n);

    const float dh_t = cur.dy + dh;
    const float da_n = dh_t * (1.f - z) * (1.f - n * n);
    const float da_z = dh_t * (cur.h_prev - n) * z * (1.f - z);
    const float da_r = da_n * a_n * r * (1.f - r);
    float* out = dxg + (size_t(t) * B + b) * 3 * H;
    out[j] = da_r;
    out[H + j] = da_z;
    out[2 * H + j] = da_n;
    dg[j] = da_r;
    dg[H + j] = da_z;
    dg[2 * H + j] = da_n * r;
    // Publishes dg; also, every thread is past reading hp.
    __syncthreads();

    // dh_{t-1}[j] = dh_t[j] * z[j] + sum_c dg[c] * w_hh[j][c].
    const float* wrow = ws + size_t(j) * WS;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < 3 * H; c += 4) {
      const float4 g4 = *reinterpret_cast<const float4*>(dg + c);
      acc[0] = fmaf(g4.x, wrow[c], acc[0]);
      acc[1] = fmaf(g4.y, wrow[c + 1], acc[1]);
      acc[2] = fmaf(g4.z, wrow[c + 2], acc[2]);
      acc[3] = fmaf(g4.w, wrow[c + 3], acc[3]);
    }
    dh = dh_t * z + ((acc[0] + acc[1]) + (acc[2] + acc[3]));
    cur = next;
  }
  dh0[size_t(b) * H + j] = dh;
}

}  // namespace

extern "C" {

// Launches K4 on `stream` (a cudaStream_t) of `device`; returns a cudaError_t
// (0 on success). All pointers are device pointers to contiguous f32 arrays.
// H must be a multiple of 32, at most 128, with 3H^2 + 5H floats in one
// block's shared memory; B >= 1, T >= 0.
int morgana_gru_bwd(const float* xg, const float* w_hh, const float* b_hh, const float* h0,
                    const float* y, const float* dy, const float* dhn, float* dxg, float* dh0,
                    int T, int B, int H, int device, void* stream) {
  if (T < 0 || B < 1 || H < 32 || H % 32 || H > kMaxHidden) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(H);
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  gru_bwd_kernel<<<B, H, smem, static_cast<cudaStream_t>(stream)>>>(xg, w_hh, b_hh, h0, y, dy, dhn,
                                                                    dxg, dh0, T, B, H);
  return cudaGetLastError();
}

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
