// K3: one GRU layer, forward, on Hopper (sm_90a).
//
// Replaces morgana_tpu/ops/pallas_gru.py::_gru_fwd_kernel (driven there by
// _fwd_call). Same function, in torch's gate form with gates ordered r, z, n:
//
//     hg_t = h_{t-1} @ w_hh + b_hh
//     r = sigmoid(xg_r + hg_r),  z = sigmoid(xg_z + hg_z)
//     n = tanh(xg_n + r * hg_n)
//     h_t = (1 - z) * n + z * h_{t-1}
//
// over the whole padded time axis, h carried in f32. Inputs: xg = x @ w_ih +
// b_ih (T, B, 3H), w_hh (H, 3H), b_hh (3H), h0 (B, H). Outputs: y = h trace
// (T, B, H) and hn (B, H). Masking past seq_len and the final-state gather
// happen outside (ops/gru.py), as in pallas_gru.py.
//
// What bounds it. A step needs 2*H*3H flops per batch row and the whole
// (B, H) state of the step before, so the work of a step is tiny (2.4 MFLOP at
// B=32, H=64) and the step-to-step latency bounds the layer: each step is a
// dependent chain of H multiply-adds per gate, then the gate math, then a
// barrier before the next step may read h_t.
//
// Design. The TPU kernel keeps w_hh resident in VMEM and walks time in a
// sequential grid. Here w_hh is small (48 KB at H = 64, 192 KB at H = 128 in
// f32) and fits one block's shared memory, and the rows of the batch are
// independent. So block b owns batch row b alone and walks all T steps with
// w_hh resident: no cooperative launch and no grid barrier, only one block
// barrier a step. Thread j owns hidden unit j and its three gate columns; it
// keeps its h in a register and publishes it through a double-buffered
// (2, H) copy of h in shared memory, which every thread of the row reads as a
// broadcast. w_hh is stored with a row stride of 3H + 1, so that a warp reads
// one row (lanes on consecutive columns, this kernel) or one column (lanes on
// consecutive rows, K4's carry product) without bank conflicts. One row per
// block keeps each step's shared-memory traffic to one pass over w_hh; the
// batch rows run on separate SMs. The next step's xg is loaded while the
// product runs. Tensor cores and keeping w_hh in registers are left for later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxHidden = 128;  // one thread per hidden unit

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.f / (1.f + expf(-x)); }

// Shared memory, in floats: ws [H][3H + 1] (w_hh), hs [2][H] (h double buffer).
size_t smem_bytes(int H) { return sizeof(float) * (size_t(H) * (3 * H + 1) + 2 * size_t(H)); }

__global__ void __launch_bounds__(kMaxHidden)
gru_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ hn, int T, int B, int H) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  const int WS = 3 * H + 1;
  float* hs = ws + size_t(H) * WS;  // H * (3H + 1) is a multiple of 4: float4-aligned
  const int j = threadIdx.x;
  const int b = blockIdx.x;
  const size_t G3 = 3 * size_t(H);

  for (int idx = j; idx < H * 3 * H; idx += H) ws[(idx / (3 * H)) * WS + idx % (3 * H)] = w_hh[idx];
  const float b_r = b_hh[j], b_z = b_hh[H + j], b_n = b_hh[2 * H + j];
  float h = h0[size_t(b) * H + j];
  hs[j] = h;
  float x_r = 0.f, x_z = 0.f, x_n = 0.f;
  if (T > 0) {
    const float* row = xg + size_t(b) * G3;
    x_r = row[j];
    x_z = row[H + j];
    x_n = row[2 * H + j];
  }
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    float nx_r = 0.f, nx_z = 0.f, nx_n = 0.f;
    if (t + 1 < T) {
      const float* row = xg + (size_t(t + 1) * B + b) * G3;
      nx_r = __ldg(row + j);
      nx_z = __ldg(row + H + j);
      nx_n = __ldg(row + 2 * H + j);
    }
    const float* hrow = hs + cur * H;
    float a_r = b_r, a_z = b_z, a_n = b_n;
#pragma unroll 4
    for (int k = 0; k < H; k += 4) {
      const float4 h4 = *reinterpret_cast<const float4*>(hrow + k);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* w = ws + size_t(k + kk) * WS + j;
        a_r = fmaf(hv[kk], w[0], a_r);
        a_z = fmaf(hv[kk], w[H], a_z);
        a_n = fmaf(hv[kk], w[2 * H], a_n);
      }
    }
    const float r = sigmoid_f32(x_r + a_r);
    const float z = sigmoid_f32(x_z + a_z);
    const float n = tanhf(x_n + r * a_n);
    h = (1.f - z) * n + z * h;
    y[(size_t(t) * B + b) * H + j] = h;
    hs[(cur ^ 1) * H + j] = h;
    // Publishes h_t before any thread reads it; also lets h_{t-1}'s buffer
    // be overwritten next step.
    __syncthreads();
    cur ^= 1;
    x_r = nx_r;
    x_z = nx_z;
    x_n = nx_n;
  }
  hn[size_t(b) * H + j] = h;
}

}  // namespace

extern "C" {

// Launches K3 on `stream` (a cudaStream_t) of `device`; returns a cudaError_t
// (0 on success). All pointers are device pointers to contiguous f32 arrays.
// H must be a multiple of 32, at most 128, with 3H^2 + 3H floats in one
// block's shared memory; B >= 1, T >= 0.
int morgana_gru_fwd(const float* xg, const float* w_hh, const float* b_hh, const float* h0,
                    float* y, float* hn, int T, int B, int H, int device, void* stream) {
  if (T < 0 || B < 1 || H < 32 || H % 32 || H > kMaxHidden) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(H);
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(gru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  gru_fwd_kernel<<<B, H, smem, static_cast<cudaStream_t>(stream)>>>(xg, w_hh, b_hh, h0, y, hn, T,
                                                                    B, H);
  return cudaGetLastError();
}

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
