// The bf16 weight-gradient carry: dW_hh of an LSTM or GRU layer under a
// bf16 compute dtype, on Hopper (sm_90a), shared by both layers
// (ops/weight_grad.py).
//
// Replaces what JAX's autodiff of the scan of morgana_tpu/ops/rnn.py::lstm
// (:120-126) and ::gru (:351-355) computes for w_hh when compute_dtype is
// bf16. w_hh enters the scan's body as a bf16 constant (w_hh_c), so the
// scan's transpose carries its cotangent in a bf16 carry: each step's
// contribution, the f32 product of the bf16 h_{t-1} and the f32 gate
// gradients summed over the batch, is rounded to bf16 and added into the
// carry with bf16 rounding, walking t from T-1 down to 0:
//
//     dW = 0
//     for t = T-1 .. 0:
//         dW = round(dW + round(sum_b round(h_prev[t, b, k]) * dg[t, b, c]))
//
// with round() to bf16 (to nearest even, as XLA's convert). Inputs: h_prev
// (T, B, H), the state each step's product read (h0 at t = 0, then y), and
// dg (T, B, G) the gradients of that product's G = 4H (LSTM) or 3H (GRU)
// gate columns, both f32 with their last dimension contiguous and any
// strides for t and b (the GRU's are batch-major). Output: dW (H, G) in
// f32, each value a bf16 value.
//
// What bounds it. H * G * T * B multiply-adds, one chain of T roundings an
// element: at the LSTM's B32 T1024 H512 34 G multiply-adds a layer, about
// 1.0 ms at 67 TFLOP/s in f32, against 0.1 ms of bytes (h_prev and dg read
// once): operations. A sum of f32 products is the function, so the tensor
// cores' TF32 or bf16 would be another one.
//
// Design: plain first. A block of 256 threads (16 x 16) owns a 16R x 16R
// tile of dW, a thread R x R elements (R = 4 at the LSTM's widths, smaller
// where the tiles would not fill the card), each element's carry in a
// register for the whole launch. A step stages kChunk batch rows of h_prev
// (rounded) and dg for the tile's rows and columns in shared memory, each
// thread sums its elements' products over the rows, and after the last
// chunk rounds them into its carries. The steps run in order inside the
// block: the rounding makes the sum over t sequential.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // batch rows staged at a time

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int R>
__global__ void __launch_bounds__(kThreads)
rnn_dw_bf16_kernel(const float* __restrict__ h_prev, const float* __restrict__ dg,
                   float* __restrict__ dw, int T, int B, int H, int G, long long hs_t,
                   long long hs_b, long long gs_t, long long gs_b) {
  constexpr int BM = 16 * R, BN = 16 * R;
  __shared__ __align__(16) float hs[kChunk][BM];
  __shared__ __align__(16) float gs[kChunk][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.y * BM, c0 = blockIdx.x * BN;

  // Element (i, j): row k0 + ty R + i, column c0 + tx R + j.
  float carry[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) carry[i][j] = 0.f;

  for (int t = T - 1; t >= 0; --t) {
    float sum[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) sum[i][j] = 0.f;
    for (int b0 = 0; b0 < B; b0 += kChunk) {
      const int rows = min(kChunk, B - b0);
      for (int e = threadIdx.x; e < kChunk * BM; e += kThreads) {
        const int b = e / BM, k = e % BM;
        hs[b][k] = b < rows && k0 + k < H
                       ? round_bf16(h_prev[t * hs_t + (b0 + b) * hs_b + k0 + k])
                       : 0.f;
      }
      for (int e = threadIdx.x; e < kChunk * BN; e += kThreads) {
        const int b = e / BN, c = e % BN;
        gs[b][c] = b < rows && c0 + c < G ? dg[t * gs_t + (b0 + b) * gs_b + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int b = 0; b < rows; ++b) {
        float hv[R], gv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) hv[i] = hs[b][ty * R + i];
#pragma unroll
        for (int j = 0; j < R; ++j) gv[j] = gs[b][tx * R + j];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) sum[i][j] = fmaf(hv[i], gv[j], sum[i][j]);
      }
      __syncthreads();  // the next chunk rewrites the tiles
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) carry[i][j] = round_bf16(carry[i][j] + round_bf16(sum[i][j]));
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int k = k0 + ty * R + i;
    if (k >= H) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = c0 + tx * R + j;
      if (c < G) dw[size_t(k) * G + c] = carry[i][j];
    }
  }
}

template <int R>
int run(const float* h_prev, const float* dg, float* dw, int T, int B, int H, int G,
        long long hs_t, long long hs_b, long long gs_t, long long gs_b, cudaStream_t stream) {
  const dim3 grid((G + 16 * R - 1) / (16 * R), (H + 16 * R - 1) / (16 * R));
  rnn_dw_bf16_kernel<R><<<grid, kThreads, 0, stream>>>(h_prev, dg, dw, T, B, H, G, hs_t, hs_b,
                                                       gs_t, gs_b);
  return cudaGetLastError();
}

// Tiles of 16R x 16R: the largest R whose grid still gives every SM a block.
int tile_side(int H, int G, int sms) {
  for (int r = 4; r > 1; r /= 2) {
    const long long blocks = (long long)((H + 16 * r - 1) / (16 * r)) * ((G + 16 * r - 1) / (16 * r));
    if (blocks >= sms) return r;
  }
  return 1;
}

}  // namespace

extern "C" {

// Launches the carry on `stream` (a cudaStream_t) of `device`; returns a
// cudaError_t (0 on success). h_prev (T, B, H) and dg (T, B, G) are f32
// device arrays whose last dimension is contiguous, element (t, b, .) at
// t * stride_t + b * stride_b (in floats); dw is a contiguous f32 (H, G)
// array. T >= 0, B >= 1, H >= 1, G >= 1 and 65535 tiles of rows at most.
int morgana_rnn_dw_bf16(const float* h_prev, const float* dg, float* dw, int T, int B, int H,
                        int G, long long hs_t, long long hs_b, long long gs_t, long long gs_b,
                        int device, void* stream) {
  if (T < 0 || B < 1 || H < 1 || G < 1 || H > 65535 * 16) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_side(H, G, sms)) {
    case 4: return run<4>(h_prev, dg, dw, T, B, H, G, hs_t, hs_b, gs_t, gs_b, s);
    case 2: return run<2>(h_prev, dg, dw, T, B, H, G, hs_t, hs_b, gs_t, gs_b, s);
    default: return run<1>(h_prev, dg, dw, T, B, H, G, hs_t, hs_b, gs_t, gs_b, s);
  }
}

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
