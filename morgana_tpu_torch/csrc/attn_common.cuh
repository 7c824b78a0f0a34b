// Tiles shared by the attention kernels K5/K6 (attn_fwd.cu, attn_bwd.cu):
// 64-row tiles in shared memory, a 16 x 16 grid of 256 threads, and the
// visibility rule of the masks. Thread (ty, tx) owns tile rows ty + 16 i
// (i < 4) and columns tx + 16 j; the 16 threads of a row are one half warp.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace attn {

constexpr int kTile = 64;              // query rows, and keys, per tile
constexpr int kThreads = 256;          // a 16 x 16 grid of threads
constexpr int kPStride = kTile + 4;    // row stride of the probability tile

// Whether query i sees key j of a batch row of length len (<= T): both below
// len (a padded query row sees no key), and j <= i when causal, i - j <
// window with a window.
__device__ __forceinline__ bool visible(int i, int j, int len, int causal, int window) {
  return i < len && j < len && (!causal || j <= i) && (window <= 0 || i - j < window);
}

// Rows [r0, r0 + 64) of a (T, DH) matrix into shared memory with row stride
// DH + 4, rows past T as zeros.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0, int T) {
  constexpr int kVec = DH / 4;
  for (int idx = threadIdx.x; idx < kTile * kVec; idx += kThreads) {
    const int r = idx / kVec, c = idx % kVec;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) val = __ldg(reinterpret_cast<const float4*>(src + size_t(r0 + r) * DH) + c);
    *reinterpret_cast<float4*>(dst + r * (DH + 4) + 4 * c) = val;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * Bm[tx + 16 j][d]; A and Bm have row
// stride DH + 4.
template <int DH>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A, const float* Bm,
                                         int ty, int tx) {
  constexpr int S = DH + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * S + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * S + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][c] += sum_k M[ty + 16 i][k] * N[k][tx + 16 c] over k < 64; M has row
// stride kPStride, N row stride DH + 4.
template <int DH>
__device__ __forceinline__ void tile_acc(float (&acc)[4][DH / 16], const float* M, const float* N,
                                         int ty, int tx) {
  constexpr int S = DH + 4;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = *reinterpret_cast<const float4*>(M + (ty + 16 * i) * kPStride + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float n[DH / 16];
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) n[c] = N[(k + kk) * S + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float mv = kk == 0 ? m[i].x : kk == 1 ? m[i].y : kk == 2 ? m[i].z : m[i].w;
#pragma unroll
        for (int c = 0; c < DH / 16; ++c) acc[i][c] = fmaf(mv, n[c], acc[i][c]);
      }
    }
  }
}

// Max and sum over the 16 threads of a row (one half warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace attn
