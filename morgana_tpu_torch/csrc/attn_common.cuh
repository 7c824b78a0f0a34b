// Shared by the attention kernels K5/K6 (attn_fwd.cu, attn_bwd.cu): the
// visibility rule of the masks, the products on the tensor cores in 3xTF32,
// and the asynchronous tile copies.
//
// Products. A block is 4 warps; each warp owns a 16-row tile of one side of
// every product and runs it as mma.sync.m16n8k8 in TF32. Each f32 operand x
// is split into hi (x truncated to TF32) and lo = x - hi, and the three
// terms lo.hi + hi.lo + hi.hi are accumulated in f32 registers: within a few
// 2^-20 of f32 for 3x the TF32 work, where one TF32 term alone misses the
// forward's 1e-4 by 4-8x (tests/test_torch_attention.py emulates both).
// Lane = 4 g + t holds the PTX fragments: A rows g and g + 8 at columns t and
// t + 4; B column g at rows t and t + 4; C rows g and g + 8 at columns 2t and
// 2t + 1. A product whose A operand is a C fragment in registers (P or dS)
// reads its depth permuted: fragment column t is C column 2t and t + 4 is
// 2t + 1 (a_from_c), and the B operand is read with the same permutation
// (load_b4_cols), so P and dS never pass through shared memory. Fragments
// are read 16 bytes a lane (the layouts below), and each product's three
// terms are issued term by term across its column tiles, so that 4-12
// accumulator chains are in flight.
//
// Tiles arrive in shared memory by cp.async, 16 bytes a thread, rows past T
// zero-filled, into a ring of kStages stages: the next tile is in flight
// while the current one is computed. Their row strides keep every fragment
// read conflict-free (kRowStride, kColStride).
//
// Elem is the element type of q, k, v, o and the gradients in device memory
// and shared memory (IoOps<Elem> reads and writes it); every product and sum
// is f32. Only Elem = float is built.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;     // rows of a block's own tile (queries, or keys in dk/dv)
constexpr int kStages = 2;    // the ring of streamed tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename Elem>
struct IoOps;

template <>
struct IoOps<float> {
  __device__ __forceinline__ static float load(const float* p) { return *p; }
  __device__ __forceinline__ static float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
};

// Row strides of shared tiles, in floats. kRowStride (= 16 mod 32) for a
// tile read only along its rows; kColStride (= 4 mod 32) for one also read
// down its columns. In 16-byte units a quarter warp (lanes 4g + t, g < 2)
// then reads row g, column 4t (rows) or rows 2t, 2t + 1, column 4g (columns)
// from 8 distinct bank quads; a kColStride tile read along its rows takes
// two passes.
template <int DH>
constexpr int kRowStride = DH + 16;
template <int DH>
constexpr int kColStride = DH + 4;

// Whether query i sees key j of a batch row of length len (<= T): both below
// len (a padded query row sees no key), and j <= i when causal, i - j <
// window with a window.
__device__ __forceinline__ bool visible(int i, int j, int len, int causal, int window) {
  return i < len && j < len && (!causal || j <= i) && (window <= 0 || i - j < window);
}

// ---- 3xTF32 on mma.sync.m16n8k8 ----

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

// hi: x with its 13 low mantissa bits cleared, the TF32 value the tensor core
// reads; lo = x - hi, exact in f32 and passed whole: the tensor core reads its
// TF32 truncation. Two instructions; cvt.rna.tf32.f32 takes three for hi
// alone. Each product then errs by < 3 * 2^-20 relative.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[n] += a . b[n] for N column tiles in 3xTF32: term by term across the
// tiles, the small terms first, so that N accumulator chains are in flight.
template <int N>
__device__ __forceinline__ void mma3(float (*d)[4], const FragA& a, const FragB (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.lo, b[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.hi, b[n].lo);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.hi, b[n].hi);
}

// Fragments are read 16 bytes a lane. Along a row (the depth of q.k^T and
// do.v^T), a 16-deep chunk c serves two k-steps: lane t reads depths 16c + 4t
// .. + 3, and k-step 2c takes the first two as its fragment columns (A) or
// rows (B) t and t + 4, k-step 2c + 1 the last two. The sum over the depth
// does not care, as long as A and B agree. Down a column (the depth is the
// key or query axis, B from load_b4_cols), a 32-wide chunk c of columns
// serves four column tiles: lane g reads columns 32c + 4g .. + 3 of rows
// k0 + 2t and k0 + 2t + 1, and tile j takes column 32c + 4g + j as its
// fragment column g. The C fragment of tile 4c + j then holds columns
// 32c + 8t + j and 32c + 8t + 4 + j (store_c4).

template <typename Elem>
__device__ __forceinline__ float4 ld4(const Elem* p) {
  return IoOps<Elem>::load4(p);
}

// A of k-steps 2c and 2c + 1 from the two 16-byte reads of rows g and g + 8.
__device__ __forceinline__ void split_a2(const float4& x, const float4& y, FragA& a0, FragA& a1) {
  a0 = split_a(x.x, y.x, x.y, y.y);
  a1 = split_a(x.z, y.z, x.w, y.w);
}

// B of k-steps 2c and 2c + 1 for columns n0 .. n0 + 7, B[kk][n] = m[n0 + n][.].
template <typename Elem, int S>
__device__ __forceinline__ void load_b2_rows(const Elem* m, int n0, int c, int g, int t,
                                             FragB& b0, FragB& b1) {
  const float4 x = ld4(m + (n0 + g) * S + 16 * c + 4 * t);
  b0 = split_b(x.x, x.y);
  b1 = split_b(x.z, x.w);
}

// B of the k-step at rows k0 + 2t, k0 + 2t + 1 of m (the depth permuted as
// a_from_c's) for the four column tiles of chunk c.
template <typename Elem, int S>
__device__ __forceinline__ void load_b4_cols(const Elem* m, int k0, int c, int g, int t,
                                             FragB* b) {
  const float4 x = ld4(m + (k0 + 2 * t) * S + 32 * c + 4 * g);
  const float4 y = ld4(m + (k0 + 2 * t + 1) * S + 32 * c + 4 * g);
  b[0] = split_b(x.x, y.x);
  b[1] = split_b(x.y, y.y);
  b[2] = split_b(x.z, y.z);
  b[3] = split_b(x.w, y.w);
}

// A from the C fragment of columns 8 kk .. 8 kk + 7 of a product held in
// registers: fragment column t is C column 2t, t + 4 is 2t + 1, which
// load_b4_cols's rows match.
__device__ __forceinline__ FragA a_from_c(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// Row r (0: g, 1: g + 8) of the C fragments of the four column tiles of
// chunk c, times `scale`, to the row's columns 32c + 8t .. + 7.
template <typename Elem>
__device__ __forceinline__ void store_c4(Elem* row, float (*acc)[4], int c, int r, int t,
                                         float scale) {
  IoOps<Elem>::store4(row + 32 * c + 8 * t,
                      make_float4(acc[0][2 * r] * scale, acc[1][2 * r] * scale,
                                  acc[2][2 * r] * scale, acc[3][2 * r] * scale));
  IoOps<Elem>::store4(row + 32 * c + 8 * t + 4,
                      make_float4(acc[0][2 * r + 1] * scale, acc[1][2 * r + 1] * scale,
                                  acc[2][2 * r + 1] * scale, acc[3][2 * r + 1] * scale));
}

// 2^x on the SFU (MUFU.EX2), 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the 4 lanes of a quad (the lanes that share C rows).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- asynchronous copies ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of a (T, DH) matrix into dst (row stride S), rows
// past T as zeros; issued by the whole block, not committed.
template <typename Elem, int DH, int S, int ROWS>
__device__ __forceinline__ void copy_tile_async(Elem* dst, const Elem* __restrict__ src, int r0,
                                                int T) {
  constexpr int kVec = 16 / int(sizeof(Elem));
  constexpr int kChunks = DH / kVec;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool valid = r0 + r < T;
    cp_async16(dst + r * S + c * kVec, src + size_t(valid ? r0 + r : 0) * DH + c * kVec, valid);
  }
}

// ROWS floats of a (T,) vector from r0 on into dst, past T as zeros.
template <int ROWS>
__device__ __forceinline__ void copy_vec_async(float* dst, const float* __restrict__ src, int r0,
                                               int T) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    const bool valid = r0 + r < T;
    cp_async4(dst + r, src + (valid ? r0 + r : 0), valid);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem, int device) {
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

}  // namespace attn
