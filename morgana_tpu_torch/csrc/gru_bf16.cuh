// What the bf16 GRU kernels K3c (csrc/gru_fwd_bf16.cu) and K4c
// (csrc/gru_bwd_bf16.cu) share: one CTA at every width (32, 64, 96, 128),
// with w_hh held in bf16 for the whole launch (K3c as mma.sync A fragments,
// K4c as packed pairs), where the f32 kernels csrc/gru_fwd.cu and
// csrc/gru_bwd.cu need a 2-CTA cluster at H = 128; the row's length; the
// depth of a cp.async ring; the launch.
//
// K3c's staged vector bf16(h) is a double-buffered shared tile [column][k]
// that the next step reads as B fragments with ldmatrix; its row stride is
// 16 bytes mod 128 (H + 8 bf16), so the eight rows of an ldmatrix hit eight
// distinct 16-byte bank groups. Its streamed xg comes in by cp.async into a
// ring of kRing steps, issued by copy warps of their own beside the compute
// warps: each step a copy warp puts the step kRing - 1 ahead in flight,
// waits for the next step's, and meets the compute warps at the step's
// barrier, so the compute warps issue no copy and never wait for one (at H
// = 64 a handful of compute warps share four schedulers, so every
// instruction they skip shortens the step).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_common.cuh"
#include "gru_common.cuh"
#include "lstm_common.cuh"

namespace grub {

constexpr int kMaxBatch = 1 << 24;  // rows a launch: the grid is B CTAs at most

// The depth of a ring of `slot`-byte steps beside `fixed` bytes of shared
// memory: 8 where they fit 200 KB of the 227 KB a CTA may take, else 4.
constexpr int ring_depth(size_t slot, size_t fixed) {
  return fixed + 8 * slot <= 200 * 1024 ? 8 : 4;
}

// The row's length: T without seq_len, else seq_len clamped to [0, T]; 0
// past B.
__device__ __forceinline__ int row_len(const long long* __restrict__ seq_len, int b, int B, int T) {
  if (b >= B) return 0;
  if (seq_len == nullptr) return T;
  return int(min(max(seq_len[b], 0LL), (long long)T));
}

// A 16-byte cp.async of `bytes` (16, or 0 to zero-fill dst) bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

// The step's barrier of all the CTA's warps, compute and copy, reached
// from the two roles' own code (a warp-uniform branch): bar.sync 0 counts
// the warps that arrive, as __syncthreads does.
__device__ __forceinline__ void step_barrier() { asm volatile("bar.sync 0;\n" ::: "memory"); }

// Launches `kernel` over `blocks` CTAs of `threads` with `smem` bytes of
// dynamic shared memory; a cudaError_t.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int blocks, int threads, size_t smem, int device,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = attn::set_smem(kernel, smem, device);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace grub
