// What K3 (csrc/gru_fwd.cu) and K4 (csrc/gru_bwd.cu) share: the thread
// layout over a row's (H, 3H) product, the slice of w_hh each thread keeps
// in registers, the hand-over of a step's vector between the CTAs of a
// cluster, the gate functions and the cp.async ring that takes the streamed
// inputs off the step-to-step chain.
//
// Layout. Each batch row is carried by a cluster of kCtas CTAs: one up to
// H = 96, two at H = 128. CTA c owns the
// kUnits = H / kCtas hidden units from c * kUnits, with 4 threads a unit:
// thread (u, s) owns unit u and slice s of 4. A warp holds 8 units: lane =
// s * 8 + (u % 8), so the 4 partial sums of a unit sit in lanes 8 apart and
// two __shfl_xor_sync (by 8, 16) reduce them, every lane ending with the
// whole sum. Each thread keeps 3H/4 floats of w_hh in registers as kGroups
// float4 groups: group q covers the 4 consecutive indices q * 16 + s * 4 +
// {0..3} of the reduced dimension (K3: k within gate q / (H/16); K4: the
// gate column c). The 4 slices of a group are 64 consecutive bytes of the
// vector broadcast in shared memory, read by one float4 load a lane without
// bank conflicts.
//
// Why a cluster at H = 128: w_hh is 192 KB there, and one CTA's registers
// (256 KB an SM) cannot hold it beside everything else; two CTAs on two SMs
// hold 96 floats a thread each. Every CTA keeps the whole vector a step
// reads (h in K3, dg in K4): the owner of a unit writes its values into its
// own and its peer's shared memory (distributed shared memory), and one
// cluster barrier a step publishes them. With one CTA the barrier is the
// block's.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace gru {

constexpr int kSlices = 4;     // slices a unit: lanes u, u + 8, u + 16, u + 24
constexpr int kRing = 8;       // steps in flight in the cp.async ring

template <int H>
struct Shape {
  static_assert(H % 32 == 0 && H >= 32 && H <= 128, "H is a multiple of 32 up to 128");
  static constexpr int kCtas = H > 96 ? 2 : 1;          // CTAs a cluster
  static constexpr int kUnits = H / kCtas;              // hidden units a CTA
  static constexpr int kThreads = kSlices * kUnits;
  static constexpr int kGroups = 3 * H / 16;            // float4 groups a thread
};

__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// tanh(x) = 2 sigmoid(2x) - 1: exp2 and a reciprocal, within ~1e-7 abs.
__device__ __forceinline__ float tanh_fast(float x) {
  return __fdividef(2.f, 1.f + __expf(-2.f * x)) - 1.f;
}

// Sum of v over the 4 slices of a unit (lanes 8 apart); every lane gets it.
__device__ __forceinline__ float slice_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kRing - 2 of this thread's groups are in flight: the
// ring keeps kRing - 1 steps ahead of the one being read.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
}

// One thread's slice of w_hh: element e of group q is at(q * 16 + s * 4 + e),
// a function of the reduced index.
template <int H, typename At>
__device__ __forceinline__ void load_slice(float4 (&w)[Shape<H>::kGroups], int s, At at) {
#pragma unroll
  for (int q = 0; q < Shape<H>::kGroups; ++q) {
    const int i = q * 16 + s * 4;
    w[q] = make_float4(at(i), at(i + 1), at(i + 2), at(i + 3));
  }
}

// The cluster of CTAs that carries a block of rows.
template <int H>
struct Cluster {
  __device__ __forceinline__ static int rank() {
    if constexpr (Shape<H>::kCtas > 1) return int(cooperative_groups::this_cluster().block_rank());
    return 0;
  }
  // Writes v at p in this CTA's shared memory and at the same place in the
  // peer's.
  __device__ __forceinline__ static void store(float* p, float v) {
    *p = v;
    if constexpr (Shape<H>::kCtas > 1)
      *cooperative_groups::this_cluster().map_shared_rank(p, rank() ^ 1) = v;
  }
  // Publishes every store before it to every thread of the cluster.
  __device__ __forceinline__ static void sync() {
    if constexpr (Shape<H>::kCtas > 1) {
      cooperative_groups::this_cluster().sync();
    } else {
      __syncthreads();
    }
  }
};

// Launches kernel over B clusters of Shape<H>::kCtas CTAs, one a batch row.
template <int H, typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int B, size_t smem, int device,
                            cudaStream_t stream, Args... args) {
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(unsigned(B * Shape<H>::kCtas));
  config.blockDim = dim3(Shape<H>::kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeClusterDimension;
  attribute.val.clusterDim.x = Shape<H>::kCtas;
  attribute.val.clusterDim.y = 1;
  attribute.val.clusterDim.z = 1;
  config.attrs = &attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace gru
