// What the bf16 cluster kernels K1c (csrc/lstm_fwd_bf16.cu) and K2c
// (csrc/lstm_bwd_bf16.cu) share: the split of a layer over the CTAs of a
// thread-block cluster, the cluster barrier, the hand-over of a step's
// vector through distributed shared memory (DSMEM), the choice of how many
// batch rows a cluster carries, and the cluster launch.
//
// Split. A layer of H units (64, 128, 256 or 512; the wrapper pads other
// widths up to these, ops/lstm.py) runs on clusters of kCtas = H / 32 CTAs
// (2 to 16; 16 is a non-portable cluster size). CTA r of a cluster owns the
// kUnits = 32 units u0 = 32 r .. u0 + 31 and their kCols = 128 gate columns,
// numbered c = gate * 32 + unit, and keeps the (H, 128) slice of w_hh that
// its product needs in bf16 in its threads' registers, as mma.sync A
// fragments, for the whole launch: 128 KiB a CTA at H = 512, 2 MiB in the
// cluster. A cluster carries kRows = 8 NT batch rows (NT n8 tiles of
// mma.sync.m16n8k16, the batch being the product's N side); batch rows do
// not interact, so clusters are independent and the launch is a plain
// cluster launch: clusters that do not fit at once queue.
//
// Why 16 CTAs of 128 KiB at H = 512 and not 8 of 256 KiB: 256 KiB is more
// than an SM's 227 KB of shared memory, so half of each slice would sit in
// shared memory and be read again every step (128 KiB of ldmatrix a step,
// about 0.5 us at 128 B a clock), where registers cost no read at all. The
// 16-CTA cluster needs cudaFuncAttributeNonPortableClusterSizeAllowed; plan()
// asks cudaOccupancyMaxActiveClusters how many such clusters fit and
// chip_smoke.py reports it (PERF.md).
//
// A step's hand-over. Every CTA needs the whole vector that the other CTAs'
// units produce (K1c: h_t; K2c: each CTA's partial of dh over its own gate
// columns, which the destination sums). The producer writes its part, 16
// bytes a store, into every CTA of the cluster (map_shared_rank), then
// arrives at the cluster barrier with release semantics and waits with
// acquire semantics: one cluster barrier a step, in place of K1/K2's
// grid.sync and exchange through L2. The receiving buffers alternate
// between two, so a step's writes never meet a slower CTA's reads of the
// step before.
//
// NT. plan() takes the fewest batch rows a cluster (NT = 1, 2, then 4 for
// K1c; 1, then 2 for K2c, whose shared memory holds no more) for which
// every cluster of the launch is resident at once, and the largest NT when
// none is: per step a cluster's product grows with NT while its
// barrier and hand-over do not, so one wave of larger clusters beats two
// waves of smaller ones.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_common.cuh"
#include "lstm_common.cuh"

namespace lstmc {

constexpr int kUnits = 32;         // hidden units a CTA
constexpr int kCols = 4 * kUnits;  // its gate columns, c = gate * kUnits + unit
constexpr int kRing = 4;           // steps of streamed inputs in flight (cp.async)
constexpr int kMaxDevices = 16;    // devices whose kernel attributes are cached

template <int H>
struct Width {
  static_assert(H == 64 || H == 128 || H == 256 || H == 512, "H is 64, 128, 256 or 512");
  static constexpr int kCtas = H / kUnits;  // CTAs a cluster
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  return int(cooperative_groups::this_cluster().block_rank());
}

// p in this CTA's shared memory, as the same offset in CTA `rank`'s.
template <typename T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

// 16-byte vectors of this CTA's shared memory into every one of the n
// CTAs of the cluster: vector q of the `vectors` bound for CTA `rank` goes
// from src_of(rank, q) here to dst_of(rank, q) there (an address of this
// CTA's shared memory, mapped); the (rank, q) pairs are spread over the
// block's threads.
template <typename Src, typename Dst>
__device__ __forceinline__ void publish(int n, int vectors, int threads, Src src_of, Dst dst_of) {
  for (int i = int(threadIdx.x); i < n * vectors; i += threads) {
    const int rank = i / vectors, q = i % vectors;
    *reinterpret_cast<uint4*>(peer(dst_of(rank, q), rank)) =
        *reinterpret_cast<const uint4*>(src_of(rank, q));
  }
}

// The cluster launch of `kernel`: `ctas` CTAs a cluster of `threads`
// threads, `smem` bytes of dynamic shared memory.
struct Config {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attribute;
  Config(int ctas, int clusters, int threads, size_t smem, cudaStream_t stream) {
    config.gridDim = dim3(unsigned(clusters * ctas));
    config.blockDim = dim3(unsigned(threads));
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    attribute.id = cudaLaunchAttributeClusterDimension;
    attribute.val.clusterDim.x = unsigned(ctas);
    attribute.val.clusterDim.y = 1;
    attribute.val.clusterDim.z = 1;
    config.attrs = &attribute;
    config.numAttrs = 1;
  }
};

// Sets the kernel's shared-memory and cluster-size attributes on `device`
// (once) and gives how many of its clusters fit at once: 0 when none does.
// `cached` is the kernel's own cache, [kMaxDevices] of clusters + 1, 0
// before the first query.
template <typename... Params>
cudaError_t fit(void (*kernel)(Params...), int ctas, int threads, size_t smem, int device,
                int& clusters, int* cached) {
  if (device >= 0 && device < kMaxDevices && cached[device] > 0) {
    clusters = cached[device] - 1;
    return cudaSuccess;
  }
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  if (ctas > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  Config c(ctas, 1, threads, smem, nullptr);
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &c.config);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < kMaxDevices) cached[device] = clusters + 1;
  return cudaSuccess;
}

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int ctas, int clusters, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  Config c(ctas, clusters, threads, smem, stream);
  const cudaError_t err = cudaLaunchKernelEx(&c.config, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The batch rows a cluster: the first n8-tile count of `tiles` (ascending)
// whose ceil(B / (8 NT)) clusters all fit at once (fits[i] of tiles[i]),
// else the last. Returns its index in tiles.
inline int plan(int B, const int* tiles, const int* fits, int n) {
  for (int i = 0; i < n; ++i)
    if ((B + 8 * tiles[i] - 1) / (8 * tiles[i]) <= fits[i]) return i;
  return n - 1;
}

}  // namespace lstmc
