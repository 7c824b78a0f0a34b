// What K1 (csrc/lstm_fwd.cu) and K2 (csrc/lstm_bwd.cu) share: the split of
// a layer over the blocks, the storage type, the step barrier and the
// per-step clock records.
//
// Split. Block j owns the U hidden units u0 = j U .. u0 + U - 1 with all
// four of their gates: the block's kCols = 4U columns of a (B, 4H) row,
// numbered c = gate * U + unit. The product of a step needs w_hh's rows or
// columns of those units in every block, so each block keeps a slice of
// w_hh (H x 4U: 32 KB in f32 at H = 512 for K1's 128 blocks, 64 KB for K2's
// 64; 128 KB for either's 128 blocks at H = 1024) in its threads' registers
// for the whole launch, and the blocks
// exchange one vector a step through L2 (K1: h_t through y; K2: the partial
// sums of dh), then meet at a grid-wide barrier. The launch is cooperative,
// so a grid whose blocks cannot all be resident at once is refused rather
// than left to deadlock.
//
// Storage. Store is float or __nv_bfloat16 (MORGANA_PALLAS_STORE, the
// storage type of morgana_tpu/ops/pallas_rnn.py::_store_dtype): the
// streamed tensors and w_hh are read and written as Store, every product
// and sum, the carried state and the exchanged partials are f32. K1 has a
// second type, Compute, that of the operands of its product: w_hh in
// registers and the staged h are rounded to it (rounded<Compute>, round to
// nearest even as XLA's astype), and held as f32 or, K1s's staged h, as
// bf16. K1 is <float, float>, K1s <bf16, bf16>, K1c <float, bf16> (the
// scan backend's bf16 compute dtype).
//
// StepClock: the per-step clock records of the step_split build
// (-DMORGANA_STEP_SPLIT, _build.VARIANTS), which the main path's libraries
// never contain. Thread 0 of block 0 and of the middle block adds the
// clock64 cycles of each phase of a step (after a block-wide barrier where
// the phase ends at one) and writes them for the first `steps` steps, with
// clock64 and globaltimer at the launch's start and end so that cycles can be
// turned into nanoseconds. With kOn false every member is empty.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace lstm {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBatch = 256;

// kMaxBlocks blocks (fewer at small H) of U units each. The wrapper
// (ops/lstm.py) pads a layer of another width with zero units up to the next
// of these.
template <int H, int kMaxBlocks>
struct Split {
  static_assert(H == 64 || H == 128 || H == 256 || H == 512 || H == 1024,
                "H is 64, 128, 256, 512 or 1024");
  static constexpr int U = H > kMaxBlocks ? H / kMaxBlocks : 1;  // units a block
  static constexpr int kBlocks = H / U;
  static constexpr int kCols = 4 * U;
};

// ---------------------------------------------------------------- storage

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename Store>
__device__ __forceinline__ Store from_f32(float v) {
  if constexpr (sizeof(Store) == 2) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

// v rounded to Compute and back to f32 (v itself for float).
template <typename Compute>
__device__ __forceinline__ float rounded(float v) {
  return to_f32(from_f32<Compute>(v));
}

// N consecutive Store values at p (aligned to their size, 16 bytes where N
// of them fill 16) as f32.
template <int N, typename Store>
__device__ __forceinline__ void load_f32(const Store* p, float (&out)[N]) {
  constexpr int kPer = 16 / int(sizeof(Store));  // values in 16 bytes
  if constexpr (N % kPer == 0) {
#pragma unroll
    for (int v = 0; v < N / kPer; ++v) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[v];
      const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(Store) == 2) {  // bf16: the upper 16 bits of an f32
          out[v * kPer + 2 * i] = __uint_as_float(words[i] << 16);
          out[v * kPer + 2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
        } else {
          out[v * kPer + i] = __uint_as_float(words[i]);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

// ------------------------------------------------------------- the barrier

// How the blocks meet after a step: cooperative groups' grid.sync(), which
// returns when every block has arrived, with every block's writes before it
// visible. An arrival counter with release/acquire ordering was measured
// against it and was slower (PERF.md §7), so it is not kept.
__device__ __forceinline__ void grid_barrier() { cooperative_groups::this_grid().sync(); }

// ------------------------------------------------------------- cp.async

// 16 bytes from global to shared memory through L2 only (the source was
// written by other blocks during this launch).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------- gates

// exp2 and a reciprocal: within ~1e-7 abs of the accurate functions.
__device__ __forceinline__ float sigmoid_fast(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }
__device__ __forceinline__ float tanh_fast(float x) {
  return __fdividef(2.f, 1.f + __expf(-2.f * x)) - 1.f;
}

// ------------------------------------------------------------- StepClock

// The phases of a step, in the order of a record.
enum Phase { kExchange = 0, kProduct = 1, kReduction = 2, kGates = 3, kBarrierWait = 4, kPhases = 5 };

// Entries of a block's record: [steps][kPhases] cycles, then clock64 and
// globaltimer at the start and at the end.
__host__ __device__ constexpr int split_record(int steps) { return steps * kPhases + 4; }

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool kOn>
struct StepClock {
  long long* rec = nullptr;  // this block's record; null in threads that record nothing
  int steps = 0;
  long long last = 0;
  long long acc[kPhases];

  // out holds two records (block 0, then the middle block) of `steps` steps.
  __device__ __forceinline__ StepClock(long long* out, int steps_) {
    if constexpr (kOn) {
      const int slot = blockIdx.x == 0 ? 0 : (blockIdx.x == gridDim.x / 2 ? 1 : -1);
      if (out != nullptr && threadIdx.x == 0 && slot >= 0) {
        rec = out + size_t(slot) * split_record(steps_);
        steps = steps_;
        rec[steps * kPhases] = clock64();
        rec[steps * kPhases + 1] = global_ns();
      }
    }
  }
  __device__ __forceinline__ void begin() {
    if constexpr (kOn) {
      if (rec) {
#pragma unroll
        for (int p = 0; p < kPhases; ++p) acc[p] = 0;
        last = clock64();
      }
    }
  }
  // Adds the cycles since the last mark to `phase`.
  __device__ __forceinline__ void mark(int phase) {
    if constexpr (kOn) {
      if (rec) {
        const long long now = clock64();
        acc[phase] += now - last;
        last = now;
      }
    }
  }
  // Writes the step's record when `i`, the step's place in the launch, is
  // among the first `steps`.
  __device__ __forceinline__ void end_step(int i) {
    if constexpr (kOn) {
      if (rec && i < steps) {
#pragma unroll
        for (int p = 0; p < kPhases; ++p) rec[size_t(i) * kPhases + p] = acc[p];
      }
    }
  }
  __device__ __forceinline__ void finish() {
    if constexpr (kOn) {
      if (rec) {
        rec[steps * kPhases + 2] = clock64();
        rec[steps * kPhases + 3] = global_ns();
      }
    }
  }
};

// ------------------------------------------------------------- launching

template <typename T>
struct Same {
  using type = T;
};

// Launches `kernel` cooperatively over `blocks` blocks of kThreads with
// `smem` bytes of dynamic shared memory; a cudaError_t. The arguments take
// the kernel's parameter types, whose values the launch copies.
template <typename... Params>
cudaError_t launch(void (*kernel)(Params...), int blocks, size_t smem, int device,
                   cudaStream_t stream, typename Same<Params>::type... args) {
  int max_smem = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem) || sms < blocks) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  void* argv[] = {&args...};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                    dim3(kThreads), argv, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace lstm
