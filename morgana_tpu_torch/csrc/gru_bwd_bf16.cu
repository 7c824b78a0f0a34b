// K4c: one GRU layer's backward with bf16 products, on Hopper (sm_90a).
//
// Replaces, as the autodiff of the 'scan' backend's bf16 recurrence (K3c;
// morgana_tpu/ops/rnn.py:332-375 under compute_dtype bfloat16),
// morgana_tpu/ops/pallas_gru.py::_gru_bwd_kernel (driven there by
// _core_bwd). Same function as K4 (csrc/gru_bwd.cu) with JAX's bf16
// roundings: walking time backwards from dh = dhn, each step takes the
// gates r, z, n from xg and hg = bf16(h_{t-1}) @ bf16(w_hh) + b_hh (one
// GEMM outside, ops/gru.py hidden_gates), then
//
//     dh   = dy_t + dh
//     da_n = dh * (1 - z) * (1 - n^2)
//     da_z = dh * (h_{t-1} - n) * z * (1 - z)
//     da_r = da_n * hg_n * r * (1 - r)
//     dxg_t = [da_r, da_z, da_n]
//     dh   = dh * z + bf16([da_r, da_z, da_n * r] @ bf16(w_hh)^T)
//
// the carried product an f32 x bf16 product with f32 sums, rounded to bf16
// before it joins dy; the gate gradients and dh0 f32. Inputs, batch-major:
// xg, hg (B, T, 3H); w_hh (H, 3H); h0 (B, H); y (B, T, H), K3c's h trace;
// dy (B, T, H), dhn (B, H), f32, and optionally seq_len (B) in int64: dy is
// 0 past each row's length and dhn enters at step seq_len - 1 (at dh0 for
// an empty row). Outputs: dxg (B, T, 3H), dnr = da_n * r (B, T, H), dh0
// (B, H), as K4.
//
// What bounds it. One dependent product a step, 2 * B * H * 3H mixed flops,
// on a (B, 3H) vector of the step itself: the step-to-step latency bounds
// the layer far above its bytes and flops.
//
// Design: K4's layout in one CTA of 4H threads a batch row at every width
// (512 at H = 128), with no cluster: thread (u, s) keeps a quarter of row u
// of w_hh as packed bf16 pairs (3H / 8 registers) for the whole launch and
// widens them exactly to f32 for its fused multiply-adds with the f32 dg
// broadcast from shared memory, in two chains (even and odd 4-column
// groups); two __shfl_xor_sync add the four slices. Lane s = 0 of a unit
// brings its streamed inputs (xg, hg, h_{t-1}, dy) in by cp.async kRing - 1
// steps ahead and reads them itself, so no barrier guards the ring; one
// __syncthreads a step publishes dg.
//
// Why SIMT and not the tensor cores: a route with 8 batch rows a CTA on the
// N side of mma.sync.m16n8k16 and dg as three exact bf16 planes (as K2c)
// took 3.27-3.36 us a step at H64 and 3.32-3.33 at H128, against this
// design's 0.427 and 1.053 (chip_smoke.py's k4c_step_split, PERF.md §6):
// the three planes triple the tensor work of a step with 8 rows at most to
// spread it over, and each lane carried four items' coefficients, gate
// gradients and 36 plane halves to publish a step.

#include "gru_bf16.cuh"

namespace {

struct Coef {
  float ar, az, an, r, z, dy;  // da_r / dh, da_z / dh, da_n / dh, r, z, dy_t
};

// The coefficients of an item from its row's ring slot at unit u.
template <int H>
__device__ __forceinline__ Coef coef_of(const float* in, int u) {
  const float hg_n = in[5 * H + u];
  Coef c;
  c.r = gru::sigmoid_fast(in[u] + in[3 * H + u]);
  c.z = gru::sigmoid_fast(in[H + u] + in[4 * H + u]);
  const float n = gru::tanh_fast(in[2 * H + u] + c.r * hg_n);
  c.an = (1.f - c.z) * (1.f - n * n);
  c.az = (in[6 * H + u] - n) * c.z * (1.f - c.z);
  c.ar = c.an * hg_n * c.r * (1.f - c.r);
  c.dy = in[7 * H + u];
  return c;
}

constexpr int kSimtRing = 8;  // steps in flight in the cp.async ring
constexpr int kFields = 8;    // ring fields a step: xg r, z, n; hg r, z, n; h_{t-1}; dy

template <int H>
struct Simt {
  static constexpr int kThreads = gru::kSlices * H;  // 4 threads a unit
  static constexpr int kGroups = 3 * H / 16;        // 4-column groups of a thread's slice
  static constexpr size_t kSmem = sizeof(float) * (2 * 3 + kSimtRing * kFields) * H;
};

// The two bf16 halves of p, exactly, as f32.
__device__ __forceinline__ float lo_f32(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi_f32(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

template <int H, bool kSplit>
__global__ void __launch_bounds__(Simt<H>::kThreads, 1)
gru_bwd_simt_kernel(const float* __restrict__ xg, const float* __restrict__ hg,
                    const float* __restrict__ w_hh, const float* __restrict__ h0,
                    const float* __restrict__ y, const float* __restrict__ dy,
                    const float* __restrict__ dhn, const long long* __restrict__ seq_len,
                    float* __restrict__ dxg, float* __restrict__ dnr, float* __restrict__ dh0,
                    int T, int B, long long* split, int split_steps) {
  constexpr int G3 = Simt<H>::kGroups, kDg = 3 * H;
  lstm::StepClock<kSplit> clock(split, split_steps);
  extern __shared__ float4 smem4[];
  float* dgs = reinterpret_cast<float*>(smem4);  // [2][3H]
  float* ring = dgs + 2 * kDg;                   // [kSimtRing][kFields][H]

  const int lane = threadIdx.x & 31;
  const int s = lane >> 3;                               // slice of the gate columns
  const int u = (threadIdx.x >> 5) * 8 + (lane & 7);     // hidden unit: row u of w_hh
  const int b = blockIdx.x;
  const bool lead = s == 0;  // this lane carries unit u's dh
  const size_t gates0 = size_t(b) * T * 3 * H + u;
  const size_t state0 = size_t(b) * T * H + u;
  const int len = grub::row_len(seq_len, b, B, T);

  // Group q holds w_hh[u][c] for the gate columns c = q * 16 + s * 4 + e as
  // two packed bf16 pairs (e = 0, 1 and 2, 3).
  uint32_t w[G3][2];
#pragma unroll
  for (int q = 0; q < G3; ++q) {
    const float* row = w_hh + size_t(u) * 3 * H + q * 16 + s * 4;
    w[q][0] = attn::pack_bf16(row[0], row[1]);
    w[q][1] = attn::pack_bf16(row[2], row[3]);
  }

  auto prefetch = [&](int step) {
    if (lead && step >= 0) {
      const size_t gates = gates0 + size_t(step) * 3 * H;
      const size_t state = state0 + size_t(step) * H;
      float* dst = ring + (step % kSimtRing) * kFields * H + u;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        gru::cp_async_f32(dst + q * H, xg + gates + q * H);
        gru::cp_async_f32(dst + (3 + q) * H, hg + gates + q * H);
      }
      gru::cp_async_f32(dst + 6 * H, step > 0 ? y + state - H : h0 + size_t(b) * H + u);
      gru::cp_async_f32(dst + 7 * H, dy + state);
    }
    attn::cp_async_commit();
  };
  // Each lane reads only what it fetched itself: a wait, no barrier.
  auto coef = [&](int step) {
    const float* in = ring + ((step + kSimtRing) % kSimtRing) * kFields * H;
    return coef_of<H>(in, u);
  };
  auto publish = [&](int step, const Coef& c, float dhv, int buf) {
    const float da_r = dhv * c.ar, da_z = dhv * c.az, da_n = dhv * c.an, dn_r = da_n * c.r;
    const size_t gates = gates0 + size_t(step) * 3 * H;
    dxg[gates] = da_r;
    dxg[gates + H] = da_z;
    dxg[gates + 2 * H] = da_n;
    dnr[state0 + size_t(step) * H] = dn_r;
    float* d = dgs + buf * kDg + u;
    d[0] = da_r;
    d[H] = da_z;
    d[2 * H] = dn_r;
  };

  for (int m = 0; m < kSimtRing - 1; ++m) prefetch(T - 1 - m);
  const float dh_n = dhn[size_t(b) * H + u];
  auto entering = [&](int step, float dy_step) {
    return (step < len ? dy_step : 0.f) + (step == len - 1 ? dh_n : 0.f);
  };
  float dh = 0.f, z_keep = 0.f;
  if (T > 0) {
    attn::cp_async_wait<kSimtRing - 2>();
    const Coef c = coef(T - 1);
    dh = entering(T - 1, c.dy);
    if (lead) publish(T - 1, c, dh, 0);
    z_keep = c.z;
    prefetch(T - kSimtRing);
  }
  __syncthreads();

  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    clock.begin();
    attn::cp_async_wait<kSimtRing - 2>();
    const Coef c = coef(t - 1);  // step t - 1's, off the chain (unused at t = 0)
    const float* dg = dgs + cur * kDg;
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < G3; ++q) {
      const float4 gv = *reinterpret_cast<const float4*>(dg + q * 16 + s * 4);
      float& a = acc[q & 1];
      a = fmaf(gv.x, lo_f32(w[q][0]), a);
      a = fmaf(gv.y, hi_f32(w[q][0]), a);
      a = fmaf(gv.z, lo_f32(w[q][1]), a);
      a = fmaf(gv.w, hi_f32(w[q][1]), a);
    }
    const float carry = attn::round_bf16(gru::slice_sum(acc[0] + acc[1]));
    clock.mark(lstm::kProduct);
    if (lead) {
      const float dprev = fmaf(dh, z_keep, carry);
      if (t > 0) {
        dh = entering(t - 1, c.dy) + dprev;
        publish(t - 1, c, dh, cur ^ 1);
        z_keep = c.z;
      } else {
        dh = dprev;
      }
    }
    clock.mark(lstm::kGates);
    prefetch(t - kSimtRing);
    clock.mark(lstm::kExchange);
    __syncthreads();
    clock.mark(lstm::kBarrierWait);
    clock.end_step(T - 1 - t);
    cur ^= 1;
  }
  clock.finish();
  attn::cp_async_wait<0>();
  if (lead) dh0[size_t(b) * H + u] = len == 0 ? dh + dh_n : dh;
}

template <bool kSplit>
int dispatch(const float* xg, const float* hg, const float* w_hh, const float* h0,
             const float* y, const float* dy, const float* dhn, const long long* seq_len,
             float* dxg, float* dnr, float* dh0, int T, int B, int H, int device, void* stream,
             long long* split, int split_steps) {
  if (T < 0 || B < 1 || B > grub::kMaxBatch) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K4C_H(HH)                                                                             \
  case HH:                                                                                    \
    return grub::launch(gru_bwd_simt_kernel<HH, kSplit>, B, Simt<HH>::kThreads,               \
                        Simt<HH>::kSmem, device, s, xg, hg, w_hh, h0, y, dy, dhn, seq_len,    \
                        dxg, dnr, dh0, T, B, split, split_steps);
  switch (H) {
    K4C_H(32)
    K4C_H(64)
    K4C_H(96)
    K4C_H(128)
  }
#undef K4C_H
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches K4c on `stream` (a cudaStream_t) of `device`; returns a
// cudaError_t (0 on success). Pointers are device pointers to contiguous
// f32 arrays, the (B, T, .) ones batch-major; xg, hg, y, dy and h0 16-byte
// aligned; seq_len may be null. H is 32, 64, 96 or 128; B >= 1, T >= 0.
int morgana_gru_bwd_bf16(const float* xg, const float* hg, const float* w_hh, const float* h0,
                         const float* y, const float* dy, const float* dhn,
                         const long long* seq_len, float* dxg, float* dnr, float* dh0, int T,
                         int B, int H, int device, void* stream) {
  return dispatch<false>(xg, hg, w_hh, h0, y, dy, dhn, seq_len, dxg, dnr, dh0, T, B, H, device,
                         stream, nullptr, 0);
}

#ifdef MORGANA_STEP_SPLIT
// As morgana_gru_bwd_bf16, recording the phases of the first split_steps
// steps (in the order they run, from T - 1 down) into split (two records
// of lstm::split_record(split_steps) entries: CTA 0 and the middle CTA of
// the grid; split may be null).
int morgana_gru_bwd_bf16_split(const float* xg, const float* hg, const float* w_hh,
                               const float* h0, const float* y, const float* dy, const float* dhn,
                               const long long* seq_len, float* dxg, float* dnr, float* dh0,
                               int T, int B, int H, int device, void* stream,
                               long long* split, int split_steps) {
  return dispatch<true>(xg, hg, w_hh, h0, y, dy, dhn, seq_len, dxg, dnr, dh0, T, B, H, device,
                        stream, split, split_steps);
}
#endif

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
