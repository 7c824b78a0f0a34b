// K4: one GRU layer, backward, on Hopper (sm_90a).
//
// Replaces morgana_tpu/ops/pallas_gru.py::_gru_bwd_kernel (driven there by
// _core_bwd); K4c, its bf16 counterpart, is csrc/gru_bwd_bf16.cu. Same
// function: walking time backwards from dh = dhn, each step
// takes the gates r, z, n of K3 from xg and hg = h_{t-1} @ w_hh + b_hh, then
//
//     dh   = dy_t + dh
//     da_n = dh * (1 - z) * (1 - n^2)
//     da_z = dh * (h_{t-1} - n) * z * (1 - z)
//     da_r = da_n * hg_n * r * (1 - r)
//     dxg_t = [da_r, da_z, da_n]
//     dh   = dh * z + [da_r, da_z, da_n * r] @ w_hh^T
//
// and returns dh0 = dh after step 0. Inputs, batch-major as the layer's x:
// xg (B, T, 3H); hg (B, T, 3H), computed for the whole sequence by one GEMM
// outside (ops/gru.py, as pallas_gru.py:183-185 does for dW_hh); w_hh
// (H, 3H); h0 (B, H); y (B, T, H), K3's h trace (h_{t-1} is y[:, t-1], h0 at
// t = 0); dy (B, T, H), dhn (B, H) and, optionally, seq_len (B) in int64.
// Outputs: dxg (B, T, 3H), dnr = da_n * r (B, T, H) and dh0 (B, H). The
// hidden-side gate gradients that dW_hh and db_hh (GEMMs outside) read are
// [da_r, da_z, da_n * r]: dxg's first 2H columns, then dnr. With seq_len,
// the kernel is the backward of K3 with seq_len: dy is taken as 0 past each
// row's length and dhn enters at step seq_len - 1 (at dh0 for an empty row).
// Past the length y may be K3's zeros: those steps carry no gradient, so
// h_{t-1} is read only where it is the state.
//
// What bounds it. One dependent product a step, the carry, 2*H*3H flops a
// batch row: the step-to-step latency bounds the layer, far above the flops.
// With hg given, everything else is elementwise on streamed inputs: every
// da is dh times a coefficient of the step's own inputs.
//
// Design (csrc/gru_common.cuh, as K3). A cluster of 4H threads -- one CTA
// up to H = 96, two at H = 128 -- carries one batch row. Thread (k, s) keeps
// a quarter of row k of w_hh -- 3H/4 gate columns -- in registers and
// multiplies it by its slice of the published [da_r, da_z, da_n * r], read
// as float4 broadcasts from a double-buffered copy in shared memory. Two
// __shfl_xor_sync add up the four slices; lane s = 0 of unit k then forms
// dh_{t-1}[k], scales the next step's coefficients by it, writes dxg and
// dnr and publishes the next dg into every CTA's copy. One block (or
// cluster) barrier a step. The coefficients (the gates and the three da /
// dh ratios) come from xg, hg, h_{t-1} and dy, which each s = 0 lane keeps
// kRing - 1 steps in flight with cp.async; they are computed without
// branches so that the compiler can interleave them with the carry product.

#include "gru_common.cuh"

namespace {

using namespace gru;

constexpr int kFields = 8;  // ring fields a step: xg r, z, n; hg r, z, n; h_{t-1}; dy

struct Coef {
  float ar, az, an, r, z, dy;  // da_r / dh, da_z / dh, da_n / dh, r, z, dy_t
};

template <int H>
__global__ void __launch_bounds__(Shape<H>::kThreads, 1)
gru_bwd_kernel(const float* __restrict__ xg, const float* __restrict__ hg,
               const float* __restrict__ w_hh, const float* __restrict__ h0,
               const float* __restrict__ y, const float* __restrict__ dy,
               const float* __restrict__ dhn, const long long* __restrict__ seq_len,
               float* __restrict__ dxg, float* __restrict__ dnr, float* __restrict__ dh0, int T) {
  constexpr int G3 = Shape<H>::kGroups;  // float4 groups of a thread's slice
  constexpr int kDg = 3 * H;             // floats of one row's dg
  using Cl = Cluster<H>;
  extern __shared__ float4 smem4[];
  float* dgs = reinterpret_cast<float*>(smem4);  // [2][3H]
  float* ring = dgs + 2 * kDg;                   // [kRing][8][H]

  const int lane = threadIdx.x & 31;
  const int s = lane >> 3;  // slice of the gate columns
  // Hidden unit: row u of w_hh.
  const int u = Cl::rank() * Shape<H>::kUnits + (threadIdx.x >> 5) * 8 + (lane & 7);
  const int b = blockIdx.x / Shape<H>::kCtas;
  const bool lead = s == 0;  // this lane carries unit u's dh
  // (b, 0) of the (B, T, 3H) and (B, T, H) arrays, at unit u.
  const size_t gates0 = size_t(b) * T * 3 * H + u;
  const size_t state0 = size_t(b) * T * H + u;
  int len = T;
  if (seq_len != nullptr) len = int(min(max(seq_len[b], 0LL), (long long)T));

  // Group q holds w_hh[u][c] for the gate columns c = q * 16 + s * 4 + e.
  float4 w[G3];
  load_slice<H>(w, s, [&](int c) { return w_hh[size_t(u) * 3 * H + c]; });

  // Step `step`'s inputs into ring slot step % kRing (step >= 0).
  auto prefetch = [&](int step) {
    if (lead && step >= 0) {
      const size_t gates = gates0 + size_t(step) * 3 * H;
      const size_t state = state0 + size_t(step) * H;
      float* dst = ring + (step % kRing) * kFields * H + u;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        cp_async_f32(dst + g * H, xg + gates + g * H);
        cp_async_f32(dst + (3 + g) * H, hg + gates + g * H);
      }
      cp_async_f32(dst + 6 * H, step > 0 ? y + state - H : h0 + size_t(b) * H + u);
      cp_async_f32(dst + 7 * H, dy + state);
    }
    cp_async_commit();
  };
  // The coefficients of step `step` from its ring slot. Lanes s > 0 read the
  // slot too and discard the result: no branch.
  auto coef = [&](int step) {
    const float* in = ring + (step & (kRing - 1)) * kFields * H + u;
    const float hg_n = in[5 * H];
    Coef c;
    c.r = sigmoid_fast(in[0] + in[3 * H]);
    c.z = sigmoid_fast(in[H] + in[4 * H]);
    const float n = tanh_fast(in[2 * H] + c.r * hg_n);
    c.an = (1.f - c.z) * (1.f - n * n);
    c.az = (in[6 * H] - n) * c.z * (1.f - c.z);
    c.ar = c.an * hg_n * c.r * (1.f - c.r);
    c.dy = in[7 * H];
    return c;
  };
  // dxg and dnr of step `step`, and its dg into buffer `buf` of every CTA.
  auto publish = [&](int step, const Coef& c, float dh, int buf) {
    const float da_r = dh * c.ar, da_z = dh * c.az, da_n = dh * c.an, dn_r = da_n * c.r;
    const size_t gates = gates0 + size_t(step) * 3 * H;
    dxg[gates] = da_r;
    dxg[gates + H] = da_z;
    dxg[gates + 2 * H] = da_n;
    dnr[state0 + size_t(step) * H] = dn_r;
    float* d = dgs + buf * kDg + u;
    Cl::store(d, da_r);
    Cl::store(d + H, da_z);
    Cl::store(d + 2 * H, dn_r);
  };

  for (int m = 0; m < kRing - 1; ++m) prefetch(T - 1 - m);
  const float dh_n = dhn[size_t(b) * H + u];
  // The cotangents that enter at step `step`: dy within the row's length,
  // dhn at its last step.
  auto entering = [&](int step, float dy_step) {
    return (step < len ? dy_step : 0.f) + (step == len - 1 ? dh_n : 0.f);
  };
  float dh = 0.f;
  float z_keep = 0.f;
  Cl::sync();  // every CTA of the cluster has started before any store to it
  if (T > 0) {
    cp_async_wait_ring();
    const Coef c = coef(T - 1);
    dh = entering(T - 1, c.dy);
    if (lead) publish(T - 1, c, dh, 0);
    z_keep = c.z;
    prefetch(T - kRing);  // into the one slot the prologue left free
  }
  Cl::sync();

  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    cp_async_wait_ring();
    const Coef c = coef(t - 1);  // step t - 1's, off the chain (unused at t = 0)
    const float* dg = dgs + cur * kDg;
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < G3; ++q) {
      const float4 gv = *reinterpret_cast<const float4*>(dg + q * 16 + s * 4);
      float& a = acc[q & 1];
      a = fmaf(gv.x, w[q].x, a);
      a = fmaf(gv.y, w[q].y, a);
      a = fmaf(gv.z, w[q].z, a);
      a = fmaf(gv.w, w[q].w, a);
    }
    const float carry = slice_sum(acc[0] + acc[1]);
    if (lead) {
      const float dprev = fmaf(dh, z_keep, carry);  // dh_{t-1} without what enters there
      if (t > 0) {
        dh = entering(t - 1, c.dy) + dprev;
        publish(t - 1, c, dh, cur ^ 1);
        z_keep = c.z;
      } else {
        dh = dprev;
      }
    }
    // Refills the slot read last step: step t's.
    prefetch(t - kRing);
    // Publishes dg_{t-1}; also, every thread is past reading dg_t's buffer.
    Cl::sync();
    cur ^= 1;
  }
  if (lead) dh0[size_t(b) * H + u] = len == 0 ? dh + dh_n : dh;
}

template <int H>
cudaError_t launch(const float* xg, const float* hg, const float* w_hh, const float* h0,
                   const float* y, const float* dy, const float* dhn, const long long* seq_len,
                   float* dxg, float* dnr, float* dh0, int T, int B, int device,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * 3 + kRing * kFields) * H;
  return launch_clusters<H>(gru_bwd_kernel<H>, B, smem, device, stream, xg, hg, w_hh, h0, y, dy,
                            dhn, seq_len, dxg, dnr, dh0, T);
}

}  // namespace

extern "C" {

// Launches K4 on `stream` (a cudaStream_t) of `device`; returns a cudaError_t
// (0 on success). All pointers are device pointers to contiguous f32 arrays,
// the (B, T, .) ones batch-major. seq_len may be null. H is 32, 64, 96 or
// 128; B >= 1, T >= 0.
int morgana_gru_bwd(const float* xg, const float* hg, const float* w_hh, const float* h0,
                    const float* y, const float* dy, const float* dhn, const long long* seq_len,
                    float* dxg, float* dnr, float* dh0, int T, int B, int H, int device,
                    void* stream) {
  if (T < 0 || B < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 32:
      return launch<32>(xg, hg, w_hh, h0, y, dy, dhn, seq_len, dxg, dnr, dh0, T, B, device,
                         st);
    case 64:
      return launch<64>(xg, hg, w_hh, h0, y, dy, dhn, seq_len, dxg, dnr, dh0, T, B, device,
                         st);
    case 96:
      return launch<96>(xg, hg, w_hh, h0, y, dy, dhn, seq_len, dxg, dnr, dh0, T, B, device,
                         st);
    case 128:
      return launch<128>(xg, hg, w_hh, h0, y, dy, dhn, seq_len, dxg, dnr, dh0, T, B, device,
                         st);
    default: return cudaErrorInvalidValue;
  }
}

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
