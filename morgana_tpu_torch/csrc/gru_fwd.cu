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
// over the whole padded time axis, h carried in f32. Inputs, batch-major as
// the layer's x: xg = x @ w_ih + b_ih (B, T, 3H), w_hh (H, 3H), b_hh (3H),
// h0 (B, H) and, optionally, seq_len (B) in int64. Outputs: y = h trace
// (B, T, H) and hn (B, H). With seq_len, y is written as 0 past each row's
// length and hn is h at step seq_len - 1 (h0 for an empty row): the masking
// and final-state gather that pallas_gru.py does outside its kernel, here
// folded in so that the layer launches no further kernels for them. The
// recurrence itself runs on through padding as in the TPU kernel.
//
// What bounds it. A step is 2*H*3H flops a batch row and needs the whole
// h_{t-1} of its row, so the work of a step is tiny and the step-to-step
// latency bounds the layer: the product, the gate math and one hand-over of
// h_t to every thread of the row, T times in a row.
//
// Design (csrc/gru_common.cuh). A cluster of 4H threads -- one CTA up to
// H = 96, two at H = 128 -- carries one batch row. Thread (u, s) keeps a
// quarter of unit u's three gate columns of w_hh -- 3H/4 floats -- in
// registers and multiplies it by its k-slice of h_{t-1}, read as float4
// broadcasts from a double-buffered copy in shared memory; two partial sums
// per gate halve the multiply-add chain. Two __shfl_xor_sync add up the
// four slices; lane s = 0 of each unit then does the gate math and
// publishes h_t into every CTA's copy. One block (or cluster) barrier a
// step. xg is off the chain: each s = 0 lane keeps kRing - 1 steps of it in
// flight with cp.async into a ring in shared memory. The gate functions use
// exp2 and a fast reciprocal (within ~1e-7 abs of expf/tanhf). A batch
// past the SM count (B > 132, or 66 at H = 128) runs in more than one wave;
// the repo's models train at B = 32 and serve at 16.
//
// H = 128, measured (chip_smoke.py's gru_step_sweep, H100 80GB HBM3 at
// 700 W, T = 1024): one CTA of 512 threads with gate n's quarter of w_hh in
// shared memory took 1.58 us a step (K4 2.02), held back by its 128 KB of
// shared-memory reads a step; the 2-CTA cluster with every weight in
// registers takes 1.04-1.12 us (K4 1.15-1.26) and replaced it.

#include "gru_common.cuh"

namespace {

using namespace gru;

template <int H>
__global__ void __launch_bounds__(Shape<H>::kThreads, 1)
gru_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ w_hh,
               const float* __restrict__ b_hh, const float* __restrict__ h0,
               const long long* __restrict__ seq_len, float* __restrict__ y,
               float* __restrict__ hn, int T) {
  constexpr int G = H / 16;  // float4 groups of one gate in a thread's slice
  using Cl = Cluster<H>;
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [2][H]
  float* ring = hs + 2 * H;                     // [kRing][3][H]

  const int lane = threadIdx.x & 31;
  const int s = lane >> 3;                                                       // k-slice
  const int u = Cl::rank() * Shape<H>::kUnits + (threadIdx.x >> 5) * 8 + (lane & 7);  // unit
  const int b = blockIdx.x / Shape<H>::kCtas;
  const bool lead = s == 0;  // this lane does unit u's gate math
  const float* xg_b = xg + size_t(b) * T * 3 * H;
  float* y_b = y + size_t(b) * T * H;
  int len = T;
  if (seq_len != nullptr) len = int(min(max(seq_len[b], 0LL), (long long)T));

  // Group q = g * G + i holds w_hh[k][g * H + u] for k = i * 16 + s * 4 + e:
  // the flat index q * 16 + s * 4 + e is g * H + k.
  float4 w[Shape<H>::kGroups];
  load_slice<H>(w, s, [&](int idx) { return w_hh[size_t(idx % H) * 3 * H + (idx / H) * H + u]; });
  if (threadIdx.x < H) hs[threadIdx.x] = h0[size_t(b) * H + threadIdx.x];
  float h = h0[size_t(b) * H + u];
  float h_last = h;  // h at step len - 1, h0 for an empty row
  const float bias[3] = {lead ? b_hh[u] : 0.f, lead ? b_hh[H + u] : 0.f,
                         lead ? b_hh[2 * H + u] : 0.f};

  // Step `step`'s xg into ring slot step % kRing; one commit group a call,
  // empty past T or off the lead lanes.
  auto prefetch = [&](int step) {
    if (lead && step < T) {
      const float* src = xg_b + size_t(step) * 3 * H + u;
      float* dst = ring + (step % kRing) * 3 * H + u;
      cp_async_f32(dst, src);
      cp_async_f32(dst + H, src + H);
      cp_async_f32(dst + 2 * H, src + 2 * H);
    }
    cp_async_commit();
  };
  for (int step = 0; step < kRing - 1; ++step) prefetch(step);
  Cl::sync();  // also: every CTA of the cluster has started

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float* hcur = hs + cur * H;
    float acc[2][3] = {{bias[0], bias[1], bias[2]}, {0.f, 0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float4 hv = *reinterpret_cast<const float4*>(hcur + i * 16 + s * 4);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float4 wv = w[g * G + i];
        float& a = acc[i & 1][g];
        a = fmaf(hv.x, wv.x, a);
        a = fmaf(hv.y, wv.y, a);
        a = fmaf(hv.z, wv.z, a);
        a = fmaf(hv.w, wv.w, a);
      }
    }
    const float a_r = slice_sum(acc[0][0] + acc[1][0]);
    const float a_z = slice_sum(acc[0][1] + acc[1][1]);
    const float a_n = slice_sum(acc[0][2] + acc[1][2]);

    cp_async_wait_ring();
    if (lead) {
      const float* slot = ring + (t % kRing) * 3 * H + u;
      const float rg = sigmoid_fast(slot[0] + a_r);
      const float zg = sigmoid_fast(slot[H] + a_z);
      const float ng = tanh_fast(slot[2 * H] + rg * a_n);
      h = fmaf(zg, h - ng, ng);
      if (t == len - 1) h_last = h;
      y_b[size_t(t) * H + u] = t < len ? h : 0.f;
      Cl::store(hs + (cur ^ 1) * H + u, h);
    }
    // Refills the slot read last step (or the free one at t = 0).
    prefetch(t + kRing - 1);
    // Publishes h_t; also, every thread is past reading h_{t-1}'s buffer.
    Cl::sync();
    cur ^= 1;
  }
  if (lead) hn[size_t(b) * H + u] = h_last;
}

template <int H>
cudaError_t launch(const float* xg, const float* w_hh, const float* b_hh, const float* h0,
                   const long long* seq_len, float* y, float* hn, int T, int B, int device,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 + kRing * 3) * H;
  return launch_clusters<H>(gru_fwd_kernel<H>, B, smem, device, stream, xg, w_hh, b_hh, h0,
                            seq_len, y, hn, T);
}

}  // namespace

extern "C" {

// Launches K3 on `stream` (a cudaStream_t) of `device`; returns a cudaError_t
// (0 on success). All pointers are device pointers to contiguous f32 arrays,
// xg and y batch-major. seq_len may be null (every row T long). H is 32, 64,
// 96 or 128; B >= 1, T >= 0.
int morgana_gru_fwd(const float* xg, const float* w_hh, const float* b_hh, const float* h0,
                    const long long* seq_len, float* y, float* hn, int T, int B, int H,
                    int device, void* stream) {
  if (T < 0 || B < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 32: return launch<32>(xg, w_hh, b_hh, h0, seq_len, y, hn, T, B, device, st);
    case 64: return launch<64>(xg, w_hh, b_hh, h0, seq_len, y, hn, T, B, device, st);
    case 96: return launch<96>(xg, w_hh, b_hh, h0, seq_len, y, hn, T, B, device, st);
    case 128: return launch<128>(xg, w_hh, b_hh, h0, seq_len, y, hn, T, B, device, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
