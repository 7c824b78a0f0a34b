// K3c: one GRU layer's recurrence with bf16 products, forward, on Hopper
// (sm_90a).
//
// Replaces, as the 'scan' backend's bf16 recurrence (morgana_tpu/ops/rnn.py:
// 332-375 under compute_dtype bfloat16), morgana_tpu/ops/pallas_gru.py::
// _gru_fwd_kernel (driven there by _fwd_call). Same function as K3
// (csrc/gru_fwd.cu) with the product's operands rounded to bf16 (to nearest
// even, as XLA's astype): in torch's gate form, gates ordered r, z, n,
//
//     hg_t = bf16(h_{t-1}) @ bf16(w_hh) + b_hh      (f32 sums)
//     r = sigmoid(xg_r + hg_r),  z = sigmoid(xg_z + hg_z)
//     n = tanh(xg_n + r * hg_n)
//     h_t = (1 - z) * n + z * h_{t-1}
//
// over the whole padded time axis, h carried in f32 and rounded once a
// step, when it is published for the next product (JAX's h.astype(bf16)).
// Inputs, batch-major as the layer's x: xg = x @ w_ih + b_ih (B, T, 3H),
// w_hh (H, 3H), b_hh (3H), h0 (B, H), f32, and optionally seq_len (B) in
// int64. Outputs: y = h trace (B, T, H), 0 past each row's length, and hn
// (B, H), h at step seq_len - 1 (h0 for an empty row), as K3.
//
// What bounds it. 2 * B * H * 3H flops a step on the bf16 tensor cores,
// and only the (B, H) vector of the step before: the step-to-step latency.
// The bound of the whole launch (the inputs read once) is far below it.
//
// Design (csrc/gru_bf16.cuh has the ring and the launch). One CTA of H / 8
// compute warps and its copy warps per 4 batch rows, no cluster at any
// width. Compute warp w owns the 8 units u = 8 w .. 8 w + 7 and keeps two
// m16 tiles of w_hh^T in bf16 A fragments in registers (3H / 8 a thread):
// tile 0 holds gates r (rows 0-7) and z (rows 8-15) of its units, tile 1
// gate n (rows 0-7; rows 8-15 zero). The batch rows are the n8 tile's even
// columns, row i in column 2i (the odd columns zero): lane 4g + t then ends
// with hg_r, hg_z and hg_n of unit 8 w + g for batch row t in its C
// fragments, one item a lane, and the gate math runs on the accumulators
// with no shuffle and no trip through shared memory. A step:
//   product  2 x H / 16 mma.sync.m16n8k16 (bf16 in, f32 sums) with B
//            fragments by ldmatrix from the staged bf16(h_{t-1}), k-step
//            kk into accumulator chain kk % 4 (H <= 64) or kk % 2, the
//            chains summed in pairs;
//   gates    each lane adds b_hh and xg (brought kRing - 1 steps ahead by
//            the copy warps' cp.async) to the hg_r, hg_z, hg_n of its
//            (unit, row) item, updates h in registers and publishes
//            bf16(h_t) into the other buffer of the staged tile, then
//            stores y (0 past the row's length);
//   barrier  one bar.sync, which the copy warps join once they have put
//            step t + kRing - 1 in flight and seen step t + 1 land.
// Rows past B carry zeros (xg zero-filled, h0 0) and store nothing; the
// staged tile's odd columns stay zero.
//
// Why 4 rows a CTA and 8 units a warp: the step is a chain of dependent
// latencies (ldmatrix, two mma, an exp2 and a reciprocal each gate, the
// bf16 store, the barrier), and the gates' six SFU instructions an item
// queue on the SM's SFUs. With 16 units a warp (H / 16 warps, 3 m16 tiles
// each) every lane carried four items and H = 64 ran one compute warp a
// scheduler; with 8 rows a CTA (every column a row) each lane carried two
// items, 0.37 us a step at H64, slower than the f32 K3. Half the columns
// empty gives each lane one item and each SM half the SFU work, for tensor
// work that costs nothing here: 0.23 us a step at H64, 0.58 at H128
// (PERF.md §6).

#include "gru_bf16.cuh"

namespace {

// The fewest copy warps, 6 16-byte copies a lane at most, that share
// `vectors` copies evenly.
constexpr int copy_warps(int vectors) {
  int w = (vectors + 32 * 6 - 1) / (32 * 6);
  while (vectors % (32 * w)) ++w;
  return w;
}

template <int H>
struct Fwd {
  static constexpr int kWarps = H / 8;        // compute warp w: units 8 w .. 8 w + 7
  static constexpr int kRows = 4;             // batch rows a CTA, in the even columns
  // The copy warps: 6 16-byte copies a lane a step at most, their sources
  // in registers (kCopies each). Each copy a lane is an instruction or two
  // on a scheduler that compute warps share, so more copy warps with fewer
  // copies each shorten the step.
  static constexpr int kVectors = kRows * (3 * H / 4);  // 16-byte vectors of xg a step
  static constexpr int kCopyWarps = copy_warps(kVectors);
  static constexpr int kCopies = kVectors / (32 * kCopyWarps);
  static constexpr int kThreads = 32 * (kWarps + kCopyWarps);
  static constexpr int kSteps = H / 16;        // k-steps of the product
  // Accumulator chains a tile (k-step kk into chain kk % kChains): four at
  // H <= 64, where the product is two k-steps deep at most a chain; two
  // above, where the registers are short.
  static constexpr int kChains = H <= 64 && kSteps % 4 == 0 ? 4 : 2;
  static constexpr int kHStride = H + 8;       // bf16; see gru_bf16.cuh
  static constexpr int kXStride = 3 * H + 8;   // f32: a warp's 4 rows x 8 units, 32 banks
  static constexpr size_t kHBytes = size_t(2) * 8 * kHStride * 2;
  static constexpr size_t kSlotBytes = size_t(kRows) * kXStride * 4;
  static constexpr int kRing = grub::ring_depth(kSlotBytes, kHBytes);
  static constexpr size_t kSmem = kHBytes + kRing * kSlotBytes;
  static_assert(H % 32 == 0 && H >= 32 && H <= 128, "H is a multiple of 32 up to 128");
};

// Element e of a tile's product from its accumulator chains: (c0 + c1),
// or (c0 + c1) + (c2 + c3).
template <int kChains>
__device__ __forceinline__ float chains_sum(const float (&acc)[kChains][4], int e) {
  if constexpr (kChains == 4) return (acc[0][e] + acc[1][e]) + (acc[2][e] + acc[3][e]);
  return acc[0][e] + acc[1][e];
}

template <int H, bool kSplit>
__global__ void __launch_bounds__(Fwd<H>::kThreads, 1)
gru_fwd_bf16_kernel(const float* __restrict__ xg, const float* __restrict__ w_hh,
                    const float* __restrict__ b_hh, const float* __restrict__ h0,
                    const long long* __restrict__ seq_len, float* __restrict__ y,
                    float* __restrict__ hn, int T, int B, long long* split, int split_steps) {
  using F = Fwd<H>;
  constexpr int kRing = F::kRing, G = 3 * H;
  lstm::StepClock<kSplit> clock(split, split_steps);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem);   // [2][8][kHStride]
  float* ring = reinterpret_cast<float*>(smem + F::kHBytes);       // [kRing][kRows][kXStride]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b0 = int(blockIdx.x) * F::kRows;

  // Both buffers of the staged tile: bf16(h0) of the CTA's rows in buffer
  // 0's even columns, zeros elsewhere (rows past B, the odd columns).
  for (int q = tid; q < 2 * 8 * H; q += F::kThreads) {
    const int col = (q / H) % 8, k = q % H, b = b0 + col / 2;
    const bool row = q < 8 * H && col % 2 == 0 && b < B;
    hbuf[(q / H) * F::kHStride + k] = __float2bfloat16_rn(row ? h0[size_t(b) * H + k] : 0.f);
  }

  if (warp >= F::kWarps) {
    // A copy warp: step t's xg into ring slot t % kRing, one commit group a
    // step (empty past T), kRing - 1 steps ahead of the compute warps; one
    // barrier a step with them. Its lanes' kCopies 16-byte copies a step
    // keep their source (at step 0), destination and size (0 past B:
    // zero-filled) in registers; a step adds t * 3H to each source.
    const float* src[F::kCopies];
    int dst[F::kCopies], bytes[F::kCopies];
#pragma unroll
    for (int c = 0; c < F::kCopies; ++c) {
      const int q = tid - 32 * F::kWarps + 32 * F::kCopyWarps * c;
      const int row = q / (G / 4), v = q % (G / 4);
      const bool valid = b0 + row < B;
      src[c] = xg + size_t(valid ? b0 + row : 0) * T * G + 4 * v;
      dst[c] = row * F::kXStride + 4 * v;
      bytes[c] = valid ? 16 : 0;
    }
    auto fetch = [&](int t) {
      if (t < T) {
        float* slot = ring + (t % kRing) * F::kRows * F::kXStride;
        const size_t step = size_t(t) * G;
#pragma unroll
        for (int c = 0; c < F::kCopies; ++c)
          grub::cp_async16(slot + dst[c], src[c] + step, bytes[c]);
      }
      attn::cp_async_commit();
    };
    for (int t = 0; t < kRing - 1; ++t) fetch(t);
    attn::cp_async_wait<kRing - 2>();  // step 0's xg
    grub::step_barrier();
    for (int t = 0; t < T; ++t) {
      // Refills the slot read last step (or the free one at t = 0), then
      // waits for step t + 1's xg.
      fetch(t + kRing - 1);
      attn::cp_async_wait<kRing - 2>();
      grub::step_barrier();
    }
    attn::cp_async_wait<0>();
    return;
  }

  // A fragments of w_hh^T (element (m, k) of a gate column m is w_hh[k][m]):
  // tile 0's rows g and g + 8 are gates r and z of unit u, tile 1's rows g
  // gate n of unit u (its rows g + 8 are zero: a[1][.][1] and [3]).
  const int u = 8 * warp + g;
  uint32_t a[2][F::kSteps][4];
#pragma unroll
  for (int kk = 0; kk < F::kSteps; ++kk) {
    const float* w = w_hh + size_t(16 * kk + 2 * t4) * G + u;
#pragma unroll
    for (int half = 0; half < 2; ++half) {   // k and k + 8
      const float* wk = w + size_t(8 * half) * G;
      a[0][kk][2 * half] = attn::pack_bf16(wk[0], wk[G]);
      a[0][kk][2 * half + 1] = attn::pack_bf16(wk[H], wk[G + H]);
      a[1][kk][2 * half] = attn::pack_bf16(wk[2 * H], wk[G + 2 * H]);
      a[1][kk][2 * half + 1] = 0u;
    }
  }
  const float bias_r = b_hh[u], bias_z = b_hh[H + u], bias_n = b_hh[2 * H + u];
  // The lane's item: unit u of batch row b0 + t4 (column 2 t4); h in f32,
  // the row's length, h at its last step (h0 for an empty row), its y at
  // step 0.
  const int b = b0 + t4;
  const int len = grub::row_len(seq_len, b, B, T);
  float h = b < B ? h0[size_t(b) * H + u] : 0.f;
  float h_last = h;
  float* const y_at = b < B ? y + size_t(b) * T * H + u : nullptr;
  const float* const x_at = ring + t4 * F::kXStride + u;   // in slot 0
  __nv_bfloat16* const h_at = hbuf + 2 * t4 * F::kHStride + u;   // in buffer 0
  grub::step_barrier();  // bf16(h0) staged, step 0's xg landed

  for (int t = 0; t < T; ++t) {
    clock.begin();
    const __nv_bfloat16* hb = hbuf + (t & 1) * 8 * F::kHStride;
    float acc[2][F::kChains][4];   // [tile][chain]
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int ch = 0; ch < F::kChains; ++ch)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][ch][e] = 0.f;
    const __nv_bfloat16* cols = hb + (lane & 7) * F::kHStride + (lane >> 3) * 8;
#pragma unroll
    for (int kk = 0; kk < F::kSteps; kk += 2) {
      uint32_t r[4];
      attn::ldmatrix_x4(r, cols + 16 * kk);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        attn::mma_bf16(acc[m][kk % F::kChains], a[m][kk], r[0], r[1]);
        attn::mma_bf16(acc[m][(kk + 1) % F::kChains], a[m][kk + 1], r[2], r[3]);
      }
    }
    clock.mark(lstm::kProduct);

    // C elements 0 and 2: rows g (r; n in tile 1) and g + 8 (z), column
    // 2 t4, the item's row.
    const float* x = x_at + (t % kRing) * F::kRows * F::kXStride;
    const float hg_r = chains_sum<F::kChains>(acc[0], 0) + bias_r;
    const float hg_z = chains_sum<F::kChains>(acc[0], 2) + bias_z;
    const float hg_n = chains_sum<F::kChains>(acc[1], 0) + bias_n;
    const float rg = gru::sigmoid_fast(x[0] + hg_r);
    const float zg = gru::sigmoid_fast(x[H] + hg_z);
    const float ng = gru::tanh_fast(x[2 * H] + rg * hg_n);
    h = fmaf(zg, h - ng, ng);
    h_at[((t + 1) & 1) * 8 * F::kHStride] = __float2bfloat16_rn(h);
    // Off the chain, once bf16(h_t) is staged: y (0 past the row's length)
    // and h at the row's last step.
    if (t == len - 1) h_last = h;
    if (y_at != nullptr) y_at[size_t(t) * H] = t < len ? h : 0.f;
    clock.mark(lstm::kGates);
    // Publishes bf16(h_t) and step t + 1's xg; every warp is past reading
    // this step's buffers.
    grub::step_barrier();
    clock.mark(lstm::kBarrierWait);
    clock.end_step(t);
  }
  clock.finish();
  if (b < B) hn[size_t(b) * H + u] = h_last;
}

template <bool kSplit>
int dispatch(const float* xg, const float* w_hh, const float* b_hh, const float* h0,
             const long long* seq_len, float* y, float* hn, int T, int B, int H, int device,
             void* stream, long long* split, int split_steps) {
  if (T < 0 || B < 1 || B > grub::kMaxBatch) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3C_H(HH)                                                                             \
  case HH:                                                                                    \
    return grub::launch(gru_fwd_bf16_kernel<HH, kSplit>,                                      \
                        (B + Fwd<HH>::kRows - 1) / Fwd<HH>::kRows, Fwd<HH>::kThreads,         \
                        Fwd<HH>::kSmem, device, s, xg, w_hh, b_hh, h0, seq_len, y, hn, T, B,  \
                        split, split_steps);
  switch (H) {
    K3C_H(32)
    K3C_H(64)
    K3C_H(96)
    K3C_H(128)
  }
#undef K3C_H
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches K3c on `stream` (a cudaStream_t) of `device`; returns a
// cudaError_t (0 on success). Pointers are device pointers to contiguous
// f32 arrays, xg and y batch-major, xg 16-byte aligned; seq_len may be null.
// H is 32, 64, 96 or 128; B >= 1, T >= 0.
int morgana_gru_fwd_bf16(const float* xg, const float* w_hh, const float* b_hh, const float* h0,
                         const long long* seq_len, float* y, float* hn, int T, int B, int H,
                         int device, void* stream) {
  return dispatch<false>(xg, w_hh, b_hh, h0, seq_len, y, hn, T, B, H, device, stream, nullptr,
                         0);
}

#ifdef MORGANA_STEP_SPLIT
// As morgana_gru_fwd_bf16, recording the phases of the first split_steps
// steps into split (two records of lstm::split_record(split_steps)
// entries: CTA 0 and the middle CTA of the grid; split may be null).
int morgana_gru_fwd_bf16_split(const float* xg, const float* w_hh, const float* b_hh,
                               const float* h0, const long long* seq_len, float* y, float* hn,
                               int T, int B, int H, int device, void* stream,
                               long long* split, int split_steps) {
  return dispatch<true>(xg, w_hh, b_hh, h0, seq_len, y, hn, T, B, H, device, stream, split,
                        split_steps);
}
#endif

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
