// K2c: one LSTM layer's backward through time with bf16 products, as one
// cluster launch on Hopper (sm_90a).
//
// Replaces, as the autodiff of the 'scan' backend's bf16 recurrence (K1c;
// morgana_tpu/ops/rnn.py:113-135 under compute_dtype bfloat16),
// morgana_tpu/ops/pallas_rnn.py::_lstm_bwd_kernel (driven there by
// _core_bwd) at the widths whose bf16 w_hh fits one cluster (H = 64, 128,
// 256, 512); H = 1024 keeps K2c's build of csrc/lstm_bwd.cu. Same function
// as that build: with the activated gates i, f, g, o that K1c saved
// (g_all), running t from T-1 down to 0,
//
//     dh      = dy[t] + dh_carry
//     do      = dh * tanh(c_t)
//     dc      = dh * o * (1 - tanh(c_t)^2) + dc_carry + dc_all[t]
//     dxg[t]  = [dc * g * i(1-i), dc * c_{t-1} * f(1-f), dc * i(1-g^2), do * o(1-o)]
//     dh_carry = bf16(dxg[t] @ bf16(w_hh)^T)          (f32 sums)
//     dc_carry = dc * f
//
// with the carries (f32) starting from dhn and dcn and ending as dh0 and
// dc0. dxg is f32 and not rounded (the scan's autodiff rounds only w_hh and
// the carried product). Inputs: g_all (T, B, 4H), w_hh (H, 4H), c0 (B, H),
// c_all, dy and dc_all (T, B, H), dhn and dcn (B, H), all f32. Outputs: dxg
// (T, B, 4H), which the bf16 carry (csrc/rnn_dw_bf16.cu) reads, dh0 and dc0
// (B, H), all f32.
//
// What bounds it. 2*B*4H*H flops a step (an f32 operand times a bf16 one)
// and only the step after it: the step-to-step latency. K2c's build of
// lstm_bwd.cu spent it on 64 blocks of f32 FMAs on rounded values and a
// reduce-scatter of 2 x 64 x B x H floats through L2 a step, then a grid
// barrier.
//
// Design (lstm_cluster.cuh has the split: clusters of H / 32 CTAs of 32
// units, kRows = 8 NT batch rows a cluster). The partition is by units:
// CTA r computes dxg[t] of its own units' 128 gate columns (the elementwise
// part needs only those units' carries) and multiplies them by its own
// (H, 128) slice of w_hh, kept as bf16 mma.sync A fragments in registers
// (warp w the m16 tiles of rows 16 MT w .. of w_hh, MT = H / 16 / warps).
// The result is the CTA's partial of the whole (kRows, H) dh_carry, which
// a reduce-scatter over DSMEM sums: each destination CTA gets the (kRows,
// 32) slice of its units from every CTA and adds the H / 32 slices in rank
// order. Partitioning by rows of w_hh instead would need no reduction but
// an all-gather of every CTA's f32 dxg columns: 4x the bytes a step (each
// CTA 128 f32 columns to every CTA, against 32 f32 units of partial).
// dxg is an f32 operand: it goes to the tensor cores as three bf16 planes
// (hi = dxg truncated to bf16, mid = the rest truncated, lo = what is left;
// hi + mid + lo = dxg exactly, attn_common.cuh), one mma a plane, lo first,
// so each plane's products are exact and the sums f32. A step:
//   reduction the (kRows, 32) slices of the step before from every CTA of
//             the cluster, summed in rank order and rounded to bf16: the
//             dh_carry of the thread's (row, unit) items (dhn at the first
//             step);
//   gates     thread (row, unit): dxg[t] of its four gate columns from the
//             saved gates, c_t, c_{t-1}, dy and dc_all (brought in kRing - 1
//             steps ahead by cp.async), stored, and written as three bf16
//             planes to shared memory; the dc carry in registers;
//   product   per n8 tile of batch rows, 8 k-steps (the CTA's 128 columns)
//             of 3 planes of mma.sync.m16n8k16 into MT accumulators a warp,
//             staged in shared memory as the (kRows, H) partial;
//   exchange  the partial's (kRows, 32) slice of CTA q's units goes into
//             CTA q's receiving buffer (DSMEM, 16-byte stores), two buffers
//             by step;
//   barrier   the cluster barrier (release / acquire); the next step's
//             inputs are put in flight meanwhile.
// Rows past B carry zeros (their inputs zero-filled) and store nothing.

#include "lstm_cluster.cuh"

namespace {

using lstmc::kCols;
using lstmc::kRing;
using lstmc::kUnits;

constexpr int kFields = 8;  // a (row, unit)'s inputs a step: i, f, g, o, c, c_prev, dy, dc_all

template <int H, int NT>
struct Bwd {
  static constexpr int kCtas = lstmc::Width<H>::kCtas;
  static constexpr int kWarps = H / 16 >= 8 ? 8 : H / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int MT = H / 16 / kWarps;     // m16 tiles (rows of w_hh) a warp
  static constexpr int kRows = 8 * NT;           // batch rows a cluster
  static constexpr int kSteps = kCols / 16;      // k-steps of the product: 8
  static constexpr int kPStride = kCols + 8;     // bf16 planes; ldmatrix conflict-free
  static constexpr int kSStride = H + 4;         // f32 partial; fragment stores conflict-free
  static constexpr int kItems = kRows * kUnits / kThreads;  // (row, unit) items a thread
  // Shared memory, bytes: the input ring [kRing][kRows][kFields][kUnits]
  // f32, the planes [3][kRows][kPStride] bf16, the partial [kRows][kSStride]
  // f32, the receiving buffers [2][kCtas][kRows][kUnits] f32.
  static constexpr size_t kRingBytes = size_t(kRing) * kRows * kFields * kUnits * 4;
  static constexpr size_t kPlaneBytes = size_t(3) * kRows * kPStride * 2;
  static constexpr size_t kPartBytes = size_t(kRows) * kSStride * 4;
  static constexpr size_t kRecvBytes = size_t(2) * kCtas * kRows * kUnits * 4;
  static constexpr size_t kSmem = kRingBytes + kPlaneBytes + kPartBytes + kRecvBytes;
  static_assert(kItems >= 1 && MT >= 1, "shape");
};

// Step t's inputs of the cluster's rows b0 .. and the CTA's units into ring
// slot `slot` ([row][field][unit]), rows past B as zeros; committed as one
// group even when t is out of range.
template <int H, int NT>
__device__ __forceinline__ void fetch_step(float* slot, const float* __restrict__ g_all,
                                           const float* __restrict__ c_all,
                                           const float* __restrict__ c0,
                                           const float* __restrict__ dy,
                                           const float* __restrict__ dc_all, int t, int T, int B,
                                           int b0, int u0) {
  using F = Bwd<H, NT>;
  constexpr int kVecs = kUnits / 4;  // 16-byte vectors a field
  if (t >= 0 && t < T) {
    for (int q = threadIdx.x; q < F::kRows * kFields * kVecs; q += F::kThreads) {
      const int row = q / (kFields * kVecs), field = (q / kVecs) % kFields, v = q % kVecs;
      const bool valid = b0 + row < B;
      const size_t r = size_t(t) * B + (valid ? b0 + row : 0);
      const int at = u0 + 4 * v;
      const float* src;
      if (field < 4) {
        src = g_all + r * 4 * H + field * H + at;
      } else if (field == 4) {
        src = c_all + r * H + at;
      } else if (field == 5) {
        src = t > 0 ? c_all + (r - B) * H + at : c0 + (r % B) * H + at;
      } else {
        src = (field == 6 ? dy : dc_all) + r * H + at;
      }
      attn::cp_async16(slot + (row * kFields + field) * kUnits + 4 * v, src, valid);
    }
  }
  attn::cp_async_commit();
}

// The bf16 planes of x: hi = x truncated to bf16, mid = (x - hi) truncated,
// lo = x - hi - mid (exact: attn_common.cuh), as bf16 bit patterns.
__device__ __forceinline__ void split3(float x, unsigned short& hi, unsigned short& mid,
                                       unsigned short& lo) {
  const uint32_t u = __float_as_uint(x);
  const float r = x - __uint_as_float(u & 0xffff0000u);
  const uint32_t m = __float_as_uint(r);
  const float l = r - __uint_as_float(m & 0xffff0000u);
  hi = static_cast<unsigned short>(u >> 16);
  mid = static_cast<unsigned short>(m >> 16);
  lo = static_cast<unsigned short>(__float_as_uint(l) >> 16);
}

// dh_carry of the thread's items from the receiving buffer `recv`
// ([kCtas][kRows][kUnits]): the CTAs' partials summed in rank order, rounded
// to bf16.
template <int H, int NT>
__device__ __forceinline__ void reduce(const float* recv, float (&dh)[Bwd<H, NT>::kItems],
                                       int warp, int lane) {
  using F = Bwd<H, NT>;
#pragma unroll
  for (int i = 0; i < F::kItems; ++i) {
    const float* p = recv + (warp + F::kWarps * i) * kUnits + lane;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < F::kCtas; ++q) s += p[q * F::kRows * kUnits];
    dh[i] = attn::round_bf16(s);
  }
}

template <int H, int NT, bool kSplit>
__global__ void __launch_bounds__(Bwd<H, NT>::kThreads, 1)
lstm_bwd_bf16_kernel(const float* __restrict__ g_all, const float* __restrict__ w_hh,
                     const float* __restrict__ c0, const float* __restrict__ c_all,
                     const float* __restrict__ dy, const float* __restrict__ dc_all,
                     const float* __restrict__ dhn, const float* __restrict__ dcn,
                     float* __restrict__ dxg, float* __restrict__ dh0, float* __restrict__ dc0,
                     int T, int B, long long* split, int split_steps) {
  using F = Bwd<H, NT>;
  constexpr int kCtas = F::kCtas, kRows = F::kRows, kWarps = F::kWarps, MT = F::MT, G = 4 * H;
  lstm::StepClock<kSplit> clock(split, split_steps);
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  unsigned short* planes = reinterpret_cast<unsigned short*>(smem + F::kRingBytes);
  float* part = reinterpret_cast<float*>(smem + F::kRingBytes + F::kPlaneBytes);
  float* recv = part + kRows * F::kSStride;
  constexpr int kSlot = kRows * kFields * kUnits, kPlane = kRows * F::kPStride;
  constexpr int kRecv = kCtas * kRows * kUnits;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rank = lstmc::cluster_rank();
  const int u0 = rank * kUnits, b0 = int(blockIdx.x) / kCtas * kRows;

  for (int s = 0; s < kRing - 1; ++s)
    fetch_step<H, NT>(ring + s * kSlot, g_all, c_all, c0, dy, dc_all, T - 1 - s, T, B, b0, u0);

  // A fragments of w_hh: rows m (of w_hh, the destination units) of the
  // warp's m16 tiles 16 (MT warp + j) + g (+ 8), columns the CTA's gate
  // columns c (gate c / 32, unit u0 + c % 32); two neighbouring columns are
  // neighbours in w_hh.
  uint32_t a[MT][F::kSteps][4];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const float* lo = w_hh + size_t(16 * (MT * warp + j) + g) * G + u0;
    const float* hi = lo + size_t(8) * G;
#pragma unroll
    for (int kk = 0; kk < F::kSteps; ++kk) {
      const int c = 16 * kk + 2 * t4, c8 = c + 8;
      const int at = (c / kUnits) * H + c % kUnits, at8 = (c8 / kUnits) * H + c8 % kUnits;
      a[j][kk][0] = attn::pack_bf16(lo[at], lo[at + 1]);
      a[j][kk][1] = attn::pack_bf16(hi[at], hi[at + 1]);
      a[j][kk][2] = attn::pack_bf16(lo[at8], lo[at8 + 1]);
      a[j][kk][3] = attn::pack_bf16(hi[at8], hi[at8 + 1]);
    }
  }
  // The thread's items (row, unit) = (warp + kWarps i, lane): the carries.
  float dh[F::kItems], dc[F::kItems];
#pragma unroll
  for (int i = 0; i < F::kItems; ++i) {
    const int b = b0 + warp + kWarps * i;
    dh[i] = b < B ? dhn[size_t(b) * H + u0 + lane] : 0.f;
    dc[i] = b < B ? dcn[size_t(b) * H + u0 + lane] : 0.f;
  }
  attn::cp_async_wait<kRing - 2>();  // the first step's inputs
  lstmc::cluster_arrive();           // every CTA has started; the ring is visible
  lstmc::cluster_wait();

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    clock.begin();
    if (s > 0) reduce<H, NT>(recv + ((s - 1) & 1) * kRecv, dh, warp, lane);
    clock.mark(lstm::kReduction);

    const float* in = ring + (s % kRing) * kSlot;
#pragma unroll
    for (int i = 0; i < F::kItems; ++i) {
      const int row = warp + kWarps * i, b = b0 + row;
      const float* p = in + row * kFields * kUnits + lane;
      const float gi = p[0], gf = p[kUnits], gg = p[2 * kUnits], go = p[3 * kUnits];
      const float c = p[4 * kUnits], c_prev = p[5 * kUnits];
      const float dh_total = p[6 * kUnits] + dh[i];
      const float tc = lstm::tanh_fast(c);
      const float d_o = dh_total * tc;
      const float dct = dh_total * go * (1.f - tc * tc) + dc[i] + p[7 * kUnits];
      const float dg[4] = {dct * gg * gi * (1.f - gi), dct * c_prev * gf * (1.f - gf),
                           dct * gi * (1.f - gg * gg), d_o * go * (1.f - go)};
      dc[i] = dct * gf;
      float* out = dxg + (size_t(t) * B + b) * G + u0 + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (b < B) out[q * H] = dg[q];
        unsigned short hi, mid, lo;
        split3(dg[q], hi, mid, lo);
        const int at = row * F::kPStride + q * kUnits + lane;
        planes[at] = hi;
        planes[kPlane + at] = mid;
        planes[2 * kPlane + at] = lo;
      }
    }
    __syncthreads();
    clock.mark(lstm::kGates);

#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float acc[MT][4] = {};
      const unsigned short* rows = planes + (nt * 8 + (lane & 7)) * F::kPStride + (lane >> 3) * 8;
#pragma unroll
      for (int kk = 0; kk < F::kSteps; kk += 2) {
#pragma unroll
        for (int p = 2; p >= 0; --p) {  // lo, mid, hi
          uint32_t r[4];
          attn::ldmatrix_x4(r, rows + p * kPlane + 16 * kk);
#pragma unroll
          for (int j = 0; j < MT; ++j) {
            attn::mma_bf16(acc[j], a[j][kk], r[0], r[1]);
            attn::mma_bf16(acc[j], a[j][kk + 1], r[2], r[3]);
          }
        }
      }
      // C: rows (units of dh) 16 (MT warp + j) + g, + 8; columns (batch
      // rows) nt * 8 + 2 t4, + 1.
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        float* out = part + (nt * 8 + 2 * t4) * F::kSStride + 16 * (MT * warp + j) + g;
        out[0] = acc[j][0];
        out[F::kSStride] = acc[j][1];
        out[8] = acc[j][2];
        out[F::kSStride + 8] = acc[j][3];
      }
    }
    __syncthreads();
    clock.mark(lstm::kProduct);

    // CTA q gets rows 0 .. kRows - 1 of the partial at its units, into slot
    // `rank` of its receiving buffer s & 1.
    float* dst = recv + (s & 1) * kRecv + rank * kRows * kUnits;
    lstmc::publish(kCtas, kRows * (kUnits / 4), F::kThreads,
                   [&](int q, int v) { return part + (v / 8) * F::kSStride + q * kUnits + (v % 8) * 4; },
                   [&](int, int v) { return dst + v * 4; });
    attn::cp_async_wait<kRing - 3>();  // the next step's inputs
    clock.mark(lstm::kExchange);
    lstmc::cluster_arrive();
    fetch_step<H, NT>(ring + ((s + kRing - 1) % kRing) * kSlot, g_all, c_all, c0, dy, dc_all,
                      t - (kRing - 1), T, B, b0, u0);
    lstmc::cluster_wait();
    clock.mark(lstm::kBarrierWait);
    clock.end_step(s);
  }
  clock.finish();
  attn::cp_async_wait<0>();
  if (T > 0) reduce<H, NT>(recv + ((T - 1) & 1) * kRecv, dh, warp, lane);
#pragma unroll
  for (int i = 0; i < F::kItems; ++i) {
    const int b = b0 + warp + kWarps * i;
    if (b < B) {
      dh0[size_t(b) * H + u0 + lane] = dh[i];
      dc0[size_t(b) * H + u0 + lane] = dc[i];
    }
  }
}

template <int H, int NT, bool kSplit>
cudaError_t fit(int device, int& clusters) {
  static int cached[lstmc::kMaxDevices] = {};
  return lstmc::fit(lstm_bwd_bf16_kernel<H, NT, kSplit>, Bwd<H, NT>::kCtas,
                    Bwd<H, NT>::kThreads, Bwd<H, NT>::kSmem, device, clusters, cached);
}

constexpr int kTiles[] = {1, 2};  // the NT a launch may take

template <int H, bool kSplit>
int run(const float* g_all, const float* w_hh, const float* c0, const float* c_all,
        const float* dy, const float* dc_all, const float* dhn, const float* dcn, float* dxg,
        float* dh0, float* dc0, int T, int B, int device, cudaStream_t stream, long long* split,
        int split_steps, int* plan_out) {
  int f[2];
  cudaError_t err = fit<H, 1, kSplit>(device, f[0]);
  if (err == cudaSuccess) err = fit<H, 2, kSplit>(device, f[1]);
  if (err != cudaSuccess) return err;
  const int pick = lstmc::plan(B, kTiles, f, 2);
  if (f[pick] < 1) return cudaErrorInvalidConfiguration;
  const int nt = kTiles[pick], clusters = (B + 8 * nt - 1) / (8 * nt);
  if (plan_out != nullptr) {
    plan_out[0] = nt;
    plan_out[1] = clusters;
    plan_out[2] = f[pick];
    return cudaSuccess;
  }
#define K2C_LAUNCH(NT)                                                                        \
  return lstmc::launch(lstm_bwd_bf16_kernel<H, NT, kSplit>, Bwd<H, NT>::kCtas, clusters,      \
                       Bwd<H, NT>::kThreads, Bwd<H, NT>::kSmem, stream, g_all, w_hh, c0,      \
                       c_all, dy, dc_all, dhn, dcn, dxg, dh0, dc0, T, B, split, split_steps)
  if (nt == 1) K2C_LAUNCH(1);
  K2C_LAUNCH(2);
#undef K2C_LAUNCH
}

template <bool kSplit>
int dispatch(const float* g_all, const float* w_hh, const float* c0, const float* c_all,
             const float* dy, const float* dc_all, const float* dhn, const float* dcn,
             float* dxg, float* dh0, float* dc0, int T, int B, int H, int device, void* stream,
             long long* split, int split_steps, int* plan_out) {
  if (T < 0 || B < 1 || B > lstm::kMaxBatch) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K2C_H(HH)                                                                            \
  case HH:                                                                                   \
    return run<HH, kSplit>(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, dxg, dh0, dc0, T, B, \
                           device, s, split, split_steps, plan_out);
  switch (H) {
    K2C_H(64)
    K2C_H(128)
    K2C_H(256)
    K2C_H(512)
  }
#undef K2C_H
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches K2c on `stream` (a cudaStream_t) of `device`; returns a
// cudaError_t (0 on success). Pointers are device pointers to contiguous
// f32 arrays. H is 64, 128, 256 or 512 and B at most 256.
int morgana_lstm_bwd_bf16(const float* g_all, const float* w_hh, const float* c0,
                          const float* c_all, const float* dy, const float* dc_all,
                          const float* dhn, const float* dcn, float* dxg, float* dh0, float* dc0,
                          int T, int B, int H, int device, void* stream) {
  return dispatch<false>(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, dxg, dh0, dc0, T, B, H,
                         device, stream, nullptr, 0, nullptr);
}

// What a launch at (B, H) would take, launching nothing: out[0] the n8
// tiles of batch rows a cluster, out[1] the clusters, out[2] how many of
// them fit at once (cudaOccupancyMaxActiveClusters).
int morgana_lstm_bwd_bf16_plan(int B, int H, int device, int* out) {
  return dispatch<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, 0, B, H, device, nullptr, nullptr, 0, out);
}

#ifdef MORGANA_STEP_SPLIT
// As morgana_lstm_bwd_bf16, recording the phases of the first split_steps
// steps into split (two records of lstm::split_record(split_steps) entries:
// CTA 0 and the middle CTA of the grid).
int morgana_lstm_bwd_bf16_split(const float* g_all, const float* w_hh, const float* c0,
                                const float* c_all, const float* dy, const float* dc_all,
                                const float* dhn, const float* dcn, float* dxg, float* dh0,
                                float* dc0, int T, int B, int H, int device, void* stream,
                                long long* split, int split_steps) {
  return dispatch<true>(g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn, dxg, dh0, dc0, T, B, H,
                        device, stream, split, split_steps, nullptr);
}
#endif

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
