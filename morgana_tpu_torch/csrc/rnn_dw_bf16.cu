// The bf16 weight-gradient carry: dW_hh of an LSTM or GRU layer under a
// bf16 compute dtype, on Hopper (sm_90a), shared by both layers
// (ops/weight_grad.py).
//
// Replaces what JAX's autodiff of the scan of morgana_tpu/ops/rnn.py::lstm
// (:120-126) and ::gru (:351-355) computes for w_hh when compute_dtype is
// bf16. w_hh enters the scan's body as a bf16 constant (w_hh_c), so the
// scan's transpose carries its cotangent in a bf16 carry: each step's
// contribution, the f32 product of the bf16 h_{t-1} and the f32 gate
// gradients summed over the batch, is rounded to bf16 and added into the
// carry with bf16 rounding, walking t from T-1 down to 0:
//
//     dW = 0
//     for t = T-1 .. 0:
//         dW = round(dW + round(sum_b round(h_prev[t, b, k]) * dg[t, b, c]))
//
// with round() to bf16 (to nearest even, as XLA's convert). Inputs: h_prev
// (T, B, H), the state each step's product read (h0 at t = 0, then y), and
// dg (T, B, G) the gradients of that product's G = 4H (LSTM) or 3H (GRU)
// gate columns, both f32 with their last dimension contiguous and any
// strides for t and b (the GRU's are batch-major). Output: dW (H, G) in
// f32, each value a bf16 value.
//
// What bounds it. H * G * T * B multiply-adds of a bf16 h by an f32 dg with
// f32 sums: three bf16 tensor-core passes a product (dg in three bf16
// planes, attn_common.cuh), at the LSTM's B32 T1024 H512 G2048 0.21 ms at
// 989 TFLOP/s, against 0.1 ms of bytes (h_prev and dg read once):
// operations. At F0's H64 G192 the bytes bound it (0.03 ms), and the chain
// of T dependent rounding adds a dW element is the latency floor.
//
// Design. The products do not depend on the carry; only the rounding add
// of each step's product into it is sequential in t. Each step's product
// runs as mma.sync.m16n8k16 in bf16, the batch as the depth (rows past B
// zero): h rounded to bf16 (exact in the product), dg split into its three
// bf16 planes, f32 sums. Rows of h_prev and dg land by cp.async in a ring of
// 3 stages, each stage an item of STEPS consecutive steps (t from T-1 down)
// and 32 batch rows, two items in flight while one is computed, one barrier
// an item; a warp reads its fragments from the f32 rows (row strides width
// + 4, = 4 mod 16: conflict-free), and each step of an item has its own
// f32 accumulator, so that its products are independent chains. Two routes:
// - the carry in one launch (Carry: the LSTM's widths, where the 64 x 128
//   tiles of dW fill the card): a block of 8 warps (each the tile's 64 rows
//   and 16 of its columns) owns a tile for all T steps and keeps its
//   carries in registers as bf16 pairs, in the accumulator's layout; after
//   an item each step's accumulator is rounded and added into them with one
//   bf16 rounding, in order (a step before t = 0 is zeros, whose add leaves
//   the carry as it is).
// - windows of steps (Products, then rnn_dw_chain_kernel: F0Model's 12,288
//   and DurationModel's 49,152 elements, whose tiles would leave most SMs
//   idle through T dependent steps): the rounded products of a window, in
//   parallel over 64 x 64 tiles and segments of steps, to a bf16 scratch;
//   then a thread an element adds them into its carry from the window's last
//   step down.
// A tile of the first route reads 24 KB of h_prev and dg rows a step from L2
// (3.2 GB at the LSTM's B32 T1024). Measured apart on the H100, those
// copies alone take about as long as the products alone, and the two add
// up: the route runs at about 8x its bound (PERF.md).

#include "attn_common.cuh"

namespace {

constexpr int kChunk = 32;  // batch rows of an item: two k-steps of 16
constexpr int kStages = 3;

// A TM x TN tile over WM x WN warps, STEPS steps an item.
template <int TM, int TN, int WM, int WN, int STEPS>
struct Tile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int MT = TM / WM / 16;  // 16-row tiles of a warp
  static constexpr int NT = TN / WN / 8;   // 8-column tiles of a warp
  static constexpr int SH = TM + 4;        // row strides of an item's f32 rows
  static constexpr int SG = TN + 4;
  static constexpr int kStep = kChunk * (SH + SG);  // one step's rows of an item
  static constexpr size_t kSmem = sizeof(float) * size_t(kStages) * STEPS * kStep;
  static_assert(MT >= 1 && NT >= 1, "a warp owns whole 16 x 8 tiles");
};

// kChunk rows from b0 on of a (B, C) slice (row stride `stride`, the last
// dimension contiguous; `live` false: zeros) at columns c0 .. c0 + W - 1
// into dst (row stride SW), rows past B and columns past C as zeros; 16
// bytes a copy where the slice allows (`vec`), 4 otherwise. Issued by the
// whole block; `any` is a valid address for the copies that read nothing.
template <int W, int SW, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, bool live, int b0, int B,
                                           long long stride, int c0, int C, int vec,
                                           const float* any) {
  for (int idx = threadIdx.x; idx < kChunk * W / 4; idx += THREADS) {
    const int r = idx / (W / 4), c = 4 * (idx - r * (W / 4));
    const bool row_ok = live && b0 + r < B;
    const float* from = row_ok ? src + (b0 + r) * stride + c0 + c : any;
    if (vec && row_ok && c0 + c + 4 <= C) {
      attn::cp_async16(dst + r * SW + c, from, true);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row_ok && c0 + c + j < C;
        attn::cp_async4(dst + r * SW + c + j, ok ? from + j : any, ok);
      }
    }
  }
}

// Steps hi - 1 down to lo of the tile at (blockIdx.y, blockIdx.x), hi =
// t_hi - blockIdx.z * seg and lo = max(t_lo, hi - seg). kProducts false:
// the carry over all T steps (one block a tile), written to dw. kProducts
// true: each step's rounded product, bf16, to products[t - t_lo] (H, G).
template <int TM, int TN, int WM, int WN, int STEPS, bool kProducts>
__global__ void __launch_bounds__(Tile<TM, TN, WM, WN, STEPS>::kThreads)
rnn_dw_bf16_kernel(const float* __restrict__ h_prev, const float* __restrict__ dg,
                   float* __restrict__ dw, __nv_bfloat16* __restrict__ products, int t_hi,
                   int t_lo, int seg, int B, int H, int G, long long hs_t, long long hs_b,
                   long long gs_t, long long gs_b, int vec) {
  using L = Tile<TM, TN, WM, WN, STEPS>;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // kStages x STEPS x {h rows, dg rows}
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (warp / WN) * (TM / WM), wc = (warp % WN) * (TN / WN);  // the warp's corner
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int hi = t_hi - int(blockIdx.z) * seg, lo = max(t_lo, hi - seg);
  const int chunks = (B + kChunk - 1) / kChunk;
  const int items = (hi - lo + STEPS - 1) / STEPS * chunks;

  auto fetch = [&](int i) {
    if (i < items) {
      const int first = hi - 1 - (i / chunks) * STEPS, b0 = (i % chunks) * kChunk;
      float* stage = ring + (i % kStages) * STEPS * L::kStep;
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int step = first - s;
        float* hs = stage + s * L::kStep;
        stage_rows<TM, L::SH, L::kThreads>(hs, h_prev + step * hs_t, step >= lo, b0, B, hs_b,
                                           m0, H, vec, h_prev);
        stage_rows<TN, L::SG, L::kThreads>(hs + kChunk * L::SH, dg + step * gs_t, step >= lo,
                                           b0, B, gs_b, n0, G, vec, dg);
      }
    }
    attn::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i);

  // acc[s][mt][nt]: step s of the item, rows wr + 16 mt + g (e 0, 1) and
  // + 8 (e 2, 3) of the tile, columns wc + 8 nt + 2t, + 1; carry the same
  // as bf16 pairs, [0] row g, [1] row g + 8.
  float acc[STEPS][L::MT][L::NT][4];
  __nv_bfloat162 carry[L::MT][L::NT][2];
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt) {
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][mt][nt][e] = 0.f;
      carry[mt][nt][0] = carry[mt][nt][1] = __floats2bfloat162_rn(0.f, 0.f);
    }

  for (int i = 0; i < items; ++i) {
    attn::cp_async_wait<kStages - 2>();
    __syncthreads();  // item i has landed; every warp is done with item i - 1
    fetch(i + kStages - 1);
    const float* stage = ring + (i % kStages) * STEPS * L::kStep;
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const float* hs = stage + s * L::kStep + wr;
      const float* gs = stage + s * L::kStep + kChunk * L::SH + wc;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        // Depth (batch) rows 16 kk + 2t, + 1 (fragment registers 0 of A
        // and B) and + 8, + 9 (A 2, 3; B 1).
        const int r = 16 * kk + 2 * t;
        uint32_t b[L::NT][3][2];
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt) {
          const float* col = gs + 8 * nt + g;
          attn::split3_pack(col[r * L::SG], col[(r + 1) * L::SG], b[nt][0][0], b[nt][1][0],
                            b[nt][2][0]);
          attn::split3_pack(col[(r + 8) * L::SG], col[(r + 9) * L::SG], b[nt][0][1],
                            b[nt][1][1], b[nt][2][1]);
        }
#pragma unroll
        for (int mt = 0; mt < L::MT; ++mt) {
          const float* hc = hs + 16 * mt + g;
          const uint32_t a[4] = {
              attn::pack_bf16(hc[r * L::SH], hc[(r + 1) * L::SH]),
              attn::pack_bf16(hc[r * L::SH + 8], hc[(r + 1) * L::SH + 8]),
              attn::pack_bf16(hc[(r + 8) * L::SH], hc[(r + 9) * L::SH]),
              attn::pack_bf16(hc[(r + 8) * L::SH + 8], hc[(r + 9) * L::SH + 8])};
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
            for (int pl = 2; pl >= 0; --pl)
              attn::mma_bf16(acc[s][mt][nt], a, b[nt][pl][0], b[nt][pl][1]);
        }
      }
    }
    if (i % chunks != chunks - 1) continue;
    // The item's steps are whole: rounded, into the carry in order (a step
    // before lo is zeros, whose add leaves the carry as it is), or out.
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int step = hi - 1 - (i / chunks) * STEPS - s;
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* v = acc[s][mt][nt] + 2 * h;
            if constexpr (kProducts) {
              const int row = m0 + wr + 16 * mt + g + 8 * h, col = n0 + wc + 8 * nt + 2 * t;
              __nv_bfloat16* out = products + (size_t(step - t_lo) * H + row) * G + col;
              if (step >= lo && row < H && col < G) out[0] = __float2bfloat16_rn(v[0]);
              if (step >= lo && row < H && col + 1 < G) out[1] = __float2bfloat16_rn(v[1]);
            } else {
              // One rounding of the exact sum of two bf16 values: where it
              // is not an f32 (the product below 2^-16 of the carry) both
              // roundings leave the carry, so this is round(f32 sum).
              carry[mt][nt][h] = __hadd2(carry[mt][nt][h], __floats2bfloat162_rn(v[0], v[1]));
            }
            v[0] = v[1] = 0.f;
          }
    }
  }
  attn::cp_async_wait<0>();
  if constexpr (!kProducts) {
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wr + 16 * mt + g + 8 * h;
        if (row >= H) continue;
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt) {
          const int col = n0 + wc + 8 * nt + 2 * t;
          if (col < G) dw[size_t(row) * G + col] = __low2float(carry[mt][nt][h]);
          if (col + 1 < G) dw[size_t(row) * G + col + 1] = __high2float(carry[mt][nt][h]);
        }
      }
  }
}

// The chain of a window of `steps` rounded step products (products[k] the
// (H, G) product of step t_lo + k, n = H * G elements), from its last step
// down, into dw (from 0 when `first`): a thread an element, kUnroll loads in
// flight ahead of the rounding adds.
constexpr int kChainThreads = 128;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kChainThreads)
rnn_dw_chain_kernel(const __nv_bfloat16* __restrict__ products, float* __restrict__ dw,
                    int steps, long long n, int first) {
  const long long e = (long long)blockIdx.x * kChainThreads + threadIdx.x;
  if (e >= n) return;
  float c = first ? 0.f : dw[e];
  int k = steps - 1;
  for (; k >= kUnroll - 1; k -= kUnroll) {
    float p[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) p[j] = __bfloat162float(products[(k - j) * n + e]);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) c = attn::round_bf16(c + p[j]);
  }
  for (; k >= 0; --k) c = attn::round_bf16(c + __bfloat162float(products[k * n + e]));
  dw[e] = c;
}

template <int TM, int TN, int WM, int WN, int STEPS>
struct Config {
  using L = Tile<TM, TN, WM, WN, STEPS>;

  static long long tiles(int H, int G) {
    return (long long)((H + TM - 1) / TM) * ((G + TN - 1) / TN);
  }

  template <bool kProducts>
  static cudaError_t run(const float* h_prev, const float* dg, float* dw,
                         __nv_bfloat16* products, int t_hi, int t_lo, int seg, int B, int H,
                         int G, long long hs_t, long long hs_b, long long gs_t, long long gs_b,
                         int vec, int device, cudaStream_t stream) {
    const auto kernel = rnn_dw_bf16_kernel<TM, TN, WM, WN, STEPS, kProducts>;
    cudaError_t err = attn::set_smem(kernel, L::kSmem, device);
    if (err != cudaSuccess) return err;
    const int segments = max(1, (t_hi - t_lo + seg - 1) / seg);
    const dim3 grid((G + TN - 1) / TN, (H + TM - 1) / TM, segments);
    kernel<<<grid, L::kThreads, L::kSmem, stream>>>(h_prev, dg, dw, products, t_hi, t_lo, seg, B,
                                                    H, G, hs_t, hs_b, gs_t, gs_b, vec);
    return cudaGetLastError();
  }
};

// The two routes (the head of this file).
using Carry = Config<64, 128, 1, 8, 2>;
using Products = Config<64, 64, 2, 2, 2>;
constexpr long long kScratchElems = 1LL << 25;  // 64 MB of bf16 products

// Steps a window: all T where the scratch holds them, 0 for the one-launch
// carry.
int window_steps(int T, int H, int G, int sms) {
  if (8 * Carry::tiles(H, G) >= 7LL * sms) return 0;
  return int(max(1LL, min((long long)T, kScratchElems / ((long long)H * G))));
}

}  // namespace

extern "C" {

// The bf16 scratch (in elements) that morgana_rnn_dw_bf16 needs at these
// sizes on `device`: 0 where the carry runs in one launch.
long long morgana_rnn_dw_bf16_scratch(int T, int H, int G, int device) {
  int sms = 0;
  if (T < 1 || H < 1 || G < 1 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  return (long long)window_steps(T, H, G, sms) * H * G;
}

// Launches the carry on `stream` (a cudaStream_t) of `device`; returns a
// cudaError_t (0 on success). h_prev (T, B, H) and dg (T, B, G) are f32
// device arrays whose last dimension is contiguous, element (t, b, .) at
// t * stride_t + b * stride_b (in floats); dw is a contiguous f32 (H, G)
// array; scratch holds morgana_rnn_dw_bf16_scratch(T, H, G, device) bf16
// values (null when that is 0). T >= 0, B >= 1, H >= 1, G >= 1 and 65535
// tiles of rows at most.
int morgana_rnn_dw_bf16(const float* h_prev, const float* dg, float* dw, void* scratch, int T,
                        int B, int H, int G, long long hs_t, long long hs_b, long long gs_t,
                        long long gs_b, int device, void* stream) {
  if (T < 0 || B < 1 || H < 1 || G < 1 || H > 65535 * 16) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies need 16-byte aligned rows: both bases and all strides.
  const uintptr_t bases = reinterpret_cast<uintptr_t>(h_prev) | reinterpret_cast<uintptr_t>(dg);
  const int vec = bases % 16 == 0 && (hs_t | hs_b | gs_t | gs_b) % 4 == 0;
  const int window = T == 0 ? 0 : window_steps(T, H, G, sms);
  if (window == 0)
    return Carry::run<false>(h_prev, dg, dw, nullptr, T, 0, max(T, 1), B, H, G, hs_t, hs_b,
                             gs_t, gs_b, vec, device, s);
  if (scratch == nullptr) return cudaErrorInvalidValue;
  auto* products = static_cast<__nv_bfloat16*>(scratch);
  const long long n = (long long)H * G;
  // Steps a block: enough blocks for two waves of the card, whole items.
  const long long tiles = Products::tiles(H, G);
  for (int hi = T; hi > 0; hi -= window) {
    const int lo = max(0, hi - window);
    const long long z = max(1LL, (2LL * sms + tiles - 1) / tiles);
    const int seg = int(((hi - lo + z - 1) / z + 1) / 2 * 2);
    err = Products::run<true>(h_prev, dg, nullptr, products, hi, lo, seg, B, H, G, hs_t, hs_b,
                              gs_t, gs_b, vec, device, s);
    if (err != cudaSuccess) return err;
    rnn_dw_chain_kernel<<<(n + kChainThreads - 1) / kChainThreads, kChainThreads, 0, s>>>(
        products, dw, hi - lo, n, hi == T);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
