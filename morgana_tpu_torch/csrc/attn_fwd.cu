// K5/K6: exact softmax attention, forward, on Hopper (sm_90a).
//
// Replaces the two TPU attention kernels of morgana_tpu/nn.py's
// MultiHeadAttention: _splash (nn.py:1001, splash attention built by
// _splash_kernel :946) and _flash (nn.py:1055, flash attention). Both compute
// the same function, which this kernel computes for q, k, v (B, H, T, DH)
// f32 (K5b, the forward on bf16 q, k, v, is attn_fwd_bf16.cu):
//
//     o_i = sum_j softmax_j(q_i . k_j / sqrt(DH)) v_j   over the keys j that
//     query i sees: i, j < len_b, and with `causal` j <= i, and with `window`
//     W (> 0) also i - j < W (the splash LocalMask(window_size=(W-1, 0))).
//
// len_b is seq_len[b] (T when seq_len is null), clamped to [0, T]. Rows at or
// past len_b are padding, undefined in the JAX package (nn.py:1007-1012): here
// they see no key. A row that sees no key is written as 0 with a log-sum-exp
// of +inf, and its tiles are not computed. It also writes lse (B, H, T), the
// log-sum-exp of each row's scaled logits, which the backward (attn_bwd.cu)
// reads.
//
// What bounds it. At the Transformer acoustic model's shapes (T up to ~1100
// frames, DH 96) the T x T logits are the work: 4 * P * DH flops for P
// visible (query, key) pairs against 4 * (4 * B * T * H * DH) bytes of q, k,
// v and o. On the tensor cores in 3xTF32 that is 3 * 4 * P * DH flops at 495
// TFLOP/s: 0.074 ms at B16 T1024 H4 (P = 31.8 M) against 0.03 ms of memory
// traffic and 0.008 ms of exp2 at the SFU rate. So it is bound by operations,
// and every product must run on the tensor cores (the f32 FMA units give
// 67 TFLOP/s, 0.18 ms for the same work).
//
// Design (attn_common.cuh has the products and copies). One block of 4
// warps per (b * H + h, 64-row query tile), the tiles of one row longest
// first. Each warp owns 16 query rows and keeps their q in registers (dh/2
// floats a thread), split into the A fragments of S = q.k^T at each key
// tile: a kept split would take dh, which dh 128 does not have. The keys are
// walked in tiles of 64, k and v streamed by cp.async through a ring of two
// stages (the next tile lands while this one is computed; one barrier a
// tile). A warp's S (16 x 64) is f32 in registers; the online softmax
// (scale, running max, exp2, running sum, rescale of o) runs on it in place
// on the CUDA cores, masking only on tiles that cross the band or len_b, and
// the probabilities feed p.v from registers as its A operand. Key tiles
// wholly past len_b or outside the causal/window band are never loaded, and
// a warp skips a tile that none of its rows sees, so windowed attention
// costs O(T * W).
//
// Both products are mma.sync, not wgmma. TF32 wgmma reads B only K-major
// from shared memory, in its canonical layout, so its 3xTF32 needs hi and lo
// planes of each streamed tile written by the block (and a transposed v for
// p.v). That data path, built and measured with mma.sync reading the planes,
// was slower than each warp splitting its own fragments: the planes double
// the shared-memory reads and add a barrier a tile (PERF.md).

#include "attn_common.cuh"

namespace {

using namespace attn;

template <int DH>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * size_t(kStages) * kTile * (kRowStride<DH> + kColStride<DH>);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ seq_len,
                float* __restrict__ o, float* __restrict__ lse, int H, int T, int causal,
                int window) {
  constexpr int SK = kRowStride<DH>;  // k is read along its rows (q.k^T)
  constexpr int SV = kColStride<DH>;  // v down its columns (p.v)
  constexpr int KC = DH / 16;         // 16-byte reads of a q row a lane: two k-steps each
  constexpr int ND = DH / 8;          // 8-column tiles of o
  constexpr int NK = kTile / 8;       // 8-key columns of a key tile
  constexpr int kStage = kTile * (SK + SV);
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // kStages x {k, v}

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int row0 = q0 + 16 * warp;
  const size_t base = size_t(bh) * T * DH;
  const int len = seq_len == nullptr ? T : min(max(seq_len[bh / H], 0), T);
  const float scale_log2 = kLog2e / sqrtf(float(DH));

  // The keys any row of this tile may see, from a whole key tile on.
  int kv_end = q0 < len ? len : 0;
  if (causal) kv_end = min(kv_end, q0 + kTile);
  const int kv_first = window > 0 ? (max(0, q0 - window + 1) / kTile) * kTile : 0;

  const float* kb = k + base;
  const float* vb = v + base;
  if (kv_first < kv_end) {
    copy_tile_async<float, DH, SK, kTile>(ring, kb, kv_first, T);
    copy_tile_async<float, DH, SV, kTile>(ring + kTile * SK, vb, kv_first, T);
  }
  cp_async_commit();

  // This warp's q rows g and g + 8 in registers, 16 bytes a chunk (rows past
  // T zero), split into A fragments at each key tile.
  float4 qx[KC], qy[KC];
  {
    const int ra = row0 + g, rb = ra + 8;
    const float4 zero = {};
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const size_t at = 16 * c + 4 * t;
      qx[c] = ra < T ? *reinterpret_cast<const float4*>(q + base + size_t(ra) * DH + at) : zero;
      qy[c] = rb < T ? *reinterpret_cast<const float4*>(q + base + size_t(rb) * DH + at) : zero;
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  int stage = 0;
  for (int k0 = kv_first; k0 < kv_end; k0 += kTile, stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed; every warp is done with the other stage
    if (k0 + kTile < kv_end) {
      float* next = ring + (stage ^ 1) * kStage;
      copy_tile_async<float, DH, SK, kTile>(next, kb, k0 + kTile, T);
      copy_tile_async<float, DH, SV, kTile>(next + kTile * SK, vb, k0 + kTile, T);
    }
    cp_async_commit();
    const float* ks = ring + stage * kStage;
    const float* vs = ks + kTile * SK;

    // Whether any row of this warp sees a key of this tile, and whether
    // every row sees every key (no mask to apply).
    const bool live = row0 < len && !(causal && k0 > row0 + 15) &&
                      !(window > 0 && k0 + kTile - 1 < row0 - window + 1);
    const bool whole = row0 + 15 < len && k0 + kTile <= len &&
                       (!causal || k0 + kTile - 1 <= row0) &&
                       (window <= 0 || row0 + 15 - k0 < window);
    if (live) {
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        FragA a0, a1;
        split_a2(qx[c], qy[c], a0, a1);
        FragB b0[NK], b1[NK];
#pragma unroll
        for (int n = 0; n < NK; ++n) load_b2_rows<SK>(ks, 8 * n, c, g, t, b0[n], b1[n]);
        mma3<NK>(s, a0, b0);
        mma3<NK>(s, a1, b1);
      }

      // Online softmax in log2 units: s[n][e] is row g + 8 (e / 2), key
      // k0 + 8 n + 2 t + e % 2.
      float mx[2] = {-INFINITY, -INFINITY};
      if (whole) {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] *= scale_log2;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
          }
      } else {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = visible(row0 + g + 8 * (e >> 1), k0 + 8 * n + 2 * t + (e & 1), len, causal,
                              window) ? s[n][e] * scale_log2 : -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
          }
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        // While a row has seen no key, subtract 0: exp2(-inf) is 0, and
        // -inf - -inf must not run.
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2_approx(m[r] - m_use[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(s[n][e] - m_use[e >> 1]);
          s[n][e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // o += p . v, p from registers.
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const FragA a = a_from_c(s[kk]);
        FragB b[ND];
#pragma unroll
        for (int c = 0; c < DH / 32; ++c) load_b4_cols<SV>(vs, 8 * kk, c, g, t, b + 4 * c);
        mma3<ND>(acc, a, b);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    float* out = o + base + size_t(row) * DH;
#pragma unroll
    for (int c = 0; c < DH / 32; ++c) store_c4(out, acc + 4 * c, c, r, t, inv);
    if (t == 0) lse[size_t(bh) * T + row] = sum > 0.f ? (m[r] + log2f(sum)) * kLn2 : INFINITY;
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seq_len, float* o,
                   float* lse, int B, int H, int T, int causal, int window, int device,
                   cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<DH>();
  const cudaError_t err = set_smem(attn_fwd_kernel<DH>, smem, device);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTile - 1) / kTile, B * H);
  attn_fwd_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      seq_len, o, lse, H, T, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K5/K6's forward on `stream` (a cudaStream_t) of `device`; returns a
// cudaError_t (0 on success). q, k, v are contiguous f32 (B, H, T, DH); o is
// f32 (B, H, T, DH), lse f32 (B, H, T), seq_len int32 (B,) or null. DH is 64,
// 96 or 128; B, H, T >= 1, B * H < 65536; window <= 0 means no window.
int morgana_attn_fwd(const void* q, const void* k, const void* v, const int* seq_len, float* o,
                     float* lse, int B, int H, int T, int DH, int causal, int window, int device,
                     void* stream) {
  if (B < 1 || H < 1 || T < 1 || B * H > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 64:
      return launch<64>(q, k, v, seq_len, o, lse, B, H, T, causal, window, device, s);
    case 96:
      return launch<96>(q, k, v, seq_len, o, lse, B, H, T, causal, window, device, s);
    case 128:
      return launch<128>(q, k, v, seq_len, o, lse, B, H, T, causal, window, device, s);
  }
  return cudaErrorInvalidValue;
}

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
