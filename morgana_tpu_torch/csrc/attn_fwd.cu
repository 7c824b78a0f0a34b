// K5/K6: exact softmax attention, forward, on Hopper (sm_90a).
//
// Replaces the two TPU attention kernels of morgana_tpu/nn.py's
// MultiHeadAttention: _splash (nn.py:1001, splash attention built by
// _splash_kernel :946) and _flash (nn.py:1055, flash attention). Both compute
// the same function, which this kernel computes for q, k, v (B, H, T, DH) f32:
//
//     o_i = sum_j softmax_j(q_i . k_j / sqrt(DH)) v_j   over the keys j that
//     query i sees: i, j < len_b, and with `causal` j <= i, and with `window`
//     W (> 0) also i - j < W (the splash LocalMask(window_size=(W-1, 0))).
//
// len_b is seq_len[b] (T when seq_len is null), clamped to [0, T]. Rows at or
// past len_b are padding, undefined in the JAX package (nn.py:1007-1012): here
// they see no key. A row that sees no key is written as 0 with a log-sum-exp
// of +inf, and its tiles are not computed. It also writes lse (B, H, T), the log-sum-exp of each
// row's scaled logits, which the backward (attn_bwd.cu) reads.
//
// What bounds it. At the shapes of the Transformer acoustic model (T up to
// ~1100 frames, DH 96, B 32) the T x T logits are the work: 4 * P * DH flops
// for P visible (query, key) pairs, against 4 * (4 * B * T * H * DH) bytes of
// q, k, v and o. At B32 T1024 that is ~51 GFLOP against ~200 MB, so the
// kernel is bound by operations: 0.77 ms at the 67 TFLOP/s of f32 outside
// the tensor cores, 0.06 ms of memory traffic.
//
// Design (the simple one: right first, fast later). One block of 256 threads
// per (b * H + h, 64-row query tile). The q tile stays in shared memory; the
// keys are walked in tiles of 64, each k and v tile loaded into shared memory
// (rows padded to DH + 4 floats so that a quarter warp's float4 reads of 8
// rows hit 32 distinct banks). The online softmax keeps a running max and sum
// per row in registers. Thread (ty, tx) of the 16 x 16 grid owns rows
// ty + 16 i (i < 4) of the tile, logit columns tx + 16 j (j < 4), and output
// columns tx + 16 c (c < DH / 16); the 16 threads of a row are one half warp,
// so a row's max and sum are reduced with shuffles. Query tiles wholly past
// len_b run no loop, and key tiles wholly past len_b or outside the
// causal/window band are never loaded, so windowed attention costs O(T * W). Plain f32 FMAs: no TF32 and no tensor cores yet,
// which leaves a later PR the wgmma/TMA pipeline (bf16 in, f32 accumulate).

#include "attn_common.cuh"

namespace {

using namespace attn;

template <int DH>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (3 * size_t(kTile) * (DH + 4) + size_t(kTile) * kPStride);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ seq_len,
                float* __restrict__ o, float* __restrict__ lse, int H, int T, int causal,
                int window) {
  constexpr int S = DH + 4;
  constexpr int C = DH / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTile * S;
  float* vs = ks + kTile * S;
  float* ps = vs + kTile * S;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t base = size_t(bh) * T * DH;
  const int len = seq_len == nullptr ? T : min(max(seq_len[bh / H], 0), T);
  const float scale = 1.f / sqrtf(float(DH));

  // The keys any row of this tile may see.
  int kv_end = q0 < len ? len : 0;
  if (causal) kv_end = min(kv_end, q0 + kTile);
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  load_tile<DH>(qs, q + base, q0, T);

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (kv_begin / kTile) * kTile; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile's k, v and p are no longer read
    load_tile<DH>(ks, k + base, k0, T);
    load_tile<DH>(vs, v + base, k0, T);
    __syncthreads();

    float s[4][4];
    tile_dot<DH>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(row, k0 + tx + 16 * j, len, causal, window) ? s[i][j] * scale
                                                                          : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // No key seen yet: nothing to add, and exp(-inf - -inf) must not run.
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = m_new == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_acc<DH>(acc, ps, vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) o[base + size_t(row) * DH + tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0) lse[size_t(bh) * T + row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, const int* seq_len, float* o,
                   float* lse, int B, int H, int T, int causal, int window, int device,
                   cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<DH>();
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(attn_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTile - 1) / kTile, B * H);
  attn_fwd_kernel<DH><<<grid, kThreads, smem, stream>>>(q, k, v, seq_len, o, lse, H, T, causal,
                                                        window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K5/K6's forward on `stream` (a cudaStream_t) of `device`; returns a
// cudaError_t (0 on success). q, k, v, o are contiguous f32 (B, H, T, DH), lse
// f32 (B, H, T), seq_len int32 (B,) or null. DH is 64, 96 or 128; B, H, T >= 1,
// B * H < 65536; window <= 0 means no window.
int morgana_attn_fwd(const float* q, const float* k, const float* v, const int* seq_len, float* o,
                     float* lse, int B, int H, int T, int DH, int causal, int window, int device,
                     void* stream) {
  if (B < 1 || H < 1 || T < 1 || B * H > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 64: return launch<64>(q, k, v, seq_len, o, lse, B, H, T, causal, window, device, s);
    case 96: return launch<96>(q, k, v, seq_len, o, lse, B, H, T, causal, window, device, s);
    case 128: return launch<128>(q, k, v, seq_len, o, lse, B, H, T, causal, window, device, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
