// K5/K6: exact softmax attention, backward, on Hopper (sm_90a).
//
// Replaces the fused backward of the TPU splash kernel (nn.py:1001,
// use_fused_bwd_kernel=True at :975) and flash attention's backward
// (nn.py:1055). Given q, k, v, the forward's o and lse (attn_fwd.cu) and the
// cotangent do, it writes dq, dk, dv for the function attn_fwd.cu computes:
// with P_ij = exp(q_i . k_j * s - lse_i) on the visible pairs (0 elsewhere),
// s = 1 / sqrt(DH) and D_i = do_i . o_i,
//
//     dv_j = sum_i P_ij do_i
//     dS_ij = P_ij (do_i . v_j - D_i)
//     dq_i = s sum_j dS_ij k_j,   dk_j = s sum_i dS_ij q_i.
//
// FlashAttention-2's recomputation, in two kernels on the same stream and no
// atomics, so that a run repeats bit for bit:
// 1. attn_bwd_dq_kernel, one block per (b * H + h, 64-row query tile): D for
//    its rows (written out for step 2), then dq over the key tiles the rows
//    see.
// 2. attn_bwd_dkdv_kernel, one block per (b * H + h, 64-key tile): dk and dv
//    over the query tiles that see its keys. Key tiles wholly past len_b are
//    written as zeros without a loop; so are dq's rows past len_b.
//
// What bounds it: 10 * P * DH flops for P visible pairs (the logits twice,
// do . v twice, and the three products), ~1.9 ms at B32 T1024 H4 DH96 at the
// f32 rate; the bytes (q, k, v, o, do read, dq, dk, dv written) are ~0.1 ms.
// The design is the forward's: 64-row tiles in shared memory with rows of
// DH + 4 floats, a 16 x 16 grid of threads each owning 4 rows and strided
// columns, plain f32 FMAs. Tensor cores are left for later work.

#include "attn_common.cuh"

namespace {

using namespace attn;

template <int DH>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * size_t(kTile) * (DH + 4) + size_t(kTile) * kPStride);
}

template <int DH>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * size_t(kTile) * (DH + 4) + 2 * size_t(kTile) * kPStride + 2 * kTile);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ o,
                   const float* __restrict__ dout, const float* __restrict__ lse,
                   const int* __restrict__ seq_len, float* __restrict__ delta,
                   float* __restrict__ dq, int H, int T, int causal, int window) {
  constexpr int S = DH + 4;
  constexpr int C = DH / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kTile * S;
  float* ks = dos + kTile * S;
  float* vs = ks + kTile * S;
  float* dss = vs + kTile * S;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t base = size_t(bh) * T * DH;
  const int len = seq_len == nullptr ? T : min(max(seq_len[bh / H], 0), T);
  const float scale = 1.f / sqrtf(float(DH));

  load_tile<DH>(qs, q + base, q0, T);
  load_tile<DH>(dos, dout + base, q0, T);
  __syncthreads();

  // D_i = do_i . o_i and lse_i of this thread's rows (0 and +inf past T).
  float d_row[4], lse_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    float part = 0.f;
    if (row < T) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        part = fmaf(dos[(ty + 16 * i) * S + tx + 16 * c], o[base + size_t(row) * DH + tx + 16 * c],
                    part);
    }
    d_row[i] = row_sum(part);
    lse_row[i] = row < T ? lse[size_t(bh) * T + row] : INFINITY;
    if (row < T && tx == 0) delta[size_t(bh) * T + row] = d_row[i];
  }

  float acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

  int kv_end = q0 < len ? len : 0;
  if (causal) kv_end = min(kv_end, q0 + kTile);
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (kv_begin / kTile) * kTile; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile's k, v and dS are no longer read
    load_tile<DH>(ks, k + base, k0, T);
    load_tile<DH>(vs, v + base, k0, T);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<DH>(s, qs, ks, ty, tx);
    tile_dot<DH>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(row, k0 + tx + 16 * j, len, causal, window)
                            ? expf(s[i][j] * scale - lse_row[i]) : 0.f;
        dss[(ty + 16 * i) * kPStride + tx + 16 * j] = p * (dp[i][j] - d_row[i]);
      }
    }
    __syncthreads();
    tile_acc<DH>(acc, dss, ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= T) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) dq[base + size_t(row) * DH + tx + 16 * c] = acc[i][c] * scale;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ seq_len, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int T, int causal, int window) {
  constexpr int S = DH + 4;
  constexpr int C = DH / 16;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTile * S;
  float* qs = vs + kTile * S;
  float* dos = qs + kTile * S;
  float* pts = dos + kTile * S;      // P^T tile: [key][query]
  float* dsts = pts + kTile * kPStride;  // dS^T tile
  float* lse_s = dsts + kTile * kPStride;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t base = size_t(bh) * T * DH;
  const int len = seq_len == nullptr ? T : min(max(seq_len[bh / H], 0), T);
  const float scale = 1.f / sqrtf(float(DH));

  float acc_k[4][C], acc_v[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // The queries that may see a key of this tile: the rows below len, from the
  // tile on when causal, and at most window - 1 rows past its last key.
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(len, k0 + kTile - 1 + window) : len;
  if (k0 < len) {
    load_tile<DH>(ks, k + base, k0, T);
    load_tile<DH>(vs, v + base, k0, T);
    for (int q0 = q_begin; q0 < q_end; q0 += kTile) {
      __syncthreads();  // the previous tile's q, do, P^T and dS^T are no longer read
      load_tile<DH>(qs, q + base, q0, T);
      load_tile<DH>(dos, dout + base, q0, T);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < T ? lse[size_t(bh) * T + row] : INFINITY;
        delta_s[threadIdx.x] = row < T ? delta[size_t(bh) * T + row] : 0.f;
      }
      __syncthreads();

      // Transposed tiles: element [a][b] is key k0 + ty + 16 a, query q0 + tx + 16 b.
      float st[4][4], dpt[4][4];
      tile_dot<DH>(st, ks, qs, ty, tx);
      tile_dot<DH>(dpt, vs, dos, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int qi = tx + 16 * b;
          const float p = visible(q0 + qi, k0 + ty + 16 * a, len, causal, window)
                              ? expf(st[a][b] * scale - lse_s[qi]) : 0.f;
          pts[(ty + 16 * a) * kPStride + qi] = p;
          dsts[(ty + 16 * a) * kPStride + qi] = p * (dpt[a][b] - delta_s[qi]);
        }
      }
      __syncthreads();
      tile_acc<DH>(acc_v, pts, dos, ty, tx);
      tile_acc<DH>(acc_k, dsts, qs, ty, tx);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= T) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[base + size_t(key) * DH + tx + 16 * c] = acc_k[a][c] * scale;
      dv[base + size_t(key) * DH + tx + 16 * c] = acc_v[a][c];
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem, int device) {
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                   const float* dout, const float* lse, const int* seq_len, float* delta,
                   float* dq, float* dk, float* dv, int B, int H, int T, int causal, int window,
                   int device, cudaStream_t stream) {
  cudaError_t err = set_smem(attn_bwd_dq_kernel<DH>, dq_smem_bytes<DH>(), device);
  if (err != cudaSuccess) return err;
  err = set_smem(attn_bwd_dkdv_kernel<DH>, dkdv_smem_bytes<DH>(), device);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTile - 1) / kTile, B * H);
  attn_bwd_dq_kernel<DH><<<grid, kThreads, dq_smem_bytes<DH>(), stream>>>(
      q, k, v, o, dout, lse, seq_len, delta, dq, H, T, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<DH><<<grid, kThreads, dkdv_smem_bytes<DH>(), stream>>>(
      q, k, v, dout, lse, delta, seq_len, dk, dv, H, T, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K5/K6's backward (two kernels, in order) on `stream` (a
// cudaStream_t) of `device`; returns a cudaError_t (0 on success). q, k, v, o,
// dout, dq, dk, dv are contiguous f32 (B, H, T, DH); lse and delta (scratch
// for D) f32 (B, H, T); seq_len int32 (B,) or null. DH is 64, 96 or 128;
// B, H, T >= 1, B * H < 65536; window <= 0 means no window.
int morgana_attn_bwd(const float* q, const float* k, const float* v, const float* o,
                     const float* dout, const float* lse, const int* seq_len, float* delta,
                     float* dq, float* dk, float* dv, int B, int H, int T, int DH, int causal,
                     int window, int device, void* stream) {
  if (B < 1 || H < 1 || T < 1 || B * H > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 64:
      return launch<64>(q, k, v, o, dout, lse, seq_len, delta, dq, dk, dv, B, H, T, causal, window,
                        device, s);
    case 96:
      return launch<96>(q, k, v, o, dout, lse, seq_len, delta, dq, dk, dv, B, H, T, causal, window,
                        device, s);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, seq_len, delta, dq, dk, dv, B, H, T, causal,
                         window, device, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
