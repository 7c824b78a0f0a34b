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
//    see: S = q.k^T, dP = do.v^T, dq += dS.k.
// 2. attn_bwd_dkdv_kernel, one block per (b * H + h, 64-key tile): dk and dv
//    over the query tiles that see its keys: S^T = k.q^T, dP^T = v.do^T,
//    dv += P^T.do, dk += dS^T.q. Key tiles wholly past len_b are written as
//    zeros without a loop; so are dq's rows past len_b.
//
// What bounds it: 10 * P * DH flops for P visible pairs at least (the
// logits, do.v^T, and the three products dv, dq, dk); this two-pass design
// does 14 * P * DH, each kernel recomputing the logits and do.v^T. In
// 3xTF32 on the tensor cores the least is 3 * 10 * P * DH flops at 495
// TFLOP/s, 0.29 ms at B32 T1024 H4 DH96 (P = 49.8 M), against ~0.1 ms of
// bytes (q, k, v, o, do read, dq, dk, dv written) and 2 * P exp2.
//
// Design: the forward's (attn_common.cuh). Blocks of 4 warps, each warp 16
// rows of the block's own 64-row tile, all five products as mma.sync in
// 3xTF32, the logits and dS in registers, P and dS fed to the next product
// from registers. The block's own tiles (q and do for dq; k and v for dk/dv)
// sit in shared memory, read as A fragments; the other side streams through
// a two-stage cp.async ring in tiles of 32 rows, which keeps a warp's S and
// dP at 16 x 32 (16 registers each) beside its f32 accumulators (dq, or dk
// and dv: dh / 2 registers each). A streamed tile read both along its rows
// and down its columns (k for dq; q and do for dk/dv) takes the column
// stride, so its row reads take two passes. Shared memory at dh 96: 109 KB
// (dq) and 106 KB (dk/dv), so two blocks fit on an SM; the earlier f32-FMA
// kernels took 117 and 134 KB. A warp skips a streamed tile that none of its rows sees.
//
// K5b's backward, on bf16 q, k and v, is a kernel of its own
// (attn_bwd_bf16.cu).

#include "attn_common.cuh"

namespace {

using namespace attn;

constexpr int kStream = 32;  // rows of a streamed tile

// dq: q and do (the block's own rows) are read along their rows; streamed k
// along its rows (q.k^T) and down its columns (dS.k), v along its rows.
template <int DH>
constexpr int kDqStage = kStream * (kColStride<DH> + kRowStride<DH>);

template <int DH>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * size_t(2 * kTile * kRowStride<DH> + kStages * kDqStage<DH>);
}

// dk/dv: k and v (the block's own rows) along their rows; streamed q and do
// along their rows (k.q^T, v.do^T) and down their columns (dS^T.q, P^T.do),
// with lse and D of the streamed rows.
template <int DH>
constexpr int kDkdvStage = 2 * kStream * kColStride<DH>;

template <int DH>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * size_t(2 * kTile * kRowStride<DH> + kStages * kDkdvStage<DH>) +
         sizeof(float) * kStages * 2 * kStream;
}

// The logits S = q.k^T and dP = do.v^T of a warp's 16 rows and a streamed
// tile's kStream keys, as C fragments.
template <int DH, int SQ, int SK, int SV>
__device__ __forceinline__ void dq_tile_products(const float* qw, const float* dow,
                                                 const float* ks, const float* vs, int g, int t,
                                                 float (&s)[kStream / 8][4],
                                                 float (&dp)[kStream / 8][4]) {
  constexpr int NK = kStream / 8;
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) {
    FragA aq0, aq1, ad0, ad1;
    split_a2(ld4(qw + g * SQ + 16 * c + 4 * t), ld4(qw + (g + 8) * SQ + 16 * c + 4 * t), aq0,
             aq1);
    split_a2(ld4(dow + g * SQ + 16 * c + 4 * t), ld4(dow + (g + 8) * SQ + 16 * c + 4 * t), ad0,
             ad1);
    FragB bk0[NK], bk1[NK], bv0[NK], bv1[NK];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      load_b2_rows<SK>(ks, 8 * n, c, g, t, bk0[n], bk1[n]);
      load_b2_rows<SV>(vs, 8 * n, c, g, t, bv0[n], bv1[n]);
    }
    mma3<NK>(s, aq0, bk0);
    mma3<NK>(dp, ad0, bv0);
    mma3<NK>(s, aq1, bk1);
    mma3<NK>(dp, ad1, bv1);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ o,
                   const float* __restrict__ dout, const float* __restrict__ lse,
                   const int* __restrict__ seq_len, float* __restrict__ delta,
                   float* __restrict__ dq, int H, int T, int causal, int window) {
  constexpr int SQ = kRowStride<DH>;
  constexpr int SK = kColStride<DH>;
  constexpr int SV = kRowStride<DH>;
  constexpr int ND = DH / 8;
  constexpr int NK = kStream / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kTile * SQ;
  float* ring = dos + kTile * SQ;  // kStages x {k, v}

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int row0 = q0 + 16 * warp;
  const size_t base = size_t(bh) * T * DH;
  const int len = seq_len == nullptr ? T : min(max(seq_len[bh / H], 0), T);
  const float scale = 1.f / sqrtf(float(DH));
  const float scale_log2 = scale * kLog2e;

  int kv_end = q0 < len ? len : 0;
  if (causal) kv_end = min(kv_end, q0 + kTile);
  const int kv_first = window > 0 ? (max(0, q0 - window + 1) / kStream) * kStream : 0;

  const float* kb = k + base;
  const float* vb = v + base;
  if (kv_first < kv_end) {
    copy_tile_async<float, DH, SQ, kTile>(qs, q + base, q0, T);
    copy_tile_async<float, DH, SQ, kTile>(dos, dout + base, q0, T);
    copy_tile_async<float, DH, SK, kStream>(ring, kb, kv_first, T);
    copy_tile_async<float, DH, SV, kStream>(ring + kStream * SK, vb, kv_first, T);
  }
  cp_async_commit();

  // lse of the lanes' rows g and g + 8 in log2 units (+inf past T).
  float d_row[2] = {0.f, 0.f}, lse_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    lse_row[r] = row < T ? lse[size_t(bh) * T + row] * kLog2e : INFINITY;
  }
  const float* qw = qs + 16 * warp * SQ;
  const float* dow = dos + 16 * warp * SQ;

  // D_i = do_i . o_i of this warp's 16 rows, a row a pass of the warp;
  // the lanes keep rows g and g + 8.
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r;
    float part = 0.f;
    if (row < T) {
      for (int c = lane; c < DH; c += 32)
        part = fmaf(dout[base + size_t(row) * DH + c], o[base + size_t(row) * DH + c], part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (r == g) d_row[0] = part;
    if (r == g + 8) d_row[1] = part;
    if (lane == 0 && row < T) delta[size_t(bh) * T + row] = part;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int stage = 0;
  for (int k0 = kv_first; k0 < kv_end; k0 += kStream, stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed; every warp is done with the other stage
    const bool more = k0 + kStream < kv_end;
    if (more) {
      float* next = ring + (stage ^ 1) * kDqStage<DH>;
      copy_tile_async<float, DH, SK, kStream>(next, kb, k0 + kStream, T);
      copy_tile_async<float, DH, SV, kStream>(next + kStream * SK, vb, k0 + kStream, T);
    }
    cp_async_commit();
    const float* ks = ring + stage * kDqStage<DH>;
    const float* vs = ks + kStream * SK;

    const bool live = row0 < len && !(causal && k0 > row0 + 15) &&
                      !(window > 0 && k0 + kStream - 1 < row0 - window + 1);
    const bool whole = row0 + 15 < len && k0 + kStream <= len &&
                       (!causal || k0 + kStream - 1 <= row0) &&
                       (window <= 0 || row0 + 15 - k0 < window);
    if (live) {
      float s[NK][4], dp[NK][4];
      dq_tile_products<DH, SQ, SK, SV>(qw, dow, ks, vs, g, t, s, dp);
      // dS in place of S: row g + 8 (e / 2), key k0 + 8 n + 2 t + e % 2.
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool seen = whole || visible(row0 + g + 8 * r, k0 + 8 * n + 2 * t + (e & 1), len,
                                             causal, window);
          const float p = seen ? exp2_approx(s[n][e] * scale_log2 - lse_row[r]) : 0.f;
          s[n][e] = p * (dp[n][e] - d_row[r]);
        }
      // dq += dS . k, dS from registers.
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const FragA a = a_from_c(s[kk]);
        FragB b[ND];
#pragma unroll
        for (int c = 0; c < DH / 32; ++c) load_b4_cols<SK>(ks, 8 * kk, c, g, t, b + 4 * c);
        mma3<ND>(acc, a, b);
      }
    }
  }
  cp_async_wait<0>();

  // dq = s sum_j dS_ij k_j.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
#pragma unroll
    for (int c = 0; c < DH / 32; ++c)
      store_c4(dq + base + size_t(row) * DH, acc + 4 * c, c, r, t, scale);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ seq_len, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int T, int causal, int window) {
  constexpr int SO = kRowStride<DH>;
  constexpr int SQ = kColStride<DH>;
  constexpr int KC = DH / 16;
  constexpr int ND = DH / 8;
  constexpr int NQ = kStream / 8;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTile * SO;
  float* ring = vs + kTile * SO;  // kStages x {q, do}
  float* vec = ring + kStages * kDkdvStage<DH>;  // kStages x {lse, D}

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int key0 = k0 + 16 * warp;
  const size_t base = size_t(bh) * T * DH;
  const int len = seq_len == nullptr ? T : min(max(seq_len[bh / H], 0), T);
  const float scale = 1.f / sqrtf(float(DH));
  const float scale_log2 = scale * kLog2e;

  // The queries that may see a key of this tile: the rows below len, from
  // the tile on when causal, and at most window - 1 rows past its last key.
  const int q_begin = causal ? k0 : 0;
  const int q_end = k0 >= len ? q_begin : window > 0 ? min(len, k0 + kTile - 1 + window) : len;

  const float* qb = q + base;
  const float* dob = dout + base;
  const float* lseb = lse + size_t(bh) * T;
  const float* deltab = delta + size_t(bh) * T;
  if (q_begin < q_end) {
    copy_tile_async<float, DH, SO, kTile>(ks, k + base, k0, T);
    copy_tile_async<float, DH, SO, kTile>(vs, v + base, k0, T);
    copy_tile_async<float, DH, SQ, kStream>(ring, qb, q_begin, T);
    copy_tile_async<float, DH, SQ, kStream>(ring + kStream * SQ, dob, q_begin, T);
    copy_vec_async<kStream>(vec, lseb, q_begin, T);
    copy_vec_async<kStream>(vec + kStream, deltab, q_begin, T);
  }
  cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const float* kw = ks + 16 * warp * SO;
  const float* vw = vs + 16 * warp * SO;
  int stage = 0;
  for (int q0 = q_begin; q0 < q_end; q0 += kStream, stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this tile has landed; every warp is done with the other stage
    const bool more = q0 + kStream < q_end;
    if (more) {
      float* next = ring + (stage ^ 1) * kDkdvStage<DH>;
      float* next_vec = vec + (stage ^ 1) * 2 * kStream;
      copy_tile_async<float, DH, SQ, kStream>(next, qb, q0 + kStream, T);
      copy_tile_async<float, DH, SQ, kStream>(next + kStream * SQ, dob, q0 + kStream, T);
      copy_vec_async<kStream>(next_vec, lseb, q0 + kStream, T);
      copy_vec_async<kStream>(next_vec + kStream, deltab, q0 + kStream, T);
    }
    cp_async_commit();
    const float* qs = ring + stage * kDkdvStage<DH>;
    const float* dos = qs + kStream * SQ;
    const float* lse_s = vec + stage * 2 * kStream;
    const float* delta_s = lse_s + kStream;

    const bool live = key0 < len && !(causal && q0 + kStream - 1 < key0) &&
                      !(window > 0 && q0 > key0 + 15 + window - 1);
    const bool whole = q0 + kStream <= len && key0 + 15 < len &&
                       (!causal || key0 + 15 <= q0) &&
                       (window <= 0 || q0 + kStream - 1 - key0 < window);
    if (live) {
      // Transposed tiles: [n][e] is key key0 + g + 8 (e / 2), query
      // q0 + 8 n + 2 t + e % 2.
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        FragA ak0, ak1, av0, av1;
        split_a2(ld4(kw + g * SO + 16 * c + 4 * t), ld4(kw + (g + 8) * SO + 16 * c + 4 * t), ak0,
                 ak1);
        split_a2(ld4(vw + g * SO + 16 * c + 4 * t), ld4(vw + (g + 8) * SO + 16 * c + 4 * t), av0,
                 av1);
        FragB bq0[NQ], bq1[NQ], bd0[NQ], bd1[NQ];
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          load_b2_rows<SQ>(qs, 8 * n, c, g, t, bq0[n], bq1[n]);
          load_b2_rows<SQ>(dos, 8 * n, c, g, t, bd0[n], bd1[n]);
        }
        mma3<NQ>(st, ak0, bq0);
        mma3<NQ>(dpt, av0, bd0);
        mma3<NQ>(st, ak1, bq1);
        mma3<NQ>(dpt, av1, bd1);
      }
      // P^T in place of S^T, dS^T in place of dP^T.
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * n + 2 * t + (e & 1);
          const bool seen = whole || visible(q0 + qi, key0 + g + 8 * (e >> 1), len, causal,
                                             window);
          const float p = seen ? exp2_approx(st[n][e] * scale_log2 - lse_s[qi] * kLog2e) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - delta_s[qi]);
        }
      // dv += P^T . do and dk += dS^T . q, both from registers.
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        FragB b[ND];
        const FragA ap = a_from_c(st[kk]);
#pragma unroll
        for (int c = 0; c < DH / 32; ++c) load_b4_cols<SQ>(dos, 8 * kk, c, g, t, b + 4 * c);
        mma3<ND>(acc_v, ap, b);
        const FragA ads = a_from_c(dpt[kk]);
#pragma unroll
        for (int c = 0; c < DH / 32; ++c) load_b4_cols<SQ>(qs, 8 * kk, c, g, t, b + 4 * c);
        mma3<ND>(acc_k, ads, b);
      }
    }
  }
  cp_async_wait<0>();

  // dk = s sum_i dS_ij q_i, dv = sum_i P_ij do_i.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + 8 * r;
    if (key >= T) continue;
#pragma unroll
    for (int c = 0; c < DH / 32; ++c) {
      store_c4(dk + base + size_t(key) * DH, acc_k + 4 * c, c, r, t, scale);
      store_c4(dv + base + size_t(key) * DH, acc_v + 4 * c, c, r, t, 1.f);
    }
  }
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
// cudaStream_t) of `device`; returns a cudaError_t (0 on success). q, k, v,
// o, dout, dq, dk, dv are contiguous f32 (B, H, T, DH), lse and delta
// (scratch for D) f32 (B, H, T), seq_len int32 (B,) or null. DH is 64, 96
// or 128; B, H, T >= 1, B * H < 65536; window <= 0 means no window.
int morgana_attn_bwd(const float* q, const float* k, const float* v, const float* o,
                     const float* dout, const float* lse, const int* seq_len, float* delta,
                     float* dq, float* dk, float* dv, int B, int H, int T, int DH, int causal,
                     int window, int device, void* stream) {
  if (B < 1 || H < 1 || T < 1 || B * H > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K5_DH(D) \
  case D:        \
    return launch<D>(q, k, v, o, dout, lse, seq_len, delta, dq, dk, dv, B, H, T, causal, window, \
                     device, s);
  switch (DH) {
    K5_DH(64)
    K5_DH(96)
    K5_DH(128)
  }
#undef K5_DH
  return cudaErrorInvalidValue;
}

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
