// K5b's backward: exact softmax attention on bf16 q, k and v, backward, on
// Hopper (sm_90a), on bf16 tensor cores.
//
// Replaces the autodiff of the JAX package's exact attention on bf16 q, k
// and v (morgana_tpu/ops/attention.py:100-143 under compute_dtype bfloat16;
// the splash and flash calls cast q, k and v to bf16, nn.py:1018-1019,
// :1063-1064), the backward of K5b (attn_fwd_bf16.cu). Given bf16
// q, k, v, the forward's f32 lse and the f32 cotangent do, it writes bf16
// dq, dk, dv with JAX's roundings to bf16 (rb): with P_ij = exp(q_i . k_j *
// s - lse_i) on the visible pairs (0 elsewhere) and s = 1 / sqrt(DH),
//
//     dP_ij = rb(do_i . v_j),   D_i = sum_j P_ij dP_ij
//     dS_ij = P_ij (dP_ij - D_i)
//     dv_j = rb(sum_i rb(P_ij) do_i)
//     dq_i = rb(s sum_j dS_ij k_j),   dk_j = rb(s sum_i dS_ij q_i).
//
// D is not do . o: with dP rounded the two differ at bf16 resolution.
//
// What bounds it: 10 * P * DH flops for P visible pairs at least (the
// logits, do.v^T, and the three products dv, dq, dk), of which q.k^T (2 *
// P * DH) has two bf16 operands and the other four an f32 one (do or dS):
// one bf16 pass and three bf16 passes (attn_common.cuh) at 989 TFLOP/s,
// 0.126 ms at B32 T1024 H4 DH96 (P = 49.8 M), against 0.060 ms of bytes
// and 2 * P exp2 at the SFU rate: operations. This design does 21 bf16
// passes of 2 * P * DH flops (the D sweep recomputes S and dP, the dq sweep
// and the dk/dv kernel each recompute both), 1.6x the least.
//
// Design: FlashAttention-2's recomputation in two kernels on the same
// stream, no atomics, every product one bf16 mma.sync.m16n8k16 a plane:
// 1. attn_bwd_bf16_dq_kernel, one block of 4 warps per (b * H + h, 64-row
//    query tile), a warp 16 rows. It splits its do rows into three bf16
//    planes into shared memory and into do_planes (for step 2), keeps its q
//    rows in registers as A fragments, and sweeps the key tiles its rows see
//    twice through one cp.async ring: first for D (S = q.k^T, dP = do.v^T),
//    then for dq (S, dP again, dq += dS.k, dS split into planes in
//    registers). D is written out for step 2.
// 2. attn_bwd_bf16_dkdv_kernel, one block per (b * H + h, 64-key tile): k
//    and v in shared memory, q, the three planes of do, lse and D streamed
//    over the query tiles that see its keys: S^T = k.q^T, dP^T = v.do^T,
//    dv += rb(P^T).do, dk += dS^T.q. Key tiles wholly past len_b are
//    written as zeros without a loop; so are dq's rows past len_b.
// Every tile stays bf16 in shared memory, row stride DH + 8 (an odd number
// of 16-byte units: the eight rows of an ldmatrix fall in eight bank
// groups), streamed by cp.async through a ring of 3 stages (2 for the dk/dv
// kernel at DH 128, to keep two blocks on an SM). One copy serves both
// orientations: ldmatrix reads k (dq) and q and do (dk/dv) along their rows
// as B fragments, ldmatrix.trans down their columns for dS.k, dS^T.q and
// P^T.do. Streamed tiles are 32 rows, which keeps a warp's S and dP at
// 16 x 32 (16 registers each) beside its f32 accumulators. Shared memory at
// DH 96: 78 KB (dq) and 105 KB (dk/dv). A warp skips a streamed tile that
// none of its rows sees.

#include "attn_common.cuh"

namespace {

using namespace attn;
using bf16 = __nv_bfloat16;

constexpr int kStream = 32;  // rows of a streamed tile
constexpr int kPlanes = 3;   // hi, mid, lo of an f32 operand

template <int DH>
constexpr int kS = DH + 8;  // row stride of every tile, in bf16

constexpr int kDqStages = 3;

template <int DH>
constexpr int kDkdvStages = DH <= 96 ? 3 : 2;

// dq: the three planes of do (the block's own rows), then the ring of {k, v}.
template <int DH>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * size_t(kS<DH>) * (kPlanes * kTile + kDqStages * 2 * kStream);
}

// dk/dv: k and v (the block's own rows), the ring of {q, do's planes}, and
// the ring of {lse, D} of the streamed rows.
template <int DH>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(bf16) * size_t(kS<DH>) * (2 * kTile + kDkdvStages<DH> * (1 + kPlanes) * kStream) +
         sizeof(float) * kDkdvStages<DH> * 2 * kStream;
}

// Lane offsets (in elements of a tile of row stride S) of the ldmatrix
// reads. a_rows: the A fragment of rows r0 .. r0 + 15, columns c0 .. c0 + 15
// of a row-major tile. b_rows: the B fragments of two column tiles, B[k][n]
// = m[n][k] for n in n0 .. n0 + 15, k in c0 .. c0 + 15 (r[0], r[1] the
// first, r[2], r[3] the second). b_cols (with ldmatrix.trans): B[k][n] =
// m[k][n] for k in k0 .. k0 + 15, n in n0 .. n0 + 15, the same order.
template <int S>
__device__ __forceinline__ int a_rows(int r0, int c0, int lane) {
  return (r0 + (lane & 15)) * S + c0 + ((lane >> 4) << 3);
}

template <int S>
__device__ __forceinline__ int b_rows(int n0, int c0, int lane) {
  return (n0 + ((lane >> 4) << 3) + (lane & 7)) * S + c0 + (((lane >> 3) & 1) << 3);
}

template <int S>
__device__ __forceinline__ int b_cols(int k0, int n0, int lane) {
  return (k0 + (((lane >> 3) & 1) << 3) + (lane & 7)) * S + n0 + ((lane >> 4) << 3);
}

// The A fragments of the 16 x 16 k-step kk of a 16 x 32 product held as C
// fragments (c[2kk] and c[2kk + 1]), split into their three bf16 planes.
__device__ __forceinline__ void planes_from_c(const float (&c0)[4], const float (&c1)[4],
                                              uint32_t (&a)[kPlanes][4]) {
  split3_pack(c0[0], c0[1], a[0][0], a[1][0], a[2][0]);
  split3_pack(c0[2], c0[3], a[0][1], a[1][1], a[2][1]);
  split3_pack(c1[0], c1[1], a[0][2], a[1][2], a[2][2]);
  split3_pack(c1[2], c1[3], a[0][3], a[1][3], a[2][3]);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_bf16_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const int* __restrict__ seq_len,
                        float* __restrict__ delta, bf16* __restrict__ do_planes,
                        bf16* __restrict__ dq, int H, int T, int causal, int window,
                        long long plane) {
  constexpr int S = kS<DH>;
  constexpr int KC = DH / 16;      // k-steps over the features
  constexpr int ND = DH / 8;       // 8-column tiles of dq
  constexpr int NK = kStream / 8;  // 8-key column tiles of a streamed tile
  constexpr int STAGES = kDqStages;
  constexpr int kStage = 2 * kStream * S;
  extern __shared__ float4 smem4[];
  bf16* dos = reinterpret_cast<bf16*>(smem4);  // kPlanes x 64 rows
  bf16* ring = dos + kPlanes * kTile * S;       // STAGES x {k, v}

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int row0 = q0 + 16 * warp;
  const size_t base = size_t(bh) * T * DH;
  const int len = seq_len == nullptr ? T : min(max(seq_len[bh / H], 0), T);
  const float scale = 1.f / sqrtf(float(DH));
  const float scale_log2 = scale * kLog2e;

  // The keys any row of this tile may see, from a whole streamed tile on;
  // items 0 .. tiles - 1 of the ring are the D sweep, tiles .. 2 tiles - 1
  // the dq sweep over the same keys.
  int kv_end = q0 < len ? len : 0;
  if (causal) kv_end = min(kv_end, q0 + kTile);
  const int kv_first = window > 0 ? (max(0, q0 - window + 1) / kStream) * kStream : 0;
  const int tiles = kv_first < kv_end ? (kv_end - kv_first + kStream - 1) / kStream : 0;

  const bf16* kb = k + base;
  const bf16* vb = v + base;
  auto fetch = [&](int i) {
    if (i < 2 * tiles) {
      const int k0 = kv_first + (i < tiles ? i : i - tiles) * kStream;
      bf16* stage = ring + (i % STAGES) * kStage;
      copy_tile_async<bf16, DH, S, kStream>(stage, kb, k0, T);
      copy_tile_async<bf16, DH, S, kStream>(stage + kStream * S, vb, k0, T);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);

  // do's rows q0 .. q0 + 63 in three planes, to shared memory and (rows
  // below T) to do_planes, while the first tiles land.
  for (int idx = threadIdx.x; idx < kTile * DH / 4; idx += kThreads) {
    const int r = idx / (DH / 4), c = 4 * (idx - r * (DH / 4)), row = q0 + r;
    const float4 x = row < T ? *reinterpret_cast<const float4*>(dout + base + size_t(row) * DH + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    uint32_t p[kPlanes][2];
    split3_pack(x.x, x.y, p[0][0], p[1][0], p[2][0]);
    split3_pack(x.z, x.w, p[0][1], p[1][1], p[2][1]);
#pragma unroll
    for (int pl = 0; pl < kPlanes; ++pl) {
      const uint2 w = make_uint2(p[pl][0], p[pl][1]);
      *reinterpret_cast<uint2*>(dos + (pl * kTile + r) * S + c) = w;
      if (row < T)
        *reinterpret_cast<uint2*>(do_planes + pl * plane + base + size_t(row) * DH + c) = w;
    }
  }

  // This warp's q rows g and g + 8 as the A fragments of q.k^T (rows past T
  // zero): k-step c holds columns 16c + 2t, + 1 (a0, a1) and 16c + 8 + 2t,
  // + 1 (a2, a3).
  uint32_t qa[KC][4];
  {
    const int ra = row0 + g, rb = ra + 8;
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(q + base);
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int word = 8 * c + 4 * h + t;
        qa[c][2 * h] = ra < T ? qr[size_t(ra) * (DH / 2) + word] : 0u;
        qa[c][2 * h + 1] = rb < T ? qr[size_t(rb) * (DH / 2) + word] : 0u;
      }
  }

  // lse of the lanes' rows g and g + 8 in log2 units (+inf past T).
  float d_row[2] = {0.f, 0.f}, lse_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    lse_row[r] = row < T ? lse[size_t(bh) * T + row] * kLog2e : INFINITY;
  }
  // D of the lanes' rows, summed over the quad, and written for dk/dv (rows
  // that see no key: 0).
  auto finish_delta = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      d_row[r] = quad_sum(d_row[r]);
      const int row = row0 + g + 8 * r;
      if (t == 0 && row < T) delta[size_t(bh) * T + row] = d_row[r];
    }
  };

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < 2 * tiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // item i has landed (and do's planes); every warp is done with item i - 1
    fetch(i + STAGES - 1);
    if (i == tiles) finish_delta();
    const bool dq_sweep = i >= tiles;
    const int k0 = kv_first + (dq_sweep ? i - tiles : i) * kStream;
    const bf16* ks = ring + (i % STAGES) * kStage;
    const bf16* vs = ks + kStream * S;

    const bool live = row0 < len && !(causal && k0 > row0 + 15) &&
                      !(window > 0 && k0 + kStream - 1 < row0 - window + 1);
    const bool whole = row0 + 15 < len && k0 + kStream <= len &&
                       (!causal || k0 + kStream - 1 <= row0) &&
                       (window <= 0 || row0 + 15 - k0 < window);
    if (!live) continue;

    // S = q.k^T (one pass), dP = do.v^T (a pass a plane of do, lo first).
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t da[kPlanes][4];
#pragma unroll
      for (int pl = 0; pl < kPlanes; ++pl)
        ldmatrix_x4(da[pl], dos + pl * kTile * S + a_rows<S>(16 * warp, 16 * c, lane));
#pragma unroll
      for (int j = 0; j < NK / 2; ++j) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, ks + b_rows<S>(16 * j, 16 * c, lane));
        ldmatrix_x4(bv, vs + b_rows<S>(16 * j, 16 * c, lane));
        mma_bf16(s[2 * j], qa[c], bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], qa[c], bk[2], bk[3]);
#pragma unroll
        for (int pl = kPlanes - 1; pl >= 0; --pl) {
          mma_bf16(dp[2 * j], da[pl], bv[0], bv[1]);
          mma_bf16(dp[2 * j + 1], da[pl], bv[2], bv[3]);
        }
      }
    }

    // [n][e] is row row0 + g + 8 (e / 2), key k0 + 8 n + 2 t + e % 2.
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool seen = whole || visible(row0 + g + 8 * r, k0 + 8 * n + 2 * t + (e & 1), len,
                                           causal, window);
        const float p = seen ? exp2_approx(s[n][e] * scale_log2 - lse_row[r]) : 0.f;
        const float dpr = round_bf16(dp[n][e]);
        if (dq_sweep)
          s[n][e] = p * (dpr - d_row[r]);  // dS
        else
          d_row[r] = fmaf(p, dpr, d_row[r]);
      }
    if (!dq_sweep) continue;

    // dq += dS . k, a pass a plane of dS, k read down its columns.
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t a[kPlanes][4];
      planes_from_c(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
      for (int n = 0; n < ND / 2; ++n) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ks + b_cols<S>(16 * kk, 16 * n, lane));
#pragma unroll
        for (int pl = kPlanes - 1; pl >= 0; --pl) {
          mma_bf16(acc[2 * n], a[pl], b[0], b[1]);
          mma_bf16(acc[2 * n + 1], a[pl], b[2], b[3]);
        }
      }
    }
  }
  if (tiles == 0) finish_delta();
  cp_async_wait<0>();

  // dq = rb(s sum_j dS_ij k_j); tile n holds columns 8n + 2t, 8n + 2t + 1.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= T) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(dq + base + size_t(row) * DH);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      out[4 * n + t] = pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_bf16_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ do_planes,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ seq_len, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int H, int T, int causal, int window,
                          long long plane) {
  constexpr int S = kS<DH>;
  constexpr int KC = DH / 16;
  constexpr int ND = DH / 8;
  constexpr int NQ = kStream / 8;
  constexpr int STAGES = kDkdvStages<DH>;
  constexpr int kStage = (1 + kPlanes) * kStream * S;  // q, then do's planes
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);
  bf16* vs = ks + kTile * S;
  bf16* ring = vs + kTile * S;
  float* vec = reinterpret_cast<float*>(ring + STAGES * kStage);  // STAGES x {lse, D}

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
  const int tiles = q_begin < q_end ? (q_end - q_begin + kStream - 1) / kStream : 0;

  const bf16* qb = q + base;
  const float* lseb = lse + size_t(bh) * T;
  const float* deltab = delta + size_t(bh) * T;
  if (tiles > 0) {  // the block's own tiles, in the first group
    copy_tile_async<bf16, DH, S, kTile>(ks, k + base, k0, T);
    copy_tile_async<bf16, DH, S, kTile>(vs, v + base, k0, T);
  }
  auto fetch = [&](int i) {
    if (i < tiles) {
      const int q0 = q_begin + i * kStream;
      bf16* stage = ring + (i % STAGES) * kStage;
      float* stage_vec = vec + (i % STAGES) * 2 * kStream;
      copy_tile_async<bf16, DH, S, kStream>(stage, qb, q0, T);
#pragma unroll
      for (int pl = 0; pl < kPlanes; ++pl)
        copy_tile_async<bf16, DH, S, kStream>(stage + (1 + pl) * kStream * S,
                                              do_planes + pl * plane + base, q0, T);
      copy_vec_async<kStream>(stage_vec, lseb, q0, T);
      copy_vec_async<kStream>(stage_vec + kStream, deltab, q0, T);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    fetch(i + STAGES - 1);
    const int q0 = q_begin + i * kStream;
    const bf16* qs = ring + (i % STAGES) * kStage;
    const bf16* dos = qs + kStream * S;  // kPlanes x kStream rows
    const float* lse_s = vec + (i % STAGES) * 2 * kStream;
    const float* delta_s = lse_s + kStream;

    const bool live = key0 < len && !(causal && q0 + kStream - 1 < key0) &&
                      !(window > 0 && q0 > key0 + 15 + window - 1);
    const bool whole = q0 + kStream <= len && key0 + 15 < len &&
                       (!causal || key0 + 15 <= q0) &&
                       (window <= 0 || q0 + kStream - 1 - key0 < window);
    if (!live) continue;

    // S^T = k.q^T (one pass) and dP^T = v.do^T (a pass a plane of do):
    // [n][e] is key key0 + g + 8 (e / 2), query q0 + 8 n + 2 t + e % 2.
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, ks + a_rows<S>(16 * warp, 16 * c, lane));
      ldmatrix_x4(va, vs + a_rows<S>(16 * warp, 16 * c, lane));
#pragma unroll
      for (int j = 0; j < NQ / 2; ++j) {
        const int at = b_rows<S>(16 * j, 16 * c, lane);
        uint32_t b[4];
        ldmatrix_x4(b, qs + at);
        mma_bf16(st[2 * j], ka, b[0], b[1]);
        mma_bf16(st[2 * j + 1], ka, b[2], b[3]);
#pragma unroll
        for (int pl = kPlanes - 1; pl >= 0; --pl) {
          ldmatrix_x4(b, dos + pl * kStream * S + at);
          mma_bf16(dpt[2 * j], va, b[0], b[1]);
          mma_bf16(dpt[2 * j + 1], va, b[2], b[3]);
        }
      }
    }
    // P^T in place of S^T (rounded to bf16 as dv's A operand), dS^T in
    // place of dP^T.
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * n + 2 * t + (e & 1);
        const bool seen = whole || visible(q0 + qi, key0 + g + 8 * (e >> 1), len, causal,
                                           window);
        const float p = seen ? exp2_approx(st[n][e] * scale_log2 - lse_s[qi] * kLog2e) : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (round_bf16(dpt[n][e]) - delta_s[qi]);
      }
    // dv += rb(P^T) . do (a pass a plane of do) and dk += dS^T . q (a pass
    // a plane of dS^T), do and q read down their columns.
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      uint32_t da[kPlanes][4];
      planes_from_c(dpt[2 * kk], dpt[2 * kk + 1], da);
#pragma unroll
      for (int n = 0; n < ND / 2; ++n) {
        const int at = b_cols<S>(16 * kk, 16 * n, lane);
        uint32_t b[4];
#pragma unroll
        for (int pl = kPlanes - 1; pl >= 0; --pl) {
          ldmatrix_x4_trans(b, dos + pl * kStream * S + at);
          mma_bf16(acc_v[2 * n], pa, b[0], b[1]);
          mma_bf16(acc_v[2 * n + 1], pa, b[2], b[3]);
        }
        ldmatrix_x4_trans(b, qs + at);
#pragma unroll
        for (int pl = kPlanes - 1; pl >= 0; --pl) {
          mma_bf16(acc_k[2 * n], da[pl], b[0], b[1]);
          mma_bf16(acc_k[2 * n + 1], da[pl], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // dk = rb(s sum_i dS_ij q_i), dv = rb(sum_i rb(P_ij) do_i).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + 8 * r;
    if (key >= T) continue;
    uint32_t* out_k = reinterpret_cast<uint32_t*>(dk + base + size_t(key) * DH);
    uint32_t* out_v = reinterpret_cast<uint32_t*>(dv + base + size_t(key) * DH);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      out_k[4 * n + t] = pack_bf16(acc_k[n][2 * r] * scale, acc_k[n][2 * r + 1] * scale);
      out_v[4 * n + t] = pack_bf16(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

template <int DH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const float* dout,
                   const float* lse, const int* seq_len, float* delta, bf16* do_planes,
                   bf16* dq, bf16* dk, bf16* dv, int B, int H, int T, int causal, int window,
                   int device, cudaStream_t stream) {
  cudaError_t err = set_smem(attn_bwd_bf16_dq_kernel<DH>, dq_smem_bytes<DH>(), device);
  if (err != cudaSuccess) return err;
  err = set_smem(attn_bwd_bf16_dkdv_kernel<DH>, dkdv_smem_bytes<DH>(), device);
  if (err != cudaSuccess) return err;
  const long long plane = (long long)B * H * T * DH;
  const dim3 grid((T + kTile - 1) / kTile, B * H);
  attn_bwd_bf16_dq_kernel<DH><<<grid, kThreads, dq_smem_bytes<DH>(), stream>>>(
      q, k, v, dout, lse, seq_len, delta, do_planes, dq, H, T, causal, window, plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_bf16_dkdv_kernel<DH><<<grid, kThreads, dkdv_smem_bytes<DH>(), stream>>>(
      q, k, v, do_planes, lse, delta, seq_len, dk, dv, H, T, causal, window, plane);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K5b's backward (two kernels, in order) on `stream` (a
// cudaStream_t) of `device`; returns a cudaError_t (0 on success). q, k, v,
// dq, dk, dv are contiguous bf16 (B, H, T, DH), dout f32 (B, H, T, DH), lse
// and delta (scratch for D) f32 (B, H, T), do_planes bf16 scratch (3, B, H,
// T, DH), seq_len int32 (B,) or null. DH is 64, 96 or 128; B, H, T >= 1,
// B * H < 65536; window <= 0 means no window.
int morgana_attn_bwd_bf16(const void* q, const void* k, const void* v, const float* dout,
                          const float* lse, const int* seq_len, float* delta, void* do_planes,
                          void* dq, void* dk, void* dv, int B, int H, int T, int DH, int causal,
                          int window, int device, void* stream) {
  if (B < 1 || H < 1 || T < 1 || B * H > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K5B_DH(D)                                                                               \
  case D:                                                                                      \
    return launch<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),                 \
                     static_cast<const bf16*>(v), dout, lse, seq_len, delta,                   \
                     static_cast<bf16*>(do_planes), static_cast<bf16*>(dq),                    \
                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, H, T, causal, window, \
                     device, s);
  switch (DH) {
    K5B_DH(64)
    K5B_DH(96)
    K5B_DH(128)
  }
#undef K5B_DH
  return cudaErrorInvalidValue;
}

const char* morgana_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
