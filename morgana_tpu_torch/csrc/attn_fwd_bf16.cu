// K5b: exact softmax attention forward on bf16 q, k and v, on Hopper
// (sm_90a): wgmma products fed by a TMA producer through an mbarrier ring.
//
// Replaces the two TPU attention kernels of morgana_tpu/nn.py's
// MultiHeadAttention on bf16 operands: _splash (nn.py:1001, bf16 q, k, v at
// :1018-1019) and _flash (nn.py:1055, :1063-1064). For q, k, v (B, H, T, DH)
// bf16 it computes, as K5 does in f32 (attn_fwd.cu),
//
//     o_i = sum_j softmax_j(q_i . k_j / sqrt(DH)) v_j   over the keys j that
//     query i sees (attn::visible: i, j < len_b; with `causal` j <= i; with
//     `window` W > 0 also i - j < W),
//
// and lse_i, the log-sum-exp of row i's scaled logits, in f32; a row that
// sees no key is written as o = 0, lse = +inf. Numerics of the plain path
// (ops/attention.py, scaled_dot_product_attention with compute_dtype bf16):
// bf16 products with f32 sums; the online softmax's running max and sum in
// f32; its unnormalised probabilities rounded to bf16 as p.v's A operand
// (the plain path rounds the normalised ones: an independent rounding of
// the same size); o in f32.
//
// What bounds it. At the Transformer's serving batch (B16 H4 T1024 DH 96,
// P = 31.8 M visible pairs) 4 * P * DH flops at 989 TFLOP/s take 0.012 ms,
// the bytes of bf16 q, k, v and f32 o and lse 0.019 ms at 3.35 TB/s: it is
// bound by bytes, and the products must stay well below them.
//
// Design. A block owns a 128-row query tile of one (b, h): three
// warpgroups, two consumers of 64 rows each and a producer, whose one
// thread keeps K and V tiles of 128 keys in flight by TMA (3-D tensor maps
// over (B * H, T, DH), so rows past T read as zeros within a head) through
// a ring of kRing stages, each with a `full` mbarrier (the TMA's bytes) and
// an `empty` one (one arrival a consumer warp); q is loaded once. The
// producer gives its registers to the consumers (setmaxnreg). There is no
// block barrier in the key loop. Each consumer warpgroup runs S = q.k^T as
// wgmma m64n128k16 (q and k K-major in shared memory) and O += P.V as
// wgmma m64nNk16 with P from registers (S's C fragments, rounded to bf16)
// and V read MN-major as it lies (16-bit wgmma's transpose bit). The two
// consumers take turns to issue their products (named barriers), so that
// one's softmax runs while the other's products are on the tensor cores;
// within a consumer, S of tile j is issued with P.V of tile j - 1 behind it
// (o rescaled in between) and the softmax of tile j starts once S is in
// (wgmma_wait<1>). The compiler places its exponentials after the wait for
// P.V (wgmma_wait<0>): a build that kept them before it, P double-buffered,
// was 4-7% slower (PERF.md). The softmax is one fused multiply-add and one
// SFU exp2 an element, with four partial maxima and sums a row, and masks
// by each row's interval of visible keys.
//
// DH 96 (a 192-byte row, past one 128-byte swizzle atom): every tile is two
// 64-column slabs, the second read by TMA at column 64 with its columns
// 96-127 filled with zeros. q.k^T takes 6 k-steps (the zero columns are not
// read), P.V accumulates 128 columns of which 96 are written: a third more
// tensor work in P.V. The other split, a 32-column second slab with 64-byte
// swizzle, an n32 P.V and a fourth stage in the smem it saves, gave the
// same bits and ran 1.10-1.25x slower (ptxas serialised its wgmma: C7520),
// so it is not kept (PERF.md).
// tests/test_torch_bf16_attention_design.py emulates this order of
// operations on the CPU.
//
// Order of work. The grid is 1-D with the query tile as the slow index,
// the last tile first, so the longest blocks (causal: the last tiles) of
// every (b, h) start in the first wave. (Persistent blocks walking the same
// order, by a fixed stride or an atomic counter, measured 0-7% faster with
// the counter and slower with the stride; not kept.) Key tiles wholly past len_b or
// outside the causal / window band are not loaded; a consumer waits for
// and releases the tiles of the block that none of its rows sees without
// computing them; the mask is applied only on tiles that cross the band or
// len_b. A block whose rows all lie past len_b writes its zeros and ends.

#include <cuda.h>
#include <dlfcn.h>

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

using attn::kLn2;
using attn::kLog2e;

constexpr int kRows = 128;       // query rows a block
constexpr int kKeys = 128;       // keys a streamed tile
constexpr int kRing = 3;         // stages of the K/V ring
constexpr int kConsumers = 2;    // consumer warpgroups of 64 rows
constexpr int kBlockThreads = 128 * (kConsumers + 1);
constexpr int kSlab = 128 * 128;  // bytes of a 64-column slab of 128 rows

template <int DH>
struct Layout {
  static constexpr int kSlabs = (DH + 63) / 64;   // 64-column slabs a tile
  static constexpr int kSteps = DH / 16;          // k-steps of q.k^T
  static constexpr int kCols = 64 * kSlabs;       // columns of o accumulated
  static constexpr int kTile = kSlabs * kSlab;    // bytes of a q, k or v tile
  static constexpr int kStage = 2 * kTile;        // k then v
  // The 1024-byte alignment slack, q, the ring, then 1 + 2 * kRing barriers.
  static constexpr size_t kSmem = 1024 + kTile + size_t(kRing) * kStage + 8 * (1 + 2 * kRing);
};

// q.k^T of one tile into s (this warpgroup's 64 rows x 128 keys).
template <int DH>
__device__ __forceinline__ void logits(float (&s)[64], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int ks = 0; ks < Layout<DH>::kSteps; ++ks) {
    const uint32_t off = (ks / 4) * kSlab + (ks % 4) * 32;
    hopper::wgmma_ss(s, hopper::desc_sw128(q_addr + off, 16, 1024),
                     hopper::desc_sw128(k_addr + off, 16, 1024), ks > 0);
  }
}

// acc += p . v of one tile, p the bf16 A fragments of 8 k-steps of 16 keys.
template <int DH>
__device__ __forceinline__ void values(float (&acc)[Layout<DH>::kCols / 2],
                                       const uint32_t (&p)[32], uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    hopper::wgmma_rs_mn(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                        hopper::desc_sw128(v_addr + kk * 16 * 128, kSlab, 1024));
}

// The online softmax of one tile in place: s (rows row0 and row0 + 8 of
// this thread, keys k0 + 8 n + 2 t + e % 2 at s[4 n + e]) masked unless
// `whole` (two loops: one branch a tile), and replaced by p = 2^(s *
// scale_log2 - m), one fused multiply-add and one SFU op an element; m (log2
// units) and l updated; alpha[r] the factor of row r's sums so far. Row r
// sees the keys [lo[r], hi[r]) (attn::visible as an interval).
__device__ __forceinline__ void softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], bool whole, const int (&lo)[2],
                                        const int (&hi)[2], int k0, int t, float scale_log2) {
  // Four partial maxima and sums a row (8-column tiles n % 4), so that the
  // chains of dependent operations are 16 long, not 64.
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[r][c] = -INFINITY;
  if (whole) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float& x = mx[(i >> 1) & 1][(i >> 2) & 3];
      x = fmaxf(x, s[i]);
    }
  } else {
    // Key k0 + 2 t + c, c = 8 (i >> 2) + (i & 1), is seen when it lies in
    // [lo, hi): (key - lo) as unsigned below hi - lo.
    const int from[2] = {k0 + 2 * t - lo[0], k0 + 2 * t - lo[1]};
    const unsigned span[2] = {unsigned(max(hi[0] - lo[0], 0)), unsigned(max(hi[1] - lo[1], 0))};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = unsigned(from[r] + 8 * (i >> 2) + (i & 1)) < span[r] ? s[i] : -INFINITY;
      float& x = mx[r][(i >> 2) & 3];
      x = fmaxf(x, s[i]);
    }
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float row_max = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    const float m_new = fmaxf(m[r], attn::quad_max(row_max) * scale_log2);
    // While a row has seen no key, subtract 0: exp2(-inf) is 0, and
    // -inf - -inf must not run.
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = attn::exp2_approx(m[r] - m_use[r]);
    m[r] = m_new;
  }
  float sum[2][4] = {};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = attn::exp2_approx(fmaf(s[i], scale_log2, -m_use[r]));
    sum[r][(i >> 2) & 3] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

// s's probabilities as the A fragments of p.v: k-step kk takes key columns
// 16 kk .. + 15, the C fragments of 8-column tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = attn::pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int DH>
__global__ void __launch_bounds__(kBlockThreads, 1)
attn_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const int* __restrict__ seq_len,
                     float* __restrict__ o, float* __restrict__ lse, int BH, int H, int T,
                     int causal, int window) {
  using L = Layout<DH>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* ring = smem + L::kTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kRing * L::kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kRing;

  // The query tile is the slow index of the grid, the last first, so that
  // the longest blocks of every (b, h) (causal: the last tiles) start first.
  const int n_q = (T + kRows - 1) / kRows;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_q - 1 - blockIdx.x / BH) * kRows;
  const int len = seq_len == nullptr ? T : min(max(seq_len[bh / H], 0), T);
  const size_t base = size_t(bh) * T;

  if (q0 >= len) {  // no row of this tile sees a key
    const int rows = min(kRows, T - q0);
    float4* out = reinterpret_cast<float4*>(o + (base + q0) * DH);
    for (int i = threadIdx.x; i < rows * DH / 4; i += kBlockThreads)
      out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = threadIdx.x; i < rows; i += kBlockThreads) lse[base + q0 + i] = INFINITY;
    return;
  }
  // The block's key tiles: from kv_first on, n_kv of them.
  const int kv_end = causal ? min(len, q0 + kRows) : len;
  const int kv_first = window > 0 ? (max(0, q0 - window + 1) / kKeys) * kKeys : 0;
  const int n_kv = (kv_end - kv_first + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < kRing; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, 4 * kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // The producer: one thread loads q, then each key tile once its stage
    // is free.
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * kConsumers) {
      hopper::tma_prefetch(&tk);
      hopper::tma_prefetch(&tv);
      hopper::mbar_arrive_tx(q_full, L::kTile);
#pragma unroll
      for (int c = 0; c < L::kSlabs; ++c)
        hopper::tma_load_3d(q_s + c * kSlab, &tq, q_full, 64 * c, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kRing;
        hopper::mbar_wait(empty + st, ((j / kRing) & 1) ^ 1);
        hopper::mbar_arrive_tx(full + st, L::kStage);
        uint8_t* ks = ring + st * L::kStage;
        const int k0 = kv_first + j * kKeys;
#pragma unroll
        for (int c = 0; c < L::kSlabs; ++c) {
          hopper::tma_load_3d(ks + c * kSlab, &tk, full + st, 64 * c, k0, bh);
          hopper::tma_load_3d(ks + L::kTile + c * kSlab, &tv, full + st, 64 * c, k0, bh);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows r_lo .. r_lo + 63; this thread's rows row0
  // and row0 + 8.
  hopper::setmaxnreg_inc<232>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r_lo = q0 + 64 * wg;
  const int row0 = r_lo + 16 * warp + g;
  const float scale_log2 = kLog2e / sqrtf(float(DH));
  const uint32_t q_addr = hopper::smem_u32(q_s) + 64 * 128 * wg;
  const uint32_t ring_addr = hopper::smem_u32(ring);

  // The block's key tiles [first, end) that a row of this warpgroup sees.
  int first = 0, end = 0;
  if (r_lo < len) {
    const int key_end = causal ? min(len, r_lo + 64) : len;
    const int key_first = window > 0 ? max(0, r_lo - window + 1) : 0;
    first = (key_first - kv_first) / kKeys;
    end = (key_end - kv_first + kKeys - 1) / kKeys;
  }

  // The keys [lo[r], hi[r]) that this thread's row row0 + 8 r sees.
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lo[r] = window > 0 ? max(0, row - window + 1) : 0;
    hi[r] = row < len ? (causal ? row + 1 : len) : 0;
  }

  float acc[L::kCols / 2];
#pragma unroll
  for (int i = 0; i < L::kCols / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float s[64];
  uint32_t p[32];

  auto wait_full = [&](int j) { hopper::mbar_wait(full + j % kRing, (j / kRing) & 1); };
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + j % kRing);
  };
  // Whether every row of this warpgroup sees every key of tile j.
  auto whole = [&](int j) {
    const int k0 = kv_first + j * kKeys;
    return r_lo + 63 < len && k0 + kKeys <= len && (!causal || k0 + kKeys - 1 <= r_lo) &&
           (window <= 0 || r_lo + 63 - k0 < window);
  };
  auto k_addr = [&](int j) { return ring_addr + (j % kRing) * L::kStage; };
  // o's sums to the running max of the last softmax, before p.v adds to them.
  auto rescale = [&]() {
#pragma unroll
    for (int i = 0; i < L::kCols / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  };

  // The two warpgroups take turns to issue their products (named barriers
  // 1 and 2, warpgroup 0 first), so that one's softmax runs beside the
  // other's products: n_kv + 1 turns each, one a key tile and one more
  // (warpgroup 1 passes its last turn to no one).
  // Tiles outside [first, end) are waited for and released in a turn of
  // their own; tile first issues q.k^T alone, each later tile q.k^T, then
  // (o rescaled meanwhile) p.v of the tile before it, and one last turn p.v
  // of tile end - 1. The softmax of a tile runs while p.v of the tile
  // before it is still on the tensor cores (wgmma_wait<1>); a tile is
  // released once its p.v is done.
  int turns = 0;
  auto take_turn = [&]() { hopper::bar_sync(1 + wg, 256); };
  auto pass_turn = [&]() {
    if (wg == 0 || ++turns <= n_kv) hopper::bar_arrive(2 - wg, 256);
  };
  auto skip = [&](int j) {
    wait_full(j);
    take_turn();
    pass_turn();
    release(j);
  };
  if (wg == 1) hopper::bar_arrive(1, 256);
  int j = 0;
  for (; j < first; ++j) skip(j);
  if (first < end) {
    hopper::mbar_wait(q_full, 0);
    wait_full(j);
    take_turn();
    hopper::wgmma_fence();
    logits<DH>(s, q_addr, k_addr(j));
    hopper::wgmma_commit();
    pass_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    softmax(s, m, l, alpha, whole(j), lo, hi, kv_first + j * kKeys, t, scale_log2);
    pack(p, s);
    for (++j; j < end; ++j) {
      wait_full(j);
      take_turn();
      hopper::wgmma_fence();
      logits<DH>(s, q_addr, k_addr(j));
      hopper::wgmma_commit();
      rescale();  // while q.k^T runs
      hopper::wgmma_fence();
      values<DH>(acc, p, k_addr(j - 1) + L::kTile);
      hopper::wgmma_commit();
      pass_turn();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);
      softmax(s, m, l, alpha, whole(j), lo, hi, kv_first + j * kKeys, t, scale_log2);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(p);
      release(j - 1);
      pack(p, s);
    }
    take_turn();
    rescale();
    hopper::wgmma_fence();
    values<DH>(acc, p, k_addr(j - 1) + L::kTile);
    hopper::wgmma_commit();
    pass_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    release(j - 1);
  } else {
    take_turn();  // the turn of p.v after the last tile
    pass_turn();
  }
  for (; j < n_kv; ++j) skip(j);

  float sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) sum[r] = attn::quad_sum(l[r]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
    const float inv = sum[r] > 0.f ? 1.f / sum[r] : 0.f;
    float* out = o + (base + row) * DH;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n + 2 * t) =
          make_float2(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
    if (t == 0) lse[base + row] = sum[r] > 0.f ? (m[r] + log2f(sum[r])) * kLn2 : INFINITY;
  }
}

// cuTensorMapEncodeTiled from the driver (libcuda), which this library is
// not linked against; null when it cannot be found.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// The tensor map of a contiguous bf16 (B * H, T, DH) tensor: boxes of 64
// columns x 128 rows of one (b, h), 128-byte swizzled, zeros past its edges.
cudaError_t tile_map(CUtensorMap* map, const void* base, int BH, int T, int DH) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {cuuint64_t(DH), cuuint64_t(T), cuuint64_t(BH)};
  const cuuint64_t strides[2] = {cuuint64_t(DH) * 2, cuuint64_t(T) * DH * 2};
  const cuuint32_t box[3] = {64, kRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seq_len, float* o,
                   float* lse, int B, int H, int T, int causal, int window, int device,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = tile_map(&tq, q, B * H, T, DH);
  if (err == cudaSuccess) err = tile_map(&tk, k, B * H, T, DH);
  if (err == cudaSuccess) err = tile_map(&tv, v, B * H, T, DH);
  if (err != cudaSuccess) return err;
  const size_t smem = Layout<DH>::kSmem;
  err = attn::set_smem(attn_fwd_bf16_kernel<DH>, smem, device);
  if (err != cudaSuccess) return err;
  const int blocks = (T + kRows - 1) / kRows * B * H;
  attn_fwd_bf16_kernel<DH><<<blocks, kBlockThreads, smem, stream>>>(
      tq, tk, tv, seq_len, o, lse, B * H, H, T, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K5b's forward on `stream` (a cudaStream_t) of `device`; returns a
// cudaError_t (0 on success). q, k, v are contiguous bf16 (B, H, T, DH),
// 16-byte aligned; o is f32 (B, H, T, DH), lse f32 (B, H, T), seq_len int32
// (B,) or null. DH is 64, 96 or 128; B, H, T >= 1, B * H < 65536; window <= 0
// means no window.
int morgana_attn_fwd_bf16(const void* q, const void* k, const void* v, const int* seq_len,
                          float* o, float* lse, int B, int H, int T, int DH, int causal,
                          int window, int device, void* stream) {
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
