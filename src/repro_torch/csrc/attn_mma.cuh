// Tensor-core tiles shared by the two prefill attention kernels
// (flash_attention.cu and flash_attention_paged.cu, bf16 q): one warp holds
// 16 query rows as bf16 A fragments and folds 64-key K/V tiles, bf16 in
// shared memory, into an f32 online softmax kept in mma accumulators; a
// block of four warps takes one 128-key split of a row tile, and the splits
// of a row tile are merged in split order (`merge_splits`).
//
// Numerics, the same in both kernels, so that a row computed by either
// kernel from the same q and K/V values is the same bit for bit:
// - q·kᵀ is an mma.sync m16n8k16 bf16 product with f32 accumulators, then
//   × the softmax scale. K and V reach the tiles as bf16: f32 rows rounded
//   to nearest, int8 rows as bf16(q · s), the rounding the models'
//   `dequantize_kv_rows(..., bf16)` applies to the rows a dense prefill
//   attends.
// - A masked key's score is NEG_INF (-1e30, finite) and its p exactly 0;
//   a row with no valid key so far keeps m = NEG_INF, l = 0, acc = 0.
// - Scores are kept in base 2: the scale carries log2(e), and
//   p = 2^(s - m_new) by ex2.approx (relative error 2^-22, far below the
//   bf16 rounding p takes next), a quarter of the instructions of expf.
//   m_new == m gives corr = 1 exactly, by a select, whatever ex2 does.
// - l sums the f32 p. p is rounded to bf16 and becomes the A fragment of
//   the p·V mma straight from the S accumulators' registers, as the TPU
//   kernel rounds p to v's type (repro/kernels/flash_attention.py:86).
// - Row max and row sum: each thread's 16 values of a row in key order,
//   then __shfl_xor 1 and 2 within the quad (a + b == b + a, so the four
//   lanes agree). The order depends on the key's place in the tile only,
//   never on the row's place in the warp, so a row's result does not
//   depend on which other rows share its tile.
// - A tile in which a row has no valid key leaves its state as it was,
//   bit for bit (corr = 1, p = 0), so a row's sums depend only on
//   the tiles that hold its own keys. Tiles (MT_KEYS) and splits
//   (MT_SPLIT) lie at absolute key positions.
// - Splits: each starts from a fresh state and folds its two tiles in
//   order; the merge takes m = the max over the row tile's live splits,
//   then l and acc as explicit fused multiply-adds in split order.
//
// Fragment layout (PTX ISA, mma.m16n8k16): lane = 4·g + t; accumulator j
// holds rows g (c0, c1) and g + 8 (c2, c3), columns 8j + 2t and 8j + 2t + 1.
#pragma once

#include <type_traits>

#include "attn_common.cuh"
#include "hopper.cuh"

namespace repro {

constexpr int MT_KEYS = 64;      // keys per K/V tile
constexpr int MT_ROWS = 16;      // query rows per warp
constexpr int MT_SPLIT = 2 * MT_KEYS;          // keys per split
constexpr int MT_WARPS = 4;                    // warps of a split block
constexpr int MT_BLOCK_ROWS = MT_WARPS * MT_ROWS;   // rows of a row tile
constexpr unsigned MT_FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;   // scores × this: base 2

// 2^x, one MUFU.EX2; x far below -126 gives 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the online-softmax rescale 2^(m - m_new), exactly 1 when m is unchanged
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m == m_new ? 1.f : ex2(__fsub_rn(m, m_new));
}

// The online-softmax state of a warp's 16 rows: this thread's accumulator
// fragments of the (16, D) output and m, l of its rows g and g + 8.
template <int D>
struct MmaRows {
  float o[D / 8][4];
  float m[2];
  float l[2];
};

template <int D>
__device__ __forceinline__ void init_rows(MmaRows<D>& st) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[n][e] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.m[h] = NEG_INF;
    st.l[h] = 0.f;
  }
}

// A fragments of 16 bf16 rows of D values in shared memory (row stride ld)
template <int D>
__device__ __forceinline__ void load_q_frags(unsigned (&qa)[D / 16][4],
                                             const __nv_bfloat16* qs, int ld, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qa[kk], qs + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: the low half
  return *reinterpret_cast<const unsigned*>(&v);
}

// Fold one tile of MT_KEYS keys into a warp's rows. qf(kk, a): the A
// fragment of Q's columns 16kk .. 16kk + 15 (DK of them: from registers, or
// from shared memory for wide rows); kt: the tile's K rows, DK bf16 each,
// row stride kld; vt: the first of the DO value columns this warp
// accumulates, row stride vld. Row h of this thread (0: g, 1: g + 8) takes
// tile key c iff lo[h] <= c < hi[h]; MASK = false: every key counts for
// every row. Every score is × scale (the softmax scale × LOG2E).
template <int DK, int DO, bool MASK, typename QF>
__device__ __forceinline__ void fold_tile_mma(MmaRows<DO>& st, QF qf,
                                              const __nv_bfloat16* kt, int kld,
                                              const __nv_bfloat16* vt, int vld,
                                              const int (&lo)[2], const int (&hi)[2],
                                              float scale, int lane) {
  constexpr int NJ = MT_KEYS / 8;
  const int t = lane & 3;
  float s[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // S = Q·Kᵀ: one ldmatrix_x4 gives the B fragments of 16 keys x 16 dims
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    unsigned qa[4];
    qf(kk, qa);
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      unsigned r[4];
      ldmatrix_x4(r, kt + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kld + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_bf16_16816(s[2 * jj], qa, b0);
      mma_bf16_16816(s[2 * jj + 1], qa, b1);
    }
  }
  auto valid = [&](int h, int c) { return !MASK || (c >= lo[h] && c < hi[h]); };
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, c = 8 * j + 2 * t + (e & 1);
      // explicit roundings: no FMA contraction that could differ between
      // the masked and unmasked instances of this function
      const float v = __fmul_rn(s[j][e], scale);
      s[j][e] = valid(h, c) ? v : NEG_INF;
      mx[h] = fmaxf(mx[h], s[j][e]);
    }
  float mn[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(MT_FULL, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(MT_FULL, mx[h], 2));
    mn[h] = fmaxf(st.m[h], mx[h]);
    corr[h] = rescale(st.m[h], mn[h]);
  }
  // p, and P as the A fragments of the p·V product (keys 16kk .. 16kk + 15)
  unsigned pa[NJ / 2][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, c = 8 * j + 2 * t + (e & 1);
      // masked keys contribute exactly 0 (with m == NEG_INF, 2^(s - m) is 1)
      p[e] = valid(h, c) ? ex2(__fsub_rn(s[j][e], mn[h])) : 0.f;
      rs[h] += p[e];
    }
    pa[j >> 1][(j & 1) * 2] = pack_bf16x2(p[0], p[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] += __shfl_xor_sync(MT_FULL, rs[h], 1);
    rs[h] += __shfl_xor_sync(MT_FULL, rs[h], 2);
    st.l[h] = __fadd_rn(__fmul_rn(st.l[h], corr[h]), rs[h]);
    st.m[h] = mn[h];
  }
#pragma unroll
  for (int n = 0; n < DO / 8; ++n) {
    st.o[n][0] *= corr[0];
    st.o[n][1] *= corr[0];
    st.o[n][2] *= corr[1];
    st.o[n][3] *= corr[1];
  }
  // O += P·V: ldmatrix.trans gives the B fragments of 16 keys x 16 dims
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
#pragma unroll
    for (int nn = 0; nn < DO / 16; ++nn) {
      unsigned r[4];
      ldmatrix_x4_trans(r, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * vld +
                               nn * 16 + (lane >> 4) * 8);
      const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_bf16_16816(st.o[2 * nn], pa[kk], b0);
      mma_bf16_16816(st.o[2 * nn + 1], pa[kk], b1);
    }
  }
}

// Whether a warp takes part in a tile, and whether its mask can be left out:
// `lo`/`hi` are this thread's rows' key ranges relative to the tile.
__device__ __forceinline__ bool warp_tile_live(const int (&lo)[2], const int (&hi)[2]) {
  const bool mine = (lo[0] < hi[0] && lo[0] < MT_KEYS && hi[0] > 0) ||
                    (lo[1] < hi[1] && lo[1] < MT_KEYS && hi[1] > 0);
  return __any_sync(MT_FULL, mine);
}

__device__ __forceinline__ bool warp_tile_full(const int (&lo)[2], const int (&hi)[2]) {
  const bool mine = lo[0] <= 0 && hi[0] >= MT_KEYS && lo[1] <= 0 && hi[1] >= MT_KEYS;
  return __all_sync(MT_FULL, mine);
}

// Q's A fragments held in registers (D <= 128: the narrow rows)
template <int D>
struct QRegs {
  const unsigned (&qa)[D / 16][4];
  __device__ __forceinline__ void operator()(int kk, unsigned (&a)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qa[kk][i];
  }
};

// Q's A fragments read from shared memory at each use (wide rows: DK / 16
// fragments of four registers would not fit beside the accumulators)
struct QShared {
  const __nv_bfloat16* qs;     // the warp's 16 rows
  int ld;
  int lane;
  __device__ __forceinline__ void operator()(int kk, unsigned (&a)[4]) const {
    ldmatrix_x4(a, qs + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
  }
};

template <int DK, int DO, typename QF>
__device__ __forceinline__ void fold_tile_any(MmaRows<DO>& st, QF qf, const __nv_bfloat16* kt,
                                              int kld, const __nv_bfloat16* vt, int vld,
                                              const int (&lo)[2], const int (&hi)[2],
                                              float scale, int lane) {
  if (!warp_tile_live(lo, hi)) return;               // no row of the warp sees it
  if (warp_tile_full(lo, hi))                        // inside every row's range
    fold_tile_mma<DK, DO, false>(st, qf, kt, kld, vt, vld, lo, hi, scale, lane);
  else                                               // crosses an edge: masked
    fold_tile_mma<DK, DO, true>(st, qf, kt, kld, vt, vld, lo, hi, scale, lane);
}

template <int D>
__device__ __forceinline__ void fold_tile_auto(MmaRows<D>& st, const unsigned (&qa)[D / 16][4],
                                               const __nv_bfloat16* kt,
                                               const __nv_bfloat16* vt, int ld,
                                               const int (&lo)[2], const int (&hi)[2],
                                               float scale, int lane) {
  fold_tile_any<D, D>(st, QRegs<D>{qa}, kt, ld, vt, ld, lo, hi, scale, lane);
}

// ------------------------------------------------------------ split merge
// A split block's four warps hold MT_BLOCK_ROWS rows of a row tile; row r
// of the tile is row r % 16 of warp r / 16. `out_row(r)` is the bf16
// output row (D values) of tile row r; rows at or past `rn` are not real.

// One live split: the block writes o / max(l, 1e-30) itself.
template <int D, typename OutRow>
__device__ __forceinline__ void write_rows(const MmaRows<D>& st, OutRow out_row, int rn,
                                           int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = warp * MT_ROWS + g + 8 * h;
    if (rl >= rn) continue;
    const float l = fmaxf(st.l[h], 1e-30f);
    __nv_bfloat16* o = out_row(rl) + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<unsigned*>(o + 8 * n) =
          pack_bf16x2(st.o[n][2 * h] / l, st.o[n][2 * h + 1] / l);
  }
}

// Several live splits: each block stores its rows' state, acc_t as
// [split][row][D] and ml_t as [split][row] (m, l), for `merge_splits`.
template <int D>
__device__ __forceinline__ void store_split(const MmaRows<D>& st, float* acc_t, float2* ml_t,
                                            int split, int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = warp * MT_ROWS + g + 8 * h;
    if (t4 == 0) ml_t[(size_t)split * MT_BLOCK_ROWS + rl] = make_float2(st.m[h], st.l[h]);
    float* rec = acc_t + ((size_t)split * MT_BLOCK_ROWS + rl) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(rec + 8 * n) = make_float2(st.o[n][2 * h], st.o[n][2 * h + 1]);
  }
}

// The last block of a row tile merges its live splits [s_lo, s_hi) in
// split order: thread t takes half of row t / 2, all its loads of a split
// in flight together. A split that holds no key of a row adds exact zeros.
template <int D, typename OutRow>
__device__ __forceinline__ void merge_splits(const float* acc_t, const float2* ml_t, int s_lo,
                                             int s_hi, int rn, OutRow out_row, int tid) {
  static_assert(MT_BLOCK_ROWS * 2 == MT_WARPS * 32, "two threads a row");
  const int rl = tid >> 1, c0 = (tid & 1) * (D / 2);
  if (rl >= rn) return;
  float m = NEG_INF;
#pragma unroll 4
  for (int sp = s_lo; sp < s_hi; ++sp)
    m = fmaxf(m, __ldcg(&ml_t[(size_t)sp * MT_BLOCK_ROWS + rl].x));
  float l = 0.f;
  float4 acc[D / 8];
#pragma unroll
  for (int u = 0; u < D / 8; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = s_lo; sp < s_hi; ++sp) {
    const float2 ml = __ldcg(&ml_t[(size_t)sp * MT_BLOCK_ROWS + rl]);
    const float4* src =
        reinterpret_cast<const float4*>(acc_t + ((size_t)sp * MT_BLOCK_ROWS + rl) * D + c0);
    float4 v[D / 8];
#pragma unroll
    for (int u = 0; u < D / 8; ++u) v[u] = __ldcg(src + u);
    const float f = rescale(ml.x, m);
    l = __fmaf_rn(ml.y, f, l);
#pragma unroll
    for (int u = 0; u < D / 8; ++u) {
      acc[u].x = __fmaf_rn(v[u].x, f, acc[u].x);
      acc[u].y = __fmaf_rn(v[u].y, f, acc[u].y);
      acc[u].z = __fmaf_rn(v[u].z, f, acc[u].z);
      acc[u].w = __fmaf_rn(v[u].w, f, acc[u].w);
    }
  }
  l = fmaxf(l, 1e-30f);
  __nv_bfloat16* o = out_row(rl) + c0;
#pragma unroll
  for (int u = 0; u < D / 8; ++u)
    *reinterpret_cast<uint2*>(o + 4 * u) =
        make_uint2(pack_bf16x2(acc[u].x / l, acc[u].y / l),
                   pack_bf16x2(acc[u].z / l, acc[u].w / l));
}


// ------------------------------------------------------------- wide rows
// Rows wider than 128 (head_dim 160-256) or MLA latent rows (keys DK = 576
// wide, values their first DV = 512 columns, one pool read as both): a
// warp's Q fragments (DK / 16 x 4 registers) and a (16, DV) accumulator
// would not fit its registers. A wide block has eight warps over its
// 64-row tile. Warps w and w + 4 (pair w) own the same 16 rows, whose Q
// stays in shared memory (`QShared`). In every 64-key tile warp w + 4·hf
// scores keys 32·hf .. 32·hf + 31 against the pair's rows, so each (row,
// key) score is computed once a launch. The pair posts its row maxima,
// then its row sums, to shared memory behind a named barrier of its 64
// threads, and each warp writes its half of P there as bf16. Both warps
// then take m as fmaxf(lower half, upper half) and the tile's sum as
// lower + upper, read in that order, so the pair holds one (m, l) bit for
// bit; each warp accumulates P·V over the tile's 64 keys for its half of
// the DV value columns (64 f32 accumulators a thread at D 256, 128 at DV
// 512). Tiles reach shared memory as bf16: a bf16 source by 16-byte
// cp.async, f32 and int8 pools through registers (f32 rounded to nearest,
// int8 as bf16(q · s), the narrow path's values). Head_dim 160-256 keeps a
// two-stage ring of K and V tiles: the next tile is in flight while the
// current one is in the products. Latent rows, whose Q and K tiles are 73
// KB each, keep one K tile and prefetch the next tile's rows into L2
// while the current one is in the products. Both prefill kernels run
// this code for wide rows, so a dense row equals a chunk row here as it
// does for narrow rows.

constexpr int WT_WARPS = 2 * MT_WARPS;          // warps of a wide block: four pairs
constexpr int WT_THREADS = WT_WARPS * 32;
constexpr int WT_HALF = MT_KEYS / 2;            // keys a warp scores in a tile
constexpr int WT_PLD = MT_KEYS + 8;             // bf16 a row of P in shared memory

// Shared memory of a wide block: Q rows, a ring of (K tile, V tile) stages
// (two; latent rows: one stage of a K tile, V being its first DV columns),
// each pair's P (16 x 64 bf16) and its posted row maxima and sums.
template <int DK, int DV, bool LATENT>
struct WideSmem {
  static constexpr int KLD = DK + 8;            // bf16 a Q or K row
  static constexpr int VLD = LATENT ? KLD : DV + 8;
  static constexpr int STAGES = LATENT ? 1 : 2;
  static constexpr size_t Q = (size_t)MT_BLOCK_ROWS * KLD * 2;
  static constexpr size_t K = (size_t)MT_KEYS * KLD * 2;
  static constexpr size_t V = LATENT ? 0 : (size_t)MT_KEYS * VLD * 2;
  static constexpr size_t RING = STAGES * (K + V);
  static constexpr size_t P = (size_t)MT_WARPS * MT_ROWS * WT_PLD * 2;
  static constexpr size_t X = (size_t)MT_WARPS * 4 * MT_ROWS * sizeof(float);
  static constexpr size_t BYTES = Q + RING + P + X;
};

// the named barrier of pair `pair` (warps pair and pair + 4), id 1 + pair
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(1 + pair) : "memory");
}

// One cache line of device memory into L2, no register written
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// What a warp carries from scoring a tile to its P·V: its rows' rescale
struct PairCorr {
  float c[2];
};

// Score one MT_KEYS tile for a warp's rows: the warp scores tile keys
// [32·hf, 32·hf + 32) (kt: K rows of DK bf16, stride kld), the pair
// combines maxima (xm) and sums (xl), writes P (pt: its 16 x WT_PLD bf16)
// and updates (m, l). Row h of this thread (0: g, 1: g + 8) takes tile key
// c iff lo[h] <= c < hi[h]; MASK = false: every key counts. Scores are ×
// scale (the softmax scale × LOG2E). Returns the rows' rescale factors.
template <int DK, int DO, bool MASK>
__device__ __forceinline__ PairCorr score_tile_pair(MmaRows<DO>& st, const QShared& qf,
                                                    const __nv_bfloat16* kt, int kld,
                                                    __nv_bfloat16* pt, float* xm, float* xl,
                                                    int hf, int pair, const int (&lo)[2],
                                                    const int (&hi)[2], float scale,
                                                    int lane) {
  constexpr int NJ = WT_HALF / 8;
  const int g = lane >> 2, t = lane & 3, c0 = hf * WT_HALF;
  float s[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // S = Q·Kᵀ over this warp's 32 keys; step kk + 1's fragments are loaded
  // before step kk's products issue
  unsigned qa[2][4], kb[2][NJ / 2][4];
  auto frags = [&](int kk, int buf) {
    qf(kk, qa[buf]);
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj)
      ldmatrix_x4(kb[buf][jj], kt + (c0 + jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kld +
                                   kk * 16 + ((lane >> 3) & 1) * 8);
  };
  frags(0, 0);
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const int cur = kk & 1;
    if (kk + 1 < DK / 16) frags(kk + 1, cur ^ 1);
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      const unsigned b0[2] = {kb[cur][jj][0], kb[cur][jj][1]};
      const unsigned b1[2] = {kb[cur][jj][2], kb[cur][jj][3]};
      mma_bf16_16816(s[2 * jj], qa[cur], b0);
      mma_bf16_16816(s[2 * jj + 1], qa[cur], b1);
    }
  }
  auto valid = [&](int h, int c) { return !MASK || (c >= lo[h] && c < hi[h]); };
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, c = c0 + 8 * j + 2 * t + (e & 1);
      const float v = __fmul_rn(s[j][e], scale);
      s[j][e] = valid(h, c) ? v : NEG_INF;
      mx[h] = fmaxf(mx[h], s[j][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(MT_FULL, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(MT_FULL, mx[h], 2));
  }
  if (t == 0) {
    xm[hf * MT_ROWS + g] = mx[0];
    xm[hf * MT_ROWS + g + 8] = mx[1];
  }
  pair_sync(pair);
  float mn[2], rs[2] = {0.f, 0.f};
  PairCorr corr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    mn[h] = fmaxf(st.m[h], fmaxf(xm[r], xm[MT_ROWS + r]));
    corr.c[h] = rescale(st.m[h], mn[h]);
  }
  // p, its row sums in key order, and this warp's half of P as bf16
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, c = c0 + 8 * j + 2 * t + (e & 1);
      p[e] = valid(h, c) ? ex2(__fsub_rn(s[j][e], mn[h])) : 0.f;
      rs[h] += p[e];
    }
    const int col = c0 + 8 * j + 2 * t;
    *reinterpret_cast<unsigned*>(pt + g * WT_PLD + col) = pack_bf16x2(p[0], p[1]);
    *reinterpret_cast<unsigned*>(pt + (g + 8) * WT_PLD + col) = pack_bf16x2(p[2], p[3]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] += __shfl_xor_sync(MT_FULL, rs[h], 1);
    rs[h] += __shfl_xor_sync(MT_FULL, rs[h], 2);
  }
  if (t == 0) {
    xl[hf * MT_ROWS + g] = rs[0];
    xl[hf * MT_ROWS + g + 8] = rs[1];
  }
  pair_sync(pair);                // both halves of P, maxima and sums posted
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    const float sum = __fadd_rn(xl[r], xl[MT_ROWS + r]);
    st.l[h] = __fadd_rn(__fmul_rn(st.l[h], corr.c[h]), sum);
    st.m[h] = mn[h];
  }
  return corr;
}

// O = O · corr + P·V over the tile's 64 keys for this warp's DO value
// columns (vt: the first of them, row stride vld): P's A fragments by
// ldmatrix from the pair's P, V's B fragments by ldmatrix.trans.
template <int DO>
__device__ __forceinline__ void pv_tile_pair(MmaRows<DO>& st, const PairCorr& corr,
                                             const __nv_bfloat16* vt, int vld,
                                             const __nv_bfloat16* pt, int lane) {
#pragma unroll
  for (int n = 0; n < DO / 8; ++n) {
    st.o[n][0] *= corr.c[0];
    st.o[n][1] *= corr.c[0];
    st.o[n][2] *= corr.c[1];
    st.o[n][3] *= corr.c[1];
  }
  // step i = (kk, nn): the next step's fragments load before its products
  constexpr int NN = DO / 16, STEPS = MT_KEYS / 16 * NN;
  unsigned pa[2][4], vb[2][4];
  auto vfrag = [&](int i, int buf) {
    const int kk = i / NN, nn = i - kk * NN;
    ldmatrix_x4_trans(vb[buf], vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * vld +
                                   nn * 16 + (lane >> 4) * 8);
  };
  auto pfrag = [&](int kk) {
    ldmatrix_x4(pa[kk & 1], pt + (lane & 15) * WT_PLD + kk * 16 + (lane >> 4) * 8);
  };
  pfrag(0);
  vfrag(0, 0);
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const int kk = i / NN, nn = i - kk * NN;
    if (i + 1 < STEPS) {
      if (nn + 1 == NN) pfrag(kk + 1);
      vfrag(i + 1, (i + 1) & 1);
    }
    const unsigned b0[2] = {vb[i & 1][0], vb[i & 1][1]}, b1[2] = {vb[i & 1][2], vb[i & 1][3]};
    mma_bf16_16816(st.o[2 * nn], pa[kk & 1], b0);
    mma_bf16_16816(st.o[2 * nn + 1], pa[kk & 1], b1);
  }
}

// A key's K and V rows (pool or contiguous) and its int8 scales
template <typename KT>
struct WideRow {
  const KT* k;
  const KT* v;
  float ks;
  float vs;
};

// Columns c .. c + 7 of a row as eight bf16 values (16 bytes)
template <typename KT>
__device__ __forceinline__ uint4 bf16x8(const KT* row, int c, float sc) {
  if constexpr (std::is_same<KT, __nv_bfloat16>::value) {
    return *reinterpret_cast<const uint4*>(row + c);
  } else if constexpr (std::is_same<KT, float>::value) {
    const float4 a = *reinterpret_cast<const float4*>(row + c);
    const float4 b = *reinterpret_cast<const float4*>(row + c + 4);
    return make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                      pack_bf16x2(b.z, b.w));
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(row + c);
    unsigned p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned word = e < 2 ? w.x : w.y;
      const int j = (e & 1) * 2;
      p[e] = pack_bf16x2(__fmul_rn(i8_at(word, j), sc), __fmul_rn(i8_at(word, j + 1), sc));
    }
    return make_uint4(p[0], p[1], p[2], p[3]);
  }
}

// The first COLS columns of the K rows (V: the V rows) of tile keys [j0,
// j0 + MT_KEYS) as bf16 through registers into dst (row stride COLS + 8).
// Keys outside [klo, khi) are 0; row_of(j) gives a key's rows. A thread's
// loads go out LB at a time before any is stored.
template <typename KT, int COLS, bool V, typename RowOf>
__device__ __forceinline__ void stage_rows(RowOf row_of, int j0, int klo, int khi,
                                           __nv_bfloat16* dst, int tid) {
  constexpr int U = COLS / 8, N = MT_KEYS * U, LB = 8;
  for (int base = tid; base < N; base += LB * WT_THREADS) {
    uint4 val[LB];
#pragma unroll
    for (int b = 0; b < LB; ++b) {
      const int i = base + b * WT_THREADS, r = i / U, u = i - r * U, j = j0 + r;
      val[b] = make_uint4(0u, 0u, 0u, 0u);
      if (i < N && j >= klo && j < khi) {
        const WideRow<KT> kr = row_of(j);
        val[b] = V ? bf16x8<KT>(kr.v, 8 * u, kr.vs) : bf16x8<KT>(kr.k, 8 * u, kr.ks);
      }
    }
#pragma unroll
    for (int b = 0; b < LB; ++b) {
      const int i = base + b * WT_THREADS, r = i / U, u = i - r * U;
      if (i < N) *reinterpret_cast<uint4*>(dst + r * (COLS + 8) + 8 * u) = val[b];
    }
  }
}

// The K rows of tile keys [j0, j0 + MT_KEYS) ∩ [klo, khi) into L2 (latent
// rows: V is K's first columns), one 128-byte line a thread at a time: the
// copies of that tile then find them there.
template <typename KT, int DK, typename RowOf>
__device__ __forceinline__ void prefetch_tile(RowOf row_of, int j0, int klo, int khi, int tid) {
  constexpr int LINES = (DK * (int)sizeof(KT) + 127) / 128;
  for (int i = tid; i < MT_KEYS * LINES; i += WT_THREADS) {
    const int r = i / LINES, j = j0 + r;
    if (j < klo || j >= khi) continue;
    prefetch_l2(reinterpret_cast<const char*>(row_of(j).k) + 128 * (i - r * LINES));
  }
}

// Fold tiles [t_first, t_last) of a row tile (tile t: keys [64t, 64t +
// 64), split t / 2) into this warp's state (its pair's rows, value columns
// hf·DV/2 ..), each split from a fresh state; after a split's last tile
// the block calls done(split) (the state then holds that split's (m, l,
// acc)). smem starts with the block's MT_BLOCK_ROWS Q rows (row stride DK
// + 8), a cp.async group the caller committed; this thread's rows' key
// ranges are rlo/rhi (absolute). src.copy_k(j0, kt) / src.copy_v(j0, vt)
// stage a tile's K / V rows (cp.async left uncommitted, or stores through
// registers; keys outside the row tile's range as 0); src.prefetch(j0)
// sends a latent tile's rows to L2. Every tile in the range must hold a key
// of the row tile. Called by the whole block.
template <int DK, int DV, bool LATENT, typename Src, typename Done>
__device__ __forceinline__ void fold_tiles_wide(MmaRows<DV / 2>& st, unsigned char* smem,
                                                Src& src, int t_first, int t_last,
                                                const int (&rlo)[2], const int (&rhi)[2],
                                                float scale, int tid, Done done) {
  using SM = WideSmem<DK, DV, LATENT>;
  constexpr int DO = DV / 2, TPS = MT_SPLIT / MT_KEYS;
  const int warp = tid >> 5, lane = tid & 31, pair = warp & 3, hf = warp >> 2;
  const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(smem);
  // stage i: its K tile, then (not latent) its V tile
  auto kt_of = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem + SM::Q + i * (SM::K + SM::V));
  };
  auto vt_of = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem + SM::Q + i * (SM::K + SM::V) +
                                            (LATENT ? 0 : SM::K));
  };
  __nv_bfloat16* pt = reinterpret_cast<__nv_bfloat16*>(smem + SM::Q + SM::RING) +
                      pair * MT_ROWS * WT_PLD;
  float* xm = reinterpret_cast<float*>(smem + SM::Q + SM::RING + SM::P) +
              pair * 4 * MT_ROWS;
  float* xl = xm + 2 * MT_ROWS;
  const QShared qf{qs + pair * MT_ROWS * SM::KLD, SM::KLD, lane};
  // this pair's part in tile j0: 0 none, 1 every key of its rows, 2 masked
  auto role = [&](int j0, int (&lo)[2], int (&hi)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lo[h] = rlo[h] - j0;
      hi[h] = rhi[h] - j0;
    }
    if (!warp_tile_live(lo, hi)) return 0;
    return warp_tile_full(lo, hi) ? 1 : 2;
  };
  auto score = [&](int r, const __nv_bfloat16* kt, const int (&lo)[2],
                   const int (&hi)[2]) {
    return r == 1 ? score_tile_pair<DK, DO, false>(st, qf, kt, SM::KLD, pt, xm, xl, hf, pair,
                                                   lo, hi, scale, lane)
                  : score_tile_pair<DK, DO, true>(st, qf, kt, SM::KLD, pt, xm, xl, hf, pair,
                                                  lo, hi, scale, lane);
  };
  auto split_end = [&](int t) { return t + 1 == t_last || (t + 1) / TPS != t / TPS; };
  if constexpr (!LATENT) {
    // a two-stage ring: tile t in stage t % 2, tile t + 1 in flight while
    // tile t is in the products
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (t_first + i < t_last) {
        src.copy_k((t_first + i) * MT_KEYS, kt_of(i));
        src.copy_v((t_first + i) * MT_KEYS, vt_of(i));
      }
      cp_async_commit();
    }
#pragma unroll 1
    for (int t = t_first; t < t_last; ++t) {
      const int j0 = t * MT_KEYS, slot = (t - t_first) & 1;
      if (t == t_first || t % TPS == 0) init_rows(st);      // a split starts fresh
      cp_async_wait<1>();
      __syncthreads();            // tile t (and Q) landed
      int lo[2], hi[2];
      const int r = role(j0, lo, hi);
      if (r) {
        const PairCorr corr = score(r, kt_of(slot), lo, hi);
        pv_tile_pair<DO>(st, corr, vt_of(slot) + hf * DO, SM::VLD, pt, lane);
      }
      __syncthreads();            // every warp is done with stage `slot`
      if (t + 2 < t_last) {
        src.copy_k(j0 + 2 * MT_KEYS, kt_of(slot));
        src.copy_v(j0 + 2 * MT_KEYS, vt_of(slot));
      }
      cp_async_commit();
      if (split_end(t)) done(t / TPS);
    }
  } else {
    __nv_bfloat16* kt = kt_of(0);
#pragma unroll 1
    for (int t = t_first; t < t_last; ++t) {
      const int j0 = t * MT_KEYS;
      if (t == t_first || t % TPS == 0) init_rows(st);
      if (t > t_first) __syncthreads();     // every warp is done with tile t - 1
      src.copy_k(j0, kt);
      cp_async_commit();
      if (t + 1 < t_last) src.prefetch(j0 + MT_KEYS);
      cp_async_wait<0>();
      __syncthreads();            // tile t (and Q) landed
      int lo[2], hi[2];
      const int r = role(j0, lo, hi);
      if (r) {
        const PairCorr corr = score(r, kt, lo, hi);
        pv_tile_pair<DO>(st, corr, kt + hf * DO, SM::VLD, pt, lane);
      }
      if (split_end(t)) done(t / TPS);
    }
  }
}

// The wide block's output: warp w holds rows 16(w % 4) .. of the row tile
// and value columns (w / 4)·DV/2 ..; out_row(r) is tile row r's bf16
// output row (DV values); rows at or past `rn` are not real.
template <int DV, typename OutRow>
__device__ __forceinline__ void write_rows_wide(const MmaRows<DV / 2>& st, OutRow out_row,
                                                int rn, int tid) {
  constexpr int DO = DV / 2;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = (warp & 3) * MT_ROWS + g + 8 * h;
    if (rl >= rn) continue;
    const float l = fmaxf(st.l[h], 1e-30f);
    __nv_bfloat16* o = out_row(rl) + (warp >> 2) * DO + 2 * t4;
#pragma unroll
    for (int n = 0; n < DO / 8; ++n)
      *reinterpret_cast<unsigned*>(o + 8 * n) =
          pack_bf16x2(st.o[n][2 * h] / l, st.o[n][2 * h + 1] / l);
  }
}

// Several live splits: acc_t as [split][row][DV], ml_t as [split][row]
// (m, l; the pair's lower warp writes them, both hold the same)
template <int DV>
__device__ __forceinline__ void store_split_wide(const MmaRows<DV / 2>& st, float* acc_t,
                                                 float2* ml_t, int split, int tid) {
  constexpr int DO = DV / 2;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = (warp & 3) * MT_ROWS + g + 8 * h;
    if (t4 == 0 && warp < 4)
      ml_t[(size_t)split * MT_BLOCK_ROWS + rl] = make_float2(st.m[h], st.l[h]);
    float* rec = acc_t + ((size_t)split * MT_BLOCK_ROWS + rl) * DV + (warp >> 2) * DO + 2 * t4;
#pragma unroll
    for (int n = 0; n < DO / 8; ++n)
      *reinterpret_cast<float2*>(rec + 8 * n) = make_float2(st.o[n][2 * h], st.o[n][2 * h + 1]);
  }
}

// Merge a row tile's live splits [s_lo, s_hi) in split order, as
// `merge_splits` does: m = the max of the splits' m, then l and acc as
// fused multiply-adds in split order; a split that holds no key of a row
// adds exact zeros. Four threads a row, each a quarter of its columns in
// passes of 16 (8 where a quarter is not a multiple of 16), the loads of
// up to eight splits in flight together. ml(sp, r) gives split sp's (m, l)
// of tile row r, acc4(sp, r, c) its accumulators c .. c + 3 (from scratch
// in device memory or shared memory). Rows at or past `rn` are not real.
template <int DV, typename ML, typename ACC, typename OutRow>
__device__ __forceinline__ void merge_rows_wide(ML ml, ACC acc4, int s_lo, int s_hi, int rn,
                                                OutRow out_row, int tid) {
  constexpr int TPR = WT_THREADS / MT_BLOCK_ROWS, CW = DV / TPR, SB = 8;
  constexpr int CH = CW % 16 == 0 ? 16 : 8, NV = CH / 4;
  static_assert(CW % CH == 0, "whole float4 passes");
  const int rl = tid / TPR, c0 = (tid % TPR) * CW;
  if (rl >= rn) return;
  float m = NEG_INF;
  for (int sb = s_lo; sb < s_hi; sb += SB) {
    float mx[SB];
#pragma unroll
    for (int u = 0; u < SB; ++u) mx[u] = sb + u < s_hi ? ml(sb + u, rl).x : NEG_INF;
#pragma unroll
    for (int u = 0; u < SB; ++u) m = fmaxf(m, mx[u]);
  }
  float l = 0.f;
  for (int sb = s_lo; sb < s_hi; sb += SB) {
    float2 v[SB];
#pragma unroll
    for (int u = 0; u < SB; ++u) v[u] = sb + u < s_hi ? ml(sb + u, rl) : make_float2(0.f, 0.f);
#pragma unroll
    for (int u = 0; u < SB; ++u)
      if (sb + u < s_hi) l = __fmaf_rn(v[u].y, rescale(v[u].x, m), l);
  }
  l = fmaxf(l, 1e-30f);
  __nv_bfloat16* o = out_row(rl);
#pragma unroll 1
  for (int cb = c0; cb < c0 + CW; cb += CH) {
    float4 acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sb = s_lo; sb < s_hi; sb += SB) {
      // every load of the batch before any use: the splits' m, then their
      // accumulators (a factor computed between loads would wait on each)
      float ms[SB];
      float4 v[SB][NV];
#pragma unroll
      for (int u = 0; u < SB; ++u) ms[u] = sb + u < s_hi ? ml(sb + u, rl).x : NEG_INF;
#pragma unroll
      for (int u = 0; u < SB; ++u)
#pragma unroll
        for (int i = 0; i < NV; ++i)
          v[u][i] = sb + u < s_hi ? acc4(sb + u, rl, cb + 4 * i)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        if (sb + u >= s_hi) continue;
        const float f = rescale(ms[u], m);
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          acc[i].x = __fmaf_rn(v[u][i].x, f, acc[i].x);
          acc[i].y = __fmaf_rn(v[u][i].y, f, acc[i].y);
          acc[i].z = __fmaf_rn(v[u][i].z, f, acc[i].z);
          acc[i].w = __fmaf_rn(v[u][i].w, f, acc[i].w);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i)
      *reinterpret_cast<uint2*>(o + cb + 4 * i) =
          make_uint2(pack_bf16x2(acc[i].x / l, acc[i].y / l),
                     pack_bf16x2(acc[i].z / l, acc[i].w / l));
  }
}

// The split blocks' merge: every split's partials in device-memory scratch,
// acc_t as [split][row][DV] and ml_t as [split][row], written by other
// blocks (read past L1)
template <int DV, typename OutRow>
__device__ __forceinline__ void merge_splits_wide(const float* acc_t, const float2* ml_t,
                                                  int s_lo, int s_hi, int rn, OutRow out_row,
                                                  int tid) {
  auto ml = [&](int sp, int r) { return __ldcg(&ml_t[(size_t)sp * MT_BLOCK_ROWS + r]); };
  auto acc4 = [&](int sp, int r, int c) {
    return __ldcg(reinterpret_cast<const float4*>(acc_t + ((size_t)sp * MT_BLOCK_ROWS + r) * DV +
                                                  c));
  };
  merge_rows_wide<DV>(ml, acc4, s_lo, s_hi, rn, out_row, tid);
}

}  // namespace repro
