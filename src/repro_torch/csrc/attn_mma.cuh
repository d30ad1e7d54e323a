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
// would not fit its registers. So Q stays in shared memory (`QShared`) and
// a block accumulates one slab of DO output columns of its row tile (grid
// y = row tile x slab): every slab computes the same scores, bit for bit,
// and the same (m, l). The K tile and the slab's V columns are staged as
// bf16 through registers (f32 rounded to nearest, int8 as bf16(q · s),
// the narrow path's values), one 64-key tile at a time. Both prefill
// kernels run this code for wide rows, so a dense row equals a chunk row
// here as it does for narrow rows.

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

// Tile keys [j0, j0 + MT_KEYS) as bf16: K's DK columns into kt (row stride
// DK + 8) and, unless LATENT, V's columns [vc0, vc0 + DO) into vt (row
// stride DO + 8). Keys outside [klo, khi) are 0. row_of(j) gives a key's
// rows. A thread's loads go out four at a time before any is stored.
template <typename KT, int DK, int DO, bool LATENT, typename RowOf>
__device__ __forceinline__ void stage_wide(RowOf row_of, int j0, int klo, int khi, int vc0,
                                           __nv_bfloat16* kt, __nv_bfloat16* vt, int tid) {
  constexpr int NT = MT_WARPS * 32, KU = DK / 8, VU = LATENT ? 0 : DO / 8, U = KU + VU;
  constexpr int N = MT_KEYS * U, LB = 4;
  for (int base = tid; base < N; base += LB * NT) {
    uint4 val[LB];
#pragma unroll
    for (int b = 0; b < LB; ++b) {
      const int i = base + b * NT, r = i / U, u = i - r * U, j = j0 + r;
      val[b] = make_uint4(0u, 0u, 0u, 0u);
      if (i < N && j >= klo && j < khi) {
        const WideRow<KT> kr = row_of(j);
        val[b] = u < KU ? bf16x8<KT>(kr.k, 8 * u, kr.ks)
                        : bf16x8<KT>(kr.v, vc0 + 8 * (u - KU), kr.vs);
      }
    }
#pragma unroll
    for (int b = 0; b < LB; ++b) {
      const int i = base + b * NT, r = i / U, u = i - r * U;
      if (i < N)
        *reinterpret_cast<uint4*>(u < KU ? kt + r * (DK + 8) + 8 * u
                                         : vt + r * (DO + 8) + 8 * (u - KU)) = val[b];
    }
  }
}

// Fold the split [s0, s0 + MT_SPLIT) of a row tile into the warp's slab
// state: qs holds the block's MT_BLOCK_ROWS Q rows (row stride DK + 8),
// already in shared memory; the block's keys are [klo, khi) and this
// thread's rows' ranges rlo/rhi (absolute). Called by the whole block.
template <typename KT, int DK, int DO, bool LATENT, typename RowOf>
__device__ __forceinline__ void fold_split_wide(MmaRows<DO>& st, const __nv_bfloat16* qs,
                                                __nv_bfloat16* kt, __nv_bfloat16* vt,
                                                RowOf row_of, int s0, int klo, int khi,
                                                int slab, const int (&rlo)[2],
                                                const int (&rhi)[2], float scale, int tid) {
  constexpr int KLD = DK + 8, VLD = LATENT ? KLD : DO + 8;
  const int warp = tid >> 5, lane = tid & 31;
  const QShared qf{qs + warp * MT_ROWS * KLD, KLD, lane};
  const __nv_bfloat16* vs = LATENT ? kt + slab * DO : vt;
#pragma unroll 1
  for (int i = 0; i < MT_SPLIT / MT_KEYS; ++i) {
    const int j0 = s0 + i * MT_KEYS;
    if (!(j0 < khi && j0 + MT_KEYS > klo)) continue;              // block-uniform
    __syncthreads();              // the previous tile read (and Q landed)
    stage_wide<KT, DK, DO, LATENT>(row_of, j0, klo, khi, slab * DO, kt, vt, tid);
    __syncthreads();
    const int lo[2] = {rlo[0] - j0, rlo[1] - j0}, hi[2] = {rhi[0] - j0, rhi[1] - j0};
    fold_tile_any<DK, DO>(st, qf, kt, KLD, vs, VLD, lo, hi, scale, lane);
  }
}

// Shared memory of a wide block: Q rows, the K tile, the V slab tile
template <int DK, int DO, bool LATENT>
struct WideSmem {
  static constexpr size_t Q = (size_t)MT_BLOCK_ROWS * (DK + 8) * 2;
  static constexpr size_t K = (size_t)MT_KEYS * (DK + 8) * 2;
  static constexpr size_t V = LATENT ? 0 : (size_t)MT_KEYS * (DO + 8) * 2;
  static constexpr size_t BYTES = Q + K + V;
};

}  // namespace repro
