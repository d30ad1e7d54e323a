// Tensor-core tiles shared by the two prefill attention kernels
// (flash_attention.cu and flash_attention_paged.cu, bf16 q): one warp holds
// 16 query rows as bf16 A fragments and folds 64-key K/V tiles, bf16 in
// shared memory, into an f32 online softmax kept in mma accumulators.
//
// Numerics, the same in both kernels:
// - q·kᵀ is an mma.sync m16n8k16 bf16 product with f32 accumulators, then
//   × a per-key f32 factor: the softmax scale, or for an int8 pool the
//   key's f16 K scale × the softmax scale (K widened to bf16 exactly, its
//   scale applied to the score column after the product).
// - A masked key's score is NEG_INF (-1e30, finite) and its p exactly 0;
//   a row with no valid key so far keeps m = NEG_INF, l = 0, acc = 0.
// - Scores are kept in base 2: the factor above carries log2(e), and
//   p = 2^(s - m_new) by ex2.approx (relative error 2^-22, far below the
//   bf16 rounding p takes next), a quarter of the instructions of expf.
//   m_new == m gives corr = 1 exactly, by a select, whatever ex2 does.
// - l sums the f32 p. p (× the key's f16
//   V scale for an int8 pool) is rounded to bf16 and becomes the A fragment
//   of the p·V mma straight from the S accumulators' registers, as the TPU
//   kernel rounds p to v's type (repro/kernels/flash_attention.py:86).
// - Row max and row sum: each thread's 16 values of a row in key order,
//   then __shfl_xor 1 and 2 within the quad (a + b == b + a, so the four
//   lanes agree). The order depends on the key's place in the tile only,
//   never on the row's place in the warp, so a row's result does not
//   depend on which other rows share its tile.
// - A tile in which a row has no valid key leaves its state as it was,
//   bit for bit (corr = 1, p = 0), so a row's sums depend only on
//   the tiles that hold its own keys. The callers cut tiles at absolute key
//   positions (multiples of MT_KEYS).
//
// Fragment layout (PTX ISA, mma.m16n8k16): lane = 4·g + t; accumulator j
// holds rows g (c0, c1) and g + 8 (c2, c3), columns 8j + 2t and 8j + 2t + 1.
#pragma once

#include "attn_common.cuh"
#include "hopper.cuh"

namespace repro {

constexpr int MT_KEYS = 64;      // keys per K/V tile
constexpr int MT_ROWS = 16;      // query rows per warp
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

// Fold one tile of MT_KEYS keys into a warp's rows. kt, vt: the tile's K
// and V rows, D bf16 each, row stride ld. Row h of this thread (0: g,
// 1: g + 8) takes tile key c iff lo[h] <= c < hi[h]; MASK = false: every
// key counts for every row. I8: kf[c] is key c's score factor (K scale ×
// softmax scale × LOG2E) and vf[c] its V scale; otherwise every score is
// × scale (the softmax scale × LOG2E).
template <int D, bool MASK, bool I8>
__device__ __forceinline__ void fold_tile_mma(MmaRows<D>& st, const unsigned (&qa)[D / 16][4],
                                              const __nv_bfloat16* kt,
                                              const __nv_bfloat16* vt, int ld,
                                              const int (&lo)[2], const int (&hi)[2],
                                              float scale, const float* kf,
                                              const float* vf, int lane) {
  constexpr int NJ = MT_KEYS / 8;
  const int t = lane & 3;
  float s[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // S = Q·Kᵀ: one ldmatrix_x4 gives the B fragments of 16 keys x 16 dims
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      unsigned r[4];
      ldmatrix_x4(r, kt + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_bf16_16816(s[2 * jj], qa[kk], b0);
      mma_bf16_16816(s[2 * jj + 1], qa[kk], b1);
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
      const float v = __fmul_rn(s[j][e], I8 ? kf[c] : scale);
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
      if (I8) p[e] *= vf[c];
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
  for (int n = 0; n < D / 8; ++n) {
    st.o[n][0] *= corr[0];
    st.o[n][1] *= corr[0];
    st.o[n][2] *= corr[1];
    st.o[n][3] *= corr[1];
  }
  // O += P·V: ldmatrix.trans gives the B fragments of 16 keys x 16 dims
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      unsigned r[4];
      ldmatrix_x4_trans(r, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
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

template <int D, bool I8>
__device__ __forceinline__ void fold_tile_auto(MmaRows<D>& st, const unsigned (&qa)[D / 16][4],
                                               const __nv_bfloat16* kt,
                                               const __nv_bfloat16* vt, int ld,
                                               const int (&lo)[2], const int (&hi)[2],
                                               float scale, const float* kf,
                                               const float* vf, int lane) {
  if (!warp_tile_live(lo, hi)) return;               // no row of the warp sees it
  if (warp_tile_full(lo, hi))                        // inside every row's range
    fold_tile_mma<D, false, I8>(st, qa, kt, vt, ld, lo, hi, scale, kf, vf, lane);
  else                                               // crosses an edge: masked
    fold_tile_mma<D, true, I8>(st, qa, kt, vt, ld, lo, hi, scale, kf, vf, lane);
}

}  // namespace repro
