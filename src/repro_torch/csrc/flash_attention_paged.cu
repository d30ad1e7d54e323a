// Chunk-prefill attention through the page table.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_paged (_paged_kernel). A chunk of C query rows, row i at
// global position q_offset[b] + i, attends against the shared
// (n_pages, page_size, KV, D) pools through a (B, pages_per_seq) page table.
// Key j counts for row i iff j <= q_offset[b] + i (causal by global
// position), j < kv_len[b] (live rows) and, with a window, q_pos - j < window.
// Float pools and int8 pools (f16 per-(row, kv head) scales, dequant fused
// into the tile load) both run here. Rows with no valid key give zeros, as
// the TPU kernel's masked `p` does.
//
// Bound on the card: bytes at the serving chunk (64 rows against at most a
// few hundred live rows per kv head), operations only for long prompts.
//
// Three paths; the wrapper's `chunk_plan` (kernels/flash_attention.py)
// picks (the third, for head_dim 160-256 and MLA latent rows, is at the end
// of the file: attn_mma.cuh's wide code, a block per (split, row tile,
// sequence · kv head) that computes each score once and accumulates every
// output column):
//
// - Tensor cores (bf16 q; path 1). The C chunk rows x G query heads of one
//   kv head are packed into the M dimension (packed row r = chunk row r / G,
//   head r % G: 192 rows at the serving chunk), so K/V are loaded once per
//   kv head, not once per query head. A 4-warp block takes a row tile of 64
//   packed rows, each warp one 16-row m-tile, and one split of the key
//   range: SPLIT = 128 keys at absolute positions, two 64-key tiles. At one
//   sequence and five kv heads the rows alone cannot fill 132 SMs, so the
//   key range is split as in the decode kernel: the grid is (splits of the
//   pool's depth) x (row tiles) x (sequence, kv head), and a block whose
//   split misses its row tile's key range exits at once. The block reads
//   the page table once per page, then copies both tiles of its split by
//   16-byte cp.async into a two-stage ring (tile 1 is in flight while tile
//   0 is in the mma.sync products); rows outside the row tile's live key
//   range are zero-filled (src_bytes 0). bf16 pools land as they are; f32
//   pools are rounded to bf16 in shared memory (exact on the main path,
//   where the engine writes bf16-valued K/V into the f32 pool, and within
//   the bf16-q tolerance elsewhere); int8 pools become bf16(q · s) with the
//   row's f16 scale, the values a dense prefill of the int8-KV engines
//   attends (models `dequantize_kv_rows(..., bf16)`). The tile code, the
//   split merge and their numerics are in attn_mma.cuh, shared with the
//   dense kernel (flash_attention.cu); V reaches the B fragments through
//   ldmatrix.trans.
//   With one live split the block writes the output. Otherwise each block
//   writes its rows' (m, l, acc) to scratch the wrapper allocated, and the
//   last block of the (sequence, kv head, row tile) to finish, found with
//   repro::last_split_done on the wrapper's zeroed semaphores, merges the
//   live splits in split-index order: one launch, no merge kernel (a
//   second launch costs ~5 us of device time on the H100). A row takes no
//   part in a split that misses its own key range (its state stays m =
//   NEG_INF, l = 0, acc = 0, which the merge adds as exact zeros), tiles
//   and splits lie at absolute key positions, and a row's sums run in an
//   order fixed by its own keys: a chunk row equals, bit for bit, the same
//   row run alone as a one-row chunk at q_offset + i, and the same row of
//   a dense causal prefill over the same K/V values.
// - CUDA cores (f32 q; path 0): bf16 fragments would round f32 q beyond the
//   f32 tolerance. One 128-thread block per (sequence, kv head, four chunk
//   rows), one warp per row covering its G query heads. The block loads
//   each 32-key tile of its rows' combined key range into shared memory
//   once, dequantized to f32, and every warp folds it into its own f32
//   online softmax.

#include <type_traits>

#include "attn_mma.cuh"

namespace {

using repro::KVArgs;
using repro::NEG_INF;
using repro::NW;
using repro::TK;

template <typename QT, typename KT>
__global__ void __launch_bounds__(NW * 32)
chunk_attention_kernel(const QT* __restrict__ q, KVArgs a,
                       const int* __restrict__ q_offset,
                       const int* __restrict__ kv_len, QT* __restrict__ out,
                       int C, int G, int window, float scale) {
  extern __shared__ float smem[];
  const int D = a.d;
  const int b = blockIdx.x / a.kv, h = blockIdx.x % a.kv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * NW;
  const int i = row0 + warp;                       // this warp's chunk row
  float* qs = smem;                                // NW x G x D
  float* ktile = qs + NW * G * D;                  // TK x (D + 1)
  float* vtile = ktile + TK * (D + 1);             // TK x D

  // q is (B, C, KV, G, D)
  for (int idx = threadIdx.x; idx < NW * G * D; idx += blockDim.x) {
    const int w = idx / (G * D), r = idx - w * (G * D);
    const int row = row0 + w;
    qs[idx] = row < C
        ? repro::to_f(q[(((size_t)b * C + row) * a.kv + h) * G * D + r]) * scale
        : 0.f;
  }

  const int live = min(kv_len[b], a.pps * a.ps);
  const int off = q_offset[b];
  int lo = 0, hi = 0;                              // this row's key range
  if (i < C) {
    hi = min(off + i + 1, live);
    lo = window > 0 ? max(0, off + i - window + 1) : 0;
  }
  const int last = min(C - 1, row0 + NW - 1);      // block's key range
  const int blk_hi = min(off + last + 1, live);
  const int blk_lo = window > 0 ? max(0, off + row0 - window + 1) : 0;
  __syncthreads();

  repro::RowState st;
  repro::init_state(st);
  for (int t = blk_lo / TK; t * TK < blk_hi; ++t) {
    const int j0 = t * TK;
    repro::load_tile<KT>(a, b, h, j0, blk_hi, ktile, vtile, threadIdx.x, blockDim.x);
    __syncthreads();
    if (lo < hi && j0 < hi && j0 + TK > lo)       // warp-uniform
      repro::tile_update(st, qs + warp * G * D, ktile, vtile, G, D, j0, lo, hi, lane);
    __syncthreads();
  }

  if (i >= C) return;
  const int E = D / 32;
  QT* ob = out + (((size_t)b * C + i) * a.kv + h) * G * D;
#pragma unroll
  for (int g = 0; g < repro::MAXG; ++g) {
    if (g < G) {
      const float l = fmaxf(st.l[g], 1e-30f);
#pragma unroll
      for (int e = 0; e < repro::MAXE; ++e)
        if (e < E) ob[g * D + lane + 32 * e] = repro::from_f<QT>(st.acc[g][e] / l);
    }
  }
}

// ------------------------------------------------------ tensor-core path
constexpr int CW = repro::MT_WARPS;            // warps per block
constexpr int CROWS = repro::MT_BLOCK_ROWS;    // packed rows of a row tile
constexpr int CTK = repro::MT_KEYS;            // keys per K/V tile
constexpr int CSPLIT = repro::MT_SPLIT;        // keys per split (kernels/flash_attention.py)
constexpr int CTILES = CSPLIT / CTK;
static_assert(CTILES == 2, "the two-stage ring holds one split");

// Shared memory of one block: Q (CROWS x LD bf16), the split's page entries
// and rows, the int8 K and V scales, the ring (two tiles of K and V in
// the pool's type; for bf16 pools they are the bf16 tiles) and, for f32 and
// int8 pools, the bf16 K and V tile the ring's tiles are converted into.
template <typename KT, int D>
struct ChunkSmem {
  static constexpr bool DIRECT = std::is_same<KT, __nv_bfloat16>::value;
  static constexpr int LD = D + 8;       // bf16 a row of a tile
  static constexpr int RSB = DIRECT ? LD * 2 : D * (int)sizeof(KT);   // ring row bytes
  static constexpr size_t Q = (size_t)CROWS * LD * 2;
  static constexpr size_t META = CSPLIT * (sizeof(int) + sizeof(long long) + 2 * sizeof(float));
  static constexpr size_t RING = (size_t)CTILES * 2 * CTK * RSB;
  static constexpr size_t TILE = DIRECT ? 0 : (size_t)2 * CTK * LD * 2;
  static constexpr size_t BYTES = Q + META + RING + TILE;
};

// Round 16 bytes of a staged pool row to bf16 at dst: f32 to nearest,
// int8 as bf16(q · sc) (q · sc is exact in f32: 8 by 11 significant bits)
template <typename KT>
__device__ __forceinline__ void to_bf16_16(const unsigned char* src, __nv_bfloat16* dst,
                                           float sc) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  if constexpr (std::is_same<KT, float>::value) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(repro::pack_bf16x2(__uint_as_float(w.x), __uint_as_float(w.y)),
                   repro::pack_bf16x2(__uint_as_float(w.z), __uint_as_float(w.w)));
  } else {
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
    unsigned p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      p[e] = repro::pack_bf16x2(__fmul_rn(repro::i8_at(words[e >> 1], (e & 1) * 2), sc),
                                __fmul_rn(repro::i8_at(words[e >> 1], (e & 1) * 2 + 1), sc));
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(p[0], p[1], p[2], p[3]);
    d[1] = make_uint4(p[4], p[5], p[6], p[7]);
  }
}

// Output row of packed row r (chunk row r / G, query head r % G) of (b, h)
__device__ __forceinline__ size_t packed_row(int b, int h, int r, int C, int KV, int G, int D) {
  const int i = r / G, g = r - i * G;
  return ((((size_t)b * C + i) * KV + h) * G + g) * D;
}

// One block per (split, row tile, sequence · kv head). part holds, per
// (sequence · kv head, row tile, split, packed row of the tile), the row's
// (m, l, acc[D]); sem one counter per (sequence · kv head, row tile).
template <typename KT, int D>
__global__ void __launch_bounds__(CW * 32)
chunk_mma_kernel(const __nv_bfloat16* __restrict__ q, KVArgs a,
                 const int* __restrict__ q_offset, const int* __restrict__ kv_len,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                 int* __restrict__ sem, int C, int G, int window, float scale, int n_splits) {
  using SM = ChunkSmem<KT, D>;
  constexpr bool I8 = std::is_same<KT, int8_t>::value;
  constexpr int LD = SM::LD, RSB = SM::RSB;
  constexpr int CPR = D * (int)sizeof(KT) / 16;         // 16-byte chunks a pool row
  constexpr int NT = CW * 32;
  extern __shared__ __align__(16) unsigned char sbuf[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(sbuf);
  long long* rows = reinterpret_cast<long long*>(sbuf + SM::Q);   // pool row of key, or -1
  int* pages = reinterpret_cast<int*>(rows + CSPLIT);
  float* kf = reinterpret_cast<float*>(pages + CSPLIT);           // K scale (int8)
  float* vf = kf + CSPLIT;                                        // V scale (int8)
  unsigned char* ring = sbuf + SM::Q + SM::META;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring + SM::RING);  // f32/int8

  const int split = blockIdx.x, rt = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.kv, h = bh - b * a.kv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = C * G, r0 = rt * CROWS, rn = min(CROWS, R - r0);
  const int live = min(kv_len[b], a.pps * a.ps), off = q_offset[b];
  // the row tile's key range: the union of its rows' ranges
  const int i_first = r0 / G, i_last = (r0 + rn - 1) / G;
  const int blk_hi = min(off + i_last + 1, live);
  const int blk_lo = window > 0 ? max(0, off + i_first - window + 1) : 0;
  const int s0 = split * CSPLIT;
  if (blk_hi <= blk_lo) {         // no row of the tile has a valid key: zeros
    if (split == 0)
      for (int e = tid; e < rn * D; e += NT)
        out[packed_row(b, h, r0 + e / D, C, a.kv, G, D) + e % D] =
            __float2bfloat16(0.f);
    return;
  }
  if (s0 >= blk_hi || s0 + CSPLIT <= blk_lo) return;             // a dead split
  const int s_lo = blk_lo / CSPLIT, s_hi = (blk_hi + CSPLIT - 1) / CSPLIT;

  // Q rows of the tile (rows past R zero-filled), in flight with the table
  constexpr int QC = D / 8;
  for (int c = tid; c < CROWS * QC; c += NT) {
    const int r = c / QC, cc = c - r * QC;
    const bool ok = r < rn;
    repro::cp_async16(qs + r * LD + cc * 8,
                      ok ? q + packed_row(b, h, r0 + r, C, a.kv, G, D) + cc * 8 : q,
                      ok ? 16 : 0);
  }
  repro::cp_async_commit();
  // the block's keys [klo, khi) of this split: one table read per page
  const int klo = max(s0, blk_lo), khi = min(s0 + CSPLIT, blk_hi);
  const int p_first = klo / a.ps, p_cnt = (khi - 1) / a.ps - p_first + 1;
  const int* pt = a.page_table + (size_t)b * a.pps;
  for (int t = tid; t < p_cnt; t += NT) pages[t] = pt[p_first + t];
  __syncthreads();
  for (int t = tid; t < CSPLIT; t += NT) {
    const int j = s0 + t;
    rows[t] = j >= klo && j < khi
        ? ((long long)pages[j / a.ps - p_first] * a.ps + j % a.ps) * a.kv + h : -1;
  }
  __syncthreads();
  // both tiles of the split into the ring; rows outside [klo, khi) are 0
  const char* K = static_cast<const char*>(a.k);
  const char* V = static_cast<const char*>(a.v);
#pragma unroll
  for (int i = 0; i < CTILES; ++i) {
    if (s0 + i * CTK < khi && s0 + (i + 1) * CTK > klo) {
      unsigned char* kt = ring + (size_t)i * 2 * CTK * RSB;
      unsigned char* vt = kt + CTK * RSB;
      for (int c = tid; c < CTK * CPR; c += NT) {
        const int r = c / CPR, cc = c - r * CPR;
        const long long row = rows[i * CTK + r];
        const size_t src = row >= 0 ? (size_t)row * D * sizeof(KT) + cc * 16 : 0;
        repro::cp_async16(kt + r * RSB + cc * 16, K + src, row >= 0 ? 16 : 0);
        repro::cp_async16(vt + r * RSB + cc * 16, V + src, row >= 0 ? 16 : 0);
      }
    }
    repro::cp_async_commit();
  }
  if constexpr (I8) {           // each key's scales, while the tiles are in flight
    for (int t = tid; t < CSPLIT; t += NT) {
      const long long row = rows[t];
      kf[t] = row >= 0 ? __half2float(a.ks[row]) : 0.f;
      vf[t] = row >= 0 ? __half2float(a.vs[row]) : 0.f;
    }
  }

  // this thread's packed rows g and g + 8 of the warp: key range [lo, hi)
  const int g = lane >> 2;
  int rlo[2], rhi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + warp * repro::MT_ROWS + g + 8 * hh;
    rlo[hh] = 0;
    rhi[hh] = 0;
    if (r < R) {
      const int i = r / G;
      rhi[hh] = min(off + i + 1, live);
      rlo[hh] = window > 0 ? max(0, off + i - window + 1) : 0;
    }
  }
  repro::MmaRows<D> st;
  repro::init_rows(st);
  unsigned qa[D / 16][4];
#pragma unroll
  for (int i = 0; i < CTILES; ++i) {
    if (i == 0) repro::cp_async_wait<CTILES - 1>();
    else repro::cp_async_wait<0>();
    __syncthreads();              // tile i (and Q, and the scales) landed
    if (i == 0) repro::load_q_frags<D>(qa, qs + warp * repro::MT_ROWS * LD, LD, lane);
    const int j0 = s0 + i * CTK;
    if (!(j0 < khi && j0 + CTK > klo)) continue;                  // block-uniform
    const __nv_bfloat16* kt;
    if constexpr (SM::DIRECT) {
      kt = reinterpret_cast<const __nv_bfloat16*>(ring + (size_t)i * 2 * CTK * RSB);
    } else {
      const unsigned char* src = ring + (size_t)i * 2 * CTK * RSB;
      for (int c = tid; c < 2 * CTK * CPR; c += NT) {             // K rows, then V rows
        const int r = c / CPR, cc = c - r * CPR;
        const float sc = !I8 ? 1.f : r < CTK ? kf[i * CTK + r] : vf[i * CTK + r - CTK];
        to_bf16_16<KT>(src + r * RSB + cc * 16, tile + r * LD + cc * 16 / (int)sizeof(KT), sc);
      }
      __syncthreads();
      kt = tile;
    }
    const int lo[2] = {rlo[0] - j0, rlo[1] - j0}, hi[2] = {rhi[0] - j0, rhi[1] - j0};
    repro::fold_tile_auto<D>(st, qa, kt, kt + CTK * LD, LD, lo, hi, scale * repro::LOG2E,
                             lane);
  }   // (the next tile's wait and __syncthreads guard the bf16 tile's reuse)

  auto out_row = [&](int rl) { return out + packed_row(b, h, r0 + rl, C, a.kv, G, D); };
  if (s_hi - s_lo == 1) {         // one live split: the block writes the output
    repro::write_rows<D>(st, out_row, rn, warp, lane);
    return;
  }
  // the split's (m, l) and acc of every row of the tile, then the merge
  const size_t tile_rows = ((size_t)bh * gridDim.y + rt) * n_splits * CROWS;
  float* acc_t = part + tile_rows * D;                         // [split][row][D]
  float2* ml_t = reinterpret_cast<float2*>(part + (size_t)gridDim.z * gridDim.y *
                                           n_splits * CROWS * D) + tile_rows;  // [split][row]
  repro::store_split<D>(st, acc_t, ml_t, split, warp, lane);
  if (!repro::last_split_done(sem + (size_t)bh * gridDim.y + rt, s_hi - s_lo)) return;
  repro::merge_splits<D>(acc_t, ml_t, s_lo, s_hi, rn, out_row, tid);
}

template <typename KT, int D>
int launch_mma(const void* q, const KVArgs& a, const void* q_offset, const void* kv_len,
               void* out, void* part, void* sem, int B, int C, int G, int window,
               float scale, int n_splits, cudaStream_t stream) {
  using SM = ChunkSmem<KT, D>;
  const int row_tiles = (C * G + CROWS - 1) / CROWS;
  if (n_splits != (a.pps * a.ps + CSPLIT - 1) / CSPLIT || part == nullptr || sem == nullptr ||
      row_tiles > 65535 || B * a.kv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = chunk_mma_kernel<KT, D>;
  cudaError_t err = repro::allow_smem(kernel, SM::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  // at least one split: its block writes the zeros of rows with no key
  kernel<<<dim3(max(n_splits, 1), row_tiles, B * a.kv), CW * 32, SM::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), a, static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), static_cast<int*>(sem), C, G, window, scale, n_splits);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- wide rows
// head_dim 160-256, or MLA latent rows (DK 576 keys, DV 512 values, one
// pool as k and v): attn_mma.cuh's wide code. One block per (split, row
// tile, sequence · kv head) of eight warps computes each score of its row
// tile once and accumulates every output column (`fold_tiles_wide`); the
// page walk, masks, splits and merge as in chunk_mma_kernel. bf16 pools
// are copied by cp.async, f32 and int8 pools through registers; head_dim
// 160-256 keeps a two-stage ring of K and V tiles (both tiles of a split
// in flight at once), latent rows one K tile.

// The split's keys as the wide code stages them: rows[j - s0] is key j's
// pool row (times KV, plus the kv head), -1 outside [klo, khi).
template <typename KT, int DK, int DV, bool LATENT>
struct ChunkWideSrc {
  const KT* k;
  const KT* v;
  const __half* ks;
  const __half* vs;
  const int* rows;
  int s0, klo, khi, tid;

  __device__ __forceinline__ repro::WideRow<KT> row_of(int j) const {
    const long long row = rows[j - s0];
    return repro::WideRow<KT>{k + row * DK, v + row * DK,
                              ks != nullptr ? __half2float(ks[row]) : 1.f,
                              vs != nullptr ? __half2float(vs[row]) : 1.f};
  }
  // the first COLS columns of tile keys [j0, j0 + CTK) of pool P into dst
  template <int COLS, bool VROWS>
  __device__ __forceinline__ void copy(const KT* pool, int j0, __nv_bfloat16* dst) {
    if constexpr (std::is_same<KT, __nv_bfloat16>::value) {
      constexpr int CPR = COLS / 8;
      for (int c = tid; c < CTK * CPR; c += repro::WT_THREADS) {
        const int r = c / CPR, u = c - r * CPR;
        const long long row = rows[j0 - s0 + r];
        const bool ok = row >= 0;
        repro::cp_async16(dst + r * (COLS + 8) + u * 8, pool + (ok ? row * DK + u * 8 : 0),
                          ok ? 16 : 0);
      }
    } else {
      auto rof = [&](int j) { return row_of(j); };
      repro::stage_rows<KT, COLS, VROWS>(rof, j0, klo, khi, dst, tid);
    }
  }
  __device__ __forceinline__ void copy_k(int j0, __nv_bfloat16* kt) {
    copy<DK, false>(k, j0, kt);
  }
  __device__ __forceinline__ void copy_v(int j0, __nv_bfloat16* vt) {
    copy<DV, true>(v, j0, vt);
  }
  __device__ __forceinline__ void prefetch(int j0) {
    auto rof = [&](int j) { return row_of(j); };
    repro::prefetch_tile<KT, DK>(rof, j0, klo, khi, tid);
  }
};

// The block's shared memory: the wide code's, then the split's rows and
// pages
template <int DK, int DV, bool LATENT>
struct ChunkWide {
  static constexpr size_t BYTES =
      repro::WideSmem<DK, DV, LATENT>::BYTES + CSPLIT * 2 * sizeof(int);
};

template <typename KT, int DK, int DV, bool LATENT>
__global__ void __launch_bounds__(repro::WT_THREADS, 1)
chunk_wide_kernel(const __nv_bfloat16* __restrict__ q, KVArgs a,
                  const int* __restrict__ q_offset, const int* __restrict__ kv_len,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                  int* __restrict__ sem, int C, int G, int window, float scale,
                  int n_splits) {
  using CFG = ChunkWide<DK, DV, LATENT>;
  constexpr int NT = repro::WT_THREADS, KLD = DK + 8;
  extern __shared__ __align__(16) unsigned char sbuf[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(sbuf);
  int* rows = reinterpret_cast<int*>(sbuf + CFG::BYTES - CSPLIT * 2 * sizeof(int));
  int* pages = rows + CSPLIT;          // pool row of key, or -1; the split's pages

  const int split = blockIdx.x, rt = blockIdx.y;
  const int bh = blockIdx.z, b = bh / a.kv, h = bh - b * a.kv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = C * G, r0 = rt * CROWS, rn = min(CROWS, R - r0);
  const int live = min(kv_len[b], a.pps * a.ps), off = q_offset[b];
  const int i_first = r0 / G, i_last = (r0 + rn - 1) / G;
  const int blk_hi = min(off + i_last + 1, live);
  const int blk_lo = window > 0 ? max(0, off + i_first - window + 1) : 0;
  const int s0 = split * CSPLIT;
  if (blk_hi <= blk_lo) {         // no row of the tile has a valid key: zeros
    if (split == 0)
      for (int e = tid; e < rn * DV; e += NT)
        out[packed_row(b, h, r0 + e / DV, C, a.kv, G, DV) + e % DV] = __float2bfloat16(0.f);
    return;
  }
  if (s0 >= blk_hi || s0 + CSPLIT <= blk_lo) return;             // a dead split
  const int s_lo = blk_lo / CSPLIT, s_hi = (blk_hi + CSPLIT - 1) / CSPLIT;

  constexpr int QC = DK / 8;
  for (int c = tid; c < CROWS * QC; c += NT) {
    const int r = c / QC, cc = c - r * QC;
    const bool ok = r < rn;
    repro::cp_async16(qs + r * KLD + cc * 8,
                      ok ? q + packed_row(b, h, r0 + r, C, a.kv, G, DK) + cc * 8 : q,
                      ok ? 16 : 0);
  }
  repro::cp_async_commit();
  const int klo = max(s0, blk_lo), khi = min(s0 + CSPLIT, blk_hi);
  const int p_first = klo / a.ps, p_cnt = (khi - 1) / a.ps - p_first + 1;
  const int* pt = a.page_table + (size_t)b * a.pps;
  for (int t = tid; t < p_cnt; t += NT) pages[t] = pt[p_first + t];
  __syncthreads();
  for (int t = tid; t < CSPLIT; t += NT) {
    const int j = s0 + t;
    rows[t] = j >= klo && j < khi ? (pages[j / a.ps - p_first] * a.ps + j % a.ps) * a.kv + h
                                  : -1;
  }
  __syncthreads();                // the rows, before any tile is staged

  // this thread's rows: g and g + 8 of its pair's 16
  const int g = lane >> 2, wr = warp & 3;
  int rlo[2], rhi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + wr * repro::MT_ROWS + g + 8 * hh;
    rlo[hh] = 0;
    rhi[hh] = 0;
    if (r < R) {
      const int i = r / G;
      rhi[hh] = min(off + i + 1, live);
      rlo[hh] = window > 0 ? max(0, off + i - window + 1) : 0;
    }
  }
  ChunkWideSrc<KT, DK, DV, LATENT> src{static_cast<const KT*>(a.k),
                                       static_cast<const KT*>(a.v), a.ks, a.vs, rows, s0,
                                       klo, khi, tid};
  auto out_row = [&](int rl) { return out + packed_row(b, h, r0 + rl, C, a.kv, G, DV); };
  const size_t tile_rows = ((size_t)bh * gridDim.y + rt) * n_splits * CROWS;
  float* acc_t = part + tile_rows * DV;
  float2* ml_t = reinterpret_cast<float2*>(part + (size_t)gridDim.z * gridDim.y *
                                           n_splits * CROWS * DV) + tile_rows;
  repro::MmaRows<DV / 2> st;
  repro::fold_tiles_wide<DK, DV, LATENT>(st, sbuf, src, klo / CTK, (khi + CTK - 1) / CTK, rlo,
                                         rhi, scale * repro::LOG2E, tid, [](int) {});
  if (s_hi - s_lo == 1) {
    repro::write_rows_wide<DV>(st, out_row, rn, tid);
    return;
  }
  repro::store_split_wide<DV>(st, acc_t, ml_t, split, tid);
  if (!repro::last_split_done(sem + (size_t)bh * gridDim.y + rt, s_hi - s_lo)) return;
  repro::merge_splits_wide<DV>(acc_t, ml_t, s_lo, s_hi, rn, out_row, tid);
}

template <typename KT, int DK, int DV, bool LATENT>
int launch_wide(const void* q, const KVArgs& a, const void* q_offset, const void* kv_len,
                void* out, void* part, void* sem, int B, int C, int G, int window,
                float scale, int n_splits, cudaStream_t stream) {
  using CFG = ChunkWide<DK, DV, LATENT>;
  const int row_tiles = (C * G + CROWS - 1) / CROWS;
  if (n_splits != (a.pps * a.ps + CSPLIT - 1) / CSPLIT || part == nullptr || sem == nullptr ||
      row_tiles > 65535 || B * a.kv > 65535 || (LATENT && a.k != a.v))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = chunk_wide_kernel<KT, DK, DV, LATENT>;
  cudaError_t err = repro::allow_smem(kernel, CFG::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  // at least one split: its block writes the zeros of rows with no key
  kernel<<<dim3(max(n_splits, 1), row_tiles, B * a.kv), repro::WT_THREADS, CFG::BYTES,
           stream>>>(
      static_cast<const __nv_bfloat16*>(q), a, static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), static_cast<int*>(sem), C, G, window, scale, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT>
int dispatch_wide(const void* q, const KVArgs& a, const void* q_offset, const void* kv_len,
                  void* out, void* part, void* sem, int B, int C, int G, int DV, int window,
                  float scale, int n_splits, cudaStream_t s) {
#define WIDE(DK, DVV, LAT)                                                                  \
  return launch_wide<KT, DK, DVV, LAT>(q, a, q_offset, kv_len, out, part, sem, B, C, G,   \
                                       window, scale, n_splits, s)
  if (a.d == 576 && DV == 512) WIDE(576, 512, true);
  if (DV != a.d) return static_cast<int>(cudaErrorInvalidValue);
  switch (a.d) {
    case 160: WIDE(160, 160, false);
    case 192: WIDE(192, 192, false);
    case 224: WIDE(224, 224, false);
    case 256: WIDE(256, 256, false);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WIDE
}

template <typename KT>
int dispatch_mma(const void* q, const KVArgs& a, const void* q_offset, const void* kv_len,
                 void* out, void* part, void* sem, int B, int C, int G, int window,
                 float scale, int n_splits, cudaStream_t s) {
  switch (a.d) {
    case 32:
      return launch_mma<KT, 32>(q, a, q_offset, kv_len, out, part, sem, B, C, G, window,
                                scale, n_splits, s);
    case 64:
      return launch_mma<KT, 64>(q, a, q_offset, kv_len, out, part, sem, B, C, G, window,
                                scale, n_splits, s);
    case 96:
      return launch_mma<KT, 96>(q, a, q_offset, kv_len, out, part, sem, B, C, G, window,
                                scale, n_splits, s);
    case 128:
      return launch_mma<KT, 128>(q, a, q_offset, kv_len, out, part, sem, B, C, G, window,
                                 scale, n_splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// --------------------------------------------------------- CUDA-core path
template <typename KT>
int launch_fma(const void* q, const KVArgs& a, const void* q_offset,
               const void* kv_len, void* out, int B, int C, int G, int window,
               float scale, cudaStream_t stream) {
  const int D = a.d;
  const size_t smem = sizeof(float) * (NW * G * D + TK * (2 * D + 1));
  auto* kernel = chunk_attention_kernel<float, KT>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * a.kv, (C + NW - 1) / NW);
  kernel<<<grid, NW * 32, smem, stream>>>(
      static_cast<const float*>(q), a, static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), static_cast<float*>(out), C, G, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT>
int launch(int path, const void* q, const KVArgs& a, const void* q_offset, const void* kv_len,
           void* out, void* part, void* sem, int B, int C, int G, int DV, int window,
           float scale, int n_splits, cudaStream_t s) {
  if (path == 2)
    return dispatch_wide<KT>(q, a, q_offset, kv_len, out, part, sem, B, C, G, DV, window,
                             scale, n_splits, s);
  if (DV != a.d) return static_cast<int>(cudaErrorInvalidValue);
  if (path == 1)
    return dispatch_mma<KT>(q, a, q_offset, kv_len, out, part, sem, B, C, G, window, scale,
                            n_splits, s);
  if (G > repro::MAXG || a.d > 32 * repro::MAXE) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fma<KT>(q, a, q_offset, kv_len, out, B, C, G, window, scale, s);
}

}  // namespace

// q (B,C,KV,G,D); k/v pools (n_pages,ps,KV,D); ks/vs f16 scales for int8
// pools (nullptr otherwise); page_table (B,pps) int32; q_offset, kv_len (B,)
// int32; out (B,C,KV,G,DV) in q's type. DV == D, or (path 2) MLA latent
// rows: D 576, DV 512, k == v. path 1 (tensor cores, bf16 q, D a multiple
// of 32 up to 128) and path 2 (tensor cores, bf16 q, D 160-256 or latent;
// 8-warp blocks, each computing every output column of its row tile): part
// is f32 scratch of (B·KV, row tiles, n_splits, 64) rows of DV acc values,
// then as many (m, l) pairs, with n_splits = ceil(pps·ps / 128) and row
// tiles = ceil(C·G / 64); sem is B·KV·row tiles zeroed int32 (left zeroed);
// q, k and v 16-byte aligned. path 0 (CUDA cores, f32 q, G <= 8, D <= 128)
// takes no scratch. The wrapper's `chunk_plan` picks the path.
extern "C" int flash_attention_paged(const void* q, const void* k, const void* v,
                                     const void* ks, const void* vs,
                                     const void* page_table, const void* q_offset,
                                     const void* kv_len, void* out, void* part, void* sem,
                                     int B, int C, int KV, int G, int D, int DV, int pps,
                                     int ps, int window, float scale, int q_dtype,
                                     int kv_dtype, int path, int n_splits, void* stream) {
  KVArgs a{k, v, static_cast<const __half*>(ks), static_cast<const __half*>(vs),
           static_cast<const int*>(page_table), pps, ps, 0, KV, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((path == 0) != (q_dtype == repro::kF32) ||
      (q_dtype != repro::kF32 && q_dtype != repro::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path != 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (kv_dtype) {
    case repro::kF32:
      return launch<float>(path, q, a, q_offset, kv_len, out, part, sem, B, C, G, DV, window,
                           scale, n_splits, s);
    case repro::kBF16:
      return launch<__nv_bfloat16>(path, q, a, q_offset, kv_len, out, part, sem, B, C, G, DV,
                                   window, scale, n_splits, s);
    case repro::kI8:
      return launch<int8_t>(path, q, a, q_offset, kv_len, out, part, sem, B, C, G, DV, window,
                            scale, n_splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
