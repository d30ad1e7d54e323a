// Dense blockwise self-attention over (B, H, S, D).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_kernel). Query row i attends key j iff, with both positions counted from
// one origin, (not causal or j <= i) and (no window or i - j < window). The
// softmax is an f32 online softmax (running max m, sum l, accumulator acc,
// NEG_INF = -1e30 finite) and the output is acc / max(l, 1e-30) in q's type.
// Tiles that are dead under the causal or window mask are skipped. Any S is
// taken (the TPU kernel asserts S % block == 0): ragged tail tiles load as 0
// and are masked. Queries and keys may differ in number (Sq != Sk), as the
// TPU kernel's may: the encoder-decoder's cross attention reads Sk = 4096
// encoder rows from a chunk or a prompt. The wrapper sends such calls
// unmasked only (a causal mask over two lengths has no caller).
//
// Bound on the card: operations at the prefill shapes (a causal 1024-row
// prompt does ~1024²/2 pairs per head against ~8 MB of q/k/v/out), at the
// bf16 tensor-core rate for bf16 q.
//
// Three paths; the wrapper's `dense_plan` (kernels/flash_attention.py)
// picks (the third, for head_dim 160-256, runs attn_mma.cuh's wide code,
// as the chunk kernel does for the same rows: an 8-warp block per (row
// tile, batch·head) walks the row tile's 128-key splits, computes each
// score once and accumulates every output column, pairs of warps sharing
// P through shared memory, and merges the splits itself):
//
// - Tensor cores (bf16 q; path 1): the chunk kernel's design
//   (flash_attention_paged.cu) over contiguous K/V, so that a row of a dense
//   prefill and the same row of a chunked prefill run the same arithmetic
//   in the same order. A 4-warp block takes a row tile of 64 query rows
//   (one 16-row m-tile a warp) and one split of the key range: SPLIT = 128
//   keys at absolute positions, two 64-key tiles copied by 16-byte cp.async
//   (tile 1 in flight while tile 0 is in the mma.sync products). The grid
//   is (splits of S) x (row tiles, heaviest first) x (batch·head); a block
//   whose split misses its row tile's key range (causal or window dead)
//   exits at once. Unmasked, a row tile's splits are those of all Sk keys,
//   whatever Sq is, so a row's result depends on its query and the keys
//   only: a cross-attention row of a 64-row chunk equals the same row of a
//   prompt's call. With one live split the block writes the output;
//   otherwise each block stores its rows' (m, l, acc) to scratch the
//   wrapper allocated and the last block of the row tile, found on the
//   wrapper's zeroed semaphores, merges the live splits in split order, in
//   the same launch. The tile code, the merge and their numerics are
//   attn_mma.cuh's, shared with the chunk kernel: a row's sums run over
//   its own keys in an order fixed by their positions, so the first S'
//   rows at S equal a run at S', and a row equals the chunk kernel's row
//   over the same K/V values (f32 pools rounded to bf16, int8 pools as
//   bf16(q · s), which is what the dense prefill attends), bit for bit.
// - CUDA cores (f32 q; path 0): bf16 fragments would round f32 q beyond the
//   f32 tolerance. One 128-thread block per (batch·head, 16 query rows);
//   each warp holds four rows and keeps their m/l/acc in registers. The
//   block streams 32-key tiles of K and V into shared memory as f32; in the
//   score phase lane t owns key t of the tile, in the value phase lane l
//   owns output columns l, l+32, ...

#include "attn_mma.cuh"

namespace {

using repro::NEG_INF;
using repro::TK;

constexpr int FW = 4;            // warps per block
constexpr int FR = 4;            // query rows per warp
constexpr int BQ = FW * FR;      // query rows per block
constexpr int NT = FW * 32;      // threads per block

// Rows [j0, j0 + TK) of one (S, D) K and V slab into shared memory as f32:
// ktile padded to D + 1 columns (lane t reads row t without bank conflicts),
// vtile dense. Rows at or past S load as 0 (always masked). All loads of a
// thread go out before any store, so their latencies overlap.
template <typename T, int D>
__device__ __forceinline__ void load_kv(const T* __restrict__ k,
                                        const T* __restrict__ v, int j0, int S,
                                        float* ktile, float* vtile) {
  constexpr int PER = TK * D / NT;
  const size_t base = static_cast<size_t>(j0) * D;
  float kf[PER], vf[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * NT;
    const bool ok = j0 + i / D < S;
    kf[u] = ok ? repro::to_f(k[base + i]) : 0.f;
    vf[u] = ok ? repro::to_f(v[base + i]) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * NT;
    const int r = i / D, c = i - r * D;
    ktile[r * (D + 1) + c] = kf[u];
    vtile[i] = vf[u];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int causal, int window, float scale) {
  constexpr int E = D / 32;
  __shared__ __align__(16) float qs[BQ * D];
  __shared__ float ktile[TK * (D + 1)];
  __shared__ float vtile[TK * D];

  const int row0 = blockIdx.x * BQ;
  const size_t qoff = static_cast<size_t>(blockIdx.y) * Sq * D;
  const size_t koff = static_cast<size_t>(blockIdx.y) * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int idx = threadIdx.x; idx < BQ * D; idx += NT)
    qs[idx] = row0 + idx / D < Sq
        ? repro::to_f(q[qoff + static_cast<size_t>(row0) * D + idx]) : 0.f;

  // key range [lo, hi) of each of this warp's rows (empty past Sq)
  int lo[FR], hi[FR];
#pragma unroll
  for (int rr = 0; rr < FR; ++rr) {
    const int i = row0 + warp * FR + rr;
    hi[rr] = i < Sq ? (causal ? min(i + 1, Sk) : Sk) : 0;
    lo[rr] = window > 0 ? max(0, i - window + 1) : 0;
  }
  // the block's key range: the union of its rows' ranges
  const int last = min(Sq, row0 + BQ) - 1;
  const int blk_hi = causal ? min(last + 1, Sk) : Sk;
  const int blk_lo = window > 0 ? max(0, row0 - window + 1) : 0;
  __syncthreads();

  float m[FR], l[FR], acc[FR][E];
#pragma unroll
  for (int rr = 0; rr < FR; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[rr][e] = 0.f;
  }
  const float* qw = qs + warp * FR * D;
  const float* krow = ktile + lane * (D + 1);

  for (int j0 = blk_lo - blk_lo % TK; j0 < blk_hi; j0 += TK) {
    load_kv<T, D>(k + koff, v + koff, j0, Sk, ktile, vtile);
    __syncthreads();
    // scores of key j0 + lane against the warp's rows
    float s[FR];
#pragma unroll
    for (int rr = 0; rr < FR; ++rr) s[rr] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float k0 = krow[c], k1 = krow[c + 1], k2 = krow[c + 2], k3 = krow[c + 3];
#pragma unroll
      for (int rr = 0; rr < FR; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + rr * D + c);
        s[rr] = fmaf(qv.x, k0, s[rr]);
        s[rr] = fmaf(qv.y, k1, s[rr]);
        s[rr] = fmaf(qv.z, k2, s[rr]);
        s[rr] = fmaf(qv.w, k3, s[rr]);
      }
    }
    const int j = j0 + lane;
    float p[FR];
#pragma unroll
    for (int rr = 0; rr < FR; ++rr) {
      p[rr] = 0.f;
      if (j0 < hi[rr] && j0 + TK > lo[rr]) {        // warp-uniform
        const bool valid = j >= lo[rr] && j < hi[rr];
        const float sv = valid ? s[rr] * scale : NEG_INF;
        const float m_new = fmaxf(m[rr], repro::warp_max(sv));
        // a live tile holds at least one valid key of the row, so m_new is
        // finite; masked keys contribute exactly 0
        p[rr] = valid ? expf(sv - m_new) : 0.f;
        const float corr = expf(m[rr] - m_new);
        l[rr] = l[rr] * corr + repro::warp_sum(p[rr]);
        m[rr] = m_new;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[rr][e] *= corr;
      }
    }
#pragma unroll 4
    for (int t = 0; t < TK; ++t) {
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = vtile[t * D + lane + 32 * e];
#pragma unroll
      for (int rr = 0; rr < FR; ++rr) {
        const float pt = __shfl_sync(0xffffffffu, p[rr], t);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[rr][e] = fmaf(pt, vv[e], acc[rr][e]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < FR; ++rr) {
    const int i = row0 + warp * FR + rr;
    if (i >= Sq) continue;
    const float lr = fmaxf(l[rr], 1e-30f);
    T* o = out + qoff + static_cast<size_t>(i) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) o[lane + 32 * e] = repro::from_f<T>(acc[rr][e] / lr);
  }
}

// ------------------------------------------------------ tensor-core path
constexpr int MW = repro::MT_WARPS;          // warps a block: one m-tile each
constexpr int MQ = repro::MT_BLOCK_ROWS;     // query rows a block
constexpr int MKT = repro::MT_KEYS;          // keys per K/V tile
constexpr int MSPLIT = repro::MT_SPLIT;      // keys per split (kernels/flash_attention.py)
constexpr int MTILES = MSPLIT / MKT;
constexpr int MTH = MW * 32;                 // threads per block
static_assert(MTILES == 2, "two tiles a split, as the chunk kernel");

template <int D>
struct MmaTile {
  static constexpr int LD = D + 8;           // bf16 a row in shared memory: the
                                             // 8 rows of an ldmatrix on distinct banks
  static constexpr size_t SMEM =             // Q, then the split's K and V tiles
      sizeof(__nv_bfloat16) * ((size_t)MQ * LD + (size_t)MTILES * 2 * MKT * LD);
};

// One block per (split, row tile, batch·head). part holds, per (batch·head,
// row tile, split, row of the tile), the row's acc[D], then all (m, l)
// pairs; sem one counter per (batch·head, row tile).
template <int D>
__global__ void __launch_bounds__(MTH)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ part, int* __restrict__ sem, int Sq, int Sk,
                 int causal, int window, float scale, int n_splits) {
  constexpr int LD = MmaTile<D>::LD;
  constexpr int CPR = D / 8;                                 // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // MQ x LD
  __nv_bfloat16* ring = qs + MQ * LD;                        // [tile](K, V) MKT x LD
  const int split = blockIdx.x, rt = gridDim.y - 1 - blockIdx.y;   // heaviest row tile first
  const int bh = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = rt * MQ, rn = min(MQ, Sq - row0);
  const size_t base = (size_t)bh * Sq * D, kbase = (size_t)bh * Sk * D;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* kb = k + kbase;
  const __nv_bfloat16* vb = v + kbase;
  // the row tile's key range: the union of its rows' ranges
  const int blk_hi = causal ? row0 + rn : Sk;
  const int blk_lo = window > 0 ? max(0, row0 - window + 1) : 0;
  const int s0 = split * MSPLIT;
  if (s0 >= blk_hi || s0 + MSPLIT <= blk_lo) return;          // a dead split
  const int s_lo = blk_lo / MSPLIT, s_hi = (blk_hi + MSPLIT - 1) / MSPLIT;

  for (int c = tid; c < MQ * CPR; c += MTH) {
    const int r = c / CPR, cc = c - r * CPR;
    const bool ok = r < rn;
    repro::cp_async16(qs + r * LD + cc * 8, ok ? qb + (size_t)(row0 + r) * D + cc * 8 : qb,
                      ok ? 16 : 0);
  }
  repro::cp_async_commit();
  // both tiles of the split; keys outside the block's [klo, khi) are 0
  const int klo = max(s0, blk_lo), khi = min(s0 + MSPLIT, blk_hi);
#pragma unroll
  for (int i = 0; i < MTILES; ++i) {
    const int j0 = s0 + i * MKT;
    if (j0 < khi && j0 + MKT > klo) {
      __nv_bfloat16* kt = ring + (size_t)i * 2 * MKT * LD;
      __nv_bfloat16* vt = kt + MKT * LD;
      for (int c = tid; c < MKT * CPR; c += MTH) {
        const int r = c / CPR, cc = c - r * CPR, j = j0 + r;
        const bool ok = j >= klo && j < khi;
        const size_t off = ok ? (size_t)j * D + cc * 8 : 0;
        repro::cp_async16(kt + r * LD + cc * 8, kb + off, ok ? 16 : 0);
        repro::cp_async16(vt + r * LD + cc * 8, vb + off, ok ? 16 : 0);
      }
    }
    repro::cp_async_commit();
  }

  // this thread's rows g and g + 8 of its m-tile: key range [lo, hi)
  const int g = lane >> 2;
  int rlo[2], rhi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + warp * repro::MT_ROWS + g + 8 * h;
    rhi[h] = i < Sq ? (causal ? i + 1 : Sk) : 0;
    rlo[h] = window > 0 ? max(0, i - window + 1) : 0;
  }
  repro::MmaRows<D> st;
  repro::init_rows(st);
  unsigned qa[D / 16][4];
#pragma unroll
  for (int i = 0; i < MTILES; ++i) {
    if (i == 0) repro::cp_async_wait<MTILES - 1>();
    else repro::cp_async_wait<0>();
    __syncthreads();              // tile i (and Q) landed
    if (i == 0) repro::load_q_frags<D>(qa, qs + warp * repro::MT_ROWS * LD, LD, lane);
    const int j0 = s0 + i * MKT;
    if (!(j0 < khi && j0 + MKT > klo)) continue;                  // block-uniform
    const __nv_bfloat16* kt = ring + (size_t)i * 2 * MKT * LD;
    const int lo[2] = {rlo[0] - j0, rlo[1] - j0}, hi[2] = {rhi[0] - j0, rhi[1] - j0};
    repro::fold_tile_auto<D>(st, qa, kt, kt + MKT * LD, LD, lo, hi, scale * repro::LOG2E,
                             lane);
  }

  auto out_row = [&](int rl) { return out + base + (size_t)(row0 + rl) * D; };
  if (s_hi - s_lo == 1) {         // one live split: the block writes the output
    repro::write_rows<D>(st, out_row, rn, warp, lane);
    return;
  }
  const size_t tile_rows = ((size_t)bh * gridDim.y + rt) * n_splits * MQ;
  float* acc_t = part + tile_rows * D;                         // [split][row][D]
  float2* ml_t = reinterpret_cast<float2*>(part + (size_t)gridDim.z * gridDim.y *
                                           n_splits * MQ * D) + tile_rows;  // [split][row]
  repro::store_split<D>(st, acc_t, ml_t, split, warp, lane);
  if (!repro::last_split_done(sem + (size_t)bh * gridDim.y + rt, s_hi - s_lo)) return;
  repro::merge_splits<D>(acc_t, ml_t, s_lo, s_hi, rn, out_row, tid);
}

// Wide rows (head_dim 160-256): attn_mma.cuh's wide code over contiguous
// bf16 K/V. One 8-warp block per (batch·head, row tile), the heaviest row
// tiles of every head first, walks the row tile's splits in order: Q is
// loaded once, K and V tiles go through a two-stage cp.async ring, the
// next tile in flight while one is in the products, across split edges
// too; every split starts
// from a fresh state and stores its (m, l, acc) to scratch as the chunk
// kernel's split blocks do (the last split to the freed ring instead), and
// the block merges them in split order as `merge_splits_wide` does, so a
// row equals the chunk kernel's row.
template <int D>
struct DenseWideSrc {
  const __nv_bfloat16* kb;
  const __nv_bfloat16* vb;
  int klo, khi, tid;
  // keys [j0, j0 + MKT) of src into a tile, 0 outside [klo, khi)
  __device__ __forceinline__ void copy(const __nv_bfloat16* src, int j0, __nv_bfloat16* dst) {
    constexpr int CPR = D / 8, LD = D + 8;
    for (int c = tid; c < MKT * CPR; c += repro::WT_THREADS) {
      const int r = c / CPR, cc = c - r * CPR, j = j0 + r;
      const bool ok = j >= klo && j < khi;
      repro::cp_async16(dst + r * LD + cc * 8, src + (ok ? (size_t)j * D + cc * 8 : 0),
                        ok ? 16 : 0);
    }
  }
  __device__ __forceinline__ void copy_k(int j0, __nv_bfloat16* kt) { copy(kb, j0, kt); }
  __device__ __forceinline__ void copy_v(int j0, __nv_bfloat16* vt) { copy(vb, j0, vt); }
};

template <int D>
__global__ void __launch_bounds__(repro::WT_THREADS, 1)
flash_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ part, int Sq, int Sk, int causal, int window,
                  float scale, int n_splits) {
  using SM = repro::WideSmem<D, D, false>;
  constexpr int KLD = SM::KLD, CPR = D / 8, NT = repro::WT_THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int rt = gridDim.y - 1 - blockIdx.y;        // heaviest row tiles first
  const int bh = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int row0 = rt * MQ, rn = min(MQ, Sq - row0);
  const size_t base = (size_t)bh * Sq * D, kbase = (size_t)bh * Sk * D;
  const __nv_bfloat16* qb = q + base;
  const int blk_hi = causal ? row0 + rn : Sk;
  const int blk_lo = window > 0 ? max(0, row0 - window + 1) : 0;
  const int s_lo = blk_lo / MSPLIT, s_hi = (blk_hi + MSPLIT - 1) / MSPLIT;

  for (int c = tid; c < MQ * CPR; c += NT) {
    const int r = c / CPR, cc = c - r * CPR;
    const bool ok = r < rn;
    repro::cp_async16(qs + r * KLD + cc * 8, ok ? qb + (size_t)(row0 + r) * D + cc * 8 : qb,
                      ok ? 16 : 0);
  }
  repro::cp_async_commit();
  const int g = lane >> 2, pair = (tid >> 5) & 3;
  int rlo[2], rhi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + pair * repro::MT_ROWS + g + 8 * h;
    rhi[h] = i < Sq ? (causal ? i + 1 : Sk) : 0;
    rlo[h] = window > 0 ? max(0, i - window + 1) : 0;
  }
  DenseWideSrc<D> src{k + kbase, v + kbase, blk_lo, blk_hi, tid};
  auto out_row = [&](int rl) { return out + base + (size_t)(row0 + rl) * D; };
  const size_t tile_rows = ((size_t)bh * gridDim.y + rt) * n_splits * MQ;
  float* acc_t = part + tile_rows * D;
  float2* ml_t = reinterpret_cast<float2*>(part + (size_t)gridDim.x * gridDim.y *
                                           n_splits * MQ * D) + tile_rows;
  // the last split's (m, l, acc) go to the ring, free once its last tile is
  // folded: rows of D + 4 floats, then the rows' (m, l)
  float* accs = reinterpret_cast<float*>(smem + SM::Q);
  float2* mls = reinterpret_cast<float2*>(accs + MQ * (D + 4));
  static_assert(MQ * (D + 4) * 4 + MQ * 8 <= SM::RING, "the last split fits the ring");
  repro::MmaRows<D / 2> st;
  // each split's (m, l, acc) as the chunk kernel's split blocks store
  // theirs (the last one in shared memory), then the same merge; one live
  // split writes the output
  auto done = [&](int split) {
    if (s_hi - s_lo == 1) {
      repro::write_rows_wide<D>(st, out_row, rn, tid);
    } else if (split + 1 < s_hi) {
      repro::store_split_wide<D>(st, acc_t, ml_t, split, tid);
    } else {
      const int warp = tid >> 5, t4 = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = pair * repro::MT_ROWS + g + 8 * h;
        if (t4 == 0 && warp < 4) mls[rl] = make_float2(st.m[h], st.l[h]);
        float* rec = accs + rl * (D + 4) + (warp >> 2) * (D / 2) + 2 * t4;
#pragma unroll
        for (int n = 0; n < D / 16; ++n)
          *reinterpret_cast<float2*>(rec + 8 * n) = make_float2(st.o[n][2 * h], st.o[n][2 * h + 1]);
      }
    }
  };
  repro::fold_tiles_wide<D, D, false>(st, smem, src, blk_lo / MKT, (blk_hi + MKT - 1) / MKT,
                                      rlo, rhi, scale * repro::LOG2E, tid, done);
  if (s_hi - s_lo == 1) return;
  __syncthreads();                // the block's own partials
  const int s_last = s_hi - 1;
  auto ml = [&](int sp, int r) {
    return sp == s_last ? mls[r] : __ldcg(&ml_t[(size_t)sp * MQ + r]);
  };
  auto acc4 = [&](int sp, int r, int c) {
    return sp == s_last
        ? *reinterpret_cast<const float4*>(accs + r * (D + 4) + c)
        : __ldcg(reinterpret_cast<const float4*>(acc_t + ((size_t)sp * MQ + r) * D + c));
  };
  repro::merge_rows_wide<D>(ml, acc4, s_lo, s_hi, rn, out_row, tid);
}

template <int D>
int launch_wide(const void* q, const void* k, const void* v, void* out, void* part,
                int BH, int Sq, int Sk, int causal, int window, float scale, int n_splits,
                cudaStream_t stream) {
  using SM = repro::WideSmem<D, D, false>;
  const int tiles = (Sq + MQ - 1) / MQ;
  if (tiles > 65535 || n_splits != (Sk + MSPLIT - 1) / MSPLIT || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = flash_wide_kernel<D>;
  cudaError_t err = repro::allow_smem(kernel, SM::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(BH, tiles), repro::WT_THREADS, SM::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), Sq, Sk, causal, window, scale, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, void* part, void* sem,
               int BH, int Sq, int Sk, int causal, int window, float scale, int n_splits,
               cudaStream_t stream) {
  const int tiles = (Sq + MQ - 1) / MQ;
  if (tiles > 65535 || BH > 65535 || n_splits != (Sk + MSPLIT - 1) / MSPLIT ||
      part == nullptr || sem == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = flash_mma_kernel<D>;
  cudaError_t err = repro::allow_smem(kernel, MmaTile<D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_splits, tiles, BH), MTH, MmaTile<D>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), static_cast<int*>(sem), Sq, Sk, causal, window, scale,
      n_splits);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------- CUDA-core path
template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* out, int BH, int Sq,
               int Sk, int causal, int window, float scale, cudaStream_t stream) {
  if (BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_kernel<float, D><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Sk, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int path, const void* q, const void* k, const void* v, void* out, void* part,
           void* sem, int BH, int Sq, int Sk, int causal, int window, float scale,
           int n_splits, cudaStream_t s) {
  if (causal && Sq != Sk) return static_cast<int>(cudaErrorInvalidValue);
  if (path == 1)
    return launch_mma<D>(q, k, v, out, part, sem, BH, Sq, Sk, causal, window, scale, n_splits,
                         s);
  if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fma<D>(q, k, v, out, BH, Sq, Sk, causal, window, scale, s);
}

template <int D>
int launch_wide_path(int path, const void* q, const void* k, const void* v, void* out,
                     void* part, void* sem, int BH, int Sq, int Sk, int causal, int window,
                     float scale, int n_splits, cudaStream_t s) {
  if (path != 2 || (causal && Sq != Sk)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wide<D>(q, k, v, out, part, BH, Sq, Sk, causal, window, scale, n_splits, s);
}

}  // namespace

// q (BH, Sq, D), k/v (BH, Sk, D), out (BH, Sq, D), all contiguous and
// 16-byte aligned in one type; D a multiple of 32 up to 256; Sq == Sk when
// causal. path 1: tensor cores, bf16, D <= 128 (at most 65535 row tiles of
// 64 query rows and BH <= 65535), n_splits = ceil(Sk / 128), part f32
// scratch of (BH, row tiles, n_splits, 64) rows of D acc values, then as
// many (m, l) pairs, and
// sem BH · row tiles zeroed int32 (left zeroed); path 2: D 160-256, the
// same scratch, no semaphores (one 8-warp block a row tile walks its
// splits); path 0: CUDA cores, f32, D <= 128 (BH <= 65535), no
// scratch. The wrapper's `dense_plan` picks the path.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* part, void* sem, int BH, int Sq, int Sk,
                               int D, int causal, int window, float scale, int dtype,
                               int path, int n_splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((path == 0) != (dtype == repro::kF32) || (dtype != repro::kF32 && dtype != repro::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq == 0 || BH == 0) return 0;
  switch (D) {
    case 32:
      return launch<32>(path, q, k, v, out, part, sem, BH, Sq, Sk, causal, window, scale,
                        n_splits, s);
    case 64:
      return launch<64>(path, q, k, v, out, part, sem, BH, Sq, Sk, causal, window, scale,
                        n_splits, s);
    case 96:
      return launch<96>(path, q, k, v, out, part, sem, BH, Sq, Sk, causal, window, scale,
                        n_splits, s);
    case 128:
      return launch<128>(path, q, k, v, out, part, sem, BH, Sq, Sk, causal, window, scale,
                        n_splits, s);
    case 160:
      return launch_wide_path<160>(path, q, k, v, out, part, sem, BH, Sq, Sk, causal,
                                       window, scale, n_splits, s);
    case 192:
      return launch_wide_path<192>(path, q, k, v, out, part, sem, BH, Sq, Sk, causal,
                                       window, scale, n_splits, s);
    case 224:
      return launch_wide_path<224>(path, q, k, v, out, part, sem, BH, Sq, Sk, causal,
                                        window, scale, n_splits, s);
    case 256:
      return launch_wide_path<256>(path, q, k, v, out, part, sem, BH, Sq, Sk, causal,
                                        window, scale, n_splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
