// Single-query (decode) GQA attention against a ragged KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (_body, _make_kernel; dense and paged pallas_calls). All four variants:
// {dense (B,Smax,KV,D) cache, paged (n_pages,ps,KV,D) pool through a
// (B,pages_per_seq) table} x {float (f32/bf16) cache, int8 cache with f16
// per-(row, kv head) scales, dequantized on the shared-memory -> register
// step}; and fp8 (e5m2) caches, upcast exactly in the load, which the JAX
// package reads only through its jnp path. Up to 8 query heads a kv head
// and head_dim 128 run the narrow kernel below; more heads (up to 16),
// head_dim up to 256 and MLA latent rows (one pool as K and V, values its
// rows' first DV columns) the wide kernel further down.
//
// Bound on the card: bytes. Each step reads every live K/V row once, in its
// storage type (the q·k and p·v work is 4·G·D flops per row, far below the
// tensor cores' line at G = 3), so the design is about parallelism and
// memory-level parallelism, not tensor cores. The page table is read by the
// kernel itself, with no dense gather.
//
// Design: split-KV (flash-decoding) with a FIXED split of SPLIT = 256 keys.
// The grid is (splits of the cache's depth) x (sequence, kv head); a block
// whose split lies outside [kv_len - window, kv_len) exits at once. Each of
// its 4 warps takes two 32-key tiles (warp w: tiles w and w + 4 of the
// split), both copied at once by 16-byte cp.async into a per-warp ring of
// two stages (one where two do not fit in shared memory: f32 rows of 128),
// so the second tile is in flight while the first is scored. A tile of a
// page-32 pool lies in one page: its table entry is read once. Each warp
// keeps an f32 online softmax for the G query heads of its kv head (the
// value phase reads the tile's probabilities four keys at a time from
// shared memory). The block merges its warps in warp order and writes the
// split's (m, l, acc) to scratch the wrapper allocated; the last live split
// of the sequence to finish (an atomic count per (sequence, kv head))
// merges the live splits in split-index order into the output. So it is one
// launch: a second kernel would cost ~5 µs of device time on the H100.
// The split length is a constant, so a sequence's output does not depend
// on the batch it is decoded in, and the dense and paged layouts, which
// load the same rows in the same tile order, give bit-identical outputs.

#include <type_traits>

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

using repro::KVArgs;
using repro::MAXE;
using repro::MAXG;
using repro::NEG_INF;

constexpr int DW = 4;                      // warps per block
constexpr int DTK = 32;                    // keys per tile: one per lane
constexpr int SPLIT = 256;                 // keys per split (kernels/decode_attention.py)
constexpr int TPW = SPLIT / DTK / DW;      // tiles per warp
constexpr int SMEM_MAX = 232448;           // a block's shared memory on Hopper
static_assert(TPW == 2, "the ring below is written for two tiles per warp");
constexpr unsigned FULL = 0xffffffffu;

// Row index (in units of D elements) of this lane's key j0 + lane of (b, h),
// for a live tile [j0, j0 + 32) of a sequence with hi live rows.
__device__ __forceinline__ size_t tile_row(const KVArgs& a, int b, int h, int j0,
                                           int hi, int lane) {
  const int j = j0 + lane;
  if (a.page_table == nullptr) return ((size_t)b * a.smax + j) * a.kv + h;
  const int* pt = a.page_table + (size_t)b * a.pps;
  int page;
  if (a.ps % DTK == 0) {          // the tile lies in one page: one table read
    int p0 = 0;
    if (lane == 0) p0 = pt[j0 / a.ps];
    page = __shfl_sync(FULL, p0, 0);
  } else {
    page = j < hi ? pt[j / a.ps] : 0;
  }
  return ((size_t)page * a.ps + (j % a.ps)) * a.kv + h;
}

// 16 bytes of a cache row, widened to f32
template <typename KT>
__device__ __forceinline__ void widen16(const uint4 v, float* f) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (std::is_same<KT, float>::value) {
#pragma unroll
    for (int u = 0; u < 4; ++u) f[u] = __uint_as_float(w[u]);
  } else if constexpr (std::is_same<KT, __nv_bfloat16>::value) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      f[2 * u] = __uint_as_float(w[u] << 16);
      f[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
    }
  } else if constexpr (std::is_same<KT, repro::e5m2>::value) {
#pragma unroll
    for (int u = 0; u < 16; ++u) f[u] = repro::e5m2_to_f((w[u >> 2] >> (8 * (u & 3))) & 0xffu);
  } else {
#pragma unroll
    for (int u = 0; u < 16; ++u) f[u] = repro::i8_at(w[u >> 2], u & 3);
  }
}

// ... of a row in shared memory
template <typename KT>
__device__ __forceinline__ void widen16(const unsigned char* p, float* f) {
  widen16<KT>(*reinterpret_cast<const uint4*>(p), f);
}

// Fold one tile (keys j0 + lane; K and V rows of RS bytes in shared memory)
// into the warp's state. `valid`: this lane's key is in [lo, hi); its rows
// were zero-filled otherwise. ksc/vsc: this lane's row scales (int8 caches;
// 0 for an invalid key). pw: the warp's (G + 1) x 32 floats, where the
// tile's probabilities and V scales are handed to the value phase.
template <typename KT>
__device__ __forceinline__ void fold_tile(repro::RowState& st, const float* qs,
                                          const unsigned char* kt,
                                          const unsigned char* vt, float* pw, int RS,
                                          int G, int D, bool valid, float ksc, float vsc,
                                          int lane) {
  constexpr bool I8 = std::is_same<KT, int8_t>::value;
  constexpr int VEC = 16 / sizeof(KT);
  const int E = D / 32;
  float s[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
  const unsigned char* krow = kt + lane * RS;
  for (int c = 0; c < D; c += VEC) {
    float kf[VEC];
    widen16<KT>(krow + c * sizeof(KT), kf);
    if constexpr (I8) {
#pragma unroll
      for (int u = 0; u < VEC; ++u) kf[u] *= ksc;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float* qg = qs + g * D + c;
#pragma unroll
        for (int u = 0; u < VEC; ++u) s[g] = fmaf(qg[u], kf[u], s[g]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      const float sv = valid ? s[g] : NEG_INF;
      const float m_new = fmaxf(st.m[g], repro::warp_max(sv));
      // masked keys contribute exactly 0 (a row with no valid key so far
      // keeps m == NEG_INF, and exp(NEG_INF - NEG_INF) would be 1)
      const float p = valid ? expf(sv - m_new) : 0.f;
      const float corr = expf(st.m[g] - m_new);
      st.l[g] = st.l[g] * corr + repro::warp_sum(p);
      st.m[g] = m_new;
#pragma unroll
      for (int e = 0; e < MAXE; ++e) st.acc[g][e] *= corr;
      pw[g * DTK + lane] = p;
    }
  }
  if constexpr (I8) pw[G * DTK + lane] = vsc;
  __syncwarp();
  // value phase: lane owns columns lane + 32e; keys in order, four at a time
#pragma unroll 2
  for (int t = 0; t < DTK; t += 4) {
    float vv[4][MAXE];
    const float4 vs4 = I8 ? *reinterpret_cast<const float4*>(pw + G * DTK + t)
                          : make_float4(1.f, 1.f, 1.f, 1.f);
    const float vsu[4] = {vs4.x, vs4.y, vs4.z, vs4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const KT* vrow = reinterpret_cast<const KT*>(vt + (t + u) * RS);
#pragma unroll
      for (int e = 0; e < MAXE; ++e) {
        vv[u][e] = 0.f;
        if (e < E) {
          vv[u][e] = repro::to_f(vrow[lane + 32 * e]);
          if (I8) vv[u][e] *= vsu[u];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + g * DTK + t);
        const float pu[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < MAXE; ++e) st.acc[g][e] = fmaf(pu[u], vv[u][e], st.acc[g][e]);
      }
    }
  }
}

__device__ __forceinline__ void live_range(const KVArgs& a, int len, int window,
                                           int& lo, int& hi) {
  const int cap = a.page_table != nullptr ? a.pps * a.ps : a.smax;
  hi = min(len, cap);
  lo = window > 0 ? max(0, len - window) : 0;
}

// One block per (split, sequence · kv head): (m, l, acc) of the split's live
// keys for the G query heads into part[(b·KV + h), split, g, 0..D+1]; the
// last live split of (b, h) to finish merges them all into out.
template <typename QT, typename KT>
__global__ void __launch_bounds__(DW * 32)
decode_split_kernel(const QT* __restrict__ q, KVArgs a, const int* __restrict__ kv_len,
                    QT* __restrict__ out, float* __restrict__ part, int* __restrict__ sem,
                    int G, int window, float scale, int n_splits, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int QPT = MAXG * MAXE * 32 / (DW * 32);          // q values a thread
  const int D = a.d;
  const int split = blockIdx.x, bh = blockIdx.y, b = bh / a.kv, h = bh % a.kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  QT* ob = out + (size_t)bh * G * D;
  int lo, hi;
  live_range(a, kv_len[b], window, lo, hi);
  const int s0 = split * SPLIT;
  if (hi <= lo) {               // no live key (kv_len == 0): the output is 0
    if (split == 0)
      for (int i = threadIdx.x; i < G * D; i += blockDim.x) ob[i] = repro::from_f<QT>(0.f);
    return;
  }
  if (s0 >= hi || s0 + SPLIT <= lo) return;                   // a dead split

  float* qs = reinterpret_cast<float*>(smem);                 // G x D, scaled
  float* comb = qs + G * D;                                   // DW x G x (m, l, D acc)
  float* pw = comb + DW * G * (D + 2) + warp * (G + 1) * DTK;  // the warp's p, V scales
  const int RS = D * (int)sizeof(KT) + 16;                    // padded row bytes
  const int CPR = D * (int)sizeof(KT) / 16;                   // 16-byte chunks a row
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(comb + DW * G * (D + 2) + DW * (G + 1) * DTK) +
      (size_t)warp * stages * 2 * DTK * RS;

  // q (at most 1024 values over 128 threads) in flight with the table reads
  const QT* qb = q + (size_t)bh * G * D;
  float qv[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int i = threadIdx.x + u * DW * 32;
    qv[u] = i < G * D ? repro::to_f(qb[i]) : 0.f;
  }

  // this warp's tiles: which are live, this lane's row, key and scales
  bool live[TPW], ok[TPW];
  size_t row[TPW];
  float ksc[TPW], vsc[TPW];
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int j0 = s0 + (warp + DW * i) * DTK, j = j0 + lane;
    live[i] = j0 < hi && j0 + DTK > lo;
    ok[i] = live[i] && j >= lo && j < hi;
    row[i] = live[i] ? tile_row(a, b, h, j0, hi, lane) : 0;
    ksc[i] = vsc[i] = 0.f;
    if (a.ks != nullptr && ok[i]) {
      ksc[i] = __half2float(a.ks[row[i]]);
      vsc[i] = __half2float(a.vs[row[i]]);
    }
  }
  // copy tile i's K and V rows into ring slot `slot`; keys outside
  // [lo, hi) are zero-filled
  auto issue = [&](int i, int slot) {
    unsigned char* kt = ring + (size_t)slot * 2 * DTK * RS;
    unsigned char* vt = kt + DTK * RS;
    const char* K = static_cast<const char*>(a.k);
    const char* V = static_cast<const char*>(a.v);
    const size_t rb = (size_t)D * sizeof(KT);
    for (int c = lane; c < DTK * CPR; c += 32) {
      const int r = c / CPR, cc = c - r * CPR;
      const size_t rr = __shfl_sync(FULL, (unsigned long long)row[i], r);
      const int okr = __shfl_sync(FULL, (int)ok[i], r);
      repro::cp_async16(kt + r * RS + cc * 16, okr ? K + rr * rb + cc * 16 : K, okr ? 16 : 0);
      repro::cp_async16(vt + r * RS + cc * 16, okr ? V + rr * rb + cc * 16 : V, okr ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    if (i < stages && live[i]) issue(i, i);
    repro::cp_async_commit();
  }
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int i = threadIdx.x + u * DW * 32;
    if (i < G * D) qs[i] = qv[u] * scale;
  }
  __syncthreads();

  repro::RowState st;
  repro::init_state(st);
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    if (stages == 2 && i == 0) repro::cp_async_wait<1>();
    else repro::cp_async_wait<0>();
    __syncwarp();
    if (live[i]) {
      const unsigned char* kt = ring + (size_t)(i % stages) * 2 * DTK * RS;
      fold_tile<KT>(st, qs, kt, kt + DTK * RS, pw, RS, G, D, ok[i], ksc[i], vsc[i], lane);
    }
    __syncwarp();
    if (stages == 1 && i + 1 < TPW) {     // one stage: refill it now
      if (live[i + 1]) issue(i + 1, 0);
      repro::cp_async_commit();
    }
  }

  // merge the DW warps' (m, l, acc) in warp order into the split's partial
  const int E = D / 32;
  float* cw = comb + warp * G * (D + 2);
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      if (lane == 0) {
        cw[g * (D + 2)] = st.m[g];
        cw[g * (D + 2) + 1] = st.l[g];
      }
#pragma unroll
      for (int e = 0; e < MAXE; ++e)
        if (e < E) cw[g * (D + 2) + 2 + lane + 32 * e] = st.acc[g][e];
    }
  }
  __syncthreads();
  float* pbh = part + (size_t)bh * n_splits * G * (D + 2);
  float* pb = pbh + (size_t)split * G * (D + 2);
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, c = i - g * D;
    float m = NEG_INF;
    for (int w = 0; w < DW; ++w) m = fmaxf(m, comb[(w * G + g) * (D + 2)]);
    float l = 0.f, acc = 0.f;
    for (int w = 0; w < DW; ++w) {
      const float* cg = comb + (w * G + g) * (D + 2);
      const float f = expf(cg[0] - m);
      l += cg[1] * f;
      acc += cg[2 + c] * f;
    }
    pb[g * (D + 2) + 2 + c] = acc;
    if (c == 0) {
      pb[g * (D + 2)] = m;
      pb[g * (D + 2) + 1] = l;
    }
  }

  // the last live split of (b, h) to finish merges the live splits in
  // split-index order, in the same (m, l, acc) algebra
  const int s_lo = lo / SPLIT, s_hi = (hi + SPLIT - 1) / SPLIT;
  if (!repro::last_split_done(sem + bh, s_hi - s_lo)) return;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, c = i - g * D;
    float m = NEG_INF;
    for (int sp = s_lo; sp < s_hi; ++sp) m = fmaxf(m, __ldcg(pbh + (sp * G + g) * (D + 2)));
    float l = 0.f, acc = 0.f;
    for (int sp = s_lo; sp < s_hi; ++sp) {
      const float* cg = pbh + (sp * G + g) * (D + 2);
      const float f = expf(__ldcg(cg) - m);
      l += __ldcg(cg + 1) * f;
      acc += __ldcg(cg + 2 + c) * f;
    }
    ob[i] = repro::from_f<QT>(acc / fmaxf(l, 1e-30f));
  }
}

// ------------------------------------------------------------- wide path
// More than MAXG query heads a kv head (up to 16), head_dim above 32 · MAXE,
// or MLA latent rows (one pool read as both K and V, keys D = 576 wide and
// values their first DV = 512 columns). One block per (split, sequence · kv
// head) holds every query head, so each K/V row of a split is read from
// device memory once, and every warp folds keys at any G: four warps at
// one head, eight at more. The split's 256 keys go in rounds of RK = 32, 64
// or 128 keys (the most whose rows two stages hold in shared memory: 32 for
// f32 rows of 256, 128 for int8 rows), copied by 16-byte cp.async into a
// two-stage ring, so the next round is in flight while the current one is
// folded. In a round warp w takes the round's w-th share of the keys.
// - Scores: four lanes a key, eight keys at a time. A lane reads every
//   fourth 16-byte piece of its key's K row from shared memory, widens it
//   to f32 (int8 × the row's scale, e5m2 exactly), takes its dot product
//   with each head's q (f32, pre-scaled, in shared memory) and adds it to
//   the head's sum; two xor shuffles add the four lanes' sums (the same
//   bits in each).
// - Softmax: the block keeps one online softmax a head. Each warp posts its
//   keys' maximum and then its sum of p = exp(s - m_new) to shared memory,
//   and every warp combines them in warp order, so the block holds one
//   (m, l) a head; p goes to shared memory (rounded to bf16 for a bf16
//   latent pool, `round_p`).
// - Values: the work units are (32-column block, slice of the heads: all
//   of them at one head, either half at 16); warp w takes units w, w + NW,
//   ..., lane l column 32·block + l, and adds p·v over the round's keys in
//   key order, reading V rows from shared memory.
// The splits merge as in the narrow path (SPLIT = 256 keys, the last live
// split of (sequence, kv head) merges them in split order): a sequence's
// output does not depend on the batch, and dense and paged layouts, which
// read the same rows in the same order, give the same bits. At 16 heads
// with bf16 q and a bf16, int8 or e5m2 pool the scores are m16n8k16
// tensor-core products (the heads are the tile's 16 rows; the pool's
// values are exact in bf16, an int8 row's scale applied after), else f32
// CUDA-core products as the plain version's; P·V stays f32 on the CUDA
// cores.
constexpr int WG = 16;              // query heads a block holds, at most
constexpr int WRK = 128;            // keys a round, at most
constexpr int WQL = 4;              // lanes a key in the score phase
constexpr int WPASS = 32 / WQL;     // keys a warp scores at once
constexpr int WNW = 8;              // warps of a block, at most
constexpr int WEU = 4;              // value work units a warp, at most

// Whether a block's scores are tensor-core products: 16 heads (the rows of
// an m16n8k16 tile), bf16 q and a pool whose values bf16 holds exactly
// (bf16, int8, e5m2); f32 pools and f32 q keep f32 CUDA-core products
template <typename QT, typename KT, int GB>
__host__ __device__ constexpr bool wide_mma() {
  return GB == 16 && std::is_same<QT, __nv_bfloat16>::value && !std::is_same<KT, float>::value;
}

// Bytes a staged row takes in shared memory: its bytes rounded up so the
// rows a warp reads at once fall on distinct banks, 64 past a multiple of
// 128 for the CUDA-core scores (a quarter-warp reads two rows, four
// 16-byte pieces each), 16 past one for the tensor-core scores (eight rows,
// one word each of four)
__host__ __device__ __forceinline__ int wide_row_stride(int row_bytes, bool mma) {
  return mma ? (row_bytes + 111) / 128 * 128 + 16 : (row_bytes + 63) / 128 * 128 + 64;
}

// Columns c, c + 1 of a staged row as a bf16x2 word (exact for every pool
// the tensor-core scores take)
template <typename KT>
__device__ __forceinline__ unsigned bf16_pair(const unsigned char* row, int c) {
  if constexpr (std::is_same<KT, __nv_bfloat16>::value) {
    return *reinterpret_cast<const unsigned*>(row + 2 * c);
  } else {
    const unsigned w = *reinterpret_cast<const unsigned short*>(row + c);
    float lo, hi;
    if constexpr (std::is_same<KT, int8_t>::value) {
      lo = repro::i8_at(w, 0);
      hi = repro::i8_at(w, 1);
    } else {
      lo = repro::e5m2_to_f(w & 0xffu);
      hi = repro::e5m2_to_f(w >> 8);
    }
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  }
}

// Shared memory of a wide block before its ring: q (GB heads), the round's
// scores, the posted maxima and sums, the split's scales and rows
__host__ __device__ __forceinline__ size_t wide_head_bytes(int GB, int D) {
  return sizeof(float) * ((size_t)GB * D + (size_t)WG * WRK + 2 * WNW * WG + 2 * SPLIT) +
         sizeof(long long) * SPLIT;
}

// One block of NW warps per (split, sequence · kv head): the split's (m, l,
// acc[DV]) of each head into part[(b·KV + h), split, g], and the last live
// split of (b, h) merges them into out (B, KV, G, DV). The block computes
// GB >= G heads (1 or 16; q rows past G are 0), so the per-head loops
// unroll without a test. The value phase's work units are (32-column
// block, one of HS slices of the heads); warp w takes units w, w + NW, ...
// round_p: the probabilities meet V rounded to bf16 (a bf16 latent pool,
// as the MLA path rounds them to the pool's dtype; l sums them in f32).
template <typename QT, typename KT, int GB, int NW, int HS>
__global__ void __launch_bounds__(NW * 32)
decode_wide_kernel(const QT* __restrict__ q, KVArgs a, const int* __restrict__ kv_len,
                   QT* __restrict__ out, float* __restrict__ part, int* __restrict__ sem,
                   int G, int DV, int window, float scale, int n_splits, int round_p, int RK) {
  constexpr int VEC = 16 / sizeof(KT), NT = NW * 32, GH = GB / HS;
  constexpr bool I8 = std::is_same<KT, int8_t>::value, MMA = wide_mma<QT, KT, GB>();
  extern __shared__ __align__(16) unsigned char wsm[];
  const int D = a.d, CPR = D / VEC, NB = DV / 32;
  const int split = blockIdx.x, bh = blockIdx.y, b = bh / a.kv, h = bh % a.kv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool latent = DV != D;
  QT* ob = out + (size_t)bh * G * DV;
  int lo, hi;
  live_range(a, kv_len[b], window, lo, hi);
  const int s0 = split * SPLIT;
  if (hi <= lo) {               // no live key (kv_len == 0): the output is 0
    if (split == 0)
      for (int i = tid; i < G * DV; i += NT) ob[i] = repro::from_f<QT>(0.f);
    return;
  }
  if (s0 >= hi || s0 + SPLIT <= lo) return;                   // a dead split

  const int RB = D * (int)sizeof(KT), RS = wide_row_stride(RB, MMA), T = RK / NW;
  float* qs = reinterpret_cast<float*>(wsm);        // GB x D, scaled (MMA: bf16 rows)
  float* ps = qs + GB * D;                          // WG x RK: scores, then p
  float* xm = ps + WG * WRK;                        // NW x WG maxima
  float* xl = xm + WNW * WG;                        // NW x WG sums
  float* ksc = xl + WNW * WG;                       // SPLIT K scales (int8)
  float* vsc = ksc + SPLIT;                         // SPLIT V scales (int8)
  long long* rows = reinterpret_cast<long long*>(vsc + SPLIT);   // key's row, -1: none
  unsigned char* ring = wsm + wide_head_bytes(GB, D);
  const size_t stage = (size_t)(latent ? 1 : 2) * RK * RS;
  if constexpr (MMA) {            // the A tile: 16 bf16 rows of D + 8, rows past G 0
    __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(qs);
    for (int i = tid; i < GB * (D + 8); i += NT) {
      const int r = i / (D + 8), c = i - r * (D + 8);
      qb[i] = r < G && c < D ? q[((size_t)bh * G + r) * D + c] : __float2bfloat16(0.f);
    }
  } else {
    for (int i = tid; i < GB * D; i += NT)
      qs[i] = i < G * D ? repro::to_f(q[(size_t)bh * G * D + i]) * scale : 0.f;
  }
  for (int t = tid; t < SPLIT; t += NT) {
    const int j = s0 + t;
    const bool ok = j >= lo && j < hi;
    const long long row = ok ? (long long)repro::kv_row(a, b, j, h) : -1;
    rows[t] = row;
    if constexpr (I8) {
      ksc[t] = ok ? __half2float(a.ks[row]) : 0.f;
      vsc[t] = ok ? __half2float(a.vs[row]) : 0.f;
    }
  }
  __syncthreads();
  const int NR = SPLIT / RK;
  auto live = [&](int r) { return s0 + r * RK < hi && s0 + (r + 1) * RK > lo; };
  // round r's K rows (then V rows) into stage `slot`, keys outside [lo, hi)
  // zero-filled: thread t copies 16-byte pieces t, t + NT, ... of the
  // stage, stepping its (row, piece) without a division
  const int C16 = RB / 16, dk = NT / C16, dc = NT - dk * C16;
  const int nrow = (latent ? 1 : 2) * RK;
  auto issue = [&](int r, int slot) {
    const unsigned char* K = static_cast<const unsigned char*>(a.k);
    const unsigned char* V = static_cast<const unsigned char*>(a.v);
    unsigned char* st = ring + slot * stage;
    int kr = tid / C16, cc = tid - kr * C16;
    while (kr < nrow) {
      const int w = kr >= RK, key = kr - w * RK;
      const long long row = rows[r * RK + key];
      const unsigned char* src = (w ? V : K) + (row >= 0 ? (size_t)row * RB + cc * 16 : 0);
      repro::cp_async16(st + (size_t)kr * RS + cc * 16, src, row >= 0 ? 16 : 0);
      kr += dk;
      cc += dc;
      if (cc >= C16) {
        cc -= C16;
        ++kr;
      }
    }
  };
  if (live(0)) issue(0, 0);
  repro::cp_async_commit();
  if (live(1)) issue(1, 1);
  repro::cp_async_commit();

  // this warp's value units: (column block cb, head slice hs), in order
  const int NU = NB * HS, EU = (NU - warp + NW - 1) / NW;
  float m[GB], l[GB], acc[WEU][GH];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < WEU; ++e)
#pragma unroll
    for (int g = 0; g < GH; ++g) acc[e][g] = 0.f;
  const int kl = lane / WQL, part4 = lane % WQL;
#pragma unroll 1
  for (int r = 0; r < NR; ++r) {
    const int r0 = s0 + r * RK;
    repro::cp_async_wait<1>();
    __syncthreads();            // round r landed
    if (live(r)) {              // block-uniform
      const unsigned char* kt = ring + (r & 1) * stage;
      const unsigned char* vt = latent ? kt : kt + (size_t)RK * RS;
      // scores of this warp's T keys, eight at a time
      const int w0 = warp * T;
      const bool wlive = r0 + w0 < hi && r0 + w0 + T > lo;   // warp-uniform
      if constexpr (MMA) {
        // S (16 heads x T keys) = Q·Kᵀ by m16n8k16 products, then × scale
        // (× the key's int8 scale): heads g and g + 8, keys 8j + 2t, + 1
        const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(qs);
        const int g8 = lane >> 2, t4 = lane & 3, NJ = T / 8;
        float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if (wlive) {
#pragma unroll 2
          for (int kk = 0; kk < D / 16; ++kk) {
            unsigned qa[4];
            repro::ldmatrix_x4(qa, qb + (lane & 15) * (D + 8) + kk * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (j >= NJ) break;
              const unsigned char* krow = kt + (size_t)(w0 + 8 * j + g8) * RS;
              const unsigned kb[2] = {bf16_pair<KT>(krow, kk * 16 + 2 * t4),
                                      bf16_pair<KT>(krow, kk * 16 + 8 + 2 * t4)};
              repro::mma_bf16_16816(sacc[j], qa, kb);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j >= NJ) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kr = w0 + 8 * j + 2 * t4 + (e & 1), head = g8 + 8 * (e >> 1);
            float v = __fmul_rn(sacc[j][e], scale);
            if constexpr (I8) v = __fmul_rn(v, ksc[r * RK + kr]);
            ps[head * RK + kr] = rows[r * RK + kr] >= 0 ? v : NEG_INF;
          }
        }
      }
#pragma unroll 1
      for (int k8 = 0; k8 < (MMA ? 0 : T); k8 += WPASS) {
        const bool inw = k8 + kl < T;                         // T < 8: lanes to spare
        const int kr = w0 + min(k8 + kl, T - 1);              // key in the round
        const bool ok = inw && rows[r * RK + kr] >= 0;
        const float ks = I8 ? ksc[r * RK + kr] : 1.f;
        float s[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g) s[g] = 0.f;
        if (wlive) {
          const unsigned char* krow = kt + (size_t)kr * RS;
#pragma unroll 2
          for (int c = part4; c < CPR; c += WQL) {
            float f[VEC];
            widen16<KT>(krow + c * 16, f);
            if constexpr (I8) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) f[e] *= ks;
            }
            const float* qc = qs + c * VEC;
#pragma unroll
            for (int g = 0; g < GB; ++g) {
              const float4* qg = reinterpret_cast<const float4*>(qc + g * D);
              float t = 0.f;
#pragma unroll
              for (int e = 0; e < VEC; e += 4) {
                const float4 q4 = qg[e / 4];
                t = fmaf(q4.x, f[e], t);
                t = fmaf(q4.y, f[e + 1], t);
                t = fmaf(q4.z, f[e + 2], t);
                t = fmaf(q4.w, f[e + 3], t);
              }
              s[g] += t;
            }
          }
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          s[g] += __shfl_xor_sync(FULL, s[g], 1);
          s[g] += __shfl_xor_sync(FULL, s[g], 2);
          if (inw && g % WQL == part4) ps[g * RK + kr] = ok ? s[g] : NEG_INF;
        }
      }
      __syncwarp();
      // the block's softmax over the round: maxima, then sums, by warp
      const bool mine = lane < T;
      const int kr = w0 + (mine ? lane : 0);
      const bool valid = mine && rows[r * RK + kr] >= 0;
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float mx = repro::warp_max(mine ? ps[g * RK + kr] : NEG_INF);
        if (lane == 0) xm[warp * WG + g] = mx;
      }
      __syncthreads();
      float corr[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float mt = xm[g];
#pragma unroll
        for (int w = 1; w < NW; ++w) mt = fmaxf(mt, xm[w * WG + g]);
        const float m_new = fmaxf(m[g], mt);
        // masked keys contribute exactly 0 (a head with no valid key so far
        // keeps m == NEG_INF, and exp(NEG_INF - NEG_INF) would be 1)
        const float p = valid ? expf(ps[g * RK + kr] - m_new) : 0.f;
        const float sum = repro::warp_sum(p);
        if (lane == 0) xl[warp * WG + g] = sum;
        if (mine) ps[g * RK + kr] = round_p ? __bfloat162float(__float2bfloat16(p)) : p;
        corr[g] = expf(m[g] - m_new);
        m[g] = m_new;
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float sum = xl[g];
#pragma unroll
        for (int w = 1; w < NW; ++w) sum += xl[w * WG + g];
        l[g] = l[g] * corr[g] + sum;
      }
#pragma unroll
      for (int e = 0; e < WEU; ++e) {
        const int hs = (warp + NW * e) % HS;
#pragma unroll
        for (int g = 0; g < GH; ++g) acc[e][g] *= corr[hs * GH + g];
      }
      // values: this warp's units over the round's live keys, in order
      const int ka = max(lo - r0, 0) & ~3, kb = min(hi - r0, RK);
#pragma unroll 1
      for (int k0 = ka; k0 < kb; k0 += 4) {
#pragma unroll
        for (int e = 0; e < WEU; ++e) {
          if (e >= EU) break;                               // warp-uniform
          const int u = warp + NW * e, cb = u / HS, hs = u - cb * HS;
          const int col = cb * 32 + lane;
          float vv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            vv[k] = repro::to_f(reinterpret_cast<const KT*>(vt + (size_t)(k0 + k) * RS)[col]);
            if constexpr (I8) vv[k] *= vsc[r * RK + k0 + k];
          }
#pragma unroll
          for (int g = 0; g < GH; ++g) {
            const float4 p4 = *reinterpret_cast<const float4*>(ps + (hs * GH + g) * RK + k0);
            acc[e][g] = fmaf(p4.x, vv[0], acc[e][g]);
            acc[e][g] = fmaf(p4.y, vv[1], acc[e][g]);
            acc[e][g] = fmaf(p4.z, vv[2], acc[e][g]);
            acc[e][g] = fmaf(p4.w, vv[3], acc[e][g]);
          }
        }
      }
    }
    __syncthreads();            // every warp is done with this stage and p
    if (r + 2 < NR && live(r + 2)) issue(r + 2, r & 1);
    repro::cp_async_commit();
  }

  float* pbh = part + (size_t)bh * n_splits * G * (DV + 2);
  float* pb = pbh + (size_t)split * G * (DV + 2);
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < G) {
        pb[(size_t)g * (DV + 2)] = m[g];
        pb[(size_t)g * (DV + 2) + 1] = l[g];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < WEU; ++e) {
    if (e >= EU) break;
    const int u = warp + NW * e, cb = u / HS, hs = u - cb * HS;
#pragma unroll
    for (int g = 0; g < GH; ++g)
      if (hs * GH + g < G) pb[(size_t)(hs * GH + g) * (DV + 2) + 2 + cb * 32 + lane] = acc[e][g];
  }
  const int s_lo = lo / SPLIT, s_hi = (hi + SPLIT - 1) / SPLIT;
  if (!repro::last_split_done(sem + bh, s_hi - s_lo)) return;
  for (int i = tid; i < G * DV; i += NT) {
    const int g = i / DV, c = i - g * DV;
    float mx = NEG_INF;
    for (int sp = s_lo; sp < s_hi; ++sp)
      mx = fmaxf(mx, __ldcg(pbh + ((size_t)sp * G + g) * (DV + 2)));
    float ls = 0.f, as = 0.f;
    for (int sp = s_lo; sp < s_hi; ++sp) {
      const float* cg = pbh + ((size_t)sp * G + g) * (DV + 2);
      const float f = expf(__ldcg(cg) - mx);
      ls += __ldcg(cg + 1) * f;
      as += __ldcg(cg + 2 + c) * f;
    }
    ob[i] = repro::from_f<QT>(as / fmaxf(ls, 1e-30f));
  }
}

template <typename QT, typename KT, int GB, int NW, int HS>
int launch_wide_g(const void* q, const KVArgs& a, const void* kv_len, void* out, void* part,
                  void* sem, int B, int G, int DV, int window, float scale, int n_splits,
                  cudaStream_t stream) {
  const int D = a.d;
  const bool latent = DV != D;
  if (DV / 32 * HS > NW * WEU) return static_cast<int>(cudaErrorInvalidValue);
  // the longest round whose two stages fit beside the rest
  const size_t head = wide_head_bytes(GB, D);
  const size_t row =
      (size_t)(latent ? 1 : 2) * wide_row_stride(D * (int)sizeof(KT), wide_mma<QT, KT, GB>());
  const size_t room = SMEM_MAX - 1024;             // the static shared memory's share
  int rk = WRK;
  while (rk > 32 && head + 2 * rk * row > room) rk /= 2;
  const size_t smem = head + 2 * rk * row;
  if (smem > room) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = decode_wide_kernel<QT, KT, GB, NW, HS>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int round_p = latent && std::is_same<KT, __nv_bfloat16>::value;
  // at least one split: its block writes the zeros of an empty cache
  kernel<<<dim3(max(n_splits, 1), B * a.kv), NW * 32, smem, stream>>>(
      static_cast<const QT*>(q), a, static_cast<const int*>(kv_len),
      static_cast<QT*>(out), static_cast<float*>(part), static_cast<int*>(sem), G, DV,
      window, scale, n_splits, round_p, rk);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_wide(const void* q, const KVArgs& a, const void* kv_len, void* out, void* part,
                void* sem, int B, int G, int DV, int window, float scale, int n_splits,
                cudaStream_t stream) {
  const int D = a.d;
  const int cap = a.page_table != nullptr ? a.pps * a.ps : a.smax;
  const bool latent = DV != D;
  if (n_splits != (cap + SPLIT - 1) / SPLIT || part == nullptr || sem == nullptr ||
      G < 1 || G > WG || DV > 512 || DV % 32 || D % 32 ||
      (latent && (DV > D || a.k != a.v)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  // one head: four warps, each its value columns; more: eight warps over 16
  // heads (q rows past G are 0), the value work split by (column block,
  // half of the heads)
  if (G == 1)
    return launch_wide_g<QT, KT, 1, 4, 1>(q, a, kv_len, out, part, sem, B, G, DV, window,
                                          scale, n_splits, stream);
  return launch_wide_g<QT, KT, WG, WNW, 2>(q, a, kv_len, out, part, sem, B, G, DV, window,
                                           scale, n_splits, stream);
}

template <typename QT, typename KT>
int launch(const void* q, const KVArgs& a, const void* kv_len, void* out, void* part,
           void* sem, int B, int G, int window, float scale, int n_splits,
           cudaStream_t stream) {
  const int D = a.d;
  const int cap = a.page_table != nullptr ? a.pps * a.ps : a.smax;
  if (n_splits != (cap + SPLIT - 1) / SPLIT || part == nullptr || sem == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int RS = D * (int)sizeof(KT) + 16;
  const size_t base = sizeof(float) * (G * D + DW * G * (D + 2) + DW * (G + 1) * DTK);
  const size_t stage = (size_t)DW * 2 * DTK * RS;
  const int stages = base + 2 * stage <= (size_t)SMEM_MAX ? 2 : 1;
  const size_t smem = base + stages * stage;
  auto* kernel = decode_split_kernel<QT, KT>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // at least one split: its block writes the zeros of an empty cache
  kernel<<<dim3(max(n_splits, 1), B * a.kv), DW * 32, smem, stream>>>(
      static_cast<const QT*>(q), a, static_cast<const int*>(kv_len),
      static_cast<QT*>(out), static_cast<float*>(part), static_cast<int*>(sem), G,
      window, scale, n_splits, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_path(int path, const void* q, const KVArgs& a, const void* kv_len, void* out,
                void* part, void* sem, int B, int G, int DV, int window, float scale,
                int n_splits, cudaStream_t s) {
  if (path == 1)
    return launch_wide<QT, KT>(q, a, kv_len, out, part, sem, B, G, DV, window, scale,
                               n_splits, s);
  if (G > MAXG || a.d > 32 * MAXE || DV != a.d)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<QT, KT>(q, a, kv_len, out, part, sem, B, G, window, scale, n_splits, s);
}

template <typename QT>
int dispatch_kv(int kv_dtype, int path, const void* q, const KVArgs& a, const void* kv_len,
                void* out, void* part, void* sem, int B, int G, int DV, int window,
                float scale, int n_splits, cudaStream_t s) {
  switch (kv_dtype) {
    case repro::kF32:
      return launch_path<QT, float>(path, q, a, kv_len, out, part, sem, B, G, DV, window,
                                    scale, n_splits, s);
    case repro::kBF16:
      return launch_path<QT, __nv_bfloat16>(path, q, a, kv_len, out, part, sem, B, G, DV,
                                            window, scale, n_splits, s);
    case repro::kI8:
      return launch_path<QT, int8_t>(path, q, a, kv_len, out, part, sem, B, G, DV, window,
                                     scale, n_splits, s);
    case repro::kE5M2:
      return launch_path<QT, repro::e5m2>(path, q, a, kv_len, out, part, sem, B, G, DV,
                                          window, scale, n_splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,KV,G,D); k/v dense (B,smax,KV,D) or pools (n_pages,ps,KV,D) with
// page_table (B,pps) int32 (nullptr = dense); ks/vs f16 scales for int8
// caches (nullptr otherwise); kv_len (B,) int32; out (B,KV,G,DV) in q's
// type; part (B·KV, n_splits, G, DV+2) f32 scratch, n_splits =
// ceil(depth / 256); sem B·KV zeroed int32 (left zeroed), on either path
// one block per (split, sequence · kv head); k and v are 16-byte aligned. DV == D,
// or DV < D for MLA latent rows (k == v: values are each row's first DV
// columns; path 1 only). path 0: G <= 8, D <= 128 (the narrow kernel);
// path 1: the wide kernel. The wrapper's `decode_plan` picks.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* page_table, const void* kv_len,
                                void* out, void* part, void* sem, int B, int KV,
                                int G, int D, int DV, int smax, int pps, int ps,
                                int window, float scale, int n_splits, int q_dtype,
                                int kv_dtype, int path, void* stream) {
  KVArgs a{k, v, static_cast<const __half*>(ks), static_cast<const __half*>(vs),
           static_cast<const int*>(page_table), pps, ps, smax, KV, D};
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == repro::kF32)
    return dispatch_kv<float>(kv_dtype, path, q, a, kv_len, out, part, sem, B, G, DV,
                              window, scale, n_splits, s);
  if (q_dtype == repro::kBF16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, path, q, a, kv_len, out, part, sem, B, G,
                                      DV, window, scale, n_splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
