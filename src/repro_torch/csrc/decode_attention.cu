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
// More than MAXG query heads a kv head, head_dim above 32 · MAXE, or MLA
// latent rows (one pool read as both K and V, keys D = 576 wide and values
// their first DV = 512 columns). A thread's state would not fit its
// registers at G 16 x D 256 (4x the narrow path's) or for a 512-wide value
// row, so the group is split instead: a block takes WGB query heads (grid
// z), each warp WHW of them, over all D columns. The block stages each
// 32-key tile of the split once, as f32 in shared memory (int8 rows
// dequantized, e5m2 rows upcast), and every warp folds it into the online
// softmax of its own heads; the splits merge as in the narrow path
// (SPLIT = 256 keys, the last live split of (sequence, kv head, head
// group) merges them in split order). So a sequence's output does not
// depend on the batch, and dense and paged layouts give the same bits.
constexpr int WHW = 2;              // query heads a warp
constexpr int WGB = DW * WHW;       // query heads a block
constexpr int WEV = 16;             // value columns / 32, at most (DV 512)

// Keys [j0, j0 + 32) of (b, h) as f32: K into kt (32 x (D + 1)) and, unless
// the rows are latent (V = K's first DV columns), V into vt (32 x D). Keys
// outside [lo, hi) load as 0. The first 32 threads find the tile's rows
// (one page-table read each) and int8 scales; then every thread moves
// 16-byte pieces of them, LB at a time in flight, widened on the way.
template <typename KT>
__device__ void wide_tile(const KVArgs& a, int b, int h, int j0, int lo, int hi,
                          bool latent, float* kt, float* vt, long long* rows,
                          float* scales) {
  constexpr int LB = 4, VEC = 16 / sizeof(KT);
  const int D = a.d, CPR = D / VEC, n = DTK * CPR, nt = blockDim.x;
  if (threadIdx.x < DTK) {
    const int j = j0 + threadIdx.x;
    const bool ok = j >= lo && j < hi;
    const long long row = ok ? (long long)repro::kv_row(a, b, j, h) : -1;
    rows[threadIdx.x] = row;
    scales[threadIdx.x] = ok && a.ks != nullptr ? __half2float(a.ks[row]) : 1.f;
    scales[DTK + threadIdx.x] = ok && a.vs != nullptr ? __half2float(a.vs[row]) : 1.f;
  }
  __syncthreads();
  for (int pass = 0; pass < (latent ? 1 : 2); ++pass) {
    const unsigned char* src = static_cast<const unsigned char*>(pass == 0 ? a.k : a.v);
    for (int base = threadIdx.x; base < n; base += LB * nt) {
      uint4 raw[LB];
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int c = base + u * nt, r = c / CPR;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (c < n && rows[r] >= 0)
          raw[u] = *reinterpret_cast<const uint4*>(
              src + ((size_t)rows[r] * D + (size_t)(c - r * CPR) * VEC) * sizeof(KT));
      }
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int c = base + u * nt, r = c / CPR, cc = c - r * CPR;
        if (c >= n) continue;
        float f[VEC];
        widen16<KT>(raw[u], f);
        const float sc = scales[pass * DTK + r];
        float* dst = pass == 0 ? kt + r * (D + 1) + cc * VEC : vt + r * D + cc * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] = f[e] * sc;
      }
    }
  }
}

// One block per (split, sequence · kv head, group of WGB query heads): the
// split's (m, l, acc[DV]) of each head into part[(b·KV + h), split, g], and
// the last live split of (b, h, group) merges them into out (B, KV, G, DV).
// round_p: the probabilities meet V rounded to bf16 (a bf16 latent pool,
// as the MLA path rounds them to the pool's dtype; l sums them in f32).
template <typename QT, typename KT>
__global__ void __launch_bounds__(DW * 32)
decode_wide_kernel(const QT* __restrict__ q, KVArgs a, const int* __restrict__ kv_len,
                   QT* __restrict__ out, float* __restrict__ part, int* __restrict__ sem,
                   int G, int DV, int window, float scale, int n_splits, int round_p) {
  extern __shared__ __align__(16) float wsm[];
  const int D = a.d, KS = D + 1;
  const int split = blockIdx.x, bh = blockIdx.y, gc = blockIdx.z;
  const int b = bh / a.kv, h = bh % a.kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g0 = gc * WGB, gn = min(WGB, G - g0);
  const bool latent = DV != D;
  QT* ob = out + (size_t)bh * G * DV;
  int lo, hi;
  live_range(a, kv_len[b], window, lo, hi);
  const int s0 = split * SPLIT;
  if (hi <= lo) {               // no live key (kv_len == 0): the output is 0
    if (split == 0)
      for (int i = threadIdx.x; i < gn * DV; i += blockDim.x)
        ob[g0 * DV + i] = repro::from_f<QT>(0.f);
    return;
  }
  if (s0 >= hi || s0 + SPLIT <= lo) return;                   // a dead split

  float* qs = wsm;                      // WGB x D, scaled
  float* kt = qs + WGB * D;             // DTK x (D + 1)
  float* vt = kt + DTK * KS;            // DTK x D (not latent)
  float* scales = vt + (latent ? 0 : DTK * D);                  // K, V scales
  long long* rows = reinterpret_cast<long long*>(scales + 2 * DTK);
  for (int i = threadIdx.x; i < gn * D; i += blockDim.x)
    qs[i] = repro::to_f(q[((size_t)bh * G + g0) * D + i]) * scale;
  const float* vb = latent ? kt : vt;
  const int VS = latent ? KS : D, E = DV / 32;

  float m[WHW], l[WHW], acc[WHW][WEV];
#pragma unroll
  for (int hh = 0; hh < WHW; ++hh) {
    m[hh] = NEG_INF;
    l[hh] = 0.f;
#pragma unroll
    for (int e = 0; e < WEV; ++e) acc[hh][e] = 0.f;
  }
  for (int t = 0; t < SPLIT / DTK; ++t) {
    const int j0 = s0 + t * DTK;
    if (j0 >= hi || j0 + DTK <= lo) continue;                 // block-uniform
    __syncthreads();            // the last tile read (and q written)
    wide_tile<KT>(a, b, h, j0, lo, hi, latent, kt, vt, rows, scales);
    __syncthreads();
    const int j = j0 + lane;
    const bool valid = j >= lo && j < hi;
    const float* krow = kt + lane * KS;
    float s[WHW];
#pragma unroll
    for (int hh = 0; hh < WHW; ++hh) s[hh] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float kc = krow[c];
#pragma unroll
      for (int hh = 0; hh < WHW; ++hh)
        if (warp * WHW + hh < gn) s[hh] = fmaf(qs[(warp * WHW + hh) * D + c], kc, s[hh]);
    }
    float p[WHW];
#pragma unroll
    for (int hh = 0; hh < WHW; ++hh) {
      p[hh] = 0.f;
      if (warp * WHW + hh < gn) {                             // warp-uniform
        const float sv = valid ? s[hh] : NEG_INF;
        const float m_new = fmaxf(m[hh], repro::warp_max(sv));
        const float pf = valid ? expf(sv - m_new) : 0.f;
        const float corr = expf(m[hh] - m_new);
        l[hh] = l[hh] * corr + repro::warp_sum(pf);
        m[hh] = m_new;
#pragma unroll
        for (int e = 0; e < WEV; ++e) acc[hh][e] *= corr;
        p[hh] = round_p ? __bfloat162float(__float2bfloat16(pf)) : pf;
      }
    }
    for (int u = 0; u < DTK; ++u) {
      float vv[WEV];
#pragma unroll
      for (int e = 0; e < WEV; ++e) vv[e] = e < E ? vb[u * VS + lane + 32 * e] : 0.f;
#pragma unroll
      for (int hh = 0; hh < WHW; ++hh) {
        if (warp * WHW + hh < gn) {
          const float pt = __shfl_sync(FULL, p[hh], u);
#pragma unroll
          for (int e = 0; e < WEV; ++e)
            if (e < E) acc[hh][e] = fmaf(pt, vv[e], acc[hh][e]);
        }
      }
    }
  }

  float* pbh = part + (size_t)bh * n_splits * G * (DV + 2);
#pragma unroll
  for (int hh = 0; hh < WHW; ++hh) {
    const int g = g0 + warp * WHW + hh;
    if (warp * WHW + hh >= gn) continue;
    float* pg = pbh + ((size_t)split * G + g) * (DV + 2);
    if (lane == 0) {
      pg[0] = m[hh];
      pg[1] = l[hh];
    }
#pragma unroll
    for (int e = 0; e < WEV; ++e)
      if (e < E) pg[2 + lane + 32 * e] = acc[hh][e];
  }
  const int s_lo = lo / SPLIT, s_hi = (hi + SPLIT - 1) / SPLIT;
  if (!repro::last_split_done(sem + (size_t)bh * gridDim.z + gc, s_hi - s_lo)) return;
  for (int i = threadIdx.x; i < gn * DV; i += blockDim.x) {
    const int g = g0 + i / DV, c = i - (i / DV) * DV;
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
    ob[(size_t)g * DV + c] = repro::from_f<QT>(as / fmaxf(ls, 1e-30f));
  }
}

template <typename QT, typename KT>
int launch_wide(const void* q, const KVArgs& a, const void* kv_len, void* out, void* part,
                void* sem, int B, int G, int DV, int window, float scale, int n_splits,
                cudaStream_t stream) {
  const int D = a.d;
  const int cap = a.page_table != nullptr ? a.pps * a.ps : a.smax;
  const bool latent = DV != D;
  if (n_splits != (cap + SPLIT - 1) / SPLIT || part == nullptr || sem == nullptr ||
      DV > 32 * WEV || DV % 32 || D % 32 || (latent && (DV > D || a.k != a.v)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(float) * ((size_t)WGB * D + (size_t)DTK * (D + 1) +
                                       (latent ? 0 : (size_t)DTK * D) + 2 * DTK) +
                      sizeof(long long) * DTK;
  auto* kernel = decode_wide_kernel<QT, KT>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int round_p = latent && std::is_same<KT, __nv_bfloat16>::value;
  kernel<<<dim3(max(n_splits, 1), B * a.kv, (G + WGB - 1) / WGB), DW * 32, smem, stream>>>(
      static_cast<const QT*>(q), a, static_cast<const int*>(kv_len),
      static_cast<QT*>(out), static_cast<float*>(part), static_cast<int*>(sem), G, DV,
      window, scale, n_splits, round_p);
  return static_cast<int>(cudaGetLastError());
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
// ceil(depth / 256); sem zeroed int32 (left zeroed), B·KV of them (path
// 0) or B·KV·ceil(G / 8) (path 1); k and v are 16-byte aligned. DV == D,
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
