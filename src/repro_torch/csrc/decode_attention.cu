// Single-query (decode) GQA attention against a ragged KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (_body, _make_kernel; dense and paged pallas_calls). All four variants:
// {dense (B,Smax,KV,D) cache, paged (n_pages,ps,KV,D) pool through a
// (B,pages_per_seq) table} x {float (f32/bf16) cache, int8 cache with f16
// per-(row, kv head) scales, dequantized on the shared-memory -> register
// step}.
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

// 16 bytes of a cache row in shared memory, widened to f32
template <typename KT>
__device__ __forceinline__ void widen16(const unsigned char* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
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
  } else {
#pragma unroll
    for (int u = 0; u < 16; ++u) f[u] = repro::i8_at(w[u >> 2], u & 3);
  }
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

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const KVArgs& a, const void* kv_len,
                void* out, void* part, void* sem, int B, int G, int window,
                float scale, int n_splits, cudaStream_t s) {
  switch (kv_dtype) {
    case repro::kF32:
      return launch<QT, float>(q, a, kv_len, out, part, sem, B, G, window, scale,
                               n_splits, s);
    case repro::kBF16:
      return launch<QT, __nv_bfloat16>(q, a, kv_len, out, part, sem, B, G, window,
                                       scale, n_splits, s);
    case repro::kI8:
      return launch<QT, int8_t>(q, a, kv_len, out, part, sem, B, G, window, scale,
                                n_splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,KV,G,D); k/v dense (B,smax,KV,D) or pools (n_pages,ps,KV,D) with
// page_table (B,pps) int32 (nullptr = dense); ks/vs f16 scales for int8
// caches (nullptr otherwise); kv_len (B,) int32; out (B,KV,G,D) in q's type;
// part (B·KV, n_splits, G, D+2) f32 scratch, n_splits = ceil(depth / 256);
// sem B·KV zeroed int32 (left zeroed); k and v are 16-byte aligned.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* page_table, const void* kv_len,
                                void* out, void* part, void* sem, int B, int KV,
                                int G, int D, int smax, int pps, int ps, int window,
                                float scale, int n_splits, int q_dtype, int kv_dtype,
                                void* stream) {
  KVArgs a{k, v, static_cast<const __half*>(ks), static_cast<const __half*>(vs),
           static_cast<const int*>(page_table), pps, ps, smax, KV, D};
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == repro::kF32)
    return dispatch_kv<float>(kv_dtype, q, a, kv_len, out, part, sem, B, G, window,
                              scale, n_splits, s);
  if (q_dtype == repro::kBF16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, a, kv_len, out, part, sem, B, G,
                                      window, scale, n_splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
