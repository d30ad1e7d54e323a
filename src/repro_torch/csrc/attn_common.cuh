// Shared pieces of the two attention kernels (decode_attention.cu and
// flash_attention_paged.cu): K/V tile loads through a dense cache or a page
// table with fused int8 dequant, and the per-warp online-softmax update.
//
// Layout convention (the JAX package's): caches are (B, Smax, KV, D) dense or
// (n_pages, page_size, KV, D) pools read through a (B, pages_per_seq) int32
// page table; int8 caches carry one f16 scale per (row, kv head).
//
// A tile is TK = 32 consecutive key positions of one (sequence, kv head),
// held in shared memory as f32 (already dequantized). In the score phase lane
// t of a warp owns key t of the tile; in the value phase lane l owns output
// columns l, l+32, ... of every query head of its row.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int TK = 32;           // keys per tile: one per lane
constexpr int NW = 4;            // warps per block
constexpr int MAXG = 8;          // query heads per kv head
constexpr int MAXE = 4;          // head_dim / 32 (head_dim <= 128)
constexpr float NEG_INF = -1e30f;  // finite, as the reference's NEG_INF

struct KVArgs {
  const void* k;
  const void* v;
  const __half* ks;      // int8 scales (same layout minus D) or nullptr
  const __half* vs;
  const int* page_table; // (B, pps) or nullptr for the dense layout
  int pps;               // pages per sequence (paged)
  int ps;                // page size (paged)
  int smax;              // cache depth (dense)
  int kv;                // kv heads
  int d;                 // head dim
};

// Row index (in units of D elements) of key position j of (b, h). Unmapped
// table entries point at the null page, which is a valid source.
__device__ __forceinline__ size_t kv_row(const KVArgs& a, int b, int j, int h) {
  if (a.page_table != nullptr) {
    const int page = a.page_table[(size_t)b * a.pps + j / a.ps];
    return ((size_t)page * a.ps + (j % a.ps)) * a.kv + h;
  }
  return ((size_t)b * a.smax + j) * a.kv + h;
}

// Load keys [j0, j0 + TK) of (b, h) into ktile (TK x (D+1), padded against
// bank conflicts) and vtile (TK x D) as f32, dequantizing int8 rows with
// their f16 scale. Keys at or past `hi` load as 0 (never read unmasked).
// Threads t, t + nthreads, ... of the caller cooperate. Loads go out in
// batches of LOAD_BATCH per thread before any is stored, so their
// device-memory latencies overlap instead of adding up.
constexpr int LOAD_BATCH = 16;

template <typename KT>
__device__ void load_tile(const KVArgs& a, int b, int h, int j0, int hi,
                          float* ktile, float* vtile, int t, int nthreads) {
  const KT* K = static_cast<const KT*>(a.k);
  const KT* V = static_cast<const KT*>(a.v);
  const int D = a.d;
  for (int base = t; base < TK * D; base += LOAD_BATCH * nthreads) {
    float kf[LOAD_BATCH], vf[LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int i = base + u * nthreads;
      kf[u] = 0.f;
      vf[u] = 0.f;
      if (i < TK * D) {
        const int r = i / D, c = i - r * D;
        const int j = j0 + r;
        if (j < hi) {
          const size_t row = kv_row(a, b, j, h);
          kf[u] = to_f(K[row * D + c]);
          vf[u] = to_f(V[row * D + c]);
          if (a.ks != nullptr) {
            kf[u] *= __half2float(a.ks[row]);
            vf[u] *= __half2float(a.vs[row]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int i = base + u * nthreads;
      if (i < TK * D) {
        const int r = i / D, c = i - r * D;
        ktile[r * (D + 1) + c] = kf[u];
        vtile[r * D + c] = vf[u];
      }
    }
  }
}

// Running online-softmax statistics of one query row (all G heads), held by
// one warp: m/l are warp-uniform, acc[g][e] is column lane + 32e of head g.
struct RowState {
  float m[MAXG];
  float l[MAXG];
  float acc[MAXG][MAXE];
};

__device__ __forceinline__ void init_state(RowState& st) {
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    st.m[g] = NEG_INF;
    st.l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) st.acc[g][e] = 0.f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Fold one tile (keys j0 + lane) into the row's state. Key j counts iff
// lo <= j < hi; q holds the row's G x D query, pre-multiplied by the scale.
// Called by all 32 lanes of a warp with warp-uniform arguments.
__device__ __forceinline__ void tile_update(RowState& st, const float* q,
                                            const float* ktile, const float* vtile,
                                            int G, int D, int j0, int lo, int hi,
                                            int lane) {
  const int j = j0 + lane;
  const bool valid = j >= lo && j < hi;
  const int E = D / 32;
  float s[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
  const float* krow = ktile + lane * (D + 1);
  for (int c = 0; c < D; ++c) {
    const float kc = krow[c];
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) s[g] = fmaf(q[g * D + c], kc, s[g]);
  }
  float p[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    p[g] = 0.f;
    if (g < G) {
      const float sv = valid ? s[g] : NEG_INF;
      const float m_new = fmaxf(st.m[g], warp_max(sv));
      // masked keys contribute exactly 0 (a row with no valid key so far
      // keeps m == NEG_INF, and exp(NEG_INF - NEG_INF) would be 1)
      p[g] = valid ? expf(sv - m_new) : 0.f;
      const float corr = expf(st.m[g] - m_new);
      st.l[g] = st.l[g] * corr + warp_sum(p[g]);
      st.m[g] = m_new;
#pragma unroll
      for (int e = 0; e < MAXE; ++e) st.acc[g][e] *= corr;
    }
  }
  for (int t = 0; t < TK; ++t) {
    float vv[MAXE];
#pragma unroll
    for (int e = 0; e < MAXE; ++e) vv[e] = (e < E) ? vtile[t * D + lane + 32 * e] : 0.f;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float pt = __shfl_sync(0xffffffffu, p[g], t);
#pragma unroll
        for (int e = 0; e < MAXE; ++e) st.acc[g][e] = fmaf(pt, vv[e], st.acc[g][e]);
      }
    }
  }
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename F>
inline cudaError_t allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
