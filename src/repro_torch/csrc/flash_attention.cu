// Dense blockwise self-attention over (B, H, S, D).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_kernel). Query row i attends key j iff, with both positions counted from
// one origin, (not causal or j <= i) and (no window or i - j < window). The
// softmax is an f32 online softmax (running max m, sum l, accumulator acc,
// NEG_INF = -1e30 finite) and the output is acc / max(l, 1e-30) in q's type.
// Tiles that are dead under the causal or window mask are skipped. Any S is
// taken (the TPU kernel asserts S % block == 0): ragged tail tiles load as 0
// and are masked. The caller passes Sq == Sk, as every caller of the TPU
// kernel does.
//
// Bound on the card: operations at the prefill shapes (a causal 1024-row
// prompt does ~1024²/2 pairs per head against ~8 MB of q/k/v/out).
//
// Design (simple first): one 128-thread block per (batch·head, 16 query
// rows); each warp holds four rows and keeps their m/l/acc in registers.
// The block streams 32-key tiles of K and V (a contiguous (32, D) slab in
// this layout) into shared memory as f32; in the score phase lane t owns key
// t of the tile, in the value phase lane l owns output columns l, l+32, ...
// CUDA-core f32 FMAs; tensor-core tiles (mma/wgmma) and TMA are later work.

#include "attn_common.cuh"

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Sq, int Sk, int causal, int window, float scale,
           cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_kernel<T, D><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
               int BH, int Sq, int Sk, int causal, int window, float scale,
               cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, BH, Sq, Sk, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, BH, Sq, Sk, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, BH, Sq, Sk, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (BH, Sq, D), k/v (BH, Sk, D), out (BH, Sq, D), all contiguous in one
// type (f32 or bf16); D in {32, 64, 128}; BH <= 65535.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int BH, int Sq, int Sk, int D,
                               int causal, int window, float scale, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq == 0 || BH == 0) return 0;
  if (dtype == repro::kF32)
    return dispatch_d<float>(D, q, k, v, out, BH, Sq, Sk, causal, window, scale, s);
  if (dtype == repro::kBF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, BH, Sq, Sk, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
