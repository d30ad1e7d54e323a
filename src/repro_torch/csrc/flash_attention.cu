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
// prompt does ~1024²/2 pairs per head against ~8 MB of q/k/v/out), at the
// bf16 tensor-core rate for bf16 q.
//
// Two paths; the wrapper's `dense_plan` (kernels/flash_attention.py) picks:
//
// - Tensor cores (bf16 q; path 1): a block per (batch·head, 64 query rows),
//   four 16-row m-tiles held as bf16 A fragments, as FlashAttention-2 cuts
//   them, but two warps per m-tile: key group 0 takes the 64-key tiles of
//   even absolute index and group 1 the odd ones, so the heaviest row tile
//   of a causal prompt walks half as many tiles in a row (that chain of
//   dependent tiles, not the card's rate, bound a one-warp-per-m-tile
//   version of this kernel: PERF.md §6). Group 1 hands its (m, l, acc) to
//   group 0 through shared memory at the end, merged in group order. Each step's two K and V tiles
//   (a contiguous (64, D) slab each in this layout) arrive by 16-byte
//   cp.async in a two-step ring, so step n + 1 is in flight while step n is
//   in the mma.sync products; rows at or past S are zero-filled. The tile
//   code and its numerics are in attn_mma.cuh: f32 online softmax on the
//   accumulator fragments, p rounded to bf16 as the A fragment of p·V, as
//   the TPU kernel rounds p to v's type. Causal and window dead tiles are
//   skipped per block and per warp; the mask is applied only on tiles that
//   cross a warp's diagonal, window edge or S. Row tiles launch heaviest
//   first (the last rows of a causal prompt see the most keys), so the
//   causal imbalance does not leave a tail. Tiles lie at absolute key
//   positions (multiples of 64, the group by the index's parity) and a
//   row's sums run over its own keys only, so the first S' rows at S equal
//   a run at S' on the same prefix bit for bit.
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
constexpr int MW = 4;                      // m-tiles: 16 query rows each
constexpr int MQ = MW * repro::MT_ROWS;    // query rows per block
constexpr int MKT = repro::MT_KEYS;        // keys per K/V tile
constexpr int MKS = 2;                     // key groups: warps per m-tile
constexpr int MTH = MW * MKS * 32;         // threads per block

template <int D>
struct MmaTile {
  static constexpr int LD = D + 8;         // bf16 a row in shared memory: the
                                           // 8 rows of an ldmatrix on distinct banks
  static constexpr size_t RING =           // two steps of MKS K and V tiles
      sizeof(__nv_bfloat16) * (size_t)2 * MKS * 2 * MKT * LD;
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * (size_t)MQ * LD + RING;
  // after the loop the ring holds the other key groups' states
  static_assert(RING >= sizeof(float) * (size_t)MW * 32 * (D / 2 + 4) * (MKS - 1),
                "the states of the other key groups fit in the ring");
};

template <int D>
__global__ void __launch_bounds__(MTH)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 int S, int causal, int window, float scale) {
  constexpr int LD = MmaTile<D>::LD;
  constexpr int CPR = D / 8;                                 // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // MQ x LD
  __nv_bfloat16* ring = qs + MQ * LD;                        // [step][group](K, V) MKT x LD
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mw = warp % MW, grp = warp / MW;                 // m-tile, key group
  const int row0 = (gridDim.y - 1 - blockIdx.y) * MQ;        // heaviest row tile first
  const size_t base = (size_t)blockIdx.x * S * D;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;

  for (int c = threadIdx.x; c < MQ * CPR; c += MTH) {
    const int r = c / CPR, cc = c - r * CPR;
    const bool ok = row0 + r < S;
    repro::cp_async16(qs + r * LD + cc * 8, ok ? qb + (size_t)(row0 + r) * D + cc * 8 : qb,
                      ok ? 16 : 0);
  }
  repro::cp_async_commit();
  // the block's key range: the union of its rows' ranges; tiles [t0, t1).
  // Step n holds tiles tb + n·MKS + i, i < MKS, and key group i takes tile
  // tb + n·MKS + i: a tile's group is its absolute index mod MKS.
  const int last = min(S, row0 + MQ) - 1;
  const int blk_hi = causal ? last + 1 : S;
  const int blk_lo = window > 0 ? max(0, row0 - window + 1) : 0;
  const int t0 = blk_lo / MKT, t1 = (blk_hi + MKT - 1) / MKT;
  const int tb = t0 - t0 % MKS, steps = (t1 - tb + MKS - 1) / MKS;
  auto tile_of = [&](int slot, int i) {
    return ring + ((size_t)slot * MKS + i) * 2 * MKT * LD;
  };
  // step n's tiles into ring slot `slot`; keys at or past S are 0
  auto issue = [&](int n, int slot) {
#pragma unroll
    for (int i = 0; i < MKS; ++i) {
      const int t = tb + n * MKS + i;
      if (t < t0 || t >= t1) continue;
      __nv_bfloat16* kt = tile_of(slot, i);
      __nv_bfloat16* vt = kt + MKT * LD;
      const int j0 = t * MKT;
      for (int c = threadIdx.x; c < MKT * CPR; c += MTH) {
        const int r = c / CPR, cc = c - r * CPR;
        const bool ok = j0 + r < S;
        const size_t off = ok ? (size_t)(j0 + r) * D + cc * 8 : 0;
        repro::cp_async16(kt + r * LD + cc * 8, kb + off, ok ? 16 : 0);
        repro::cp_async16(vt + r * LD + cc * 8, vb + off, ok ? 16 : 0);
      }
    }
  };
  issue(0, 0);
  repro::cp_async_commit();
  if (steps > 1) issue(1, 1);
  repro::cp_async_commit();

  // this thread's rows g and g + 8 of its m-tile: key range [lo, hi)
  const int g = lane >> 2, t4 = lane & 3;
  int rlo[2], rhi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + mw * repro::MT_ROWS + g + 8 * h;
    rhi[h] = i < S ? (causal ? i + 1 : S) : 0;
    rlo[h] = window > 0 ? max(0, i - window + 1) : 0;
  }
  repro::MmaRows<D> st;
  repro::init_rows(st);
  unsigned qa[D / 16][4];
  for (int n = 0; n < steps; ++n) {
    repro::cp_async_wait<1>();      // step n landed (and Q, before the first)
    __syncthreads();
    if (n == 0) repro::load_q_frags<D>(qa, qs + mw * repro::MT_ROWS * LD, LD, lane);
    const int t = tb + n * MKS + grp;
    if (t >= t0 && t < t1) {        // warp-uniform
      const __nv_bfloat16* kt = tile_of(n & 1, grp);
      const int j0 = t * MKT;
      const int lo[2] = {rlo[0] - j0, rlo[1] - j0}, hi[2] = {rhi[0] - j0, rhi[1] - j0};
      repro::fold_tile_auto<D, false>(st, qa, kt, kt + MKT * LD, LD, lo, hi,
                                      scale * repro::LOG2E, nullptr, nullptr, lane);
    }
    __syncthreads();                // every warp is done with the slot
    if (n + 2 < steps) issue(n + 2, n & 1);
    repro::cp_async_commit();
  }
  repro::cp_async_wait<0>();

  // key groups 1.. hand their states to group 0 through the ring, which
  // merges them in group order
  float* xs = reinterpret_cast<float*>(ring);              // [grp - 1][mw][lane][D/2 + 4]
  constexpr int XS = D / 2 + 4;
  if (grp > 0) {
    float* x = xs + (((size_t)(grp - 1) * MW + mw) * 32 + lane) * XS;
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[nn * 4 + e] = st.o[nn][e];
    x[D / 2] = st.m[0];
    x[D / 2 + 1] = st.m[1];
    x[D / 2 + 2] = st.l[0];
    x[D / 2 + 3] = st.l[1];
  }
  __syncthreads();
  if (grp > 0) return;
#pragma unroll
  for (int gg = 1; gg < MKS; ++gg) {
    const float* x = xs + (((size_t)(gg - 1) * MW + mw) * 32 + lane) * XS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m2 = x[D / 2 + h], mn = fmaxf(st.m[h], m2);
      const float f1 = repro::rescale(st.m[h], mn), f2 = repro::rescale(m2, mn);
      st.l[h] = st.l[h] * f1 + x[D / 2 + 2 + h] * f2;
      st.m[h] = mn;
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e)
          st.o[nn][e] = st.o[nn][e] * f1 + x[nn * 4 + e] * f2;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + mw * repro::MT_ROWS + g + 8 * h;
    if (i >= S) continue;
    const float l = fmaxf(st.l[h], 1e-30f);
    __nv_bfloat16* o = out + base + (size_t)i * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<unsigned*>(o + 8 * n) =
          repro::pack_bf16x2(st.o[n][2 * h] / l, st.o[n][2 * h + 1] / l);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int BH, int S,
               int causal, int window, float scale, cudaStream_t stream) {
  const int tiles = (S + MQ - 1) / MQ;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = flash_mma_kernel<D>;
  cudaError_t err = repro::allow_smem(kernel, MmaTile<D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(BH, tiles), MTH, MmaTile<D>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, causal,
      window, scale);
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
int launch(int path, const void* q, const void* k, const void* v, void* out, int BH, int Sq,
           int Sk, int causal, int window, float scale, cudaStream_t s) {
  if (path == 1) {
    if (Sq != Sk) return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma<D>(q, k, v, out, BH, Sq, causal, window, scale, s);
  }
  return launch_fma<D>(q, k, v, out, BH, Sq, Sk, causal, window, scale, s);
}

}  // namespace

// q (BH, Sq, D), k/v (BH, Sk, D), out (BH, Sq, D), all contiguous and
// 16-byte aligned in one type; D in {32, 64, 128}. path 1: tensor cores,
// bf16, Sq == Sk (at most 65535 row tiles of 64); path 0: CUDA cores, f32
// (BH <= 65535). The wrapper's `dense_plan` picks the path from the dtype.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int BH, int Sq, int Sk, int D, int causal,
                               int window, float scale, int dtype, int path,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path != (dtype == repro::kBF16 ? 1 : 0) || (dtype != repro::kF32 && dtype != repro::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq == 0 || BH == 0) return 0;
  switch (D) {
    case 32: return launch<32>(path, q, k, v, out, BH, Sq, Sk, causal, window, scale, s);
    case 64: return launch<64>(path, q, k, v, out, BH, Sq, Sk, causal, window, scale, s);
    case 128: return launch<128>(path, q, k, v, out, BH, Sq, Sk, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
