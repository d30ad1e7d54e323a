// Weight-only int8 matmul: out (M,N) = (x (M,K) · w_q (K,N) int8) * scales (N,),
// and its expert-batched form: out[e] = (x[e] · w_q[e]) * scales[e] for
// x (E,M,K), w_q (E,K,N), scales (E,N).
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul (_kernel),
// and the same kernel under jax.vmap over a leading expert dim
// (repro/models/quantized.py:210-211: one grid dim per expert). Here the
// expert is folded into a grid dim that already exists (the GEMV path's
// row groups, the tensor-core path's 64-row tiles) and a block offsets
// its pointers by its expert, so all E experts run in one launch.
// x is f32 or bf16, accumulation is f32, the per-output-channel scale is
// applied in the epilogue and the output is in x's type. Ragged M, N and K
// are masked here, so unlike the TPU kernel there is no divisibility
// contract (smollm's K=960, N=320 run on the kernel).
//
// Bound on the card: at decode (M = n_slots) and the 64-row prefill chunk,
// the bytes of the int8 weight, read once (K·N); at M of several hundred the
// bf16 operations start to count. The wrapper (kernels/int8_matmul.py,
// `plan`, `batched_plan`) picks one of two paths, a split of K, and for
// the batched call whether a block walks its splits:
//
// - GEMV path (M <= 16, and f32 x at any M): CUDA-core FMAs, since at M = 8
//   tensor cores buy nothing. 256 threads a 64-column tile of 16 rows;
//   thread (c4, kg) owns 4 columns and rows kg, kg + 16, ... of a split,
//   then the warp's two row groups are added and the 8 warps summed in
//   warp order. Splits are at least 64 rows and as many as keep the grid of
//   ONE expert within one wave of two blocks per SM; the split depends on
//   (K, N) only, so a row's output is bit-identical at M = 1 and M = 8. The
//   weight tile arrives as 16-byte cp.async copies, x as f32 in shared
//   memory (16 rows of a K index side by side, read 4 at a time).
// - Tensor-core path (bf16 x, M > 16): 64x64 output tiles, 4 warps of
//   32x32, mma.sync m16n8k16 bf16 -> f32. x tiles and the weight tiles AS
//   INT8 arrive by cp.async in a 4-stage ring (a full K step copies from
//   pointers that advance by the step); each weight tile is widened to a
//   bf16 shared tile (int8 is exact in bf16, and a bf16 product is exact in
//   f32) and read with ldmatrix.trans. K is split only while the output
//   tiles of one M tile leave SMs idle, at least three 64-row K steps a
//   split, so every split boundary is a step boundary.
//
// Two ways to run the splits, with the same bits:
//
// - Split blocks (the 2-D call, and a batched call too small to fill the
//   card): one block per (tile, split) writes its split's f32 sums to
//   scratch and counts itself done on the tile's semaphore; the tile's last
//   block adds the splits in index order starting from +0.0f (merge_tile)
//   and applies the scale. No second kernel is launched (one launch alone
//   costs ~5 us of device time on the H100).
// - Walking blocks (a batched call whose experts' tiles already fill the
//   card, as qwen2-moe's 60 experts do): one block per tile takes every
//   split in index order, sums each exactly as its split block sums it (a
//   fresh accumulator, the same fmaf chains or mma.sync products over the
//   same rows in the same order, the same pair and warp-order reduction),
//   and adds it to a running total in registers that starts at +0.0f,
//   which is merge_tile's order. So every output equals the split blocks'
//   output bit for bit, with no scratch, no semaphore, no fence and no
//   merge. A bit depends only on each element's own chain, so the walking
//   blocks may cut M, N and the threads otherwise: the GEMV walk takes 8
//   rows a block at M <= 8 and keeps a split's reduction inside one warp
//   (gemv_walk_kernel); the tensor-core walk takes 64 x 128 tiles of eight
//   warps, streams all of K through its ring and folds its accumulators
//   at each split's last step, widening step t + 1's weight tile while
//   step t's products run (one barrier a step).
//
// int8 is widened by byte permutes and an add (repro::i8_at), not the
// quarter-rate I2F. What still holds the walking kernels back (PERF.md §6):
// neither reaches half of its byte bound. The GEMV walk's bit equality
// fixes its work at f32 FMA chains (1.4 G FMAs a launch at qwen2-moe's
// M 8, ~0.04 ms of the card's f32 rate alone), each weight word costs
// nine widening instructions and three shared-memory loads beside its 32
// FMAs, and each split ends in a barrier and a reduction: it is bound by
// instruction issue and latency, not bytes. The tensor-core walk waits on
// each K step's ldmatrix and mma.sync chain and its widening, and leaves a
// partial last wave (660 or 960 blocks at two a SM); wgmma with TMA and a
// persistent grid are later work.

#include <type_traits>

#include "hopper.cuh"

namespace {

using repro::cp_async16;

// The raw bits of an element (a bf16 in the low half), for packing x into
// 16-byte words; a bf16 widens to f32 exactly as its bits << 16.
__device__ __forceinline__ unsigned bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned bits_of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// ------------------------------------------- split merge, both paths
// The last block of a split tile (see repro::last_split_done) writes its
// rows x cols outputs: out[m, n] = scale[n] · Σ part[s, m, n], summed in
// split-index order whatever the block timing. Each thread owns up to QMAX
// groups of 4 columns and keeps 16 float4 loads in flight a round.
template <typename T, int QMAX>
__device__ void merge_tile(const float* part, const float* scales, T* out, int M, int N,
                           int S, int m0, int n0, int rows, int cols) {
  const size_t mn = (size_t)M * N;
  const int nt = blockDim.x;
  if (N % 4 != 0) {                   // rows not 16-byte aligned: one at a time
    for (int o = threadIdx.x; o < rows * cols; o += nt) {
      const int m = m0 + o / cols, n = n0 + o % cols;
      if (m >= M || n >= N) continue;
      float s = 0.f;
      for (int sp = 0; sp < S; ++sp) s += __ldcg(part + sp * mn + (size_t)m * N + n);
      out[(size_t)m * N + n] = repro::from_f<T>(s * scales[n]);
    }
    return;
  }
  constexpr int CH = QMAX >= 16 ? 1 : 16 / QMAX;   // splits a round
  const int cq = cols / 4;
  size_t idx[QMAX];
  bool ok[QMAX];
  float4 acc[QMAX];
#pragma unroll
  for (int i = 0; i < QMAX; ++i) {
    const int q = threadIdx.x + i * nt, r = q / cq, c = (q % cq) * 4;
    ok[i] = q < rows * cq && m0 + r < M && n0 + c < N;
    idx[i] = (size_t)(m0 + r) * N + n0 + c;
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int sp0 = 0; sp0 < S; sp0 += CH) {
    float4 v[CH][QMAX];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < QMAX; ++i)
        v[c][i] = ok[i] && sp0 + c < S
                      ? __ldcg(reinterpret_cast<const float4*>(part + (sp0 + c) * mn + idx[i]))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (sp0 + c < S) {
#pragma unroll
        for (int i = 0; i < QMAX; ++i) {
          acc[i].x += v[c][i].x;
          acc[i].y += v[c][i].y;
          acc[i].z += v[c][i].z;
          acc[i].w += v[c][i].w;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < QMAX; ++i) {
    if (!ok[i]) continue;
    const int n = static_cast<int>(idx[i] % N);
    const float a4[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) out[idx[i] + j] = repro::from_f<T>(a4[j] * scales[n + j]);
  }
}

// ---------------------------------------------------------------- GEMV path
constexpr int GV_THREADS = 256, GV_BN = 64, GV_MT = 16, GV_KS_MAX = 256;
constexpr int GV_KG = GV_THREADS / (GV_BN / 4);      // 16 row groups
constexpr int GV_WARPS = GV_THREADS / 32;
// the weight (KS x 64 int8) and x (KS x 16 f32) tiles, then the warps'
// partial sums (8 x 16 x 64 f32) in the same bytes
constexpr int GV_SMEM = GV_WARPS * GV_MT * GV_BN * 4;
static_assert(GV_KS_MAX * GV_BN + GV_MT * GV_KS_MAX * 4 <= GV_SMEM, "gemv tiles");

// grid (N tiles, splits, E x 16-row groups); expert e = blockIdx.z / groups
template <typename T>
__global__ void __launch_bounds__(GV_THREADS)
gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scales, T* __restrict__ out,
            float* __restrict__ part, int* __restrict__ sem, int M, int N, int K,
            int KS, int vec_w) {
  __shared__ __align__(16) unsigned char smem[GV_SMEM];
  int8_t* ws = reinterpret_cast<int8_t*>(smem);                    // kn x 64
  float* xs = reinterpret_cast<float*>(smem + GV_KS_MAX * GV_BN);  // kn x 16 rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = (M + GV_MT - 1) / GV_MT, e = blockIdx.z / groups;
  x += (size_t)e * M * K;
  w += (size_t)e * K * N;
  scales += (size_t)e * N;
  out += (size_t)e * M * N;
  if (part != nullptr) part += (size_t)e * gridDim.y * M * N;
  const int n0 = blockIdx.x * GV_BN, split = blockIdx.y, m0 = (blockIdx.z - e * groups) * GV_MT;
  const int k0 = split * KS, kn = min(KS, K - k0), mr = min(GV_MT, M - m0);

  // weight rows k0 .. k0+kn, columns n0 .. n0+64: four 16-byte chunks a row
  for (int i = tid; i < kn * 4; i += GV_THREADS) {
    const int r = i >> 2, c = (i & 3) * 16, gn = n0 + c;
    int8_t* dst = ws + r * GV_BN + c;
    const int8_t* src = w + (size_t)(k0 + r) * N + gn;
    if (vec_w && gn + 16 <= N) {
      cp_async16(dst, src, 16);
    } else {
      for (int e = 0; e < 16; ++e) dst[e] = gn + e < N ? src[e] : int8_t(0);
    }
  }
  repro::cp_async_commit();
  // x[m0 .. m0+mr, k0 + kk] as f32 at xs[kk][row] (rows past mr are 0):
  // thread kk < kn issues all its rows' loads before it stores any
  static_assert(GV_KS_MAX <= GV_THREADS, "one x column a thread");
  if (tid < kn) {
    float xv[GV_MT];
#pragma unroll
    for (int r = 0; r < GV_MT; ++r)
      xv[r] = r < mr ? repro::to_f(x[(size_t)(m0 + r) * K + k0 + tid]) : 0.f;
    float4* dst = reinterpret_cast<float4*>(xs + tid * GV_MT);
#pragma unroll
    for (int q = 0; q < GV_MT / 4; ++q)
      dst[q] = make_float4(xv[4 * q], xv[4 * q + 1], xv[4 * q + 2], xv[4 * q + 3]);
  }
  repro::cp_async_wait<0>();
  __syncthreads();

  // thread (c4, kg): columns n0 + 4·c4 .. +3, rows kg, kg + 16, ...
  const int c4 = tid & 15, kg = tid >> 4;
  float acc[GV_MT][4];
#pragma unroll
  for (int r = 0; r < GV_MT; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  for (int kk = kg; kk < kn; kk += GV_KG) {
    const unsigned wv = *reinterpret_cast<const unsigned*>(ws + kk * GV_BN + c4 * 4);
    float wf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wf[j] = repro::i8_at(wv, j);
    const float4* xq = reinterpret_cast<const float4*>(xs + kk * GV_MT);
#pragma unroll
    for (int q = 0; q < GV_MT / 4; ++q) {
      if (4 * q < mr) {
        const float4 x4 = xq[q];
        const float xr[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[4 * q + u][j] = fmaf(xr[u], wf[j], acc[4 * q + u][j]);
      }
    }
  }
  // the warp's two row groups (a + b == b + a, so both halves agree), then
  // the eight warps in warp order
#pragma unroll
  for (int r = 0; r < GV_MT; ++r)
    if (r < mr)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
  __syncthreads();                                   // the tiles are dead
  float4* red = reinterpret_cast<float4*>(smem);     // [warp][row][16 x float4]
  if (lane < 16) {
#pragma unroll
    for (int r = 0; r < GV_MT; ++r)
      if (r < mr)
        red[(warp * GV_MT + r) * (GV_BN / 4) + c4] =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  const float* redf = reinterpret_cast<const float*>(smem);
  const bool split_k = gridDim.y > 1;
  for (int o = tid; o < mr * GV_BN; o += GV_THREADS) {
    const int r = o / GV_BN, c = o - r * GV_BN, gn = n0 + c;
    if (gn >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < GV_WARPS; ++wi) s += redf[(wi * GV_MT + r) * GV_BN + c];
    const size_t gm = m0 + r;
    if (split_k) part[((size_t)split * M + gm) * N + gn] = s;
    else out[gm * N + gn] = repro::from_f<T>(s * scales[gn]);
  }
  if (split_k && repro::last_split_done(sem + blockIdx.z * gridDim.x + blockIdx.x, gridDim.y))
    merge_tile<T, 1>(part, scales, out, M, N, gridDim.y, m0, n0, mr, GV_BN);
}

// Walking blocks. grid (N tiles, 1, E x MT-row groups): a block takes its
// tile's S splits in index order and keeps their running total from +0.0f
// in registers. Each split is summed as gemv_kernel sums it: thread (c4,
// kg) runs the same fmaf chain over rows kg, kg + 16, ... of the split
// from a fresh accumulator, the row-group pair (2p, 2p + 1) is added, and
// the eight pairs are added in order from 0.f. Here one warp holds all 16
// row groups of 8 columns (lane = 2·kg + c4 % 2, c4 = 2·warp + lane % 2),
// so a split's reduction stays in the warp (shuffles and the warp's own
// shared memory) and a split costs one block barrier. MT = 8 rows at
// M <= 8: a row's chain does not depend on the rows beside it, and half
// the accumulators let four blocks share an SM.
// Shared memory, for splits of KS rows: a ring of GW_STAGES weight tiles
// (KS x 64 int8, each row's four 16-byte chunks swizzled by row so that the
// 16 rows a warp reads at once fall on two banks each at most), two x tiles
// (KS x XP f32, x columns side by side) and the warps' pair sums. Split
// s + 1's weight tile is in flight and its x in registers (one 16-byte load
// a thread) while split s computes.
constexpr int GW_STAGES = 2;

template <int MT>
struct GwShape {
  static constexpr int XP = MT + 4;               // floats a K index of x (bank spread)
  static constexpr int RED = 8 * MT * 8;          // a warp's pair sums: [pair][row][8 cols]
  static constexpr int OUTS = MT * 8 / 32;        // outputs a lane
};

template <int MT>
int gw_smem(int ks) {
  return GW_STAGES * ks * GV_BN + 2 * ks * GwShape<MT>::XP * 4 +
         GV_WARPS * GwShape<MT>::RED * 4;
}

template <typename T, int MT>
__global__ void __launch_bounds__(GV_THREADS)
gemv_walk_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scales, T* __restrict__ out, int M, int N, int K,
                 int KS, int S, int vec_x, int vec_w) {
  using G = GwShape<MT>;
  constexpr int EL = 16 / sizeof(T);              // x elements a 16-byte chunk
  constexpr int XCH = MT * GV_KS_MAX / EL / GV_THREADS;   // x chunks a thread
  static_assert(XCH * EL * GV_THREADS == MT * GV_KS_MAX, "x chunks");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int groups = (M + MT - 1) / MT, e = blockIdx.z / groups;
  x += (size_t)e * M * K;
  w += (size_t)e * K * N;
  scales += (size_t)e * N;
  out += (size_t)e * M * N;
  const int n0 = blockIdx.x * GV_BN, m0 = (blockIdx.z - e * groups) * MT;
  const int mr = min(MT, M - m0);
  const int kg = lane >> 1, c4 = 2 * warp + (lane & 1);
  float* xs0 = reinterpret_cast<float*>(smem + GW_STAGES * KS * GV_BN);
  float* red = xs0 + 2 * KS * G::XP + warp * G::RED;
  auto wtile = [&](int s) { return reinterpret_cast<int8_t*>(smem) + (s % GW_STAGES) * KS * GV_BN; };
  auto xtile = [&](int s) { return xs0 + (s & 1) * KS * G::XP; };
  auto kn_of = [&](int s) { return min(KS, K - s * KS); };

  // weight rows of split s: chunk c of row r at chunk c ^ ((r >> 1) & 3)
  auto load_w = [&](int s) {
    int8_t* ws = wtile(s);
    const int k0 = s * KS, kn = kn_of(s);
    for (int i = tid; i < kn * 4; i += GV_THREADS) {
      const int r = i >> 2, c = i & 3, gn = n0 + c * 16;
      int8_t* dst = ws + r * GV_BN + ((c ^ ((r >> 1) & 3)) << 4);
      const int8_t* src = w + (size_t)(k0 + r) * N + gn;
      if (vec_w && gn + 16 <= N) {
        cp_async16(dst, src, 16);
      } else {
        for (int b = 0; b < 16; ++b) dst[b] = gn + b < N ? src[b] : int8_t(0);
      }
    }
  };
  // x rows m0 .. m0+MT of split s as raw 16-byte chunks: chunk i is row
  // i % MT, K elements (i / MT)·EL .. +EL; rows past mr and K past the
  // split are +0.0. store_x widens them to f32 at xs[k][row].
  uint4 xr[XCH];
  auto load_x = [&](int s) {
    const int k0 = s * KS, kn = kn_of(s);
#pragma unroll
    for (int j = 0; j < XCH; ++j) {
      const int i = tid + j * GV_THREADS, r = i % MT, kc = (i / MT) * EL;
      const T* src = x + (size_t)(m0 + r) * K + k0 + kc;
      if (r < mr && vec_x && kc + EL <= kn) {
        xr[j] = *reinterpret_cast<const uint4*>(src);
      } else {
        unsigned wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < EL; ++b)
          if (r < mr && kc + b < kn) wd[b * 4 / EL] |= bits_of(src[b]) << (b * (128 / EL) % 32);
        xr[j] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
    }
  };
  auto store_x = [&](int s) {
    float* xs = xtile(s);
    const int kn = kn_of(s);
#pragma unroll
    for (int j = 0; j < XCH; ++j) {
      const int i = tid + j * GV_THREADS, r = i % MT, kc = (i / MT) * EL;
      const unsigned wd[4] = {xr[j].x, xr[j].y, xr[j].z, xr[j].w};
#pragma unroll
      for (int b = 0; b < EL; ++b)
        if (kc + b < kn)
          xs[(kc + b) * G::XP + r] = EL == 4 ? __uint_as_float(wd[b])
                                             : __uint_as_float(wd[b / 2] >> (b % 2 * 16) << 16);
    }
  };

#pragma unroll
  for (int s = 0; s < GW_STAGES - 1; ++s) {
    if (s < S) load_w(s);
    repro::cp_async_commit();
  }
  load_x(0);
  store_x(0);

  float total[G::OUTS];
#pragma unroll
  for (int i = 0; i < G::OUTS; ++i) total[i] = 0.f;   // merge_tile's start
  for (int s = 0; s < S; ++s) {
    repro::cp_async_wait<GW_STAGES - 2>();
    __syncthreads();   // split s's tiles are in; split s - 1's are dead
    if (s + GW_STAGES - 1 < S) load_w(s + GW_STAGES - 1);
    repro::cp_async_commit();
    if (s + 1 < S) load_x(s + 1);

    const int8_t* ws = wtile(s);
    const float* xs = xtile(s);
    const int kn = kn_of(s);
    float acc[MT][4];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    for (int kk = kg; kk < kn; kk += GV_KG) {
      const unsigned wv = *reinterpret_cast<const unsigned*>(
          ws + kk * GV_BN + (((c4 >> 2) ^ ((kk >> 1) & 3)) << 4) + (c4 & 3) * 4);
      float wf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wf[j] = repro::i8_at(wv, j);
      const float4* xq = reinterpret_cast<const float4*>(xs + kk * G::XP);
#pragma unroll
      for (int q = 0; q < MT / 4; ++q) {
        if (4 * q < mr) {
          const float4 x4 = xq[q];
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[4 * q + u][j] = fmaf(xv[u], wf[j], acc[4 * q + u][j]);
        }
      }
    }
    if (s + 1 < S) store_x(s + 1);
    // the row-group pair (2p, 2p + 1) is lanes 4p + c and 4p + 2 + c
#pragma unroll
    for (int r = 0; r < MT; ++r)
      if (r < mr)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 2);
    if ((lane & 2) == 0) {
      float4* red4 = reinterpret_cast<float4*>(red);
#pragma unroll
      for (int r = 0; r < MT; ++r)
        if (r < mr)
          red4[((lane >> 2) * MT + r) * 2 + (lane & 1)] =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncwarp();
    // lane's output o: row o / 8, column 4·(2·warp + (o % 8) / 4) + o % 4
#pragma unroll
    for (int i = 0; i < G::OUTS; ++i) {
      const int o = lane + 32 * i;
      if (o < mr * 8) {
        float sum = 0.f;
#pragma unroll
        for (int p = 0; p < 8; ++p) sum += red[(p * MT + (o >> 3)) * 8 + (o & 7)];
        total[i] += sum;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < G::OUTS; ++i) {
    const int o = lane + 32 * i, r = o >> 3, gn = n0 + 8 * warp + (o & 7);
    if (o < mr * 8 && gn < N) out[(size_t)(m0 + r) * N + gn] = repro::from_f<T>(total[i] * scales[gn]);
  }
}

// --------------------------------------------------------- tensor-core path
// A block computes a 64 x BN output tile with BN / 16 warps of 32 x 32, each
// two m16 by four n8 m16n8k16 products a 16-deep slice; K steps of 64 rows,
// STAGES in the ring (STAGES - 1 in flight). The 2-D call's tile is 64 x 64
// with four stages.
constexpr int TC_BM = 64, TC_BN = 64, TC_BK = 64, TC_STAGES = 4;
constexpr int TC_WTM = 32, TC_WTN = 32, TC_MI = TC_WTM / 16, TC_NI = TC_WTN / 8;
constexpr int TC_XLD = TC_BK + 8;   // bf16 a row of x in shared memory (144 B:
                                    // the 8 rows of an ldmatrix on distinct banks)
constexpr int TC_XBYTES = TC_BM * TC_XLD * 2;
// the walking blocks: 64 x 128 tiles, four stages, registers capped so
// that two blocks share an SM
constexpr int TC_WALK_BN = 128, TC_WALK_STAGES = 4, TC_WALK_MINB = 2;

template <int BN>
__host__ __device__ constexpr int tc_threads() { return TC_BM / TC_WTM * BN / TC_WTN * 32; }
template <bool WALK, int BN, int STAGES>
constexpr int tc_smem() {
  return STAGES * (TC_XBYTES + TC_BK * BN) + (WALK ? 2 : 1) * TC_BK * (BN + 8) * 2;
}

// grid (N tiles, E x 64-row M tiles, splits); expert e = blockIdx.y / M tiles.
// WALK: one block a tile (gridDim.z = 1) streams all of K and folds its
// accumulators into `total` (from +0.0f) after each split's last step.
template <bool WALK, int BN, int STAGES, int MINB>
__global__ void __launch_bounds__(tc_threads<BN>(), MINB)
tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ scales, __nv_bfloat16* __restrict__ out,
          float* __restrict__ part, int* __restrict__ sem, int M, int N, int K, int KS,
          int vec_x, int vec_w) {
  constexpr int BM = TC_BM, BK = TC_BK, T = tc_threads<BN>();
  constexpr int MI = TC_MI, NI = TC_NI, XLD = TC_XLD, WLD = BN + 8;
  constexpr int STAGE_BYTES = TC_XBYTES + BK * BN;      // x bf16 + w int8
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * STAGE_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mtiles = (M + BM - 1) / BM, e = blockIdx.y / mtiles;
  x += (size_t)e * M * K;
  w += (size_t)e * K * N;
  scales += (size_t)e * N;
  out += (size_t)e * M * N;
  if (part != nullptr) part += (size_t)e * gridDim.z * M * N;
  const int n0 = blockIdx.x * BN, m0 = (blockIdx.y - e * mtiles) * BM, split = blockIdx.z;
  const int kbeg = WALK ? 0 : split * KS, kend = WALK ? K : min(K, kbeg + KS);
  const int nsteps = (kend - kbeg + BK - 1) / BK;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // x rows m0.. and weight rows k0.. of one K step into ring slot `slot`;
  // what lies past M, N or the split's end is zero. A full step (every
  // row of K in the split, aligned rows) takes the fast path: one 16-byte
  // copy per chunk from a pointer that advances by a step, rows past M and
  // columns past N zero-filled.
  constexpr int XC = BM * (BK / 8) / T, WC = BK * (BN / 16) / T;   // chunks a thread
  static_assert(XC * T == BM * (BK / 8) && WC * T == BK * (BN / 16), "chunks");
  const __nv_bfloat16* xsrc[XC];
  const int8_t* wsrc[WC];
  int xoff[XC], woff[WC], xok[XC], wok[WC];
#pragma unroll
  for (int j = 0; j < XC; ++j) {
    const int i = tid + j * T, r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    xok[j] = m0 + r < M ? 16 : 0;
    xsrc[j] = xok[j] ? x + (size_t)(m0 + r) * K + kbeg + c : x;
    xoff[j] = r * XLD + c;
  }
#pragma unroll
  for (int j = 0; j < WC; ++j) {
    const int i = tid + j * T, r = i / (BN / 16), c = (i % (BN / 16)) * 16;
    wok[j] = n0 + c + 16 <= N ? 16 : 0;
    wsrc[j] = wok[j] ? w + (size_t)(kbeg + r) * N + n0 + c : w;
    woff[j] = r * BN + c;
  }
  const bool fast = vec_x && vec_w;
  auto load_stage = [&](int step, int slot) {
    unsigned char* st = smem + slot * STAGE_BYTES;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st);
    int8_t* w8 = reinterpret_cast<int8_t*>(st + TC_XBYTES);
    const int k0 = kbeg + step * BK;
    if (fast && k0 + BK <= kend) {
#pragma unroll
      for (int j = 0; j < XC; ++j)
        cp_async16(xs + xoff[j], xok[j] ? xsrc[j] + step * BK : x, xok[j]);
#pragma unroll
      for (int j = 0; j < WC; ++j)
        cp_async16(w8 + woff[j], wok[j] ? wsrc[j] + (size_t)step * BK * N : w, wok[j]);
      return;
    }
    for (int i = tid; i < BM * (BK / 8); i += T) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8, gm = m0 + r, gk = k0 + c;
      __nv_bfloat16* dst = xs + r * XLD + c;
      const __nv_bfloat16* src = x + (size_t)gm * K + gk;
      if (gm < M && vec_x && gk + 8 <= kend) {
        cp_async16(dst, src, 16);
      } else if (gm < M && gk < kend) {
        for (int e = 0; e < 8; ++e) dst[e] = gk + e < kend ? src[e] : zero;
      } else {
        cp_async16(dst, x, 0);
      }
    }
    for (int i = tid; i < BK * (BN / 16); i += T) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16, gk = k0 + r, gn = n0 + c;
      int8_t* dst = w8 + r * BN + c;
      const int8_t* src = w + (size_t)gk * N + gn;
      if (gk < kend && vec_w && gn + 16 <= N) {
        cp_async16(dst, src, 16);
      } else if (gk < kend && gn < N) {
        for (int e = 0; e < 16; ++e) dst[e] = gn + e < N ? src[e] : int8_t(0);
      } else {
        cp_async16(dst, w, 0);
      }
    }
  };

  float acc[MI][NI][4], total[WALK ? MI : 1][WALK ? NI : 1][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  if constexpr (WALK) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[mi][ni][e] = 0.f;   // merge_tile's start
  }
  const int wm = (warp / (BN / TC_WTN)) * TC_WTM, wn = (warp % (BN / TC_WTN)) * TC_WTN;

  // the int8 weight tile of ring slot `slot`, widened to bf16 into `dst`
  auto widen = [&](int slot, __nv_bfloat16* dst) {
    const int8_t* w8 = reinterpret_cast<const int8_t*>(smem + slot * STAGE_BYTES + TC_XBYTES);
    for (int i = tid; i < BK * (BN / 16); i += T) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(w8 + r * BN + c);
      const unsigned words[4] = {v.x, v.y, v.z, v.w};
      unsigned p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const unsigned word = words[e >> 1];
        p[e] = repro::bf16x2_of_ints(repro::i8_at(word, (e & 1) * 2),
                                     repro::i8_at(word, (e & 1) * 2 + 1));
      }
      uint4* d = reinterpret_cast<uint4*>(dst + r * WLD + c);
      d[0] = make_uint4(p[0], p[1], p[2], p[3]);
      d[1] = make_uint4(p[4], p[5], p[6], p[7]);
    }
  };
  // acc += the K step's x tile (ring slot `slot`) · its widened weight tile
  auto mma_step = [&](int slot, const __nv_bfloat16* wt) {
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(smem + slot * STAGE_BYTES);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        repro::ldmatrix_x4(a[mi], xs + (wm + mi * 16 + (lane & 15)) * XLD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        unsigned r[4];
        repro::ldmatrix_x4_trans(
            r, wt + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * WLD + wn + nj * 16 + (lane >> 4) * 8);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) repro::mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_stage(s, s);
    repro::cp_async_commit();
  }
  if constexpr (!WALK) {
    for (int t = 0; t < nsteps; ++t) {
      const int slot = t % STAGES;
      repro::cp_async_wait<STAGES - 2>();
      __syncthreads();          // step t landed; every warp is past step t-1
      widen(slot, wb);
      const int nt = t + STAGES - 1;
      if (nt < nsteps) load_stage(nt, nt % STAGES);
      repro::cp_async_commit();
      __syncthreads();          // the widened weight tile is complete
      mma_step(slot, wb);
    }
  } else {
    // two widened tiles: step t's products and step t + 1's widening share
    // one barrier
    static_assert(STAGES >= 3, "the walk widens one step ahead");
    int split_left = KS / BK;   // steps left in the current split
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();            // step 0 landed
    widen(0, wb);
    for (int t = 0; t < nsteps; ++t) {
      repro::cp_async_wait<STAGES - 3>();
      __syncthreads();          // step t + 1 landed, step t widened; step t - 1 done
      const int nt = t + STAGES - 1;
      if (nt < nsteps) load_stage(nt, nt % STAGES);
      repro::cp_async_commit();
      mma_step(t % STAGES, wb + (t & 1) * BK * WLD);
      if (t + 1 < nsteps) widen((t + 1) % STAGES, wb + ((t + 1) & 1) * BK * WLD);
      if (--split_left == 0 || t + 1 == nsteps) {   // the split's last step
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              total[mi][ni][e] += acc[mi][ni][e];
              acc[mi][ni][e] = 0.f;
            }
        split_left = KS / BK;
      }
    }
  }

  // accumulator (mi, ni): rows g and g + 8, columns 2·(lane % 4) + {0, 1}
  const int g = lane >> 2, tq = lane & 3;
  const bool split_k = !WALK && gridDim.z > 1;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + h * 8;
        if (row >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + ni * 8 + tq * 2 + e;
          if (col >= N) continue;
          float v;
          if constexpr (WALK) v = total[mi][ni][h * 2 + e];
          else v = acc[mi][ni][h * 2 + e];
          if (split_k) part[((size_t)split * M + row) * N + col] = v;
          else out[(size_t)row * N + col] = __float2bfloat16(v * scales[col]);
        }
      }
  if (split_k && repro::last_split_done(sem + blockIdx.y * gridDim.x + blockIdx.x, gridDim.z))
    merge_tile<__nv_bfloat16, BM * BN / 4 / T>(part, scales, out, M, N, gridDim.z, m0, n0,
                                               BM, BN);
}

template <bool WALK, int BN, int STAGES, int MINB>
int launch_tc(const __nv_bfloat16* x, const int8_t* w, const float* sc, __nv_bfloat16* out,
              float* part, int* sem, int E, int M, int N, int K, int ks, int splits,
              int vec_x, int vec_w, cudaStream_t s) {
  constexpr int smem = tc_smem<WALK, BN, STAGES>();
  cudaError_t err = cudaFuncSetAttribute(tc_kernel<WALK, BN, STAGES, MINB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long mt = (long long)E * ((M + TC_BM - 1) / TC_BM);
  if (mt > 65535 || splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + BN - 1) / BN, static_cast<unsigned>(mt), WALK ? 1 : splits);
  tc_kernel<WALK, BN, STAGES, MINB><<<grid, tc_threads<BN>(), smem, s>>>(
      x, w, sc, out, part, sem, M, N, K, ks, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int MT>
int launch_gemv_walk_mt(const T* x, const int8_t* w, const float* sc, T* out, int E, int M,
                        int N, int K, int ks, int splits, int vec_w, cudaStream_t s) {
  const int smem = gw_smem<MT>(ks);
  cudaError_t err = cudaFuncSetAttribute(gemv_walk_kernel<T, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_x = K % (16 / sizeof(T)) == 0 && aligned16(x);
  dim3 grid((N + GV_BN - 1) / GV_BN, 1, static_cast<unsigned>(E * ((M + MT - 1) / MT)));
  gemv_walk_kernel<T, MT><<<grid, GV_THREADS, smem, s>>>(x, w, sc, out, M, N, K, ks, splits,
                                                         vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gemv_walk(const T* x, const int8_t* w, const float* sc, T* out, int E, int M, int N,
                     int K, int ks, int splits, int vec_w, cudaStream_t s) {
  if (M <= 8) return launch_gemv_walk_mt<T, 8>(x, w, sc, out, E, M, N, K, ks, splits, vec_w, s);
  return launch_gemv_walk_mt<T, 16>(x, w, sc, out, E, M, N, K, ks, splits, vec_w, s);
}

template <typename T>
int launch(const void* x, const void* w, const void* scales, void* out, void* part,
           void* sem, int E, int M, int N, int K, int path, int ks, int splits, int walk,
           cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scales);
  T* ot = static_cast<T*>(out);
  float* pt = static_cast<float*>(part);
  int* st = static_cast<int*>(sem);
  const int vec_w = N % 16 == 0 && aligned16(w);
  if (E < 1 || splits < 1 || (splits - 1) * ks >= K || splits * ks < K)
    return static_cast<int>(cudaErrorInvalidValue);
  // a walk has splits to walk and needs no scratch; split blocks with more
  // than one split need both
  if (walk ? splits < 2 : splits > 1 && (part == nullptr || sem == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 0) {
    const long long groups = (long long)E * ((M + GV_MT - 1) / GV_MT);
    if (ks < 1 || ks > GV_KS_MAX || groups > 65535 || splits > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    if (walk && ks % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (walk) return launch_gemv_walk(xt, wt, sc, ot, E, M, N, K, ks, splits, vec_w, s);
    dim3 grid((N + GV_BN - 1) / GV_BN, splits, static_cast<unsigned>(groups));
    gemv_kernel<T><<<grid, GV_THREADS, 0, s>>>(xt, wt, sc, ot, pt, st, M, N, K, ks, vec_w);
  } else if (path == 1) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const int vec_x = K % 8 == 0 && aligned16(x);
      if (!walk)
        return launch_tc<false, TC_BN, TC_STAGES, 1>(xt, wt, sc, ot, pt, st, E, M, N, K, ks, splits,
                                                  vec_x, vec_w, s);
      if (ks % TC_BK != 0) return static_cast<int>(cudaErrorInvalidValue);
      return launch_tc<true, TC_WALK_BN, TC_WALK_STAGES, TC_WALK_MINB>(xt, wt, sc, ot, nullptr, nullptr, E, M,
                                                          N, K, ks, splits, vec_x, vec_w, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);   // tensor cores take bf16 x
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// path 0 = GEMV (CUDA cores), 1 = tensor cores (bf16 x); K is cut into
// `splits` pieces of `ks` rows. walk = 0: one block per (tile, split), and
// with splits > 1 `part` is (E, splits, M, N) f32 scratch and `sem` holds
// one zeroed int32 per output tile of every expert (the kernel leaves them
// zeroed). walk = 1 (splits > 1): one block per tile walks the splits;
// `part` and `sem` are not read. x (E,M,K), w (E,K,N), scales (E,N) and out
// (E,M,N) are contiguous; every expert takes the same plan, the wrapper's
// `plan(M, K, N)`, and either way gets its bits. The 2-D call is E = 1.
extern "C" int int8_matmul_batched(const void* x, const void* w, const void* scales,
                                   void* out, void* part, void* sem, int E, int M, int N,
                                   int K, int x_dtype, int path, int ks, int splits, int walk,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == repro::kF32)
    return launch<float>(x, w, scales, out, part, sem, E, M, N, K, path, ks, splits, walk, s);
  if (x_dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, w, scales, out, part, sem, E, M, N, K, path, ks, splits,
                                 walk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
