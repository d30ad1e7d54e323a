// Weight-only int8 matmul: out (M,N) = (x (M,K) · w_q (K,N) int8) * scales (N,),
// and its expert-batched form: out[e] = (x[e] · w_q[e]) * scales[e] for
// x (E,M,K), w_q (E,K,N), scales (E,N).
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul (_kernel),
// and the same kernel under jax.vmap over a leading expert dim
// (repro/models/quantized.py:210-211: one grid dim per expert). Here the
// expert is folded into a grid dim that already exists (the GEMV path's
// 16-row groups, the tensor-core path's 64-row tiles), every expert takes
// the plan of the 2-D call at its (M, K, N), and a block offsets its
// pointers by its expert: expert e's rows are the 2-D kernel's rows on
// that slice, bit for bit, in one launch for all E.
// x is f32 or bf16, accumulation is f32, the per-output-channel scale is
// applied in the epilogue and the output is in x's type. Ragged M, N and K
// are masked here, so unlike the TPU kernel there is no divisibility
// contract (smollm's K=960, N=320 run on the kernel).
//
// Bound on the card: at decode (M = n_slots) and the 64-row prefill chunk,
// the bytes of the int8 weight, read once (K·N); at M of several hundred the
// bf16 operations start to count. The wrapper (kernels/int8_matmul.py,
// `plan`) picks one of two paths, and a split of K:
//
// - GEMV path (M <= 16, and f32 x at any M): CUDA-core FMAs, since at M = 8
//   tensor cores buy nothing. One 256-thread block per (64-column tile,
//   K split, 16-row group). Splits are at least 64 rows and as many as keep
//   the grid one wave of two blocks per SM; the split depends on (K, N)
//   only, so a row's output is bit-identical at M = 1 and M = 8. The weight
//   tile arrives as 16-byte cp.async copies (all in flight at once), x as
//   f32 in shared memory (16 rows of a K index side by side, read 4 at a
//   time); each thread owns 4 columns and every 16th row of the split.
// - Tensor-core path (bf16 x, M > 16): 64x64 output tiles, 4 warps of
//   32x32, mma.sync m16n8k16 bf16 -> f32. x tiles and the weight tiles AS
//   INT8 arrive by cp.async in a 4-stage ring (a full K step copies from
//   pointers that advance by the step); each weight tile is widened to a
//   bf16 shared tile (int8 is exact in bf16, and a bf16 product is exact in
//   f32) and read with ldmatrix.trans. K is split only while the output
//   tiles leave SMs idle, at least three K steps a split.
//
// int8 is widened by byte permutes and an add (repro::i8_at), not the
// quarter-rate I2F. With more than one split, each block writes f32
// partials to scratch the wrapper allocated and counts itself done on its
// output tile's semaphore; the last block of the tile sums the partials in
// split-index order and applies the scale, so the result never depends on
// which block finished first, and no second kernel is launched (one launch
// alone costs ~5 µs of device time on the H100). What still holds it back:
// a K step of 4 warps is bound by instruction issue (copies, widening,
// products in turn), and each split pays a store, fence and count; wgmma
// with TMA and warp-specialised producers are later work.

#include <type_traits>

#include "hopper.cuh"

namespace {

using repro::cp_async16;

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

// --------------------------------------------------------- tensor-core path
// A block computes a 64 x 64 output tile with 4 warps of 32 x 32, each two
// m16 by four n8 m16n8k16 products a 16-deep slice; K steps of 64 rows, four
// in the ring (three in flight).
constexpr int TC_BM = 64, TC_BN = 64, TC_BK = 64, TC_STAGES = 4, TC_THREADS = 128;
constexpr int TC_WTM = 32, TC_WTN = 32, TC_MI = TC_WTM / 16, TC_NI = TC_WTN / 8;
constexpr int TC_XLD = TC_BK + 8;   // bf16 a row of x in shared memory (144 B:
constexpr int TC_WLD = TC_BN + 8;   // the 8 rows of an ldmatrix on distinct banks)
constexpr int TC_XBYTES = TC_BM * TC_XLD * 2;
constexpr int TC_STAGE_BYTES = TC_XBYTES + TC_BK * TC_BN;      // x bf16 + w int8
constexpr int TC_SMEM = TC_STAGES * TC_STAGE_BYTES + TC_BK * TC_WLD * 2;

// grid (N tiles, E x 64-row M tiles, splits); expert e = blockIdx.y / M tiles
__global__ void __launch_bounds__(TC_THREADS)
tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ scales, __nv_bfloat16* __restrict__ out,
          float* __restrict__ part, int* __restrict__ sem, int M, int N, int K, int KS,
          int vec_x, int vec_w) {
  constexpr int BM = TC_BM, BN = TC_BN, BK = TC_BK, STAGES = TC_STAGES, T = TC_THREADS;
  constexpr int MI = TC_MI, NI = TC_NI, XLD = TC_XLD, WLD = TC_WLD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * TC_STAGE_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mtiles = (M + BM - 1) / BM, e = blockIdx.y / mtiles;
  x += (size_t)e * M * K;
  w += (size_t)e * K * N;
  scales += (size_t)e * N;
  out += (size_t)e * M * N;
  if (part != nullptr) part += (size_t)e * gridDim.z * M * N;
  const int n0 = blockIdx.x * BN, m0 = (blockIdx.y - e * mtiles) * BM, split = blockIdx.z;
  const int kbeg = split * KS, kend = min(K, kbeg + KS);
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
    unsigned char* st = smem + slot * TC_STAGE_BYTES;
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

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const int wm = (warp / (BN / TC_WTN)) * TC_WTM, wn = (warp % (BN / TC_WTN)) * TC_WTN;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load_stage(s, s);
    repro::cp_async_commit();
  }
  for (int t = 0; t < nsteps; ++t) {
    const int slot = t % STAGES;
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();          // step t landed; every warp is past step t-1
    const int8_t* w8 = reinterpret_cast<const int8_t*>(smem + slot * TC_STAGE_BYTES + TC_XBYTES);
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
      uint4* dst = reinterpret_cast<uint4*>(wb + r * WLD + c);
      dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
      dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
    }
    const int nt = t + STAGES - 1;
    if (nt < nsteps) load_stage(nt, nt % STAGES);
    repro::cp_async_commit();
    __syncthreads();          // the widened weight tile is complete
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(smem + slot * TC_STAGE_BYTES);
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
            r, wb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * WLD + wn + nj * 16 + (lane >> 4) * 8);
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
  }

  // accumulator (mi, ni): rows g and g + 8, columns 2·(lane % 4) + {0, 1}
  const int g = lane >> 2, tq = lane & 3;
  const bool split_k = gridDim.z > 1;
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
          const float v = acc[mi][ni][h * 2 + e];
          if (split_k) part[((size_t)split * M + row) * N + col] = v;
          else out[(size_t)row * N + col] = __float2bfloat16(v * scales[col]);
        }
      }
  if (split_k && repro::last_split_done(sem + blockIdx.y * gridDim.x + blockIdx.x, gridDim.z))
    merge_tile<__nv_bfloat16, BM * BN / 4 / T>(part, scales, out, M, N, gridDim.z, m0, n0,
                                               BM, BN);
}

int launch_tc(const __nv_bfloat16* x, const int8_t* w, const float* sc, __nv_bfloat16* out,
              float* part, int* sem, int E, int M, int N, int K, int ks, int splits,
              int vec_x, int vec_w, cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long mt = (long long)E * ((M + TC_BM - 1) / TC_BM);
  if (mt > 65535 || splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + TC_BN - 1) / TC_BN, static_cast<unsigned>(mt), splits);
  tc_kernel<<<grid, TC_THREADS, TC_SMEM, s>>>(x, w, sc, out, part, sem, M, N, K, ks, vec_x,
                                              vec_w);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch(const void* x, const void* w, const void* scales, void* out, void* part,
           void* sem, int E, int M, int N, int K, int path, int ks, int splits,
           cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scales);
  T* ot = static_cast<T*>(out);
  float* pt = static_cast<float*>(part);
  int* st = static_cast<int*>(sem);
  const int vec_w = N % 16 == 0 && aligned16(w);
  if (E < 1 || splits < 1 || (splits > 1 && (part == nullptr || sem == nullptr)) ||
      (splits - 1) * ks >= K || splits * ks < K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 0) {
    const long long groups = (long long)E * ((M + GV_MT - 1) / GV_MT);
    if (ks < 1 || ks > GV_KS_MAX || groups > 65535 || splits > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((N + GV_BN - 1) / GV_BN, splits, static_cast<unsigned>(groups));
    gemv_kernel<T><<<grid, GV_THREADS, 0, s>>>(xt, wt, sc, ot, pt, st, M, N, K, ks, vec_w);
  } else if (path == 1) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const int vec_x = K % 8 == 0 && aligned16(x);
      return launch_tc(xt, wt, sc, ot, pt, st, E, M, N, K, ks, splits, vec_x, vec_w, s);
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
// `splits` pieces of `ks` rows, and with splits > 1 `part` is (E, splits, M,
// N) f32 scratch and `sem` holds one zeroed int32 per output tile of every
// expert (the kernel leaves them zeroed). x (E,M,K), w (E,K,N), scales
// (E,N) and out (E,M,N) are contiguous; every expert takes the same plan,
// the wrapper's `plan(M, K, N)`. The 2-D call is E = 1.
extern "C" int int8_matmul_batched(const void* x, const void* w, const void* scales,
                                   void* out, void* part, void* sem, int E, int M, int N,
                                   int K, int x_dtype, int path, int ks, int splits,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == repro::kF32)
    return launch<float>(x, w, scales, out, part, sem, E, M, N, K, path, ks, splits, s);
  if (x_dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, w, scales, out, part, sem, E, M, N, K, path, ks, splits,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
