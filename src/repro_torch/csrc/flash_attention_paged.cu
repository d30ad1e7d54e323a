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
// Design (simple first): one 128-thread block per (sequence, kv head, four
// chunk rows), one warp per row covering its G query heads. The block loads
// each 32-key tile of its rows' combined key range into shared memory once,
// dequantized to f32, and every warp folds it into its own f32 online
// softmax. Tensor-core tiles (mma/wgmma) are later work.

#include "attn_common.cuh"

namespace {

using repro::KVArgs;
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

template <typename QT, typename KT>
int launch(const void* q, const KVArgs& a, const void* q_offset,
           const void* kv_len, void* out, int B, int C, int G, int window,
           float scale, cudaStream_t stream) {
  const int D = a.d;
  const size_t smem = sizeof(float) * (NW * G * D + TK * (2 * D + 1));
  auto* kernel = chunk_attention_kernel<QT, KT>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * a.kv, (C + NW - 1) / NW);
  kernel<<<grid, NW * 32, smem, stream>>>(
      static_cast<const QT*>(q), a, static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_len), static_cast<QT*>(out), C, G, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const KVArgs& a, const void* q_offset,
                const void* kv_len, void* out, int B, int C, int G, int window,
                float scale, cudaStream_t s) {
  switch (kv_dtype) {
    case repro::kF32:
      return launch<QT, float>(q, a, q_offset, kv_len, out, B, C, G, window, scale, s);
    case repro::kBF16:
      return launch<QT, __nv_bfloat16>(q, a, q_offset, kv_len, out, B, C, G, window, scale, s);
    case repro::kI8:
      return launch<QT, int8_t>(q, a, q_offset, kv_len, out, B, C, G, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,C,KV,G,D); k/v pools (n_pages,ps,KV,D); ks/vs f16 scales for int8
// pools (nullptr otherwise); page_table (B,pps) int32; q_offset, kv_len (B,)
// int32; out (B,C,KV,G,D) in q's type.
extern "C" int flash_attention_paged(const void* q, const void* k, const void* v,
                                     const void* ks, const void* vs,
                                     const void* page_table, const void* q_offset,
                                     const void* kv_len, void* out, int B, int C,
                                     int KV, int G, int D, int pps, int ps,
                                     int window, float scale, int q_dtype,
                                     int kv_dtype, void* stream) {
  KVArgs a{k, v, static_cast<const __half*>(ks), static_cast<const __half*>(vs),
           static_cast<const int*>(page_table), pps, ps, 0, KV, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == repro::kF32)
    return dispatch_kv<float>(kv_dtype, q, a, q_offset, kv_len, out, B, C, G, window, scale, s);
  if (q_dtype == repro::kBF16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, a, q_offset, kv_len, out, B, C, G, window,
                                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
