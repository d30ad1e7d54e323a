// Single-query (decode) GQA attention against a ragged KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (_body, _make_kernel; dense and paged pallas_calls). All four variants:
// {dense (B,Smax,KV,D) cache, paged (n_pages,ps,KV,D) pool through a
// (B,pages_per_seq) table} x {float (f32/bf16) cache, int8 cache with f16
// per-(row, kv head) scales, dequant fused into the tile load}.
//
// Bound on the card: bytes. Each step reads every live K/V row once (the
// q·k and p·v work is 4·G·D flops per row), so the cache crosses device
// memory once, in its storage type; the page table is read by the kernel
// itself, with no dense gather. Only tiles that intersect [kv_len - window,
// kv_len) are visited.
//
// Design (simple first): one 128-thread block per (sequence, kv head). Its
// four warps take alternate 32-key tiles, each keeping an f32 online softmax
// for the G query heads that share the kv head, and the block merges the
// four partial states at the end. Split-KV across blocks is later work.

#include "attn_common.cuh"

namespace {

using repro::KVArgs;
using repro::NEG_INF;
using repro::NW;
using repro::TK;

template <typename QT, typename KT>
__global__ void __launch_bounds__(NW * 32)
decode_attention_kernel(const QT* __restrict__ q, KVArgs a,
                        const int* __restrict__ kv_len, QT* __restrict__ out,
                        int G, int window, float scale) {
  extern __shared__ float smem[];
  const int D = a.d;
  const int b = blockIdx.x / a.kv, h = blockIdx.x % a.kv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = smem;                                  // G x D
  float* comb = qs + G * D;                          // NW x G x (m, l, D acc)
  float* ktile = comb + NW * G * (D + 2) + warp * TK * (2 * D + 1);
  float* vtile = ktile + TK * (D + 1);

  // q is (B, KV, G, D): this block's G x D query group
  const QT* qb = q + ((size_t)b * a.kv + h) * G * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) qs[i] = repro::to_f(qb[i]) * scale;
  __syncthreads();

  const int len = kv_len[b];
  const int cap = a.page_table != nullptr ? a.pps * a.ps : a.smax;
  const int hi = min(len, cap);
  const int lo = window > 0 ? max(0, len - window) : 0;

  repro::RowState st;
  repro::init_state(st);
  if (hi > lo) {
    for (int t = lo / TK + warp; t * TK < hi; t += NW) {
      repro::load_tile<KT>(a, b, h, t * TK, hi, ktile, vtile, lane, 32);
      __syncwarp();
      repro::tile_update(st, qs, ktile, vtile, G, D, t * TK, lo, hi, lane);
      __syncwarp();
    }
  }

  // merge the NW partial (m, l, acc) states
  const int E = D / 32;
  float* cw = comb + warp * G * (D + 2);
#pragma unroll
  for (int g = 0; g < repro::MAXG; ++g) {
    if (g < G) {
      if (lane == 0) {
        cw[g * (D + 2)] = st.m[g];
        cw[g * (D + 2) + 1] = st.l[g];
      }
#pragma unroll
      for (int e = 0; e < repro::MAXE; ++e)
        if (e < E) cw[g * (D + 2) + 2 + lane + 32 * e] = st.acc[g][e];
    }
  }
  __syncthreads();
  QT* ob = out + ((size_t)b * a.kv + h) * G * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, c = i - g * D;
    float m = NEG_INF;
    for (int w = 0; w < NW; ++w) m = fmaxf(m, comb[(w * G + g) * (D + 2)]);
    float l = 0.f, acc = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float* cg = comb + (w * G + g) * (D + 2);
      const float f = expf(cg[0] - m);
      l += cg[1] * f;
      acc += cg[2 + c] * f;
    }
    // kv_len == 0: l == 0 and acc == 0, so the output is 0
    ob[i] = repro::from_f<QT>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename QT, typename KT>
int launch(const void* q, const KVArgs& a, const void* kv_len, void* out, int B,
           int G, int window, float scale, cudaStream_t stream) {
  const int D = a.d;
  const size_t smem = sizeof(float) *
      (G * D + NW * G * (D + 2) + NW * TK * (2 * D + 1));
  auto* kernel = decode_attention_kernel<QT, KT>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * a.kv, NW * 32, smem, stream>>>(
      static_cast<const QT*>(q), a, static_cast<const int*>(kv_len),
      static_cast<QT*>(out), G, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const KVArgs& a, const void* kv_len,
                void* out, int B, int G, int window, float scale, cudaStream_t s) {
  switch (kv_dtype) {
    case repro::kF32: return launch<QT, float>(q, a, kv_len, out, B, G, window, scale, s);
    case repro::kBF16: return launch<QT, __nv_bfloat16>(q, a, kv_len, out, B, G, window, scale, s);
    case repro::kI8: return launch<QT, int8_t>(q, a, kv_len, out, B, G, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,KV,G,D); k/v dense (B,smax,KV,D) or pools (n_pages,ps,KV,D) with
// page_table (B,pps) int32 (nullptr = dense); ks/vs f16 scales for int8
// caches (nullptr otherwise); kv_len (B,) int32; out (B,KV,G,D) in q's type.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* page_table, const void* kv_len,
                                void* out, int B, int KV, int G, int D, int smax,
                                int pps, int ps, int window, float scale,
                                int q_dtype, int kv_dtype, void* stream) {
  KVArgs a{k, v, static_cast<const __half*>(ks), static_cast<const __half*>(vs),
           static_cast<const int*>(page_table), pps, ps, smax, KV, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == repro::kF32)
    return dispatch_kv<float>(kv_dtype, q, a, kv_len, out, B, G, window, scale, s);
  if (q_dtype == repro::kBF16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, a, kv_len, out, B, G, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
