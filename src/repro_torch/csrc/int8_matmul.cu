// Weight-only int8 matmul: out (M,N) = (x (M,K) · w_q (K,N) int8) * scales (N,)
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py::int8_matmul (_kernel).
// On the serving path M is n_slots (decode) or the prefill chunk (64), so the
// product is bound by reading the int8 weight once (K·N bytes): the weight
// crosses device memory as int8 and is upcast in registers; x is f32 or bf16,
// accumulation is f32 and the per-output-channel scale is applied in the
// epilogue. Ragged tiles are masked here, so unlike the TPU kernel there is
// no divisibility contract (smollm's K=960, N=320 run on the kernel).
//
// Design (simple first): one 256-thread block per (BM x BN) output tile,
// K swept in BK-deep shared-memory tiles, each thread owning 8 rows of one
// output column. CUDA-core FMAs; tensor cores (mma/wgmma) are later work.

#include "common.cuh"

namespace {

constexpr int BM = 32, BN = 64, BK = 32, THREADS = 256, ROWS = BM / (THREADS / BN);

template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scales, T* __restrict__ out,
                   int M, int N, int K) {
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % BN;            // output column within the tile
  const int ty = tid / BN;            // row group: rows ty*ROWS .. +ROWS
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // every load of the tile is issued before any is stored, so the
    // global-memory latencies overlap instead of adding up
    float xv[BM * BK / THREADS];
    float wv[BK * BN / THREADS];
#pragma unroll
    for (int it = 0; it < BM * BK / THREADS; ++it) {
      const int i = tid + it * THREADS, r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      xv[it] = (gm < M && gk < K) ? repro::to_f(x[(size_t)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < BK * BN / THREADS; ++it) {
      const int i = tid + it * THREADS, r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      wv[it] = (gk < K && gn < N) ? static_cast<float>(w[(size_t)gk * N + gn]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < BM * BK / THREADS; ++it) {
      const int i = tid + it * THREADS;
      xs[i / BK][i % BK] = xv[it];
    }
#pragma unroll
    for (int it = 0; it < BK * BN / THREADS; ++it) {
      const int i = tid + it * THREADS;
      ws[i / BN][i % BN] = wv[it];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float wk = ws[kk][tx];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(xs[ty * ROWS + r][kk], wk, acc[r]);
    }
    __syncthreads();
  }

  const int gn = n0 + tx;
  if (gn >= N) return;
  const float s = scales[gn];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int gm = m0 + ty * ROWS + r;
    if (gm < M) out[(size_t)gm * N + gn] = repro::from_f<T>(acc[r] * s);
  }
}

}  // namespace

extern "C" int int8_matmul(const void* x, const void* w, const void* scales,
                           void* out, int M, int N, int K, int x_dtype,
                           void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == repro::kF32) {
    int8_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scales), static_cast<float*>(out), M, N, K);
  } else if (x_dtype == repro::kBF16) {
    int8_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(out), M, N, K);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
