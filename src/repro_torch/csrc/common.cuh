// Shared element conversions for the repro_torch CUDA kernels.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// fp8 e5m2 storage (torch.float8_e5m2): the high byte of an f16, so the
// upcast is exact (subnormals, inf and NaN included)
struct e5m2 {
  unsigned char bits;
};
__device__ __forceinline__ float e5m2_to_f(unsigned b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b << 8)));
}
__device__ __forceinline__ float to_f(e5m2 x) { return e5m2_to_f(x.bits); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// dtype codes shared with the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kE5M2 = 3 };

}  // namespace repro
