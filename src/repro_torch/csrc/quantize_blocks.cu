// Blockwise symmetric int8 quantize / dequantize of 256-element blocks.
//
//   quantize:   scale[b] = max(absmax(x[b, :]), 1e-12) * (1/127)
//               q[b, i]  = clip(rint(x[b, i] / scale[b]), -127, 127)
//   dequantize: out[b, i] = q[b, i] * scale[b]     (f32, or bf16 rounded to nearest even)
//
// Replaces the TPU kernels repro/kernels/quantize.py::quantize_blocks
// (_quant_kernel) and ::dequantize_blocks (_dequant_kernel). They carry the
// error-feedback gradient compression (train/compression.py): every gradient
// leaf, every step, once each.
//
// Bound: bytes. Quantize reads 4 bytes and writes 1 (+ 4 per 256 for the
// scale) per element; dequantize the reverse. A compressed smollm-360m step
// moves ~1.8 GB through each kernel, ~0.54 ms at 3.35 TB/s, with ~10
// operations per element, far below the f32 rate.
//
// Design (simple first):
//   quantize: one warp per 256-element block in a grid-stride loop over
//     blocks. Each lane loads its 8 consecutive values with 16-byte loads,
//     the warp reduces the absmax by shuffle, every lane writes its 8 int8
//     values in one 8-byte store and lane 0 writes the scale.
//   dequantize: one thread per 8 elements, an 8-byte int8 load and 16-byte
//     stores, in a grid-stride loop.
//   Offsets are 64-bit.
//
// Bit-exactness with the plain versions (kernels/ref.py) and the JAX package:
//   - the scale multiplies by the f32 reciprocal of 127, as XLA folds `/ 127`
//     and as PyTorch does for a scalar divisor on the card;
//   - x / scale is an IEEE division (no reciprocal, no __fdividef; the build
//     has no --use_fast_math), rounded half to even with rintf, clipped to
//     +-127 (never -128);
//   - the absmax propagates NaN as torch.amax / jnp.max do (fmaxf would drop
//     it and hide a diverged step behind a finite scale);
//   - bf16 input is upcast to f32 before the absmax.

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;               // elements per quantization block
constexpr int PER_LANE = BLOCK / 32;     // 8 consecutive values per lane
constexpr int THREADS = 256;
constexpr float INV127 = 1.0f / 127.0f;  // folded by the compiler, round to nearest

__device__ __forceinline__ float nan_max(float a, float b) {
  // NaN in either operand wins, as torch.amax / jnp.max
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ void load8(const float* p, float v[PER_LANE]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[PER_LANE]) {
  const uint4 raw = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) v[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void store8(float* p, const float v[PER_LANE]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[PER_LANE]) {
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) h[i] = __float2bfloat16_rn(v[i]);
  reinterpret_cast<uint4*>(p)[0] = raw;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_blocks_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                       float* __restrict__ scales, long long n_blocks) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * (THREADS / 32);
  for (long long b = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
       b < n_blocks; b += warps) {
    const size_t off = (size_t)b * BLOCK + (size_t)lane * PER_LANE;
    float v[PER_LANE];
    load8(x + off, v);
    float m = fabsf(v[0]);
#pragma unroll
    for (int i = 1; i < PER_LANE; ++i) m = nan_max(fabsf(v[i]), m);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) m = nan_max(__shfl_xor_sync(0xffffffffu, m, s), m);
    // clamp(absmax, 1e-12): NaN < 1e-12 is false, so NaN stays NaN
    const float scale = (m < 1e-12f ? 1e-12f : m) * INV127;
    union { int8_t i8[PER_LANE]; uint2 u; } out;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const float r = rintf(v[i] / scale);  // IEEE division, half to even
      out.i8[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
    }
    *reinterpret_cast<uint2*>(q + off) = out.u;
    if (lane == 0) scales[b] = scale;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dequantize_blocks_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                         T* __restrict__ out, long long n_groups) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x; g < n_groups;
       g += stride) {
    const size_t off = (size_t)g * PER_LANE;
    const float s = scales[off / BLOCK];
    union { uint2 u; int8_t i8[PER_LANE]; } in;
    in.u = *reinterpret_cast<const uint2*>(q + off);
    float v[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) v[i] = static_cast<float>(in.i8[i]) * s;
    store8(out + off, v);
  }
}

// enough resident blocks to fill 132 SMs several times over; the grid-stride
// loops cover the rest
constexpr long long MAX_GRID = 132 * 16;

int grid_for(long long items_per_thread_group, long long groups) {
  long long g = (groups + items_per_thread_group - 1) / items_per_thread_group;
  return static_cast<int>(g < MAX_GRID ? (g > 0 ? g : 1) : MAX_GRID);
}

}  // namespace

extern "C" int quantize_blocks(const void* x, void* q, void* scales,
                               long long n_blocks, int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(THREADS / 32, n_blocks);
  if (x_dtype == repro::kF32) {
    quantize_blocks_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n_blocks);
  } else if (x_dtype == repro::kBF16) {
    quantize_blocks_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), n_blocks);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_blocks(const void* q, const void* scales, void* out,
                                 long long n_blocks, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long groups = n_blocks * (BLOCK / PER_LANE);
  const int grid = grid_for(THREADS, groups);
  if (out_dtype == repro::kF32) {
    dequantize_blocks_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<float*>(out), groups);
  } else if (out_dtype == repro::kBF16) {
    dequantize_blocks_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<__nv_bfloat16*>(out), groups);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
