// Hopper primitives shared by the redesigned kernels (int8_matmul.cu,
// decode_attention.cu): 16-byte cp.async from device memory into shared
// memory (zero-filling what lies outside the source), ldmatrix, the bf16
// m16n8k16 tensor-core product, and the semaphore that finds the last
// block of a split output tile.
#pragma once

#include "common.cuh"

namespace repro {

// Copy 16 bytes, of which the first `src_bytes` (0 or 16) come from `src`
// and the rest are zero. `dst` and `src` are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

// d += a (16x16 bf16, row) · b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte j (0..3) of a word as a signed int8 value, widened to f32 exactly
// without the quarter-rate I2F: 0x4B0000uu is 2^23 + u as f32, and with
// u = b + 128 (the byte with its top bit flipped) 2^23 + u - (2^23 + 128)
// is b. One PRMT and one FADD.
__device__ __forceinline__ float i8_at(unsigned word, int j) {
  return __int_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7540 + j)) -
         8388736.f;
}

// Two f32 values that are small integers (|v| <= 256, so their low 16 bits
// are 0) as a bf16x2 word, exactly: their high halves, one PRMT.
__device__ __forceinline__ unsigned bf16x2_of_ints(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Called by every thread of a block after it stored its split's partials:
// true in the one block of the output tile that finished last, which then
// merges them. `sem` counts the tile's splits done; that block resets it to
// 0, so the wrapper's zeroed semaphores (`_build.semaphores`) are reused.
// The partials are read back past L1 (`__ldcg`): other blocks wrote them.
__device__ __forceinline__ bool last_split_done(int* sem, int splits) {
  __shared__ int last;
  __threadfence();                    // the partials before the count
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(sem, 1) == splits - 1;
    if (last) *sem = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

}  // namespace repro
