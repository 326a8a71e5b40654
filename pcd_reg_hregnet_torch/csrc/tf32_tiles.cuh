// Pieces shared by the patch attention kernels (attention.cu, K3, and
// attention_bwd.cu, K3b): 3xTF32 products on mma.sync.m16n8k8, bf16
// products on mma.sync.m16n8k16, and tiles staged into shared memory with
// cp.async.
//
// Fragments of mma.sync.m16n8k8 (row.col), lane = 4 g + t:
//   A (16 x 8):  a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]
//   B (8 x 8):   b0 = B[t][g], b1 = B[t + 4][g]
//   C (16 x 8):  c0 = C[g][2t], c1 = C[g][2t + 1], c2 = C[g + 8][2t], c3 = C[g + 8][2t + 1]
// A C fragment becomes the A operand of a product that sums over its
// columns with no shuffle by relabelling the 8 columns: k-index t is column
// 2t and t + 4 is 2t + 1, so A = {c0, c2, c1, c3} and the B operand's rows
// are read as 2t and 2t + 1.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* dst) { *dst = __float2bfloat16(x); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo: hi is x rounded to tf32's 10 mantissa bits (half away from
// zero, by integer ops), lo = x - hi exactly.  The tensor core reads the
// top 19 bits of a tf32 operand, so lo goes in as it is (truncated there,
// an error of at most 2^-21 |x|), and no cvt is spent on either part.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma.sync.m16n8k16 in bf16 (row.col), f32 accumulate; lane = 4 g + t:
//   A (16 x 16): a0 = A[g][2t, 2t+1], a1 = A[g + 8][2t, 2t+1],
//                a2 = A[g][2t+8, 2t+9], a3 = A[g + 8][2t+8, 2t+9]
//   B (16 x 8):  b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]
//   C (16 x 8):  as m16n8k8's, so the C fragments of two adjacent 8-column
//   tiles are the A operand of a product over those 16 columns, in order.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values, the first in the low half (the lower column or key).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Stage rows [0, BN) x columns [0, DP) of `src` (row stride `ld`) into
// `dst` (row stride LD), zero past `rows` rows and `cols` columns: 16-byte
// cp.async where the rows allow it, plain loads where they do not.
template <typename T, int BN, int DP, int LD>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long ld,
                                           int rows, int cols, bool vec) {
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T);
    constexpr int CPR = DP / E;   // chunks per row
    for (int i = threadIdx.x; i < BN * CPR; i += blockDim.x) {
      const int row = i / CPR, col = (i % CPR) * E;
      const int n = row < rows ? max(0, min(E, cols - col)) : 0;
      cp_async16(dst + row * LD + col, n ? src + row * ld + col : src, n * (int)sizeof(T));
    }
  } else {
    for (int i = threadIdx.x; i < BN * DP; i += blockDim.x) {
      const int row = i / DP, col = i % DP;
      T x;
      if (row < rows && col < cols) x = src[row * ld + col];
      else store(0.f, &x);
      dst[row * LD + col] = x;
    }
  }
}

}  // namespace
