// Tensor-core building blocks shared by the bf16 kernels (sm_80 and later;
// built for sm_90a): 16-byte cp.async copies into shared memory, ldmatrix,
// and mma.sync m16n8k16 with bf16 operands and f32 accumulators.
//
// Fragment layouts of mma.m16n8k16.row.col (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), each register holding two bf16 of neighbouring columns:
//   A 16 x 16: a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..), a2 (row g,
//              k 2t+8..), a3 (row g+8, k 2t+8..)
//   B 16 x 8:  b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g)
//   C 16 x 8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)
// so the C fragments of two neighbouring n8 tiles are, element for element,
// the A fragment of one k16 step (c0c1 / c2c3 of tile 2s -> a0 / a1, of tile
// 2s+1 -> a2 / a3): a product's result feeds the next product in registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared (dst a shared address); when !in, the 16 bytes
// are zero-filled and nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the shared address (smem_addr) of
// row l % 8 of matrix l / 8 (16 bytes).  Without .trans, r[m] holds (row g,
// cols 2t, 2t+1) of matrix m; with .trans, (rows 2t, 2t+1, col g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 2^x on the special-function unit (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c += a * b (16 x 8 x 16), products exact, sums in f32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half), round to nearest
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// Split two f32 into a leading bf16 pair (returned) and the f32 remainders
// (x0, x1 updated in place).  Two splits carry about 16 bits of each value
// (relative error <= 2^-18), three about 24.
__device__ __forceinline__ uint32_t split(float& x0, float& x1) {
  const uint32_t hi = pack(x0, x1);
  const float2 h = unpack(hi);
  x0 -= h.x;
  x1 -= h.y;
  return hi;
}

}  // namespace mma_bf16
