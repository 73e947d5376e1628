// Register-level helpers shared by the bf16 tensor-core kernels (built for
// sm_90a): ldmatrix.trans, the exponential on the special-function unit,
// and f32 <-> bf16 packing and splitting.
//
// Fragment layouts of mma.m16n8k16.row.col, which are also a warp's share
// of wgmma's 64-row accumulator and register A operand (lane = 4 * g + t,
// g = lane / 4, t = lane % 4), each register holding two bf16 of
// neighbouring columns:
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

// Four 8 x 8 bf16 matrices; lane l gives the shared address (smem_addr) of
// row l % 8 of matrix l / 8 (16 bytes); r[m] holds (rows 2t, 2t+1, col g)
// of matrix m.
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
