// Hopper's own building blocks (sm_90a only): TMA tensor copies between
// device and shared memory, mbarriers that count a copy's bytes and the
// consumers' arrivals, warpgroup matrix products (wgmma) with operands in
// 128-byte-swizzled shared memory or in registers, named barriers, and
// setmaxnreg.
//
// Shared-memory layout of every wgmma operand here: 128-byte rows of 64
// bf16, as TMA writes a box whose inner extent is 64 bf16 with
// CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r lands at chunk
// c ^ (r % 8) (address bits 4-6 XOR bits 7-9), so a tile must start on a
// 1024-byte boundary.  Eight rows make one 1024-byte swizzle atom, atoms
// follow one another (the descriptor's stride byte offset, 1024).  Such a
// tile is
//   K-major (A = q rows, or B = K rows: the reduction dim contiguous): a
//   k16 step is 32 bytes further along each row, start address + 32 k;
//   MN-major B (V rows [key][d], d contiguous; transpose bit 1): a k16 step
//   is 16 rows further, start address + 2048; a second 64-column panel
//   (d 64..127) lies the leading byte offset further.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

// -------------------------------------------------------------------------
// mbarrier
// -------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival, and `bytes` more expected from copies before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// -------------------------------------------------------------------------
// TMA: 4-D tiles (coordinates innermost first), completion on an mbarrier
// -------------------------------------------------------------------------
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
// shared -> global; the box's part outside the tensor is not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// close this thread's bulk group of stores ...
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// ... and wait until all its groups have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// order this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (a TMA store)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(uint32_t id, uint32_t threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -------------------------------------------------------------------------
// wgmma
// -------------------------------------------------------------------------
// Descriptor of a 128-byte-swizzled operand at shared address `addr`
// (leading / stride byte offsets as in the note above; base offset 0, the
// tile's atoms being 1024-byte aligned).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Tie registers to this point of the program: a product's accumulators
// and register operands are read or reused only after its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define HOPPER_R8(M, i)                                                                       \
  M(d[i]), M(d[i + 1]), M(d[i + 2]), M(d[i + 3]), M(d[i + 4]), M(d[i + 5]), M(d[i + 6]), \
      M(d[i + 7])
#define HOPPER_R32(M) HOPPER_R8(M, 0), HOPPER_R8(M, 8), HOPPER_R8(M, 16), HOPPER_R8(M, 24)
#define HOPPER_R64(M) \
  HOPPER_R32(M), HOPPER_R8(M, 32), HOPPER_R8(M, 40), HOPPER_R8(M, 48), HOPPER_R8(M, 56)
#define HOPPER_RW(x) "+f"(x)
#define HOPPER_WO(x) "=f"(x)
#define HOPPER_S32                                                                  \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_S64                                                                     \
  HOPPER_S32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
             "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "   \
             "%60, %61, %62, %63"

// d (64 x N, f32) = [d +] a b: a 64 x 16 K-major, b 16 x N K-major,
// both in shared memory.  kAcc false: d is written, not read (scale-d 0).
template <bool kAcc>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b) {
  if constexpr (kAcc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_S64
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_R64(HOPPER_RW)
        : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_S64
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_R64(HOPPER_WO)
        : "l"(a), "l"(b), "r"(0));
  }
}

template <bool kAcc>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (kAcc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_S32
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_R32(HOPPER_RW)
        : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_S32
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_R32(HOPPER_WO)
        : "l"(a), "l"(b), "r"(0));
  }
}
// the same, N = 64 or 128
template <int N, bool kAcc>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 64)
    wgmma_ss_n64<kAcc>(d, a, b);
  else
    wgmma_ss_n128<kAcc>(d, a, b);
}

// d (64 x N, f32) = [d +] a b: a 64 x 16 bf16 in registers (the mma.m16n8k16
// A fragment of each warp's 16 rows), b 16 x N MN-major in shared memory.
template <bool kAcc>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kAcc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_S32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HOPPER_R32(HOPPER_RW)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_S32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HOPPER_R32(HOPPER_WO)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
}
template <bool kAcc>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  if constexpr (kAcc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_S64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : HOPPER_R64(HOPPER_RW)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_S64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : HOPPER_R64(HOPPER_WO)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
}
// the product of a 64 x 16 register tile with a 16 x D MN-major tile
template <int D, bool kAcc>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64)
    wgmma_rs_n64<kAcc>(d, a, b);
  else
    wgmma_rs_n128<kAcc>(d, a, b);
}

#undef HOPPER_R8
#undef HOPPER_R32
#undef HOPPER_R64
#undef HOPPER_RW
#undef HOPPER_WO
#undef HOPPER_S32
#undef HOPPER_S64

// -------------------------------------------------------------------------
// host: tensor maps
// -------------------------------------------------------------------------
// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// that the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A contiguous bf16 tensor [B, S, heads, D] as the 4-D map [D, heads, S, B]
// (innermost first) with a box of [64, 1, rows, 1], 128-byte swizzle;
// positions past S read as zeros and are not written.  False when the
// driver refuses it.
inline bool bf16_rows_map(CUtensorMap* map, const void* base, int B, int S, int heads, int D,
                          int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;  // bytes
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
