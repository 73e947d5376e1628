// Fused count-weighted PME average for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pme_average/kernel.py, pme_average_pallas (the
// Pallas TPU kernel behind repro.core.pme.pme_average_pytree's exact-mode
// dense exchange).
//
// For W [m, n], masks M [m, n] and the selection A [m, m] (A[j, i] = 1 iff
// sender j is in receiver i's selection):
//     agg[i, l] = sum_j A[j, i] * M[j, l] * W[j, l]
//     cnt[i, l] = sum_j A[j, i] * M[j, l]
//     out[i, l] = cnt > 0 ? agg / max(cnt, 1) : W[i, l]
// computed in f32 and written in W's type (f32 or bf16).  M may be bool /
// uint8 or W's own type.
//
// What bounds it on an H100: bytes.  Per coordinate it does 2*m*m
// multiply-adds against m*(|W| + |M| + |out|) bytes; at the trainer's m = 4
// that is about 6 operations a byte, far below the ridge point, so the
// least time is (W read + M read + out written) / 3.35 TB/s.
//
// Design.  The TPU kernel ran two MXU matmuls per tile.  Here each thread
// owns V = 4 neighbouring coordinates.  A receiver tile of up to 8 rows of
// A^T is staged in shared memory; the thread then reads W[j, l] and M[j, l]
// for every sender j (one vector load each: 8 bytes of bf16 or 16 of f32,
// 4 bytes of mask) and keeps agg and cnt for the whole receiver tile in
// registers, so for m <= 8 every byte of W and M is read once (the tile is
// 4 rows when m <= 4, which halves the accumulator registers).  Larger m
// loops over receiver tiles (W and M re-read from L2).  The select and the
// cast to W's type happen in registers.  Ragged n and misaligned operands
// take the scalar instance (V = 1); nothing is padded in memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRecvTile = 8;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(uint8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&o)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int e = 0; e < V; ++e) o[e] = to_f(pk.v[e]);
}

template <typename WT, typename MT, int V, int kRecvTile>
__global__ void __launch_bounds__(kThreads)
pme_average_kernel(const WT* __restrict__ w, const MT* __restrict__ mask,
                   const float* __restrict__ a, WT* __restrict__ out, int m,
                   int64_t n) {
  extern __shared__ float s_at[];  // [kRecvTile, m]: A^T rows of the tile
  const int64_t l0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  const bool active = l0 < n;  // for V > 1 the launcher guarantees n % V == 0
  for (int i0 = 0; i0 < m; i0 += kRecvTile) {
    const int rt = min(kRecvTile, m - i0);
    __syncthreads();
    for (int e = threadIdx.x; e < rt * m; e += kThreads) {
      const int r = e / m, j = e % m;
      s_at[e] = a[static_cast<int64_t>(j) * m + i0 + r];
    }
    __syncthreads();
    if (!active) continue;
    float agg[kRecvTile][V], cnt[kRecvTile][V];
#pragma unroll
    for (int r = 0; r < kRecvTile; ++r)
#pragma unroll
      for (int e = 0; e < V; ++e) agg[r][e] = cnt[r][e] = 0.f;
    for (int j = 0; j < m; ++j) {
      float wv[V], mv[V];
      load<WT, V>(w + static_cast<int64_t>(j) * n + l0, wv);
      load<MT, V>(mask + static_cast<int64_t>(j) * n + l0, mv);
#pragma unroll
      for (int e = 0; e < V; ++e) wv[e] *= mv[e];
#pragma unroll
      for (int r = 0; r < kRecvTile; ++r) {
        if (r < rt) {
          const float aji = s_at[r * m + j];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            agg[r][e] += aji * wv[e];
            cnt[r][e] += aji * mv[e];
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRecvTile; ++r) {
      if (r < rt) {
        const int64_t off = static_cast<int64_t>(i0 + r) * n + l0;
        float own[V];
        load<WT, V>(w + off, own);
        Pack<WT, V> pk;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float c = cnt[r][e];
          pk.v[e] = from_f<WT>(c > 0.f ? agg[r][e] / fmaxf(c, 1.f) : own[e]);
        }
        *reinterpret_cast<Pack<WT, V>*>(out + off) = pk;
      }
    }
  }
}

template <typename WT, typename MT>
int launch(const void* w, const void* mask, const float* a, void* out, int m,
           int64_t n, cudaStream_t s) {
  const size_t align = 4 * sizeof(WT);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % align == 0 &&
                   reinterpret_cast<uintptr_t>(out) % align == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % (4 * sizeof(MT)) == 0;
  const int v = vec ? 4 : 1;
  const int64_t blocks = (n / v + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // a receiver tile of 4 rows when m <= 4 halves the accumulator registers
  // (more blocks resident per SM, more loads in flight)
  const int rt = m <= 4 ? 4 : kMaxRecvTile;
  const size_t smem = static_cast<size_t>(rt) * m * sizeof(float);
  const auto* wp = static_cast<const WT*>(w);
  const auto* mp = static_cast<const MT*>(mask);
  auto* op = static_cast<WT*>(out);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec && rt == 4)
    pme_average_kernel<WT, MT, 4, 4><<<grid, kThreads, smem, s>>>(wp, mp, a, op, m, n);
  else if (vec)
    pme_average_kernel<WT, MT, 4, kMaxRecvTile><<<grid, kThreads, smem, s>>>(wp, mp, a, op, m, n);
  else
    pme_average_kernel<WT, MT, 1, kMaxRecvTile><<<grid, kThreads, smem, s>>>(wp, mp, a, op, m, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT>
int dispatch_mask(const void* w, const void* mask, const float* a, void* out,
                  int m, int64_t n, int mask_dtype, cudaStream_t s) {
  switch (mask_dtype) {
    case 0: return launch<WT, float>(w, mask, a, out, m, n, s);
    case 1: return launch<WT, __nv_bfloat16>(w, mask, a, out, m, n, s);
    case 2: return launch<WT, uint8_t>(w, mask, a, out, m, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// w, out [m, n] of type w_dtype; mask [m, n] of type mask_dtype; a [m, m]
// float32, row-major A[sender, receiver].  Type codes: 0 float32, 1 bfloat16,
// 2 uint8 (bool).  Launches on `stream`, allocates nothing, does not
// synchronise.  Returns cudaGetLastError() (0 = launched).
extern "C" int pme_average(const void* w, const void* mask, const float* a,
                           void* out, int m, long long n, int w_dtype,
                           int mask_dtype, void* stream) {
  if (m < 1 || n < 1 || static_cast<size_t>(kMaxRecvTile) * m * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (w_dtype) {
    case 0: return dispatch_mask<float>(w, mask, a, out, m, n, mask_dtype, s);
    case 1: return dispatch_mask<__nv_bfloat16>(w, mask, a, out, m, n, mask_dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
