// Causal grouped-query flash attention (optional sliding window) for Hopper
// (sm_90a), forward only.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_attention_pallas
// (the Pallas TPU kernel behind repro.models.attention.gqa_apply when
// cfg.use_flash is set).
//
// For q [B, S, H, D] and k, v [B, S, KV, D] (f32 or bf16, one type), query
// head h reads kv head h / (H / KV) and
//     out[b, i, h] = sum_j softmax_j(scale * q_i . k_j) v_j,   j <= i,
//                    and i - j < window when a window is given,
// with scale = D^-0.5, the online softmax kept in f32 and the output written
// in q's type.  Masked scores take NEG_INF = -1e30 and the denominator is
// guarded by max(l, 1e-30), as in the Pallas kernel.
//
// What bounds it on an H100: operations.  The causal half of the two
// products is 2 * B * H * D * S^2 flops (137 GFLOP at B = 8, S = 2048,
// H = 32, D = 64) against 4 * B * S * H * D * |type| bytes, some 500
// operations a byte.  The least time is that work at the bf16 tensor-core
// peak; this first kernel runs it in f32 FMAs on the CUDA cores (the Pallas
// kernel's f32 arithmetic), whose peak is 67 TFLOP/s, not 989.
//
// Design.  The TPU grid's sequential kv axis becomes a loop inside the
// block: one block per (query tile, head, batch), blocks of the latest
// (heaviest) query tiles launched first.  Each query row belongs to TPR
// neighbouring threads, each owning DP = min(D, 32) of its dims in 4-wide
// chunks (chunk p, p + TPR, ...), so q, the running max m, the denominator l
// and the output accumulator stay in registers, and the TPR lanes of a row
// read neighbouring 16-byte chunks of a K/V row (no bank conflict); the
// partial dot products meet by __shfl_xor_sync.  K and V tiles are staged in
// shared memory as f32; only tiles of the causal / window band are loaded,
// and a thread skips each 16-key sub-tile that lies wholly above its row's
// diagonal or before its window, as the Pallas kernel skips whole blocks.
// Sixteen scores are taken before one rescale of the accumulator.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kSub = 16;  // keys scored together before one rescale
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
struct Shape {
  static constexpr int DP = D < 32 ? D : 32;   // dims a thread owns
  static constexpr int TPR = D / DP;           // threads per query row
  static constexpr int BQ = kThreads / TPR;    // query rows per block
  static constexpr int BK = 4096 / D < 64 ? 4096 / D : 64;  // keys per tile
  static constexpr int NCH = DP / 4;           // 4-wide chunks a thread owns
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int H, int KV,
             int window, float scale) {
  using Sh = Shape<D>;
  constexpr int TPR = Sh::TPR, BQ = Sh::BQ, BK = Sh::BK, NCH = Sh::NCH;
  static_assert(BK % kSub == 0, "key tile must hold whole sub-tiles");
  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];

  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_lo = qtile * BQ;
  const int i = q_lo + tid / TPR;  // this thread's query row
  const bool row_ok = i < S;
  const int lane = tid % 32;
  const unsigned gmask =
      TPR == 1 ? 1u << lane : ((1u << TPR) - 1u) << (lane & ~(TPR - 1));

  const int64_t q_step = static_cast<int64_t>(H) * D;   // between positions
  const int64_t kv_step = static_cast<int64_t>(KV) * D;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_step + static_cast<int64_t>(kvh) * D;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_step + static_cast<int64_t>(kvh) * D;
  const int64_t row_off = (static_cast<int64_t>(b) * S + (row_ok ? i : 0)) * q_step +
                          static_cast<int64_t>(h) * D;

  float qr[4 * NCH], acc[4 * NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * c + e] = row_ok ? to_f(q[row_off + (part + c * TPR) * 4 + e]) : 0.f;
      acc[4 * c + e] = 0.f;
    }
  float m = kNegInf, l = 0.f;

  const int k_end = min(S, q_lo + BQ);  // keys past the tile's last row are masked
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_begin -= k_begin % BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * D; e += kThreads) {
      const int j = k0 + e / D, d = e % D;
      const bool in = j < S;
      ks[e] = in ? to_f(kb[j * kv_step + d]) : 0.f;
      vs[e] = in ? to_f(vb[j * kv_step + d]) : 0.f;
    }
    __syncthreads();
    const int kn = min(BK, k_end - k0);
    for (int s0 = 0; s0 < kn; s0 += kSub) {
      const int j0 = k0 + s0;
      // wholly above this row's diagonal, or wholly before its window
      if (!row_ok || j0 > i || (window > 0 && j0 + kSub - 1 <= i - window)) continue;
      float sc[kSub];
      float mx = m;
#pragma unroll
      for (int kk = 0; kk < kSub; ++kk) {
        const float* kr = ks + (s0 + kk) * D;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + (part + c * TPR) * 4);
          dot = fmaf(qr[4 * c + 0], k4.x, dot);
          dot = fmaf(qr[4 * c + 1], k4.y, dot);
          dot = fmaf(qr[4 * c + 2], k4.z, dot);
          dot = fmaf(qr[4 * c + 3], k4.w, dot);
        }
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(gmask, dot, o);
        const int j = j0 + kk;
        const bool ok = j <= i && (window <= 0 || i - j < window);
        sc[kk] = ok ? dot * scale : kNegInf;
        mx = fmaxf(mx, sc[kk]);
      }
      if (mx == kNegInf) continue;  // no key of the band yet
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < 4 * NCH; ++d) acc[d] *= alpha;
#pragma unroll
      for (int kk = 0; kk < kSub; ++kk) {
        const float p = expf(sc[kk] - mx);  // 0 for a masked key
        l += p;
        const float* vr = vs + (s0 + kk) * D;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const float4 v4 = *reinterpret_cast<const float4*>(vr + (part + c * TPR) * 4);
          acc[4 * c + 0] = fmaf(p, v4.x, acc[4 * c + 0]);
          acc[4 * c + 1] = fmaf(p, v4.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(p, v4.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(p, v4.w, acc[4 * c + 3]);
        }
      }
      m = mx;
    }
  }
  if (!row_ok) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[row_off + (part + c * TPR) * 4 + e] = from_f<T>(acc[4 * c + e] / denom);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int H, int KV, int window, float scale, cudaStream_t s) {
  const dim3 grid((S + Shape<D>::BQ - 1) / Shape<D>::BQ, H, B);
  flash_kernel<T, D><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, KV, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int KV, int D, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, out, B, S, H, KV, window, scale, s);
    case 16: return launch<T, 16>(q, k, v, out, B, S, H, KV, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, KV, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, KV, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, KV, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, B, S, H, KV, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out [B, S, H, D]; k, v [B, S, KV, D]; all contiguous, of type `dtype`
// (0 float32, 1 bfloat16).  D in {8, 16, 32, 64, 128, 256}; H a multiple of
// KV; window <= 0 means full causal.  Launches on `stream`, allocates
// nothing, does not synchronise.  Returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int KV, int D,
                               int window, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, out, B, S, H, KV, D, window, scale, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, out, B, S, H, KV, D, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
