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
// operations a byte: the least time is that work at the bf16 tensor-core
// peak.  Two variants, chosen by the caller from the type and D alone
// (kernels/flash_attention/kernel.py, flash_variant):
//
// tensor_cores (bf16, D in {64, 128}): an mma.sync design, not wgmma.  One
// block of 8 warps per (128-row query tile, head, batch), heaviest tiles
// first; each warp owns 16 query rows, whose q stays in registers as mma A
// fragments for the whole kv loop.  K and V tiles of 64 keys are copied as
// bf16 by 16-byte cp.async into a ring of two stages (rows padded by 16
// bytes, so ldmatrix's eight row addresses fall in eight bank groups): tile
// k + 1 is in flight while tile k is multiplied, one __syncthreads a tile.
// A warp scores 64 keys (32 with a window) at a time, S = q K^T by
// mma.m16n8k16 bf16 -> f32 (exact products, f32 sums), and runs the online
// softmax on the accumulator fragments: p = 2^(s c - m c) with
// c = scale * log2 e, one FFMA and one ex2 a score; the row max and sum
// meet across the 4 lanes of a row by __shfl_xor_sync.  A masked score is
// -inf, its weight exactly 0, where the Pallas kernel's NEG_INF gives
// weights that a later rescale zeroes: the same sums.  P stays in
// registers: its C fragments are the A fragments of O += P V, V read by
// ldmatrix.trans.  Rounding P to bf16 would cost up to 2^-9 of each weight,
// some 20 bf16 ulps of the output's floored scale at S = 512 to 2048, so P
// is split into bf16 hi + lo and P V takes two products (about 2^-18 of
// each weight; 1.5x the products' operations).  The tensor cores' f32
// accumulation truncates what falls below the largest addend's exponent, so
// an O fragment that took all S / 16 products as the mma's accumulator
// drifted with S (1.65 floored bf16 ulps at S = 32,768 against the
// rounding's 0.5): each sub-tile's products start from zero and meet O,
// rescaled, in one f32 FMA that rounds to nearest (0.54 at every length;
// tools/flash_accuracy.py).  A warp skips keys wholly above its diagonal
// or before its window and masks only those that cross either; keys and
// queries past S are zero-filled.  D = 64 fits 128 registers a thread
// (with 8-24 bytes spilled), so two blocks (16 warps) share an SM, one block's
// softmax overlapping the other's products.  What bounds it: the mma.sync
// rate and the ldmatrix traffic of every warp reading whole K and V tiles
// (wgmma with TMA would share them across a warpgroup), then the ex2 and
// the split of every score.
//
// cuda_cores (f32 any D, bf16 other D): the first design, kept for the f32
// parity paths.  The TPU grid's sequential kv axis becomes a loop inside the
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
// Sixteen scores are taken before one rescale of the accumulator; f32 FMAs
// on the CUDA cores, whose peak is 67 TFLOP/s, not 989.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------------------
// tensor_cores variant (bf16, D in {64, 128})
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
using namespace mma_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int BQ = 16 * kWarps;  // query rows of a block, 16 a warp
constexpr int BK = 64;           // keys of a tile
constexpr int kStages = 2;       // K/V tiles in flight: the ring's length

template <int D>
struct Shape {
  static constexpr int LD = D + 8;         // shared row, elements (16-byte pad)
  static constexpr int TILE = BK * LD;     // one K or V tile, elements
  static constexpr int STAGE = 2 * TILE;   // K then V
  static constexpr int SMEM = kStages * STAGE * static_cast<int>(sizeof(bf16));
  static constexpr int CH = D / 8;         // 16-byte chunks of a row
  // q is staged in the last stage (read into registers before that stage's
  // first K/V tile is copied), the output in the first one
  static_assert(BQ * LD <= STAGE, "a query tile must fit one stage");
  static_assert(kThreads % CH == 0 && BK % (kThreads / CH) == 0, "whole copy passes");
};

template <int D, bool kWindow>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int S, int H,
                int KV, int window, float scale_log2) {
  using Sh = Shape<D>;
  constexpr int LD = Sh::LD, CH = Sh::CH, KD = D / 16, ND = D / 8;
  // keys scored before one softmax update: 64, or 32 where the window's
  // checks would otherwise push D = 64 past 128 registers (2 blocks an SM)
  constexpr int SUB = kWindow ? 32 : 64;
  constexpr int NS = SUB / 8;  // n8 tiles of scores a warp holds
  static_assert(BK % SUB == 0 && SUB % 16 == 0, "whole sub-tiles of 16-key steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qtile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q_lo = qtile * BQ;
  // A batch row of q holds S * H * D elements, past 2^31 at long contexts
  // (qwen3-14b's 524,288 x 40 x 128): the block's query tile and each K/V
  // tile get a 64-bit base pointer, and offsets within a tile (< 128
  // positions) stay 32-bit
  const int q_step = H * D, kv_step = KV * D;  // between positions
  const int64_t q_tile = (static_cast<int64_t>(b) * S + q_lo) * q_step + h * D;
  const bf16* qt = q + q_tile;  // row q_lo of this head
  bf16* ot = out + q_tile;
  const bf16* kb = k + static_cast<int64_t>(b) * S * kv_step + kvh * D;
  const bf16* vb = v + static_cast<int64_t>(b) * S * kv_step + kvh * D;

  const int k_end = min(S, q_lo + BQ);  // keys past the tile's last row are masked
  int k_begin = kWindow ? max(0, q_lo - window + 1) : 0;
  k_begin -= k_begin % BK;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  // byte addresses in shared memory; each lane's ldmatrix row within a
  // 16 x 16 block, so that every fragment's address is one of these plus a
  // constant: q and K (rows j, no .trans), V (.trans)
  const uint32_t s_base = smem_addr(sm);
  const int a_lane = (lane % 16) * LD + 8 * (lane / 16);
  const int k_lane = ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
  const int v_lane = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
  constexpr int kB = static_cast<int>(sizeof(bf16));

  // copies: a thread moves 16-byte chunk ld_c of rows ld_r, ld_r + RPP, ...
  constexpr int RPP = kThreads / CH;  // rows the block copies in one pass
  const int ld_r = tid / CH, ld_c = 8 * (tid % CH);
  const uint32_t ld_dst = s_base + (ld_r * LD + ld_c) * kB;

  // K and V rows of tile `it` into stage it % kStages; keys past S read as 0
  auto load_tile = [&](int it) {
    const uint32_t dst = ld_dst + (it % kStages) * Sh::STAGE * kB;
    const int j0 = k_begin + it * BK;  // the tile's first key, below S
    const int64_t tile = static_cast<int64_t>(j0) * kv_step;
    const bf16* kt = kb + tile;
    const bf16* vt = vb + tile;
#pragma unroll
    for (int u = 0; u < BK / RPP; ++u) {
      const int r = ld_r + u * RPP;
      const bool in = j0 + r < S;
      const int off = (in ? r : 0) * kv_step + ld_c;
      cp_async16(dst + u * RPP * LD * kB, kt + off, in);
      cp_async16(dst + (Sh::TILE + u * RPP * LD) * kB, vt + off, in);
    }
  };

#pragma unroll
  for (int u = 0; u < BQ / RPP; ++u) {
    const int r = ld_r + u * RPP;
    const bool in = q_lo + r < S;
    cp_async16(ld_dst + ((kStages - 1) * Sh::STAGE + u * RPP * LD) * kB,
               qt + (in ? r : 0) * q_step + ld_c, in);
  }
  load_tile(0);
  cp_async_commit();
#pragma unroll
  for (int st = 1; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  uint32_t qa[KD][4];  // this warp's 16 rows of q, as A fragments
  {
    const uint32_t qa_addr = s_base + ((kStages - 1) * Sh::STAGE + 16 * warp * LD + a_lane) * kB;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) ldmatrix_x4(qa[kd], qa_addr + 16 * kd * kB);
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const int row_min = q_lo + 16 * warp, row_max = row_min + 15;
  const int i0 = row_min + g, i1 = i0 + 8;
  const float minus_inf = -__int_as_float(0x7f800000);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // tile `it` has landed (this thread's copies)
    __syncthreads();               // ... everyone's, and stage (it - 1) is free
    if (it + kStages - 1 < n_tiles) load_tile(it + kStages - 1);
    cp_async_commit();
    const uint32_t stage = s_base + (it % kStages) * Sh::STAGE * kB;
#pragma unroll
    for (int sub = 0; sub < BK / SUB; ++sub) {
      const int k0 = k_begin + it * BK + sub * SUB;
      // wholly above this warp's diagonal, or wholly before its window
      if (k0 > row_max || (kWindow && k0 + SUB - 1 <= row_min - window)) continue;
      const uint32_t k_addr = stage + (sub * SUB * LD + k_lane) * kB;
      const uint32_t v_addr = stage + (Sh::TILE + sub * SUB * LD + v_lane) * kB;

      float s[NS][4];
#pragma unroll
      for (int c = 0; c < NS; ++c) s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int p = 0; p < NS / 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4(r, k_addr + (16 * p * LD + 16 * kd) * kB);
          mma(s[2 * p], qa[kd], r[0], r[1]);
          mma(s[2 * p + 1], qa[kd], r[2], r[3]);
        }

      // mask only keys that cross the diagonal or the window's edge for
      // some row of this warp; a masked score is -inf, so its weight is 0
      if (k0 + SUB - 1 > row_min || (kWindow && row_max - k0 >= window)) {
#pragma unroll
        for (int c = 0; c < NS; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? i0 : i1, j = k0 + 8 * c + 2 * t + (e & 1);
            if (j > i || (kWindow && i - j >= window)) s[c][e] = minus_inf;
          }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        mx0 = fmaxf(mx0, fmaxf(s[c][0], s[c][1]));
        mx1 = fmaxf(mx1, fmaxf(s[c][2], s[c][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // The max starts at NEG_INF (finite), so it stays finite while a row
      // has seen only masked keys, and those keys' weights are exactly 0;
      // the Pallas kernel gives them exp(0) = 1 and rescales them by 0 at
      // the row's first real key, which every row reaches (j = i): the same
      // sums.  Scores stay unscaled: p = 2^(s c - m c), c = scale log2(e).
      const float a0 = ex2((m0 - mx0) * scale_log2), a1 = ex2((m1 - mx1) * scale_log2);
      const float mc0 = mx0 * scale_log2, mc1 = mx1 * scale_log2;
      m0 = mx0;
      m1 = mx1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        s[c][0] = ex2(fmaf(s[c][0], scale_log2, -mc0));
        s[c][1] = ex2(fmaf(s[c][1], scale_log2, -mc0));
        s[c][2] = ex2(fmaf(s[c][2], scale_log2, -mc1));
        s[c][3] = ex2(fmaf(s[c][3], scale_log2, -mc1));
        l0 += s[c][0] + s[c][1];
        l1 += s[c][2] + s[c][3];
      }

      // P = hi + lo (two bf16 A fragments a 16 keys)
      uint32_t ph[SUB / 16][4], pl[SUB / 16][4];
#pragma unroll
      for (int kj = 0; kj < SUB / 16; ++kj) {
        ph[kj][0] = split(s[2 * kj][0], s[2 * kj][1]);
        ph[kj][1] = split(s[2 * kj][2], s[2 * kj][3]);
        ph[kj][2] = split(s[2 * kj + 1][0], s[2 * kj + 1][1]);
        ph[kj][3] = split(s[2 * kj + 1][2], s[2 * kj + 1][3]);
        pl[kj][0] = pack(s[2 * kj][0], s[2 * kj][1]);
        pl[kj][1] = pack(s[2 * kj][2], s[2 * kj][3]);
        pl[kj][2] = pack(s[2 * kj + 1][0], s[2 * kj + 1][1]);
        pl[kj][3] = pack(s[2 * kj + 1][2], s[2 * kj + 1][3]);
      }
      // O = a O + P V: each pair of O fragments takes this sub-tile's
      // products from zero, then one f32 FMA (see the header)
#pragma unroll
      for (int dq = 0; dq < ND / 2; ++dq) {
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kj = 0; kj < SUB / 16; ++kj) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, v_addr + (16 * kj * LD + 16 * dq) * kB);
          mma(t0, pl[kj], r[0], r[1]);
          mma(t0, ph[kj], r[0], r[1]);
          mma(t1, pl[kj], r[2], r[3]);
          mma(t1, ph[kj], r[2], r[3]);
        }
        float* o0 = o[2 * dq];
        float* o1 = o[2 * dq + 1];
        o0[0] = fmaf(o0[0], a0, t0[0]);
        o0[1] = fmaf(o0[1], a0, t0[1]);
        o0[2] = fmaf(o0[2], a1, t0[2]);
        o0[3] = fmaf(o0[3], a1, t0[3]);
        o1[0] = fmaf(o1[0], a0, t1[0]);
        o1[1] = fmaf(o1[1], a0, t1[1]);
        o1[2] = fmaf(o1[2], a1, t1[2]);
        o1[3] = fmaf(o1[3], a1, t1[3]);
      }
    }
  }

  // epilogue: out = O / max(l, 1e-30), staged in stage 0 for 16-byte stores
  cp_async_wait<0>();
  __syncthreads();
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* os = sm + 16 * warp * LD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(os + g * LD + 8 * n + 2 * t) = pack(o[n][0] / d0, o[n][1] / d0);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + 8 * n + 2 * t) =
        pack(o[n][2] / d1, o[n][3] / d1);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH, c = e % CH;
    if (row_min + r < S)
      *reinterpret_cast<uint4*>(ot + (16 * warp + r) * q_step + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * LD + c * 8);
  }
}

template <int D, bool kWindow>
int launch_w(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
             int KV, int window, float scale, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D, kWindow>, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape<D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_tc_kernel<D, kWindow><<<grid, kThreads, Shape<D>::SMEM, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), S, H, KV, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
           int KV, int window, float scale, cudaStream_t s) {
  return window > 0 ? launch_w<D, true>(q, k, v, out, B, S, H, KV, window, scale, s)
                    : launch_w<D, false>(q, k, v, out, B, S, H, KV, window, scale, s);
}

}  // namespace tc

}  // namespace

// q, out [B, S, H, D]; k, v [B, S, KV, D]; all contiguous, of type `dtype`
// (0 float32, 1 bfloat16).  `variant` 0 (cuda_cores) takes D in {8, 16, 32,
// 64, 128, 256}; 1 (tensor_cores) takes bfloat16 with D in {64, 128}.  H a
// multiple of KV; window <= 0 means full causal.  Launches on `stream`,
// allocates nothing, does not synchronise.  Returns cudaGetLastError()
// (0 = launched); a variant that does not take the type or D is refused.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int KV, int D,
                               int window, float scale, int dtype, int variant,
                               void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (D) {
      case 64: return tc::launch<64>(q, k, v, out, B, S, H, KV, window, scale, s);
      case 128: return tc::launch<128>(q, k, v, out, B, S, H, KV, window, scale, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, out, B, S, H, KV, D, window, scale, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, out, B, S, H, KV, D, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
