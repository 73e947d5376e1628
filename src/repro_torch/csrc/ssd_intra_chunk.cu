// Mamba2 SSD intra-chunk contraction for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py, ssd_intra_chunk_pallas (the
// Pallas TPU kernel behind repro.models.ssm._ssd_chunked when
// cfg.use_ssd_kernel is set).
//
// For each (batch b, chunk c, head h) of length L, with head h reading group
// g = h / rep of B and C:
//     W[i, j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j     for j <= i, else 0
//     y[i]    = sum_j W[i, j] x_j                             [L, P]
//     state   = sum_j exp(cum_{L-1} - cum_j) dt_j  x_j (x) B_j   [P, N]
// all in f32; y is written in x's type, the state in f32.
//
// What bounds it on an H100: bytes.  At the serving shape (L = 128,
// P = N = 64, bf16 x / B / C) a block reads 16 KB of x and writes 16 KB of y
// and 16 KB of state for about 3.2 M multiply-adds of the causal half,
// some 60 operations a byte: below the tensor cores' ridge point, above the
// CUDA cores' one.  This first kernel does the products in f32 FMAs on the
// CUDA cores.
//
// Design.  The TPU grid (b, c, h) becomes the CUDA grid (h, c, b); nothing
// carries between blocks, so each block is independent.  The chunk's x, B,
// C, dt and cum are staged in dynamic shared memory as f32 (167 KB at the
// serving shape, hence cudaFuncSetAttribute), B and C transposed to [N][L]
// so that both products read 16-byte chunks along the sequence.  Three
// phases, each a 4 x 4 register tile per thread:
//   1. W into shared memory, only for tiles on or below the diagonal (whole
//      warps of tiles above it are skipped).  exp(cum_i - cum_j) is taken
//      only for j <= i: cum decreases (A < 0), so for j > i the exponent is
//      positive and may overflow, and inf * 0 would be NaN where the Pallas
//      kernel's jnp.where selects it away.
//   2. y = W x, each row summing only up to its diagonal.
//   3. the chunk state from x scaled by exp(cum_last - cum_j) dt_j, and B.
// Rows past L (a chunk shorter than a multiple of 4) are zero in shared
// memory and never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory limit

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

__device__ __forceinline__ void unpack(const float4 f, float (&o)[4]) {
  o[0] = f.x;
  o[1] = f.y;
  o[2] = f.z;
  o[3] = f.w;
}

// Row strides (floats) of the shared arrays: lp = L rounded up to 4 (x and
// W rows), sl for the transposed B / C rows.  sl pads them so that 8
// neighbouring lanes storing 16 bytes each at rows n..n+7 hit 8 distinct
// bank groups; it falls back to lp where the pad would not fit.
struct Layout {
  int lp, sl, bytes;
};

Layout layout(int L, int P, int N) {
  Layout t;
  t.lp = (L + 3) / 4 * 4;
  const int padded = (t.lp / 4) % 2 == 0 ? t.lp + 4 : t.lp;
  for (int sl : {padded, t.lp}) {
    t.sl = sl;
    t.bytes = static_cast<int>(sizeof(float)) * (2 * N * sl + t.lp * P + t.lp * t.lp + 3 * t.lp);
    if (t.bytes <= kMaxSmem) break;
  }
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ xc, const float* __restrict__ dtc,
           const float* __restrict__ cum, const T* __restrict__ bc,
           const T* __restrict__ cc, T* __restrict__ y, float* __restrict__ state,
           int Nc, int L, int H, int P, int G, int N, int rep, int lp, int sl) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;           // [N][sl]  C transposed
  float* bt = ct + N * sl;    // [N][sl]  B transposed
  float* xs = bt + N * sl;    // [lp][P]
  float* w = xs + lp * P;     // [lp][lp]
  float* dts = w + lp * lp;   // [lp]
  float* cs = dts + lp;       // [lp]
  float* dec = cs + lp;       // [lp]  exp(cum_last - cum_j) dt_j

  const int h = blockIdx.x;
  const int64_t bcix = static_cast<int64_t>(blockIdx.z) * Nc + blockIdx.y;  // (b, c)
  const int g = h / rep;
  const int tid = threadIdx.x;
  const int q = lp / 4;
  const int64_t xrow = static_cast<int64_t>(H) * P;  // between positions in x / y
  const int64_t brow = static_cast<int64_t>(G) * N;  // between positions in B / C
  const T* xg = xc + bcix * L * xrow + static_cast<int64_t>(h) * P;
  T* yg = y + bcix * L * xrow + static_cast<int64_t>(h) * P;
  const T* bg = bc + bcix * L * brow + static_cast<int64_t>(g) * N;
  const T* cg = cc + bcix * L * brow + static_cast<int64_t>(g) * N;
  const float* dg = dtc + bcix * L * H + h;
  const float* cug = cum + bcix * L * H + h;
  float* sg = state + (bcix * H + h) * P * N;

  // ---- stage the chunk -------------------------------------------------
  for (int e = tid; e < lp * P; e += kThreads) {
    const int i = e / P, p = e % P;
    xs[e] = i < L ? to_f(xg[i * xrow + p]) : 0.f;
  }
  for (int e = tid; e < N * q; e += kThreads) {
    const int n = e % N, i0 = e / N * 4;
    float bb[4], cv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool in = i0 + r < L;
      bb[r] = in ? to_f(bg[(i0 + r) * brow + n]) : 0.f;
      cv[r] = in ? to_f(cg[(i0 + r) * brow + n]) : 0.f;
    }
    *reinterpret_cast<float4*>(bt + n * sl + i0) = make_float4(bb[0], bb[1], bb[2], bb[3]);
    *reinterpret_cast<float4*>(ct + n * sl + i0) = make_float4(cv[0], cv[1], cv[2], cv[3]);
  }
  for (int i = tid; i < lp; i += kThreads) {
    dts[i] = i < L ? dg[static_cast<int64_t>(i) * H] : 0.f;
    cs[i] = i < L ? cug[static_cast<int64_t>(i) * H] : 0.f;
  }
  __syncthreads();
  const float cum_last = cs[L - 1];
  for (int i = tid; i < lp; i += kThreads)
    dec[i] = i < L ? expf(cum_last - cs[i]) * dts[i] : 0.f;

  // ---- 1. W = (C B^T) * decay * dt on and below the diagonal ----------
  // a warp takes 8 row-quads x 4 column-quads (32 rows x 16 columns)
  const int warp = tid / 32, lane = tid % 32;
  const int wti = (q + 7) / 8, wtj = (q + 3) / 4;
  for (int wt = warp; wt < wti * wtj; wt += kThreads / 32) {
    const int wi = wt / wtj, wj = wt % wtj;
    if (wj * 16 > wi * 32 + 31) continue;  // wholly above the diagonal
    const int ti = wi * 8 + lane / 4, tj = wj * 4 + lane % 4;
    if (ti >= q || tj >= q || tj > ti) continue;
    float acc[4][4] = {};
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
      unpack(*reinterpret_cast<const float4*>(ct + n * sl + 4 * ti), cv);
      unpack(*reinterpret_cast<const float4*>(bt + n * sl + 4 * tj), bv);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(cv[a], bv[c], acc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * ti + a, j = 4 * tj + c;
        float val = 0.f;
        if (j <= i && i < L) val = acc[a][c] * expf(cs[i] - cs[j]) * dts[j];
        w[i * lp + j] = val;
      }
  }
  __syncthreads();

  // ---- 2. y = W x, rows summed up to their diagonal -------------------
  const int pt_n = P / 4;
  for (int t = tid; t < q * pt_n; t += kThreads) {
    const int it = t / pt_n, pt = t % pt_n;
    float acc[4][4] = {};
    for (int j0 = 0; j0 < 4 * it + 4; j0 += 4) {
      float wv[4][4], xv[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        unpack(*reinterpret_cast<const float4*>(w + (4 * it + a) * lp + j0), wv[a]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        unpack(*reinterpret_cast<const float4*>(xs + (j0 + c) * P + 4 * pt), xv[c]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(wv[a][c], xv[c][e], acc[a][e]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * it + a;
      if (i < L)
#pragma unroll
        for (int e = 0; e < 4; ++e) yg[i * xrow + 4 * pt + e] = from_f<T>(acc[a][e]);
    }
  }

  // ---- 3. state[p, n] = sum_j (x_j[p] dec_j) B_j[n] --------------------
  const int nt_n = N / 4;
  for (int t = tid; t < pt_n * nt_n; t += kThreads) {
    const int pt = t % pt_n, nt = t / pt_n;
    float acc[4][4] = {};  // [p][n]
    for (int j0 = 0; j0 < lp; j0 += 4) {
      float dv[4], xv[4][4], bv[4][4];
      unpack(*reinterpret_cast<const float4*>(dec + j0), dv);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        unpack(*reinterpret_cast<const float4*>(xs + (j0 + c) * P + 4 * pt), xv[c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) xv[c][e] *= dv[c];
      }
#pragma unroll
      for (int f = 0; f < 4; ++f)
        unpack(*reinterpret_cast<const float4*>(bt + (4 * nt + f) * sl + j0), bv[f]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[e][f] = fmaf(xv[c][e], bv[f][c], acc[e][f]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float4*>(sg + (4 * pt + e) * N + 4 * nt) =
          make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
  }
}

template <typename T>
int launch(const void* xc, const float* dtc, const float* cum, const void* bc,
           const void* cc, void* y, float* state, int B, int Nc, int L, int H,
           int P, int G, int N, cudaStream_t s) {
  const Layout t = layout(L, P, N);
  if (t.bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, t.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, Nc, B);
  ssd_kernel<T><<<grid, kThreads, t.bytes, s>>>(
      static_cast<const T*>(xc), dtc, cum, static_cast<const T*>(bc),
      static_cast<const T*>(cc), static_cast<T*>(y), state, Nc, L, H, P, G, N,
      H / G, t.lp, t.sl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xc, y [B, Nc, L, H, P] and bc, cc [B, Nc, L, G, N] of type `dtype`
// (0 float32, 1 bfloat16); dtc, cum [B, Nc, L, H] float32; state
// [B, Nc, H, P, N] float32; all contiguous.  L <= 128, P and N multiples of
// 4, H a multiple of G.  Launches on `stream`, allocates nothing, does not
// synchronise.  Returns cudaGetLastError() (0 = launched).
extern "C" int ssd_intra_chunk(const void* xc, const float* dtc, const float* cum,
                               const void* bc, const void* cc, void* y,
                               float* state, int B, int Nc, int L, int H, int P,
                               int G, int N, int dtype, void* stream) {
  if (B < 1 || B > 65535 || Nc < 1 || Nc > 65535 || L < 1 || L > kMaxL || P < 4 ||
      P % 4 != 0 || N < 4 || N % 4 != 0 || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(xc, dtc, cum, bc, cc, y, state, B, Nc, L, H, P, G, N, s);
    case 1:
      return launch<__nv_bfloat16>(xc, dtc, cum, bc, cc, y, state, B, Nc, L, H, P, G, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
