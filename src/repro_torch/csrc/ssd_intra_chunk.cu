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
// CUDA cores' one.  Two variants, chosen by the caller from the type and
// shape alone (kernels/ssd_scan/kernel.py, ssd_variant):
//
// tensor_cores (bf16, L <= 128 and P <= 128, all three multiples of 16,
// N a multiple of 16): one block of 4 warps per (head, chunk, batch).  x, B
// and C are copied as bf16 by 16-byte cp.async into shared memory (rows
// padded by 16 bytes for conflict-free ldmatrix), 56 KB at the serving
// shape, so four blocks share an SM and one block's copies overlap the
// others' products; dt, cum and the decay to the chunk's end are kept as
// f32.  A warp takes the 16-row blocks r and L/16 - 1 - r of W, so every
// warp does the same work under the causal triangle, and for each 16-key
// step j <= its diagonal:
//   1. C B^T by mma.sync m16n8k16 bf16 -> f32 (exact products), then
//      * exp(cum_i - cum_j) * dt_j on the accumulator fragment, taken only
//      for j <= i and 0 elsewhere: cum decreases (A < 0), so above the
//      diagonal the exponent is positive and may overflow, and inf * 0 would
//      be NaN where the Pallas kernel's jnp.where selects it away;
//   2. y += W x with W's fragments repacked in registers as A fragments and
//      x read by ldmatrix.trans.  W is f32: rounded to bf16 it would cost up
//      to 2^-9 of each weight (some 60 bf16 ulps of y's floored scale), so it
//      is split into bf16 hi + lo and takes two products.
// Then each warp takes 16 rows p of the state (x * dec)^T B, with x * dec
// split into three bf16 parts (hi + mid + lo, about 2^-24 of each term:
// with two, the state's error reaches half of its 1e-5 x scale check).
// W never goes to shared memory.
//
// cuda_cores (f32, and bf16 shapes the tensor-core variant does not take):
// the first design, kept for the f32 parity paths.  The TPU grid (b, c, h)
// becomes the CUDA grid (h, c, b); nothing carries between blocks, so each
// block is independent.  The chunk's x, B, C, dt and cum are staged in
// dynamic shared memory as f32 (167 KB at the serving shape, hence
// cudaFuncSetAttribute), B and C transposed to [N][L] so that both products
// read 16-byte chunks along the sequence.  Three phases, each a 4 x 4
// register tile per thread on the CUDA cores:
//   1. W into shared memory, only for tiles on or below the diagonal (whole
//      warps of tiles above it are skipped), exp(cum_i - cum_j) only for
//      j <= i as above.
//   2. y = W x, each row summing only up to its diagonal.
//   3. the chunk state from x scaled by exp(cum_last - cum_j) dt_j, and B.
// Rows past L (a chunk shorter than a multiple of 4) are zero in shared
// memory and never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------------------
// tensor_cores variant (bf16; L, P, N multiples of 16, L and P <= 128)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
using namespace mma_bf16;
using mma_bf16::unpack;  // not the f32 helper of the enclosing namespace

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// shared layout: x [L][P + 8], B and C [L][N + 8] (bf16), then dt, cum and
// dec [L] (f32)
inline int smem_bytes(int L, int P, int N) {
  return 2 * (L * (P + 8) + 2 * L * (N + 8)) + 3 * 4 * L;
}

// PMAX: the widest P this instance takes (y's accumulators live in
// registers, PMAX / 8 fragments a thread)
template <int PMAX>
__global__ void __launch_bounds__(kThreads)
ssd_tc_kernel(const bf16* __restrict__ xc, const float* __restrict__ dtc,
              const float* __restrict__ cum, const bf16* __restrict__ bc,
              const bf16* __restrict__ cc, bf16* __restrict__ y, float* __restrict__ state,
              int Nc, int L, int H, int P, int G, int N, int rep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = P + 8, ldb = N + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [L][ldx]
  bf16* bs = xs + L * ldx;                        // [L][ldb]
  bf16* cs = bs + L * ldb;                        // [L][ldb]
  float* dts = reinterpret_cast<float*>(cs + L * ldb);
  float* cus = dts + L;
  float* dec = cus + L;  // exp(cum_last - cum_j) dt_j

  const int h = blockIdx.x;
  const int64_t bcix = static_cast<int64_t>(blockIdx.z) * Nc + blockIdx.y;  // (b, c)
  const int grp = h / rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t xrow = static_cast<int64_t>(H) * P;  // between positions in x / y
  const int64_t brow = static_cast<int64_t>(G) * N;  // between positions in B / C
  const bf16* xg = xc + bcix * L * xrow + static_cast<int64_t>(h) * P;
  bf16* yg = y + bcix * L * xrow + static_cast<int64_t>(h) * P;
  const bf16* bg = bc + bcix * L * brow + static_cast<int64_t>(grp) * N;
  const bf16* cg = cc + bcix * L * brow + static_cast<int64_t>(grp) * N;
  const float* dg = dtc + bcix * L * H + h;
  const float* cug = cum + bcix * L * H + h;
  float* sg = state + (bcix * H + h) * P * N;

  // ---- stage the chunk ---------------------------------------------------
  const int xch = P / 8, bch = N / 8;  // 16-byte chunks of a row
  for (int e = tid; e < L * xch; e += kThreads) {
    const int i = e / xch, c = e % xch;
    cp_async16(smem_addr(xs + i * ldx + c * 8), xg + i * xrow + c * 8);
  }
  for (int e = tid; e < L * bch; e += kThreads) {
    const int i = e / bch, c = e % bch;
    cp_async16(smem_addr(bs + i * ldb + c * 8), bg + i * brow + c * 8);
    cp_async16(smem_addr(cs + i * ldb + c * 8), cg + i * brow + c * 8);
  }
  cp_async_commit();
  const float cum_last = cug[static_cast<int64_t>(L - 1) * H];
  for (int i = tid; i < L; i += kThreads) {
    const float d = dg[static_cast<int64_t>(i) * H], cu = cug[static_cast<int64_t>(i) * H];
    dts[i] = d;
    cus[i] = cu;
    dec[i] = expf(cum_last - cu) * d;
  }
  cp_async_wait<0>();
  __syncthreads();

  // shared byte addresses of each lane's ldmatrix row in a 16 x 16 block:
  // A fragments (rows i, no .trans), B fragments of rows j (no .trans: B in
  // C B^T), B fragments of k rows (.trans: x in W x, B in the state), and
  // A fragments read transposed (x^T in the state)
  constexpr int kB = static_cast<int>(sizeof(bf16));
  const uint32_t x_addr = smem_addr(xs), b_addr = smem_addr(bs), c_addr = smem_addr(cs);
  const int a_lane = (lane % 16), a_col = 8 * (lane / 16);
  const int n_lane = (lane & 7) + 8 * (lane >> 4), n_col = 8 * ((lane >> 3) & 1);
  const int t_lane = (lane & 7) + 8 * ((lane >> 3) & 1), t_col = 8 * (lane >> 4);

  // ---- W and y, two 16-row blocks a warp ---------------------------------
  constexpr int NP = PMAX / 8;  // n8 tiles of y a thread may hold
  const int nrb = L / 16, np = P / 8;
  for (int pair = warp; 2 * pair < nrb; pair += kWarps) {
    for (int half = 0; half < 2; ++half) {
      const int rb = half == 0 ? pair : nrb - 1 - pair;
      if (half == 1 && rb == pair) break;  // odd nrb: the middle block once
      const int i0 = 16 * rb + g, i1 = i0 + 8;
      const float ci0 = cus[i0], ci1 = cus[i1];
      float acc[NP][4];
#pragma unroll
      for (int n = 0; n < NP; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      for (int sj = 0; sj <= rb; ++sj) {
        // 1. s = C_i . B_j over N for keys j in [16 sj, 16 sj + 16)
        float sc[2][4] = {};
        for (int kn = 0; kn < N / 16; ++kn) {
          uint32_t ca[4], bb[4];
          ldmatrix_x4(ca, c_addr + ((16 * rb + a_lane) * ldb + 16 * kn + a_col) * kB);
          ldmatrix_x4(bb, b_addr + ((16 * sj + n_lane) * ldb + 16 * kn + n_col) * kB);
          mma(sc[0], ca, bb[0], bb[1]);
          mma(sc[1], ca, bb[2], bb[3]);
        }
        // W = s * exp(cum_i - cum_j) * dt_j on and below the diagonal
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? i0 : i1, j = 16 * sj + 8 * c + 2 * t + (e & 1);
            float w = 0.f;
            if (j <= i) w = sc[c][e] * expf((e < 2 ? ci0 : ci1) - cus[j]) * dts[j];
            sc[c][e] = w;
          }
        uint32_t wh[4], wl[4];
        wh[0] = split(sc[0][0], sc[0][1]);
        wh[1] = split(sc[0][2], sc[0][3]);
        wh[2] = split(sc[1][0], sc[1][1]);
        wh[3] = split(sc[1][2], sc[1][3]);
        wl[0] = pack(sc[0][0], sc[0][1]);
        wl[1] = pack(sc[0][2], sc[0][3]);
        wl[2] = pack(sc[1][0], sc[1][1]);
        wl[3] = pack(sc[1][2], sc[1][3]);
        // 2. y += W x
#pragma unroll
        for (int pq = 0; pq < NP / 2; ++pq) {
          if (2 * pq >= np) break;
          uint32_t r[4];
          ldmatrix_x4_trans(r, x_addr + ((16 * sj + t_lane) * ldx + 16 * pq + t_col) * kB);
          mma(acc[2 * pq], wl, r[0], r[1]);
          mma(acc[2 * pq], wh, r[0], r[1]);
          mma(acc[2 * pq + 1], wl, r[2], r[3]);
          mma(acc[2 * pq + 1], wh, r[2], r[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        if (n >= np) break;
        *reinterpret_cast<uint32_t*>(yg + i0 * xrow + 8 * n + 2 * t) = pack(acc[n][0], acc[n][1]);
        *reinterpret_cast<uint32_t*>(yg + i1 * xrow + 8 * n + 2 * t) = pack(acc[n][2], acc[n][3]);
      }
    }
  }

  // ---- state[p, n] = sum_j (x_j[p] dec_j) B_j[n], 16 rows p a warp --------
  for (int pb = warp; pb < P / 16; pb += kWarps) {
    for (int n0 = 0; n0 < N; n0 += 64) {  // 64 columns of state at a time
      const int nn = min(64, N - n0) / 8;  // n8 tiles in this slice
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      for (int sj = 0; sj < L / 16; ++sj) {
        // A[p][j] = x[j][p] dec_j: x read transposed, scaled, split in three
        uint32_t xa[4];
        ldmatrix_x4_trans(xa, x_addr + ((16 * sj + n_lane) * ldx + 16 * pb + n_col) * kB);
        const float d0 = dec[16 * sj + 2 * t], d1 = dec[16 * sj + 2 * t + 1];
        const float d8 = dec[16 * sj + 2 * t + 8], d9 = dec[16 * sj + 2 * t + 9];
        float a[4][2];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xv = unpack(xa[e]);
          a[e][0] = xv.x * (e < 2 ? d0 : d8);
          a[e][1] = xv.y * (e < 2 ? d1 : d9);
        }
        uint32_t ah[4], am[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = split(a[e][0], a[e][1]);
          am[e] = split(a[e][0], a[e][1]);
          al[e] = pack(a[e][0], a[e][1]);
        }
#pragma unroll
        for (int nq = 0; nq < 4; ++nq) {
          if (2 * nq >= nn) break;
          uint32_t r[4];
          ldmatrix_x4_trans(r, b_addr + ((16 * sj + t_lane) * ldb + n0 + 16 * nq + t_col) * kB);
          mma(acc[2 * nq], al, r[0], r[1]);
          mma(acc[2 * nq], am, r[0], r[1]);
          mma(acc[2 * nq], ah, r[0], r[1]);
          mma(acc[2 * nq + 1], al, r[2], r[3]);
          mma(acc[2 * nq + 1], am, r[2], r[3]);
          mma(acc[2 * nq + 1], ah, r[2], r[3]);
        }
      }
      const int p0 = 16 * pb + g;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n >= nn) break;
        const int col = n0 + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(sg + static_cast<int64_t>(p0) * N + col) =
            make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(sg + static_cast<int64_t>(p0 + 8) * N + col) =
            make_float2(acc[n][2], acc[n][3]);
      }
    }
  }
}

template <int PMAX>
int launch(const void* xc, const float* dtc, const float* cum, const void* bc,
           const void* cc, void* y, float* state, int B, int Nc, int L, int H, int P,
           int G, int N, cudaStream_t s) {
  const int bytes = smem_bytes(L, P, N);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_tc_kernel<PMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, Nc, B);
  ssd_tc_kernel<PMAX><<<grid, kThreads, bytes, s>>>(
      static_cast<const bf16*>(xc), dtc, cum, static_cast<const bf16*>(bc),
      static_cast<const bf16*>(cc), static_cast<bf16*>(y), state, Nc, L, H, P, G, N, H / G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// xc, y [B, Nc, L, H, P] and bc, cc [B, Nc, L, G, N] of type `dtype`
// (0 float32, 1 bfloat16); dtc, cum [B, Nc, L, H] float32; state
// [B, Nc, H, P, N] float32; all contiguous; H a multiple of G.  `variant` 0
// (cuda_cores) takes L <= 128 and P, N multiples of 4; 1 (tensor_cores)
// takes bfloat16 with L and P multiples of 16 up to 128 and N a multiple of
// 16.  Launches on `stream`, allocates nothing, does not synchronise.
// Returns cudaGetLastError() (0 = launched); a variant that does not take
// the type or shape is refused.
extern "C" int ssd_intra_chunk(const void* xc, const float* dtc, const float* cum,
                               const void* bc, const void* cc, void* y,
                               float* state, int B, int Nc, int L, int H, int P,
                               int G, int N, int dtype, int variant, void* stream) {
  if (B < 1 || B > 65535 || Nc < 1 || Nc > 65535 || L < 1 || L > kMaxL || P < 4 ||
      P % 4 != 0 || N < 4 || N % 4 != 0 || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != 1 || L % 16 != 0 || P % 16 != 0 || N % 16 != 0 || P > 128)
      return static_cast<int>(cudaErrorInvalidValue);
    if (P <= 64) return tc::launch<64>(xc, dtc, cum, bc, cc, y, state, B, Nc, L, H, P, G, N, s);
    return tc::launch<128>(xc, dtc, cum, bc, cc, y, state, B, Nc, L, H, P, G, N, s);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch<float>(xc, dtc, cum, bc, cc, y, state, B, Nc, L, H, P, G, N, s);
    case 1:
      return launch<__nv_bfloat16>(xc, dtc, cum, bc, cc, y, state, B, Nc, L, H, P, G, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
