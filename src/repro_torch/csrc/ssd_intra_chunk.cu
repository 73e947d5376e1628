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
// P = N = 64, bf16 x / B / C) a head of a chunk reads 16 KB of x and writes
// 16 KB of y and 16 KB of f32 state for about 3.1 M multiply-adds on the
// tensor cores (W x with W as bf16 hi + lo, the state with x dec in three
// parts), some 60 operations a byte: below the tensor cores' ridge point.
// Two variants, chosen by the caller from the type and shape alone
// (kernels/ssd_scan/kernel.py, ssd_variant):
//
// tensor_cores (bf16, L <= 128 and P <= 128, all three multiples of 16,
// N a multiple of 16): Hopper's own instructions in a persistent grid of
// one block an SM, four warpgroups a block.  A work item is up to 32 heads
// of one B / C group of one chunk (fewer where the launch has fewer chunks
// than the card has SMs; Item, launch); a block takes its next item from a
// counter of the launch.
//   Warpgroup 0 is the producer (setmaxnreg 32): one thread copies, by TMA
// on 5-D tensor maps [D, heads, L, Nc, B] (so the hardware computes the
// 64-bit addresses and a chunk shorter than 128 rows reads zeros past L,
// never the next chunk), each head's x tile into a ring of four stages
// (full / empty mbarriers), and the item's B and C once per item.  An
// item's first x tiles go out while the previous item's last heads are
// computed.
//   Warpgroups 1-3 are consumers (setmaxnreg 160).  At an item's start two
// of them compute a row tile each of S = C B^T by wgmma (rows 0 .. 63 with
// keys 0 .. 63, rows 64 .. 127 with keys 0 .. 127; C and B both K-major, as
// TMA wrote them with the 128-byte swizzle) and write S over C in shared
// memory (f32): C B^T once per item, not once per head.  Then the three
// take the item's heads in turns, each head whole, so that while one forms
// W on the CUDA cores the others' products are on the tensor cores.  For a
// head: dt and cum (its column of [B, Nc, L, H], loaded the head before)
// become cum log2(e), dt and the decay to the chunk's end in shared memory;
// W = S exp(cum_i - cum_j) dt_j is formed in registers in wgmma's
// accumulator layout, 0 above the diagonal (16-key steps past a warp's
// diagonal are skipped; only the diagonal step is masked: there cum
// decreases, the exponent is positive and may overflow, and inf * 0 would
// be NaN where the Pallas kernel's jnp.where selects it away), and split
// into bf16 hi + lo, whose registers are wgmma's A fragments: y = W x by
// wgmma with x MN-major in shared memory (rounded to one bf16, W would cost
// up to 2^-9 of each weight, some 60 bf16 ulps of y's floored scale), four
// 16-key steps at a time and a 64-column panel of y at a time (the
// registers of three warpgroups allow no more).  y goes back through a
// staging buffer by TMA stores of 64 rows.  The state's A = (x dec)^T comes
// from the x tile by ldmatrix.trans, split into three bf16 parts (about
// 2^-24 of each term: with two, the state's error reaches half of its
// 1e-5 x scale check), four 16-row steps at a time, and state = A B by
// wgmma with B MN-major, two 64-column blocks from each build of A where N
// allows; each [64 p][64 n] f32 block goes back through the staging
// buffer as two 128-byte-swizzled panels by TMA stores of whole state rows.
// A chunk of at most 64 positions skips row tile 1 and the state's rows
// 64 .. 127, which hold zeros.
//   Measured on the card (tools/ssd_phases.py, tools/ssd_ab.py, PERF.md):
// the parent design (cp.async, mma.sync, one block of 4 warps a head)
// spent a head's time on W and its split (31 %), the state (21 %), the
// copy wait (16 %), S (15 %), W x (13 %) and its scattered stores (4 %).
// Here a warpgroup's head is paced by forming W (about a quarter of it),
// the state, the staging and the products' waits: each step is a chain of
// dependent instructions, and removing either product or the stores (an
// ablation) saved only a fifth of the time each, so the design adds
// chains in flight (three warpgroups on whole heads) rather than speed to
// one.  Slower in an A/B against the form they changed: each head's rows
// split between two warpgroups (the state's keys handed over through
// shared memory), two warpgroups on whole heads, the state's A built while
// W x runs, and each warp's W steps unrolled apart.  dt and cum stay one
// float a thread at a stride of H floats, loaded into registers a head
// ahead: a TMA box of them needs a row stride of a multiple of 16 bytes
// (H = 6 has 24), the clocks put a head's dt, cum and decay at about 6 %
// of a warp's head at path C's shape (770 of 13,400), and copying them a
// head ahead into shared memory by cp.async ran no faster.
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "hopper_sm90.cuh"
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

using namespace hopper;
using mma_bf16::ex2;
using mma_bf16::ldmatrix_x4_trans;
using mma_bf16::pack;
using mma_bf16::smem_addr;
using mma_bf16::split;
using mma_bf16::unpack;  // not the f32 helper of the enclosing namespace

constexpr int kConsumers = 3;                     // warpgroups taking heads in turns
constexpr int kThreads = 128 * (1 + kConsumers);  // the producer warpgroup first
constexpr int kProducerRegs = 32;                 // a producer thread's registers
constexpr int kConsumerRegs = 160;                // a consumer thread's
constexpr int kRows = 128;            // rows of a chunk tile: L <= 128, rows past L zeros
constexpr int kRow = 128;             // bytes of a swizzled row: 64 bf16 or 32 f32
constexpr int kPanel = kRows * kRow;  // a 64-column panel of a chunk tile
constexpr int kHalf = 64 * kRow;      // 64 rows of a panel: a row tile's
constexpr int kOut = 2 * kHalf;       // a staging buffer: a row tile of y, or 64 x 64 f32 of state
constexpr int kMaxHeads = 32;         // heads of a work item, at most
constexpr int kVec = 3 * kRows * 4;   // one head's cum log2(e), dt and decay to the chunk's end
constexpr int kS0 = 64 * 64 * 4;      // S of row tile 0 (keys 0 .. 63), f32
constexpr int kS = kS0 + 64 * 128 * 4;  // and of row tile 1 (keys 0 .. 127)
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <=
                  65536 / kThreads / 8 * 8 * kThreads,
              "the registers of one block an SM");

#ifdef SSD_PHASE_CLOCKS
// Instrumented builds only (tools/ssd_phases.py): the clocks a consumer warp
// spends on a head in each step, summed over the launch by warpgroup: 0
// waiting for x (and for the item's B and C), 1 S, 2 W and its split, 3 W x,
// 4 the state, 5 staging and storing y and the state, 6 the head's dt, cum
// and decay (waiting for their loads), 7 the warpgroup's barrier before the
// head's x; 8 counts the warp-heads.
constexpr int kPhases = 9;
__device__ unsigned long long g_phase_clocks[kConsumers][kPhases];
struct PhaseClocks {
  unsigned long long sum[kPhases] = {};
  unsigned int last = 0;
  __device__ __forceinline__ void begin() { last = clock(); }
  __device__ __forceinline__ void head() { ++sum[kPhases - 1]; }
  __device__ __forceinline__ void mark(int k) {
    const unsigned int now = clock();
    sum[k] += now - last;
    last = now;
  }
};
#define SSD_PHASE(call) clocks.call
#else
#define SSD_PHASE(call)
#endif

// Shared memory from a 1024-byte-aligned base (byte offsets): B of the
// work item (npan 64-column panels), C of the item and then, once both
// row tiles of S = C B^T are computed, S itself (f32, kS bytes), the ring
// of x tiles (stages, xpan panels each), each consumer warpgroup's staging
// buffer and its two heads' vectors (kVec each), then the barriers:
// full[stages], empty[stages], item_full, item_empty, and the item's
// number.
struct Layout {
  int npan, xpan, stages;
  int b, cs, x, out, vec, bars, bytes;
};

inline Layout make_layout(int xpan, int npan, int stages) {
  Layout t;
  t.npan = npan;
  t.xpan = xpan;
  t.stages = stages;
  t.b = 0;
  t.cs = npan * kPanel;
  t.x = t.cs + (npan * kPanel > kS ? npan * kPanel : kS);
  t.out = t.x + stages * xpan * kPanel;
  t.vec = t.out + kConsumers * kOut;
  t.bars = t.vec + kConsumers * 2 * kVec;
  t.bytes = t.bars + 16 * stages + 24;
  return t;
}

// The layout a launch takes (kernels/ssd_scan/kernel.py, tc_smem_bytes):
// the most x stages, up to four, that fit with 1024 bytes of slack to
// align the tiles.  False when none fits.
inline bool choose_layout(int xpan, int npan, Layout* t) {
  for (int stages = 4; stages >= 1; --stages) {
    *t = make_layout(xpan, npan, stages);
    if (1024 + t->bytes <= kMaxSmem) return true;
  }
  return false;
}

struct Params {
  const float* dtc;
  const float* cum;
  int Nc, L, H, P, G, N, rep, hb, n_items;
  Layout lay;
  unsigned int* next_item;
};

// Work item w: up to hb heads h0 .. h0 + nh - 1 of group g of chunk c of
// batch row b; the items of one chunk are neighbours, so the blocks busy at
// one time read the same B and C, which L2 holds once for all.
struct Item {
  int b, c, g, h0, nh;
  __device__ __forceinline__ Item(int w, int Nc, int G, int rep, int hb) {
    const int nhb = (rep + hb - 1) / hb;  // head blocks of a group
    const int bc = w / (G * nhb), r = w - bc * G * nhb;
    g = r / nhb;
    const int k = r - g * nhb;
    b = bc / Nc;
    c = bc - b * Nc;
    h0 = g * rep + k * hb;
    nh = min(hb, rep - k * hb);
  }
};

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ int ld_shared(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t full(uint32_t bar, int st) { return bar + 8 * st; }
__device__ __forceinline__ uint32_t empty(uint32_t bar, int stages, int st) {
  return bar + 8 * (stages + st);
}

// Consumer warpgroup wg: every head of an item whose place among the
// block's heads is wg modulo kConsumers, all of it: W, y = W x and the
// state for rows 0 .. 127 of the chunk.  The warpgroups take turns head by
// head, so that one's CUDA-core work (W, its split, the state's A, the
// staging) runs while the others' products are on the tensor cores.  At an
// item's start warpgroups 0 and 1 compute a row tile of S = C B^T each (0:
// rows 0 .. 63 and keys 0 .. 63, 1: rows 64 .. 127 and keys 0 .. 127) and
// write S over C in shared memory, each thread its accumulators as float4s
// [n8 block][thread], where the thread of the same rank in any warpgroup
// reads them back.  A thread holds rows 64 r + 16 wl + g and + 8 of row
// tile r.
template <int PMAX, int NP>
__device__ __forceinline__ void consume(const Params& q, const CUtensorMap* tmy,
                                        const CUtensorMap* tms, uint32_t base_s,
                                        unsigned char* base, int wg) {
  constexpr int XPAN = PMAX / 64;  // 64-column panels of x and y, p tiles of the state
  const Layout& t = q.lay;
  const int tid = threadIdx.x % 128, wl = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const uint32_t b_s = base_s + t.b, cs_s = base_s + t.cs, x_s = base_s + t.x;
  const float4* s_tile[2] = {reinterpret_cast<const float4*>(base + t.cs) + tid,
                             reinterpret_cast<const float4*>(base + t.cs + kS0) + tid};
  const uint32_t out_s = base_s + t.out + wg * kOut;
  const uint32_t bar = base_s + t.bars;
  const uint32_t item_full = bar + 16 * t.stages, item_empty = item_full + 8;
  const uint32_t item_word = item_full + 16;
  float* vec = reinterpret_cast<float*>(base + t.vec + wg * 2 * kVec);
  const int r0 = 16 * wl + g;          // this thread's first row of a 64-row tile
  const bool in = tid < q.L;           // this thread's position of dt and cum
  const bool tile1 = q.L > 64;         // row tile 1 holds positions (else W, y and x are 0 there)
  int pos = 0;                         // the block's heads before this item (the ring's position)
  int mine = 0;                        // this warpgroup's heads so far

  // the staging buffer, once the store that last read it has read it
  auto stage_begin = [&]() {
    if (tid == 0) tma_store_wait_read();
    named_sync(1 + wg, 128);
    return out_s;
  };
  auto stage_end = [&]() {
    fence_proxy_async();
    named_sync(1 + wg, 128);
  };

#ifdef SSD_PHASE_CLOCKS
  PhaseClocks clocks;
  clocks.begin();
#endif
  for (int n = 0;; ++n) {
    mbar_wait(item_full, n & 1);
    const int w = ld_shared(item_word);
    if (w < 0) break;
    const Item it(w, q.Nc, q.G, q.rep, q.hb);
    const int64_t bc = static_cast<int64_t>(it.b) * q.Nc + it.c;
    // position tid's dt and cum, and the chunk's last cum, of a head
    const float* dtp = q.dtc + (bc * q.L + (in ? tid : 0)) * q.H;
    const float* cup = q.cum + (bc * q.L + (in ? tid : 0)) * q.H;
    const float* lastp = q.cum + (bc * q.L + q.L - 1) * q.H;
    // this warpgroup's first head of the item
    const int first = (wg - pos % kConsumers + kConsumers) % kConsumers;
    float dt_n = 0.f, cu_n = 0.f, cl_n = 0.f;
    if (first < it.nh) {
      dt_n = in ? __ldg(dtp + it.h0 + first) : 0.f;
      cu_n = in ? __ldg(cup + it.h0 + first) : 0.f;
      cl_n = __ldg(lastp + it.h0 + first);
    }
    SSD_PHASE(mark(0));

    // S = C B^T, C and B both K-major (k16 steps 32 bytes along the rows),
    // this warpgroup's row tile; then, once both tiles have read C, over C
    auto s_tile_compute = [&](auto keys) {
      constexpr int KEYS = decltype(keys)::value;
      constexpr int RT = KEYS / 64 - 1;
      float s[KEYS / 2];
      wgmma_fence();
      wgmma_ss<KEYS, false>(s, sw128_desc(cs_s + 64 * RT * kRow, 16, 1024),
                            sw128_desc(b_s, 16, 1024));
      for (int k = 1; k < 4 * t.npan; ++k) {
        const int off = (k / 4) * kPanel + (k % 4) * 32;
        wgmma_ss<KEYS, true>(s, sw128_desc(cs_s + off + 64 * RT * kRow, 16, 1024),
                             sw128_desc(b_s + off, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      named_sync(1 + kConsumers, 128 * kConsumers);
      float4* dst = reinterpret_cast<float4*>(base + t.cs + RT * kS0) + tid;
#pragma unroll
      for (int c = 0; c < KEYS / 8; ++c)
        dst[128 * c] = make_float4(s[4 * c], s[4 * c + 1], s[4 * c + 2], s[4 * c + 3]);
    };
    if (wg == 0)
      s_tile_compute(std::integral_constant<int, 64>());
    else if (wg == 1 && tile1)
      s_tile_compute(std::integral_constant<int, 128>());
    else
      named_sync(1 + kConsumers, 128 * kConsumers);
    named_sync(1 + kConsumers, 128 * kConsumers);
    SSD_PHASE(mark(1));

    for (int hh = first; hh < it.nh; hh += kConsumers, ++mine) {
      const int h = it.h0 + hh;
      // head hh's ring stage (the heads in between are the other warpgroup's)
      const int st = (pos + hh) % t.stages, phase = ((pos + hh) / t.stages) & 1;
      SSD_PHASE(head());
      // the head's vectors: cum log2(e), dt, and dec = exp(cum_last - cum) dt
      // (0 past L, where exp may overflow); the next head's loads go out
      float* v = vec + (mine & 1) * (3 * kRows);
      v[tid] = cu_n * kLog2e;
      v[kRows + tid] = dt_n;
      v[2 * kRows + tid] = in ? expf(cl_n - cu_n) * dt_n : 0.f;
      if (hh + kConsumers < it.nh) {
        dt_n = in ? __ldg(dtp + h + kConsumers) : 0.f;
        cu_n = in ? __ldg(cup + h + kConsumers) : 0.f;
        cl_n = __ldg(lastp + h + kConsumers);
      }
      SSD_PHASE(mark(6));
      named_sync(1 + wg, 128);
      SSD_PHASE(mark(7));
      mbar_wait(full(bar, st), phase);
      SSD_PHASE(mark(0));
      const uint32_t xt = x_s + st * XPAN * kPanel;

      // W = S exp(cum_i - cum_j) dt_j, j <= i, of row tile RT as bf16 hi +
      // lo A fragments of the k16 steps (n8 blocks 2 kj and 2 kj + 1); steps
      // past this warp's diagonal are 0, and only the diagonal step is
      // masked: above the diagonal the exponent may overflow, and inf * 0
      // would be NaN
      auto weights = [&](auto keys, auto k0, uint32_t(&wh)[4][4], uint32_t(&wlo)[4][4]) {
        constexpr int KEYS = decltype(keys)::value, K0 = decltype(k0)::value;
        constexpr int RT = KEYS / 64 - 1;
        const int i0 = 64 * RT + r0, i1 = i0 + 8, diag = 4 * RT + wl;
        const float c2i0 = v[i0], c2i1 = v[i1];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int kj = K0 + kk;
          if (kj > diag) {
#pragma unroll
            for (int r = 0; r < 4; ++r) wh[kk][r] = wlo[kk][r] = 0u;
            continue;
          }
          float e[8];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int c = 2 * kj + hf, j = 8 * c + 2 * tq;
            const float4 sv = s_tile[RT][128 * c];
            const float2 cj = *reinterpret_cast<const float2*>(v + j);
            const float2 dj = *reinterpret_cast<const float2*>(v + kRows + j);
            float w0 = sv.x * ex2(c2i0 - cj.x) * dj.x;
            float w1 = sv.y * ex2(c2i0 - cj.y) * dj.y;
            float w2 = sv.z * ex2(c2i1 - cj.x) * dj.x;
            float w3 = sv.w * ex2(c2i1 - cj.y) * dj.y;
            if (kj == diag) {
              w0 = j <= i0 ? w0 : 0.f;
              w1 = j + 1 <= i0 ? w1 : 0.f;
              w2 = j <= i1 ? w2 : 0.f;
              w3 = j + 1 <= i1 ? w3 : 0.f;
            }
            e[4 * hf] = w0;
            e[4 * hf + 1] = w1;
            e[4 * hf + 2] = w2;
            e[4 * hf + 3] = w3;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            wh[kk][r] = split(e[2 * r], e[2 * r + 1]);
            wlo[kk][r] = pack(e[2 * r], e[2 * r + 1]);
          }
        }
      };
      // y += W x: x MN-major (k16 steps 16 rows on, the second 64-column
      // panel the leading byte offset away), lo then hi a step
      // y += W x for the 64 columns of x panel p: x MN-major (k16 steps 16
      // rows on), lo then hi a step
      auto wx_issue = [&](int p, auto k0, float(&y)[32], uint32_t(&wh)[4][4],
                          uint32_t(&wlo)[4][4]) {
        constexpr int K0 = decltype(k0)::value;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dx = sw128_desc(xt + p * kPanel + (K0 + kk) * 16 * kRow, kPanel, 1024);
          if (K0 + kk == 0)
            wgmma_rs<64, false>(y, wlo[kk], dx);
          else
            wgmma_rs<64, true>(y, wlo[kk], dx);
          wgmma_rs<64, true>(y, wh[kk], dx);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(y);
        fence_regs(wh);
        fence_regs(wlo);
      };
      // y of row tile rt and panel p in bf16 into a staging buffer,
      // swizzled as TMA reads it, then one TMA store (rows past L are not
      // written)
      auto y_store = [&](int rt, int p, float(&y)[32]) {
        const uint32_t o = stage_begin();
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint32_t row = o + r0 * kRow + 4 * tq;
          const uint32_t chunk = (c ^ g) * 16;
          st_shared(row + chunk, pack(y[4 * c], y[4 * c + 1]));
          st_shared(row + 8 * kRow + chunk, pack(y[4 * c + 2], y[4 * c + 3]));
        }
        stage_end();
        if (tid == 0) {
          if (64 * p < q.P && 64 * rt < q.L) tma_store_5d(tmy, o, 64 * p, h, 64 * rt, it.c, it.b);
          tma_store_commit();
        }
      };

      // row tile 0 (4 k16 steps), then row tile 1 (8, in two halves), a
      // 64-column panel of y at a time (W formed again for the second)
#pragma unroll
      for (int p = 0; p < XPAN; ++p) {
        using std::integral_constant;
        uint32_t wh[4][4], wlo[4][4];
        float y[32];
        weights(integral_constant<int, 64>(), integral_constant<int, 0>(), wh, wlo);
        SSD_PHASE(mark(2));
        wx_issue(p, integral_constant<int, 0>(), y, wh, wlo);
        SSD_PHASE(mark(3));
        y_store(0, p, y);
        SSD_PHASE(mark(5));
        if (tile1) {
          weights(integral_constant<int, 128>(), integral_constant<int, 0>(), wh, wlo);
          SSD_PHASE(mark(2));
          wx_issue(p, integral_constant<int, 0>(), y, wh, wlo);
          SSD_PHASE(mark(3));
          weights(integral_constant<int, 128>(), integral_constant<int, 4>(), wh, wlo);
          SSD_PHASE(mark(2));
          wx_issue(p, integral_constant<int, 4>(), y, wh, wlo);
          SSD_PHASE(mark(3));
          y_store(1, p, y);
          SSD_PHASE(mark(5));
        }
      }

      // the state of p tile pt: A = (x dec)^T for p rows 64 pt + 16 wl ..,
      // x read transposed from its swizzled tile, split into bf16 hi + mid
      // + lo; then state[p, n] = sum_j A[p, j] B[j, n], 64 columns n at a
      // time (B MN-major, k16 steps 16 rows on), lo, mid, then hi a step
      const float* dec = v + 2 * kRows;
#pragma unroll
      for (int pt = 0; pt < XPAN; ++pt) {
        for (int nc0 = 0; nc0 < t.npan; nc0 += NP) {
          float acc[NP][32];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (half == 1 && !tile1) break;  // rows 64 .. 127 of x are zeros
            uint32_t ah[4][4], am[4][4], al[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int kj = 4 * half + kk;
              const int j = 16 * kj + (lane & 7) + 8 * (lane >> 4);
              const int chunk = 2 * wl + ((lane >> 3) & 1);
              uint32_t xa[4];
              ldmatrix_x4_trans(xa, xt + pt * kPanel + j * kRow + ((chunk ^ (j & 7)) << 4));
              const float2 d0 = *reinterpret_cast<const float2*>(dec + 16 * kj + 2 * tq);
              const float2 d8 = *reinterpret_cast<const float2*>(dec + 16 * kj + 2 * tq + 8);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 xv = unpack(xa[e]);
                float a0 = xv.x * (e < 2 ? d0.x : d8.x), a1 = xv.y * (e < 2 ? d0.y : d8.y);
                ah[kk][e] = split(a0, a1);
                am[kk][e] = split(a0, a1);
                al[kk][e] = pack(a0, a1);
              }
            }
            // x has been read for the last time: the stage may take the next tile
            if ((half == 1 || !tile1) && pt == XPAN - 1 && nc0 + NP >= t.npan && lane == 0)
              mbar_arrive(empty(bar, t.stages, st));
            wgmma_fence();
#pragma unroll
            for (int m = 0; m < NP; ++m)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const uint64_t db = sw128_desc(
                    b_s + (nc0 + m) * kPanel + (4 * half + kk) * 16 * kRow, kPanel, 1024);
                if (half == 0 && kk == 0)
                  wgmma_rs<64, false>(acc[m], al[kk], db);
                else
                  wgmma_rs<64, true>(acc[m], al[kk], db);
                wgmma_rs<64, true>(acc[m], am[kk], db);
                wgmma_rs<64, true>(acc[m], ah[kk], db);
              }
            wgmma_commit();
            wgmma_wait<0>();
#pragma unroll
            for (int m = 0; m < NP; ++m) fence_regs(acc[m]);
            fence_regs(ah);
            fence_regs(am);
            fence_regs(al);
          }
          SSD_PHASE(mark(4));
          // f32 [64 p][64 n] as two swizzled 32-column panels, then one
          // TMA store each: whole rows of the head's [P, N] state
#pragma unroll
          for (int m = 0; m < NP; ++m) {
            const int nc = nc0 + m;
            const uint32_t o = stage_begin();
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const uint32_t row = o + (c / 4) * kHalf + r0 * kRow + 8 * (tq % 2);
              const uint32_t chunk = ((2 * (c % 4) + tq / 2) ^ g) << 4;
              st_shared2(row + chunk, acc[m][4 * c], acc[m][4 * c + 1]);
              st_shared2(row + 8 * kRow + chunk, acc[m][4 * c + 2], acc[m][4 * c + 3]);
            }
            stage_end();
            if (tid == 0) {
              const int tile = static_cast<int>(bc * q.H + h);
#pragma unroll
              for (int half = 0; half < 2; ++half)
                if (64 * nc + 32 * half < q.N)
                  tma_store_3d(tms, o + half * kHalf, 64 * nc + 32 * half, 64 * pt, tile);
              tma_store_commit();
            }
            SSD_PHASE(mark(5));
          }
        }
      }
    }
    pos += it.nh;
    // B and S have been read for the last time this item; S's generic
    // writes come before the copy of the next item's C over it
    fence_proxy_async();
    if (lane == 0) mbar_arrive(item_empty);
  }
  // the last stores have read their buffers before the block's shared memory goes
  if (tid == 0) tma_store_wait_read();
#ifdef SSD_PHASE_CLOCKS
  if (lane == 0)
    for (int k = 0; k < kPhases; ++k) atomicAdd(&g_phase_clocks[wg][k], clocks.sum[k]);
#endif
}

template <int PMAX, int NP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_tc_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmb,
              const __grid_constant__ CUtensorMap tmc, const __grid_constant__ CUtensorMap tmy,
              const __grid_constant__ CUtensorMap tms, const __grid_constant__ Params q) {
  constexpr int XPAN = PMAX / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base_s = smem_addr(base);
  const Layout& t = q.lay;
  const uint32_t bar = base_s + t.bars;
  const uint32_t item_full = bar + 16 * t.stages, item_empty = item_full + 8;
  const uint32_t item_word = item_full + 16;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < t.stages; ++st) {
      mbar_init(full(bar, st), 1);
      mbar_init(empty(bar, t.stages, st), 4);  // lane 0 of the head's warpgroup's warps
    }
    mbar_init(item_full, 1);
    mbar_init(item_empty, 4 * kConsumers);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // producer: one thread issues every copy, item after item; the ring's
    // stage and phase run on across items
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int st = 0, phase = 0, w = blockIdx.x;
      auto load_x = [&](const Item& it, int hh) {
        // the stage's previous tile released by every consumer warp
        mbar_wait(empty(bar, t.stages, st), phase ^ 1);
        const uint32_t xt = base_s + t.x + st * XPAN * kPanel;
        mbar_arrive_expect_tx(full(bar, st), XPAN * kPanel);
#pragma unroll
        for (int p = 0; p < XPAN; ++p)
          tma_load_5d(xt + p * kPanel, &tmx, full(bar, st), 64 * p, it.h0 + hh, 0, it.c, it.b);
        if (++st == t.stages) {
          st = 0;
          phase ^= 1;
        }
      };
      for (int n = 0;; ++n) {
        if (w >= q.n_items) {
          // item n - 1's B and C released, then -1 ends the consumers
          if (n > 0) mbar_wait(item_empty, (n - 1) & 1);
          st_shared(item_word, static_cast<uint32_t>(-1));
          mbar_arrive(item_full);
          break;
        }
        const Item it(w, q.Nc, q.G, q.rep, q.hb);
        const int next = take_item(q.next_item, q.n_items);
        // the item's first x tiles go out while the previous item's last
        // heads are computed, then its B and C once they are free
        const int pre = min(it.nh, t.stages);
        for (int hh = 0; hh < pre; ++hh) load_x(it, hh);
        if (n > 0) mbar_wait(item_empty, (n - 1) & 1);
        st_shared(item_word, static_cast<uint32_t>(w));
        mbar_arrive_expect_tx(item_full, 2 * t.npan * kPanel);
        for (int p = 0; p < t.npan; ++p) {
          tma_load_5d(base_s + t.b + p * kPanel, &tmb, item_full, 64 * p, it.g, 0, it.c, it.b);
          tma_load_5d(base_s + t.cs + p * kPanel, &tmc, item_full, 64 * p, it.g, 0, it.c, it.b);
        }
        for (int hh = pre; hh < it.nh; ++hh) load_x(it, hh);
        w = next;
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<PMAX, NP>(q, &tmy, &tms, base_s, base, warp / 4 - 1);
  }
}

// PMAX: the widest P the instance takes; NP: blocks of 64 state columns
// that share one build of the state's A (2 at P <= 64 where N / 64 rounded
// up is even; at P = 128 the registers allow one)
template <int PMAX, int NP>
int launch(const void* xc, const float* dtc, const float* cum, const void* bc,
           const void* cc, void* y, float* state, int B, int Nc, int L, int H, int P,
           int G, int N, cudaStream_t s) {
  Params q;
  if (!choose_layout(PMAX / 64, (N + 63) / 64, &q.lay))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rep = H / G;
  if (static_cast<int64_t>(B) * Nc * H > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mb, mc, my, ms;
  if (!bf16_chunk_map(&mx, xc, B, Nc, L, H, P, kRows) ||
      !bf16_chunk_map(&mb, bc, B, Nc, L, G, N, kRows) ||
      !bf16_chunk_map(&mc, cc, B, Nc, L, G, N, kRows) ||
      !bf16_chunk_map(&my, y, B, Nc, L, H, P, 64) ||
      !f32_tile_map(&ms, state, B * Nc * H, P, N, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  q.dtc = dtc;
  q.cum = cum;
  q.Nc = Nc;
  q.L = L;
  q.H = H;
  q.P = P;
  q.G = G;
  q.N = N;
  q.rep = rep;
  const int bytes = 1024 + q.lay.bytes;
  PersistentLaunch pl;
  const cudaError_t err = persistent_launch(ssd_tc_kernel<PMAX, NP>, bytes, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Heads a work item: the most (up to kMaxHeads) that still leave an item
  // for every SM, so that B and C are copied and S computed as seldom as
  // the card's width allows.
  q.hb = kMaxHeads;
  while (q.hb > 1 && static_cast<int64_t>(B) * Nc * G * ((rep + q.hb - 1) / q.hb) < pl.sms)
    q.hb /= 2;
  const int64_t n_items = static_cast<int64_t>(B) * Nc * G * ((rep + q.hb - 1) / q.hb);
  if (n_items > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  q.n_items = static_cast<int>(n_items);
  q.next_item = pl.next_item;
  const int grid = static_cast<int>(n_items < pl.sms ? n_items : pl.sms);
  ssd_tc_kernel<PMAX, NP><<<grid, kThreads, bytes, s>>>(mx, mb, mc, my, ms, q);
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
    if (P > 64) return tc::launch<128, 1>(xc, dtc, cum, bc, cc, y, state, B, Nc, L, H, P, G, N, s);
    if ((N + 63) / 64 % 2 == 0)
      return tc::launch<64, 2>(xc, dtc, cum, bc, cc, y, state, B, Nc, L, H, P, G, N, s);
    return tc::launch<64, 1>(xc, dtc, cum, bc, cc, y, state, B, Nc, L, H, P, G, N, s);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch<float>(xc, dtc, cum, bc, cc, y, state, B, Nc, L, H, P, G, N, s);
    case 1:
      return launch<__nv_bfloat16>(xc, dtc, cum, bc, cc, y, state, B, Nc, L, H, P, G, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef SSD_PHASE_CLOCKS
// Instrumented builds only: copies the phase clocks summed since the last
// call into out[3][9] (by consumer warpgroup, see tc::PhaseClocks) and
// zeroes them.
extern "C" int ssd_phase_clocks(unsigned long long* out) {
  static const unsigned long long zero[tc::kConsumers * tc::kPhases] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, tc::g_phase_clocks, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(tc::g_phase_clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
