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
// peak (989 TFLOP/s: 2,048 multiply-adds a clock an SM).  But every score
// also takes an exponential on the special-function unit (16 a clock an
// SM) and some eight other f32 operations (scale, max, sum, the split of P
// below) from the same four instruction issuers: at D = 64 the 64 + 128
// tensor-core multiply-adds of a score (S, then the two P V products) take
// about as long as its exponential and its dozen issued instructions, at
// D = 128 (128 + 256) twice as long.  Two variants, chosen by the caller
// from the type and D alone (kernels/flash_attention/kernel.py,
// flash_variant):
//
// tensor_cores (bf16, D in {64, 128}): Hopper's own instructions, in a
// persistent grid of one block an SM.  A block has three warpgroups.
// Warpgroup 0 is the producer: it gives up registers (setmaxnreg 32) and
// one of its threads copies, for each work item the block takes (128 query
// rows of one batch row and head), the q tile into one of two q buffers and
// then every K and V tile of the item's causal / window band (128 keys at
// D = 64, 64 at D = 128) into a ring of four stages, all by TMA
// (cp.async.bulk.tensor on 4-D tensor maps [D, heads, S, B] built for each
// call, so the hardware computes the 64-bit addresses and zero-fills
// positions past S).  Each stage has a "full" mbarrier that counts the
// copies' bytes and an "empty" one that counts the consumer warps'
// releases; each q buffer a full and an empty one; the ring's stage and
// phase run on from item to item.  Items are numbered heaviest query tile
// first within groups of eight query heads (Item, below): the blocks busy
// at one time read the same K / V tiles, which L2 holds once for all, and
// a block takes its next item from a counter of the launch, so the last
// items to start are the lightest.
//   Warpgroups 1 and 2 are consumers (setmaxnreg 232), 64 query rows each:
// for every tile, S = q K^T by wgmma.mma_async (m64nBKk16) with q and K
// read from shared memory (both K-major, 128-byte swizzle as TMA wrote
// them, the descriptors' swizzle mode the same), the online softmax on the
// accumulators, then O += P V by wgmma with P from registers (the
// accumulators' layout is the A fragment's) and V read from shared memory
// as an MN-major operand (the transpose bit; V needs no transposed copy).
// A warpgroup issues the next tile's S with this tile's P V, runs the next
// tile's softmax while P V is on the tensor cores, and releases the stage
// when wgmma.wait_group says its P V has landed.  The two warpgroups take
// turns at the tensor cores (named barriers), so that one's softmax runs
// while the other's products do.  The output is written back through the
// warpgroup's rows of the q buffer by a TMA store, which leaves rows past S
// unwritten; the buffer goes back to the producer once the store has read
// it, during the next item.
//   Measured on the card (tools/flash_phases.py, PERF.md): at D = 64 a
// warpgroup spends some 700-960 clocks a 128-key tile issuing its products
// (wgmma does not return until the tensor cores take its last steps),
// 1,400-1,550 in the softmax and 440-590 splitting P: the CUDA-core steps
// pace the loop, and the tensor cores work about half the time.  Three
// consumer warpgroups on 64-key tiles (160 registers each), P split inside
// the products' issue, and a split by truncation were each no faster.
//   A warpgroup skips a tile wholly above its diagonal or before its window
// (it still waits for and releases the stage) and masks only tiles that
// cross either: a masked score is -inf, its weight exactly 0, where the
// Pallas kernel's NEG_INF gives weights that a later rescale zeroes: the
// same sums.  Scores stay unscaled: p = 2^(s c - m c), c = scale * log2 e,
// one FFMA and one ex2 a score; a row's max and sum meet across the 4 lanes
// that hold it.
//   Why P takes the form it takes: rounding P to one bf16 would cost up to
// 2^-9 of each weight, some 20 bf16 ulps of the output's floored scale at
// S = 512 to 2048 (tests/test_torch_kernels.py, the rounding model); fp16
// holds 3 more bits and still misses by more than 2 ulps there, and would
// need V in fp16, whose range a bf16 V exceeds.  So P is split into bf16 hi + lo and P V takes two
// register-A products with the same V descriptor (about 2^-18 of each
// weight; 1.5x the products' operations).  The tensor cores' f32
// accumulation truncates what falls below the largest addend's exponent, so
// an O accumulator that took all S / 16 products drifted with S (1.65
// floored bf16 ulps at S = 32,768 against the rounding's 0.5): each
// tile's products start from zero (scale-d 0) and meet O, rescaled, in one
// f32 FMA that rounds to nearest (tools/flash_accuracy.py).
//   Registers: a consumer thread holds 2 rows' share of O (D / 2 floats),
// of one tile's P V (D / 2) and of its scores (BK / 2), which become P's
// BK / 4 hi and lo registers: 192 at either D, under 232 with no spills.
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_sm90.cuh"
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

using namespace hopper;
using mma_bf16::ex2;
using mma_bf16::pack;
using mma_bf16::smem_addr;
using mma_bf16::split;

constexpr int kConsumers = 2;                      // warpgroups of 64 query rows
constexpr int kThreads = 128 * (1 + kConsumers);    // the producer warpgroup first
constexpr int BQ = 64 * kConsumers;                // query rows of a work item
constexpr int kProducerRegs = 32;                  // a producer thread's registers
constexpr int kConsumerRegs = 232;                 // a consumer thread's
constexpr int kRow = 128;         // bytes of a swizzled row: 64 bf16
constexpr int kStages = 4;        // K / V tiles in flight
constexpr int kGroupHeads = 8;    // query heads of a group of work items (see Item)
// the registers a block is launched with (168 a thread) are shared out anew
// by setmaxnreg: the producer gives up what the consumers take
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <=
                  65536 / kThreads / 8 * 8 * kThreads,
              "the registers of one block an SM");

#ifdef FLASH_PHASE_CLOCKS
// Instrumented builds only (tools/flash_phases.py): the clocks a consumer
// warp spends in each step of the main loop, summed over the launch's warps
// by warpgroup: 0 the tile's copy, 1 the turn, 2 issuing S and P V, 3 S,
// 4 the softmax, 5 P V and the sum into O, 6 the split of P; 7 the tiles.
constexpr int kPhases = 8;
__device__ unsigned long long g_phase_clocks[kConsumers][kPhases];
struct PhaseClocks {
  unsigned long long sum[kPhases] = {};
  unsigned int last = 0;
  __device__ __forceinline__ void start() {
    last = clock();
    ++sum[kPhases - 1];
  }
  __device__ __forceinline__ void mark(int k) {
    const unsigned int now = clock();
    sum[k] += now - last;
    last = now;
  }
};
#define FLASH_PHASE(call) clocks.call
#else
#define FLASH_PHASE(call)
#endif

template <int D>
struct Shape {
  // keys of a K / V tile: a consumer thread holds O and one tile's P V
  // (D / 2 floats each), P of one tile as hi + lo (BK / 4 registers) and the
  // next tile's scores (BK / 2): 192 registers at either D
  static constexpr int BK = D == 64 ? 128 : 64;
  static constexpr int PANELS = D / 64;             // 64-column panels of a row
  static constexpr int STAGES = kStages;
  static constexpr int Q_PANEL = BQ * kRow;         // bytes of a q panel
  static constexpr int Q_BYTES = PANELS * Q_PANEL;  // a q tile; two, for two work items
  static constexpr int KV_PANEL = BK * kRow;        // bytes of a K or V panel
  static constexpr int TILE = PANELS * KV_PANEL;    // a K or V tile
  static constexpr int STAGE = 2 * TILE;            // K then V
  // full[], empty[], q_full[2], q_empty[2], then the two q tiles' work items
  static constexpr int BARS = 8 * (2 * STAGES + 4) + 8;
  // 1024 bytes of slack to align the tiles to the swizzle's atoms
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * STAGE + BARS;
  static_assert(SMEM <= 232448, "a block's shared memory");
};

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_shared(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Work item w of a launch: BQ query rows of one (batch row, head).  The items
// come in groups of query heads that read a few K / V heads (kGroupHeads, or
// one K / V head's heads, of one batch row), within a group the heaviest
// query tiles first: the blocks busy at one time read the same K / V tiles,
// which L2 then holds once for all of them, and the last items to start are
// the lightest.  The item's K / V tiles are [k_begin, k_begin + n_tiles BK),
// the causal / window band of its rows.
template <int BK, bool kWindow>
struct Item {
  int q_lo, h, b, k_begin, n_tiles;
  __device__ __forceinline__ Item(int w, int S, int H, int KV, int B, int window) {
    const int n_qt = (S + BQ - 1) / BQ, rep = H / KV;
    const int gkv = max(1, kGroupHeads / rep);   // K / V heads of a full group
    const int group = w / (n_qt * rep * gkv);
    const int g0 = group * gkv, gsize = min(gkv, B * KV - g0);
    const int r = w - group * n_qt * rep * gkv;  // within the group
    const int c = r % (gsize * rep);
    const int kvb = g0 + c / rep;                // batch row and K / V head
    q_lo = (n_qt - 1 - r / (gsize * rep)) * BQ;
    b = kvb / KV;
    h = (kvb % KV) * rep + c % rep;
    const int k_end = min(S, q_lo + BQ);  // keys past the tile's last row are masked
    k_begin = kWindow ? max(0, q_lo - window + 1) : 0;
    k_begin -= k_begin % BK;
    n_tiles = (k_end - k_begin + BK - 1) / BK;
  }
  // the item's tiles [lo, hi) that reach the 64 rows from `first`: none
  // wholly before their window, none wholly above their diagonal (at least
  // one, for rows past S that no tile reaches)
  __device__ __forceinline__ void rows_tiles(int first, int window, int& lo, int& hi) const {
    hi = min(n_tiles, (first + 63 - k_begin) / BK + 1);
    lo = kWindow ? min(max(0, (first - window + 1 - k_begin) / BK), hi - 1) : 0;
  }
};

template <int D, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                int S, int H, int KV, int B, int window, float scale_log2,
                unsigned int* next_item) {
  using Sh = Shape<D>;
  constexpr int BK = Sh::BK, STAGES = Sh::STAGES;
  using It = Item<BK, kWindow>;
  extern __shared__ unsigned char smem_raw[];
  // two q tiles (work items n and n + 1 of this block; each also takes its
  // item's output), then the ring's stages, then the barriers
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + 2 * Sh::Q_BYTES;  // stage st at kv_s + st STAGE
  const uint32_t bar_s = kv_s + STAGES * Sh::STAGE;
  auto full = [&](int st) { return bar_s + 8 * st; };
  auto empty = [&](int st) { return bar_s + 8 * (STAGES + st); };
  auto q_full = [&](int buf) { return bar_s + 8 * (2 * STAGES + buf); };
  auto q_empty = [&](int buf) { return bar_s + 8 * (2 * STAGES + 2 + buf); };
  auto item_of = [&](int buf) { return bar_s + 8 * (2 * STAGES + 4) + 4 * buf; };
  const int n_items = (S + BQ - 1) / BQ * H * B;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * kConsumers);  // lane 0 of every consumer warp
    }
#pragma unroll
    for (int buf = 0; buf < 2; ++buf) {
      mbar_init(q_full(buf), 1);
      mbar_init(q_empty(buf), kConsumers);  // one thread of each consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // producer: one thread issues every copy, item after item; the ring's
    // stage and phase run on across items
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      // the first item is the block's own, each later one taken from the
      // launch's count when the previous one starts; -1 ends the consumers
      int st = 0, phase = 0, w = blockIdx.x;
      for (int n = 0;; ++n) {
        const int buf = n & 1;
        // q tile buf, once every warpgroup has stored item n - 2's output from it
        if (n >= 2) mbar_wait(q_empty(buf), ((n >> 1) - 1) & 1);
        if (w >= n_items) {
          st_shared(item_of(buf), static_cast<uint32_t>(-1));
          mbar_arrive(q_full(buf));
          break;
        }
        st_shared(item_of(buf), static_cast<uint32_t>(w));
        const It item(w, S, H, KV, B, window);
        w = take_item(next_item, n_items);
        const uint32_t qt = q_s + buf * Sh::Q_BYTES;
        mbar_arrive_expect_tx(q_full(buf), Sh::Q_BYTES);
#pragma unroll
        for (int wg = 0; wg < kConsumers; ++wg)
#pragma unroll
          for (int p = 0; p < Sh::PANELS; ++p)
            tma_load_4d(qt + p * Sh::Q_PANEL + wg * 64 * kRow, &tq, q_full(buf), 64 * p, item.h,
                        item.q_lo + 64 * wg, item.b);
        const int kvh = item.h / (H / KV);
        for (int it = 0; it < item.n_tiles; ++it) {
          // the stage's previous tile released by every consumer warp
          mbar_wait(empty(st), phase ^ 1);
          const int j0 = item.k_begin + it * BK;
          const uint32_t kt = kv_s + st * Sh::STAGE;
          mbar_arrive_expect_tx(full(st), Sh::STAGE);
#pragma unroll
          for (int p = 0; p < Sh::PANELS; ++p) {
            tma_load_4d(kt + p * Sh::KV_PANEL, &tk, full(st), 64 * p, kvh, j0, item.b);
            tma_load_4d(kt + Sh::TILE + p * Sh::KV_PANEL, &tv, full(st), 64 * p, kvh, j0,
                        item.b);
          }
          if (++st == STAGES) {
            st = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q_lo + 64 wg .. + 63 of each item
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4 - 1, wl = warp % 4;
    const int g = lane / 4, t = lane % 4;
    const float minus_inf = -__int_as_float(0x7f800000);
    int st = 0, phase = 0;
    auto next = [&]() {
      if (++st == STAGES) {
        st = 0;
        phase ^= 1;
      }
    };
    // The two warpgroups take turns at the tensor cores, 0 first: warpgroup
    // w waits at named barrier 3 + w for its turn, issues its next S and its
    // P V, and gives the turn to the other, whose softmax ran meanwhile.
    // Both take as many turns an item: the one with fewer tiles passes its
    // last turns idle.
    const uint32_t my_turn = 3 + wg, next_turn = 4 - wg;
    if (wg == 1) named_arrive(3, 256);

#ifdef FLASH_PHASE_CLOCKS
    PhaseClocks clocks;
#endif
    for (int n = 0;; ++n) {
      const int buf = n & 1;
      mbar_wait(q_full(buf), (n >> 1) & 1);
      const int w = ld_shared(item_of(buf));
      if (w < 0) break;
      const It item(w, S, H, KV, B, window);
      const int row_min = item.q_lo + 64 * wg;
      const int w_min = row_min + 16 * wl, w_max = w_min + 15;  // this warp's rows
      const int i0 = w_min + g, i1 = i0 + 8;                    // this thread's rows
      const uint32_t q_wg = q_s + buf * Sh::Q_BYTES + wg * 64 * kRow;

      float o[D / 2];  // n8 block c: o[4c..4c+1] row i0, o[4c+2..4c+3] row i1
#pragma unroll
      for (int c = 0; c < D / 2; ++c) o[c] = 0.f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

      // S = q K^T of the tile in stage st: D / 16 steps, each 32 bytes
      // further along the rows (a second 64-column panel a panel further)
      auto scores = [&](int st, float(&s)[BK / 2]) {
        const uint32_t kt = kv_s + st * Sh::STAGE;
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const int off = (kd % 4) * 32;
          const uint64_t da = sw128_desc(q_wg + (kd / 4) * Sh::Q_PANEL + off, 16, 1024);
          const uint64_t db = sw128_desc(kt + (kd / 4) * Sh::KV_PANEL + off, 16, 1024);
          if (kd == 0)
            wgmma_ss<BK, false>(s, da, db);
          else
            wgmma_ss<BK, true>(s, da, db);
        }
        wgmma_commit();
      };
      // the online softmax of the tile at k0: the scores become weights
      // p = 2^(s c - m c) in place, a0 / a1 the rescale of rows i0 / i1
      auto softmax = [&](int k0, float(&s)[BK / 2], float& a0, float& a1) {
        // mask only keys that cross the diagonal or the window's edge for
        // some row of this warp
        if (k0 + BK - 1 > w_min || (kWindow && w_max - k0 >= window)) {
#pragma unroll
          for (int c = 0; c < BK / 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? i0 : i1, j = k0 + 8 * c + 2 * t + (e & 1);
              if (j > i || (kWindow && i - j >= window)) s[4 * c + e] = minus_inf;
            }
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * c], s[4 * c + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        // The max starts at NEG_INF (finite), so it stays finite while a row
        // has seen only masked keys, and those keys' weights are exactly 0;
        // the Pallas kernel gives them exp(0) = 1 and rescales them by 0 at
        // the row's first real key, which every row reaches (j = i).
        a0 = ex2((m0 - mx0) * scale_log2);
        a1 = ex2((m1 - mx1) * scale_log2);
        const float mc0 = mx0 * scale_log2, mc1 = mx1 * scale_log2;
        m0 = mx0;
        m1 = mx1;
        l0 *= a0;
        l1 *= a1;
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) {
          s[4 * c] = ex2(fmaf(s[4 * c], scale_log2, -mc0));
          s[4 * c + 1] = ex2(fmaf(s[4 * c + 1], scale_log2, -mc0));
          s[4 * c + 2] = ex2(fmaf(s[4 * c + 2], scale_log2, -mc1));
          s[4 * c + 3] = ex2(fmaf(s[4 * c + 3], scale_log2, -mc1));
          l0 += s[4 * c] + s[4 * c + 1];
          l1 += s[4 * c + 2] + s[4 * c + 3];
        }
      };
      // P = hi + lo, each a bf16 A fragment a 16 keys: n8 blocks 2kj and
      // 2kj + 1 of the weights are the k16 step kj of P
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
      auto split_p = [&](float(&s)[BK / 2]) {
#pragma unroll
        for (int kj = 0; kj < BK / 16; ++kj)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ph[kj][r] = split(s[8 * kj + 2 * r], s[8 * kj + 2 * r + 1]);
            pl[kj][r] = pack(s[8 * kj + 2 * r], s[8 * kj + 2 * r + 1]);
          }
      };

      // this tile's P V from zero (lo then hi a k16 step, V 16 rows = 2048
      // bytes a step, the second 64-column panel a V panel further)
      float pv[D / 2];
      auto pv_issue = [&](int st) {
        const uint32_t vt = kv_s + st * Sh::STAGE + Sh::TILE;
        wgmma_fence();
#pragma unroll
        for (int kj = 0; kj < BK / 16; ++kj) {
          const uint64_t dv = sw128_desc(vt + kj * 16 * kRow, Sh::KV_PANEL, 1024);
          if (kj == 0)
            wgmma_rs<D, false>(pv, pl[kj], dv);
          else
            wgmma_rs<D, true>(pv, pl[kj], dv);
          wgmma_rs<D, true>(pv, ph[kj], dv);
        }
        wgmma_commit();
      };
      // O = a O + P V in one f32 FMA an element (see the header), once P V
      // has landed; then the stage is free
      auto pv_finish = [&](int st, float r0, float r1) {
        wgmma_wait<0>();
        fence_regs(pv);
        fence_regs(ph);
        fence_regs(pl);
        if (lane == 0) mbar_arrive(empty(st));
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          o[4 * c] = fmaf(o[4 * c], r0, pv[4 * c]);
          o[4 * c + 1] = fmaf(o[4 * c + 1], r0, pv[4 * c + 1]);
          o[4 * c + 2] = fmaf(o[4 * c + 2], r1, pv[4 * c + 2]);
          o[4 * c + 3] = fmaf(o[4 * c + 3], r1, pv[4 * c + 3]);
        }
      };

      // this warpgroup's tiles, and the most tiles any warpgroup of the item has
      int t_lo, t_hi, most = 0;
      item.rows_tiles(row_min, window, t_lo, t_hi);
#pragma unroll
      for (int v = 0; v < kConsumers; ++v) {
        int lo, hi;
        item.rows_tiles(item.q_lo + 64 * v, window, lo, hi);
        most = max(most, hi - lo);
      }
      // a tile of the item that this warpgroup skips: wait for it (so that
      // the stage's phases stay in step) and release it
      auto pass = [&]() {
        mbar_wait(full(st), phase);
        if (lane == 0) mbar_arrive(empty(st));
        next();
      };
      for (int it = 0; it < t_lo; ++it) pass();

      mbar_wait(full(st), phase);
      float s[BK / 2];
      scores(st, s);
      // the previous item's output has left q tile buf ^ 1 (its store was
      // issued at that item's end): the producer may load item n + 1's q there
      if (n > 0 && tid % 128 == 0) {
        tma_store_wait_read();
        mbar_arrive(q_empty(buf ^ 1));
      }
      wgmma_wait<0>();
      fence_regs(s);
      float a0, a1;
      softmax(item.k_begin + t_lo * BK, s, a0, a1);
      split_p(s);
      for (int it = t_lo; it + 1 < t_hi; ++it) {
        // the next tile's S, then this tile's P V; the next tile's softmax
        // runs while P V is on the tensor cores
        const int nst = st + 1 == STAGES ? 0 : st + 1;
        const int nphase = nst == 0 ? phase ^ 1 : phase;
        FLASH_PHASE(start());
        mbar_wait(full(nst), nphase);
        FLASH_PHASE(mark(0));
        named_sync(my_turn, 256);
        FLASH_PHASE(mark(1));
        scores(nst, s);
        pv_issue(st);
        named_arrive(next_turn, 256);
        FLASH_PHASE(mark(2));
        float na0, na1;
        wgmma_wait<1>();
        fence_regs(s);
        FLASH_PHASE(mark(3));
        softmax(item.k_begin + (it + 1) * BK, s, na0, na1);
        FLASH_PHASE(mark(4));
        pv_finish(st, a0, a1);
        FLASH_PHASE(mark(5));
        split_p(s);
        FLASH_PHASE(mark(6));
        a0 = na0;
        a1 = na1;
        next();
      }
      pv_issue(st);
      pv_finish(st, a0, a1);
      next();
      for (int turn = t_hi - t_lo; turn < most; ++turn) {
        named_sync(my_turn, 256);
        named_arrive(next_turn, 256);
      }
      for (int it = t_hi; it < item.n_tiles; ++it) pass();

      // epilogue: out = O / max(l, 1e-30) in bf16, into this warpgroup's q
      // rows (swizzled as TMA reads them), then one TMA store a panel
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
      const int r0 = 16 * wl + g;  // rows r0 and r0 + 8 of the warpgroup; both r0 % 8 == g
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const uint32_t row0 = q_wg + (c / 8) * Sh::Q_PANEL + r0 * kRow + 4 * t;
        const uint32_t chunk = ((c % 8) ^ g) * 16;
        st_shared(row0 + chunk, pack(o[4 * c] / d0, o[4 * c + 1] / d0));
        st_shared(row0 + 8 * kRow + chunk, pack(o[4 * c + 2] / d1, o[4 * c + 3] / d1));
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (tid % 128 == 0) {
        if (row_min < S) {
#pragma unroll
          for (int p = 0; p < Sh::PANELS; ++p)
            tma_store_4d(&to, q_wg + p * Sh::Q_PANEL, 64 * p, item.h, row_min, item.b);
        }
        tma_store_commit();
      }
    }
    // the last store has read its tile before the block's shared memory goes
    if (tid % 128 == 0) tma_store_wait_read();
#ifdef FLASH_PHASE_CLOCKS
    if (lane == 0)
      for (int k = 0; k < kPhases; ++k) atomicAdd(&g_phase_clocks[wg][k], clocks.sum[k]);
#endif
  }
}

template <int D, bool kWindow>
int launch_w(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
             int KV, int window, float scale, cudaStream_t s) {
  using Sh = Shape<D>;
  CUtensorMap tq, tk, tv, to;
  if (!bf16_rows_map(&tq, q, B, S, H, D, 64) || !bf16_rows_map(&tk, k, B, S, KV, D, Sh::BK) ||
      !bf16_rows_map(&tv, v, B, S, KV, D, Sh::BK) || !bf16_rows_map(&to, out, B, S, H, D, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_items = static_cast<int64_t>((S + BQ - 1) / BQ) * H * B;
  if (n_items > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  PersistentLaunch pl;
  const cudaError_t err = persistent_launch(flash_tc_kernel<D, kWindow>, Sh::SMEM, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(n_items < pl.sms ? n_items : pl.sms);
  flash_tc_kernel<D, kWindow><<<grid, kThreads, Sh::SMEM, s>>>(
      tq, tk, tv, to, S, H, KV, B, window, scale * 1.4426950408889634f, pl.next_item);
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

#ifdef FLASH_PHASE_CLOCKS
// Instrumented builds only: copies the phase clocks summed since the last
// call into out[2][8] (by warpgroup, see tc::PhaseClocks) and zeroes them.
extern "C" int flash_phase_clocks(unsigned long long* out) {
  static const unsigned long long zero[tc::kConsumers * tc::kPhases] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, tc::g_phase_clocks, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(tc::g_phase_clocks, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
