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
// computed in f32 and written in W's type (f32 or bf16).  M may be bool,
// uint8 or W's own type.  The sums run over j = 0 ... m - 1 in that order
// from 0 (p = W * M first, then agg += A * p), and the quotient is IEEE's:
// A and M hold 0 and 1, so every product is exact and the bits depend on
// that order alone.
//
// Receiver range: the senders are all m rows of W and M, the receivers r of
// them starting at r0 (1 <= r, r0 + r <= m): out [r, n] holds receivers
// r0 ... r0 + r - 1, their selection A[:, r0:r0 + r] and their lambda = 0
// fill W[r0 + i].  A sharded step gives each rank the rows of its own
// nodes: it gathers the m senders' slabs over the node axis and averages
// for its r = m / node receivers alone.  The square call is r0 = 0, r = m.
// Receiver r0 + i is sender r0 + i: the ring form takes its fill from the
// tile of W already read for the sums, so no row of W is read from device
// memory twice.
//
// Lanes: W, M and out may hold L independent lanes [L, m, n] and A [L, m, m]
// (S seeds x C configs of one run batched together).  A tile lies in one
// lane and reads and writes only that lane's rows, at its strides, so one
// launch covers every lane and each lane computes what a single-lane launch
// on it computes, bit for bit.
//
// What bounds it on an H100: bytes.  Per coordinate it does 2*m*r
// multiply-adds against m*(|W| + |M|) + r*|out| bytes; at the trainer's
// m = 4 that is about 6 operations a byte, far below the ridge point, so
// the least time is (W read + M read + out written) / 3.35 TB/s.
//
// Design (m <= 4, a launch of at least one tile an SM: every large leaf of
// the port's paths).  A persistent grid, one block on each SM, walks tiles
// of kTile coordinates (lane-major for a lane launch) with a grid stride.
// In each block one producer thread keeps a ring of up to four stages full
// with cp.async.bulk copies (global to shared, completion on the stage's
// mbarrier): a stage holds the m sender rows of W and of M for one tile,
// 7.5 KB of bf16 W and 3.75 KB of mask a row at m = 4.  Fifteen consumer
// warps (so that a thread may keep 128 registers) read their coordinates
// from the stage (16-byte reads of W), take each receiver's fill from its
// own row there, write out with 16-byte stores, and release the stage to
// the producer, one arrival a warp.  A bulk copy needs 16-byte-aligned
// addresses and sizes: a row whose tile does not start on 16 bytes has its
// head, and a ragged last tile its tail, read by the consumers from device
// memory with plain loads; the aligned middle still comes by bulk copy.
// Nothing is padded in memory.  A^T of the tile's lane is staged in shared
// memory once a block (and again where its tiles cross into another lane).
//
// The consumers' instructions, not the copies, set the pace (a ring that
// only copies moves row 1's reads at 0.92 of the bound), and a loop body
// that outgrows the instruction cache costs more than its count.  So:
//   - bool masks with a selection of 0s and 1s (every path of the port)
//     take one pass for up to four receivers, with the counts summed as
//     bytes of the packed mask words (exact: at most 4, no carry), no
//     quotient where a count is 0 or 1 and a multiply by 2^-k where every
//     count of a group is 0, 1, 2 or 4;
//   - any other input takes the general pass, two receivers at a time;
//   - a quotient agg / d (d = 1 ... 8) is Markstein's correction of
//     agg * RN(1/d), branch-free; it equals IEEE's division for every
//     dividend of magnitude 2^-100 ... 2^100 or 0 and every such d, which
//     pme_average_quotient_check holds for all 2^32 dividends.  IEEE's
//     division takes the rest.
//
// m > 4 (up to MAX_NODES), or a launch too small to give each SM a tile
// (F3's fc1, H3's convs, where a block would wait one copy round trip for
// its only tile): a loop form, a chunk a block while the chunks are few
// and a grid stride beyond.  Each thread owns V = 4 coordinates (16-byte
// loads of f32 W; V = 1 when n or an operand is not aligned), receiver
// tiles of up to 8 rows of A^T are staged in shared memory, agg and cnt
// live in registers and each sender row is read once a receiver tile.  The
// fill is read again after the sums, from the cache line the sender loop
// just brought in: keeping it in registers through that loop costs a
// select per receiver, coordinate and sender, which a launch of a few
// microseconds pays for in time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// ---- the ring form (m <= kRingSenders) ----
constexpr int kRingSenders = 4;            // the rows of W and of M a stage holds
constexpr int kRecv = 2;                   // receivers a general pass keeps in registers
constexpr int kMaxStages = 4;
constexpr uint32_t kPad = 16;              // room before a row for its misaligned head
constexpr uint32_t kHeader = 384;          // mbarriers, the lane's A^T, RN(1/d)
constexpr uint32_t kSmemMax = 227 * 1024;  // the most one block may have
// ---- the loop form ----
constexpr int kLoopThreads = 256;
constexpr int kMaxRecvTile = 8;
constexpr int kMaxDevices = 64;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
// exact for 0 ... 255 (2^23 + x - 2^23) and full rate, where I2F is not
__device__ __forceinline__ float to_f(uint8_t x) {
  return __uint_as_float(0x4B000000u | x) - 8388608.f;
}
// byte b of x as a float, the same way in one PRMT and one FADD
__device__ __forceinline__ float byte_f(uint32_t x, int b) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540u | b)) - 8388608.f;
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V values from p (aligned to V * sizeof(T)), as floats
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&o)[V]) {
  if constexpr (std::is_same<T, uint8_t>::value && V % 4 == 0) {
    const Pack<uint32_t, V / 4> pk = *reinterpret_cast<const Pack<uint32_t, V / 4>*>(p);
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = byte_f(pk.v[e / 4], e % 4);
  } else {
    const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = to_f(pk.v[e]);
  }
}

// ---- the quotient ----

// agg / d for d = max(cnt, 1), bit for bit IEEE's where `fast`: d one of
// 1 ... 8 and agg 0 or of magnitude 2^-100 ... 2^100.  rcp[d] = RN(1/d).
__device__ __forceinline__ float count_quotient(float agg, float d, const float* rcp, bool& fast) {
  const int di = __float2int_rz(d);
  const float mag = fabsf(agg);
  fast = di <= 8 && __int2float_rn(di) == d &&
         (agg == 0.f || (mag >= 0x1p-100f && mag <= 0x1p100f));
  const float y = rcp[fast ? di : 1];
  const float q = agg * y;
  return agg == 0.f ? agg : fmaf(fmaf(-d, q, agg), y, q);
}

__device__ __forceinline__ void fill_rcp(float* rcp) {
  if (threadIdx.x < 9) rcp[threadIdx.x] = 1.f / static_cast<float>(threadIdx.x);
}

// Every float dividend (all 2^32 bit patterns) against each d = 1 ... 8:
// out[0] counts the fast quotients that differ from IEEE division in any
// bit, out[1] the fast ones compared.
__global__ void quotient_check(unsigned long long* out) {
  __shared__ float rcp[9];
  fill_rcp(rcp);
  __syncthreads();
  unsigned long long wrong = 0, compared = 0;
  for (uint64_t i = blockIdx.x * 256ull + threadIdx.x; i < (1ull << 32);
       i += 256ull * gridDim.x) {
    const float a = __uint_as_float(static_cast<uint32_t>(i));
    for (int c = 1; c <= 8; ++c) {
      bool fast;
      const float d = static_cast<float>(c);
      const float q = count_quotient(a, d, rcp, fast);
      compared += fast;
      wrong += fast && __float_as_uint(q) != __float_as_uint(__fdiv_rn(a, d));
    }
  }
  atomicAdd(out, wrong);
  atomicAdd(out + 1, compared);
}

// ---- mbarriers and bulk copies (PTX) ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.  A wait
// that lasts seconds means the ring is broken: trap, so that the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A row's tile of `bytes` bytes from `p`: the head (up to the first 16-byte
// boundary) and the 16-byte-multiple core after it, the part that comes by
// bulk copy.  The core lands kPad bytes into the row's slot.
struct Span {
  uint32_t head, core;
};

__device__ __forceinline__ Span span(const void* p, uint32_t bytes) {
  const uint32_t mis = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p) & 15u);
  uint32_t head = mis ? 16u - mis : 0u;
  if (head > bytes) head = bytes;
  return {head, (bytes - head) & ~15u};
}

// Coordinate k of a row's tile (g: its start in device memory) in a launch
// whose rows do not all start on 16 bytes: from the slot where the bulk
// copy put the core, else (head and tail) from g.
template <typename T>
__device__ __forceinline__ float any_at(const unsigned char* slot, const T* g, int cnt, int k) {
  const Span sp = span(g, static_cast<uint32_t>(cnt) * sizeof(T));
  const uint32_t b = static_cast<uint32_t>(k) * sizeof(T);
  if (b >= sp.head && b - sp.head < sp.core)
    return to_f(*reinterpret_cast<const T*>(slot + kPad - sp.head + b));
  return to_f(g[k]);
}

// ---- the ring form ----

template <typename WT, typename MT>
struct Ring {
  // fifteen consumer warps and one producer warp, so that a consumer may
  // keep 128 registers
  static constexpr int kConsumers = 480;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kVec = 16 / sizeof(WT);  // coordinates of a 16-byte store of out
  static constexpr int kTile = kConsumers * 8;  // coordinates a stage: 3840
  static constexpr int kGroups = kTile / (kConsumers * kVec);  // a consumer's: bf16 1, f32 2
  static constexpr uint32_t kWSlot = kTile * sizeof(WT) + kPad;
  static constexpr uint32_t kMSlot = kTile * sizeof(MT) + kPad;
  static constexpr uint32_t kStage = kRingSenders * (kWSlot + kMSlot);
  static constexpr uint32_t kBudget = kSmemMax - 1024 - kHeader;
  static constexpr int kStages = kBudget / kStage < kMaxStages ? kBudget / kStage : kMaxStages;
  static constexpr uint32_t kSmem = kHeader + kStages * kStage;
  static_assert(kStages >= 1, "a stage must fit in shared memory");
  static_assert(kMaxStages * 16 + (kRingSenders * kRingSenders + 9) * 4 <= kHeader,
                "the header must fit");
};

template <int kCount>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kCount) : "memory");
}

// The general pass.  Receivers r0 + i (i < nr) at V coordinates k0 ... of
// one tile, kRecv receivers at a time: the sums over senders j = 0 ... m - 1
// in order.  senders(j, wv, mv) gives sender j's W and M there, own(row, o)
// a row's W (the fill); s_at[j * kRingSenders + i] = A[j, r0 + i].  Out rows at
// ol + i * n; the store is one 16-byte write where the group is whole and
// aligned.
template <typename WT, int V, class Senders, class Own>
__device__ __forceinline__ void average_group(const Senders& senders, const Own& own,
                                              const float* s_at, const float* s_rcp, int m,
                                              int r0, int nr, WT* ol, int64_t n, int k0,
                                              int cnt) {
#pragma unroll 1
  for (int i0 = 0; i0 < nr; i0 += kRecv) {
    float agg[kRecv][V], c[kRecv][V];
#pragma unroll
    for (int i = 0; i < kRecv; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) agg[i][e] = c[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kRingSenders; ++j) {
      if (j < m) {
        float wv[V], mv[V];
        senders(j, wv, mv);
#pragma unroll
        for (int e = 0; e < V; ++e) wv[e] *= mv[e];
#pragma unroll
        for (int i = 0; i < kRecv; ++i) {
          if (i0 + i < nr) {
            const float aji = s_at[j * kRingSenders + i0 + i];
#pragma unroll
            for (int e = 0; e < V; ++e) {
              agg[i][e] += aji * wv[e];
              c[i][e] += aji * mv[e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRecv; ++i) {
      if (i0 + i < nr) {
        float o[V], q[V];
        own(r0 + i0 + i, o);  // the fill: the receiver's own row, already read
        bool fast = true;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          bool f;
          q[e] = count_quotient(agg[i][e], fmaxf(c[i][e], 1.f), s_rcp, f);
          fast &= f || !(c[i][e] > 0.f);
        }
        if (!fast) {
#pragma unroll
          for (int e = 0; e < V; ++e) q[e] = agg[i][e] / fmaxf(c[i][e], 1.f);
        }
        Pack<WT, V> pk;
#pragma unroll
        for (int e = 0; e < V; ++e) pk.v[e] = from_f<WT>(c[i][e] > 0.f ? q[e] : o[e]);
        WT* p = ol + static_cast<int64_t>(i0 + i) * n + k0;
        if (k0 + V <= cnt && reinterpret_cast<uintptr_t>(p) % sizeof(pk) == 0) {
          *reinterpret_cast<Pack<WT, V>*>(p) = pk;
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (k0 + e < cnt) p[e] = pk.v[e];
        }
      }
    }
  }
}

// The common pass: bool masks (bytes 0 and 1), a selection of 0s and 1s,
// m <= 4, finite W, a whole aligned group.  All receivers in one pass; the
// counts add up as bytes of the packed mask words (cw += word * a_ji: at
// most 4, no carry), agg in f32 with the general pass's bits (p = w * m,
// then agg += a_ji * p in sender order), a count of 0 or 1 needs no quotient
// (agg / 1 = agg), and a power of two none but a multiply.  Returns false,
// having written nothing, where some W is Inf or NaN: the general pass then
// keeps the 0 * NaN terms that carry NaN into the sums, as IEEE does.
template <typename WT, int V>
__device__ __forceinline__ bool average_group_binary(const unsigned char* st, const float* s_at,
                                                     const float* s_rcp, int m, int r0, int nr,
                                                     WT* ol, int64_t n, int k0) {
  using R = Ring<WT, uint8_t>;
  constexpr int kS = kRingSenders;
  constexpr int kW = V * sizeof(WT) / 4;  // 32-bit words of W a sender
  constexpr int kM = V / 4;               // of mask bytes
  // an exponent of all ones carries into the sign bit of its element
  constexpr uint32_t kExp = sizeof(WT) == 2 ? 0x7F807F80u : 0x7F800000u;
  constexpr uint32_t kOne = sizeof(WT) == 2 ? 0x00800080u : 0x00800000u;
  constexpr uint32_t kTop = sizeof(WT) == 2 ? 0x80008000u : 0x80000000u;
  uint32_t wr[kS][kW], mr[kS][kM], top = 0;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    if (j < m) {
      const auto pw = *reinterpret_cast<const Pack<uint32_t, kW>*>(
          st + j * R::kWSlot + kPad + k0 * sizeof(WT));
      const auto pm = *reinterpret_cast<const Pack<uint32_t, kM>*>(
          st + kS * R::kWSlot + j * R::kMSlot + kPad + k0);
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        wr[j][k] = pw.v[k];
        top |= (pw.v[k] & kExp) + kOne;
      }
#pragma unroll
      for (int k = 0; k < kM; ++k) mr[j][k] = pm.v[k];
    }
  }
  if (top & kTop) return false;
  // p = w * m for a finite w and m in {0, 1} is w or +-0, and a zero term
  // leaves agg (never -0: it starts at +0) as it is, so p = m ? w : +0:
  // each mask byte spread to 0xFF.. over its element's bits, ANDed with W
  const auto p_at = [&](int j, int e) {
    const uint32_t m255 = mr[j][e / 4] * 0xFFu;  // bytes 0x00 / 0xFF
    if (sizeof(WT) == 4)
      return __uint_as_float(wr[j][e] & __byte_perm(m255, 0u, 0x1111u * (e % 4)));
    const int b = 2 * (e / 2) % 4;  // the word's first element's byte
    const uint32_t x = wr[j][e / 2] & __byte_perm(m255, 0u, 0x1100u + 0x2222u * (b / 2));
    return __uint_as_float(e % 2 ? x & 0xFFFF0000u : x << 16);
  };
  float agg[kS][V];
  uint32_t cw[kS][kM];
#pragma unroll
  for (int i = 0; i < kS; ++i) {
#pragma unroll
    for (int e = 0; e < V; ++e) agg[i][e] = 0.f;
#pragma unroll
    for (int k = 0; k < kM; ++k) cw[i][k] = 0;
  }
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    if (j < m) {
      float p[V];
#pragma unroll
      for (int e = 0; e < V; ++e) p[e] = p_at(j, e);
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        if (i < nr) {
          const float a = s_at[j * kS + i];
          const uint32_t ai = a != 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) agg[i][e] += a * p[e];
#pragma unroll
          for (int k = 0; k < kM; ++k) cw[i][k] += mr[j][k] * ai;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    if (i < nr) {
      float o[V];  // the fill: the receiver's own row, already in the stage
      load<WT, V>(reinterpret_cast<const WT*>(st + (r0 + i) * R::kWSlot + kPad) + k0, o);
      bool small = true;
#pragma unroll
      for (int k = 0; k < kM; ++k) small &= (cw[i][k] & 0xFEFEFEFEu) == 0;
      const auto heard = [&](int e) { return (cw[i][e / 4] >> (8 * (e % 4)) & 0xFFu) != 0; };
      // a count of 3 (counts are 0 ... 4 here): a zero byte of cw ^ 0x03...
      bool three = false;
#pragma unroll
      for (int k = 0; k < kM; ++k) {
        const uint32_t x = cw[i][k] ^ 0x03030303u;
        three |= ((x - 0x01010101u) & ~x & 0x80808080u) != 0;
      }
      Pack<WT, V> pk;
      if (small) {  // every count 0 or 1
#pragma unroll
        for (int e = 0; e < V; ++e) pk.v[e] = from_f<WT>(heard(e) ? agg[i][e] : o[e]);
      } else if (!three) {  // counts 0, 1, 2, 4: agg * 2^-k is agg / 2^k rounded, exactly
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const uint32_t c = cw[i][e / 4] >> (8 * (e % 4)) & 0xFFu;
          const float y = __uint_as_float(0x3F800000u - ((c >> 1) << 23));
          pk.v[e] = from_f<WT>(c ? agg[i][e] * y : o[e]);
        }
      } else {
        float q[V];
        bool fast = true;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          bool f;
          q[e] = count_quotient(agg[i][e], fmaxf(byte_f(cw[i][e / 4], e % 4), 1.f), s_rcp, f);
          fast &= f;
        }
        if (!fast) {
#pragma unroll
          for (int e = 0; e < V; ++e)
            q[e] = agg[i][e] / fmaxf(byte_f(cw[i][e / 4], e % 4), 1.f);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) pk.v[e] = from_f<WT>(heard(e) ? q[e] : o[e]);
      }
      *reinterpret_cast<Pack<WT, V>*>(ol + static_cast<int64_t>(i) * n + k0) = pk;
    }
  }
  return true;
}

// kAligned: every row of W, M and out starts on 16 bytes (aligned bases and
// n * sizeof a multiple of 16), so a tile's rows share their layout: the
// first vec_end = cnt & ~15 coordinates come by bulk copy, the rest (a
// ragged last tile's tail) by plain loads.  Otherwise each row's head and
// tail come by plain loads and its aligned middle by bulk copy.  kBool:
// bool masks, m <= 4 and an aligned launch, where a lane whose selection
// holds only 0s and 1s takes the common pass.
template <typename WT, typename MT, bool kAligned, bool kBool>
__global__ void __launch_bounds__(Ring<WT, MT>::kThreads, 1)
pme_ring_kernel(const WT* __restrict__ w, const MT* __restrict__ mask,
                const float* __restrict__ a, WT* __restrict__ out, int m, int64_t n, int lanes,
                int r0, int nr) {
  using R = Ring<WT, MT>;
  constexpr int V = R::kVec;
  constexpr int kTile = R::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* s_at = reinterpret_cast<float*>(empty + kMaxStages);  // [kRingSenders]^2
  float* s_rcp = s_at + kRingSenders * kRingSenders;            // RN(1/d), d = 0 ... 8
  unsigned char* ring = smem + kHeader;
  const int64_t per_lane = (n + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], R::kConsumers / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fill_rcp(s_rcp);
  __syncthreads();
  // the tiles of this block: blockIdx.x, + gridDim.x, ... (lane-major), as
  // (lane, tile within the lane), stepped without a 64-bit division a tile
  int64_t lane = blockIdx.x / per_lane, tl = blockIdx.x % per_lane;
  const auto next = [&] {
    for (tl += gridDim.x; tl >= per_lane && lane < lanes; tl -= per_lane) ++lane;
  };
  int s = 0;
  uint32_t phase = 0;

  if (threadIdx.x >= R::kConsumers) {  // the producer warp: one thread copies
    if (threadIdx.x != R::kConsumers) return;
    for (; lane < lanes; next()) {
      const int64_t l0 = tl * kTile;
      const uint32_t cnt = static_cast<uint32_t>(n - l0 < kTile ? n - l0 : kTile);
      const WT* wl = w + lane * m * n + l0;
      const MT* ml = mask + lane * m * n + l0;
      mbar_wait(&empty[s], phase ^ 1);  // a fresh stage passes at once
      unsigned char* st = ring + s * R::kStage;
      if (kAligned) {
        const uint32_t vec_end = cnt & ~15u;
        mbar_expect_tx(&full[s], m * vec_end * (sizeof(WT) + sizeof(MT)));
        if (vec_end)
          for (int j = 0; j < m; ++j) {
            bulk_copy(st + j * R::kWSlot + kPad, wl + j * n, vec_end * sizeof(WT), &full[s]);
            bulk_copy(st + kRingSenders * R::kWSlot + j * R::kMSlot + kPad, ml + j * n,
                      vec_end * sizeof(MT), &full[s]);
          }
      } else {
        uint32_t tx = 0;
        for (int j = 0; j < m; ++j)
          tx += span(wl + j * n, cnt * sizeof(WT)).core + span(ml + j * n, cnt * sizeof(MT)).core;
        mbar_expect_tx(&full[s], tx);
        for (int j = 0; j < m; ++j) {
          const Span sw = span(wl + j * n, cnt * sizeof(WT));
          if (sw.core)
            bulk_copy(st + j * R::kWSlot + kPad,
                      reinterpret_cast<const unsigned char*>(wl + j * n) + sw.head, sw.core,
                      &full[s]);
          const Span sm = span(ml + j * n, cnt * sizeof(MT));
          if (sm.core)
            bulk_copy(st + kRingSenders * R::kWSlot + j * R::kMSlot + kPad,
                      reinterpret_cast<const unsigned char*>(ml + j * n) + sm.head, sm.core,
                      &full[s]);
        }
      }
      if (++s == R::kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  int64_t staged = -1;  // the lane whose A is in s_at
  bool binary = false;  // its entries all 0 or 1
  for (; lane < lanes; next()) {
    const int64_t l0 = tl * kTile;
    const int cnt = static_cast<int>(n - l0 < kTile ? n - l0 : kTile);
    if (lane != staged) {  // once a block, and where its tiles cross into another lane
      consumers_sync<R::kConsumers>();
      const float* al = a + lane * m * m;
      for (int e = threadIdx.x; e < m * nr; e += R::kConsumers)
        s_at[(e / nr) * kRingSenders + e % nr] = al[(e / nr) * m + r0 + e % nr];
      consumers_sync<R::kConsumers>();
      staged = lane;
      binary = true;
      for (int e = 0; e < m * nr; ++e) {
        const float x = s_at[(e / nr) * kRingSenders + e % nr];
        binary &= x == 0.f || x == 1.f;
      }
    }
    const WT* wl = w + lane * m * n + l0;
    const MT* ml = mask + lane * m * n + l0;
    WT* ol = out + lane * nr * n + l0;
    mbar_wait(&full[s], phase);
    const unsigned char* st = ring + s * R::kStage;
    const auto wslot = [&](int j) { return st + j * R::kWSlot + kPad; };
    const auto mslot = [&](int j) {
      return st + kRingSenders * R::kWSlot + j * R::kMSlot + kPad;
    };
    const int vec_end = cnt & ~15;
#pragma unroll
    for (int gi = 0; gi < R::kGroups; ++gi) {
      const int k0 = (gi * R::kConsumers + static_cast<int>(threadIdx.x)) * V;
      if (k0 >= cnt) continue;
      if (kAligned && k0 + V <= vec_end) {  // every tile but a ragged last one
        if constexpr (kBool)
          if (binary && average_group_binary<WT, V>(st, s_at, s_rcp, m, r0, nr, ol, n, k0))
            continue;
        average_group<WT, V>(
            [&](int j, float(&wv)[V], float(&mv)[V]) {
              load<WT, V>(reinterpret_cast<const WT*>(wslot(j)) + k0, wv);
              load<MT, V>(reinterpret_cast<const MT*>(mslot(j)) + k0, mv);
            },
            [&](int row, float(&o)[V]) {
              load<WT, V>(reinterpret_cast<const WT*>(wslot(row)) + k0, o);
            },
            s_at, s_rcp, m, r0, nr, ol, n, k0, cnt);
      } else {
        const auto at = [&](const unsigned char* slot, const auto* g, int k) {
          using T = typename std::remove_cv<typename std::remove_pointer<decltype(g)>::type>::type;
          if (k >= cnt) return 0.f;
          if (!kAligned) return any_at<T>(slot - kPad, g, cnt, k);
          return k < vec_end ? to_f(reinterpret_cast<const T*>(slot)[k]) : to_f(g[k]);
        };
        average_group<WT, V>(
            [&](int j, float(&wv)[V], float(&mv)[V]) {
#pragma unroll
              for (int e = 0; e < V; ++e) {
                wv[e] = at(wslot(j), wl + j * n, k0 + e);
                mv[e] = at(mslot(j), ml + j * n, k0 + e);
              }
            },
            [&](int row, float(&o)[V]) {
#pragma unroll
              for (int e = 0; e < V; ++e) o[e] = at(wslot(row), wl + row * n, k0 + e);
            },
            s_at, s_rcp, m, r0, nr, ol, n, k0, cnt);
      }
    }
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[s]);
    if (++s == R::kStages) {
      s = 0;
      phase ^= 1;
    }
  }
}

// ---- the loop form ----

template <typename WT, typename MT, int V, int kRecvTile>
__global__ void __launch_bounds__(kLoopThreads)
pme_loop_kernel(const WT* __restrict__ w, const MT* __restrict__ mask,
                const float* __restrict__ a, WT* __restrict__ out, int m, int64_t n, int lanes,
                int r0, int nr) {
  extern __shared__ float s_at_loop[];  // [kRecvTile, m]: A^T rows of the receiver tile
  const int64_t per_lane = (n + kLoopThreads * V - 1) / (kLoopThreads * V);
  const int64_t chunks = per_lane * lanes;
  for (int64_t t = blockIdx.x; t < chunks; t += gridDim.x) {
    // no 64-bit division where there is one lane: a small launch's blocks
    // each take one chunk, and its latency is theirs
    const int64_t lane = lanes == 1 ? 0 : t / per_lane;
    const int64_t l0 = ((t - lane * per_lane) * kLoopThreads + threadIdx.x) * V;
    const WT* wl = w + lane * m * n;
    const MT* ml = mask + lane * m * n;
    const float* al = a + lane * m * m;
    WT* ol = out + lane * nr * n;
    for (int i0 = 0; i0 < nr; i0 += kRecvTile) {
      const int rt = min(kRecvTile, nr - i0);
      __syncthreads();
      for (int e = threadIdx.x; e < rt * m; e += kLoopThreads) {
        const int r = e / m, j = e % m;
        s_at_loop[e] = al[static_cast<int64_t>(j) * m + r0 + i0 + r];
      }
      __syncthreads();
      if (l0 >= n) continue;  // for V > 1 the launcher guarantees n % V == 0
      float agg[kRecvTile][V], cnt[kRecvTile][V];
#pragma unroll
      for (int r = 0; r < kRecvTile; ++r)
#pragma unroll
        for (int e = 0; e < V; ++e) agg[r][e] = cnt[r][e] = 0.f;
      for (int j = 0; j < m; ++j) {
        float wv[V], mv[V];
        load<WT, V>(wl + static_cast<int64_t>(j) * n + l0, wv);
        load<MT, V>(ml + static_cast<int64_t>(j) * n + l0, mv);
#pragma unroll
        for (int e = 0; e < V; ++e) wv[e] *= mv[e];
#pragma unroll
        for (int r = 0; r < kRecvTile; ++r) {
          if (r < rt) {
            const float aji = s_at_loop[r * m + j];
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
          float own[V];  // the fill: the receiver's row, as the sender loop read it
          load<WT, V>(wl + static_cast<int64_t>(r0 + i0 + r) * n + l0, own);
          Pack<WT, V> pk;
#pragma unroll
          for (int e = 0; e < V; ++e)
            pk.v[e] = from_f<WT>(cnt[r][e] > 0.f ? agg[r][e] / fmaxf(cnt[r][e], 1.f) : own[e]);
          *reinterpret_cast<Pack<WT, V>*>(ol + static_cast<int64_t>(i0 + r) * n + l0) = pk;
        }
      }
    }
  }
}

// ---- launchers ----

// Blocks of `kernel` resident on one SM of the current device with `smem`
// bytes of dynamic shared memory, times the SMs: the persistent grid.
template <typename K>
int persistent_grid(K kernel, int threads, size_t smem, int (&cache)[kMaxDevices]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cache[dev]) return cache[dev];
  int sms = 0, per_sm = 0;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return 0;
  const int grid = sms * per_sm;
  if (dev < kMaxDevices) cache[dev] = grid;
  return grid;
}

template <typename WT, typename MT, int V, int kRecvTile>
int launch_loop_as(const void* w, const void* mask, const float* a, void* out, int m, int64_t n,
                   int lanes, int r0, int nr, cudaStream_t s) {
  static int cache[kMaxDevices];
  auto kernel = pme_loop_kernel<WT, MT, V, kRecvTile>;
  const size_t smem = static_cast<size_t>(kRecvTile) * m * sizeof(float);
  // sized for MAX_NODES senders, so that one grid serves every m
  const int grid = persistent_grid(kernel, kLoopThreads, 48 * 1024, cache);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t chunks = (n + kLoopThreads * V - 1) / (kLoopThreads * V) * lanes;
  // a chunk a block while the chunks are few (a small launch's latency is
  // its blocks', and a second chunk in a block doubles it); a grid stride
  // over the resident blocks beyond
  const int64_t blocks = chunks <= 4 * static_cast<int64_t>(grid) ? chunks : grid;
  kernel<<<static_cast<unsigned>(blocks), kLoopThreads, smem, s>>>(
      static_cast<const WT*>(w), static_cast<const MT*>(mask), a, static_cast<WT*>(out), m, n,
      lanes, r0, nr);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT, typename MT>
int launch_loop(const void* w, const void* mask, const float* a, void* out, int m, int64_t n,
                int lanes, int r0, int nr, cudaStream_t s) {
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % (4 * sizeof(WT)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * sizeof(WT)) == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % (4 * sizeof(MT)) == 0;
  // a receiver tile of 4 rows when r <= 4 halves the accumulator registers
  if (vec && nr <= 4)
    return launch_loop_as<WT, MT, 4, 4>(w, mask, a, out, m, n, lanes, r0, nr, s);
  if (vec)
    return launch_loop_as<WT, MT, 4, kMaxRecvTile>(w, mask, a, out, m, n, lanes, r0, nr, s);
  return launch_loop_as<WT, MT, 1, kMaxRecvTile>(w, mask, a, out, m, n, lanes, r0, nr, s);
}

template <typename WT, typename MT, bool kAligned, bool kBool>
int launch_ring_as(const void* w, const void* mask, const float* a, void* out, int m, int64_t n,
                   int lanes, int r0, int nr, cudaStream_t s) {
  using R = Ring<WT, MT>;
  static int cache[kMaxDevices];
  auto kernel = pme_ring_kernel<WT, MT, kAligned, kBool>;
  const int grid = persistent_grid(kernel, R::kThreads, R::kSmem, cache);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t tiles = (n + R::kTile - 1) / R::kTile * lanes;
  if (tiles < grid)  // too small to give each SM a tile
    return launch_loop<WT, MT>(w, mask, a, out, m, n, lanes, r0, nr, s);
  kernel<<<static_cast<unsigned>(grid), R::kThreads, R::kSmem, s>>>(
      static_cast<const WT*>(w), static_cast<const MT*>(mask), a, static_cast<WT*>(out), m, n,
      lanes, r0, nr);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT, typename MT, bool kBool>
int launch_ring(const void* w, const void* mask, const float* a, void* out, int m, int64_t n,
                int lanes, int r0, int nr, cudaStream_t s) {
  const bool aligned = n * sizeof(MT) % 16 == 0 && n * sizeof(WT) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(mask) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!aligned)
    return launch_ring_as<WT, MT, false, false>(w, mask, a, out, m, n, lanes, r0, nr, s);
  return launch_ring_as<WT, MT, true, kBool>(w, mask, a, out, m, n, lanes, r0, nr, s);
}

template <typename WT, typename MT, bool kBool = false>
int launch(const void* w, const void* mask, const float* a, void* out, int m, int64_t n,
           int lanes, int r0, int nr, cudaStream_t s) {
  if (m <= kRingSenders)
    return launch_ring<WT, MT, kBool>(w, mask, a, out, m, n, lanes, r0, nr, s);
  return launch_loop<WT, MT>(w, mask, a, out, m, n, lanes, r0, nr, s);
}

template <typename WT>
int dispatch_mask(const void* w, const void* mask, const float* a, void* out,
                  int m, int64_t n, int lanes, int r0, int nr, int mask_dtype,
                  cudaStream_t s) {
  switch (mask_dtype) {
    case 0: return launch<WT, float>(w, mask, a, out, m, n, lanes, r0, nr, s);
    case 1: return launch<WT, __nv_bfloat16>(w, mask, a, out, m, n, lanes, r0, nr, s);
    case 2: return launch<WT, uint8_t, true>(w, mask, a, out, m, n, lanes, r0, nr, s);
    case 3: return launch<WT, uint8_t>(w, mask, a, out, m, n, lanes, r0, nr, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// w [lanes, m, n] of type w_dtype; out [lanes, r, n] of the same type (the
// receivers r0 ... r0 + r - 1); mask [lanes, m, n] of type mask_dtype; a
// [lanes, m, m] float32, row-major A[sender, receiver] per lane.  Type
// codes: 0 float32, 1 bfloat16, 2 bool (bytes 0 and 1), 3 uint8.
// Launches on `stream`, allocates nothing, does not synchronise.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int pme_average_range(const void* w, const void* mask, const float* a,
                                 void* out, int m, long long n, int lanes, int r0,
                                 int r, int w_dtype, int mask_dtype, void* stream) {
  if (m < 1 || n < 1 || lanes < 1 || lanes > 65535 || r < 1 || r0 < 0 ||
      r0 + r > m || static_cast<size_t>(kMaxRecvTile) * m * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (w_dtype) {
    case 0: return dispatch_mask<float>(w, mask, a, out, m, n, lanes, r0, r, mask_dtype, s);
    case 1:
      return dispatch_mask<__nv_bfloat16>(w, mask, a, out, m, n, lanes, r0, r, mask_dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The square call: every row a receiver (r0 = 0, r = m), out [lanes, m, n].
extern "C" int pme_average(const void* w, const void* mask, const float* a,
                           void* out, int m, long long n, int lanes, int w_dtype,
                           int mask_dtype, void* stream) {
  return pme_average_range(w, mask, a, out, m, n, lanes, 0, m, w_dtype, mask_dtype, stream);
}

// The quotient's check: `out` two zeroed uint64 on the device; after the
// call out[0] holds the fast quotients (of all 2^32 dividends, d = 1 ... 8)
// that differ from IEEE division, out[1] those compared.  Synchronises.
extern "C" int pme_average_quotient_check(unsigned long long* out) {
  quotient_check<<<132 * 8, 256>>>(out);
  return static_cast<int>(cudaDeviceSynchronize());
}
