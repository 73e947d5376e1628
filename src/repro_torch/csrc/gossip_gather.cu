// Fused gossip neighbour contraction for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gossip/kernel.py, gossip_gather_pallas (the
// Pallas TPU kernel behind repro.core.mixing.gather_terms(impl="pallas")).
//
// Computes, for T terms riding one padded [m, k] neighbour table,
//     out_t[i, l] = sum_slot w_{g(t)}[i, slot] * x_t[nbrs[i, slot], l]
// with G distinct weight tables (terms that share a table share it here
// too).  The wrapper (repro_torch.kernels.gossip.ops) has already set the
// weights of structural padding slots to exactly 0.0.
//
// Two variants, one per operand type; all terms of a launch share it.
//   * f32: x and out float32.
//   * bf16: x and out bfloat16, as the Pallas kernel takes them: each
//     sender value is widened to f32, the sum runs in f32 registers, and
//     the result is rounded to bf16 once (round to nearest even), so the
//     output equals the f32 "slots" chain on x.float() rounded to bf16.
//
// What bounds it on an H100: bytes.  Each output element costs k
// multiply-adds against one element written and (once L2 serves the
// repeats) one read, so at k <= 16 the work sits far below the card's
// ridge point: the least time is T*m*n*(read + written bytes) / 3.35 TB/s.
//
// Design.  The TPU kernel scattered the table into a one-hot [BM, m]
// matrix because its MXU wants a matmul.  Here each block owns one
// receiver row i and a tile of 256*V coordinates: it stages row i's k slot
// ids and the G weight rows in shared memory, then every thread walks the
// k slots once, and for each slot reads x_t[j, its V coordinates] with one
// 16-byte load per term (V = 4 floats or 8 bf16) and accumulates into f32
// registers.  The number of terms is a template parameter, so only the
// T*V accumulators in use take registers and more blocks stay resident.
// Blocks are numbered receiver-fastest, so the m blocks of one coordinate
// tile run together and the k re-reads of a sender row hit L2, not HBM.
// The sum runs in ascending slot order with separately rounded multiply
// and add (__fmul_rn / __fadd_rn, no FMA contraction), exactly the
// arithmetic of the "slots" chain, so the f32 variant equals it bit for
// bit.  Zero weights are multiplied, not skipped, as in every reference
// form.  A tail that does not fill 16-byte loads (n % V != 0 or a
// misaligned operand) takes the scalar instance of the same kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxTerms = 8;
constexpr int kThreads = 256;

struct Terms {
  const void* x[kMaxTerms];
  void* out[kMaxTerms];
  int group[kMaxTerms];
};

struct Bf16 {};  // tag: bfloat16 operands, handled as raw 16-bit words

// Io<T, V>: V consecutive operands at vector index i, widened to f32 on
// load and rounded to T on store, with one 16-byte access where V > 1.
template <typename T, int V>
struct Io;

template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void load(const void* p, int64_t i, float (&f)[4]) {
    const float4 x = static_cast<const float4*>(p)[i];
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
  static __device__ __forceinline__ void store(void* p, int64_t i, const float (&f)[4]) {
    static_cast<float4*>(p)[i] = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Io<float, 1> {
  static __device__ __forceinline__ void load(const void* p, int64_t i, float (&f)[1]) {
    f[0] = static_cast<const float*>(p)[i];
  }
  static __device__ __forceinline__ void store(void* p, int64_t i, const float (&f)[1]) {
    static_cast<float*>(p)[i] = f[0];
  }
};

// bf16 is the top half of an f32: widening is a shift, exact.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t to_bf16(float f) {  // round to nearest even
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}

template <>
struct Io<Bf16, 8> {
  static __device__ __forceinline__ void load(const void* p, int64_t i, float (&f)[8]) {
    const uint4 x = static_cast<const uint4*>(p)[i];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = bf16_lo(w[j]);
      f[2 * j + 1] = bf16_hi(w[j]);
    }
  }
  static __device__ __forceinline__ void store(void* p, int64_t i, const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = to_bf16(f[2 * j]) | (to_bf16(f[2 * j + 1]) << 16);
    static_cast<uint4*>(p)[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Io<Bf16, 1> {
  static __device__ __forceinline__ void load(const void* p, int64_t i, float (&f)[1]) {
    f[0] = __uint_as_float(static_cast<uint32_t>(static_cast<const unsigned short*>(p)[i]) << 16);
  }
  static __device__ __forceinline__ void store(void* p, int64_t i, const float (&f)[1]) {
    static_cast<unsigned short*>(p)[i] = static_cast<unsigned short>(to_bf16(f[0]));
  }
};

// T = operand type (float or Bf16), V = values per 16-byte load (1 for the
// scalar tail instance), NT = number of terms, fixed at compile time so that only NT*V
// accumulators take registers.
template <typename T, int V, int NT>
__global__ void __launch_bounds__(kThreads)
gossip_gather_kernel(const int* __restrict__ nbrs, const float* __restrict__ ws,
                     Terms terms, int n_groups, int m, int k, int64_t n_vec) {
  extern __shared__ float smem[];
  int* s_nbr = reinterpret_cast<int*>(smem);  // [k]
  float* s_w = smem + k;                       // [G, k]
  const int i = static_cast<int>(blockIdx.x % static_cast<unsigned>(m));
  const int64_t tile = blockIdx.x / static_cast<unsigned>(m);
  for (int s = threadIdx.x; s < k; s += blockDim.x) {
    s_nbr[s] = nbrs[static_cast<int64_t>(i) * k + s];
    for (int g = 0; g < n_groups; ++g)
      s_w[g * k + s] = ws[(static_cast<int64_t>(g) * m + i) * k + s];
  }
  __syncthreads();
  const int64_t v = tile * kThreads + threadIdx.x;  // index in units of V
  if (v >= n_vec) return;

  float acc[NT][V];
  {
    const int64_t row = static_cast<int64_t>(s_nbr[0]) * n_vec;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      float xv[V];
      Io<T, V>::load(terms.x[t], row + v, xv);
      const float w = s_w[terms.group[t] * k];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[t][e] = __fmul_rn(w, xv[e]);
    }
  }
  for (int s = 1; s < k; ++s) {
    const int64_t row = static_cast<int64_t>(s_nbr[s]) * n_vec;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      float xv[V];
      Io<T, V>::load(terms.x[t], row + v, xv);
      const float w = s_w[terms.group[t] * k + s];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[t][e] = __fadd_rn(acc[t][e], __fmul_rn(w, xv[e]));
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
    Io<T, V>::store(terms.out[t], static_cast<int64_t>(i) * n_vec + v, acc[t]);
}

template <typename T, int V, int NT>
void launch(unsigned blocks, size_t smem, cudaStream_t s, const int* nbrs,
            const float* ws, const Terms& terms, int n_terms, int n_groups,
            int m, int k, int64_t n_vec) {
  if (n_terms == NT)
    gossip_gather_kernel<T, V, NT><<<blocks, kThreads, smem, s>>>(
        nbrs, ws, terms, n_groups, m, k, n_vec);
  else if constexpr (NT < kMaxTerms)
    launch<T, V, NT + 1>(blocks, smem, s, nbrs, ws, terms, n_terms, n_groups, m, k, n_vec);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// One variant: 16-byte loads of V values where n and every pointer allow
// them, the scalar instance otherwise.
template <typename T, int V>
int run(const int* nbrs, const float* ws, int n_groups, const Terms& terms,
        int n_terms, int m, int k, long long n, size_t smem, cudaStream_t s) {
  bool vec = (n % V == 0);
  for (int t = 0; t < n_terms; ++t)
    vec = vec && aligned16(terms.x[t]) && aligned16(terms.out[t]);
  const int64_t n_vec = vec ? n / V : n;
  const int64_t blocks = (n_vec + kThreads - 1) / kThreads * m;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto b = static_cast<unsigned>(blocks);
  if (vec)
    launch<T, V, 1>(b, smem, s, nbrs, ws, terms, n_terms, n_groups, m, k, n_vec);
  else
    launch<T, 1, 1>(b, smem, s, nbrs, ws, terms, n_terms, n_groups, m, k, n_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nbrs [m, k] int32; ws [G, m, k] float32; xs / outs: n_terms pointers to
// [m, n] operands of one type, dtype 0 = float32, 1 = bfloat16; groups[t]
// in [0, G).  Launches on `stream`, allocates nothing, does not
// synchronise.  Returns cudaGetLastError() (0 = launched).
extern "C" int gossip_gather(const int* nbrs, const float* ws, int n_groups,
                             const void* const* xs, void* const* outs,
                             const int* groups, int n_terms, int m, int k,
                             long long n, int dtype, void* stream) {
  if (n_terms < 1 || n_terms > kMaxTerms || m < 1 || k < 1 || n < 1 ||
      n_groups < 1 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(k) * (1 + n_groups) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  Terms terms{};
  for (int t = 0; t < n_terms; ++t) {
    if (groups[t] < 0 || groups[t] >= n_groups)
      return static_cast<int>(cudaErrorInvalidValue);
    terms.x[t] = xs[t];
    terms.out[t] = outs[t];
    terms.group[t] = groups[t];
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, 4>(nbrs, ws, n_groups, terms, n_terms, m, k, n, smem, s);
  return run<Bf16, 8>(nbrs, ws, n_groups, terms, n_terms, m, k, n, smem, s);
}
