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
// What bounds it on an H100: bytes.  Each output element costs k
// multiply-adds against 4 bytes written and (once L2 serves the repeats)
// 4 bytes read, so at k <= 16 the work sits far below the card's ridge
// point: the least time is (T*m*n*4 read + T*m*n*4 written) / 3.35 TB/s.
//
// Design.  The TPU kernel scattered the table into a one-hot [BM, m]
// matrix because its MXU wants a matmul.  Here each block owns one
// receiver row i and a tile of 256*V coordinates: it stages row i's k slot
// ids and the G weight rows in shared memory, then every thread walks the
// k slots once, and for each slot reads x_t[j, its V coordinates] with one
// 16-byte load per term (V = 4 floats) and accumulates into registers.
// The number of terms is a template parameter, so only the accumulators in
// use take registers (32 a thread at T = 2) and more blocks stay resident.
// Blocks are numbered receiver-fastest, so the m blocks of one coordinate
// tile run together and the k re-reads of a sender row hit L2, not HBM.
// The sum runs in ascending slot order with separately rounded multiply
// and add (__fmul_rn / __fadd_rn, no FMA contraction), exactly the
// arithmetic of the "slots" chain, so the kernel equals it bit for bit.
// Zero weights are multiplied, not skipped, as in every reference form.
// A tail that does not fill 16-byte loads (n % 4 != 0 or a misaligned
// operand) takes the scalar instance of the same kernel.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxTerms = 8;
constexpr int kThreads = 256;

struct Terms {
  const float* x[kMaxTerms];
  float* out[kMaxTerms];
  int group[kMaxTerms];
};

template <int V>
struct alignas(4 * V) Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> scale(float w, const Vec<V>& x) {
  Vec<V> r;
#pragma unroll
  for (int e = 0; e < V; ++e) r.v[e] = __fmul_rn(w, x.v[e]);
  return r;
}

template <int V>
__device__ __forceinline__ Vec<V> add(const Vec<V>& a, const Vec<V>& b) {
  Vec<V> r;
#pragma unroll
  for (int e = 0; e < V; ++e) r.v[e] = __fadd_rn(a.v[e], b.v[e]);
  return r;
}

// NT = number of terms, fixed at compile time so that only NT accumulators
// take registers.
template <int V, int NT>
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

  Vec<V> acc[NT];
  {
    const int64_t row = static_cast<int64_t>(s_nbr[0]) * n_vec;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const Vec<V> xv = reinterpret_cast<const Vec<V>*>(terms.x[t])[row + v];
      acc[t] = scale(s_w[terms.group[t] * k], xv);
    }
  }
  for (int s = 1; s < k; ++s) {
    const int64_t row = static_cast<int64_t>(s_nbr[s]) * n_vec;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const Vec<V> xv = reinterpret_cast<const Vec<V>*>(terms.x[t])[row + v];
      acc[t] = add(acc[t], scale(s_w[terms.group[t] * k + s], xv));
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
    reinterpret_cast<Vec<V>*>(terms.out[t])[static_cast<int64_t>(i) * n_vec + v] = acc[t];
}

template <int V, int NT>
void launch(unsigned blocks, size_t smem, cudaStream_t s, const int* nbrs,
            const float* ws, const Terms& terms, int n_terms, int n_groups,
            int m, int k, int64_t n_vec) {
  if (n_terms == NT)
    gossip_gather_kernel<V, NT><<<blocks, kThreads, smem, s>>>(
        nbrs, ws, terms, n_groups, m, k, n_vec);
  else if constexpr (NT < kMaxTerms)
    launch<V, NT + 1>(blocks, smem, s, nbrs, ws, terms, n_terms, n_groups, m, k, n_vec);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// nbrs [m, k] int32; ws [G, m, k] float32; xs / outs: n_terms pointers to
// [m, n] float32; groups[t] in [0, G).  Launches on `stream`, allocates
// nothing, does not synchronise.  Returns cudaGetLastError() (0 = launched).
extern "C" int gossip_gather(const int* nbrs, const float* ws, int n_groups,
                             const void* const* xs, void* const* outs,
                             const int* groups, int n_terms, int m, int k,
                             long long n, void* stream) {
  if (n_terms < 1 || n_terms > kMaxTerms || m < 1 || k < 1 || n < 1 ||
      n_groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(k) * (1 + n_groups) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  Terms terms{};
  bool vec = (n % 4 == 0);
  for (int t = 0; t < n_terms; ++t) {
    if (groups[t] < 0 || groups[t] >= n_groups)
      return static_cast<int>(cudaErrorInvalidValue);
    terms.x[t] = static_cast<const float*>(xs[t]);
    terms.out[t] = static_cast<float*>(outs[t]);
    terms.group[t] = groups[t];
    vec = vec && aligned16(xs[t]) && aligned16(outs[t]);
  }
  const int64_t n_vec = vec ? n / 4 : n;
  const int64_t blocks = (n_vec + kThreads - 1) / kThreads * m;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto b = static_cast<unsigned>(blocks);
  if (vec)
    launch<4, 1>(b, smem, s, nbrs, ws, terms, n_terms, n_groups, m, k, n_vec);
  else
    launch<1, 1>(b, smem, s, nbrs, ws, terms, n_terms, n_groups, m, k, n_vec);
  return static_cast<int>(cudaGetLastError());
}
