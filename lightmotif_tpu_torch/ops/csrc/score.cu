// PSSM window scoring kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lightmotif_tpu/ops/kernels.py::_gather_kernel
// in both of its modes:
//
//   K1, f32 mode (lm_score_f32):  out[p] = w[0][s[p]] + w[1][s[p+1]] + ...
//       + w[m-1][s[p+m-1]], added in ascending j with round-to-nearest adds,
//       so every score is bit-identical to the sequential host oracle
//       (ScoringMatrix.score_host); -INFINITY at p >= n_scores.
//   K2, discrete mode (lm_score_u8):  out[p] = min(sum_j dm[j][s[p+j]], 255)
//       as int32, which equals the reference's stepwise-saturating u8 sum
//       because the partial sums never decrease; -1 at p >= n_scores.
//
// Reads past the end of the sequence see the wildcard (rank k - 1), like the
// reference's wrap rows, and so does any rank >= k, as in the XLA version's
// select chain: no byte can index outside the table.
//
// What bounds it: each window costs m dependent adds (the f32 order may not be
// reassociated, so there is no tree or warp reduction over j) and m table
// lookups, against 1 byte read and 4 bytes written per position.  It is an
// integer/FP32-pipe and shared-memory-latency kernel; the tensor cores have
// nothing to do here.
//
// Design: one block scores a tile of TILE consecutive positions.  It first
// stages the whole table (m * k entries, 4 bytes each) and its TILE + m - 1
// sequence bytes (the tile plus the (m-1)-byte halo) in shared memory, so
// each sequence byte is read from device memory about once per block instead
// of m times (once per window that covers it), and the table lookups hit
// shared memory.  Each thread then scores TILE / blockDim.x positions, strided
// by blockDim.x so that a warp's output stores are coalesced.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;    // positions per block
constexpr int THREADS = 256;  // 4 positions per thread

template <bool DISCRETE>
struct Acc;

template <>
struct Acc<false> {
  using T = float;
  static __device__ __forceinline__ float load(const void* table, int i) {
    return static_cast<const float*>(table)[i];
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);  // never contracted into an FMA
  }
};

template <>
struct Acc<true> {
  using T = int;
  static __device__ __forceinline__ int load(const void* table, int i) {
    return static_cast<int>(static_cast<const uint8_t*>(table)[i]);
  }
  static __device__ __forceinline__ int add(int a, int b) { return a + b; }
};

template <bool DISCRETE>
__global__ void __launch_bounds__(THREADS)
score_kernel(const uint8_t* __restrict__ seq, long long lp,
             const void* __restrict__ table, int m, int k,
             long long n_scores, void* __restrict__ out) {
  using A = Acc<DISCRETE>;
  using T = typename A::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);  // [m][k], 4-byte entries
  uint8_t* tile = smem + static_cast<size_t>(m) * k * sizeof(T);

  const long long base = static_cast<long long>(blockIdx.x) * TILE;
  const uint8_t wildcard = static_cast<uint8_t>(k - 1);

  for (int i = threadIdx.x; i < m * k; i += blockDim.x) {
    tab[i] = A::load(table, i);
  }
  const int span = TILE + m - 1;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long long g = base + i;
    const uint8_t s = g < lp ? seq[g] : wildcard;
    tile[i] = s < wildcard ? s : wildcard;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < TILE; t += blockDim.x) {
    const long long p = base + t;
    if (p >= lp) {
      break;
    }
    T acc = tab[tile[t]];
    for (int j = 1; j < m; ++j) {
      acc = A::add(acc, tab[j * k + tile[t + j]]);
    }
    if constexpr (DISCRETE) {
      static_cast<int*>(out)[p] = p < n_scores ? min(acc, 255) : -1;
    } else {
      static_cast<float*>(out)[p] = p < n_scores ? acc : -INFINITY;
    }
  }
}

template <bool DISCRETE>
int launch(const void* seq, long long lp, const void* table, int m, int k,
           long long n_scores, void* out, void* stream) {
  const size_t smem = static_cast<size_t>(m) * k * 4 + TILE + m - 1;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        score_kernel<DISCRETE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const long long blocks = (lp + TILE - 1) / TILE;
  score_kernel<DISCRETE><<<static_cast<unsigned int>(blocks), THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), lp, table, m, k, n_scores, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Positions per block, so the caller can size shared memory and grids.
int lm_score_tile() { return TILE; }

// seq: uint8 [lp]; table: float32 [m][k]; out: float32 [lp].
int lm_score_f32(const void* seq, long long lp, const void* table, int m, int k,
                 long long n_scores, void* out, void* stream) {
  return launch<false>(seq, lp, table, m, k, n_scores, out, stream);
}

// seq: uint8 [lp]; table: uint8 [m][k]; out: int32 [lp].
int lm_score_u8(const void* seq, long long lp, const void* table, int m, int k,
                long long n_scores, void* out, void* stream) {
  return launch<true>(seq, lp, table, m, k, n_scores, out, stream);
}

}  // extern "C"
