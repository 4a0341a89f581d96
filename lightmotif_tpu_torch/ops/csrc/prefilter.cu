// Multi-motif prefilter K3 for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lightmotif_tpu/ops/multi_kernel.py::_any8_kernel
// (prefilter_any8).  For every window start p it computes, in int32,
//
//   out[p] = max over motif lanes mo of ( sum_j d16[mo][j][s[p+j]] - t_eff[mo] )
//
// where d16 holds the u16 cells of a motif group (zero for padded rows and
// lanes) and t_eff is the u16 threshold, or 2^26 for a lane that never passes.
// out[p] >= 0 marks a candidate.  The TPU kernel gets the same integers from an
// int8 MXU product of a one-hot window matrix with -128-shifted byte planes;
// those are layout devices of the MXU.  Here the sums are plain table lookups:
// integer arithmetic, so any order gives the same bits, sentinel values
// included.
//
// Inputs: seq uint8 [lp]; table int32 [n_chunks][m][k][CH] with
// table[c][j][s][l] = d16[c*CH + l][j][s]; chunk_m int32 [n_chunks], the rows
// the chunk needs (every row at or past it is zero, so skipping it changes no
// sum); t_eff int32 [n_chunks * CH].
//
// The tail: windows that run past lp read the wildcard (rank k - 1), like the
// scoring kernels, and so does any rank >= k.  The Pallas kernel's last tile
// reads the first tile's head as its halo instead ((i + 1) % grid), so the two
// agree on p < lp - m + 1, the positions a scan uses.
//
// What bounds it: each (position, lane, row) costs one shared-memory table read
// and one integer add -- about 2e11 of them for a JASPAR-sized database against
// a bacterial genome -- against one byte read and four bytes written per
// position.  It is bound by shared-memory bandwidth and the integer pipe.
//
// Design: a block takes TILE = THREADS * PPT consecutive positions and stages
// them, with their (m - 1)-byte halo, in shared memory once.  It then walks the
// group's lane chunks: for each it stages the chunk's rows (CH lanes of int32,
// rows padded to 80 bytes so the K rows of one j fall in different banks) and
// every thread adds, for each of its PPT positions and each row j, the CH lane
// values of that row's symbol into CH register accumulators with 16-byte
// loads.  After the chunk it folds acc - t_eff into a running max.  The block
// writes each position once: no atomics, no second pass.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 16;       // motif lanes per chunk
constexpr int PPT = 4;       // positions per thread
constexpr int THREADS = 256;
constexpr int TILE = THREADS * PPT;
constexpr int ROW = CH + 4;  // int32 per staged (j, symbol) row: 80 bytes

__global__ void __launch_bounds__(THREADS)
any8_kernel(const uint8_t* __restrict__ seq, long long lp,
            const int* __restrict__ table, const int* __restrict__ chunk_m,
            const int* __restrict__ t_eff, int n_chunks, int m, int k,
            int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem);  // [m][k][ROW]
  uint8_t* tile = smem + static_cast<size_t>(m) * k * ROW * sizeof(int);

  const long long base = static_cast<long long>(blockIdx.x) * TILE;
  const uint8_t wildcard = static_cast<uint8_t>(k - 1);
  for (int i = threadIdx.x; i < TILE + m - 1; i += THREADS) {
    const long long g = base + i;
    const uint8_t s = g < lp ? seq[g] : wildcard;
    tile[i] = s < wildcard ? s : wildcard;
  }

  int best[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    best[q] = INT_MIN;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int mc = chunk_m[c];
    __syncthreads();  // the previous chunk's rows are no longer read
    const int4* src = reinterpret_cast<const int4*>(
        table + static_cast<size_t>(c) * m * k * CH);
    for (int i = threadIdx.x; i < mc * k * (CH / 4); i += THREADS) {
      const int row = i / (CH / 4);
      const int v = i % (CH / 4);
      reinterpret_cast<int4*>(tab + row * ROW)[v] = src[i];
    }
    __syncthreads();

    int acc[PPT][CH];
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
#pragma unroll
      for (int l = 0; l < CH; ++l) {
        acc[q][l] = 0;
      }
    }
    for (int j = 0; j < mc; ++j) {
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const int s = tile[threadIdx.x + q * THREADS + j];
        const int4* row = reinterpret_cast<const int4*>(tab + (j * k + s) * ROW);
#pragma unroll
        for (int v = 0; v < CH / 4; ++v) {
          const int4 x = row[v];
          acc[q][4 * v + 0] += x.x;
          acc[q][4 * v + 1] += x.y;
          acc[q][4 * v + 2] += x.z;
          acc[q][4 * v + 3] += x.w;
        }
      }
    }
#pragma unroll
    for (int l = 0; l < CH; ++l) {
      const int t = __ldg(t_eff + c * CH + l);
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        best[q] = max(best[q], acc[q][l] - t);
      }
    }
  }

#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const long long p = base + threadIdx.x + q * THREADS;
    if (p < lp) {
      out[p] = best[q];
    }
  }
}

}  // namespace

extern "C" {

// Lanes per chunk of the table layout, positions per block, and the bytes of
// shared memory per staged (j, symbol) row, so the caller can check its layout
// and size shared memory.
int lm_prefilter_lanes() { return CH; }
int lm_prefilter_tile() { return TILE; }
int lm_prefilter_row_bytes() { return ROW * static_cast<int>(sizeof(int)); }

// seq: uint8 [lp]; table: int32 [n_chunks][m][k][CH]; chunk_m: int32
// [n_chunks]; t_eff: int32 [n_chunks * CH]; out: int32 [lp].
int lm_prefilter_any8(const void* seq, long long lp, const void* table,
                      const void* chunk_m, const void* t_eff, int n_chunks,
                      int m, int k, void* out, void* stream) {
  const size_t smem =
      static_cast<size_t>(m) * k * ROW * sizeof(int) + TILE + m - 1;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        any8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const long long blocks = (lp + TILE - 1) / TILE;
  any8_kernel<<<static_cast<unsigned int>(blocks), THREADS, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), lp, static_cast<const int*>(table),
      static_cast<const int*>(chunk_m), static_cast<const int*>(t_eff),
      n_chunks, m, k, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
