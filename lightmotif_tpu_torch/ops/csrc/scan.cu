// C3: the one-PSSM scan's compaction, exact rescore and keep, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the XLA code of lightmotif_tpu/ops/xla_ops.py:159-333 that follows
// the discrete pass in scan_segment: threshold_positions (the candidates
// score >= t_scaled, the first cap of them in ascending order, their exact
// count), rescore_positions (the exact f32 score of each), the keep mask
// score >= threshold and the front compaction of the kept hits.  No Pallas
// kernel does this on the TPU; there it is a chain of XLA ops.
//
// Inputs: scores int32 [>= n] (K2's discrete scores; the first n are read),
// seq uint8 [n + m - 1] (the segment and its halo), table f32 [m][k], n the
// segment's window starts, t_scaled, threshold (f32), cap.  Outputs:
// counts int32 [3] = [exact candidate count, n_kept, 1] (n_kept among the
// first cap candidates: the compaction is complete at any density, so valid
// is always 1) and packed int32 [2][cap], the kept hits front-compacted in
// ascending position order, as positions and f32 bits (slots past n_kept
// are not written).  ops/torch_ops.py::scan_compact is its plain version.
//
// What bounds it on this card: the bytes, K2's int32 scores read once (18.6
// MB at a 4.6 Mbp genome, 268 MB at a 2**26-start segment); the candidates'
// m table and sequence reads come from L1/L2 and the kept hits are few.
// The design, three launches on the caller's stream, no host read, no
// atomics, so the result is the same at every run:
//
// 1. tile_counts: the window starts in tiles of 4,096, 16 consecutive
//    starts a thread (four 16-byte reads where the tile is whole); each
//    tile's candidates and, rescoring each, its kept candidates.
// 2. tile_offsets: one block of 1,024 threads scans both counts over the
//    tiles (exclusive, 64-bit) and writes the counters; n_kept here when
//    every candidate fits in cap.
// 3. tile_write: each tile whose first candidate falls below cap reads its
//    scores again, ranks its candidates in position order (a block scan of
//    the threads' counts), rescores those of rank < cap, ranks the kept ones
//    (a second block scan) and writes them at the tile's kept offset.  The
//    tile holding the cap-th candidate writes n_kept.
//
// The rescore is the sequential ascending-j sum from +0.0 with __fadd_rn
// (ranks >= K read the wildcard, rank K - 1), so the compiler never
// contracts it and the bits are those of the JAX rescore_positions; a sum of
// -0.0 terms is +0.0, as there.  Tiles whose rescore runs twice (1 and 3)
// hold candidates only: a tile of none reads its scores and leaves.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr int TILE = THREADS * PER_THREAD;  // window starts a tile
constexpr int SCAN_THREADS = 1024;          // tile_offsets' one block
constexpr unsigned FULL = 0xffffffffu;

long long n_tiles(long long n) { return (n + TILE - 1) / TILE; }
long long align16(long long x) { return (x + 15) / 16 * 16; }

struct Scratch {
  int* cand;            // [tiles] candidates of each tile
  int* kept;            // [tiles] kept candidates of each tile (all of its candidates)
  long long* cand_off;  // [tiles] candidates before each tile
  long long* kept_off;  // [tiles] kept candidates before each tile
};

Scratch carve(void* base, long long tiles) {
  char* p = static_cast<char*>(base);
  Scratch s;
  s.cand_off = reinterpret_cast<long long*>(p);
  p += align16(8 * tiles);
  s.kept_off = reinterpret_cast<long long*>(p);
  p += align16(8 * tiles);
  s.cand = reinterpret_cast<int*>(p);
  p += align16(4 * tiles);
  s.kept = reinterpret_cast<int*>(p);
  return s;
}

long long scratch_bytes(long long n) {
  const long long t = n_tiles(n);
  return 2 * align16(8 * t) + 2 * align16(4 * t) + 16;
}

// The 16 scores of this thread's starts, -1 past n.
__device__ __forceinline__ void load_scores(const int* __restrict__ scores, long long p0,
                                            long long n, int (&v)[PER_THREAD]) {
  if (p0 + PER_THREAD <= n) {
    const int4* q = reinterpret_cast<const int4*>(scores + p0);
#pragma unroll
    for (int i = 0; i < PER_THREAD / 4; ++i) {
      const int4 x = __ldg(q + i);
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) v[i] = p0 + i < n ? __ldg(scores + p0 + i) : -1;
  }
}

// The exact score of the window at p.
__device__ __forceinline__ float rescore(const uint8_t* __restrict__ seq,
                                         const float* __restrict__ w, long long p, int m,
                                         int k) {
  const int wild = k - 1;
  float acc = 0.0f;
  for (int j = 0; j < m; ++j) {
    int sym = seq[p + j];
    sym = sym < wild ? sym : wild;
    acc = __fadd_rn(acc, __ldg(w + j * k + sym));
  }
  return acc;
}

// Exclusive block scan of one value a thread over WARPS warps; *total gets
// the block's sum.  `sums` holds WARPS values; the block is synchronised on
// return, so `sums` may be used again.
template <int WARPS, typename T>
__device__ __forceinline__ T block_scan(T v, T* sums, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  T before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const T s = sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

__global__ void __launch_bounds__(THREADS)
tile_counts(const int* __restrict__ scores, const uint8_t* __restrict__ seq,
            const float* __restrict__ table, int m, int k, long long n, int t_scaled,
            float threshold, Scratch s) {
  __shared__ int sums[THREADS / 32];
  const long long p0 = static_cast<long long>(blockIdx.x) * TILE + threadIdx.x * PER_THREAD;
  int v[PER_THREAD];
  load_scores(scores, p0, n, v);
  int cand = 0, kept = 0;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    if (v[i] >= t_scaled && p0 + i < n) {
      ++cand;
      kept += rescore(seq, table, p0 + i, m, k) >= threshold;
    }
  }
  int total;
  block_scan<THREADS / 32>(cand, sums, &total);
  if (threadIdx.x == 0) s.cand[blockIdx.x] = total;
  block_scan<THREADS / 32>(kept, sums, &total);
  if (threadIdx.x == 0) s.kept[blockIdx.x] = total;
}

__global__ void __launch_bounds__(SCAN_THREADS)
tile_offsets(long long tiles, long long cap, Scratch s, int* __restrict__ counts) {
  __shared__ long long sums[SCAN_THREADS / 32];
  long long cand_base = 0, kept_base = 0;
  for (long long t0 = 0; t0 < tiles; t0 += SCAN_THREADS) {
    const long long t = t0 + threadIdx.x;
    const long long c = t < tiles ? s.cand[t] : 0;
    const long long kk = t < tiles ? s.kept[t] : 0;
    long long c_all, k_all;
    const long long c_before = block_scan<SCAN_THREADS / 32>(c, sums, &c_all);
    const long long k_before = block_scan<SCAN_THREADS / 32>(kk, sums, &k_all);
    if (t < tiles) {
      s.cand_off[t] = cand_base + c_before;
      s.kept_off[t] = kept_base + k_before;
    }
    cand_base += c_all;
    kept_base += k_all;
  }
  if (threadIdx.x == 0) {
    counts[0] = static_cast<int>(cand_base < INT_MAX ? cand_base : INT_MAX);
    if (cand_base <= cap) counts[1] = static_cast<int>(kept_base);
    counts[2] = 1;
  }
}

__global__ void __launch_bounds__(THREADS)
tile_write(const int* __restrict__ scores, const uint8_t* __restrict__ seq,
           const float* __restrict__ table, int m, int k, long long n, int t_scaled,
           float threshold, long long cap, Scratch s, int* __restrict__ counts,
           int* __restrict__ packed) {
  __shared__ int sums[THREADS / 32];
  const long long tile = blockIdx.x;
  const int c_tile = s.cand[tile];
  const long long c_off = s.cand_off[tile];
  const long long k_off = s.kept_off[tile];
  if (c_tile == 0 || c_off > cap) return;
  if (c_off == cap) {  // the cap-th candidate is this tile's first: none of it is kept
    if (threadIdx.x == 0) counts[1] = static_cast<int>(k_off);
    return;
  }
  const long long p0 = tile * TILE + threadIdx.x * PER_THREAD;
  int v[PER_THREAD];
  load_scores(scores, p0, n, v);
  int cand = 0;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) cand += v[i] >= t_scaled && p0 + i < n;
  int total;
  const long long rank0 = c_off + block_scan<THREADS / 32>(cand, sums, &total);
  // rescore this thread's candidates of rank < cap, in position order
  float sc[PER_THREAD];
  unsigned keep = 0u;
  int kept = 0;
  long long rank = rank0;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    sc[i] = 0.0f;
    if (v[i] >= t_scaled && p0 + i < n) {
      if (rank < cap) {
        sc[i] = rescore(seq, table, p0 + i, m, k);
        if (sc[i] >= threshold) {
          keep |= 1u << i;
          ++kept;
        }
      }
      ++rank;
    }
  }
  long long dst = k_off + block_scan<THREADS / 32>(kept, sums, &total);
  if (threadIdx.x == 0 && c_off + c_tile > cap) counts[1] = static_cast<int>(k_off + total);
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    if (keep & (1u << i)) {
      packed[dst] = static_cast<int>(p0 + i);
      packed[cap + dst] = __float_as_int(sc[i]);
      ++dst;
    }
  }
}

}  // namespace

extern "C" {

// Bytes of the scratch buffer lm_scan_compact takes for n window starts
// (16-byte aligned), or -1 for n < 0.
long long lm_scan_scratch(long long n) { return n < 0 ? -1 : scratch_bytes(n); }

// scores int32 [>= n], 16-byte aligned; seq uint8 [n + m - 1]; table f32
// [m][k]; scratch of lm_scan_scratch(n) bytes, 16-byte aligned; counts int32
// [3]; packed int32 [2][cap].  Returns the CUDA error of the launches (0
// when all three were queued).
int lm_scan_compact(const void* scores, const void* seq, const void* table, int m, int k,
                    long long n, int t_scaled, float threshold, long long cap, void* scratch,
                    void* counts, void* packed, void* stream) {
  if (n < 0 || n > INT_MAX || cap < 1 || m < 1 || k < 2 || k > 256 ||
      (reinterpret_cast<uintptr_t>(scores) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = n_tiles(n);
  const Scratch s = carve(scratch, tiles);
  const int* sc = static_cast<const int*>(scores);
  const uint8_t* sq = static_cast<const uint8_t*>(seq);
  const float* w = static_cast<const float*>(table);
  int* c = static_cast<int*>(counts);
  if (tiles > 0) {
    tile_counts<<<static_cast<unsigned>(tiles), THREADS, 0, st>>>(sc, sq, w, m, k, n, t_scaled,
                                                                  threshold, s);
  }
  tile_offsets<<<1, SCAN_THREADS, 0, st>>>(tiles, cap, s, c);
  if (tiles > 0) {
    tile_write<<<static_cast<unsigned>(tiles), THREADS, 0, st>>>(
        sc, sq, w, m, k, n, t_scaled, threshold, cap, s, c, static_cast<int*>(packed));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
