// The database scan's pairs and exact rescore for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA code of lightmotif_tpu/ops/multi.py::scan_multi_core that
// follows phase C (:975-1080): the extraction of (candidate, motif lane)
// pairs from the per-candidate hit words, their exact f32 rescore
// (rescore_multi), the keep mask score >= threshold[lane], and the front
// compaction of the kept hits into packed[3, cap_hits] in (position, lane)
// order, with the counters [candidates, hit_need, n_kept, valid].  No Pallas
// kernel does this on the TPU; there it is a chain of XLA ops.
//
// Inputs: bits int32 [cap][n_chunks] from lm_phase_c_bits (bit l of word c:
// lane 16c + l passes), of which the first n = min(*count, cap) rows are
// read; cand int64 [cap], the candidates' window starts in seq; count int64,
// the candidate count, on the device; seq uint8 [lp]; pssm f32 [M][m][K], th
// f32 [M].  A lane >= M reads motif M - 1, as the JAX core clamps it.
//
// The JAX core's capacities, kept so that its counters come out the same:
// a candidate row contributes its first min(popcount, slots) lanes, slots =
// max(64, min(256, cap_hits / 4096)), and the pairs past cap_hits are
// dropped; hit_need = max(min(pairs, 2^30), listed pairs, rmax > slots ?
// rmax * 4096 : 0), rmax the largest popcount of a row.  A caller re-runs
// with larger capacities while candidates > cap or hit_need > cap_hits.
//
// The steps, five launches on the caller's stream (no host read; each grid
// is sized by cap, and rows past the count do nothing):
//
// 1. row_counts, a warp per candidate row and 8 rows a block: popcount of
//    the row's words (a lane a word, coalesced), min(., slots) stored; the
//    block's listed pairs summed, and its pair total and rmax added once;
// 2. scan_blocks, one block: exclusive scan of the blocks' listed pairs
//    into int64 block offsets (the order of the pairs is (row, lane):
//    ascending (position, lane), since the candidates ascend);
// 3. score_rows, a warp per row: its first pair at its block's offset plus
//    the listed pairs of the block's earlier rows; the row's words in
//    groups of 32, a warp scan of their popcounts gives each lane's first
//    slot, and each lane walks its word's set bits (ascending lanes) and,
//    for the slots inside the row's listed count and below cap_hits,
//    computes the exact score: the sequential ascending-j sum of
//    pssm[lane][j][s[p + j]] with __fadd_rn, from row 0's value (padded
//    rows add +0.0; windows past lp and ranks >= K read the wildcard, rank
//    K - 1); it stores the score by pair index and counts the row's kept
//    pairs, and the block's;
// 4. scan_blocks again, over the blocks' kept counts: each block's first
//    kept slot, and n_kept; its last thread writes the counters;
// 5. write_rows, a warp per row: the same walk, each kept pair written to
//    packed[:, its kept slot] (position, lane, f32 bits).
//
// What bounds it: the bytes, the bits of the listed rows read twice and the
// packed hits written once (the pair scores go through a scratch buffer the
// size of cap_hits); the rescore's m table reads per pair come from L1/L2.
// The adds are __fadd_rn, so the compiler never contracts them into FFMA,
// and the order is the JAX core's: bit-identical scores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_WARPS = 8;  // candidate rows per block of the row kernels
constexpr int SCAN_THREADS = 1024;
constexpr int LANES_PER_WORD = 16;
constexpr unsigned FULL = 0xffffffffu;

struct Scratch {
  int* listed;              // [cap] pairs listed per row: min(popcount, slots)
  int* kept;                // [cap] kept pairs per row
  int* block_listed;        // [blocks] listed pairs per block of ROW_WARPS rows
  int* block_kept;          // [blocks] kept pairs per block
  long long* pair_off;      // [blocks] first pair index of each block
  long long* kept_off;      // [blocks] first kept slot of each block
  float* score;             // [cap_hits] the score of each listed pair
  unsigned long long* tot;  // [4]: pair total, rmax, listed pairs, n_kept
};

long long align16(long long x) { return (x + 15) / 16 * 16; }

long long blocks_of(long long cap) { return (cap + ROW_WARPS - 1) / ROW_WARPS; }

Scratch carve(void* base, long long cap, long long cap_hits) {
  const long long nb = blocks_of(cap);
  char* p = static_cast<char*>(base);
  Scratch s;
  s.tot = reinterpret_cast<unsigned long long*>(p);
  p += 64;
  s.pair_off = reinterpret_cast<long long*>(p);
  p += align16(8 * nb);
  s.kept_off = reinterpret_cast<long long*>(p);
  p += align16(8 * nb);
  s.block_listed = reinterpret_cast<int*>(p);
  p += align16(4 * nb);
  s.block_kept = reinterpret_cast<int*>(p);
  p += align16(4 * nb);
  s.listed = reinterpret_cast<int*>(p);
  p += align16(4 * cap);
  s.kept = reinterpret_cast<int*>(p);
  p += align16(4 * cap);
  s.score = reinterpret_cast<float*>(p);
  return s;
}

long long scratch_bytes(long long cap, long long cap_hits) {
  const long long nb = blocks_of(cap);
  return 64 + 2 * align16(8 * nb) + 2 * align16(4 * nb) + 2 * align16(4 * cap) +
         align16(4 * cap_hits);
}

__device__ __forceinline__ long long rows_of(const long long* count, long long cap) {
  const long long c = __ldg(count);
  return c < cap ? c : cap;
}

__global__ void __launch_bounds__(32 * ROW_WARPS)
row_counts(const int* __restrict__ bits, int n_chunks, const long long* __restrict__ count,
           long long cap, int slots, Scratch s) {
  __shared__ int part[ROW_WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * ROW_WARPS + warp;
  const long long n = rows_of(count, cap);
  int pc = 0;
  if (row < n) {
    const int* w = bits + row * n_chunks;
    for (int c = lane; c < n_chunks; c += 32) pc += __popc(static_cast<unsigned>(w[c]));
    pc = __reduce_add_sync(FULL, pc);
    if (lane == 0) s.listed[row] = pc < slots ? pc : slots;
  }
  if (lane == 0) part[warp] = pc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0, top = 0;
    int listed = 0;
    for (int i = 0; i < ROW_WARPS; ++i) {
      sum += static_cast<unsigned long long>(part[i]);
      top = static_cast<unsigned long long>(part[i]) > top ? part[i] : top;
      listed += part[i] < slots ? part[i] : slots;
    }
    s.block_listed[blockIdx.x] = listed;
    if (sum) {
      atomicAdd(s.tot + 0, sum);
      atomicMax(s.tot + 1, top);
    }
  }
}

// Exclusive scan of in[0:n] into out[0:n] (int64), n the blocks of rows
// that hold candidates, by one block of SCAN_THREADS threads, each over a
// contiguous range; the total goes to *total.  With counters, the last
// thread also writes the core's counters.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_blocks(const int* __restrict__ in, long long* __restrict__ out,
            const long long* __restrict__ count, long long cap, unsigned long long* total,
            int* counters, Scratch s, int slots) {
  __shared__ long long sums[SCAN_THREADS];
  const long long n = (rows_of(count, cap) + ROW_WARPS - 1) / ROW_WARPS;
  const long long per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  const long long lo = threadIdx.x * per;
  const long long hi = lo + per < n ? lo + per : n;
  long long mine = 0;
  for (long long i = lo; i < hi; ++i) mine += in[i];
  sums[threadIdx.x] = mine;
  __syncthreads();
  // Hillis-Steele inclusive scan of the per-thread sums
  for (int d = 1; d < SCAN_THREADS; d <<= 1) {
    const long long add = threadIdx.x >= d ? sums[threadIdx.x - d] : 0;
    __syncthreads();
    sums[threadIdx.x] += add;
    __syncthreads();
  }
  long long run = sums[threadIdx.x] - mine;
  for (long long i = lo; i < hi; ++i) {
    out[i] = run;
    run += in[i];
  }
  if (threadIdx.x == SCAN_THREADS - 1) {
    *total = static_cast<unsigned long long>(sums[SCAN_THREADS - 1]);
    if (counters != nullptr) {
      const long long c = __ldg(count);
      const unsigned long long pairs = s.tot[0];
      const unsigned long long rmax = s.tot[1];
      const unsigned long long listed = s.tot[2];
      unsigned long long need = pairs < (1ull << 30) ? pairs : (1ull << 30);
      need = listed > need ? listed : need;
      if (rmax > static_cast<unsigned long long>(slots)) {
        need = rmax * 4096 > need ? rmax * 4096 : need;
      }
      counters[0] = static_cast<int>(c < INT32_MAX ? c : INT32_MAX);
      counters[1] = static_cast<int>(need < INT32_MAX ? need : INT32_MAX);
      counters[2] = static_cast<int>(sums[SCAN_THREADS - 1]);
      counters[3] = 1;
    }
  }
}

// The exact score of one pair.
__device__ __forceinline__ float rescore(const uint8_t* __restrict__ seq, long long lp,
                                         const float* __restrict__ w, long long p, int m,
                                         int k) {
  const int wild = k - 1;
  float acc = 0.0f;
  for (int j = 0; j < m; ++j) {
    const long long q = p + j;
    int sym = q < lp ? seq[q] : wild;
    sym = sym < wild ? sym : wild;
    const float v = __ldg(w + j * k + sym);
    acc = j == 0 ? v : __fadd_rn(acc, v);
  }
  return acc;
}

// Visit the listed pairs of one row below cap_hits in (lane) order: fn(slot,
// lane) by the warp lane that holds the lane's word.  Returns nothing; every
// warp lane takes part.
template <typename Fn>
__device__ __forceinline__ void walk_row(const int* __restrict__ w, int n_chunks, int limit,
                                         Fn fn) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int c0 = 0; c0 < n_chunks && base < limit; c0 += 32) {
    unsigned word = c0 + lane < n_chunks ? static_cast<unsigned>(w[c0 + lane]) : 0u;
    const int pc = __popc(word);
    int incl = pc;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += up;
    }
    int slot = base + incl - pc;
    while (word != 0u && slot < limit) {
      const int b = __ffs(word) - 1;
      word &= word - 1;
      fn(slot, (c0 + lane) * LANES_PER_WORD + b);
      ++slot;
    }
    base += __shfl_sync(FULL, incl, 31);
  }
}

// The sum of v[row0 .. row0 + warp) (the block's earlier rows).
__device__ __forceinline__ int before(const int* __restrict__ v, long long row0, int warp) {
  int sum = 0;
  for (int i = 0; i < warp; ++i) sum += v[row0 + i];
  return sum;
}

__global__ void __launch_bounds__(32 * ROW_WARPS)
score_rows(const int* __restrict__ bits, int n_chunks, const long long* __restrict__ cand,
           const long long* __restrict__ count, long long cap, long long cap_hits,
           const uint8_t* __restrict__ seq, long long lp, const float* __restrict__ pssm,
           const float* __restrict__ th, int n_motifs, int m, int k, Scratch s) {
  __shared__ int part[ROW_WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROW_WARPS;
  const long long row = row0 + warp;
  const long long n = rows_of(count, cap);
  if (row0 >= n) return;  // the whole block
  int kept = 0;
  if (row < n) {
    const long long off = s.pair_off[blockIdx.x] + before(s.listed, row0, warp);
    const long long room = cap_hits - off;
    const int listed = s.listed[row];
    const int limit = room <= 0 ? 0 : (room < listed ? static_cast<int>(room) : listed);
    const long long p = cand[row];
    walk_row(bits + row * n_chunks, n_chunks, limit, [&](int slot, int l) {
      const int mo = l < n_motifs ? l : n_motifs - 1;
      const float sc = rescore(seq, lp, pssm + static_cast<long long>(mo) * m * k, p, m, k);
      s.score[off + slot] = sc;
      kept += sc >= __ldg(th + mo);
    });
    kept = __reduce_add_sync(FULL, kept);
    if (lane == 0) s.kept[row] = kept;
  }
  if (lane == 0) part[warp] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int i = 0; i < ROW_WARPS; ++i) sum += part[i];
    s.block_kept[blockIdx.x] = sum;
  }
}

__global__ void __launch_bounds__(32 * ROW_WARPS)
write_rows(const int* __restrict__ bits, int n_chunks, const long long* __restrict__ cand,
           const long long* __restrict__ count, long long cap, long long cap_hits,
           const float* __restrict__ th, int n_motifs, int* __restrict__ packed, Scratch s) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROW_WARPS;
  const long long row = row0 + warp;
  if (row >= rows_of(count, cap) || s.kept[row] == 0) return;
  const long long off = s.pair_off[blockIdx.x] + before(s.listed, row0, warp);
  const long long room = cap_hits - off;
  const int listed = s.listed[row];
  const int limit = room <= 0 ? 0 : (room < listed ? static_cast<int>(room) : listed);
  const int pos = static_cast<int>(cand[row]);
  const int* w = bits + row * n_chunks;
  // group by group of 32 words (a word a warp lane): each lane counts the
  // kept pairs among its word's listed slots, a warp scan of those counts
  // gives its first kept slot, and a second pass over the word writes them
  long long at = s.kept_off[blockIdx.x] + before(s.kept, row0, warp);
  int base = 0;
  for (int c0 = 0; c0 < n_chunks && base < limit; c0 += 32) {
    unsigned word = c0 + lane < n_chunks ? static_cast<unsigned>(w[c0 + lane]) : 0u;
    const int pc = __popc(word);
    int pincl = pc;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(FULL, pincl, d);
      if (lane >= d) pincl += up;
    }
    // this lane's listed pairs in the group and how many it keeps
    int slot = base + pincl - pc;
    unsigned rest = word;
    int keep_here = 0;
    while (rest != 0u && slot < limit) {
      const int b = __ffs(rest) - 1;
      rest &= rest - 1;
      const int l = (c0 + lane) * LANES_PER_WORD + b;
      const int mo = l < n_motifs ? l : n_motifs - 1;
      keep_here += s.score[off + slot] >= __ldg(th + mo);
      ++slot;
    }
    int kincl = keep_here;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(FULL, kincl, d);
      if (lane >= d) kincl += up;
    }
    long long dst = at + kincl - keep_here;
    slot = base + pincl - pc;
    rest = word;
    while (rest != 0u && slot < limit) {
      const int b = __ffs(rest) - 1;
      rest &= rest - 1;
      const int l = (c0 + lane) * LANES_PER_WORD + b;
      const int mo = l < n_motifs ? l : n_motifs - 1;
      const float sc = s.score[off + slot];
      if (sc >= __ldg(th + mo)) {
        packed[dst] = pos;
        packed[cap_hits + dst] = mo;
        packed[2 * cap_hits + dst] = __float_as_int(sc);
        ++dst;
      }
      ++slot;
    }
    at += __shfl_sync(FULL, kincl, 31);
    base += __shfl_sync(FULL, pincl, 31);
  }
}

}  // namespace

extern "C" {

// Bytes of the scratch buffer lm_pairs_rescore takes for these capacities.
long long lm_pairs_scratch(long long cap, long long cap_hits) {
  return cap < 1 || cap_hits < 1 ? -1 : scratch_bytes(cap, cap_hits);
}

// bits int32 [cap][n_chunks]; cand int64 [cap]; count int64 [1]; seq uint8
// [lp]; pssm f32 [n_motifs][m][k]; th f32 [n_motifs]; scratch of
// lm_pairs_scratch(cap, cap_hits) bytes (16-byte aligned); packed int32 [3]
// [cap_hits] (the kept hits front-compacted; the rest is not written);
// counters int32 [4].  Returns the CUDA error of the launches (0 when all
// five were queued).
int lm_pairs_rescore(const void* bits, int n_chunks, const void* cand, const void* count,
                     long long cap, long long cap_hits, const void* seq, long long lp,
                     const void* pssm, const void* th, int n_motifs, int m, int k,
                     void* scratch, void* packed, void* counters, void* stream) {
  if (cap < 1 || cap_hits < 1 || n_chunks < 1 || n_motifs < 1 || m < 1 || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = carve(scratch, cap, cap_hits);
  long long slots = cap_hits / 4096;
  slots = slots < 64 ? 64 : (slots > 256 ? 256 : slots);
  cudaError_t err = cudaMemsetAsync(s.tot, 0, 64, st);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const unsigned row_blocks = static_cast<unsigned>((cap + ROW_WARPS - 1) / ROW_WARPS);
  const int* b = static_cast<const int*>(bits);
  const long long* c = static_cast<const long long*>(cand);
  const long long* n = static_cast<const long long*>(count);
  row_counts<<<row_blocks, 32 * ROW_WARPS, 0, st>>>(b, n_chunks, n, cap,
                                                     static_cast<int>(slots), s);
  scan_blocks<<<1, SCAN_THREADS, 0, st>>>(s.block_listed, s.pair_off, n, cap, s.tot + 2,
                                          nullptr, s, static_cast<int>(slots));
  score_rows<<<row_blocks, 32 * ROW_WARPS, 0, st>>>(
      b, n_chunks, c, n, cap, cap_hits, static_cast<const uint8_t*>(seq), lp,
      static_cast<const float*>(pssm), static_cast<const float*>(th), n_motifs, m, k, s);
  scan_blocks<<<1, SCAN_THREADS, 0, st>>>(s.block_kept, s.kept_off, n, cap, s.tot + 3,
                                          static_cast<int*>(counters), s,
                                          static_cast<int>(slots));
  write_rows<<<row_blocks, 32 * ROW_WARPS, 0, st>>>(b, n_chunks, c, n, cap, cap_hits,
                                                     static_cast<const float*>(th), n_motifs,
                                                     static_cast<int*>(packed), s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
