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
// read; pcnt int32 [cap], each row's set bits (lm_phase_c_bits writes it:
// the JAX core's pcnt); cand int64 [cap], the candidates' window starts in
// seq; count int64, the candidate count, on the device; seq uint8 [lp]; pssm
// f32 [M][m][K], th f32 [M].  A lane >= M reads motif M - 1, as the JAX core
// clamps it.
//
// The JAX core's capacities, kept so that its counters come out the same:
// a candidate row contributes its first min(popcount, slots) lanes, slots =
// max(64, min(256, cap_hits / 4096)), and the pairs past cap_hits are
// dropped; hit_need = max(min(pairs, 2^30), listed pairs, rmax > slots ?
// rmax * 4096 : 0), rmax the largest popcount of a row.  A caller re-runs
// with larger capacities while candidates > cap or hit_need > cap_hits.
//
// What bounds it on this card: the bytes, the bit words of the candidate
// rows read once (123 MB at database group 0 of the seeded JASPAR stand-in,
// more than L2 holds) and the kept hits written once; the rescore's m table
// and sequence reads per pair come from L1/L2.  The design, two launches on
// the caller's stream after one memset (no host read; each grid is sized by
// a capacity, and tiles past the work leave at once):
//
// 1. row_offsets: the rows in tiles of 2,048, each tile's listed pairs
//    (min(pcnt, slots)) scanned in the block and across tiles in one pass
//    with decoupled look-back (tiles taken in order from a counter, so a
//    tile waits only on tiles already running): row_off[r], the int64 index
//    of row r's first pair in (position, lane) order, and the totals the
//    counters need (pairs, rmax, listed pairs).  It reads pcnt, never the
//    bits.
// 2. keep_pairs: the pairs in tiles of 256, a thread a pair.  A tile finds
//    the row of its first pair (a 32-way search of row_off by one warp),
//    and its warps walk the rows from there 32 at a time (one read of 32
//    pcnt and row_off values, a ballot of the rows with pairs in the tile),
//    four rows at once, eight lanes a row: a row's 128 words are four
//    16-byte reads a lane, their popcounts a scan over the eight lanes,
//    and each set bit of rank < the row's listed count that falls in the
//    tile goes to its slot in shared memory.  Then every thread rescores
//    its pair -- the sequential ascending-j sum of pssm[lane][j][s[p + j]]
//    with __fadd_rn, from row 0's value (padded rows add +0.0; windows past
//    lp and ranks >= K read the wildcard, rank K - 1), so the compiler never
//    contracts it into FFMA and the scores are the JAX core's bits -- and
//    keeps it if score >= th[lane]; a ballot scan in the block and a second
//    decoupled look-back across tiles give each kept pair its slot, and the
//    kept hits are written front-compacted.  Tile 0 writes the counters,
//    the last tile n_kept.
//
// So the bits are read once (the earlier design read them three times), no
// scan runs in a single block, and the rescore is spread over the pairs,
// 256 at once in a block, not over the rows.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int ROWS_PER_THREAD = 8;
constexpr int SCAN_TILE = SCAN_THREADS * ROWS_PER_THREAD;  // rows per tile of row_offsets
constexpr int PAIR_TILE = 256;  // pairs per tile of keep_pairs, one a thread
constexpr int PAIR_WARPS = PAIR_TILE / 32;
constexpr int GROUP = 8;           // lanes that read one row together
constexpr int ROWS_AT_ONCE = 32 / GROUP;  // rows a warp reads at once
constexpr int WORDS_PER_LANE = 16;  // bit words a lane reads of a row at once
constexpr int LANES_PER_WORD = 16;
constexpr unsigned FULL = 0xffffffffu;

// look-back states: flag in the top two bits, value below
constexpr unsigned long long AGGREGATE = 1ull << 62;
constexpr unsigned long long INCLUSIVE = 2ull << 62;
constexpr unsigned long long VALUE = AGGREGATE - 1;

// hdr words
constexpr int PAIRS = 0, RMAX = 1, LISTED = 2, ROW_TICKET = 3, PAIR_TICKET = 4;
constexpr int HDR_WORDS = 8;

struct Scratch {
  unsigned long long* hdr;         // [HDR_WORDS]
  unsigned long long* row_state;   // [row tiles] look-back states of row_offsets
  unsigned long long* kept_state;  // [pair tiles] look-back states of keep_pairs
  long long* row_off;              // [cap] first pair index of each row
};

long long align16(long long x) { return (x + 15) / 16 * 16; }
long long row_tiles(long long cap) { return (cap + SCAN_TILE - 1) / SCAN_TILE; }
long long pair_tiles(long long cap_hits) { return (cap_hits + PAIR_TILE - 1) / PAIR_TILE; }

// the bytes zeroed before each call: the header and the look-back states
long long zeroed_bytes(long long cap, long long cap_hits) {
  return 8LL * HDR_WORDS + align16(8 * row_tiles(cap)) + align16(8 * pair_tiles(cap_hits));
}

Scratch carve(void* base, long long cap, long long cap_hits) {
  char* p = static_cast<char*>(base);
  Scratch s;
  s.hdr = reinterpret_cast<unsigned long long*>(p);
  p += 8 * HDR_WORDS;
  s.row_state = reinterpret_cast<unsigned long long*>(p);
  p += align16(8 * row_tiles(cap));
  s.kept_state = reinterpret_cast<unsigned long long*>(p);
  p += align16(8 * pair_tiles(cap_hits));
  s.row_off = reinterpret_cast<long long*>(p);
  return s;
}

long long scratch_bytes(long long cap, long long cap_hits) {
  return zeroed_bytes(cap, cap_hits) + align16(8 * cap);
}

__device__ __forceinline__ long long rows_of(const long long* count, long long cap) {
  const long long c = __ldg(count);
  return c < cap ? c : cap;
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Decoupled look-back, by one thread of tile `tile`: publishes the tile's
// aggregate, sums its predecessors' (waiting for each to publish, and
// stopping at the first inclusive prefix), publishes its own inclusive
// prefix and returns the exclusive one.  A state word carries its flag and
// value together, so a relaxed 64-bit load sees both or neither.
__device__ unsigned long long look_back(unsigned long long* state, long long tile,
                                        unsigned long long aggregate) {
  if (tile == 0) {
    st_relaxed(state, INCLUSIVE | aggregate);
    return 0;
  }
  st_relaxed(state + tile, AGGREGATE | aggregate);
  unsigned long long before = 0;
  for (long long t = tile - 1;;) {
    const unsigned long long s = ld_relaxed(state + t);
    if ((s & ~VALUE) == 0) continue;  // not published yet
    before += s & VALUE;
    if ((s & ~VALUE) == INCLUSIVE) break;
    --t;
  }
  st_relaxed(state + tile, INCLUSIVE | (before + aggregate));
  return before;
}

// The tile this block takes, in the order blocks start.
__device__ __forceinline__ long long take_tile(unsigned long long* ticket) {
  __shared__ long long tile;
  if (threadIdx.x == 0) tile = static_cast<long long>(atomicAdd(ticket, 1ull));
  __syncthreads();
  return tile;
}

// Inclusive warp scan of a 64-bit value.
__device__ __forceinline__ long long warp_scan(long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long up = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

__global__ void __launch_bounds__(SCAN_THREADS)
row_offsets(const int* __restrict__ pcnt, const long long* __restrict__ count, long long cap,
            int slots, Scratch s) {
  __shared__ long long warp_sums[SCAN_THREADS / 32];
  __shared__ unsigned long long base;
  const long long n = rows_of(count, cap);
  const long long tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  const long long tile = take_tile(s.hdr + ROW_TICKET);
  if (tile >= tiles) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r0 = tile * SCAN_TILE + threadIdx.x * ROWS_PER_THREAD;
  int listed[ROWS_PER_THREAD];
  unsigned total = 0;
  int top = 0;
  long long mine = 0;
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int pc = r0 + i < n ? __ldg(pcnt + r0 + i) : 0;
    total += static_cast<unsigned>(pc);
    top = pc > top ? pc : top;
    listed[i] = pc < slots ? pc : slots;
    mine += listed[i];
  }
  const long long incl = warp_scan(mine);
  if (lane == 31) warp_sums[warp] = incl;
  total = __reduce_add_sync(FULL, total);
  top = static_cast<int>(__reduce_max_sync(FULL, static_cast<unsigned>(top)));
  if (lane == 0 && total != 0) {
    atomicAdd(s.hdr + PAIRS, static_cast<unsigned long long>(total));
    atomicMax(s.hdr + RMAX, static_cast<unsigned long long>(top));
  }
  __syncthreads();
  long long before = 0, aggregate = 0;
  for (int w = 0; w < SCAN_THREADS / 32; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    aggregate += warp_sums[w];
  }
  if (threadIdx.x == 0) {
    base = look_back(s.row_state, tile, static_cast<unsigned long long>(aggregate));
    if (tile == tiles - 1) s.hdr[LISTED] = base + aggregate;
  }
  __syncthreads();
  long long off = static_cast<long long>(base) + before + incl - mine;
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    if (r0 + i < n) s.row_off[r0 + i] = off;
    off += listed[i];
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

__global__ void __launch_bounds__(PAIR_TILE)
keep_pairs(const int* __restrict__ bits, int n_chunks, const int* __restrict__ pcnt,
           const long long* __restrict__ cand, const long long* __restrict__ count, long long cap,
           long long cap_hits, int slots, const uint8_t* __restrict__ seq, long long lp,
           const float* __restrict__ pssm, const float* __restrict__ th, int n_motifs, int m,
           int k, int* __restrict__ packed, int* __restrict__ counters, Scratch s) {
  __shared__ int q_row[PAIR_TILE];
  __shared__ int q_lane[PAIR_TILE];
  __shared__ int warp_kept[PAIR_WARPS];
  __shared__ long long first_row;
  __shared__ unsigned long long kept_base;
  const long long n = rows_of(count, cap);
  const unsigned long long listed = s.hdr[LISTED];
  const long long n_pairs = listed < static_cast<unsigned long long>(cap_hits)
                                ? static_cast<long long>(listed) : cap_hits;
  const long long tiles = (n_pairs + PAIR_TILE - 1) / PAIR_TILE;
  const long long tile = take_tile(s.hdr + PAIR_TICKET);
  if (tile == 0 && threadIdx.x == 0) {
    const long long c = __ldg(count);
    const unsigned long long pairs = s.hdr[PAIRS];
    const unsigned long long rmax = s.hdr[RMAX];
    unsigned long long need = pairs < (1ull << 30) ? pairs : (1ull << 30);
    need = listed > need ? listed : need;
    if (rmax > static_cast<unsigned long long>(slots)) {
      need = rmax * 4096 > need ? rmax * 4096 : need;
    }
    counters[0] = static_cast<int>(c < INT32_MAX ? c : INT32_MAX);
    counters[1] = static_cast<int>(need < INT32_MAX ? need : INT32_MAX);
    counters[3] = 1;
    if (tiles == 0) counters[2] = 0;
  }
  if (tile >= tiles) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane / GROUP;  // the row group of this lane
  const int gl = lane % GROUP;   // its place in the group
  const long long j0 = tile * PAIR_TILE;
  const long long j1 = j0 + PAIR_TILE < n_pairs ? j0 + PAIR_TILE : n_pairs;

  // the row of pair j0: the last row whose first pair is at or before it
  if (warp == 0) {
    long long lo = 0, hi = n;  // row_off[lo] <= j0; the row is in [lo, hi)
    while (hi - lo > 1) {
      const long long step = (hi - lo + 31) / 32;
      const long long probe = lo + lane * step;
      const unsigned below = __ballot_sync(FULL, probe < hi && s.row_off[probe] <= j0);
      const int last = 31 - __clz(below);  // lane 0's probe, lo, is always below
      const long long nlo = lo + last * step;
      hi = nlo + step < hi ? nlo + step : hi;
      lo = nlo;
    }
    if (lane == 0) first_row = lo;
  }
  __syncthreads();

  // the tile's pairs, each in its slot: warps walk the rows from there, 32
  // at a time, up to the first row whose pairs start past the tile
  for (long long rb = first_row + 32 * warp; rb < n; rb += 32 * PAIR_WARPS) {
    const long long r = rb + lane;
    const long long off = r < n ? s.row_off[r] : LLONG_MAX;
    const int pc = r < n ? __ldg(pcnt + r) : 0;
    const int row_listed = pc < slots ? pc : slots;
    if (__shfl_sync(FULL, off, 0) >= j1) break;
    unsigned rows = __ballot_sync(FULL, row_listed > 0 && off < j1 && off + row_listed > j0);
    while (rows != 0u) {
      // group sub takes the sub-th of the next ROWS_AT_ONCE rows (if any)
      unsigned next = rows;
      for (int t = 0; t < sub && next != 0u; ++t) next &= next - 1;
      const int i = next != 0u ? __ffs(next) - 1 : -1;
      for (int t = 0; t < ROWS_AT_ONCE && rows != 0u; ++t) rows &= rows - 1;
      const long long roff = __shfl_sync(FULL, off, i < 0 ? 0 : i);
      const int listed_i = __shfl_sync(FULL, row_listed, i < 0 ? 0 : i);
      const int limit = i < 0 ? 0 : listed_i;
      const long long row = rb + (i < 0 ? 0 : i);
      const int* w = bits + row * n_chunks;
      int base = 0;
      for (int c0 = 0; c0 < n_chunks; c0 += GROUP * WORDS_PER_LANE) {
        // words c + e of the row, e < 16: ascending lanes within a lane
        const int c = c0 + WORDS_PER_LANE * gl;
        unsigned word[WORDS_PER_LANE];
#pragma unroll
        for (int q = 0; q < WORDS_PER_LANE / 4; ++q) {
          const int cq = c + 4 * q;
          if (base >= limit) {
            word[4 * q] = word[4 * q + 1] = word[4 * q + 2] = word[4 * q + 3] = 0u;
          } else if ((n_chunks & 3) == 0) {
            // rows of whole 16-byte pieces
            const int4 v = cq < n_chunks ? __ldg(reinterpret_cast<const int4*>(w + cq))
                                         : make_int4(0, 0, 0, 0);
            word[4 * q] = v.x;
            word[4 * q + 1] = v.y;
            word[4 * q + 2] = v.z;
            word[4 * q + 3] = v.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              word[4 * q + e] = cq + e < n_chunks ? static_cast<unsigned>(__ldg(w + cq + e)) : 0u;
            }
          }
        }
        int pc_lane = 0;
#pragma unroll
        for (int e = 0; e < WORDS_PER_LANE; ++e) pc_lane += __popc(word[e]);
        int incl = pc_lane;
#pragma unroll
        for (int d = 1; d < GROUP; d <<= 1) {
          const int up = __shfl_up_sync(FULL, incl, d, GROUP);
          if (gl >= d) incl += up;
        }
        int slot = base + incl - pc_lane;  // the rank of this lane's first set bit
#pragma unroll
        for (int e = 0; e < WORDS_PER_LANE; ++e) {
          unsigned v = word[e];
          while (v != 0u && slot < limit) {
            const int b = __ffs(v) - 1;
            v &= v - 1;
            const long long jj = roff + slot;
            if (jj >= j0 && jj < j1) {
              q_row[jj - j0] = static_cast<int>(row);
              q_lane[jj - j0] = (c + e) * LANES_PER_WORD + b;
            }
            ++slot;
          }
        }
        base += __shfl_sync(FULL, incl, GROUP - 1, GROUP);
      }
    }
  }
  __syncthreads();

  // each thread's pair: its exact score and the keep mask
  bool keep = false;
  int pos = 0, mo = 0;
  float score = 0.0f;
  if (j0 + threadIdx.x < j1) {
    const int l = q_lane[threadIdx.x];
    mo = l < n_motifs ? l : n_motifs - 1;
    const long long p = __ldg(cand + q_row[threadIdx.x]);
    pos = static_cast<int>(p);
    score = rescore(seq, lp, pssm + static_cast<long long>(mo) * m * k, p, m, k);
    keep = score >= __ldg(th + mo);
  }
  const unsigned kept = __ballot_sync(FULL, keep);
  if (lane == 0) warp_kept[warp] = __popc(kept);
  __syncthreads();
  int before = 0, aggregate = 0;
  for (int i = 0; i < PAIR_WARPS; ++i) {
    before += i < warp ? warp_kept[i] : 0;
    aggregate += warp_kept[i];
  }
  if (threadIdx.x == 0) {
    kept_base = look_back(s.kept_state, tile, static_cast<unsigned long long>(aggregate));
    if (tile == tiles - 1) counters[2] = static_cast<int>(kept_base + aggregate);
  }
  __syncthreads();
  if (keep) {
    const long long dst = static_cast<long long>(kept_base) + before +
                          __popc(kept & ((1u << lane) - 1u));
    packed[dst] = pos;
    packed[cap_hits + dst] = mo;
    packed[2 * cap_hits + dst] = __float_as_int(score);
  }
}

}  // namespace

extern "C" {

// Bytes of the scratch buffer lm_pairs_rescore takes for these capacities.
long long lm_pairs_scratch(long long cap, long long cap_hits) {
  return cap < 1 || cap_hits < 1 ? -1 : scratch_bytes(cap, cap_hits);
}

// bits int32 [cap][n_chunks]; pcnt int32 [cap] (the rows' set bits); cand
// int64 [cap]; count int64 [1]; seq uint8 [lp]; pssm f32 [n_motifs][m][k];
// th f32 [n_motifs]; scratch of lm_pairs_scratch(cap, cap_hits) bytes
// (16-byte aligned); packed int32 [3][cap_hits] (the kept hits
// front-compacted; the rest is not written); counters int32 [4].  Returns
// the CUDA error of the launches (0 when both were queued).
int lm_pairs_rescore(const void* bits, int n_chunks, const void* pcnt, const void* cand,
                     const void* count, long long cap, long long cap_hits, const void* seq,
                     long long lp, const void* pssm, const void* th, int n_motifs, int m, int k,
                     void* scratch, void* packed, void* counters, void* stream) {
  if (cap < 1 || cap_hits < 1 || n_chunks < 1 || n_motifs < 1 || m < 1 || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = carve(scratch, cap, cap_hits);
  long long slots = cap_hits / 4096;
  slots = slots < 64 ? 64 : (slots > 256 ? 256 : slots);
  cudaError_t err = cudaMemsetAsync(scratch, 0, zeroed_bytes(cap, cap_hits), st);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long* n = static_cast<const long long*>(count);
  row_offsets<<<static_cast<unsigned>(row_tiles(cap)), SCAN_THREADS, 0, st>>>(
      static_cast<const int*>(pcnt), n, cap, static_cast<int>(slots), s);
  keep_pairs<<<static_cast<unsigned>(pair_tiles(cap_hits)), PAIR_TILE, 0, st>>>(
      static_cast<const int*>(bits), n_chunks, static_cast<const int*>(pcnt),
      static_cast<const long long*>(cand), n, cap, cap_hits, static_cast<int>(slots),
      static_cast<const uint8_t*>(seq), lp, static_cast<const float*>(pssm),
      static_cast<const float*>(th), n_motifs, m, k, static_cast<int*>(packed),
      static_cast<int*>(counters), s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
