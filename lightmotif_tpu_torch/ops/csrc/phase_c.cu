// Phase C of the database scan for NVIDIA Hopper (sm_90a): the exact test of
// every (candidate, motif lane) on the int8 tensor cores.
//
// Replaces the XLA code of lightmotif_tpu/ops/multi.py::scan_multi_core's
// phase_c (:868), which tests every (candidate, lane) with one-hot matmuls
// against the u16 byte planes (or the u8 cells) and phase C's thresholds.
// Here the same test is the same exact integer sum,
//
//   sum_q 256^q (X B_q)[i][lane] - t_eff[lane] >= 0  and  cand[i] < n_valid[lane],
//
// X the one-hot windows of the candidates, B_q the byte planes of the group's
// shifted cells (ops/multi.py::_plane_table), on
// mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32; every sum is exact in any
// order (prefilter.cu says why).  Bit l of word c of row i is set where lane
// 16c + l passes at candidate i.  Each row's popcount is added to pcnt[i]
// (zeroed first), the JAX core's pcnt, so that the pairs kernel (pairs.cu)
// needs no pass of its own over the bits.
//
// What bounds it on this card: the MMA work, 2 * P * candidates * K * 16 *
// sum(chunk_m) int8 operations, and the bits it writes, 4 bytes per candidate
// and lane chunk (123 MB at database group 0 of the seeded JASPAR stand-in).
// The earlier kernel (the tensor-core prefilter's gather form) took a block of
// 256 candidates through all 128 lane chunks in a serial chain, restaging the
// planes for every block.  Timed on the card by candidate count (PERF.md,
// section 6), that chain, not the MMA work, set its time; here the MMAs come
// in independent chains, and what is left is each warp's in-order run of
// shared-memory loads, shuffles and stores per chunk, and the work done once
// per tile and slice.  What the design does about it:
//
// * A 2-D grid: lane-chunk slices (blockIdx.y) x persistent blocks over the
//   candidates (blockIdx.x), one wave of them.  A block stages its slice of
//   the planes in shared memory once (cp.async), so the planes cross L2 once
//   per block and not once per candidate tile, and every slice's blocks spread
//   over the card however few candidates a group has.
// * Everything after that is the warp's own: a warp takes tiles of 32
//   candidates (two 16-row fragments: candidates are the M rows of the
//   product, X is operand A, a lane chunk's 16 lanes two 8-lane N tiles),
//   builds their one-hot runs (one word-aligned run per candidate, 8 * ks + 4
//   words, so that the eight candidates of a fragment load from distinct
//   banks; a flat loop over (candidate, row), from windows copied with
//   cp.async while the warp computed the tile before), keeps the first KSR
//   k-steps of X in registers, and walks its slice's chunks.  No
//   __syncthreads after the planes arrive.
// * Every chunk of a slice runs the k-steps of the slice's deepest chunk
//   (chunk_m), its planes staged that deep with zero cells past its rows, so
//   the walk has no branch: for one or two planes and up to KSR k-steps it is
//   code compiled for them, two chunks at a time, so one chunk's epilogue
//   overlaps the other's MMAs; the planes from the top byte down (Horner).
// * The epilogue: each thread owns one candidate row of the tile.  The
//   accumulators of a fragment hold two candidates x 4 lanes per thread; their
//   pass bits are packed into one word (candidate grp in the low half, grp + 8
//   in the high half) and ORed across the quad with two shuffles, so each
//   thread then holds its own row's word, masks it by n_valid (one compare
//   against the chunk's smallest valid window; lane by lane only near the
//   sequence's end), adds its popcount and stages it in shared memory.  After
//   the slice, the warp stores the tile's staged words row by row, coalesced
//   (whole 32-byte sectors), and adds each row's popcount to pcnt.
//
// Rows at or past min(*count, cap) are not written: the count is read on the
// device, the grid is sized by cap and the card's SMs, and the host reads
// nothing.  The geometry (slice, warps a block, blocks an SM) is chosen on
// the host from the shared memory it needs (the slice's planes, and per warp
// its runs, staged words, windows and positions) and from the MMA work a
// rebuild of the runs buys (choose).
//
// Inputs: seq uint8 [lp]; cand int64 [cap] (ascending window starts, the
// first min(*count, cap) of them); planes uint8 [P][n_chunks][16][rows][K]
// (rows * K a multiple of 16); chunk_m int32 [n_chunks]; t_eff, n_valid int32
// [n_chunks * 16].  Windows that run past lp read the wildcard (rank K - 1),
// and so does any rank >= K.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_attrs.cuh"

namespace {

constexpr int CH = 16;         // motif lanes per chunk: one pass-bit word
constexpr int MAX_PLANES = 4;
constexpr int KSR = 3;         // k-steps of X each thread keeps in registers
constexpr int TILE = 32;       // candidates of a warp's tile
constexpr int NF = TILE / 16;  // 16-candidate fragments of a tile
constexpr int MAX_WARPS = 8;
constexpr int MAX_SLICE = 32;  // lane chunks of a slice, at most
constexpr int SMEM_2 = 113 * 1024;  // a block's share when two fit on an SM
constexpr int SMEM_1 = 232448;      // the most one block may use

// ---------------------------------------------------------------------------
// Geometry, the same on the host and the device.

struct Geom {
  int ks_max;    // 32-deep k-steps of the deepest lane: ceil(rows * K / 32)
  int ls;        // staged bytes per lane and plane: ks_max * 32 + 16
  int cw;        // words per candidate run: 8 * max(ks_max, KSR) + 4
  int wwords;    // words of a candidate's window as copied: (rows + 6) / 4, odd
  int slice;     // lane chunks per slice, a power of two
  int lg_slice;  // log2(slice)
  int warps;     // warps per block
  int per_sm;    // blocks an SM holds, as their shared memory allows
  long long planes_bytes;  // min(slice, n_chunks) * P * 16 * ls
  long long meta_bytes;    // per slice chunk: 16 thresholds, 16 windows, lo, mask
  long long warp_bytes;    // per warp: runs, staged words, windows, positions
  long long smem;
};

__host__ __device__ inline long long round16(long long x) { return (x + 15) / 16 * 16; }

__host__ __device__ inline Geom geom_of(int rows, int k, int planes, int n_chunks, int slice,
                                        int warps, int per_sm) {
  Geom g;
  g.ks_max = (rows * k + 31) / 32;
  g.ls = g.ks_max * 32 + 16;
  g.cw = 8 * (g.ks_max > KSR ? g.ks_max : KSR) + 4;
  g.wwords = (rows + 6) / 4 | 1;
  g.slice = slice;
  g.lg_slice = 0;
  while ((1 << g.lg_slice) < slice) ++g.lg_slice;
  g.warps = warps;
  g.per_sm = per_sm;
  const int held = slice < n_chunks ? slice : n_chunks;
  g.planes_bytes = static_cast<long long>(held) * planes * CH * g.ls;
  g.meta_bytes = round16(4LL * slice * (2 * CH + 2));
  // staged words: TILE rows of slice + 1 words (an odd stride: the 32 rows
  // of one chunk land in distinct banks)
  g.warp_bytes = 4LL * TILE * g.cw + round16(4LL * TILE * (slice + 1)) +
                 round16(4LL * TILE * g.wwords) + 8LL * TILE;
  g.smem = g.planes_bytes + g.meta_bytes + warps * g.warp_bytes;
  return g;
}

// k-steps of MMAs a rebuild of a tile's runs should buy (slice x k-steps):
// below it the rebuilds, one per tile and slice, outweigh the MMAs
constexpr int WORK_PER_BUILD = 48;

// The geometry of a launch: for each count of warps a block and blocks an
// SM, the largest slice that fits (at most MAX_SLICE, and not past the
// chunks); of those, the most warps an SM runs, counted in full only where
// a slice buys WORK_PER_BUILD k-steps a rebuild, else in proportion; the
// larger slice on a tie.  slice_hint > 0 asks for that slice.  smem < 0
// where nothing fits.
Geom choose(int rows, int k, int planes, int n_chunks, int slice_hint) {
  int top = 1;
  while (top < n_chunks && top < MAX_SLICE) top *= 2;
  Geom best = geom_of(rows, k, planes, n_chunks, 1, 1, 1);
  best.smem = -1;
  long long best_score = 0;
  for (int per_sm = 2; per_sm >= 1; --per_sm) {
    const long long target = per_sm == 2 ? SMEM_2 : SMEM_1;
    for (int warps = MAX_WARPS; warps >= 1; warps /= 2) {
      for (int slice = top; slice >= 1; slice /= 2) {
        if (slice_hint > 0 && slice != slice_hint) continue;
        const Geom g = geom_of(rows, k, planes, n_chunks, slice, warps, per_sm);
        if (g.smem > target) continue;
        const int work = slice * g.ks_max;
        const long long score = static_cast<long long>(per_sm) * warps *
                                (work < WORK_PER_BUILD ? work : WORK_PER_BUILD);
        if (score > best_score || (score == best_score && slice > best.slice)) {
          best = g;
          best_score = score;
        }
        break;  // the largest slice of these warps
      }
    }
  }
  return best;
}

__device__ __forceinline__ int ksteps(int mc, int k, int ks_max) {
  const int ks = (mc * k + 31) / 32;
  return ks < ks_max ? ks : ks_max;
}

// ---------------------------------------------------------------------------
// PTX wrappers.

__device__ __forceinline__ void mma_u8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared; src_bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(src_bytes));
}

// 4 bytes global -> shared, of which src_bytes are read (the rest zero)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---------------------------------------------------------------------------
// The MMAs of one chunk.  acc[f][nt][r]: candidate 16f + grp (r < 2) or
// 16f + grp + 8 (r >= 2) of the tile, lane 8nt + 2tig + (r & 1) of the chunk.

using Acc = int[NF][2][4];
using XFrag = unsigned[NF][4];

// X fragments of k-step ks from the runs: A of m16n8k32 (w: this thread's
// first word, run grp at word tig; cw: words per run)
__device__ __forceinline__ void x_frags(XFrag& x, const uint32_t* w, int ks, int cw) {
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const uint32_t* p = w + 16 * f * cw + 8 * ks;
    x[f][0] = p[0];
    x[f][1] = p[8 * cw];
    x[f][2] = p[4];
    x[f][3] = p[8 * cw + 4];
  }
}

__device__ __forceinline__ void mma_step(Acc& acc, const XFrag& x, const unsigned (&b)[4]) {
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    mma_u8(acc[f][0], x[f], b[0], b[1]);
    mma_u8(acc[f][1], x[f], b[2], b[3]);
  }
}

// Per thread's view of a warp's tile while it walks the slice's chunks.
struct Walk {
  const unsigned char* b;  // this thread's ldmatrix base in the slice's chunk 0
  int chunk_bytes;         // staged bytes per chunk (every plane)
  int plane_bytes;         // staged bytes per plane of a chunk
  const int* t_s;          // [slice][16]: -t_eff
  const int* nv_s;         // [slice][16]: n_valid
  const int2* reach_s;     // [slice]: a chunk's smallest positive n_valid, and
                           // the mask of its lanes with a positive n_valid
  uint32_t* staged;        // [TILE][row_words]: the tile's words of the slice
  int row_words;
  const uint32_t* xw;      // this thread's first word of the runs
  int cw;
  int tig, own;            // the thread's place in its quad; its row of the tile
  long long p_own;         // that row's candidate (-1 past the count)
  int n_here;              // the slice's chunks
};

// -t_eff of lanes 8nt + 2tig + (r & 1) of chunk j (two 8-byte loads)
__device__ __forceinline__ void thresholds(int (&tv)[2][4], const Walk& w, int j) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int2 t = *reinterpret_cast<const int2*>(w.t_s + j * CH + 8 * nt + 2 * w.tig);
    tv[nt][0] = tv[nt][2] = t.x;
    tv[nt][1] = tv[nt][3] = t.y;
  }
}

// sum - t_eff of chunk j at KS k-steps (X in registers) and P planes known
// when compiled: the planes from the top byte down, Horner between them,
// -t_eff entering with the last (every cell load of a plane issued before
// its MMAs).  No branch: two calls interleave.
template <int KS, int P>
__device__ __forceinline__ void chunk_sums(Acc& acc, const XFrag (&xreg)[KSR], const Walk& w,
                                           int j, const int (&tv)[2][4]) {
  const unsigned char* b = w.b + j * w.chunk_bytes;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[f][nt][r] = P == 1 ? tv[nt][r] : 0;
#pragma unroll
  for (int q = P - 1; q >= 0; --q) {
    unsigned cell[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldsm_x4(cell[ks], b + q * w.plane_bytes + ks * 32);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) mma_step(acc, xreg[ks], cell[ks]);
    if (q == 1) {
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[f][nt][r] = acc[f][nt][r] * 256 + tv[nt][r];
    }
  }
}

// The same for any k-steps (X past KSR k-steps from the runs): one or two
// planes k-step by k-step, each X fragment loaded once for both planes and
// the two planes' sums apart; more planes one after another.
__device__ void chunk_sums_any(Acc& acc, const XFrag (&xreg)[KSR], const Walk& w, int j,
                               const int (&tv)[2][4], int ks_n, int n_planes) {
  const unsigned char* b = w.b + j * w.chunk_bytes;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[f][nt][r] = 0;
  if (n_planes <= 2) {
    Acc hi;
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) hi[f][nt][r] = 0;
    const bool two = n_planes == 2;
#pragma unroll
    for (int ks = 0; ks < KSR; ++ks) {
      if (ks < ks_n) {
        unsigned cell[4];
        ldsm_x4(cell, b + ks * 32);
        mma_step(acc, xreg[ks], cell);
        if (two) {
          ldsm_x4(cell, b + w.plane_bytes + ks * 32);
          mma_step(hi, xreg[ks], cell);
        }
      }
    }
    for (int ks = KSR; ks < ks_n; ++ks) {
      XFrag x;
      x_frags(x, w.xw, ks, w.cw);
      unsigned cell[4];
      ldsm_x4(cell, b + ks * 32);
      mma_step(acc, x, cell);
      if (two) {
        ldsm_x4(cell, b + w.plane_bytes + ks * 32);
        mma_step(hi, x, cell);
      }
    }
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[f][nt][r] += (two ? hi[f][nt][r] * 256 : 0) + tv[nt][r];
    return;
  }
  for (int q = n_planes - 1; q >= 0; --q) {
    const unsigned char* bq = b + q * w.plane_bytes;
#pragma unroll
    for (int ks = 0; ks < KSR; ++ks) {
      if (ks < ks_n) {
        unsigned cell[4];
        ldsm_x4(cell, bq + ks * 32);
        mma_step(acc, xreg[ks], cell);
      }
    }
    for (int ks = KSR; ks < ks_n; ++ks) {
      XFrag x;
      x_frags(x, w.xw, ks, w.cw);
      unsigned cell[4];
      ldsm_x4(cell, bq + ks * 32);
      mma_step(acc, x, cell);
    }
    if (q > 0) {
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[f][nt][r] *= 256;
    }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[f][nt][r] += tv[nt][r];
}

// Chunk j's pass bits of the thread's own row, inside the lanes' valid
// windows, staged; returns their count.  Fragment f's word holds candidate
// 16f + grp in its low half and 16f + grp + 8 in its high half; the quad
// ORs its lanes, and the thread keeps the half of its row.
__device__ __forceinline__ int finish(const Acc& acc, const Walk& w, int j) {
  unsigned v[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    unsigned x = 0;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        x |= static_cast<unsigned>(acc[f][nt][r] >= 0) << (16 * (r >> 1) + 8 * nt + (r & 1));
    x <<= 2 * w.tig;
    x |= __shfl_xor_sync(0xffffffffu, x, 1);
    x |= __shfl_xor_sync(0xffffffffu, x, 2);
    v[f] = x;
  }
  unsigned word = (w.tig >> 1) ? v[1] : v[0];
  word = (w.tig & 1) ? word >> 16 : word & 0xffffu;
  // one compare, unless the candidate is within reach of a lane's last window
  const int2 reach = w.reach_s[j];
  unsigned ok;
  if (w.p_own < reach.x) {
    ok = static_cast<unsigned>(reach.y);
  } else {
    ok = 0;
    for (int l = 0; l < CH; ++l) ok |= static_cast<unsigned>(w.p_own < w.nv_s[j * CH + l]) << l;
  }
  word &= ok;
  w.staged[w.own * w.row_words + j] = word;
  return __popc(word);
}

// The slice's chunks of one tile, two at a time so that one chunk's
// epilogue overlaps the other's MMAs; returns the row's pass bits.
template <int KS, int P>
__device__ int walk(const XFrag (&xreg)[KSR], const Walk& w) {
  int cnt = 0;
  int j = 0;
  for (; j + 1 < w.n_here; j += 2) {
    int tv0[2][4], tv1[2][4];
    thresholds(tv0, w, j);
    thresholds(tv1, w, j + 1);
    Acc a0, a1;
    chunk_sums<KS, P>(a0, xreg, w, j, tv0);
    chunk_sums<KS, P>(a1, xreg, w, j + 1, tv1);
    cnt += finish(a0, w, j);
    cnt += finish(a1, w, j + 1);
  }
  if (j < w.n_here) {
    int tv[2][4];
    thresholds(tv, w, j);
    Acc a;
    chunk_sums<KS, P>(a, xreg, w, j, tv);
    cnt += finish(a, w, j);
  }
  return cnt;
}

__device__ int walk_any(const XFrag (&xreg)[KSR], const Walk& w, int ks_n, int n_planes) {
  int cnt = 0;
  for (int j = 0; j < w.n_here; ++j) {
    int tv[2][4];
    thresholds(tv, w, j);
    Acc a;
    chunk_sums_any(a, xreg, w, j, tv, ks_n, n_planes);
    cnt += finish(a, w, j);
  }
  return cnt;
}

// ---------------------------------------------------------------------------
// The kernel.

__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
phase_c_kernel(const uint8_t* __restrict__ seq, long long lp, const long long* __restrict__ cand,
               const long long* __restrict__ count, long long cap,
               const uint8_t* __restrict__ planes, int n_planes, int n_chunks, int rows, int k,
               const int* __restrict__ chunk_m, const int* __restrict__ t_eff,
               const int* __restrict__ n_valid, int* __restrict__ out, int* __restrict__ pcnt,
               Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long n_rows = min(__ldg(count), cap);
  const long long tiles = (n_rows + TILE - 1) / TILE;
  const int warps = g.warps;
  // a block with no tile leaves before its one barrier, as a whole
  if (static_cast<long long>(blockIdx.x) * warps >= tiles) return;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int c0 = blockIdx.y * g.slice;
  const int n_here = min(g.slice, n_chunks - c0);
  const int depth = rows * k;  // bytes per lane and plane in global memory

  unsigned char* pl = smem;  // chunk j, plane q: pl + (j * P + q) * 16 * ls
  int* t_s = reinterpret_cast<int*>(smem + g.planes_bytes);  // [slice][16], negated
  int* nv_s = t_s + g.slice * CH;                            // [slice][16]
  // [slice]: the chunk's smallest positive n_valid and its lanes with one
  int2* reach_s = reinterpret_cast<int2*>(nv_s + g.slice * CH);
  unsigned char* mine = smem + g.planes_bytes + g.meta_bytes + warp * g.warp_bytes;
  uint32_t* runs = reinterpret_cast<uint32_t*>(mine);    // [TILE][cw]
  uint32_t* staged = runs + TILE * g.cw;                 // [TILE][slice + 1]
  uint32_t* windows = reinterpret_cast<uint32_t*>(       // [TILE][wwords]
      mine + 4LL * TILE * g.cw + round16(4LL * TILE * (g.slice + 1)));
  long long* cpos = reinterpret_cast<long long*>(mine + g.warp_bytes - 8 * TILE);

  // every chunk of the slice runs as many k-steps as its deepest chunk
  // needs, its planes staged that deep (zero cells past a chunk's rows,
  // zero-filled past a lane's bytes), so the walk has no branch on them
  int ks_n = 0;
  for (int j = 0; j < n_here; ++j) ks_n = max(ks_n, ksteps(__ldg(chunk_m + c0 + j), k, g.ks_max));
  for (int j = 0; j < n_here; ++j) {
    const int c = c0 + j;
    for (int q = 0; q < n_planes; ++q) {
      const uint8_t* src = planes + (static_cast<size_t>(q) * n_chunks + c) * CH * depth;
      unsigned char* dst = pl + (j * n_planes + q) * CH * g.ls;
      for (int i = tid; i < CH * 2 * ks_n; i += blockDim.x) {
        const int l = i & (CH - 1);
        const int piece = i >> 4;
        const bool in = piece * 16 < depth;
        cp_async16(dst + l * g.ls + piece * 16, in ? src + l * depth + piece * 16 : planes,
                   in ? 16 : 0);
      }
    }
  }
  cp_async_commit();
  for (int i = tid; i < n_here * CH; i += blockDim.x) {
    t_s[i] = -__ldg(t_eff + c0 * CH + i);
    nv_s[i] = __ldg(n_valid + c0 * CH + i);
  }
  for (int j = tid; j < n_here; j += blockDim.x) {
    int lo = INT_MAX, pm = 0;
    for (int l = 0; l < CH; ++l) {
      const int nv = __ldg(n_valid + (c0 + j) * CH + l);
      if (nv > 0) {
        lo = min(lo, nv);
        pm |= 1 << l;
      }
    }
    reach_s[j] = make_int2(lo, pm);
  }

  const uint8_t wildcard = static_cast<uint8_t>(k - 1);
  // the windows are copied as aligned words of the sequence: byte q of seq
  // is byte shift + q from the word boundary below seq (inside the same
  // allocation, whose start is aligned)
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(seq) & 3);
  const uint8_t* seq_words = seq - shift;
  // this lane's candidate of a tile, or -1 past the count
  auto position = [&](long long tile) {
    const long long r = tile * TILE + lane;
    return tile < tiles && r < n_rows ? __ldg(cand + r) : -1LL;
  };
  // t / d for t < 32 d, as (t * ceil(2^32 / d)) >> 32: exact there for d
  // below 11,585
  auto divider = [](int d) { return static_cast<unsigned>(0xffffffffu / d + 1); };
  auto quotient = [](int t, unsigned by, int d) {
    return d == 1 ? t : static_cast<int>(__umulhi(static_cast<unsigned>(t), by));
  };
  const unsigned by_rows = divider(rows);
  // start copying the window of this lane's candidate p into its words of
  // `windows` (cp.async: the copies land while the warp computes)
  auto fetch = [&](long long p) {
    if (p >= 0) {
      const long long first = (shift + p) >> 2;
      for (int w = 0; w < g.wwords; ++w) {
        const long long at = 4 * (first + w);
        const long long left = shift + lp - at;
        const int n = left >= 4 ? 4 : (left > 0 ? static_cast<int>(left) : 0);
        cp_async4(windows + lane * g.wwords + w, n ? seq_words + at : seq_words, n);
      }
    }
    cp_async_commit();
  };
  // candidate i's window: rows symbols from its copied window, the wildcard
  // past the end and for any rank >= K, one-hot in run i (K bytes a row);
  // runs of rows past the count stay zero
  auto build = [&](long long p) {
    cpos[lane] = p;
    uint4* r4 = reinterpret_cast<uint4*>(runs);
    for (int i = lane; i < TILE * g.cw / 4; i += 32) r4[i] = make_uint4(0u, 0u, 0u, 0u);
    cp_async_wait_all();
    __syncwarp();
    // slot t: row t % rows of candidate t / rows
#pragma unroll 4
    for (int t = lane; t < TILE * rows; t += 32) {
      const int i = quotient(t, by_rows, rows);
      const int j = t - i * rows;
      const long long pi = cpos[i];
      if (pi >= 0) {
        const uint8_t* win = reinterpret_cast<const uint8_t*>(windows + i * g.wwords) +
                             ((shift + pi) & 3);
        const uint8_t s = pi + j < lp ? win[j] : wildcard;
        reinterpret_cast<uint8_t*>(runs + i * g.cw)[j * k + (s < wildcard ? s : wildcard)] = 1;
      }
    }
    __syncwarp();
  };

  // this thread's row of the tile in the epilogue: fragment tig >> 1, half
  // tig & 1, candidate grp of that half
  const int own = 16 * (tig >> 1) + 8 * (tig & 1) + grp;
  // ldmatrix row and k-byte of this thread inside a staged chunk (B: 8
  // lanes x 16 k-bytes per matrix; lanes 0-7 at k 0 and 16, lanes 8-15)
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const int lkk = ((lane >> 3) & 1) * 16;
  Walk w;
  w.b = pl + lrow * g.ls + lkk;
  w.plane_bytes = CH * g.ls;
  w.chunk_bytes = n_planes * CH * g.ls;
  w.t_s = t_s;
  w.nv_s = nv_s;
  w.reach_s = reach_s;
  w.staged = staged;
  w.row_words = g.slice + 1;
  w.xw = runs + grp * g.cw + tig;
  w.cw = g.cw;
  w.tig = tig;
  w.own = own;
  w.n_here = n_here;
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  const int form = ks_n <= KSR && n_planes <= 2 ? 4 * n_planes + ks_n : 0;

  // the windows of a tile are copied during the tile before, the
  // positions read a tile before that
  long long tile = static_cast<long long>(blockIdx.x) * warps + warp;
  long long p_now = position(tile);
  fetch(p_now);
  long long p_next = position(tile + stride);
  cp_async_wait_all();
  __syncthreads();  // the planes and the slice's tables are in place

  for (; tile < tiles; tile += stride) {
    build(p_now);
    if (tile + stride < tiles) fetch(p_next);
    p_now = p_next;
    p_next = position(tile + 2 * stride);
    XFrag xreg[KSR];
#pragma unroll
    for (int ks = 0; ks < KSR; ++ks) x_frags(xreg[ks], w.xw, ks, g.cw);
    w.p_own = cpos[own];
    int cnt;
    switch (form) {
      case 4 + 1: cnt = walk<1, 1>(xreg, w); break;
      case 4 + 2: cnt = walk<2, 1>(xreg, w); break;
      case 4 + 3: cnt = walk<3, 1>(xreg, w); break;
      case 8 + 1: cnt = walk<1, 2>(xreg, w); break;
      case 8 + 2: cnt = walk<2, 2>(xreg, w); break;
      case 8 + 3: cnt = walk<3, 2>(xreg, w); break;
      default: cnt = walk_any(xreg, w, ks_n, n_planes);
    }

    const long long r0 = tile * TILE;
    if (cnt != 0 && r0 + own < n_rows) atomicAdd(pcnt + r0 + own, cnt);
    __syncwarp();
    // the tile's staged words, row by row: lanes j of rows i, coalesced
    const int j = lane & (g.slice - 1);
    const int step = 32 >> g.lg_slice;
#pragma unroll 4
    for (int i = lane >> g.lg_slice; i < TILE; i += step) {
      if (j < n_here && r0 + i < n_rows) {
        out[(r0 + i) * n_chunks + c0 + j] = static_cast<int>(staged[i * (g.slice + 1) + j]);
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// The geometry phase C takes for windows of rows x K in `planes` byte
// planes over n_chunks lane chunks (slice_hint 0: its own choice): (blocks
// an SM << 24) | (warps a block << 16) | lane chunks a slice, or -1 where
// nothing fits in shared memory.
int lm_phase_c_geom(int rows, int k, int planes, int n_chunks, int slice_hint) {
  if (rows < 1 || k < 1 || planes < 1 || n_chunks < 1) {
    return -1;
  }
  const Geom g = choose(rows, k, planes, n_chunks, slice_hint);
  return g.smem < 0 ? -1 : (g.per_sm << 24) | (g.warps << 16) | g.slice;
}

// Its dynamic shared memory (bytes), or -1.
long long lm_phase_c_smem(int rows, int k, int planes, int n_chunks, int slice_hint) {
  if (rows < 1 || k < 1 || planes < 1 || n_chunks < 1) {
    return -1;
  }
  return choose(rows, k, planes, n_chunks, slice_hint).smem;
}

// Phase C over the candidates: cand int64 [cap], its first min(*count, cap)
// entries ascending window starts in seq (count int64 on the device);
// planes, chunk_m and t_eff phase C's; n_valid int32 [n_chunks * 16]; out
// int32 [cap][n_chunks], row i bit l of word c set where lane 16c + l passes
// at candidate i (rows at or past the count are not written); pcnt int32
// [cap], each row's set bits (zeroed here first, so 0 past the count).
// slice_hint: 0, or the lane chunks of a slice to take.  Returns the CUDA
// error of the launch (0 when it was queued).
int lm_phase_c_bits(const void* seq, long long lp, const void* cand, const void* count,
                    long long cap, const void* planes, int n_planes, int n_chunks, int rows,
                    int k, const void* chunk_m, const void* t_eff, const void* n_valid,
                    void* out, void* pcnt, int slice_hint, void* stream) {
  if (n_planes < 1 || n_planes > MAX_PLANES || (rows * k) % 16 != 0 || cap < 1 ||
      n_chunks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geom g = choose(rows, k, n_planes, n_chunks, slice_hint);
  if (g.smem < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(pcnt, 0, 4 * cap, st);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  static std::atomic<int> allowed[MAX_DEVICES];
  err = allow_smem(reinterpret_cast<const void*>(phase_c_kernel), allowed, g.smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  int sms = 0;
  const int sm_err = n_sms(&sms);
  if (sm_err != 0) {
    return sm_err;
  }
  // one wave of blocks over the slices, never more than cap's tiles need
  const long long slices = (n_chunks + g.slice - 1) / g.slice;
  const long long wave = (static_cast<long long>(g.per_sm) * sms + slices - 1) / slices;
  const long long need = (cap + static_cast<long long>(TILE) * g.warps - 1) /
                         (static_cast<long long>(TILE) * g.warps);
  const dim3 grid(static_cast<unsigned>(need < wave ? need : wave),
                  static_cast<unsigned>(slices));
  phase_c_kernel<<<grid, 32 * g.warps, g.smem, st>>>(
      static_cast<const uint8_t*>(seq), lp, static_cast<const long long*>(cand),
      static_cast<const long long*>(count), cap, static_cast<const uint8_t*>(planes), n_planes,
      n_chunks, rows, k, static_cast<const int*>(chunk_m), static_cast<const int*>(t_eff),
      static_cast<const int*>(n_valid), static_cast<int*>(out), static_cast<int*>(pcnt), g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
