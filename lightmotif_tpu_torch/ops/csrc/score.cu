// PSSM window scoring kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lightmotif_tpu/ops/kernels.py::_gather_kernel
// in both of its modes:
//
//   K1, f32 mode (lm_score_f32):  out[p] = w[0][s[p]] + w[1][s[p+1]] + ...
//       + w[m-1][s[p+m-1]], added in ascending j with round-to-nearest adds
//       (__fadd_rn: never contracted into an FMA, never reassociated), so
//       every score is bit-identical to the sequential host oracle
//       (ScoringMatrix.score_host); -INFINITY at p >= n_scores.
//   K2, discrete mode (lm_score_u8):  out[p] = min(sum_j dm[j][s[p+j]], 255)
//       as int32, which equals the reference's stepwise-saturating u8 sum
//       because the partial sums never decrease; -1 at p >= n_scores.
//       Integer sums do not depend on their order, so this mode may reorder.
//
// Reads past the end of the sequence see the wildcard (rank k - 1), like the
// reference's wrap rows, and so does any rank >= k, as in the XLA version's
// select chain: no byte can index outside the table.
//
// What bounds it: 1 byte read and 4 bytes written per position, 6.9 us for
// the 4.64 M-position genome at 3.35 TB/s.  The work per position is m table
// lookups and m adds; the f32 adds of one window form a chain that may not be
// reassociated.  The first kernel (kept as variant 0, LK_LEGACY) did two
// dependent shared-memory loads per (window, row) -- the sequence byte and
// the table cell -- and was bound by shared-memory load issue, at 24% of the
// bound.
//
// Design (every variant but LK_LEGACY):
//
// * A block stages its TP positions plus the (m-1)-byte halo once, as ranks
//   clamped to the wildcard, in shared memory (16-byte loads where the
//   sequence is aligned), and the table once.
// * Each thread owns P consecutive positions.  For every 4 motif rows it
//   reads the P + 3 bytes those rows need as P/4 + 1 aligned 32-bit words
//   and takes each symbol out with __byte_perm, so the sequence costs about
//   (P + 3) / (4P) shared loads per window and row instead of one.
// * Rows outer, positions inner: for each row j the thread does P
//   independent acc[i] = acc[i] + cell(j, s[i + j]); each chain stays in
//   ascending j (exact), and the P chains are the instruction-level
//   parallelism.
// * The cell lookup (LK_*): LK_SMEM reads the table in shared memory (one
//   conflict-free load per lookup: a warp reads at most k distinct words of
//   row j); LK_SHFL holds row j in the warp's lanes and fetches a cell with
//   __shfl_sync (k <= 32); LK_SEL holds row j's cells in registers and picks
//   one with a 3-level select tree (k <= 8); LK_PRMT (K2, k <= 7, m <= 257)
//   packs row j's u8 cells in two registers and looks up TWO positions with
//   one __byte_perm: the staged ranks carry 0x70 | s, so the 16-bit window
//   at byte i+j is the selector (s_i, 7, s_i+1, 7) whose nibble 7 picks the
//   zero top byte, giving cell(s_i) | cell(s_i+1) << 16, and the sums run in
//   16-bit lanes (m * 255 <= 65535); LK_ROW2 / LK_ROW4 keep the table
//   symbol-major in groups of RV = 2 / 4 rows, T[j / RV][s] = (w[j][s],
//   w[j+1][s], ...), so that one 8- or 16-byte shared load of symbol s_b
//   brings the cells of RV rows for RV different positions (row j + r of
//   position b - r): a byte is taken out and looked up once per RV rows, and
//   position i still adds its rows in ascending j, because byte b's
//   components reach positions b, b - 1, ... as b ascends.
// * A thread writes its P outputs as 128-bit vector stores, so a warp writes
//   contiguous 16 * P-byte runs.  With LAZY, only a block that crosses
//   n_scores tests positions against it (P24's last-block masking); the
//   sequence tail is staged as the wildcard, so no read tests lp.
// * The halo: HALO_STAGED reads the (m-1) bytes after the block from the
//   sequence (they sit in L2 from the next block's read); HALO_HEADS reads
//   them from a side input built by the caller, [blocks][head_w], so each
//   byte of the sequence is read once (P16 and P18's question); HALO_DIRECT
//   stages nothing in a block whose bytes all lie in an aligned sequence:
//   each thread reads its words straight from device memory (neighbouring
//   threads share them in L1) and clamps them itself, with no barrier; the
//   blocks at the tail stage as HALO_STAGED does.
// * PERSIST: one block per SM slot walks the tiles (grid stride), staging
//   the table once; PERSIST 2 also double-buffers the tiles and copies the
//   next one with cp.async while it scores this one (raw bytes, clamped in
//   place once they land).
//
// LM_SCORE_VARIANTS below are the instantiations; the sweep of them is the
// probe module lightmotif_tpu_torch/probes/scoring.py, whose VARIANTS mirrors
// the table.  The entry points launch PRODUCTION_F32 / PRODUCTION_U8, or,
// for a table that variant does not take (a k or m past its lookup's
// limit), GENERIC.  See PERF.md section 6 for the sweep's numbers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "launch_attrs.cuh"

namespace {

// lookup kinds
constexpr int LK_LEGACY = 0;  // the first kernel: one position at a time, strided
constexpr int LK_SMEM = 1;
constexpr int LK_SHFL = 2;
constexpr int LK_SEL = 3;
constexpr int LK_PRMT = 4;
constexpr int LK_ROW2 = 5;
constexpr int LK_ROW4 = 6;

// halo forms
constexpr int HALO_STAGED = 0;
constexpr int HALO_HEADS = 1;
constexpr int HALO_DIRECT = 2;

constexpr unsigned FULL = 0xffffffffu;

// (lookup, positions per thread, threads, positions per block, halo, lazy
// mask, persistent, the blocks per SM __launch_bounds__ asks registers for,
// the alphabet size when it is fixed at compile time -- 5, DNA, so that a
// row's offset in the table is an immediate of the load -- or 0 for any k,
// and the positions of a group: a thread's P positions are P / grp groups
// of grp consecutive ones, group q of thread t at q * threads * grp + t *
// grp, so that grp = 4 makes every 128-bit store of a warp one contiguous
// 512-byte run and its word loads conflict-free)
#define LM_SCORE_VARIANTS(X)                       \
  X(LK_LEGACY, 1, 256, 1024, HALO_STAGED, 0, 0, 1, 0, 1)    \
  X(LK_SMEM, 8, 256, 2048, HALO_STAGED, 1, 0, 1, 0, 8)      \
  X(LK_SMEM, 4, 256, 1024, HALO_STAGED, 1, 0, 1, 0, 4)      \
  X(LK_SMEM, 16, 256, 4096, HALO_STAGED, 1, 0, 1, 0, 16)     \
  X(LK_SMEM, 8, 128, 1024, HALO_STAGED, 1, 0, 1, 0, 8)      \
  X(LK_SMEM, 8, 256, 8192, HALO_STAGED, 1, 0, 1, 0, 8)      \
  X(LK_SMEM, 8, 512, 4096, HALO_STAGED, 1, 0, 1, 0, 8)      \
  X(LK_SMEM, 8, 256, 2048, HALO_STAGED, 0, 0, 1, 0, 8)      \
  X(LK_SMEM, 8, 256, 2048, HALO_HEADS, 1, 0, 1, 0, 8)       \
  X(LK_SMEM, 8, 256, 8192, HALO_HEADS, 1, 0, 1, 0, 8)       \
  X(LK_SMEM, 8, 256, 2048, HALO_STAGED, 1, 1, 1, 0, 8)      \
  X(LK_SHFL, 8, 256, 2048, HALO_STAGED, 1, 0, 1, 0, 8)      \
  X(LK_SHFL, 8, 256, 2048, HALO_STAGED, 0, 0, 1, 0, 8)      \
  X(LK_SEL, 8, 256, 2048, HALO_STAGED, 1, 0, 1, 0, 8)       \
  X(LK_PRMT, 8, 256, 2048, HALO_STAGED, 1, 0, 1, 0, 8)      \
  X(LK_PRMT, 16, 256, 4096, HALO_STAGED, 1, 0, 1, 0, 16)     \
  X(LK_ROW2, 8, 256, 2048, HALO_STAGED, 1, 0, 1, 0, 8)      \
  X(LK_ROW4, 8, 256, 2048, HALO_STAGED, 1, 0, 1, 0, 8)      \
  X(LK_ROW4, 16, 256, 4096, HALO_STAGED, 1, 0, 1, 0, 16)   \
  X(LK_SMEM, 8, 256, 2048, HALO_STAGED, 1, 0, 8, 0, 8)    \
  X(LK_PRMT, 8, 256, 2048, HALO_STAGED, 1, 0, 8, 0, 8) \
  X(LK_SMEM, 8, 256, 2048, HALO_STAGED, 1, 0, 1, 5, 8) \
  X(LK_SMEM, 8, 128, 1024, HALO_STAGED, 1, 0, 1, 5, 8) \
  X(LK_ROW4, 8, 256, 2048, HALO_STAGED, 1, 0, 1, 5, 8) \
  X(LK_PRMT, 8, 256, 2048, HALO_STAGED, 1, 0, 1, 5, 8) \
  X(LK_SMEM, 8, 256, 2048, HALO_STAGED, 1, 2, 1, 5, 8) \
  X(LK_SMEM, 8, 256, 2048, HALO_DIRECT, 1, 0, 1, 5, 8) \
  X(LK_PRMT, 8, 256, 2048, HALO_DIRECT, 1, 0, 1, 5, 8) \
  X(LK_SMEM, 8, 128, 1024, HALO_STAGED, 1, 0, 1, 5, 4) \
  X(LK_SMEM, 8, 256, 2048, HALO_STAGED, 1, 0, 1, 5, 4) \
  X(LK_SMEM, 16, 128, 2048, HALO_STAGED, 1, 0, 1, 5, 4) \
  X(LK_PRMT, 8, 256, 2048, HALO_STAGED, 1, 0, 1, 5, 4) \
  X(LK_PRMT, 16, 128, 2048, HALO_STAGED, 1, 0, 1, 5, 4)

struct Variant {
  int lookup, p, threads, tp, halo, lazy, persist, minb, kc, grp;
};

#define LM_SCORE_ROW(lk, p, nt, tp, halo, lazy, persist, minb, kc, grp) \
  {lk, p, nt, tp, halo, lazy, persist, minb, kc, grp},
constexpr Variant VARIANTS[] = {LM_SCORE_VARIANTS(LM_SCORE_ROW)};
#undef LM_SCORE_ROW
constexpr int N_VARIANTS = sizeof(VARIANTS) / sizeof(VARIANTS[0]);

// The instantiations the entry points launch (indices of VARIANTS), and the
// one they fall back to for a table the production one does not take (k != 5,
// or m > 257 for K2).  The sweep's winners on an NVIDIA H100 80GB HBM3 at
// 700 W, at the genome (4,641,652 positions, MX000001's 15 x 5 table;
// chip_smoke.py's sweep through probes/scoring.py, PERF.md section 6): K1
// through variant 30 -- the shared-memory table with k fixed at 5, 16
// positions per thread in groups of 4 interleaved across the warp, 128
// threads -- and K2 through variant 32, two lookups per __byte_perm in the
// same layout: K1 within 1.2x of the probes' body that does the same io
// with no lookup (lm_probe_score_diag, DIAG_IO), K2 below it; the first
// kernel, variant 0, took 1.8x and 2.3x their time.  Neither the
// row-group loads (LK_ROW2/4), the warp shuffle, the select tree, the
// side-input, direct or pipelined halos, nor the other geometries beat
// them.
constexpr int PRODUCTION_F32 = 30;
constexpr int PRODUCTION_U8 = 32;
constexpr int GENERIC = 4;

// Whether variant v takes a table of m rows and k symbols in this mode.
__host__ inline bool accepts(const Variant& x, bool discrete, int m, int k) {
  if (x.kc != 0 && x.kc != k) {
    return false;
  }
  switch (x.lookup) {
    case LK_SHFL:
      return k <= 32;
    case LK_SEL:
      return k <= 8;
    case LK_PRMT:
      return discrete && k <= 7 && m <= 257;
    default:
      return true;
  }
}

// rows per table entry of a lookup (LK_ROW2 / LK_ROW4), else 1
__host__ __device__ constexpr int rows_per_entry(int lk) {
  return lk == LK_ROW2 ? 2 : lk == LK_ROW4 ? 4 : 1;
}

// bytes of the staged table
__host__ __device__ inline int table_bytes(int lk, int m, int k) {
  const int rv = rows_per_entry(lk);
  return lk == LK_PRMT ? 8 * m : 4 * ((m + rv - 1) / rv * rv) * k;
}

// Shared memory of variant x for an m x k table: the table, then the
// staged ranks (the block's positions, the halo, and slack for the last
// thread's word reads), both 16-byte aligned.
__host__ inline long long smem_bytes(const Variant& x, int m, int k) {
  if (x.lookup == LK_LEGACY) {
    return static_cast<long long>(m) * k * 4 + x.tp + m - 1;
  }
  const long long table = table_bytes(x.lookup, m, k);
  const long long tile = (x.tp + m + 3 + 15) / 16 * 16;
  return (table + 15) / 16 * 16 + tile * (x.persist == 2 ? 2 : 1);
}

// ---------------------------------------------------------------------------
// The first kernel, kept as the sweep's baseline (variant 0).

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
  static __device__ __forceinline__ float zero() { return -0.0f; }  // -0 + x == x
};

template <>
struct Acc<true> {
  using T = int;
  static __device__ __forceinline__ int load(const void* table, int i) {
    return static_cast<int>(static_cast<const uint8_t*>(table)[i]);
  }
  static __device__ __forceinline__ int add(int a, int b) { return a + b; }
  static __device__ __forceinline__ int zero() { return 0; }
};

template <bool DISCRETE, int NT, int TP>
__global__ void __launch_bounds__(NT)
legacy_kernel(const uint8_t* __restrict__ seq, long long lp,
              const void* __restrict__ table, int m, int k,
              long long n_scores, void* __restrict__ out) {
  using A = Acc<DISCRETE>;
  using T = typename A::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);  // [m][k], 4-byte entries
  uint8_t* tile = smem + static_cast<size_t>(m) * k * sizeof(T);

  const long long base = static_cast<long long>(blockIdx.x) * TP;
  const uint8_t wildcard = static_cast<uint8_t>(k - 1);

  for (int i = threadIdx.x; i < m * k; i += NT) {
    tab[i] = A::load(table, i);
  }
  const int span = TP + m - 1;
  for (int i = threadIdx.x; i < span; i += NT) {
    const long long g = base + i;
    const uint8_t s = g < lp ? seq[g] : wildcard;
    tile[i] = s < wildcard ? s : wildcard;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < TP; t += NT) {
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

// ---------------------------------------------------------------------------
// The redesigned kernel.

// Byte b of the word array w, zero-extended (one PRMT).  Every caller's b is
// known once its loops are unrolled, so w stays in registers.
template <int NW>
__device__ __forceinline__ unsigned byte_at(const uint32_t (&w)[NW], int b) {
  return __byte_perm(w[b >> 2], 0u, 0x4440u | (b & 3));
}

// The 16-bit window of bytes b, b + 1 in the low half (__byte_perm reads
// only the low 16 bits of its selector).
template <int NW>
__device__ __forceinline__ unsigned pair_at(const uint32_t (&w)[NW], int b) {
  if ((b & 3) == 0) {
    return w[b >> 2];
  }
  if ((b & 3) == 3) {
    return __funnelshift_r(w[b >> 2], w[(b >> 2) + 1], 24);
  }
  return w[b >> 2] >> (8 * (b & 3));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the four bytes of v clamped to the wildcard (and tagged 0x70 for LK_PRMT)
template <int LK>
__device__ __forceinline__ uint32_t clamp4(uint32_t v, uint32_t wc4) {
  v = __vminu4(v, wc4);
  return LK == LK_PRMT ? v | 0x70707070u : v;
}

template <int LK>
__device__ __forceinline__ uint8_t clamp1(unsigned v, unsigned wc) {
  v = v < wc ? v : wc;
  return static_cast<uint8_t>(LK == LK_PRMT ? v | 0x70u : v);
}

// One row of the P positions: acc[i] += cell(j, s[i + jj]), for the lookups
// that fetch one cell per position (row: the table's row j; lane_cell: cell
// `lane` of it for LK_SHFL; cells: its first 8 cells for LK_SEL).
template <bool DISCRETE, int LK, int P, int NW>
__device__ __forceinline__ void row_step(typename Acc<DISCRETE>::T (&acc)[P],
                                         const uint32_t (&w)[NW], int jj,
                                         const typename Acc<DISCRETE>::T* row,
                                         typename Acc<DISCRETE>::T lane_cell,
                                         const typename Acc<DISCRETE>::T (&cells)[8]) {
  using A = Acc<DISCRETE>;
  using T = typename A::T;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const unsigned s = byte_at<NW>(w, i + jj);
    T cell;
    if constexpr (LK == LK_SMEM) {
      cell = row[s];
    } else if constexpr (LK == LK_SHFL) {
      cell = __shfl_sync(FULL, lane_cell, static_cast<int>(s));
    } else {  // LK_SEL
      const bool b0 = s & 1u, b1 = s & 2u, b2 = s & 4u;
      const T v01 = b0 ? cells[1] : cells[0];
      const T v23 = b0 ? cells[3] : cells[2];
      const T v45 = b0 ? cells[5] : cells[4];
      const T v67 = b0 ? cells[7] : cells[6];
      const T v03 = b1 ? v23 : v01;
      const T v47 = b1 ? v67 : v45;
      cell = b2 ? v47 : v03;
    }
    acc[i] = A::add(acc[i], cell);
  }
}

// One row of LK_PRMT: acc2[q] += cell(j, s[2q + jj]) | cell(j, s[2q + 1 + jj]) << 16
template <int P, int NW>
__device__ __forceinline__ void prmt_step(uint32_t (&acc2)[P / 2], const uint32_t (&w)[NW],
                                          int jj, uint2 cells) {
#pragma unroll
  for (int q = 0; q < P / 2; ++q) {
    acc2[q] += __byte_perm(cells.x, cells.y, pair_at<NW>(w, 2 * q + jj));
  }
}

// Vector of RV table cells.
template <typename T, int RV>
struct Cells;
template <typename T>
struct Cells<T, 2> {
  using V = typename std::conditional<std::is_same<T, float>::value, float2, int2>::type;
  static __device__ __forceinline__ T at(const V& v, int r) { return r == 0 ? v.x : v.y; }
};
template <typename T>
struct Cells<T, 4> {
  using V = typename std::conditional<std::is_same<T, float>::value, float4, int4>::type;
  static __device__ __forceinline__ T at(const V& v, int r) {
    return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
  }
};

// Rows j0 .. j0 + 3 of LK_ROW2 / LK_ROW4: group g holds rows j0 + RV g + r;
// the load of byte b brings row j0 + RV g + r of position b - RV g - r.
template <bool DISCRETE, int RV, int P, int NW>
__device__ __forceinline__ void rows_step(typename Acc<DISCRETE>::T (&acc)[P],
                                          const uint32_t (&w)[NW], int j0, int m, int k,
                                          const typename Acc<DISCRETE>::T* tab) {
  using A = Acc<DISCRETE>;
  using C = Cells<typename A::T, RV>;
  using V = typename C::V;
  const V* tv = reinterpret_cast<const V*>(tab);
#pragma unroll
  for (int g = 0; g < 4 / RV; ++g) {
    const int jg = j0 + RV * g;
    if (jg >= m) break;  // the same for every thread
    const V* row = tv + (jg / RV) * k;
#pragma unroll
    for (int b = RV * g; b < RV * g + P + RV - 1; ++b) {
      const V c = row[byte_at<NW>(w, b)];
#pragma unroll
      for (int r = 0; r < RV; ++r) {
        const int i = b - RV * g - r;
        if (i >= 0 && i < P && jg + r < m) acc[i] = A::add(acc[i], C::at(c, r));
      }
    }
  }
}

template <bool DISCRETE, int LK, int P, int NT, int TP, int HALO, bool LAZY, int PERSIST,
          int MINB, int KC, int G>
__global__ void __launch_bounds__(NT, MINB)
score_kernel(const uint8_t* __restrict__ seq, long long lp,
             const uint8_t* __restrict__ heads, int head_w,
             const void* __restrict__ table, int m, int k_arg, long long n_scores,
             void* __restrict__ out) {
  const int k = KC != 0 ? KC : k_arg;  // the launch checked k_arg == KC
  using A = Acc<DISCRETE>;
  using T = typename A::T;
  static_assert(G % 4 == 0 && P % G == 0 && TP % (NT * P) == 0,
                "whole words, whole groups, whole rounds");
  static_assert(LK != LK_PRMT || DISCRETE, "LK_PRMT is a K2 lookup");
  constexpr bool PIPE = PERSIST == 2;  // persistent, the next tile copied ahead
  static_assert(!PIPE || HALO == HALO_STAGED, "the pipelined form stages the halo");
  constexpr bool DIRECT = HALO == HALO_DIRECT;
  constexpr int NG = P / G;      // groups of G consecutive positions per thread
  constexpr int NW = G / 4 + 1;  // words a group reads per 4 rows
  constexpr int ROUNDS = TP / (NT * P);

  constexpr int RV = rows_per_entry(LK);
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  uint2* prm = reinterpret_cast<uint2*>(smem);
  uint8_t* tile = smem + (table_bytes(LK, m, k) + 15) / 16 * 16;
  const int tile_bytes = (TP + m + 3 + 15) / 16 * 16;

  const int tid = threadIdx.x;
  const unsigned wc = static_cast<unsigned>(k - 1);
  const uint32_t wc4 = wc * 0x01010101u;

  // the table, once per block
  if constexpr (LK == LK_PRMT) {
    const uint8_t* t8 = static_cast<const uint8_t*>(table);
    for (int j = tid; j < m; j += NT) {
      uint32_t lo = 0, hi = 0;  // cells 0-3, cells 4-6; byte 7 stays 0
      for (int s = 0; s < k; ++s) {
        const uint32_t c = t8[j * k + s];
        if (s < 4) {
          lo |= c << (8 * s);
        } else {
          hi |= c << (8 * (s - 4));
        }
      }
      prm[j] = make_uint2(lo, hi);
    }
  } else if constexpr (RV > 1) {
    // entry (q, s) holds rows q RV .. q RV + RV - 1 of symbol s (0 past m)
    const int n = (m + RV - 1) / RV * k * RV;
    for (int i = tid; i < n; i += NT) {
      const int r = i % RV;
      const int s = (i / RV) % k;
      const int j = i / (RV * k) * RV + r;
      tab[i] = j < m ? A::load(table, j * k + s) : A::zero();
    }
  } else {
    for (int i = tid; i < m * k; i += NT) {
      tab[i] = A::load(table, i);
    }
  }

  // Stage the ranks of tile blk into dst: TP positions, the halo, then the
  // wildcard.  PIPE copies an aligned interior tile with cp.async, raw, and
  // returns true (the caller clamps it once it has landed); every PIPE call
  // commits one cp.async group, empty or not, so the waits count tiles.
  auto stage = [&](long long blk, uint8_t* dst) -> bool {
    const long long base = blk * TP;
    const int from_seq = HALO == HALO_HEADS ? TP : tile_bytes;
    const bool vec = ((reinterpret_cast<uintptr_t>(seq) + base) & 15) == 0 &&
                     base + from_seq <= lp;
    if (PIPE && vec) {
      for (int i = 16 * tid; i < from_seq; i += 16 * NT) cp_async16(dst + i, seq + base + i);
      cp_async_commit();
      return true;
    }
    if (vec) {
      for (int i = 16 * tid; i < from_seq; i += 16 * NT) {
        uint4 v = *reinterpret_cast<const uint4*>(seq + base + i);
        v.x = clamp4<LK>(v.x, wc4);
        v.y = clamp4<LK>(v.y, wc4);
        v.z = clamp4<LK>(v.z, wc4);
        v.w = clamp4<LK>(v.w, wc4);
        *reinterpret_cast<uint4*>(dst + i) = v;
      }
    } else {
      for (int i = tid; i < from_seq; i += NT) {
        const long long g = base + i;
        dst[i] = clamp1<LK>(g < lp ? seq[g] : wc, wc);
      }
    }
    if constexpr (HALO == HALO_HEADS) {
      const uint8_t* hd = heads + blk * head_w;
      for (int i = TP + tid; i < tile_bytes; i += NT) {
        const int h = i - TP;
        dst[i] = clamp1<LK>(h < m - 1 ? hd[h] : wc, wc);
      }
    }
    if (PIPE) cp_async_commit();
    return false;
  };

  if constexpr (DIRECT) {
    __syncthreads();  // the table, before a block that stages nothing reads it
  }
  const long long n_tiles = (lp + TP - 1) / TP;
  const long long step = PERSIST ? gridDim.x : n_tiles;
  int cur = 0;
  bool raw_cur = false;
  if (PIPE && blockIdx.x < n_tiles) raw_cur = stage(blockIdx.x, tile);
  for (long long blk = blockIdx.x; blk < n_tiles; blk += step) {
    const long long base = blk * TP;
    uint8_t* const tl = tile + cur * tile_bytes;
    if constexpr (PIPE) {
      // the next tile's copy overlaps this tile's work
      bool raw_next = false;
      if (blk + step < n_tiles) {
        raw_next = stage(blk + step, tile + (cur ^ 1) * tile_bytes);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (raw_cur) {
        for (int i = 4 * tid; i < tile_bytes; i += 4 * NT) {
          uint32_t* word = reinterpret_cast<uint32_t*>(tl + i);
          *word = clamp4<LK>(*word, wc4);
        }
        __syncthreads();
      }
      raw_cur = raw_next;
    }
    // DIRECT: every byte this block reads lies in the sequence, 4-aligned
    const bool direct = DIRECT && ((reinterpret_cast<uintptr_t>(seq) + base) & 3) == 0 &&
                        base + tile_bytes <= lp;
    if (!PIPE && !direct) {
      if constexpr (PERSIST) {
        __syncthreads();  // the previous tile's ranks are no longer read
      }
      stage(blk, tl);
      __syncthreads();
    }

    const bool mask = !LAZY || base + TP > n_scores;
#pragma unroll 1
    for (int r = 0; r < ROUNDS; ++r) {
      // group q of the thread: G consecutive positions at tile offset t0[q]
      int t0[NG];
#pragma unroll
      for (int q = 0; q < NG; ++q) t0[q] = r * NT * P + (q * NT + tid) * G;
      T acc[NG][G];
      uint32_t acc2[NG][G / 2];
#pragma unroll
      for (int q = 0; q < NG; ++q) {
#pragma unroll
        for (int i = 0; i < G; ++i) acc[q][i] = A::zero();
#pragma unroll
        for (int i = 0; i < G / 2; ++i) acc2[q][i] = 0u;
      }
      const uint8_t* src = direct ? seq + base : tl;
      const int lane = tid & 31;

#pragma unroll 1
      for (int j0 = 0; j0 < m; j0 += 4) {
        uint32_t w[NG][NW];
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          const uint32_t* wp = reinterpret_cast<const uint32_t*>(src + t0[q] + j0);
#pragma unroll
          for (int i = 0; i < NW; ++i) w[q][i] = direct ? clamp4<LK>(__ldg(wp + i), wc4) : wp[i];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + jj;
          if (j >= m) break;  // the same for every thread
          if constexpr (RV > 1) {
            if (jj == 0) {
#pragma unroll
              for (int q = 0; q < NG; ++q) rows_step<DISCRETE, RV, G, NW>(acc[q], w[q], j0, m, k, tab);
            }
          } else if constexpr (LK == LK_PRMT) {
            const uint2 c = prm[j];
#pragma unroll
            for (int q = 0; q < NG; ++q) prmt_step<G, NW>(acc2[q], w[q], jj, c);
          } else {
            const T* row = tab + j * k;
            T lane_cell = A::zero();
            T cells[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) cells[i] = A::zero();
            if constexpr (LK == LK_SHFL) {
              lane_cell = lane < k ? row[lane] : A::zero();
            }
            if constexpr (LK == LK_SEL) {
#pragma unroll
              for (int i = 0; i < 8; ++i) cells[i] = row[i < k ? i : k - 1];
            }
#pragma unroll
            for (int q = 0; q < NG; ++q) {
              row_step<DISCRETE, LK, G, NW>(acc[q], w[q], jj, row, lane_cell, cells);
            }
          }
        }
      }

      // each group's G results, masked where the block crosses n_scores,
      // as 128-bit stores
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const long long p0 = base + t0[q];
        T v[G];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          T x;
          if constexpr (LK == LK_PRMT) {
            const uint32_t lanes = acc2[q][i >> 1];
            x = static_cast<T>((i & 1) ? lanes >> 16 : lanes & 0xffffu);
          } else {
            x = acc[q][i];
          }
          if constexpr (DISCRETE) {
            x = min(x, 255);
            v[i] = mask && p0 + i >= n_scores ? -1 : x;
          } else {
            v[i] = mask && p0 + i >= n_scores ? -INFINITY : x;
          }
        }
        T* o = static_cast<T*>(out) + p0;
        if (p0 + G <= lp) {
#pragma unroll
          for (int i = 0; i < G / 4; ++i) {
            if constexpr (DISCRETE) {
              reinterpret_cast<int4*>(o)[i] =
                  make_int4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
            } else {
              reinterpret_cast<float4*>(o)[i] =
                  make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < G; ++i) {
            if (p0 + i < lp) o[i] = v[i];
          }
        }
      }
    }
    if constexpr (PIPE) {
      __syncthreads();  // every thread is done with this buffer: the next copy takes it
      cur ^= 1;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.

template <bool DISCRETE, int LK, int P, int NT, int TP, int HALO, int LAZY, int PERSIST,
          int MINB, int KC, int G>
int launch_variant(const void* seq, long long lp, const void* heads, int head_w,
                   const void* table, int m, int k, long long n_scores, void* out,
                   void* stream) {
  if constexpr (LK == LK_PRMT && !DISCRETE) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const Variant x{LK, P, NT, TP, HALO, LAZY, PERSIST, MINB, KC, G};
    if (!accepts(x, DISCRETE, m, k) || (HALO == HALO_HEADS && (heads == nullptr || head_w < m - 1))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long smem = smem_bytes(x, m, k);
    void (*kernel)(const uint8_t*, long long, const uint8_t*, int, const void*, int, int,
                   long long, void*) = nullptr;
    void (*legacy)(const uint8_t*, long long, const void*, int, int, long long, void*) = nullptr;
    if constexpr (LK == LK_LEGACY) {
      legacy = legacy_kernel<DISCRETE, NT, TP>;
    } else {
      kernel = score_kernel<DISCRETE, LK, P, NT, TP, HALO, LAZY != 0, PERSIST, MINB, KC, G>;
    }
    const void* fn = LK == LK_LEGACY ? reinterpret_cast<const void*>(legacy)
                                     : reinterpret_cast<const void*>(kernel);
    static std::atomic<int> allowed[MAX_DEVICES];
    const cudaError_t err = allow_smem(fn, allowed, smem);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    const long long tiles = (lp + TP - 1) / TP;
    long long grid = tiles;
    if (PERSIST) {
      int per_sm = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, static_cast<size_t>(smem));
      int sms = 0;
      const int sm_err = n_sms(&sms);
      if (sm_err != 0) {
        return sm_err;
      }
      const long long slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
      grid = tiles < slots ? tiles : slots;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if constexpr (LK == LK_LEGACY) {
      legacy<<<static_cast<unsigned int>(grid), NT, smem, s>>>(
          static_cast<const uint8_t*>(seq), lp, table, m, k, n_scores, out);
    } else {
      kernel<<<static_cast<unsigned int>(grid), NT, smem, s>>>(
          static_cast<const uint8_t*>(seq), lp, static_cast<const uint8_t*>(heads), head_w,
          table, m, k, n_scores, out);
    }
    return static_cast<int>(cudaGetLastError());
  }
}

template <bool DISCRETE>
int launch(int v, const void* seq, long long lp, const void* heads, int head_w,
           const void* table, int m, int k, long long n_scores, void* out, void* stream) {
  if (lp <= 0) {
    return 0;
  }
  int i = 0;
#define LM_SCORE_CASE(lk, p, nt, tp, halo, lazy, persist, minb, kc, g)                  \
  if (v == i++) {                                                                       \
    return launch_variant<DISCRETE, lk, p, nt, tp, halo, lazy, persist, minb, kc, g>(   \
        seq, lp, heads, head_w, table, m, k, n_scores, out, stream);                    \
  }
  LM_SCORE_VARIANTS(LM_SCORE_CASE)
#undef LM_SCORE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int pick(bool discrete, int m, int k) {
  const int v = discrete ? PRODUCTION_U8 : PRODUCTION_F32;
  return accepts(VARIANTS[v], discrete, m, k) ? v : GENERIC;
}

}  // namespace

extern "C" {

// The instantiations: their count, the production one of each mode
// (discrete: 0 for K1, 1 for K2), and field f of variant v (0 lookup, 1
// positions per thread, 2 threads, 3 positions per block, 4 halo form, 5
// lazy mask, 6 persistent, 7 blocks per SM asked of the register
// allocation, 8 the alphabet size fixed at compile time or 0, 9 positions
// per group); -1 for an index out of range.
int lm_score_variants() { return N_VARIANTS; }
int lm_score_production(int discrete) { return discrete ? PRODUCTION_U8 : PRODUCTION_F32; }
int lm_score_variant_info(int v, int f) {
  if (v < 0 || v >= N_VARIANTS) {
    return -1;
  }
  const Variant& x = VARIANTS[v];
  const int fields[] = {x.lookup, x.p,       x.threads, x.tp, x.halo,
                        x.lazy,   x.persist, x.minb,    x.kc, x.grp};
  return f >= 0 && f < 10 ? fields[f] : -1;
}

// The variant an entry point launches for an m x k table, and the dynamic
// shared memory (bytes) of variant v for it, so the caller can check it
// against the card's limit before a launch; -1 for an index out of range.
int lm_score_pick(int discrete, int m, int k) { return pick(discrete != 0, m, k); }
long long lm_score_smem(int v, int m, int k) {
  if (v < 0 || v >= N_VARIANTS || m < 1 || k < 1) {
    return -1;
  }
  return smem_bytes(VARIANTS[v], m, k);
}

// seq: uint8 [lp]; table: float32 [m][k]; out: float32 [lp].  Each entry
// returns the CUDA error of the launch (0 when it was queued).
int lm_score_f32(const void* seq, long long lp, const void* table, int m, int k,
                 long long n_scores, void* out, void* stream) {
  return launch<false>(pick(false, m, k), seq, lp, nullptr, 0, table, m, k, n_scores, out,
                       stream);
}

// seq: uint8 [lp]; table: uint8 [m][k]; out: int32 [lp].
int lm_score_u8(const void* seq, long long lp, const void* table, int m, int k,
                long long n_scores, void* out, void* stream) {
  return launch<true>(pick(true, m, k), seq, lp, nullptr, 0, table, m, k, n_scores, out,
                      stream);
}

// The scoring probes: instantiation v in either mode on the same inputs;
// heads: uint8 [blocks][head_w], the (m-1) bytes after each block (the
// wildcard past lp), for the HALO_HEADS variants, else null.
int lm_score_variant(int v, int discrete, const void* seq, long long lp, const void* heads,
                     int head_w, const void* table, int m, int k, long long n_scores,
                     void* out, void* stream) {
  return discrete ? launch<true>(v, seq, lp, heads, head_w, table, m, k, n_scores, out, stream)
                  : launch<false>(v, seq, lp, heads, head_w, table, m, k, n_scores, out,
                                  stream);
}

}  // extern "C"
