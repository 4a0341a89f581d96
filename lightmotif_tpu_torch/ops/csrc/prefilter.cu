// Multi-motif prefilters K3, K4 and K5 for NVIDIA Hopper (sm_90a), on the
// int8 tensor cores.
//
// Replaces three Pallas TPU kernels of lightmotif_tpu/ops/multi_kernel.py:
// _any8_kernel (prefilter_any8, K3), _any_kernel (prefilter_any, K4) and
// _any16_kernel (prefilter_any16, K5).  For every window start p each computes
//
//   out[p] = max over motif lanes mo of ( sum_j cell[mo][j][s[p+j]] - t_eff[mo] )
//
// and out[p] >= 0 marks a candidate.  They differ only in the cells and the
// thresholds, which the host packs (lightmotif_tpu_torch/ops/multi.py): K3
// and K5 the u16 cells of a motif group (never-pass lanes at 2^26 and at
// 262144), K4 the u8 cells.  Each has its own C entry point
// (lm_prefilter_any8, lm_prefilter_any, lm_prefilter_any16) so that its
// launches are its own; all three launch the production instantiation of
// mma_kernel below.
//
// The form.  The window matrix X[p][j*K + s] = (s[p+j] == s) holds 0/1 bytes,
// and the host packs every lane's cells, shifted per (lane, row) by the row's
// minimum so that they are unsigned (the shifts are folded into t_eff), as
// byte planes B_q[j*K + s][mo] = (cell[mo][j][s] >> 8q) & 255, q < P (P = 1
// for u8 cells, 2 for u16, at most 4).  Then
//
//   out[p] = max_mo ( sum_q 256^q (X B_q)[p][mo] - t_eff[mo] )
//
// and every X B_q is a u8 x u8 -> s32 product on the tensor cores
// (mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32).  A plane's sum is at most
// 128 rows x 255 < 2^15 and the combined sums stay below 2^26, so every step
// is exact integer arithmetic and the order of the sums changes no bit.
//
// What bounds it: the MMA work, 2 * P * positions * K * 16 * sum(chunk_m)
// operations over the int8 peak; a byte in and four out per position are
// small beside it.  What the design does about it:
//
// * The one-hot never touches device memory.  A block stages its positions
//   and their halo once, as symbols in shared memory, and writes the one-hot
//   byte stream OH[i*K + s] = (sym[i] == s), of which row p of X is the slice
//   starting at p*K.  So a fragment register of X (4 bytes at p*K + kk) is one
//   32-bit shared load: the stream is kept in 4 copies, each shifted by one
//   byte (a funnel shift of the first), and a thread always reads the copy its
//   alignment (p*K) & 3 picks.  The copies are 8 words apart modulo 32 banks,
//   which leaves at most a 2-way bank conflict for K = 5 and K = 21.  The X
//   fragments of the first KSR k-steps stay in registers for the block's life.
// * The planes stream through shared memory with cp.async in stages of as
//   many lane chunks (16 lanes each) as the shared-memory target allows, every
//   plane of each, double-buffered: the next stage's copy is issued right
//   after the one barrier of a stage and overlaps all of its MMAs.  A lane's
//   bytes are padded to ks_max * 32 + 16 bytes, an odd number of 16-byte
//   units, so that ldmatrix reads them without bank conflicts.
// * A pass (CPP chunks) runs only the 32-deep k-steps its rows need (chunk_m
//   rows, padded to the k-step with zero cells), so short motifs cost what
//   they need; a pass of 1-3 k-steps dispatches to code compiled for that
//   count, which issues every cell load before the MMAs, and the next pass's
//   chunk_m and t_eff are loaded a pass ahead.
// * The planes of a pass run from the top byte down and the accumulators are
//   multiplied by 256 between planes (Horner), so one set of accumulators
//   serves every plane; the first MMA starts from 0, or from -t_eff when there
//   is one plane, and -t_eff enters with the last plane otherwise.  Each pass
//   folds into a running max in registers (three-way integer max); the block
//   reduces over the lanes of a fragment and then across threads with
//   __shfl_xor_sync, and writes one int32 per position: no atomics, no second
//   pass.
//
// Where it stands (NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6): at a
// database group's shape it does the bound's integer operations at about
// 20% of the int8 peak, near half the rate probe P6 reaches with mma.sync
// alone at the prefilter's operand shapes; short motifs give each pass of
// a lane chunk only a few k-steps of MMAs between its cell loads, its
// Horner step and its fold.
//
// Template parameters: POS_M, the orientation (true: positions are the M rows
// of the product and X is operand A; false: positions are the N columns, X is
// operand B and the cells are A with the 16 lanes of a chunk as M); CPP, the
// lane chunks whose accumulators live in registers at once; PW, the positions
// of each warp; NW, warps per block (positions per block = NW * PW).  The sweep of these is the probe module
// lightmotif_tpu_torch/probes/prefilter.py (P8 and P10); PRODUCTION names
// the instantiation the entry points launch.
//
// mma.sync, not wgmma: each thread builds its X fragments in registers from
// the one-hot copies, which mma.sync takes as they are; wgmma would read X
// from shared memory in its own tiled layout (a second staging of every
// block's one-hot) and keeps 64-row accumulator tiles per warpgroup, which
// would not fit the 16-lane chunks whose rows chunk_m lets us skip.
//
// Inputs: seq uint8 [lp]; planes uint8 [P][n_chunks][16][rows][K] (rows * K a
// multiple of 16); chunk_m int32 [n_chunks], one past the last row with a
// nonzero shifted cell in the chunk; t_eff int32 [n_chunks * 16].  Windows
// that run past lp read the wildcard (rank K - 1), and so does any rank >= K.
//
// The first design, a lookup of one int32 per (position, lane, row)
// in shared memory, stays below as lookup_kernel: no path of the package
// launches it; it is the baseline of probe P7 (lm_prefilter_lookup).
//
// Probe P9 (lm_prefilter_bits) is the production instantiation with another
// epilogue (BITS): instead of folding a pass into the running max it writes
// the pass's per-lane pass bits, (score >= t) & (p < n_valid[lane]), 16 lanes
// per int32 word -- one lane chunk is one word, the layout of the JAX probe
// experiments/multi_opt.py::prefilter_bits2 (bits[p][mo / 16] bit mo % 16).
// A warp ORs the bits of a chunk's 16 lanes across its eight lane groups with
// __shfl_xor_sync and one thread per position stores the word.
//
// Phase C of the database scan, the same test over compacted candidates,
// is a kernel of its own: phase_c.cu.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_attrs.cuh"


namespace {

constexpr int CH = 16;        // motif lanes per chunk
constexpr int THREADS = 256;  // threads of the lookup kernel
constexpr int MAX_PLANES = 4;
constexpr int KSR = 3;  // k-steps of X each thread keeps in registers

// ---------------------------------------------------------------------------
// Geometry of a block's shared memory, the same on the host and the device.

// Shared memory a block aims at: two blocks fit on an SM, or one.
constexpr int SMEM_TARGET_2 = 110 * 1024;
constexpr int SMEM_TARGET_1 = 200 * 1024;
constexpr int MAX_STAGE_CHUNKS = 32;

struct Geom {
  int ks_max;  // 32-deep k-steps of the deepest lane: ceil(rows * K / 32)
  int ls;      // staged bytes per lane and plane: ks_max * 32 + 16
  int cw;      // 32-bit words per one-hot copy, = 8 modulo 32
  int npos;    // sequence positions staged
  int spc;     // lane chunks per stage, a multiple of cpp
  int stage;   // bytes of one stage: spc * planes * 16 * ls
  long long smem;
};

__host__ __device__ inline Geom geom(int tp, int cpp, int rows, int k, int planes,
                                     int blocks_per_sm) {
  Geom g;
  g.ks_max = (rows * k + 31) / 32;
  g.ls = g.ks_max * 32 + 16;
  // the last byte any fragment reads is (tp - 1) * K + ks * 32 - 1, ks the
  // larger of ks_max and the KSR k-steps kept in registers
  const int ks_read = g.ks_max > KSR ? g.ks_max : KSR;
  int words = ((tp - 1) * k + ks_read * 32) / 4 + 2;
  words = words < 8 ? 8 : words;
  g.cw = (words - 8 + 31) / 32 * 32 + 8;
  // every position a byte of a copy names: (4 * cw + 2) / K
  g.npos = (4 * g.cw + 8) / k + 2;
  const long long fixed = 4LL * 4 * g.cw + (g.npos + 15) / 16 * 16;
  // as many whole passes per stage as two stages and the fixed part allow
  // within the target, and at least one
  const long long chunk = static_cast<long long>(planes) * CH * g.ls;
  const long long target = blocks_per_sm > 1 ? SMEM_TARGET_2 : SMEM_TARGET_1;
  long long spc = (target - fixed) / (2 * chunk) / cpp * cpp;
  spc = spc < cpp ? cpp : (spc > MAX_STAGE_CHUNKS ? MAX_STAGE_CHUNKS : spc);
  g.spc = static_cast<int>(spc);
  g.stage = static_cast<int>(spc * chunk);
  g.smem = 2LL * g.stage + fixed;
  return g;
}

// 32-deep k-steps of a chunk of mc rows, never past the staged depth
__device__ __forceinline__ int ksteps(int mc, int k, int ks_max) {
  const int ks = (mc * k + 31) / 32;
  return ks < ks_max ? ks : ks_max;
}

// ---------------------------------------------------------------------------
// PTX wrappers.

__device__ __forceinline__ void mma_u8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b + c, for the first k-step of a pass (c: zero, or -t_eff)
__device__ __forceinline__ void mma_u8_c(int (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1, const int (&c)[4]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared; src_bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---------------------------------------------------------------------------
// The tensor-core prefilter.

// Fragment shapes of an orientation: NT 8-lane tiles per chunk and
// position fragment, XR registers per X fragment.
template <bool POS_M>
struct Frag {
  static constexpr int NT = POS_M ? 2 : 1;
  static constexpr int XR = POS_M ? 4 : 2;
};

// The MMAs of one k-step of a pass: X fragments xs, the chunks' cells.
// POS_M: acc[f][cc][nt] is positions 16f + (grp, grp + 8) x lanes
// 16cc + 8nt + (2tig, 2tig + 1); else acc[f][cc][0] is lanes 16cc + (grp,
// grp + 8) x positions 8f + (2tig, 2tig + 1).  FIRST: the pass's first
// k-step, which starts from c_init instead of acc.
template <bool POS_M, int CPP, int NF, bool FIRST>
__device__ __forceinline__ void mma_step(
    int (&acc)[NF][CPP][Frag<POS_M>::NT][4], const unsigned (&xs)[NF][Frag<POS_M>::XR],
    const unsigned (&cell)[CPP][4], const int (&c_init)[CPP][Frag<POS_M>::NT][4]) {
#pragma unroll
  for (int cc = 0; cc < CPP; ++cc)
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      if constexpr (POS_M) {
        if constexpr (FIRST) {
          mma_u8_c(acc[f][cc][0], xs[f], cell[cc][0], cell[cc][1], c_init[cc][0]);
          mma_u8_c(acc[f][cc][1], xs[f], cell[cc][2], cell[cc][3], c_init[cc][1]);
        } else {
          mma_u8(acc[f][cc][0], xs[f], cell[cc][0], cell[cc][1]);
          mma_u8(acc[f][cc][1], xs[f], cell[cc][2], cell[cc][3]);
        }
      } else {
        if constexpr (FIRST) {
          mma_u8_c(acc[f][cc][0], cell[cc], xs[f][0], xs[f][1], c_init[cc][0]);
        } else {
          mma_u8(acc[f][cc][0], cell[cc], xs[f][0], xs[f][1]);
        }
      }
    }
}

// The cells of k-step ks of a pass's chunks: lane rows of ls bytes at pbuf.
template <int CPP>
__device__ __forceinline__ void cells_of(unsigned (&cell)[CPP][4], const unsigned char* pbuf,
                                         int ks, int ls, int lrow, int lkk) {
#pragma unroll
  for (int cc = 0; cc < CPP; ++cc)
    ldsm_x4(cell[cc], pbuf + (cc * CH + lrow) * ls + ks * 32 + lkk);
}

// X fragment f of k-step ks from the one-hot copies: A of m16n8k32 (POS_M)
// or its B.  w: this thread's first word; fw: words per fragment; hw: words
// per 8 positions.
template <bool POS_M>
__device__ __forceinline__ void x_frag(unsigned (&x)[Frag<POS_M>::XR], const uint32_t* w,
                                       int f, int ks, int fw, int hw) {
  w += 8 * ks + f * fw;
  if constexpr (POS_M) {
    x[0] = w[0];
    x[1] = w[hw];
    x[2] = w[4];
    x[3] = w[hw + 4];
  } else {
    x[0] = w[0];
    x[1] = w[4];
  }
}

// What every k-step of a pass shares: the X fragments kept in registers,
// the one-hot copies for the others, and where this thread's ldmatrix rows
// are.
template <bool POS_M, int NF>
struct PassCtx {
  const unsigned (&xreg)[KSR][NF][Frag<POS_M>::XR];
  const uint32_t* w;  // this thread's first one-hot word
  int fw, hw;         // words per X fragment, per 8 positions
  int ls, lrow, lkk;  // staged lane stride, ldmatrix row and k-byte
};

// One plane of a pass of KS k-steps, KS known when compiled: every cell
// load is issued before the MMAs that wait for it.
template <bool POS_M, int CPP, int NF, int KS, bool FIRST>
__device__ __forceinline__ void plane_fixed(
    int (&acc)[NF][CPP][Frag<POS_M>::NT][4], const PassCtx<POS_M, NF>& x,
    const int (&c_init)[CPP][Frag<POS_M>::NT][4], const unsigned char* pbuf) {
  unsigned cell[KS][CPP][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) cells_of<CPP>(cell[ks], pbuf, ks, x.ls, x.lrow, x.lkk);
  mma_step<POS_M, CPP, NF, FIRST>(acc, x.xreg[0], cell[0], c_init);
#pragma unroll
  for (int ks = 1; ks < KS; ++ks)
    mma_step<POS_M, CPP, NF, false>(acc, x.xreg[ks], cell[ks], c_init);
}

// One plane of a pass of ks_pass k-steps (FIRST: the pass's top plane).
// Past KSR k-steps X comes from the one-hot copies in shared memory.
template <bool POS_M, int CPP, int NF, bool FIRST>
__device__ __forceinline__ void run_plane(
    int (&acc)[NF][CPP][Frag<POS_M>::NT][4], const PassCtx<POS_M, NF>& x,
    const int (&c_init)[CPP][Frag<POS_M>::NT][4], const unsigned char* pbuf, int ks_pass) {
  constexpr int NT = Frag<POS_M>::NT;
  static_assert(KSR == 3, "the dispatch below covers KSR k-steps");
  switch (ks_pass) {
    case 0:  // no row of the pass has a cell: the sums are 0
      if constexpr (FIRST) {
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int cc = 0; cc < CPP; ++cc)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[f][cc][nt][r] = c_init[cc][nt][r];
      }
      return;
    case 1:
      plane_fixed<POS_M, CPP, NF, 1, FIRST>(acc, x, c_init, pbuf);
      return;
    case 2:
      plane_fixed<POS_M, CPP, NF, 2, FIRST>(acc, x, c_init, pbuf);
      return;
    default:
      plane_fixed<POS_M, CPP, NF, 3, FIRST>(acc, x, c_init, pbuf);
  }
  for (int ks = KSR; ks < ks_pass; ++ks) {
    unsigned xs[NF][Frag<POS_M>::XR];
#pragma unroll
    for (int f = 0; f < NF; ++f) x_frag<POS_M>(xs[f], x.w, f, ks, x.fw, x.hw);
    unsigned cell[CPP][4];
    cells_of<CPP>(cell, pbuf, ks, x.ls, x.lrow, x.lkk);
    mma_step<POS_M, CPP, NF, false>(acc, xs, cell, c_init);
  }
}

// Fold the sums v[f][cc][nt] of a pass's chunks into the running max (the
// chunks past n_chunks skip).
template <bool POS_M, int CPP, int NF>
__device__ __forceinline__ void fold(int (&best)[NF][2], const int (&v)[NF][CPP][Frag<POS_M>::NT][4],
                                     int live) {
#pragma unroll
  for (int cc = 0; cc < CPP; ++cc) {
    if (cc < live) {
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int nt = 0; nt < Frag<POS_M>::NT; ++nt) {
          const int* t = v[f][cc][nt];
          best[f][0] = __vimax3_s32(best[f][0], t[0], POS_M ? t[1] : t[2]);
          best[f][1] = __vimax3_s32(best[f][1], POS_M ? t[2] : t[1], t[3]);
        }
    }
  }
}

// blocks of an instantiation on an SM, as its registers allow: two when
// its 32 * NW threads keep at most 32 accumulators each (PW * CPP / 2)
__host__ __device__ constexpr int blocks_per_sm(int warps, int pw, int cpp) {
  return warps <= 8 && pw * cpp <= 64 ? 2 : 1;
}

template <bool POS_M, int CPP, int PW, int NW, bool BITS = false>
__global__ void __launch_bounds__(32 * NW, blocks_per_sm(NW, PW, CPP))
mma_kernel(const uint8_t* __restrict__ seq, long long lp,
           const uint8_t* __restrict__ planes, int n_planes, int n_chunks,
           int rows, int k, const int* __restrict__ chunk_m,
           const int* __restrict__ t_eff, int* __restrict__ out,
           const int* __restrict__ n_valid) {
  static_assert(!BITS || !POS_M, "the bits epilogue reads the positions-as-columns fragments");
  constexpr int NTHREADS = 32 * NW;
  constexpr int TP = NW * PW;                   // positions per block
  constexpr int NF = POS_M ? PW / 16 : PW / 8;  // X fragments per warp
  static_assert(PW % 16 == 0, "PW: whole 16-position tiles");

  extern __shared__ __align__(16) unsigned char smem[];
  const Geom g = geom(TP, CPP, rows, k, n_planes, blocks_per_sm(NW, PW, CPP));
  unsigned char* stages = smem;
  uint32_t* oh = reinterpret_cast<uint32_t*>(smem + 2 * g.stage);
  uint8_t* tile = reinterpret_cast<uint8_t*>(oh + 4 * g.cw);

  const long long base = static_cast<long long>(blockIdx.x) * TP;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int depth = rows * k;  // bytes per lane and plane in global memory

  // stage s: the lane chunks [s * spc, (s + 1) * spc), every plane; chunk
  // cc of plane q at buf + (q * spc + cc) * 16 * ls
  // this thread copies the 16-byte pieces tid / 16 + i * PIECE_STEP of lane
  // tid % 16: the first warps take the first pieces, which every chunk has
  constexpr int PIECE_STEP = NTHREADS / CH;
  const int copy_lane = tid & (CH - 1);
  const int copy_piece = tid / CH;
  auto load_stage = [&](int s) {
    unsigned char* buf = stages + (s & 1) * g.stage;
    const int c0 = s * g.spc;
    const int n_here = min(g.spc, n_chunks - c0);
    for (int cc = 0; cc < n_here; ++cc) {
      // every chunk of a pass runs the pass's k-steps: rows past a chunk's
      // chunk_m are zero in the planes, or zero-filled past a lane's bytes
      const int first = cc - cc % CPP;
      int ks = 0;
      for (int i = first; i < first + CPP && i < n_here; ++i) {
        ks = max(ks, ksteps(__ldg(chunk_m + c0 + i), k, g.ks_max));
      }
      for (int q = 0; q < n_planes; ++q) {
        const uint8_t* src = planes +
            ((static_cast<size_t>(q) * n_chunks + c0 + cc) * CH + copy_lane) * depth;
        unsigned char* dst = buf + ((q * g.spc + cc) * CH + copy_lane) * g.ls;
        for (int piece = copy_piece; piece < 2 * ks; piece += PIECE_STEP) {
          const bool in = piece * 16 < depth;
          cp_async16(dst + piece * 16, in ? src + piece * 16 : planes, in ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };

  load_stage(0);

  const uint8_t wildcard = static_cast<uint8_t>(k - 1);
  uint8_t* oh0 = reinterpret_cast<uint8_t*>(oh);
  // the block's symbols, the wildcard past the end and for any rank >= K
  for (int i = tid; i < g.npos; i += NTHREADS) {
    const long long p = base + i;
    const uint8_t s = p < lp ? seq[p] : wildcard;
    tile[i] = s < wildcard ? s : wildcard;
  }
  // copy 0 is the one-hot stream itself: K bytes per position, zero past
  // the staged positions
  for (int w = tid; w < g.cw; w += NTHREADS) oh[w] = 0;
  __syncthreads();
  for (int i = tid; i < g.npos; i += NTHREADS) {
    const int b = i * k + tile[i];
    if (b < 4 * g.cw) oh0[b] = 1;
  }
  __syncthreads();
  // copy c, word w: the bytes OH[4w + c .. 4w + c + 3], a funnel shift of
  // words w and w + 1 of copy 0
  for (int w = tid; w < g.cw; w += NTHREADS) {
    const uint32_t lo = oh[w];
    const uint32_t hi = w + 1 < g.cw ? oh[w + 1] : 0u;
#pragma unroll
    for (int c = 1; c < 4; ++c) oh[c * g.cw + w] = __funnelshift_r(lo, hi, 8 * c);
  }

  // this thread's one-hot words: the row (POS_M) or column (else) of its
  // first fragment, at k-byte tig * 4; every other fragment of the thread is
  // a multiple of 4 bytes away, so one copy serves them all
  const int p_first = warp * PW + grp;
  const int off = p_first * k + tig * 4;
  const uint32_t* ohp = oh + (off & 3) * g.cw + (off >> 2);
  // 16 or 8 positions further
  const int frag_words = POS_M ? 4 * k : 2 * k;
  const int half_words = 2 * k;  // 8 positions further (POS_M)

  constexpr int XR = Frag<POS_M>::XR;
  constexpr int NT = Frag<POS_M>::NT;

  // ldmatrix row of this thread inside a staged chunk
  const int lrow = POS_M ? (lane & 7) + ((lane >> 4) << 3) : (lane & 7) + (((lane >> 3) & 1) << 3);
  const int lkk = POS_M ? ((lane >> 3) & 1) * 16 : (lane >> 4) * 16;

  // the first KSR k-steps of X stay in registers for the block's life
  unsigned xreg[KSR][NF][XR];
  const PassCtx<POS_M, NF> ctx{xreg, ohp, frag_words, half_words, g.ls, lrow, lkk};
  int best[NF][2];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    best[f][0] = best[f][1] = INT_MIN;
  }

  // chunk_m and t_eff of the next pass, loaded a pass ahead
  int cm_next[CPP];
  int tv_next[CPP][NT][2];
  auto prefetch = [&](int c_first) {
#pragma unroll
    for (int cc = 0; cc < CPP; ++cc) {
      const int c = c_first + cc;
      const bool live = c < n_chunks;
      cm_next[cc] = live ? __ldg(chunk_m + c) : 0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // POS_M: lanes 8nt + 2tig and + 1; else lanes grp and grp + 8
        const int l0 = c * CH + (POS_M ? nt * 8 + 2 * tig : grp);
        tv_next[cc][nt][0] = live ? __ldg(t_eff + l0) : 0;
        tv_next[cc][nt][1] = live ? __ldg(t_eff + l0 + (POS_M ? 1 : 8)) : 0;
      }
    }
  };

  __syncthreads();  // the one-hot copies are complete
#pragma unroll
  for (int ks = 0; ks < KSR; ++ks)
#pragma unroll
    for (int f = 0; f < NF; ++f) x_frag<POS_M>(xreg[ks][f], ohp, f, ks, frag_words, half_words);

  prefetch(0);
  const int n_stages = (n_chunks + g.spc - 1) / g.spc;
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_all();
    // stage s visible to all, and every thread is done with stage s - 1,
    // whose buffer the next copy takes
    __syncthreads();
    if (s + 1 < n_stages) {
      load_stage(s + 1);
    }
    const unsigned char* buf = stages + (s & 1) * g.stage;
    const int c_stage = s * g.spc;
    const int n_here = min(g.spc, n_chunks - c_stage);

    for (int c0 = 0; c0 < n_here; c0 += CPP) {
      // the pass: chunks c_stage + c0 + cc, their k-steps and thresholds
      // (tile register r reads tv[..][r & 1] for POS_M, else tv[..][r >> 1])
      int tv[CPP][NT][4];
      int ks_pass = 0;
#pragma unroll
      for (int cc = 0; cc < CPP; ++cc) {
        ks_pass = max(ks_pass, ksteps(cm_next[cc], k, g.ks_max));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) tv[cc][nt][r] = -tv_next[cc][nt][POS_M ? r & 1 : r >> 1];
      }
      prefetch(c_stage + c0 + CPP);
      const int live = n_here - c0;
      const unsigned char* plane0 = buf + c0 * CH * g.ls;
      const int plane_bytes = g.spc * CH * g.ls;

      // planes from the top byte down, Horner between them: acc = 256 *
      // acc, from 0, and -t_eff enters with the last plane
      int acc[NF][CPP][NT][4];
      int c_init[CPP][NT][4];
#pragma unroll
      for (int cc = 0; cc < CPP; ++cc)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) c_init[cc][nt][r] = n_planes == 1 ? tv[cc][nt][r] : 0;
      for (int q = n_planes - 1; q >= 0; --q) {
        const unsigned char* pbuf = plane0 + q * plane_bytes;
        if (q == n_planes - 1) {
          run_plane<POS_M, CPP, NF, true>(acc, ctx, c_init, pbuf, ks_pass);
        } else {
          run_plane<POS_M, CPP, NF, false>(acc, ctx, c_init, pbuf, ks_pass);
        }
        if (q > 0) {
#pragma unroll
          for (int f = 0; f < NF; ++f)
#pragma unroll
            for (int cc = 0; cc < CPP; ++cc)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int r = 0; r < 4; ++r)
                  acc[f][cc][nt][r] = acc[f][cc][nt][r] * 256 + (q == 1 ? tv[cc][nt][r] : 0);
        }
      }
      if constexpr (BITS) {
        // positions 8f + 2tig + (r & 1) of the warp; lanes grp (r < 2) and
        // grp + 8 (r >= 2) of each chunk
#pragma unroll
        for (int cc = 0; cc < CPP; ++cc) {
          if (cc < live) {
            const int c = c_stage + c0 + cc;
            const int nv_lo = __ldg(n_valid + c * CH + grp);
            const int nv_hi = __ldg(n_valid + c * CH + grp + 8);
#pragma unroll
            for (int f = 0; f < NF; ++f)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int i = warp * PW + 8 * f + 2 * tig + r;
                const long long p = base + i;
                const int* a = acc[f][cc][0];
                unsigned word = (a[r] >= 0 && p < nv_lo ? 1u << grp : 0u) |
                                (a[r + 2] >= 0 && p < nv_hi ? 1u << (grp + 8) : 0u);
                word |= __shfl_xor_sync(0xffffffffu, word, 4);
                word |= __shfl_xor_sync(0xffffffffu, word, 8);
                word |= __shfl_xor_sync(0xffffffffu, word, 16);
                if (grp == 0 && base + i < lp) {
                  out[(base + i) * n_chunks + c] = static_cast<int>(word);
                }
              }
          }
        }
      } else {
        fold<POS_M, CPP, NF>(best, acc, live);
      }
    }
  }
  if constexpr (BITS) {
    return;
  }

#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int v = best[f][r];
      if constexpr (POS_M) {
        // the quad holds the lanes of one position
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const long long p = base + warp * PW + 16 * f + grp + 8 * r;
        if (tig == 0 && p < lp) out[p] = v;
      } else {
        // the eight groups hold the lanes of one position
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 4));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 8));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 16));
        const long long p = base + warp * PW + 8 * f + 2 * tig + r;
        if (grp == 0 && p < lp) out[p] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The instantiations: (orientation, lane chunks per pass, positions per warp).

struct Variant {
  bool pos_m;
  int cpp;
  int pw;
  int warps;
};

#define LM_VARIANTS(X) \
  X(true, 1, 32, 8)    \
  X(true, 1, 64, 8)    \
  X(true, 1, 128, 8)   \
  X(true, 1, 64, 16)   \
  X(true, 2, 64, 8)    \
  X(false, 1, 32, 8)   \
  X(false, 1, 64, 8)   \
  X(false, 1, 128, 8)  \
  X(false, 1, 64, 16)  \
  X(false, 2, 64, 8)

#define LM_VARIANT_ROW(pm, cpp, pw, warps) {pm, cpp, pw, warps},
constexpr Variant VARIANTS[] = {LM_VARIANTS(LM_VARIANT_ROW)};
constexpr int N_VARIANTS = sizeof(VARIANTS) / sizeof(VARIANTS[0]);

// the instantiation the three entry points launch (an index of VARIANTS):
// positions as columns, one lane chunk per pass, 128 positions per warp, 8
// warps; the fastest of the sweep at bench.py's u8 row and within the noise
// of the fastest at a database group's shape on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md, section 6)
constexpr int PRODUCTION = 7;

template <bool POS_M, int CPP, int PW, int NW, bool BITS = false>
int launch_variant(const void* seq, long long lp, const void* planes,
                   int n_planes, int n_chunks, int rows, int k,
                   const void* chunk_m, const void* t_eff, void* out,
                   void* stream, const void* n_valid = nullptr) {
  constexpr int TP = NW * PW;
  const Geom g = geom(TP, CPP, rows, k, n_planes, blocks_per_sm(NW, PW, CPP));
  auto kernel = mma_kernel<POS_M, CPP, PW, NW, BITS>;
  static std::atomic<int> allowed[MAX_DEVICES];
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), allowed, g.smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long blocks = (lp + TP - 1) / TP;
  kernel<<<static_cast<unsigned int>(blocks), 32 * NW, g.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), lp, static_cast<const uint8_t*>(planes),
      n_planes, n_chunks, rows, k, static_cast<const int*>(chunk_m),
      static_cast<const int*>(t_eff), static_cast<int*>(out),
      static_cast<const int*>(n_valid));
  return static_cast<int>(cudaGetLastError());
}

int launch(int v, const void* seq, long long lp, const void* planes,
           int n_planes, int n_chunks, int rows, int k, const void* chunk_m,
           const void* t_eff, void* out, void* stream) {
  if (n_planes < 1 || n_planes > MAX_PLANES || (rows * k) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int i = 0;
#define LM_VARIANT_CASE(pm, cpp, pw, warps)                                     \
  if (v == i++) {                                                               \
    return launch_variant<pm, cpp, pw, warps>(seq, lp, planes, n_planes, n_chunks, \
                                              rows, k, chunk_m, t_eff, out, stream); \
  }
  LM_VARIANTS(LM_VARIANT_CASE)
#undef LM_VARIANT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The first design, the lookup kernel (P7's baseline; no path of the package
// launches it).  A block stages TILE = 1024 positions and their halo once, then walks
// the lane chunks: for each it stages the chunk's int32 rows (80-byte rows,
// so the K rows of one j fall in different banks) and every thread adds, for
// each of its 4 positions and each row, the 16 lane values of that row's
// symbol, then folds acc - t_eff into a running max.  Table: int32
// [n_chunks][m][k][16].

constexpr int PPT = 4;
constexpr int TILE = THREADS * PPT;
constexpr int ROW = CH + 4;  // int32 per staged (j, symbol) row: 80 bytes

__global__ void __launch_bounds__(THREADS)
lookup_kernel(const uint8_t* __restrict__ seq, long long lp,
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

long long lookup_smem(int m, int k) {
  return static_cast<long long>(m) * k * ROW * sizeof(int) + TILE + m - 1;
}

}  // namespace

extern "C" {

// Lanes per chunk of the plane layout.
int lm_prefilter_lanes() { return CH; }

// The instantiations: their count, the production one, and each one's
// (warps << 24) | (orientation << 16) | (lane chunks per pass << 8) |
// positions per warp; -1 for an index out of range.
int lm_prefilter_variants() { return N_VARIANTS; }
int lm_prefilter_production() { return PRODUCTION; }
int lm_prefilter_variant_info(int v) {
  if (v < 0 || v >= N_VARIANTS) {
    return -1;
  }
  return (VARIANTS[v].warps << 24) | (VARIANTS[v].pos_m ? 1 << 16 : 0) |
         (VARIANTS[v].cpp << 8) | VARIANTS[v].pw;
}

// Dynamic shared memory (bytes) of instantiation v for `planes` byte planes
// of rows x K, so the caller can check it against the card's limit before a
// launch.
long long lm_prefilter_smem(int v, int rows, int k, int planes) {
  if (v < 0 || v >= N_VARIANTS || rows < 1 || k < 1 || planes < 1) {
    return -1;
  }
  const Variant& x = VARIANTS[v];
  return geom(x.warps * x.pw, x.cpp, rows, k, planes, blocks_per_sm(x.warps, x.pw, x.cpp)).smem;
}

// seq: uint8 [lp]; planes: uint8 [n_planes][n_chunks][16][rows][k]; chunk_m:
// int32 [n_chunks]; t_eff: int32 [n_chunks * 16]; out: int32 [lp].  Each
// returns the CUDA error of the launch (0 when it was queued).

// K3: the u16 planes of pack_filters_k3.
int lm_prefilter_any8(const void* seq, long long lp, const void* planes,
                      int n_planes, int n_chunks, int rows, int k,
                      const void* chunk_m, const void* t_eff, void* out,
                      void* stream) {
  return launch(PRODUCTION, seq, lp, planes, n_planes, n_chunks, rows, k,
                chunk_m, t_eff, out, stream);
}

// K4: the u8 plane of pack_filters_k4.
int lm_prefilter_any(const void* seq, long long lp, const void* planes,
                     int n_planes, int n_chunks, int rows, int k,
                     const void* chunk_m, const void* t_eff, void* out,
                     void* stream) {
  return launch(PRODUCTION, seq, lp, planes, n_planes, n_chunks, rows, k,
                chunk_m, t_eff, out, stream);
}

// K5: the u16 planes of pack_filters_k5.
int lm_prefilter_any16(const void* seq, long long lp, const void* planes,
                       int n_planes, int n_chunks, int rows, int k,
                       const void* chunk_m, const void* t_eff, void* out,
                       void* stream) {
  return launch(PRODUCTION, seq, lp, planes, n_planes, n_chunks, rows, k,
                chunk_m, t_eff, out, stream);
}

// Probes P8 and P10: instantiation v on the same inputs.
int lm_prefilter_variant(int v, const void* seq, long long lp,
                         const void* planes, int n_planes, int n_chunks,
                         int rows, int k, const void* chunk_m,
                         const void* t_eff, void* out, void* stream) {
  return launch(v, seq, lp, planes, n_planes, n_chunks, rows, k, chunk_m,
                t_eff, out, stream);
}

// Probe P9: the production instantiation with the bits epilogue; n_valid:
// int32 [n_chunks * 16]; out: int32 [lp][n_chunks], bit l of word c the pass
// bit of lane 16c + l.
int lm_prefilter_bits(const void* seq, long long lp, const void* planes,
                      int n_planes, int n_chunks, int rows, int k,
                      const void* chunk_m, const void* t_eff, const void* n_valid,
                      void* out, void* stream) {
  constexpr Variant x = VARIANTS[PRODUCTION];
  static_assert(!x.pos_m && x.cpp == 1 && x.pw == 128 && x.warps == 8,
                "the bits probe instantiates the production variant");
  if (n_planes < 1 || n_planes > MAX_PLANES || (rows * k) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_variant<false, 1, 128, 8, true>(seq, lp, planes, n_planes, n_chunks, rows, k,
                                                chunk_m, t_eff, out, stream, n_valid);
}

// Probe P7's baseline, the lookup kernel: table int32 [n_chunks][m][k][16].
long long lm_prefilter_lookup_smem(int m, int k) { return lookup_smem(m, k); }

int lm_prefilter_lookup(const void* seq, long long lp, const void* table,
                        const void* chunk_m, const void* t_eff, int n_chunks,
                        int m, int k, void* out, void* stream) {
  const long long smem = lookup_smem(m, k);
  static std::atomic<int> allowed[MAX_DEVICES];
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(lookup_kernel), allowed,
                                     smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long blocks = (lp + TILE - 1) / TILE;
  lookup_kernel<<<static_cast<unsigned int>(blocks), THREADS, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), lp, static_cast<const int*>(table),
      static_cast<const int*>(chunk_m), static_cast<const int*>(t_eff),
      n_chunks, m, k, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
