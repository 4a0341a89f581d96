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
// launches are its own; all three launch gmma_prefilter below.
//
// The form.  The window matrix X[p][j*K + s] = (s[p+j] == s) holds 0/1 bytes,
// and the host packs every lane's cells, shifted per (lane, row) by the row's
// minimum so that they are unsigned (the shifts are folded into t_eff), as
// byte planes B_q[j*K + s][mo] = (cell[mo][j][s] >> 8q) & 255, q < P (P = 1
// for u8 cells, 2 for u16, at most 4).  Then
//
//   out[p] = max_mo ( sum_q 256^q (X B_q)[p][mo] - t_eff[mo] )
//
// and every X B_q is a u8 x u8 -> s32 product on the tensor cores.  A
// plane's sum is at most 128 rows x 255 < 2^15 and the combined sums stay
// below 2^26, so every step is exact integer arithmetic and the order of
// the sums changes no bit.
//
// What bounds it: the MMA work over the int8 peak; a byte in and four out
// per position are small beside it.  Two kernels compute it:
//
// gmma_prefilter, what the three entry points launch, on Hopper's warpgroup
// MMAs (wgmma.mma_async m64n128k32 .s32.u8.u8), with the design of probe P6
// (probe_gmma.cu) adapted to the prefilter's inputs:
//
// * Tiles.  Positions are the M rows, lanes the N columns, 128 lanes a
//   tile: eight 16-lane chunks of the length-sorted group.  Two consumer
//   warpgroups each take 64 or 128 positions of a tile (one or two 64-row
//   halves) and one producer warpgroup issues the copies (setmaxnreg gives
//   its registers to the consumers).  Blocks are persistent, one per SM,
//   walking the position tiles; no clusters (P6 measured them no faster).
// * The one-hot windows X are nowhere in device memory.  Each consumer
//   warpgroup writes its positions and their halo as the one-hot byte
//   stream OH[i*K + s] = (sym[i] == s) (X's row p is the stream from byte
//   p*K on) and then its rows of X into shared memory, once per tile, each
//   16-byte piece a funnel shift of five words of the stream, in the
//   K-major layout with the 32-byte swizzle that the wgmma descriptors
//   name.  The tile then serves every lane tile of the group.  (X as
//   register fragments instead, as mma_kernel builds them, would be loaded
//   again for every lane tile and hold registers the accumulators need.)
// * The planes come packed for this kernel (multi_kernel.gmma_blocks, on
//   the host when a group is packed; the 5-D planes stay as they are for
//   phase C): blocks of one 32-byte k-step of one plane of a lane tile (128
//   lanes x 32 bytes, each row's halves already swizzled), in the order the
//   consumers multiply them: lane tile by lane tile, planes from the top,
//   only the k-steps of the tile's deepest chunk (chunk_m), so short tiles
//   cost what they need.  Those k-steps come with the launch, worked out on
//   the host with the blocks, which the launch checks against them: the
//   kernel reads no chunk_m.  The producers stream them, one bulk copy of 4,096
//   contiguous bytes each, through a ring of such units in shared memory; a
//   unit is free again once each of the eight consumer warps has released
//   it (P6's per-warp release).  (TMA boxes over the 5-D planes instead,
//   rows of 32 bytes at a stride of rows * K bytes, took 1.6x as long at a
//   database group's shape on an H100: PERF.md section 6.)
// * A tile of 256 positions (two halves a warpgroup) when the shape's lanes
//   have at most G_TWO_KS k-steps and one or two planes: each unit then
//   feeds four MMAs, halving the bytes streamed a result, and the two
//   halves' accumulator sets overlap one half's Horner step or fold with
//   the other's MMAs.  Deeper shapes take 128 positions, one half a
//   warpgroup and plane after plane, in commit groups of up to G_GROUP
//   k-steps, a loop that waits for each group before it goes round.  The
//   deepest tile the entry points take, 1,024 bytes a lane, fits then.
//   (Every depth unrolled whole instead, one group in flight while the
//   next is issued, ran 14-26% faster at 10 to 21 k-steps on an H100 but
//   took this file 121 s to compile against 31; the benchmark's groups
//   have at most 8 k-steps: PERF.md section 6.)
// * No loop back edge and no branch carries an MMA group in flight (ptxas
//   serialises every wgmma then, its note C7514): the two-half tiles'
//   k-steps are unrolled whole, chosen by a switch on the lane tile's
//   count, and every tile ends with all of its MMAs waited for; a deep
//   group is waited for within its own case of a switch on its size.
// * Planes run from the top byte down into one accumulator set (Horner):
//   acc = 256 acc, and -t_eff enters with the last shift, one IMAD a
//   (position, lane) pair; with one plane the accumulators start from
//   -t_eff.  The fold into a running max per row is a three-way integer
//   max (half an operation a pair); lanes past the group start from
//   INT_MIN.  -t_eff of every lane sits in shared memory, read where it is
//   used.  The rows' maxima merge across the quad with __shfl_xor_sync and
//   one int32 a position is stored: no atomics, no second pass.
// * It takes every shape with rows * K <= 1,024 bytes (32 k-steps) and at
//   most 64 lane tiles (8,192 lanes): every group that supports_fused
//   routes to a prefilter.  The entry points choose by the shape alone and
//   give other shapes to mma_kernel.
//
// mma_kernel, the earlier design on mma.sync m16n8k32: each warp builds its
// X fragments from four shifted one-hot copies and streams the planes with
// cp.async in 16-lane chunks, in stages double-buffered, one pass of a
// chunk running only its chunk_m k-steps, Horner between planes, a running
// max in registers.  It reached about 20% of the int8 peak at a database
// group's shape (PERF.md section 6): short motifs give each pass of a lane
// chunk only a few k-steps of MMAs between its cell loads, its Horner step
// and its fold.  It stays as the instantiations probes P8 and P10 sweep
// (lm_prefilter_variant), as P9's bits form and the time P9 sets them
// beside, as the comparison the card tests and chip_smoke.py time in
// turns, and for the shapes the warpgroup kernel does not take.
//
// Template parameters of mma_kernel: POS_M, the orientation (true: positions are the M rows
// of the product and X is operand A; false: positions are the N columns, X is
// operand B and the cells are A with the 16 lanes of a chunk as M); CPP, the
// lane chunks whose accumulators live in registers at once; PW, the positions
// of each warp; NW, warps per block (positions per block = NW * PW).  The sweep of these is the probe module
// lightmotif_tpu_torch/probes/prefilter.py (P8 and P10); PRODUCTION names
// the instantiation the entry points launch for the shapes gmma_prefilter
// does not take.
//
// Inputs: seq uint8 [lp]; planes uint8 [P][n_chunks][16][rows][K] (rows * K a
// multiple of 16); chunk_m int32 [n_chunks], one past the last row with a
// nonzero shifted cell in the chunk; t_eff int32 [n_chunks * 16]; for
// gmma_prefilter, the planes' blocks and their k-steps a lane tile.
// Windows that run past lp read the wildcard (rank K - 1), and so does any
// rank >= K.
//
// The first design, a lookup of one int32 per (position, lane, row)
// in shared memory, stays below as lookup_kernel: no path of the package
// launches it; it is the baseline of probe P7 (lm_prefilter_lookup).
//
// Probe P9 (lm_prefilter_bits) is mma_kernel's production instantiation with another
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

#include "gmma.cuh"
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


// ---------------------------------------------------------------------------
// The warpgroup prefilter (gmma_prefilter): the design is in the note at the
// top of this file.

constexpr int G_LANES = 128;               // lanes per tile: the MMA's N
constexpr int G_HALF = 64;                 // positions of one MMA: its M
constexpr int G_KSTEP = 32;                // bytes of depth per MMA
constexpr int G_BLOCK = G_LANES * G_KSTEP; // a block: one k-step of one plane of a lane tile
constexpr int G_MAX_KS = 32;               // k-steps of the deepest lane: 1,024 bytes
constexpr int G_MAX_LTILES = 64;           // lane tiles: 8,192 lanes
constexpr int G_TWO_KS = 8;                // the deepest shape whose warpgroups take two halves
constexpr int G_GROUP = 4;                 // k-steps per commit group of a deep tile
constexpr int G_MAX_UNITS = 32;            // ring units, one block each
constexpr int G_MIN_UNITS = 2 * G_TWO_KS;  // a tile's two planes in flight
constexpr int G_PRODUCERS = 4;             // threads issuing copies, one per producer warp
constexpr int G_THREADS = 384;
constexpr int G_CONSUMER_WARPS = 8;
constexpr long long G_SMEM_MAX = 232448;   // dynamic shared memory a block may use

// The geometry of a shape, the same on the host and the device: the tile
// of positions (each consumer warpgroup's rows: two halves of 64 when the
// shape's lanes have at most G_TWO_KS k-steps and one or two planes, else
// one), and the block's shared memory from a 1024-byte aligned base: the
// window tile X (ks k-steps of the tile's rows x 32 bytes), the ring, each
// consumer warpgroup's one-hot stream, -t_eff of every lane tile's 128
// lanes, the k-steps of every lane tile, the ring's barriers.
struct GGeom {
  int ks;      // k-steps of the deepest lane the shape allows: ceil(rows * K / 32)
  int halves;  // 64-row halves of a consumer warpgroup
  int pos;     // positions per tile: 2 x 64 x halves
  int oh;      // bytes of a warpgroup's one-hot stream, a multiple of 16
  int npos;    // positions whose one-hot bytes it holds
  int ltiles;  // lane tiles
  int units;   // ring units
  int ring, ohs, negt, tks, bars;  // offsets
  long long smem;
};

__host__ __device__ inline GGeom ggeom(int n_planes, int n_chunks, int rows, int k) {
  GGeom g;
  g.ks = (rows * k + G_KSTEP - 1) / G_KSTEP;
  g.halves = g.ks <= G_TWO_KS && n_planes <= 2 ? 2 : 1;
  g.pos = 2 * G_HALF * g.halves;
  // a row's window reads bytes r*K .. r*K + 32 ks - 1 of the stream, the
  // X build a word past its last piece
  g.oh = ((G_HALF * g.halves - 1) * k + g.ks * G_KSTEP + 8 + 15) / 16 * 16;
  g.npos = (g.oh + k - 1) / k;
  g.ltiles = (n_chunks * CH + G_LANES - 1) / G_LANES;
  g.ring = g.ks * g.pos * G_KSTEP;
  const int tks_bytes = (g.ltiles + 15) / 16 * 16;
  const long long rest = 1024 + g.ring + 2LL * g.oh + 4LL * G_LANES * g.ltiles + tks_bytes;
  long long units = (G_SMEM_MAX - rest) / (G_BLOCK + 16);
  units = units > G_MAX_UNITS ? G_MAX_UNITS : units;
  g.units = static_cast<int>(units < 0 ? 0 : units);
  g.ohs = g.ring + g.units * G_BLOCK;
  g.negt = g.ohs + 2 * g.oh;
  g.tks = g.negt + 4 * G_LANES * g.ltiles;
  g.bars = g.tks + tks_bytes;
  g.smem = 1024LL + g.bars + 16LL * g.units;
  return g;
}

// Whether gmma_prefilter takes a shape: planes of rows x K bytes a lane and
// n_chunks 16-lane chunks.
__host__ __device__ inline bool gmma_takes(int n_planes, int n_chunks, int rows, int k) {
  if (n_planes < 1 || n_planes > MAX_PLANES || n_chunks < 1 || rows < 1 || k < 2 || k > 256 ||
      rows * k > G_MAX_KS * G_KSTEP) {
    return false;
  }
  const GGeom g = ggeom(n_planes, n_chunks, rows, k);
  return g.ltiles <= G_MAX_LTILES && g.units >= G_MIN_UNITS && g.smem <= G_SMEM_MAX;
}

// 4 KB from global to shared memory, completing on the barrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "n"(G_BLOCK), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile of 32-byte rows with the 32-byte
// swizzle: start address >> 4, leading offset unused (1), 8-row groups 256
// bytes apart, layout type 3 (B32)
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(256 >> 4) << 32) | (uint64_t(3) << 62);
}

// one k-step: d (+)= X[64 x 32 B] . B[128 lanes x 32 B]^T, u8 x u8 -> s32;
// `accumulate` 0 starts the sums afresh
__device__ __forceinline__ void wgmma_u8(int (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 " LM_REGS64 ", %64, %65, p;\n}\n"
      : LM_D64(LM_R)
      : "l"(da), "l"(db), "r"(accumulate));
}

// A consumer's view of the ring: the next unit to take (and its phase), the
// next to give back.  Every thread of both consumer warpgroups walks the
// same sequence of units as the producers.
struct Ring {
  uint32_t base, bars;
  int units;
  int u = 0, back = 0;
  uint32_t phase = 0;
  __device__ uint32_t full(int i) const { return bars + 8u * i; }
  __device__ uint32_t empty(int i) const { return bars + 8u * (units + i); }
  // wait for the next n units; returns the first one's index
  __device__ __forceinline__ int take(int n) {
    const int first = u;
    for (int i = 0; i < n; ++i) {
      mbar_wait(full(u), phase);
      if (++u == units) {
        u = 0;
        phase ^= 1;
      }
    }
    return first;
  }
  // the shared address of the i-th unit from the unit `first`
  __device__ __forceinline__ uint32_t at(int first, int i) const {
    const int v = first + i;
    return base + static_cast<uint32_t>(v < units ? v : v - units) * G_BLOCK;
  }
  // give back the n oldest units taken; each warp arrives for itself
  __device__ __forceinline__ void give(int n, int lane) {
    for (int i = 0; i < n; ++i) {
      if (lane == 0) mbar_arrive(empty(back));
      if (++back == units) back = 0;
    }
  }
};

// -t_eff of this thread's columns 8 jj + 2 quad (+1) of a lane tile: nt
// points at column 2 quad of the tile in the block's copy in shared memory
// (INT_MIN past the group's lanes), read where each value is used
__device__ __forceinline__ int2 nt_of(const int* nt, int jj) {
  return *reinterpret_cast<const int2*>(nt + 8 * jj);
}

// acc = 256 acc, + -t_eff when the last plane is still to come
__device__ __forceinline__ void horner(int (&acc)[64], const int* nt, bool add) {
  if (add) {
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int2 v = nt_of(nt, jj);
      acc[4 * jj] = acc[4 * jj] * 256 + v.x;
      acc[4 * jj + 1] = acc[4 * jj + 1] * 256 + v.y;
      acc[4 * jj + 2] = acc[4 * jj + 2] * 256 + v.x;
      acc[4 * jj + 3] = acc[4 * jj + 3] * 256 + v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= 256;
  }
}

// the sums start from -t_eff (one plane)
__device__ __forceinline__ void start_at(int (&acc)[64], const int* nt) {
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int2 v = nt_of(nt, jj);
    acc[4 * jj] = acc[4 * jj + 2] = v.x;
    acc[4 * jj + 1] = acc[4 * jj + 3] = v.y;
  }
}

// best[0] over row r, best[1] over row r + 8: acc[4 jj + (0, 1)] holds row
// r, columns 8 jj + 2 quad (+1), acc[4 jj + (2, 3)] row r + 8
__device__ __forceinline__ void fold(int* best, const int (&acc)[64]) {
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    best[0] = __vimax3_s32(best[0], acc[4 * jj], acc[4 * jj + 1]);
    best[1] = __vimax3_s32(best[1], acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

// every sum of the tile is 0 (none of its rows has a cell): fold -t_eff
__device__ __forceinline__ void fold_nt(int* best, const int* nt) {
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int2 v = nt_of(nt, jj);
    best[0] = __vimax3_s32(best[0], v.x, v.y);
    best[1] = __vimax3_s32(best[1], v.x, v.y);
  }
}

// One commit group: N k-steps of one plane of a lane tile from the N ring
// units from `first` on, against the 64 rows of X at x_rows (XS bytes a
// k-step of X, x_rows at the group's first k-step), into acc (scale0 0: the
// first k-step starts the sums afresh).
template <int N, int XS>
__device__ __forceinline__ void mma_group(int (&acc)[64], uint32_t x_rows, const Ring& ring,
                                          int first, int scale0) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    wgmma_u8(acc, sw32_desc(x_rows + i * XS), sw32_desc(ring.at(first, i)), i ? 1 : scale0);
  }
  wgmma_commit();
  fence_regs(acc);
}

constexpr int DEEP_XS = 2 * G_HALF * G_KSTEP;  // a k-step of X: 128 rows
constexpr int TWO_XS = 4 * G_HALF * G_KSTEP;   // 256 rows

// One commit group of a deep shape (one 64-row half a warpgroup, X slabs
// of 128 rows): N k-steps from the ring's next units, waited for and
// given back before it returns.
template <int N>
__device__ __forceinline__ void deep_group(int (&acc)[64], Ring& ring, uint32_t x_rows,
                                           int scale0, int lane) {
  const int first = ring.take(N);
  mma_group<N, DEEP_XS>(acc, x_rows, ring, first, scale0);
  wgmma_wait<0>();
  fence_regs(acc);
  ring.give(N, lane);
}

// One plane of one lane tile of a deep shape: ks k-steps in commit groups
// of up to G_GROUP, x_rows at k-step 0.  Each group is waited for within
// its own case, so that no group is in flight across a branch or the
// loop's back edge.
__device__ __forceinline__ void plane_mmas(int (&acc)[64], Ring& ring, uint32_t x_rows, int ks,
                                           int scale0, int lane) {
  static_assert(G_GROUP == 4, "a case for every group size");
  for (int k0 = 0; k0 < ks; k0 += G_GROUP) {
    const uint32_t x = x_rows + k0 * DEEP_XS;
    const int s0 = k0 ? 1 : scale0;
    switch (ks - k0) {
      case 1: deep_group<1>(acc, ring, x, s0, lane); break;
      case 2: deep_group<2>(acc, ring, x, s0, lane); break;
      case 3: deep_group<3>(acc, ring, x, s0, lane); break;
      default: deep_group<G_GROUP>(acc, ring, x, s0, lane); break;
    }
  }
}

// A lane tile of a deep shape against one 64-row half: plane after plane,
// from the top byte down, Horner between them, each plane waited for.
__device__ __forceinline__ void deep_tile(int* best, int (&acc)[64], Ring& ring, uint32_t x_rows,
                                          const int* nt, int ks, int n_planes, int lane) {
  if (ks == 0) {
    fold_nt(best, nt);
    return;
  }
  if (n_planes == 1) start_at(acc, nt);
  for (int q = n_planes - 1; q >= 0; --q) {
    plane_mmas(acc, ring, x_rows, ks, q == n_planes - 1 && n_planes > 1 ? 0 : 1, lane);
    if (q > 0) horner(acc, nt, q == 1);
  }
  fold(best, acc);
}

// A lane tile of P = 1 or 2 planes and KS k-steps against both 64-row
// halves of a warpgroup (x_rows, x_rows + 64 rows), into two accumulator
// sets: each plane's units are taken once and multiply both halves, one
// commit group a half and plane, so that while one half's shift or fold
// runs, the other's MMAs are queued.  The last group is waited for before
// it returns.
template <int KS, int P>
__device__ __forceinline__ void two_halves(int* best, int (&a)[64], int (&b)[64], Ring& ring,
                                           uint32_t x_rows, const int* nt, int lane) {
  constexpr uint32_t X1 = G_HALF * G_KSTEP;  // the second half's rows
  const int top = ring.take(KS);
  if constexpr (P == 1) {
    start_at(a, nt);
    start_at(b, nt);
    mma_group<KS, TWO_XS>(a, x_rows, ring, top, 1);
    mma_group<KS, TWO_XS>(b, x_rows + X1, ring, top, 1);
  } else {
    mma_group<KS, TWO_XS>(a, x_rows, ring, top, 0);       // the top plane, half 0
    mma_group<KS, TWO_XS>(b, x_rows + X1, ring, top, 0);  // and half 1
    const int low = ring.take(KS);
    wgmma_wait<1>();
    fence_regs(a);
    horner(a, nt, true);
    mma_group<KS, TWO_XS>(a, x_rows, ring, low, 1);  // the low plane, half 0
    wgmma_wait<1>();
    fence_regs(b);
    ring.give(KS, lane);  // the top plane's units
    horner(b, nt, true);
    mma_group<KS, TWO_XS>(b, x_rows + X1, ring, low, 1);  // and half 1
  }
  wgmma_wait<1>();
  fence_regs(a);
  fold(best, a);
  wgmma_wait<0>();
  fence_regs(b);
  ring.give(KS, lane);
  fold(best + 2, b);
}

// two_halves<ks, n_planes> for a runtime ks in 1..G_TWO_KS and one or two
// planes
__device__ __forceinline__ void two_switch(int ks, int n_planes, int* best, int (&a)[64],
                                           int (&b)[64], Ring& ring, uint32_t x_rows,
                                           const int* nt, int lane) {
  switch (ks * 2 + n_planes - 1) {
#define LM_TWO_CASE(n)                                                 \
  case 2 * n:                                                          \
    two_halves<n, 1>(best, a, b, ring, x_rows, nt, lane);         \
    break;                                                             \
  case 2 * n + 1:                                                      \
    two_halves<n, 2>(best, a, b, ring, x_rows, nt, lane);         \
    break;
    LM_TWO_CASE(1) LM_TWO_CASE(2) LM_TWO_CASE(3) LM_TWO_CASE(4)
    LM_TWO_CASE(5) LM_TWO_CASE(6) LM_TWO_CASE(7) LM_TWO_CASE(8)
#undef LM_TWO_CASE
    default:
      break;
  }
}

// The k-steps of every lane tile, those of its deepest chunk
// (multi_kernel.tile_ksteps), from the host: the schedule of the blocks.
struct GSteps {
  uint8_t ks[G_MAX_LTILES];
};

// blocks: uint8 [n_blocks][128 lanes][32 bytes], what a position tile
// multiplies, in the order the consumers take them (the host's
// multi_kernel.gmma_blocks): lane tile by lane tile, each tile's planes from
// the top, each plane's steps.ks[tile] k-steps, each row's two 16-byte
// halves already in the 32-byte swizzle's order; n_blocks is n_planes x the
// sum of steps.ks (the launch checks it)
__global__ void __launch_bounds__(G_THREADS, 1)
gmma_prefilter(const uint8_t* __restrict__ seq, long long lp, const uint8_t* __restrict__ blocks,
               int n_blocks, const __grid_constant__ GSteps steps, int n_planes, int n_chunks,
               int rows, int k, const int* __restrict__ t_eff, int* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  const GGeom g = ggeom(n_planes, n_chunks, rows, k);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  uint8_t* const tks = gbase + g.tks;
  int* const negt = reinterpret_cast<int*>(gbase + g.negt);
  const uint32_t bars = base + g.bars;
  const int tid = threadIdx.x;
  const int n_lanes = n_chunks * CH;
  const long long tiles = (lp + g.pos - 1) / g.pos;

  // the k-steps of each lane tile; -t_eff of every lane, INT_MIN past the
  // group's
  for (int j = tid; j < g.ltiles; j += G_THREADS) tks[j] = steps.ks[j];
  for (int c = tid; c < g.ltiles * G_LANES; c += G_THREADS) {
    negt[c] = c < n_lanes ? -__ldg(t_eff + c) : INT_MIN;
  }
  if (tid == 0) {
    for (int u = 0; u < g.units; ++u) {
      mbar_init(bars + 8u * u, 1);
      mbar_init(bars + 8u * (g.units + u), G_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // the producer warpgroup: the first thread of each warp copies every
    // G_PRODUCERS-th block, each tile's blocks in order.  128 x 40 + 256 x
    // 232 registers are the block's allocation at launch (384 x 168), so
    // the consumers' increase below finds its registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int w = (tid - 256) >> 5;
    if ((tid & 31) == 0 && w < G_PRODUCERS) {
      int u = 0, n = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        for (int i = 0; i < n_blocks; ++i) {
          if (n == w) {
            mbar_wait(bars + 8u * (g.units + u), phase ^ 1);
            mbar_expect_tx(bars + 8u * u, G_BLOCK);
            bulk_load(base + g.ring + static_cast<uint32_t>(u) * G_BLOCK,
                      blocks + static_cast<size_t>(i) * G_BLOCK, bars + 8u * u);
          }
          if (++n == G_PRODUCERS) n = 0;
          if (++u == g.units) {
            u = 0;
            phase ^= 1;
          }
        }
      }
      // every unit given back by every consumer warp before the block exits
      for (int i = 0; i < g.units; ++i) {
        mbar_wait(bars + 8u * (g.units + u), phase ^ 1);
        if (++u == g.units) {
          u = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int lane = tid & 31;
  const int wg_rows = G_HALF * g.halves;
  uint8_t* const oh = gbase + g.ohs + wg * g.oh;
  const uint32_t* const ohw = reinterpret_cast<const uint32_t*>(oh);
  const uint32_t x_rows = base + wg * wg_rows * G_KSTEP;  // this warpgroup's rows of X
  const int xslab = g.pos * G_KSTEP;  // bytes of one k-step of X
  const uint8_t wildcard = static_cast<uint8_t>(k - 1);
  int ks_x = 0;  // the k-steps of X: the deepest lane tile's
  for (int j = 0; j < g.ltiles; ++j) ks_x = max(ks_x, static_cast<int>(tks[j]));
  Ring ring{base + g.ring, bars, g.units};
  // two accumulator sets; a tile of two or more planes starts its sums
  // afresh with its first MMA
  int acc_a[64], acc_b[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_a[i] = acc_b[i] = 0;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long first = t * g.pos + wg * wg_rows;
    // the previous tile's MMAs are waited for and its stream read
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    for (int w = wtid; w < g.oh / 4; w += 128) reinterpret_cast<uint32_t*>(oh)[w] = 0u;
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    for (int i = wtid; i < g.npos; i += 128) {
      const long long p = first + i;
      uint8_t s = p < lp ? seq[p] : wildcard;
      s = s < wildcard ? s : wildcard;
      const int b = i * k + s;
      if (b < g.oh) oh[b] = 1;
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    // rows r of X, k-step kk, 16-byte half h: stream bytes r*K + 32 kk + 16 h
    // on, at the warpgroup's row r of slab kk with the 32-byte swizzle; a
    // warp writes one half of 32 rows, whose pieces fall in distinct banks
    for (int i = wtid; i < wg_rows * 2 * ks_x; i += 128) {
      const int r = i % wg_rows;
      const int h = (i / wg_rows) & 1;
      const int kk = i / (2 * wg_rows);
      const int off = r * k + kk * G_KSTEP + h * 16;
      const uint32_t* w = ohw + (off >> 2);
      const int sh = (off & 3) * 8;
      uint4 v;
      v.x = __funnelshift_r(w[0], w[1], sh);
      v.y = __funnelshift_r(w[1], w[2], sh);
      v.z = __funnelshift_r(w[2], w[3], sh);
      v.w = __funnelshift_r(w[3], w[4], sh);
      const int row = wg * wg_rows + r;
      *reinterpret_cast<uint4*>(gbase + kk * xslab + (row >> 3) * 256 + (row & 7) * 32 +
                                ((h ^ ((row >> 2) & 1)) << 4)) = v;
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    // rows r and r + 8 of each half of this thread: best[2 h], best[2 h + 1]
    int best[4] = {INT_MIN, INT_MIN, INT_MIN, INT_MIN};
    for (int j = 0; j < g.ltiles; ++j) {
      const int ks = tks[j];
      const int* nt = negt + j * G_LANES + 2 * (lane & 3);  // this thread's columns
      if (g.halves == 1) {
        deep_tile(best, acc_a, ring, x_rows, nt, ks, n_planes, lane);
      } else if (ks == 0) {
        fold_nt(best, nt);
        fold_nt(best + 2, nt);
      } else {
        two_switch(ks, n_planes, best, acc_a, acc_b, ring, x_rows, nt, lane);
      }
    }
    // the quad's four threads hold the same rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int v = best[i];
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const long long p = first + (i >> 1) * G_HALF + (wtid >> 5) * 16 + (lane >> 2) + 8 * (i & 1);
      if ((lane & 3) == 0 && i < 2 * g.halves && p < lp) out[p] = v;
    }
  }
}

// The launch of gmma_prefilter: persistent, one block per SM (its shared
// memory holds one), fewer for fewer tiles.  ksteps: int [lane tiles] on
// the host; blocks that are not n_planes x their sum, or k-steps past the
// planes' depth, are refused (cudaErrorInvalidValue) before anything runs.
int launch_gmma(const void* seq, long long lp, const void* blocks, int n_blocks,
                const int* ksteps, int n_planes, int n_chunks, int rows, int k,
                const void* t_eff, void* out, void* stream) {
  const GGeom g = ggeom(n_planes, n_chunks, rows, k);
  if (blocks == nullptr || (reinterpret_cast<unsigned long long>(blocks) & 15) != 0 ||
      ksteps == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GSteps steps = {};
  long long scheduled = 0;
  for (int j = 0; j < g.ltiles; ++j) {
    if (ksteps[j] < 0 || ksteps[j] > g.ks) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    steps.ks[j] = static_cast<uint8_t>(ksteps[j]);
    scheduled += static_cast<long long>(ksteps[j]) * n_planes;
  }
  if (scheduled != n_blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<int> allowed[MAX_DEVICES];
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(gmma_prefilter), allowed, g.smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  int sms = 0;
  const int sm_err = n_sms(&sms);
  if (sm_err != 0) {
    return sm_err;
  }
  const long long tiles = (lp + g.pos - 1) / g.pos;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  gmma_prefilter<<<grid, G_THREADS, static_cast<size_t>(g.smem),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), lp, static_cast<const uint8_t*>(blocks), n_blocks, steps,
      n_planes, n_chunks, rows, k, static_cast<const int*>(t_eff), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// What the three entry points launch, chosen by the shape alone:
// gmma_prefilter on the planes' blocks when it takes the shape, else
// mma_kernel's production instantiation on the planes.
int prefilter(const void* seq, long long lp, const void* planes, int n_planes, int n_chunks,
              int rows, int k, const void* chunk_m, const void* t_eff, const void* blocks,
              int n_blocks, const int* ksteps, void* out, void* stream) {
  if (lp <= 0) {
    return 0;
  }
  if (gmma_takes(n_planes, n_chunks, rows, k)) {
    return launch_gmma(seq, lp, blocks, n_blocks, ksteps, n_planes, n_chunks, rows, k, t_eff,
                       out, stream);
  }
  return launch(PRODUCTION, seq, lp, planes, n_planes, n_chunks, rows, k, chunk_m, t_eff, out,
                stream);
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
// int32 [n_chunks]; t_eff: int32 [n_chunks * 16]; blocks: the planes'
// blocks (multi_kernel.gmma_blocks), n_blocks of them, and ksteps, int
// [lane tiles] on the host, their schedule (multi_kernel.tile_ksteps); out:
// int32 [lp].  Each returns the CUDA error of the launch (0 when it was
// queued).

// K3: the u16 planes of pack_filters_k3.
int lm_prefilter_any8(const void* seq, long long lp, const void* planes, int n_planes,
                      int n_chunks, int rows, int k, const void* chunk_m, const void* t_eff,
                      const void* blocks, int n_blocks, const int* ksteps, void* out,
                      void* stream) {
  return prefilter(seq, lp, planes, n_planes, n_chunks, rows, k, chunk_m, t_eff, blocks,
                   n_blocks, ksteps, out, stream);
}

// K4: the u8 plane of pack_filters_k4.
int lm_prefilter_any(const void* seq, long long lp, const void* planes, int n_planes,
                     int n_chunks, int rows, int k, const void* chunk_m, const void* t_eff,
                     const void* blocks, int n_blocks, const int* ksteps, void* out,
                     void* stream) {
  return prefilter(seq, lp, planes, n_planes, n_chunks, rows, k, chunk_m, t_eff, blocks,
                   n_blocks, ksteps, out, stream);
}

// K5: the u16 planes of pack_filters_k5.
int lm_prefilter_any16(const void* seq, long long lp, const void* planes, int n_planes,
                       int n_chunks, int rows, int k, const void* chunk_m, const void* t_eff,
                       const void* blocks, int n_blocks, const int* ksteps, void* out,
                       void* stream) {
  return prefilter(seq, lp, planes, n_planes, n_chunks, rows, k, chunk_m, t_eff, blocks,
                   n_blocks, ksteps, out, stream);
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

// The warpgroup kernel's shapes: field 0 the positions of an MMA (a half
// of a warpgroup's rows), 1 the lanes of a tile, 2 the bytes of a k-step, 3
// the most k-steps a lane takes, 4 the most lane tiles, 5 the deepest
// shape whose warpgroups take two halves; -1 for another field.
int lm_prefilter_gmma_shape(int f) {
  const int fields[] = {G_HALF, G_LANES, G_KSTEP, G_MAX_KS, G_MAX_LTILES, G_TWO_KS};
  return f >= 0 && f < 6 ? fields[f] : -1;
}

// 1 when the entry points launch the warpgroup kernel on planes of this
// shape, 0 when they launch mma_kernel.
int lm_prefilter_gmma_takes(int n_planes, int n_chunks, int rows, int k) {
  return gmma_takes(n_planes, n_chunks, rows, k) ? 1 : 0;
}

// The warpgroup kernel's geometry at a shape: (dynamic shared memory <<
// 20) | (positions per tile << 8) | ring units, or -1 for a shape it does
// not take.
long long lm_prefilter_gmma_geom(int n_planes, int n_chunks, int rows, int k) {
  if (!gmma_takes(n_planes, n_chunks, rows, k)) {
    return -1;
  }
  const GGeom g = ggeom(n_planes, n_chunks, rows, k);
  return (g.smem << 20) | (static_cast<long long>(g.pos) << 8) | g.units;
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
