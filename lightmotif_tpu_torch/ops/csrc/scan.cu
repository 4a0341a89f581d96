// The one-PSSM scan of a segment in one launch, for NVIDIA Hopper (sm_90a):
// the discrete pass, the threshold, the exact rescore, the keep and the
// front compaction of the kept hits.
//
// Replaces the XLA code of lightmotif_tpu/ops/xla_ops.py:291-333
// (scan_segment after the slice): its discrete pass, the Pallas kernel
// lightmotif_tpu/ops/kernels.py:73 (_gather_kernel) in score_u8's discrete
// mode, then threshold_positions (the candidates score >= t_scaled, the
// first cap of them in ascending order, their exact count),
// rescore_positions (the exact f32 score of each), the keep mask score >=
// threshold and the front compaction.
//
// Inputs: seq uint8 [lp >= n + m - 1] (the segment's window starts and
// their halo), dm uint8 [m][k] (the discrete table), pssm f32 [m][k], n the
// segment's window starts, t_scaled, threshold (f32), cap.  Outputs, in one
// int32 buffer: counts [3] = [exact candidate count, n_kept, 1] (n_kept
// among the first cap candidates: the compaction is complete at any
// density, so valid is always 1); best [2] = the f32 bits and the position
// of the best kept hit (the largest score, ties to the larger position, the
// reference's last-max rule), or -inf bits and -1 when none is kept; and
// packed [2][cap], the kept hits front-compacted in ascending position
// order, as positions and f32 bits (slots past n_kept are not written).
// ops/torch_ops.py::scan_segment is its plain version.
//
// What bounds it on this card: the bytes, the segment's n + m - 1 sequence
// bytes read once (4.6 MB at a 4.6 Mbp genome, 67 MB at a 2**26-start
// segment), the two tables and the outputs (20 bytes, and 8 a kept hit);
// the work is m table lookups and adds a window start and m f32 adds a
// rescored candidate.  The earlier form, K2 (score.cu) then three kernels,
// wrote an int32 score a window start to device memory and read it twice.
// Here the discrete pass's instructions set the pace (K2, the same inner
// loop, takes 0.148 ms at a 2**26-start segment on an H100 against a
// 0.020 ms byte bound; PERF.md section 6), and the design keeps
// everything else off that path.  One launch after one
// memset of a small scratch, no host read, no allocation:
//
// * A block takes the next tile of 2,048 window starts from a counter (so
//   tiles start in order and a tile waits only on running ones), stages the
//   tables and the tile with its (m-1)-byte halo as ranks clamped to the
//   wildcard (16-byte loads where aligned) in shared memory, as score.cu's
//   K2 does.
// * The discrete pass is K2's in registers: 16 consecutive window starts a
//   thread, rows outer; for k <= 7 (DNA) and m <= 257, two lookups per
//   __byte_perm from the ranks tagged 0x70 and a row's cells in two words,
//   in 16-bit lanes (K2's production lookup); else one shared-memory load of
//   the u8 cell a lookup.  A start is a candidate where its sum is >=
//   t_scaled (min(sum, 255) >= t_scaled, as t_scaled <= 255; none above)
//   and it lies below n: one __vcmpgeu2 tests two starts, and a thread with
//   none goes no further.
// * Each candidate is rescored once, from the staged ranks: the sequential
//   ascending-j sum from +0.0 with __fadd_rn (ranks >= K read the wildcard,
//   rank K - 1), so the compiler never contracts it into FFMA and the bits
//   are those of the JAX rescore_positions (a sum of -0.0 terms is +0.0).
//   The f32 table is staged for the __byte_perm form; the generic form reads
//   it through the read-only cache, so that every table K2 takes fits.
// * Slots: a tile with no candidate (one barrier tells) publishes its
//   zero state and leaves; every 32nd one, and every tile with candidates,
//   first waits for its prefix, so a walk back is short.  A tile with
//   candidates ranks them and its kept hits in position order with one
//   block scan, and a single-pass decoupled look-back over the tiles (one
//   warp reads 32 predecessors' states at once, one 64-bit word a tile:
//   flag, 31-bit candidates, 31-bit kept) gives the candidates and kept
//   hits before it.  A tile whose candidates all rank below cap writes its
//   kept hits at its kept offset, the tile holding the cap-th candidate
//   those of rank < cap, later tiles nothing; the hits go through shared
//   memory so that the block writes them as contiguous runs.
// * The counters and the best hit: each writing warp adds its written hits
//   and takes the max of an order-preserving 64-bit key (orderable f32 bits
//   above the position) with atomics, whose results do not depend on their
//   order; every tile then adds one to a counter with release semantics,
//   and the last tile taken waits for the others and writes counts and
//   best.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_attrs.cuh"

namespace {

constexpr int NT = 128;       // threads a block
constexpr int P = 16;         // consecutive window starts a thread
constexpr int TILE = NT * P;  // window starts a tile
constexpr int NW = P / 4 + 1; // words a thread reads per 4 rows
constexpr int ZERO_STRIDE = 32;  // a tile with no candidate waits for its prefix every ...
constexpr unsigned FULL = 0xffffffffu;

// look-back states: the flag in the top two bits, below it the candidates
// (31 bits) above the kept hits (31 bits)
constexpr unsigned long long AGGREGATE = 1ull << 62;
constexpr unsigned long long INCLUSIVE = 2ull << 62;
constexpr unsigned long long VALUE = AGGREGATE - 1;
constexpr int KEPT_BITS = 31;
constexpr unsigned long long KEPT_MASK = (1ull << KEPT_BITS) - 1;

// The zeroed scratch: this header, then one look-back state a tile.
struct Header {
  unsigned long long ticket;  // tiles taken
  unsigned long long done;    // tiles finished, the last one taken aside
  unsigned long long cand;    // candidates of every tile
  unsigned long long kept;    // kept hits written
  unsigned long long best;    // the largest key of a written hit, 0 for none
  unsigned long long pad[3];
};

// int32 words of the buffer before the scratch: counts [3], a pad, best
// [2], a pad
constexpr int HEAD_INTS = 8;

__host__ __device__ constexpr long long align16(long long x) { return (x + 15) / 16 * 16; }
long long n_tiles(long long n) { return n > TILE ? (n + TILE - 1) / TILE : 1; }
long long scratch_bytes(long long n) {
  return static_cast<long long>(sizeof(Header)) + align16(8 * n_tiles(n));
}

// the __byte_perm form's tables: K2's production lookup
bool use_prmt(int m, int k) { return k <= 7 && m <= 257; }

// Shared memory: the tables (the __byte_perm form: the f32 table, a row's
// packed cells and the raw u8 cells they are packed from; the generic form:
// the u8 cells), the tile's ranks, then the kept hits of the tile (their
// positions and f32 bits) before they are written.
__host__ __device__ inline int tables_bytes(bool prmt, int m, int k) {
  const long long cells = align16(static_cast<long long>(m) * k);
  return static_cast<int>(prmt ? align16(4LL * m * k) + align16(8LL * m) + cells : cells);
}

__host__ __device__ inline int tile_bytes(int m) {
  return static_cast<int>(align16(TILE + m + 3));
}

long long smem_bytes(int m, int k) {
  return tables_bytes(use_prmt(m, k), m, k) + tile_bytes(m) + 8LL * TILE;
}

// Byte b of the word array w, zero-extended (one PRMT).
__device__ __forceinline__ unsigned byte_at(const uint32_t (&w)[NW], int b) {
  return __byte_perm(w[b >> 2], 0u, 0x4440u | (b & 3));
}

// The 16-bit window of bytes b, b + 1 in the low half (__byte_perm reads
// only the low 16 bits of its selector).
__device__ __forceinline__ unsigned pair_at(const uint32_t (&w)[NW], int b) {
  if ((b & 3) == 0) {
    return w[b >> 2];
  }
  if ((b & 3) == 3) {
    return __funnelshift_r(w[b >> 2], w[(b >> 2) + 1], 24);
  }
  return w[b >> 2] >> (8 * (b & 3));
}

// the four bytes of v clamped to the wildcard (and tagged 0x70 for PRMT)
template <bool PRMT>
__device__ __forceinline__ uint32_t clamp4(uint32_t v, uint32_t wc4) {
  v = __vminu4(v, wc4);
  return PRMT ? v | 0x70707070u : v;
}

template <bool PRMT>
__device__ __forceinline__ uint8_t clamp1(unsigned v, unsigned wc) {
  v = v < wc ? v : wc;
  return static_cast<uint8_t>(PRMT ? v | 0x70u : v);
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void red_release_add(unsigned long long* p, unsigned long long v) {
  asm volatile("red.release.gpu.global.add.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Exclusive block scan of one 64-bit value a thread; *total gets the
// block's sum.  The block is synchronised on return, so `sums` may be used
// again.
__device__ __forceinline__ unsigned long long block_scan(unsigned long long v,
                                                         unsigned long long* sums,
                                                         unsigned long long* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  unsigned long long before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const unsigned long long s = sums[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

// Decoupled look-back by one warp of tile `tile`: publishes the tile's
// aggregate, sums its predecessors' states 32 at a time (waiting for each
// to publish, stopping at the nearest inclusive prefix), publishes its own
// inclusive prefix and returns the exclusive one to every lane.  A state
// word carries its flag and value together, so a relaxed 64-bit load sees
// both or neither.
__device__ unsigned long long look_back(unsigned long long* state, long long tile,
                                        unsigned long long aggregate) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) st_relaxed(state, INCLUSIVE | aggregate);
    return 0;
  }
  if (lane == 0) st_relaxed(state + tile, AGGREGATE | aggregate);
  unsigned long long before = 0;
  for (long long end = tile - 1;; end -= 32) {
    const long long t = end - lane;
    unsigned long long s;
    do {
      s = t >= 0 ? ld_relaxed(state + t) : INCLUSIVE;
    } while (__any_sync(FULL, (s & ~VALUE) == 0));
    const unsigned inclusive = __ballot_sync(FULL, (s & ~VALUE) == INCLUSIVE);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    unsigned long long v = lane <= stop ? s & VALUE : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    before += v;
    if (inclusive) break;
  }
  if (lane == 0) st_relaxed(state + tile, INCLUSIVE | (before + aggregate));
  return before;
}

// An order-preserving key of a hit: the f32 bits made orderable as
// unsigned, above the position, so the largest key is the largest score
// and, among equal scores, the larger position.  Never 0 for a hit.
__device__ __forceinline__ unsigned long long hit_key(float score, long long pos) {
  const unsigned u = __float_as_uint(score);
  const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) | static_cast<unsigned>(pos);
}

__device__ __forceinline__ int key_bits(unsigned long long key) {
  const unsigned o = static_cast<unsigned>(key >> 32);
  return static_cast<int>((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// This tile is done (its atomics issued; one thread): it counts itself with
// release semantics, or, the last tile taken, waits for every other tile's
// count and writes the counters and the best hit.  The last tile started
// after every other, so the others run on to their end.
__device__ void finish(Header* hdr, long long tile, long long tiles, int* counts, int* best) {
  if (tile != tiles - 1) {
    red_release_add(&hdr->done, 1ull);
    return;
  }
  while (ld_acquire(&hdr->done) != static_cast<unsigned long long>(tiles - 1)) {
  }
  const unsigned long long cand = atomicAdd(&hdr->cand, 0ull);
  const unsigned long long kept = atomicAdd(&hdr->kept, 0ull);
  const unsigned long long key = atomicAdd(&hdr->best, 0ull);
  counts[0] = static_cast<int>(cand);
  counts[1] = static_cast<int>(kept);
  counts[2] = 1;
  best[0] = key ? key_bits(key) : __float_as_int(-INFINITY);
  best[1] = key ? static_cast<int>(key & 0xffffffffu) : -1;
}

template <bool PRMT>
__global__ void __launch_bounds__(NT)
scan_kernel(const uint8_t* __restrict__ seq, long long lp, const uint8_t* __restrict__ dm,
            const float* __restrict__ pssm, int m, int k, long long n, int t_scaled,
            float threshold, long long cap, long long tiles, Header* hdr,
            unsigned long long* state, int* __restrict__ counts, int* __restrict__ best,
            int* __restrict__ packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long sums[NT / 32];
  __shared__ long long taken;
  __shared__ unsigned long long prefix;
  __shared__ int block_written;
  float* ftab = reinterpret_cast<float*>(smem);  // PRMT: [m][k]
  uint2* prm = reinterpret_cast<uint2*>(smem + align16(4LL * m * k));  // PRMT: [m]
  uint8_t* cells = PRMT ? smem + align16(4LL * m * k) + align16(8LL * m) : smem;  // [m][k]
  uint8_t* tl = smem + tables_bytes(PRMT, m, k);
  int* kept_pos = reinterpret_cast<int*>(tl + tile_bytes(m));  // [TILE]
  int* kept_bits = kept_pos + TILE;                            // [TILE]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned wc = static_cast<unsigned>(k - 1);
  const uint32_t wc4 = wc * 0x01010101u;
  constexpr unsigned RANK = PRMT ? 0x0fu : 0xffu;  // a staged byte's rank

  if (tid == 0) {
    taken = static_cast<long long>(atomicAdd(&hdr->ticket, 1ull));
    block_written = 0;
  }
  if constexpr (PRMT) {
    for (int i = tid; i < m * k; i += NT) ftab[i] = __ldg(pssm + i);
  }
  for (int i = tid; i < m * k; i += NT) cells[i] = __ldg(dm + i);
  __syncthreads();
  if constexpr (PRMT) {
    for (int j = tid; j < m; j += NT) {
      uint32_t lo = 0, hi = 0;  // cells 0-3, cells 4-6; byte 7 stays 0
      for (int s = 0; s < k; ++s) {
        const uint32_t c = cells[j * k + s];
        if (s < 4) {
          lo |= c << (8 * s);
        } else {
          hi |= c << (8 * (s - 4));
        }
      }
      prm[j] = make_uint2(lo, hi);
    }
  }
  const long long tile = taken;
  const long long base = tile * TILE;

  // the tile's ranks, its halo, then the wildcard
  const int tb = tile_bytes(m);
  if (((reinterpret_cast<uintptr_t>(seq) + base) & 15) == 0 && base + tb <= lp) {
    for (int i = 16 * tid; i < tb; i += 16 * NT) {
      uint4 v = __ldg(reinterpret_cast<const uint4*>(seq + base + i));
      v.x = clamp4<PRMT>(v.x, wc4);
      v.y = clamp4<PRMT>(v.y, wc4);
      v.z = clamp4<PRMT>(v.z, wc4);
      v.w = clamp4<PRMT>(v.w, wc4);
      *reinterpret_cast<uint4*>(tl + i) = v;
    }
  } else {
    for (int i = tid; i < tb; i += NT) {
      const long long g = base + i;
      tl[i] = clamp1<PRMT>(g < lp ? __ldg(seq + g) : wc, wc);
    }
  }
  __syncthreads();

  // the discrete pass over the thread's P window starts at tile offset t0
  const int t0 = tid * P;
  uint32_t acc2[P / 2];  // PRMT: starts 2h, 2h + 1 in 16-bit lanes
  int acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < P / 2; ++i) acc2[i] = 0u;
#pragma unroll 1
  for (int j0 = 0; j0 < m; j0 += 4) {
    uint32_t w[NW];
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(tl + t0 + j0);
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = wp[i];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + jj;
      if (j >= m) break;  // the same for every thread
      if constexpr (PRMT) {
        const uint2 c = prm[j];
#pragma unroll
        for (int h = 0; h < P / 2; ++h) {
          acc2[h] += __byte_perm(c.x, c.y, pair_at(w, 2 * h + jj));
        }
      } else {
        const uint8_t* row = cells + j * k;
#pragma unroll
        for (int i = 0; i < P; ++i) acc[i] += row[byte_at(w, i + jj)];
      }
    }
  }

  // the candidates (bit i of cand: start t0 + i), then each rescored and
  // the kept ones (keep)
  const bool none = t_scaled > 255;
  const unsigned t1 = static_cast<unsigned>(max(t_scaled, 0));
  unsigned cand = 0u;
  if constexpr (PRMT) {
    const unsigned t2 = t1 | (t1 << 16);
    uint32_t hit[P / 2];
    unsigned any = 0u;
#pragma unroll
    for (int h = 0; h < P / 2; ++h) {
      hit[h] = none ? 0u : __vcmpgeu2(acc2[h], t2);
      any |= hit[h];
    }
    if (any) {
#pragma unroll
      for (int h = 0; h < P / 2; ++h) cand |= ((hit[h] & 1u) | ((hit[h] >> 15) & 2u)) << (2 * h);
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (!none && static_cast<unsigned>(acc[i]) >= t1) cand |= 1u << i;
    }
  }
  if (cand && base + TILE > n) {  // only the tile that holds n
    const long long left = n - base - t0;
    cand &= left >= P ? FULL : left <= 0 ? 0u : (1u << left) - 1u;
  }
  unsigned keep = 0u;
  float sc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) sc[i] = 0.0f;
  if (cand) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (cand & (1u << i)) {
        const uint8_t* win = tl + t0 + i;
        float a = 0.0f;
        for (int j = 0; j < m; ++j) {
          const int s = win[j] & RANK;
          a = __fadd_rn(a, PRMT ? ftab[j * k + s] : __ldg(pssm + j * k + s));
        }
        sc[i] = a;
        if (a >= threshold) keep |= 1u << i;
      }
    }
  }

  if (!__syncthreads_or(cand != 0u)) {  // no candidate in the tile
    if (warp == 0) {
      if (tile % ZERO_STRIDE == ZERO_STRIDE - 1) {
        look_back(state, tile, 0ull);
      } else if (lane == 0) {
        st_relaxed(state + tile, tile == 0 ? INCLUSIVE : AGGREGATE);
      }
      if (lane == 0) finish(hdr, tile, tiles, counts, best);
    }
    return;
  }

  // the candidates and kept hits of the tile before the thread's (every
  // field stays below TILE < 2**16)
  unsigned long long total;
  const unsigned pre = static_cast<unsigned>(
      block_scan((__popc(cand) << 16) | __popc(keep), sums, &total));
  const unsigned tile_cand = static_cast<unsigned>(total) >> 16;
  const unsigned tile_kept = static_cast<unsigned>(total) & 0xffffu;
  if (warp == 0) {
    const unsigned long long before = look_back(
        state, tile, (static_cast<unsigned long long>(tile_cand) << KEPT_BITS) | tile_kept);
    if (lane == 0) {
      prefix = before;
      atomicAdd(&hdr->cand, static_cast<unsigned long long>(tile_cand));
    }
  }
  __syncthreads();
  const long long cand_before = static_cast<long long>(prefix >> KEPT_BITS);
  const long long kept_before = static_cast<long long>(prefix & KEPT_MASK);
  if (cand_before < cap) {  // the same for every thread
    // the written hits (kept, of rank < cap) are the tile's first kept
    // ones: stage them at their rank in the tile, then write them out
    long long rank = cand_before + (pre >> 16);
    int dst = static_cast<int>(pre & 0xffffu);
    unsigned written = 0;
    unsigned long long top = 0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (cand & (1u << i)) {
        if ((keep & (1u << i)) && rank < cap) {
          const long long pos = base + t0 + i;
          kept_pos[dst] = static_cast<int>(pos);
          kept_bits[dst] = __float_as_int(sc[i]);
          const unsigned long long key = hit_key(sc[i], pos);
          top = key > top ? key : top;
          ++written;
          ++dst;
        }
        ++rank;
      }
    }
    written = __reduce_add_sync(FULL, written);
#pragma unroll
    for (int d = 16; d; d >>= 1) {
      const unsigned long long o = __shfl_xor_sync(FULL, top, d);
      top = o > top ? o : top;
    }
    if (lane == 0 && written) {
      atomicAdd(&hdr->kept, static_cast<unsigned long long>(written));
      atomicMax(&hdr->best, top);
      atomicAdd(&block_written, static_cast<int>(written));
    }
    __syncthreads();
    const int n_written = block_written;
    for (int i = tid; i < n_written; i += NT) {
      packed[kept_before + i] = kept_pos[i];
      packed[cap + kept_before + i] = kept_bits[i];
    }
  }
  __syncthreads();
  if (tid == 0) finish(hdr, tile, tiles, counts, best);
}

template <bool PRMT>
int launch(const uint8_t* seq, long long lp, const uint8_t* dm, const float* pssm, int m, int k,
           long long n, int t_scaled, float threshold, long long cap, int* out,
           cudaStream_t st) {
  const long long tiles = n_tiles(n);
  const long long smem = smem_bytes(m, k);
  static std::atomic<int> allowed[MAX_DEVICES];
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(scan_kernel<PRMT>), allowed,
                                     smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  Header* hdr = reinterpret_cast<Header*>(out + HEAD_INTS);
  unsigned long long* state = reinterpret_cast<unsigned long long*>(hdr + 1);
  int* packed = out + HEAD_INTS + scratch_bytes(n) / 4;
  scan_kernel<PRMT><<<static_cast<unsigned>(tiles), NT, smem, st>>>(
      seq, lp, dm, pssm, m, k, n, t_scaled, threshold, cap, tiles, hdr, state, out, out + 4,
      packed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of the zeroed scratch for n window starts (a multiple of 16), or -1
// for n < 0.  The output buffer of lm_scan_segment holds 8 int32 words
// (counts, best), this scratch, then packed [2][cap].
long long lm_scan_scratch(long long n) { return n < 0 ? -1 : scratch_bytes(n); }

// Dynamic shared memory (bytes) a launch takes for an m x k table, or -1
// for a table no form takes.
long long lm_scan_smem(int m, int k) {
  return m < 1 || k < 2 || k > 256 ? -1 : smem_bytes(m, k);
}

// seq uint8 [lp >= n + m - 1]; dm uint8 [m][k]; pssm f32 [m][k]; out int32
// [8 + lm_scan_scratch(n) / 4 + 2 cap], 16-byte aligned: counts at out[0:3],
// best at out[4:6], packed at out[8 + lm_scan_scratch(n) / 4:].  Queues one
// memset and one kernel on the stream; returns the CUDA error (0 when both
// were queued).
int lm_scan_segment(const void* seq, long long lp, const void* dm, const void* pssm, int m,
                    int k, long long n, int t_scaled, float threshold, long long cap, void* out,
                    void* stream) {
  if (n < 0 || n > INT_MAX || cap < 1 || m < 1 || k < 2 || k > 256 ||
      (n > 0 && lp < n + m - 1) || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  cudaError_t err = cudaMemsetAsync(o, 0, 4 * HEAD_INTS + scratch_bytes(n), st);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const uint8_t* s = static_cast<const uint8_t*>(seq);
  const uint8_t* d = static_cast<const uint8_t*>(dm);
  const float* w = static_cast<const float*>(pssm);
  return use_prmt(m, k) ? launch<true>(s, lp, d, w, m, k, n, t_scaled, threshold, cap, o, st)
                        : launch<false>(s, lp, d, w, m, k, n, t_scaled, threshold, cap, o, st);
}

}  // extern "C"
