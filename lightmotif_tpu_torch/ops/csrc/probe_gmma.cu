// P6 on Hopper (sm_90a): the tensor cores' int8 and bf16 rates at the
// prefilter's operand shapes, on warpgroup MMAs (wgmma) fed by the Tensor
// Memory Accelerator (TMA).  No path of the package launches it; the probe
// module lightmotif_tpu_torch/probes/prefilter.py wraps it.
//
// P6 replaces the Pallas probe experiments/int8_probe.py (run, its
// pallas_call at :54), which asked whether the TPU's int8 matrix unit beats
// bf16 at the prefilter's shapes.  Both forms compute, for every position p,
//
//   out[p] = max over l < L of  sum_{d < 128 B} filt[l][d] * x[p][d]
//
// as int32, with filt [L][128 B] and x [n_pos][128 B] K-major (the
// transposes of the JAX probe's [128 B, M] and [128 B, tile]), L = M =
// 2,048 lanes and B blocks of 128 in the contraction (B = 3 in the JAX
// probe; 1 is the earlier mma.sync probe's depth).  The JAX probe draws
// filt from [-100, 100) and x from {0, 1}; every sum is an exact integer,
// |sum| <= 384 * 128 < 2^24, in s32 and in f32.  The int8 form multiplies s8 x s8 -> s32
// (wgmma ... m64n128k32.s32.s8.s8); the bf16 form the same integers as bf16
// x bf16 -> f32 (wgmma ... m64n128k16.f32.bf16.bf16) and converts the max to
// int32, as _kernel_bf16 does.  What bounds each is its MMA work over the
// card's dense peak for its type (1,979 int8 / 989 bf16 tera-operations a
// second); the probe reports its rate as a share of that.
//
// Design.  Positions are the MMA's M rows, lanes its N columns.  A block
// holds a tile of 128 positions (x, all of its depth, resident in shared
// memory while the tile lasts) and streams filt through a ring of STAGES
// shared tiles, each 128 lanes x 128 bytes of depth: one 128-deep int8
// block, or half of a bf16 one.  Both operands are K-major, as 8-bit wgmma
// requires, and land through TMA with the 128-byte swizzle that the wgmma
// descriptors name (one 128-byte row of depth per lane or position, tiles
// 1024-byte aligned).  384 threads: warpgroups 0 and 1 consume, each owning
// 64 of the tile's rows; warpgroup 2 produces (one thread issues every TMA
// copy; setmaxnreg moves its registers to the consumers).  A consumer runs
// a lane chunk's k-steps into one of two accumulator sets, commits one
// wgmma group per shared tile and waits for all but the newest, so the
// tensor cores always hold queued work: the finished group's tile goes back
// to the producer, and once a chunk's last group is done its accumulators
// fold into a running max per row while the next chunk's MMAs run.  A
// thread holds two rows; the quad's four threads merge their maxima with
// __shfl_xor_sync once per tile and one writes each position's int32.
//
// Re-reads of filt could bound what the tiles reach: every 128-position
// tile streams all of filt (786,432 bytes in int8, twice that in bf16)
// from L2, 1.61 GB per call of 262,144 positions in int8.  On an H100 that
// asks 6.75 TB/s of L2 at 87% of the int8 peak, and an earlier form that
// shared each filt tile between the two blocks of a cluster (TMA multicast)
// took the same time, so L2 is not the limit (PERF.md) and each block loads
// its own.  Blocks are persistent, one per SM, walking the tiles.  A ring
// slot is free again only when each of the eight consumer warps has
// released it (each arrives on the slot's `empty` barrier once its own wait
// has returned).  The x tile's slabs have barriers of their own: the next
// tile's slab k loads as soon as the last chunk's MMAs on slab k are done.
// The chunk loop is unrolled whole and so is the slab loop: ptxas
// serialises every wgmma when a loop's back edge carries an MMA group in
// flight.

#include <climits>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include <cuda.h>
#include <cudaTypedefs.h>

#include "gmma.cuh"
#include "launch_attrs.cuh"

namespace {

constexpr int LANES = 2048;        // the JAX probe's M
constexpr int BLOCK_DEPTH = 128;   // depth of one contraction block
constexpr int MAX_BLOCKS = 3;      // the JAX probe's BLOCKS
constexpr int TILE = 128;          // positions per block tile: 2 warpgroups x 64 rows
constexpr int BN = 128;            // lanes per chunk: the MMA's N
constexpr int CHUNKS = LANES / BN;
constexpr int ROW = 128;           // bytes of depth per shared row: one 128-byte swizzle row
constexpr int TILE_BYTES = 128 * ROW;  // an x slab (128 positions) or a ring tile (128 lanes)
constexpr int MAX_SLABS = 2 * MAX_BLOCKS;  // bf16 rows hold 64 values: two slabs a block
constexpr int STAGES = 8;
constexpr int THREADS = 384;
constexpr int CONSUMER_WARPS = 8;  // two warpgroups
constexpr int N_BARRIERS = 2 * STAGES + 2 * MAX_SLABS;

__host__ __device__ constexpr long long smem_bytes(int slabs) {
  return 1024 + static_cast<long long>(slabs + STAGES) * TILE_BYTES + 8 * N_BARRIERS;
}

// a box of a 2-D tensor map at (c0, c1) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows with the 128-byte
// swizzle: start address >> 4, leading offset unused (1), 8-row groups
// 1024 bytes apart, layout type 1 (B128)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// one k-step of 32 bytes: d (+)= A[64 x 32 B] . B[128 x 32 B]^T; `accumulate`
// 0 starts a chunk's sums afresh
__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " LM_REGS64 ", %64, %65, p;\n}\n"
      : LM_D64(LM_R)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " LM_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : LM_D64(LM_F)
      : "l"(da), "l"(db), "r"(accumulate));
}

// fence_regs(int) is gmma.cuh's
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ int max3(int a, int b, int c) { return __vimax3_s32(a, b, c); }
__device__ __forceinline__ float max3(float a, float b, float c) { return fmaxf(a, fmaxf(b, c)); }

// Shared memory of a block: the x tile's slabs, the ring, the barriers.
struct Smem {
  uint32_t a, b, bars;
  __device__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ uint32_t empty(int s) const { return bars + 8u * (STAGES + s); }
  __device__ uint32_t a_full(int k) const { return bars + 8u * (2 * STAGES + k); }
  __device__ uint32_t a_empty(int k) const { return bars + 8u * (2 * STAGES + MAX_SLABS + k); }
};

// One consumer warpgroup: its 64 rows of each tile, two accumulator sets
// (chunk j into set j & 1), the running maxima of its thread's two rows.
template <bool BF16, int SLABS>
struct Consumer {
  using Acc = std::conditional_t<BF16, float, int>;
  const Smem& sm;
  const int wg, tid;
  int stage = 0, prev = -1;
  uint32_t phase = 0, a_phase = 0;
  Acc acc0[64], acc1[64];
  Acc best0, best1;

  __device__ __forceinline__ Consumer(const Smem& s, int w, int t) : sm(s), wg(w), tid(t) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = Acc(0);
  }

  // give ring slot s back to the producer; every warp arrives for itself,
  // once its own wait has returned
  __device__ __forceinline__ void release(int s) const {
    if ((tid & 31) == 0) mbar_arrive(sm.empty(s));
  }

  __device__ __forceinline__ void release_a(int k) const {
    if ((tid & 31) == 0) mbar_arrive(sm.a_empty(k));
  }

  __device__ __forceinline__ void fold(Acc (&d)[64]) {
    fence_regs(d);
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
      best0 = max3(best0, d[i], d[i + 1]);
      best1 = max3(best1, d[i + 2], d[i + 3]);
    }
  }

  // lane chunk j: one wgmma group per depth slab into set BUF; after each
  // commit, the group before it is done: its ring slot is released, and when
  // it closed the previous chunk, that chunk (set !BUF) is folded
  template <int BUF>
  __device__ __forceinline__ void chunk(int j) {
    Acc(&cur)[64] = *(BUF ? &acc1 : &acc0);
    Acc(&old)[64] = *(BUF ? &acc0 : &acc1);
#pragma unroll
    for (int k = 0; k < SLABS; ++k) {
      if (j == 0) mbar_wait(sm.a_full(k), a_phase);
      mbar_wait(sm.full(stage), phase);
      fence_regs(cur);
      wgmma_fence();
      const uint64_t da = sw128_desc(sm.a + k * TILE_BYTES + wg * 64 * ROW);
      const uint64_t db = sw128_desc(sm.b + stage * TILE_BYTES);
#pragma unroll
      for (int kk = 0; kk < ROW / 32; ++kk) wgmma(cur, da + 2 * kk, db + 2 * kk, k | kk);
      wgmma_commit();
      fence_regs(cur);
      wgmma_wait<1>();
      if (prev >= 0) {
        release(prev);
        if (k == 0) {
          fold(old);
        } else if (j == CHUNKS - 1) {
          release_a(k - 1);
        }
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

  __device__ __forceinline__ void tile(int pos0, int n_pos, int* __restrict__ out) {
    if constexpr (BF16) {
      best0 = best1 = -INFINITY;
    } else {
      best0 = best1 = INT_MIN;
    }
    prev = -1;
    // unrolled whole: a back edge with an MMA group in flight makes ptxas
    // serialise every wgmma (its note C7514)
#pragma unroll
    for (int j = 0; j < CHUNKS; j += 2) {
      chunk<0>(j);
      chunk<1>(j + 1);
    }
    wgmma_wait<0>();
    release(prev);
    release_a(SLABS - 1);
    fold(acc1);
    a_phase ^= 1;
    // the quad's four threads hold the same two rows
    int v0 = static_cast<int>(best0), v1 = static_cast<int>(best1);
    v0 = max(v0, __shfl_xor_sync(0xffffffffu, v0, 1));
    v0 = max(v0, __shfl_xor_sync(0xffffffffu, v0, 2));
    v1 = max(v1, __shfl_xor_sync(0xffffffffu, v1, 1));
    v1 = max(v1, __shfl_xor_sync(0xffffffffu, v1, 2));
    const int lane = tid & 31;
    const int row = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    if ((lane & 3) == 0) {
      if (pos0 + row < n_pos) out[pos0 + row] = v0;
      if (pos0 + row + 8 < n_pos) out[pos0 + row + 8] = v1;
    }
  }
};

// filt_map: [LANES][depth], boxes of 128 bytes x BN lanes; x_map:
// [n_pos][depth], boxes of 128 bytes x TILE positions; SLABS 128-byte slabs
// of depth (blocks for int8, twice that for bf16)
template <bool BF16, int SLABS>
__global__ void __launch_bounds__(THREADS, 1)
gmma_kernel(const __grid_constant__ CUtensorMap filt_map,
            const __grid_constant__ CUtensorMap x_map, int n_pos, int* __restrict__ out) {
  constexpr int SLAB_ELEMS = BF16 ? ROW / 2 : ROW;
  extern __shared__ uint8_t smem_raw[];
  Smem sm;
  sm.a = (smem_u32(smem_raw) + 1023u) & ~1023u;
  sm.b = sm.a + SLABS * TILE_BYTES;
  sm.bars = sm.b + STAGES * TILE_BYTES;
  const int tid = threadIdx.x;
  const int tiles = (n_pos + TILE - 1) / TILE;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), CONSUMER_WARPS);
    }
    for (int k = 0; k < MAX_SLABS; ++k) {
      mbar_init(sm.a_full(k), 1);
      mbar_init(sm.a_empty(k), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // the producer warpgroup; one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      int stage = 0;
      uint32_t phase = 0, a_phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int pos0 = t * TILE;
        for (int j = 0; j < CHUNKS; ++j) {
          for (int k = 0; k < SLABS; ++k) {
            if (j == 0) {
              mbar_wait(sm.a_empty(k), a_phase ^ 1);
              mbar_expect_tx(sm.a_full(k), TILE_BYTES);
              tma_load(sm.a + k * TILE_BYTES, &x_map, sm.a_full(k), k * SLAB_ELEMS, pos0);
            }
            mbar_wait(sm.empty(stage), phase ^ 1);
            mbar_expect_tx(sm.full(stage), TILE_BYTES);
            tma_load(sm.b + stage * TILE_BYTES, &filt_map, sm.full(stage), k * SLAB_ELEMS,
                     j * BN);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
        a_phase ^= 1;
      }
      // every slot released by every consumer warp before the block exits
      for (int i = 0; i < STAGES; ++i) {
        mbar_wait(sm.empty(stage), phase ^ 1);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    Consumer<BF16, SLABS> c(sm, tid >> 7, tid);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      c.tile(t * TILE, n_pos, out);
    }
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

// [rows][depth] row-major, boxes of 128 bytes of depth x box_rows rows, the
// 128-byte swizzle; int8 moves as UINT8 (the same bytes)
CUresult make_map(CUtensorMap* map, bool bf16, const void* ptr, long long rows, int depth,
                  int box_rows) {
  const int elem = bf16 ? 2 : 1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(depth), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(depth) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(ROW / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode_fn()(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                     2, const_cast<void*>(ptr), dims, strides, box, steps,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The launch of P6 at BLOCKS blocks of depth: persistent, one block per SM
// (its shared memory holds one), fewer for fewer tiles.
template <bool BF16, int BLOCKS>
int launch(const void* filt, const void* x, int n_pos, void* out, cudaStream_t stream) {
  constexpr int SLABS = BLOCKS * (BF16 ? 2 : 1);
  static std::atomic<int> allowed[MAX_DEVICES];
  const auto kernel = gmma_kernel<BF16, SLABS>;
  const long long smem = smem_bytes(SLABS);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), allowed, smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  int sms = 0;
  const int sm_err = n_sms(&sms);
  if (sm_err != 0) {
    return sm_err;
  }
  if (encode_fn() == nullptr) {
    return -1;
  }
  const int depth = BLOCKS * BLOCK_DEPTH;
  CUtensorMap filt_map, x_map;
  CUresult res = make_map(&filt_map, BF16, filt, LANES, depth, BN);
  if (res == CUDA_SUCCESS) {
    res = make_map(&x_map, BF16, x, n_pos, depth, TILE);
  }
  if (res != CUDA_SUCCESS) {
    return -100 - static_cast<int>(res);
  }
  const int tiles = (n_pos + TILE - 1) / TILE;
  kernel<<<tiles < sms ? tiles : sms, THREADS, static_cast<size_t>(smem), stream>>>(
      filt_map, x_map, n_pos, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int launch_blocks(int blocks, const void* filt, const void* x, int n_pos, void* out,
                  cudaStream_t stream) {
  switch (blocks) {
    case 1:
      return launch<BF16, 1>(filt, x, n_pos, out, stream);
    case 3:
      return launch<BF16, 3>(filt, x, n_pos, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The P6 kernel's shapes: field 0 its lanes, 1 the depth of a block, 2 the
// most blocks (it takes 1 or 3), 3 the positions of a block's tile.
int lm_probe_gmma_shape(int f) {
  const int fields[] = {LANES, BLOCK_DEPTH, MAX_BLOCKS, TILE};
  return f >= 0 && f < 4 ? fields[f] : -1;
}

// P6: filt [2048][128 blocks] and x [n_pos][128 blocks], blocks 1 (the
// earlier probe's depth) or 3 (the JAX probe's), both int8 (bf16 = 0) or
// both bf16 (bf16 = 1), contiguous and 16-byte aligned; out: int32
// [n_pos].  Returns 0, the CUDA error of the launch (> 0), -1 when the
// driver has no cuTensorMapEncodeTiled, or -100 - the driver's error when
// it refuses a tensor map.
int lm_probe_gmma(int bf16, const void* filt, const void* x, int n_pos, int blocks, void* out,
                  void* stream) {
  if (n_pos <= 0) {
    return 0;
  }
  if (out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_blocks<true>(blocks, filt, x, n_pos, out, s)
              : launch_blocks<false>(blocks, filt, x, n_pos, out, s);
}

}  // extern "C"
