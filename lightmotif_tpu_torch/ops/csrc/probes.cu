// Probe P6 for NVIDIA Hopper (sm_90a): the tensor cores' integer and bf16
// rates at the prefilter's operand shapes.
//
// Replaces the Pallas probe experiments/int8_probe.py (run, its pallas_call
// at :54), which asked whether the TPU's int8 matrix unit beats bf16 at the
// prefilter's shapes.  Both kernels here compute, for every position p,
//
//   out[p] = max over lanes l of  sum_d filt[l][d] * x[p][d]
//
// with filt [2048 lanes][128 depth] and x [n_pos][128 depth] holding small
// non-negative integers (cells below 256, 0/1 windows), so every sum is an
// exact integer below 2^24 in either type.  probe_u8 multiplies them as
// u8 x u8 -> s32 with mma.sync.aligned.m16n8k32; probe_bf16 as bf16 x bf16 ->
// f32 with mma.sync.aligned.m16n8k16 and converts the max to int32.  What
// bounds each is its MMA work over the card's peak for its type (1,979 int8 /
// 989 bf16 tera-operations a second, dense); the probe reports its rate as a
// share of that.
//
// Design: a warp owns NT 8-position tiles (64 positions for u8, 32 for
// bf16, whose k-steps are half as deep) and keeps their fragments of x in
// registers for the whole depth.  The block streams filt through shared
// memory in 64-lane slabs with cp.async, double-buffered (one barrier per
// slab); each warp reads a 16-lane tile's fragments with ldmatrix, runs its
// MMAs and folds the tile into a running max.  The epilogue reduces over
// the lanes across the warp's eight groups with __shfl_xor_sync and writes
// one int32 per position.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 2048;
constexpr int DEPTH = 128;
constexpr int SLAB = 64;  // lanes per staged slab

__device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src));
}

__device__ __forceinline__ int to_int(int v) { return v; }
__device__ __forceinline__ int to_int(float v) { return static_cast<int>(v); }

// T: uint8_t or __nv_bfloat16; Acc: int or float.  filt: T [LANES][DEPTH];
// x: T [n_pos][DEPTH]; out: int32 [n_pos]
template <typename T, typename Acc, int NT>
__global__ void __launch_bounds__(THREADS)
probe_kernel(const T* __restrict__ filt, const T* __restrict__ x, int n_pos,
             int* __restrict__ out) {
  constexpr int ROW = DEPTH * sizeof(T);  // bytes of a lane's filter
  constexpr int LS = ROW + 16;            // staged: odd 16-byte units
  constexpr int KS = ROW / 32;            // 32-byte k-steps
  constexpr int POS = WARPS * NT * 8;     // positions per block
  __shared__ __align__(16) unsigned char slabs[2][SLAB * LS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int p0 = blockIdx.x * POS + (tid >> 5) * NT * 8;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(filt);

  auto load = [&](int slab) {
    for (int i = tid; i < SLAB * ROW / 16; i += THREADS) {
      const int l = i / (ROW / 16);
      const int piece = i - l * (ROW / 16);
      cp_async16(&slabs[slab & 1][l * LS + piece * 16],
                 src + static_cast<size_t>(slab * SLAB + l) * ROW + piece * 16);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load(0);

  unsigned b[NT][KS][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int p = min(p0 + nt * 8 + grp, n_pos - 1);
    const uint32_t* row = reinterpret_cast<const uint32_t*>(x + static_cast<size_t>(p) * DEPTH);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      b[nt][ks][0] = __ldg(row + ks * 8 + tig);
      b[nt][ks][1] = __ldg(row + ks * 8 + 4 + tig);
    }
  }
  Acc best[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) best[nt][0] = best[nt][1] = Acc(-1);

  const int lrow = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int lkk = (lane >> 4) * 16;
  for (int slab = 0; slab < LANES / SLAB; ++slab) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (slab + 1 < LANES / SLAB) load(slab + 1);
    const unsigned char* buf = slabs[slab & 1];
#pragma unroll
    for (int tile = 0; tile < SLAB / 16; ++tile) {
      Acc acc[NT][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned a[4];
        ldsm_x4(a, buf + (tile * 16 + lrow) * LS + ks * 32 + lkk);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma(acc[nt], a, b[nt][ks][0], b[nt][ks][1]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        best[nt][0] = max(best[nt][0], max(acc[nt][0], acc[nt][2]));
        best[nt][1] = max(best[nt][1], max(acc[nt][1], acc[nt][3]));
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int v = to_int(best[nt][r]);
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 16));
      const int p = p0 + nt * 8 + 2 * tig + r;
      if (grp == 0 && p < n_pos) out[p] = v;
    }
}

template <typename T, typename Acc, int NT>
int launch(const void* filt, const void* x, int n_pos, void* out, void* stream) {
  constexpr int POS = WARPS * NT * 8;
  probe_kernel<T, Acc, NT><<<(n_pos + POS - 1) / POS, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(filt), static_cast<const T*>(x), n_pos,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Lanes and depth of the probe's filters.
int lm_probe_lanes() { return LANES; }
int lm_probe_depth() { return DEPTH; }

// P6, u8 and bf16.  filt [2048][128] and x [n_pos][128], both uint8 or both
// bf16; out: int32 [n_pos].  Returns the CUDA error of the launch.
int lm_probe_mma_u8(const void* filt, const void* x, int n_pos, void* out,
                    void* stream) {
  return launch<uint8_t, int, 8>(filt, x, n_pos, out, stream);
}

int lm_probe_mma_bf16(const void* filt, const void* x, int n_pos, void* out,
                      void* stream) {
  return launch<__nv_bfloat16, float, 4>(filt, x, n_pos, out, stream);
}

}  // extern "C"
