// Probes for NVIDIA Hopper (sm_90a).  Two families, each a counterpart of
// Pallas probes the JAX package ran on the TPU; none runs on a path of the
// package (the probe modules lightmotif_tpu_torch/probes/*.py wrap them).
// P6, the tensor cores' int8 and bf16 rates at the prefilter's operand
// shapes, has a source of its own: probe_gmma.cu.
//
// 1. Family B, the scoring kernel's diagnostic bodies (diag_kernel,
//    lm_probe_score_diag): K1's memory pattern -- the block stages its
//    positions and halo, each thread scores P consecutive positions and
//    writes them as vector stores -- with one part of the work removed or
//    replaced, as the TPU probes P2 (floor), P4 (io only), P5 (K2 writing
//    uint8) and P15/P23 (noroll, nosel, addonly) did.
// 2. Family C, op-class chains (chain_kernel, lm_probe_op_chain): each
//    thread runs CHAINS independent chains of R ops of one class on one
//    element of a genome-sized buffer, the H100's answer to the TPU probes
//    P1, P3, P11, P12, P13 (device skeletons), P20 and P22, which timed
//    chains of lane rolls, adds, sublane gathers and int8 ops per vreg.

#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

// ---------------------------------------------------------------------------
// Family B: the scoring kernel's diagnostic bodies.  Geometry of K1's
// production form: 256 threads, 8 consecutive positions each, 2,048
// positions per block, the ranks (clamped to the wildcard, which is also
// read past lp) and the table staged once per block.  Each mode's output is
// the numpy formula of its JAX body (s: the rank, w: the f32 table, dm: the
// u8 table, eager masking at n_scores):
//
//   DIAG_IO     out[p] = float(seq[p]) + w[0][0], the raw byte, no mask
//               (P4 io_only / io_narrow: the kernel's io and its pipeline)
//   DIAG_FLOOR  sum_j float(s[p+j]) * w[j][0], products rounded, then added
//               in ascending j (P2 floor: shifts and adds, no lookup)
//   DIAG_NOSEL  sum_j float(s[p+j]) (P15 diag_nosel)
//   DIAG_NOROLL sum_j w[j][s[p]] (P15 diag_noroll: lookups, no shift)
//   DIAG_ADD    float(s[p]) added m times (P15 diag_addonly, P23 addsplit4)
//   DIAG_U8OUT  min(sum_j dm[j][s[p+j]], 255) as uint8, 255 at p >= n_scores
//               (P5: K2 writing a byte instead of an int32)

constexpr int DIAG_IO = 0;
constexpr int DIAG_FLOOR = 1;
constexpr int DIAG_NOSEL = 2;
constexpr int DIAG_NOROLL = 3;
constexpr int DIAG_ADD = 4;
constexpr int DIAG_U8OUT = 5;
constexpr int N_DIAG = 6;

constexpr int DG_P = 8;
constexpr int DG_NT = 256;
constexpr int DG_TP = DG_P * DG_NT;

__host__ __device__ inline int diag_tile_bytes(int m) { return (DG_TP + m + 3 + 15) / 16 * 16; }
__host__ __device__ inline int diag_table_bytes(int m, int k) { return (4 * m * k + 15) / 16 * 16; }

template <int MODE>
__global__ void __launch_bounds__(DG_NT)
diag_kernel(const uint8_t* __restrict__ seq, long long lp, const void* __restrict__ table,
            int m, int k, long long n_scores, void* __restrict__ out) {
  constexpr bool DISCRETE = MODE == DIAG_U8OUT;
  constexpr int NW = DG_P / 4 + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* tabf = reinterpret_cast<float*>(smem);
  int* tabi = reinterpret_cast<int*>(smem);
  uint8_t* tile = smem + diag_table_bytes(m, k);
  const int tile_bytes = diag_tile_bytes(m);
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * DG_TP;
  const unsigned wc = static_cast<unsigned>(k - 1);

  for (int i = tid; i < m * k; i += DG_NT) {
    if constexpr (DISCRETE) {
      tabi[i] = static_cast<const uint8_t*>(table)[i];
    } else {
      tabf[i] = static_cast<const float*>(table)[i];
    }
  }
  for (int i = tid; i < tile_bytes; i += DG_NT) {
    const long long g = base + i;
    const unsigned s = g < lp ? seq[g] : wc;
    tile[i] = static_cast<uint8_t>(MODE == DIAG_IO ? s : (s < wc ? s : wc));
  }
  __syncthreads();

  const int t0 = tid * DG_P;
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(tile + t0);
  float acc[DG_P];
  int iacc[DG_P];
#pragma unroll
  for (int i = 0; i < DG_P; ++i) {
    acc[i] = -0.0f;  // -0 + x == x
    iacc[i] = 0;
  }
  if constexpr (MODE == DIAG_IO) {
    const float w00 = tabf[0];
#pragma unroll
    for (int i = 0; i < DG_P; ++i) {
      acc[i] = __fadd_rn(__uint2float_rn(__byte_perm(wp[i >> 2], 0u, 0x4440u | (i & 3))), w00);
    }
  } else {
#pragma unroll 1
    for (int j0 = 0; j0 < m; j0 += 4) {
      // NOROLL and ADD read the thread's own positions for every row
      constexpr bool OWN = MODE == DIAG_NOROLL || MODE == DIAG_ADD;
      uint32_t w[NW];
#pragma unroll
      for (int q = 0; q < NW; ++q) w[q] = wp[(OWN ? 0 : j0 >> 2) + q];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
        if (j >= m) break;
#pragma unroll
        for (int i = 0; i < DG_P; ++i) {
          const int b = OWN ? i : i + jj;
          const unsigned s = __byte_perm(w[b >> 2], 0u, 0x4440u | (b & 3));
          if constexpr (MODE == DIAG_FLOOR) {
            acc[i] = __fadd_rn(acc[i], __fmul_rn(__uint2float_rn(s), tabf[j * k]));
          } else if constexpr (MODE == DIAG_NOSEL || MODE == DIAG_ADD) {
            acc[i] = __fadd_rn(acc[i], __uint2float_rn(s));
          } else if constexpr (MODE == DIAG_NOROLL) {
            acc[i] = __fadd_rn(acc[i], tabf[j * k + s]);
          } else {  // DIAG_U8OUT
            iacc[i] += tabi[j * k + s];
          }
        }
      }
    }
  }

  const long long p0 = base + t0;
  if constexpr (DISCRETE) {
    uint8_t v[DG_P];
#pragma unroll
    for (int i = 0; i < DG_P; ++i) {
      v[i] = static_cast<uint8_t>(p0 + i < n_scores ? min(iacc[i], 255) : 255);
    }
    uint8_t* o = static_cast<uint8_t*>(out) + p0;
    if (p0 + DG_P <= lp) {
      uint2 pk;
      pk.x = v[0] | v[1] << 8 | v[2] << 16 | static_cast<uint32_t>(v[3]) << 24;
      pk.y = v[4] | v[5] << 8 | v[6] << 16 | static_cast<uint32_t>(v[7]) << 24;
      *reinterpret_cast<uint2*>(o) = pk;
    } else {
      for (int i = 0; i < DG_P; ++i) {
        if (p0 + i < lp) o[i] = v[i];
      }
    }
  } else {
    float v[DG_P];
#pragma unroll
    for (int i = 0; i < DG_P; ++i) {
      v[i] = MODE != DIAG_IO && p0 + i >= n_scores ? -INFINITY : acc[i];
    }
    float* o = static_cast<float*>(out) + p0;
    if (p0 + DG_P <= lp) {
      reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      for (int i = 0; i < DG_P; ++i) {
        if (p0 + i < lp) o[i] = v[i];
      }
    }
  }
}

template <int MODE>
int launch_diag(const void* seq, long long lp, const void* table, int m, int k,
                long long n_scores, void* out, void* stream) {
  const int smem = diag_table_bytes(m, k) + diag_tile_bytes(m);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        diag_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const long long blocks = (lp + DG_TP - 1) / DG_TP;
  diag_kernel<MODE><<<static_cast<unsigned int>(blocks), DG_NT, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seq), lp, table, m, k, n_scores, out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Family C: op-class chains.  Element e of x (uint8 [n], n a multiple of 32)
// is thread e; its lane is e % 32.  Chain c starts from x + c; every step
// i < R updates every chain (the chains are independent, so CHAINS > 1
// measures issue rate rather than latency); the result folds the chains in
// ascending c (f32 ops: left-fold adds; integer ops: the sum).  table: the
// op's table (32 floats, t[c] = (c & 7) + (c >> 3): the TPU probes' sublane
// index for c < 8, and P13's pair4 value for a pair code; 8 bytes for
// OP_PRMT; 256 bytes for OP_GATHER), read from device memory so that the
// compiler cannot fold a lookup.
//
//   OP_FADD    b = x, v = b + c; v = v + b (even i) or v - b (odd i) (P3's
//              calibration body)
//   OP_SHFL    v = x + c; v = v of lane (lane + 1 + i % 3) % 32, __shfl_sync
//   OP_SMEM    the same cross-lane shift through shared memory
//   OP_LDS     idx = (x + c) & 7, v = 0; v += t[idx] (shared memory); idx += 1 mod 8
//   OP_SEL     the same lookup by a 3-level select tree over registers
//   OP_PRMT    the same lookup of bytes t8[idx] by __byte_perm and a mask
//              (integer sum)
//   OP_MIX     idx = (x + c) & 7, v = t[idx]; v += (t[(idx + i) & 7] of lane
//              (lane + i + 1) % 32): P12's kernelmix, a lookup and a shift per add
//   OP_SKEL1   idx = (x + c) % 5, v = 0; idx = idx of lane + 1; v += t[idx & 7]
//              (P13 single: per row a shift, one lookup, one add)
//   OP_PAIR1   idx = ((x + c) % 5) * 5 + ((x + c) >> 2) % 5; idx = idx of lane
//              + 2; v += t[idx] (P13 pair1: on this card a 25-entry table is
//              one lookup, so it sums what pair4 does)
//   OP_PAIR4   the same sums with the 25-entry lookup as four 8-entry lookups
//              and three selects (P13 pair4, the TPU's construction)
//   OP_VADD4   four copies of b = (x + c) & 255 in a word; b = min(b + 1 +
//              i % 3, 255) with __vaddus4; the result sums byte 0
//   OP_VSEL    the same word; b = b >= 200 ? 7 : b + 1 with __vcmpgeu4, a
//              byte-wise select and __vadd4
//   OP_GATHER  b = (x + c) & 255; b = t256[b] (a 256-entry byte table in
//              shared memory)

constexpr int OP_FADD = 0;
constexpr int OP_SHFL = 1;
constexpr int OP_SMEM = 2;
constexpr int OP_LDS = 3;
constexpr int OP_SEL = 4;
constexpr int OP_PRMT = 5;
constexpr int OP_MIX = 6;
constexpr int OP_SKEL1 = 7;
constexpr int OP_PAIR1 = 8;
constexpr int OP_PAIR4 = 9;
constexpr int OP_VADD4 = 10;
constexpr int OP_VSEL = 11;
constexpr int OP_GATHER = 12;

constexpr int CH_NT = 256;

#define LM_CHAIN_VARIANTS(X) \
  X(OP_FADD, 0, 1)           \
  X(OP_FADD, 14, 1)          \
  X(OP_FADD, 28, 1)          \
  X(OP_FADD, 64, 1)          \
  X(OP_FADD, 8, 8)           \
  X(OP_SHFL, 14, 1)          \
  X(OP_SHFL, 28, 1)          \
  X(OP_SHFL, 14, 4)          \
  X(OP_SHFL, 7, 4)           \
  X(OP_SMEM, 14, 1)          \
  X(OP_SMEM, 28, 1)          \
  X(OP_LDS, 14, 1)           \
  X(OP_LDS, 28, 1)           \
  X(OP_LDS, 14, 4)           \
  X(OP_LDS, 7, 4)            \
  X(OP_SEL, 14, 1)           \
  X(OP_SEL, 14, 4)           \
  X(OP_PRMT, 14, 1)          \
  X(OP_PRMT, 14, 4)          \
  X(OP_MIX, 14, 1)           \
  X(OP_MIX, 28, 1)           \
  X(OP_SKEL1, 14, 1)         \
  X(OP_PAIR1, 7, 1)          \
  X(OP_PAIR4, 7, 1)          \
  X(OP_VADD4, 14, 1)         \
  X(OP_VADD4, 14, 4)         \
  X(OP_VSEL, 14, 1)          \
  X(OP_VSEL, 14, 4)          \
  X(OP_GATHER, 14, 1)        \
  X(OP_GATHER, 14, 4)

struct Chain {
  int op, r, chains;
};
#define LM_CHAIN_ROW(op, r, c) {op, r, c},
constexpr Chain CHAINS_TABLE[] = {LM_CHAIN_VARIANTS(LM_CHAIN_ROW)};
#undef LM_CHAIN_ROW
constexpr int N_CHAINS = sizeof(CHAINS_TABLE) / sizeof(CHAINS_TABLE[0]);

__host__ __device__ constexpr bool op_is_float(int op) {
  return op == OP_FADD || op == OP_LDS || op == OP_SEL || op == OP_MIX || op == OP_SKEL1 ||
         op == OP_PAIR1 || op == OP_PAIR4;
}

__device__ __forceinline__ float sel8(const float (&t)[8], unsigned s) {
  const bool b0 = s & 1u, b1 = s & 2u, b2 = s & 4u;
  const float v01 = b0 ? t[1] : t[0];
  const float v23 = b0 ? t[3] : t[2];
  const float v45 = b0 ? t[5] : t[4];
  const float v67 = b0 ? t[7] : t[6];
  const float v03 = b1 ? v23 : v01;
  const float v47 = b1 ? v67 : v45;
  return b2 ? v47 : v03;
}

template <int OP, int R, int C>
__global__ void __launch_bounds__(CH_NT)
chain_kernel(const uint8_t* __restrict__ x, long long n, const void* __restrict__ table,
             void* __restrict__ out) {
  __shared__ float ftab[32];
  __shared__ uint8_t btab[256];
  __shared__ int xbuf[C][CH_NT];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (OP == OP_GATHER) {
    btab[tid] = static_cast<const uint8_t*>(table)[tid];
  } else if (OP != OP_PRMT && tid < 32) {
    ftab[tid] = static_cast<const float*>(table)[tid];
  }
  __syncthreads();
  const long long e = static_cast<long long>(blockIdx.x) * CH_NT + tid;
  if (e >= n) {
    return;  // whole warps: n is a multiple of 32
  }
  const unsigned xv = x[e];

  if constexpr (OP_FADD == OP) {
    const float b = __uint2float_rn(xv);
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __fadd_rn(b, static_cast<float>(c));
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = (i & 1) ? __fsub_rn(v[c], b) : __fadd_rn(v[c], b);
    float o = v[0];
#pragma unroll
    for (int c = 1; c < C; ++c) o = __fadd_rn(o, v[c]);
    static_cast<float*>(out)[e] = o;
  } else if constexpr (OP == OP_SHFL || OP == OP_SMEM) {
    int v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = static_cast<int>(xv) + c;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int src = (lane + 1 + i % 3) & 31;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if constexpr (OP == OP_SHFL) {
          v[c] = __shfl_sync(FULL_MASK, v[c], src);
        } else {
          xbuf[c][tid] = v[c];
          __syncwarp();
          v[c] = xbuf[c][(tid & ~31) | src];
          __syncwarp();
        }
      }
    }
    int o = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) o += v[c];
    static_cast<int*>(out)[e] = o;
  } else if constexpr (OP == OP_LDS || OP == OP_SEL || OP == OP_PRMT) {
    float t[8];
    uint32_t lo = 0, hi = 0;
    if constexpr (OP == OP_SEL) {
#pragma unroll
      for (int q = 0; q < 8; ++q) t[q] = static_cast<const float*>(table)[q];
    }
    if constexpr (OP == OP_PRMT) {
      lo = static_cast<const uint32_t*>(table)[0];
      hi = static_cast<const uint32_t*>(table)[1];
    }
    unsigned idx[C];
    float v[C];
    int iv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      idx[c] = (xv + c) & 7u;
      v[c] = 0.0f;
      iv[c] = 0;
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if constexpr (OP == OP_LDS) {
          v[c] = __fadd_rn(v[c], ftab[idx[c]]);
        } else if constexpr (OP == OP_SEL) {
          v[c] = __fadd_rn(v[c], sel8(t, idx[c]));
        } else {
          // __byte_perm takes the low 3 bits of each selector nibble: byte
          // idx lands in byte 0 and the mask drops the other three
          iv[c] += static_cast<int>(__byte_perm(lo, hi, idx[c]) & 255u);
        }
        idx[c] = (idx[c] + 1u) & 7u;
      }
    if constexpr (OP == OP_PRMT) {
      int o = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) o += iv[c];
      static_cast<int*>(out)[e] = o;
    } else {
      float o = v[0];
#pragma unroll
      for (int c = 1; c < C; ++c) o = __fadd_rn(o, v[c]);
      static_cast<float*>(out)[e] = o;
    }
  } else if constexpr (OP == OP_MIX || OP == OP_SKEL1 || OP == OP_PAIR1 || OP == OP_PAIR4) {
    unsigned idx[C];
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const unsigned xc = xv + c;
      if constexpr (OP == OP_MIX) {
        idx[c] = xc & 7u;
        v[c] = ftab[idx[c]];
      } else if constexpr (OP == OP_SKEL1) {
        idx[c] = xc % 5u;
        v[c] = 0.0f;
      } else {
        idx[c] = (xc % 5u) * 5u + (xc >> 2) % 5u;
        v[c] = 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if constexpr (OP == OP_MIX) {
          const float w = ftab[(idx[c] + i) & 7u];
          v[c] = __fadd_rn(v[c], __shfl_sync(FULL_MASK, w, (lane + i + 1) & 31));
        } else if constexpr (OP == OP_SKEL1) {
          idx[c] = __shfl_sync(FULL_MASK, idx[c], (lane + 1) & 31);
          v[c] = __fadd_rn(v[c], ftab[idx[c] & 7u]);
        } else if constexpr (OP == OP_PAIR1) {
          idx[c] = __shfl_sync(FULL_MASK, idx[c], (lane + 2) & 31);
          v[c] = __fadd_rn(v[c], ftab[idx[c]]);
        } else {
          idx[c] = __shfl_sync(FULL_MASK, idx[c], (lane + 2) & 31);
          const unsigned low = idx[c] & 7u;
          float val = ftab[low];
#pragma unroll
          for (int g = 1; g < 4; ++g) {
            const float vg = ftab[8 * g + low];
            val = idx[c] >= 8u * g ? vg : val;
          }
          v[c] = __fadd_rn(v[c], val);
        }
      }
    float o = v[0];
#pragma unroll
    for (int c = 1; c < C; ++c) o = __fadd_rn(o, v[c]);
    static_cast<float*>(out)[e] = o;
  } else {  // OP_VADD4, OP_VSEL, OP_GATHER
    uint32_t v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint32_t b = (xv + c) & 255u;
      v[c] = OP == OP_GATHER ? b : b * 0x01010101u;
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if constexpr (OP == OP_VADD4) {
          v[c] = __vaddus4(v[c], (1u + i % 3) * 0x01010101u);
        } else if constexpr (OP == OP_VSEL) {
          const uint32_t big = __vcmpgeu4(v[c], 0xC8C8C8C8u);
          v[c] = (__vadd4(v[c], 0x01010101u) & ~big) | (0x07070707u & big);
        } else {
          v[c] = btab[v[c]];
        }
      }
    int o = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) o += static_cast<int>(v[c] & 255u);
    static_cast<int*>(out)[e] = o;
  }
}

template <int OP, int R, int C>
int launch_chain(const void* x, long long n, const void* table, void* out, void* stream) {
  const long long blocks = (n + CH_NT - 1) / CH_NT;
  chain_kernel<OP, R, C><<<static_cast<unsigned int>(blocks), CH_NT, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), n, table, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Family B: diagnostic body `mode` (DIAG_*) on the scoring kernel's inputs:
// seq uint8 [lp]; table float32 [m][k] (uint8 for DIAG_U8OUT); out float32
// [lp] (uint8 for DIAG_U8OUT).  Returns the CUDA error of the launch.
int lm_probe_diag_modes() { return N_DIAG; }
long long lm_probe_diag_smem(int m, int k) {
  return static_cast<long long>(diag_table_bytes(m, k)) + diag_tile_bytes(m);
}
int lm_probe_score_diag(int mode, const void* seq, long long lp, const void* table, int m,
                        int k, long long n_scores, void* out, void* stream) {
  if (lp <= 0) {
    return 0;
  }
  switch (mode) {
    case DIAG_IO:
      return launch_diag<DIAG_IO>(seq, lp, table, m, k, n_scores, out, stream);
    case DIAG_FLOOR:
      return launch_diag<DIAG_FLOOR>(seq, lp, table, m, k, n_scores, out, stream);
    case DIAG_NOSEL:
      return launch_diag<DIAG_NOSEL>(seq, lp, table, m, k, n_scores, out, stream);
    case DIAG_NOROLL:
      return launch_diag<DIAG_NOROLL>(seq, lp, table, m, k, n_scores, out, stream);
    case DIAG_ADD:
      return launch_diag<DIAG_ADD>(seq, lp, table, m, k, n_scores, out, stream);
    case DIAG_U8OUT:
      return launch_diag<DIAG_U8OUT>(seq, lp, table, m, k, n_scores, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Family C: the chains, their count and field f of chain variant v (0 op, 1
// steps R, 2 chains, 3 whether the output is float32); -1 out of range.
int lm_probe_chains() { return N_CHAINS; }
int lm_probe_chain_info(int v, int f) {
  if (v < 0 || v >= N_CHAINS || f < 0 || f > 3) {
    return -1;
  }
  const Chain& c = CHAINS_TABLE[v];
  const int fields[] = {c.op, c.r, c.chains, op_is_float(c.op) ? 1 : 0};
  return fields[f];
}

// x uint8 [n] (n a multiple of 32); table: the op's table; out float32 or
// int32 [n].
int lm_probe_op_chain(int v, const void* x, long long n, const void* table, void* out,
                      void* stream) {
  if (n <= 0 || n % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int i = 0;
#define LM_CHAIN_CASE(op, r, c) \
  if (v == i++) {               \
    return launch_chain<op, r, c>(x, n, table, out, stream); \
  }
  LM_CHAIN_VARIANTS(LM_CHAIN_CASE)
#undef LM_CHAIN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
