// One whole HiFi-GAN MRF stage for Hopper (sm_90a): fp32 or bf16 in and out (the
// output takes x's type), bf16 or fp32 operands for the convolution products,
// fp32 accumulation, bias, residual and mean.
//
// Replaces the TPU kernels mri2speech_tpu/ops/pallas_mrf.py::
// mrf_stage_pallas_v2 (:259, compact (B, T, C) input, every branch starts
// from the same x) and ::mrf_stage_pallas (:352, branch-tiled input, branch j
// starts from its own slice). One kernel serves both: the input is read
// through a branch stride, 0 for v2 and C (or C*T) for v1. The stage is
// NB branches (kernels k_j, e.g. 3/7/11), each NU units (dilations, e.g.
// 1/3/5) of
//   y   = causal_conv_{k_j, d}(leaky(cur)) + b1
//   cur = cur + causal_conv_{k_j, 1}(leaky(y)) + b2
// followed by the branch mean. Activations are rounded to the operand type
// right after leaky, just before each product; bias, residual and the mean
// stay fp32 (where the TPU kernel rounds). Rows before t = 0 are literal zeros
// at every conv's input; the bias never reaches them.
//
// What bounds it: operations. A stage does 2 * NU * sum(k_j) * T * C^2
// multiply-adds (252 * T * C^2 FLOPs at 3/7/11 and 1/3/5): ~200 GFLOP for
// the four stages of a 256-frame request, against a few tens of MB that must
// move.
//
// Design. A CTA owns one branch j, one batch row and a time tile of TM_j rows,
// and runs a chain of convs on it with everything it needs on chip: the input
// rows of the tile plus the chain's receptive-field halo, recomputed as the TPU
// kernel does (pallas_mrf.py:17-20). Each conv's outputs are computed in 64-row
// tiles aligned at the end of the buffer (the halo shrinks conv by conv), and
// written back in place over the rows they replace.
//   * Chain mode (C <= 64, stages 2-3 of the generator): one launch runs the
//     whole unit chain of the branch. The fp32 residual stream (cur) and the
//     operand tile (leaky(cur) or leaky(y), rounded) stay in shared memory;
//     only the branch's final state leaves.
//   * Unit mode (C > 64, stages 0-1): one launch per unit fuses conv1 -> leaky
//     -> round -> conv2 + residual; leaky(y) never leaves the SM. Between
//     launches pass the fp32 state and leaky(state) already rounded to the
//     operand type (exact by construction), so the next launch reads its halo
//     at the operand's width and the fp32 residual only at the rows it owns.
//     The output channels are split over a cluster of NP CTAs (NW each): each
//     loads its NW input channels and computes its NW output channels of both
//     convs, and every operand slab it makes goes to the other CTAs' tiles
//     through distributed shared memory.
//   * The taps stream through a ring of S stages in shared memory: one stage
//     is one tap's NW x KS slice of (output channel x input channel), laid out
//     by the wrapper (ops/mrf.py::MRFStageWeights.kernel_layout) exactly as the
//     shared tile, one bulk copy by the Tensor Memory Accelerator completing on
//     the stage's mbarrier. A 13th warp feeds the ring: it issues each conv's
//     stages as every compute warp releases their slots (a second mbarrier), then
//     what fits of the next conv, and joins the CTA's and cluster's barriers at
//     the same points as the compute warps. (Fed by a compute thread, the copies'
//     issue cost its warpgroup ~1000 clocks a stage, and the whole CTA waited.)
//   * Products: bf16 operands run wgmma with A, the activations, from registers
//     (ldmatrix at per-lane row addresses: tap m reads the rows shifted by m*d,
//     which is seldom a multiple of 8, so a shifted tile cannot be a shared
//     memory descriptor) and B, the taps, from the ring in the core-matrix
//     layout. The first product of each chain starts from nothing (scale-d 0).
//     Branches on the warpgroup index use a value broadcast from lane 0, so
//     ptxas sees them as uniform and does not serialize the chains (C7520).
//     fp32 operands run FMAs on the CUDA cores in the same register layout.
//   * Three warpgroups share a conv's 64-row tiles. Grid: the branches' CTAs,
//     heaviest first, each branch with its own TM_j chosen in Python
//     (ops/mrf.py::tile_plan) so that the CTAs of every branch cost about the
//     same and the grid fills the card.
//   * The input tile is read 16 bytes a load (time-contiguous layouts), and the
//     output leaves from shared memory 16 bytes a store; between units the state
//     and its activation go through (nb, B, C, T) scratch.
//   * The branch mean is one more launch that sums the branches' final states
//     in a fixed order and writes x's type: no atomics, a run repeats bit for bit.
// Resources (nvcc -Xptxas -v, sm_90a): 416 threads, at most 128 registers a
// thread (13 warps are allocated as 16), 0-12 bytes of spills; shared memory
// by the plan, up to 227 KB; one CTA an SM. Times and the design's iterations
// in PERF.md.
//
// Built without --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tile_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using m2s::bulk_copy;
using m2s::ldmatrix_x4;
using m2s::mbar_arrive;
using m2s::mbar_expect;
using m2s::mbar_init;
using m2s::mbar_init_fence;
using m2s::mbar_wait;
using m2s::wg_commit_wait;
using m2s::wg_desc;
using m2s::wg_fence;
using m2s::Wgmma;

constexpr int NWG = 3;  // warpgroups a CTA that compute
constexpr int THREADS = 128 * NWG;
constexpr int CTA_THREADS = THREADS + 32;  // and one warp that feeds the tap ring
constexpr int MAX_NB = 4;
constexpr int MAX_UNITS = 8;
constexpr int MAX_STAGES = 8;
constexpr int MAX_NP = 8;  // CTAs a cluster (the portable limit)
constexpr int SMEM_LIMIT = 232448;
constexpr float SLOPE = 0.1f;

// ---- geometry, mirrored by ops/mrf.py ----
// input channels padded for the products: a multiple of the K slice
__host__ __device__ inline int padded_channels(int C) {
  return C <= 32 ? (C + 15) / 16 * 16 : C <= 64 ? (C + 31) / 32 * 32 : (C + 63) / 64 * 64;
}
__host__ __device__ inline int k_slice(int Kp, bool bf) { return Kp < (bf ? 64 : 32) ? Kp : (bf ? 64 : 32); }
// rows the taps of conv q (2u + c) reach back
__host__ __device__ inline int reach_of(int q, int k, const int* dil) {
  return (q & 1) ? k - 1 : (k - 1) * dil[q >> 1];
}
// Buffer rows of a tile of TM rows through convs q0 .. q1-1 of a branch with kernel k:
// conv q computes n_q 64-row tiles aligned at the end, enough for the TM rows plus
// what the later convs reach back, and reads reach(q) rows below them. Sets
// *n_max to the largest n_q.
__host__ __device__ inline int rows_of(int k, const int* dil, int q0, int q1, int TM, int* n_max) {
  int h = 0;
  for (int q = q0; q < q1; ++q) h += reach_of(q, k, dil);
  int rows = 0, nm = 0;
  for (int q = q0; q < q1; ++q) {
    const int r = reach_of(q, k, dil);
    h -= r;
    const int n = (TM + h + 63) / 64;
    nm = n > nm ? n : nm;
    rows = 64 * n + r > rows ? 64 * n + r : rows;
  }
  if (n_max) *n_max = nm;
  return (rows + 7) / 8 * 8;
}
__host__ __device__ inline size_t round128(size_t n) { return (n + 127) / 128 * 128; }
// byte offsets: mbarriers (full, empty), tap ring, operand tile, fp32 state: chain mode
// every buffer row and channel, unit mode the tile's TM rows of the CTA's NW channels
struct Smem {
  size_t ring, act, cur, total, stage;
  __host__ __device__ Smem(int rows, int tm, int Kp, int NW, bool bf, bool chain, int S) {
    const int KS = k_slice(Kp, bf);
    const size_t es = bf ? 2 : 4;
    stage = NW * (size_t)(bf ? KS : KS + 4) * es;
    ring = round128(16 * MAX_STAGES);
    act = ring + S * round128(stage);
    cur = act + round128((size_t)rows * (Kp + (bf ? 8 : 4)) * es);
    total = cur + (chain ? (size_t)rows * (Kp + 4) : (size_t)tm * (NW + 4)) * 4;
  }
};

struct Tensor {  // element (b, branch j, channel c, time t) at p[b*sb + j*sj + c*sc + t*st]
  const void* p;
  long long sb, sj, sc, st;
  int bf16;
};

struct Args {
  Tensor in;      // conv q0's input: the state (in_act 0), or leaky(state) in the operand type
  Tensor res;     // unit mode: the state the launch's residual adds
  float* out;     // the state after the launch, (nb, B, C, T) fp32
  void* out_act;  // unit mode but the last unit: leaky(out) in the operand type, (nb, B, C, T)
  const void* w;  // taps (MRFStageWeights.kernel_layout)
  const float* bias;  // (2 NU, nb, C)
  int k[MAX_NB], kpre[MAX_NB], tm[MAX_NB], dil[MAX_UNITS];
  int slot_branch[MAX_NB], item0[MAX_NB + 1];  // launch order: slot i = branch slot_branch[i]
  int nb, ksum, B, C, T, Kp, KS, NW, NP, S;
  int q0, q1, chain, in_act;
  unsigned ring_off, act_off, cur_off, stage_bytes;
};

// Rows [crow0, crow0 + rows) and channels [ccol0, ccol0 + cols) of the fp32 state held in
// shared memory, rows ld floats apart
struct State {
  float* p;
  int crow0, ccol0, ld;
  __device__ float* at(int row, int col) const { return p + (row - crow0) * ld + (col - ccol0); }
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.0f ? v : v * SLOPE; }
// The warpgroup index, broadcast from lane 0 so that the compiler knows it is the
// same across the warp: branches on it then do not count as divergent, and the
// wgmma chains inside them are not serialized (ptxas C7520).
__device__ __forceinline__ int warpgroup() { return __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0); }
// Output tiles a warpgroup holds: one at 128 channels, two where the accumulator or the A
// fragments of a tile are large (64 channels, or a K slice of 64 bf16), else four.
template <typename T>
__host__ __device__ constexpr int tiles_a_warpgroup(int nw, int ks) {
  return nw == 128 ? 1 : nw == 64 || (sizeof(T) == 2 && ks == 64) ? 2 : 4;
}
__device__ __forceinline__ float load_f(const void* p, long long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// Reads rows [tlo, tlo + nrows) (times) and channels [clo, clo + ncols) of `in` for
// branch j, batch row b, as fp32, 0 outside [0, T) x [0, C), and hands each element to
// put(row - tlo, channel, v). Time-contiguous input (the generator's (B, C, T) and the
// stage's scratch) is read 16 bytes a load, a warp taking 8 channels x 4 groups of V
// times, U loads in flight a thread; other layouts one element a load along their
// contiguous axis.
template <typename Put>
__device__ void load_tile(const Tensor& in, const Args& a, int j, int b, int tlo, int nrows,
                          int clo, int ncols, Put put) {
  const long long base = b * in.sb + j * in.sj;
  const int V = in.bf16 ? 8 : 4;
  const bool vec = in.st == 1 && reinterpret_cast<uintptr_t>(in.p) % 16 == 0 && in.sb % V == 0 &&
                   in.sj % V == 0 && in.sc % V == 0 && tlo % V == 0 && nrows % V == 0;
  if (vec) {
    constexpr int U = 8;
    const int ng = nrows / V;
    const int tblk = (ng + 3) / 4;
    const int n = ((ncols + 7) / 8) * tblk * 32;
    for (int i0 = threadIdx.x; i0 < n; i0 += U * THREADS) {
      uint4 raw[U];
      int row[U], col[U];
      bool full[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = i0 + u * THREADS;
        const int l = idx & 31, blk = idx >> 5;
        const int c = clo + (blk / tblk) * 8 + (l & 7);
        const int g = (blk % tblk) * 4 + (l >> 3);
        const int t = tlo + g * V;
        row[u] = (idx < n && g < ng && c < clo + ncols) ? g * V : -1;
        col[u] = c;
        full[u] = row[u] >= 0 && c < a.C && t >= 0 && t + V <= a.T;
        const char* src = static_cast<const char*>(in.p) +
                          (base + (long long)c * in.sc + t) * (in.bf16 ? 2 : 4);
        raw[u] = full[u] ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (row[u] < 0) continue;
        const int c = col[u];
        const int t = tlo + row[u];
        const long long off = base + (long long)c * in.sc + t;
        if (in.bf16) {
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float2 f = __bfloat1622float2(h[e]);
            if (!full[u]) {
              const bool ok = c < a.C;
              f.x = ok && t + 2 * e >= 0 && t + 2 * e < a.T ? load_f(in.p, off + 2 * e, 1) : 0.0f;
              f.y = ok && t + 2 * e + 1 >= 0 && t + 2 * e + 1 < a.T ? load_f(in.p, off + 2 * e + 1, 1) : 0.0f;
            }
            put(row[u] + 2 * e, c, f.x);
            put(row[u] + 2 * e + 1, c, f.y);
          }
        } else {
          const float* f = reinterpret_cast<const float*>(&raw[u]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = f[e];
            if (!full[u]) v = c < a.C && t + e >= 0 && t + e < a.T ? load_f(in.p, off + e, 0) : 0.0f;
            put(row[u] + e, c, v);
          }
        }
      }
    }
    return;
  }
  constexpr int U = 8;
  const bool ch_fast = in.sc == 1;
  const int n = nrows * ncols;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * THREADS) {
    float v[U];
    int row[U], col[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = i0 + u * THREADS;
      const int r = ch_fast ? idx / ncols : idx % nrows;
      const int c = clo + (ch_fast ? idx % ncols : idx / nrows);
      const int t = tlo + r;
      row[u] = idx < n ? r : -1;
      col[u] = c;
      v[u] = (idx < n && c < a.C && t >= 0 && t < a.T)
                 ? load_f(in.p, base + (long long)c * in.sc + (long long)t * in.st, in.bf16)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (row[u] >= 0) put(row[u], col[u], v[u]);
  }
}

// The launch's output: the state's rows for times [t0, t0 + TM) (fp32) and, but after the
// last unit, leaky(state) in the operand type, channels [clo, clo + ncols), to the
// (nb, B, C, T) scratch; four times a thread where the layout allows it, a warp taking 8
// channels x 4 groups.
template <typename T>
__device__ void store_tile(const Args& a, const State& cur, int j, int b, int t0, int TM,
                           int row_t0, int clo, int ncols) {
  T* oa = static_cast<T*>(a.out_act);
  const long long base = ((long long)j * a.B + b) * a.C;
  const bool vec = a.T % 4 == 0;
  const int V = vec ? 4 : 1;
  const int ng = TM / V;
  const int tblk = (ng + 3) / 4;
  const int n = ((ncols + 7) / 8) * tblk * 32;
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const int l = idx & 31, blk = idx >> 5;
    const int c = clo + (blk / tblk) * 8 + (l & 7);
    const int g = (blk % tblk) * 4 + (l >> 3);
    const int t = t0 + g * V;
    if (g >= ng || c >= clo + ncols || c >= a.C || t >= a.T) continue;
    const long long o = (base + c) * a.T + t;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < V ? *cur.at(row_t0 + g * V + e, c) : 0.0f;
    if (vec && t + 4 <= a.T) {
      *reinterpret_cast<float4*>(a.out + o) = make_float4(v[0], v[1], v[2], v[3]);
      if (oa) {
        if constexpr (sizeof(T) == 2) {
          __nv_bfloat162 lo = __floats2bfloat162_rn(leaky(v[0]), leaky(v[1]));
          __nv_bfloat162 hi = __floats2bfloat162_rn(leaky(v[2]), leaky(v[3]));
          uint2 pk;
          pk.x = *reinterpret_cast<unsigned*>(&lo);
          pk.y = *reinterpret_cast<unsigned*>(&hi);
          *reinterpret_cast<uint2*>(oa + o) = pk;
        } else {
          *reinterpret_cast<float4*>(oa + o) =
              make_float4(leaky(v[0]), leaky(v[1]), leaky(v[2]), leaky(v[3]));
        }
      }
    } else {
      for (int e = 0; e < V && t + e < a.T; ++e) {
        a.out[o + e] = v[e];
        if (oa) oa[o + e] = m2s::Operand<T>::round(leaky(v[e]));
      }
    }
  }
}

// Copies this CTA's slab (rows [r0, r1), channels [c0, c0 + NW)) of the operand tile
// into the other CTAs of the cluster, 16 bytes a store.
template <typename T>
__device__ void broadcast_slab(T* act, int lda, int r0, int r1, int c0, int NW, int NP) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned me = cluster.block_rank();
  const int per_row = NW * (int)sizeof(T) / 16;
  const int per_peer = (r1 - r0) * per_row;
  for (int idx = threadIdx.x; idx < per_peer * (NP - 1); idx += THREADS) {
    const int pi = idx / per_peer;
    const int rest = idx - pi * per_peer;
    const int r = r0 + rest / per_row;
    const int v = rest % per_row;
    const unsigned rank = pi + (pi >= (int)me ? 1 : 0);
    T* src = act + r * lda + c0;
    T* dst = cluster.map_shared_rank(src, rank);
    reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(src)[v];
  }
}

// acc[mt] (+)= the conv's 64-row tile wg + NWG*mt (rows row0 + 64*tile ..) for one
// ring stage: tap shift `shift`, input channels k0 .. k0 + KS of the operand tile
// against the stage's NW x KS taps; acc starts from nothing if `first`.
// bf16: wgmma, A from registers (ldmatrix), B from shared memory, tile after tile, each
// done before the next loads its fragments into the same registers (a second set of
// fragments cost more in spills than its overlap gained). Nothing is in flight on
// return, so no wgmma crosses the ring's waits.
template <int NW, int MT, int KK>
__device__ __forceinline__ void product(float (&acc)[MT][NW / 2], const bf16* act, int lda, int row0,
                                        int shift, int k0, const void* ring, int nq, bool first) {
  const int lane = threadIdx.x & 31;
  const int wq = (threadIdx.x >> 5) & 3;
  const int wg = warpgroup();
  const uint64_t db = wg_desc(ring, 16 * KK);
  uint32_t fa[KK][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (wg + NWG * mt >= nq) continue;
    const bf16* p = act + (row0 + 64 * (wg + NWG * mt) + 16 * wq + (lane & 15) - shift) * lda + k0 +
                    (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) ldmatrix_x4(fa[kk], p + 16 * kk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      Wgmma<NW>::mma(acc[mt], fa[kk], db + 16 * kk, first && kk == 0 ? 0 : 1);
    wg_commit_wait();
  }
}

// fp32: FMAs, the same register layout (warp wq: rows 16 wq + g and + 8, columns
// 8j + 2t, + 1 with g = lane / 4, t = lane % 4); the stage holds rows KS + 4 apart.
template <int NW, int MT>
__device__ __forceinline__ void product_fma(float (&acc)[MT][NW / 2], const float* act, int lda,
                                            int row0, int shift, int k0, int KS, const void* ring,
                                            int nq, bool first) {
  const int lane = threadIdx.x & 31;
  const int wq = (threadIdx.x >> 5) & 3;
  const int wg = warpgroup();
  const int g = lane >> 2, tq = lane & 3;
  const float* B = static_cast<const float*>(ring);
  const int ldb = KS + 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (wg + NWG * mt >= nq) continue;
    if (first) {
#pragma unroll
      for (int e = 0; e < NW / 2; ++e) acc[mt][e] = 0.0f;
    }
    const float* a0 = act + (row0 + 64 * (wg + NWG * mt) + 16 * wq + g - shift) * lda + k0;
    const float* a1 = a0 + 8 * lda;
    for (int kk = 0; kk < KS; ++kk) {
      const float x0 = a0[kk], x1 = a1[kk];
#pragma unroll
      for (int jn = 0; jn < NW / 8; ++jn) {
        const float b0 = B[(8 * jn + 2 * tq) * ldb + kk];
        const float b1 = B[(8 * jn + 2 * tq + 1) * ldb + kk];
        acc[mt][4 * jn] = fmaf(x0, b0, acc[mt][4 * jn]);
        acc[mt][4 * jn + 1] = fmaf(x0, b1, acc[mt][4 * jn + 1]);
        acc[mt][4 * jn + 2] = fmaf(x1, b0, acc[mt][4 * jn + 2]);
        acc[mt][4 * jn + 3] = fmaf(x1, b1, acc[mt][4 * jn + 3]);
      }
    }
  }
}

// KK: k16 steps a ring stage (bf16: KS / 16; fp32: unused)
template <typename T, int NW, int KK>
__global__ void __launch_bounds__(CTA_THREADS, 1) mrf_units_kernel(Args a) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int MT = tiles_a_warpgroup<T>(NW, 16 * KK);
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wq = (tid >> 5) & 3;
  const int wg = warpgroup();
  const bool producer = wg == NWG;  // the ring's warp: no tiles, no share of the loads

  // this CTA's work: branch j, batch row b, time tile t0 .. t0 + TM, output channels c0 .. c0 + NW
  const int p = blockIdx.x % a.NP;
  const int item = blockIdx.x / a.NP;
  int bslot = 0;
  while (bslot + 1 < a.nb && item >= a.item0[bslot + 1]) ++bslot;
  const int j = a.slot_branch[bslot];
  const int TM = a.tm[j];
  const int tiles = (a.T + TM - 1) / TM;
  const int local = item - a.item0[bslot];
  const int b = local / tiles;
  const int t0 = (local - b * tiles) * TM;
  const int k = a.k[j];
  const int rows = rows_of(k, a.dil, a.q0, a.q1, TM, nullptr);
  const int tbase = t0 + TM - rows;  // time of buffer row 0
  const int lda = a.Kp + (BF ? 8 : 4);
  const int NS = a.Kp / a.KS;
  const int kdim = BF ? a.KS : a.KS + 4;
  const int c0 = p * NW;
  const bool cluster = a.NP > 1;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* ring = smem + a.ring_off;
  T* act = reinterpret_cast<T*>(smem + a.act_off);
  const State cur{reinterpret_cast<float*>(smem + a.cur_off), a.chain ? 0 : rows - TM,
                  a.chain ? 0 : c0, (a.chain ? a.Kp : NW) + 4};

  // Ring stage i holds conv q0 + i / (k NS)'s tap m, K slice s, with i % (k NS) = m NS + s,
  // in slot i % S. The producer warp's lane 0 issues the stages in order, keeping its
  // place in counters; the compute warps only wait for a stage and release it.
  const int per_conv = k * NS;
  const int total = (a.q1 - a.q0) * per_conv;
  const long long tile_elems = (long long)a.Kp * kdim;
  const T* const conv_taps = static_cast<const T*>(a.w) +
                       (long long)(a.q0 * a.ksum + a.kpre[j]) * NS * tile_elems + (long long)c0 * kdim;
  const long long conv_step = (long long)a.ksum * NS * tile_elems;  // the next conv's taps
  int next = 0;  // the producer: the next stage to issue
  // issues every stage before `upto`, waiting for their slots, then those after it whose
  // slots every compute warp has already left (the slot's previous stage is next - S)
  auto feed = [&](int upto) {
    int slot = next % a.S, round = next / a.S, ms = next % per_conv;
    const T* src = conv_taps + (long long)(next / per_conv) * conv_step + ms * tile_elems;
    for (; next < total; ++next) {
      if (next >= a.S) {
        const unsigned parity = (round - 1) & 1;
        if (next < upto) mbar_wait(empty + slot, parity);
        else if (!m2s::mbar_test(empty + slot, parity)) return;
      }
      mbar_expect(full + slot, a.stage_bytes);
      bulk_copy(ring + slot * a.stage_bytes, src, a.stage_bytes, full + slot);
      src += tile_elems;
      if (++ms == per_conv) {
        ms = 0;
        src += conv_step - per_conv * tile_elems;
      }
      if (++slot == a.S) {
        slot = 0;
        ++round;
      }
    }
  };
  const bool feeder = tid == THREADS;  // the producer's lane 0 issues the copies
  if (feeder) {
    for (int st = 0; st < a.S; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, THREADS / 32);
    }
    mbar_init_fence();
    feed(0);
  }

  // the input tile; in unit mode also the state at the tile's own rows and channels,
  // which the residual adds
  if (producer) {
  } else if (a.chain) {
    load_tile(a.in, a, j, b, tbase, rows, 0, a.Kp, [&](int r, int c, float v) {
      *cur.at(r, c) = v;
      act[r * lda + c] = m2s::Operand<T>::round(leaky(v));
    });
  } else if (!a.in_act) {  // unit 0: x is both
    load_tile(a.in, a, j, b, tbase, rows, c0, NW, [&](int r, int c, float v) {
      act[r * lda + c] = m2s::Operand<T>::round(leaky(v));
      if (r >= rows - TM) *cur.at(r, c) = v;
    });
  } else {
    load_tile(a.in, a, j, b, tbase, rows, c0, NW, [&](int r, int c, float v) {
      act[r * lda + c] = m2s::Operand<T>::round(v);  // exact: v came from the operand type
    });
    load_tile(a.res, a, j, b, t0, TM, c0, NW,
              [&](int r, int c, float v) { *cur.at(r + rows - TM, c) = v; });
  }
  __syncthreads();
  if (cluster) {
    if (!producer) broadcast_slab<T>(act, lda, 0, rows, c0, NW, a.NP);
    cg::this_cluster().sync();
  }

  int h = 0;
  for (int q = a.q0; q < a.q1; ++q) h += reach_of(q, k, a.dil);
  int slot = 0;        // the compute warps: the next stage's slot
  unsigned round = 0;  // and its round (stage / S)
  for (int q = a.q0; q < a.q1; ++q) {
    h -= reach_of(q, k, a.dil);
    const int nq = (TM + h + 63) / 64;
    const int row0 = rows - 64 * nq;
    const int d = (q & 1) ? 1 : a.dil[q >> 1];
    float acc[MT][NW / 2];
    if (producer) {
      if (feeder) feed((q - a.q0 + 1) * per_conv);  // this conv's stages, and what fits of the next
      __syncwarp();
    } else {
      for (int m = 0; m < k; ++m) {
        for (int ks = 0; ks < NS; ++ks) {
          mbar_wait(full + slot, round & 1);
          const void* stage = ring + slot * a.stage_bytes;
          if constexpr (BF)
            product<NW, MT, KK>(acc, act, lda, row0, m * d, ks * a.KS, stage, nq, m == 0 && ks == 0);
          else
            product_fma<NW, MT>(acc, act, lda, row0, m * d, ks * a.KS, a.KS, stage, nq,
                                m == 0 && ks == 0);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + slot);
          if (++slot == a.S) {
            slot = 0;
            ++round;
          }
        }
      }
    }

    // epilogue: conv1 -> leaky(y) into the operand tile; conv2 -> the residual into
    // the state, then the next conv's operand (chain) or the launch's output
    const bool conv1 = (q & 1) == 0;
    const bool last = q == a.q1 - 1;
    const float* bias = a.bias + ((long long)q * a.nb + j) * a.C;
    float bv[NW / 8][2];
#pragma unroll
    for (int jn = 0; jn < NW / 8; ++jn) {
      const int col = c0 + 8 * jn + 2 * (lane & 3);
      bv[jn][0] = col < a.C ? bias[col] : 0.0f;
      bv[jn][1] = col + 1 < a.C ? bias[col + 1] : 0.0f;
    }
    if (conv1 || a.chain) {  // every warp is done reading the tile (in every CTA of the cluster)
      if (cluster) cg::this_cluster().sync();
      else __syncthreads();
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int tile = wg + NWG * mt;
      if (producer || tile >= nq) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 64 * tile + 16 * wq + (lane >> 2) + 8 * r;
        const bool before0 = tbase + row < 0;  // rows before t = 0 stay zero at conv inputs
#pragma unroll
        for (int jn = 0; jn < NW / 8; ++jn) {
          const int col = c0 + 8 * jn + 2 * (lane & 3);
          const float v0 = acc[mt][4 * jn + 2 * r] + bv[jn][0];
          const float v1 = acc[mt][4 * jn + 2 * r + 1] + bv[jn][1];
          if (conv1) {
            store_pair(act + row * lda + col, before0 ? 0.0f : leaky(v0), before0 ? 0.0f : leaky(v1));
            continue;
          }
          float2* cp = reinterpret_cast<float2*>(cur.at(row, col));
          float2 cv = *cp;
          cv.x = cv.x + v0;
          cv.y = cv.y + v1;
          *cp = cv;
          if (!last)
            store_pair(act + row * lda + col, before0 ? 0.0f : leaky(cv.x), before0 ? 0.0f : leaky(cv.y));
        }
      }
    }
    __syncthreads();
    if (last) {
      if (!producer)
        store_tile<T>(a, cur, j, b, t0, TM, rows - TM, a.chain ? 0 : c0, a.chain ? a.Kp : NW);
    } else if (cluster) {  // the operand tile is complete before the next conv reads it
      if (!producer) broadcast_slab<T>(act, lda, row0, rows, c0, NW, a.NP);
      cg::this_cluster().sync();
    }
  }
}

// out(b, c, t) = (s_0 + s_1 + ...) * (1 / nb) in out's type; s is (nb, B, C, T) fp32.
// Four consecutive times a thread where the layouts allow it.
template <typename X>
__global__ void __launch_bounds__(256) mrf_mean_kernel(const float* __restrict__ s, X* __restrict__ out,
                                                      long long ob, long long oc, long long ot, int nb,
                                                      int B, int C, int T) {
  const long long n = (long long)B * C * T;
  const float inv = 1.0f / (float)nb;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const bool vec = T % 4 == 0 && ot == 1 && oc % 4 == 0 && ob % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * sizeof(X)) == 0;
  if (vec) {
    for (long long i4 = blockIdx.x * (long long)blockDim.x + threadIdx.x; i4 < n / 4; i4 += stride) {
      const long long i = 4 * i4;
      float4 v = reinterpret_cast<const float4*>(s)[i4];
      for (int jj = 1; jj < nb; ++jj) {
        const float4 w = reinterpret_cast<const float4*>(s + jj * n)[i4];
        v.x = v.x + w.x;
        v.y = v.y + w.y;
        v.z = v.z + w.z;
        v.w = v.w + w.w;
      }
      const int t = (int)(i % T);
      const int c = (int)((i / T) % C);
      const int bb = (int)(i / ((long long)T * C));
      X* o = out + bb * ob + c * oc + t;
      if constexpr (sizeof(X) == 2) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(v.x * inv, v.y * inv);
        __nv_bfloat162 hi = __floats2bfloat162_rn(v.z * inv, v.w * inv);
        uint2 pk;
        pk.x = *reinterpret_cast<unsigned*>(&lo);
        pk.y = *reinterpret_cast<unsigned*>(&hi);
        *reinterpret_cast<uint2*>(o) = pk;
      } else {
        *reinterpret_cast<float4*>(o) = make_float4(v.x * inv, v.y * inv, v.z * inv, v.w * inv);
      }
    }
    return;
  }
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += stride) {
    const int t = (int)(i % T);
    const int c = (int)((i / T) % C);
    const int bb = (int)(i / ((long long)T * C));
    float v = s[i];
    for (int jj = 1; jj < nb; ++jj) v = v + s[jj * n + i];
    if constexpr (sizeof(X) == 2) out[bb * ob + c * oc + t * ot] = __float2bfloat16_rn(v * inv);
    else out[bb * ob + c * oc + t * ot] = v * inv;
  }
}

template <typename T, int NW, int KK>
cudaError_t launch_units(const Args& a, int grid, size_t smem, cudaStream_t st) {
  void (*kernel)(Args) = mrf_units_kernel<T, NW, KK>;
  cudaError_t err = m2s::allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(CTA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.NP;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// bf16: (NW, KS) pairs of the plans (chain: KS = NW = Kp; unit: KS = 64); fp32 by NW
cudaError_t launch_any(bool bf, const Args& a, int grid, size_t smem, cudaStream_t st) {
  if (bf) {
    if (a.NW == 128 && a.KS == 64) return launch_units<bf16, 128, 4>(a, grid, smem, st);
    if (a.NW == 64 && a.KS == 64) return launch_units<bf16, 64, 4>(a, grid, smem, st);
    if (a.NW == 32 && a.KS == 64) return launch_units<bf16, 32, 4>(a, grid, smem, st);
    if (a.NW == 32 && a.KS == 32) return launch_units<bf16, 32, 2>(a, grid, smem, st);
    if (a.NW == 16 && a.KS == 16) return launch_units<bf16, 16, 1>(a, grid, smem, st);
    return cudaErrorInvalidValue;
  }
  switch (a.NW) {
    case 64: return launch_units<float, 64, 0>(a, grid, smem, st);
    case 32: return launch_units<float, 32, 0>(a, grid, smem, st);
    case 16: return launch_units<float, 16, 0>(a, grid, smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Runs one MRF stage on `stream`; returns the first cudaError_t seen (0 = ok).
//   x:   element (b, j, c, t) at x[b*x_sb + j*x_sj + c*x_sc + t*x_st], bf16 if x_bf16
//        else fp32 (x_sj = 0: every branch starts from the same x);
//   out: x's type, element (b, c, t) at out[b*o_sb + c*o_sc + t*o_st];
//   s0, s1: fp32 scratch (nb, B, C, T) (s1 unit mode with nu > 1, else null);
//   a0, a1: scratch in the operand type, the same shape (a0 unit mode with nu > 1,
//        a1 with nu > 2, else null);
//   w:   taps in the operand type (op_bf16: bf16, else fp32), as
//        ops/mrf.py::MRFStageWeights.kernel_layout lays them out for Kp =
//        padded_channels(C) and KS = k_slice(Kp);
//   bias: fp32 (2 nu, nb, C);
//   the plan (ops/mrf.py::tile_plan): nw output channels a CTA (Kp / nw CTAs a
//        cluster; chain mode, Kp <= 64, takes nw = Kp), tm[j] the time tile of
//        branch j, order the branches heaviest first, stages the ring's depth.
extern "C" int mrf_stage(const void* x, long long x_sb, long long x_sj, long long x_sc,
                         long long x_st, int x_bf16, void* out, long long o_sb, long long o_sc,
                         long long o_st, float* s0, float* s1, void* a0, void* a1, const void* w,
                         const float* bias, const int* kernels, int nb, const int* dils, int nu,
                         int B, int C, int T, int op_bf16, int nw, const int* tm, const int* order,
                         int stages, void* stream) {
  if (nb < 1 || nb > MAX_NB || nu < 1 || nu > MAX_UNITS || B < 1 || C < 1 || T < 1 ||
      stages < 2 || stages > MAX_STAGES || (nw != 16 && nw != 32 && nw != 64 && nw != 128))
    return (int)cudaErrorInvalidValue;
  const bool bf = op_bf16 != 0;
  const int Kp = padded_channels(C);
  const bool chain = Kp <= 64;
  const int NP = Kp / nw;
  if (Kp % nw != 0 || NP > MAX_NP || (chain && NP != 1)) return (int)cudaErrorInvalidValue;
  if (!chain && nu > 1 && (s1 == nullptr || a0 == nullptr || (nu > 2 && a1 == nullptr)))
    return (int)cudaErrorInvalidValue;

  Args a{};
  a.nb = nb;
  a.B = B;
  a.C = C;
  a.T = T;
  a.Kp = Kp;
  a.KS = k_slice(Kp, bf);
  a.NW = nw;
  a.NP = NP;
  a.S = stages;
  a.chain = chain;
  a.w = w;
  a.bias = bias;
  for (int u = 0; u < nu; ++u) a.dil[u] = dils[u];
  int rows_max = 0, tm_max = 0;
  for (int jj = 0; jj < nb; ++jj) {
    if (kernels[jj] < 1 || tm[jj] < 64 || tm[jj] % 64 != 0) return (int)cudaErrorInvalidValue;
    a.k[jj] = kernels[jj];
    a.kpre[jj] = a.ksum;
    a.ksum += kernels[jj];
    a.tm[jj] = tm[jj];
    tm_max = tm[jj] > tm_max ? tm[jj] : tm_max;
    for (int u = 0; u < (chain ? 1 : nu); ++u) {
      int n_max;
      const int rows = chain ? rows_of(kernels[jj], dils, 0, 2 * nu, tm[jj], &n_max)
                             : rows_of(kernels[jj], dils, 2 * u, 2 * u + 2, tm[jj], &n_max);
      const int cap = NWG * (bf ? tiles_a_warpgroup<bf16>(nw, a.KS) : tiles_a_warpgroup<float>(nw, a.KS));
      if (n_max > cap) return (int)cudaErrorInvalidValue;
      rows_max = rows > rows_max ? rows : rows_max;
    }
  }
  int items = 0;
  for (int i = 0; i < nb; ++i) {
    const int jj = order[i];
    if (jj < 0 || jj >= nb) return (int)cudaErrorInvalidValue;
    a.slot_branch[i] = jj;
    a.item0[i] = items;
    items += B * ((T + tm[jj] - 1) / tm[jj]);
  }
  a.item0[nb] = items;
  const Smem L(rows_max, tm_max, Kp, nw, bf, chain, stages);
  if (L.total > SMEM_LIMIT || L.stage % 128 != 0) return (int)cudaErrorInvalidValue;
  a.ring_off = (unsigned)L.ring;
  a.act_off = (unsigned)L.act;
  a.cur_off = (unsigned)L.cur;
  a.stage_bytes = (unsigned)L.stage;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tensor xin{x, x_sb, x_sj, x_sc, x_st, x_bf16};
  const long long sb = (long long)C * T, sj = (long long)B * C * T;  // scratch strides
  float* final_state = s0;
  for (int u = 0; u < (chain ? 1 : nu); ++u) {
    Args l = a;
    float* dst = u % 2 == 0 ? s0 : s1;
    if (chain) {
      l.q0 = 0;
      l.q1 = 2 * nu;
      l.in = xin;
    } else {
      l.q0 = 2 * u;
      l.q1 = 2 * u + 2;
      const bool first = u == 0;
      l.in = first ? xin : Tensor{u % 2 == 1 ? a0 : a1, sb, sj, T, 1, op_bf16};
      l.in_act = first ? 0 : 1;
      l.res = first ? xin : Tensor{u % 2 == 1 ? s0 : s1, sb, sj, T, 1, 0};
      l.out_act = u + 1 < nu ? (u % 2 == 0 ? a0 : a1) : nullptr;
    }
    l.out = dst;
    final_state = dst;
    const cudaError_t err = launch_any(bf, l, items * NP, L.total, st);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n = (long long)B * C * T;
  const long long work = T % 4 == 0 ? n / 4 : n;
  const int blocks = (int)((work + 255) / 256 < 65535 ? (work + 255) / 256 : 65535);
  if (x_bf16)
    mrf_mean_kernel<bf16><<<blocks, 256, 0, st>>>(final_state, static_cast<bf16*>(out), o_sb, o_sc,
                                                  o_st, nb, B, C, T);
  else
    mrf_mean_kernel<float><<<blocks, 256, 0, st>>>(final_state, static_cast<float*>(out), o_sb, o_sc,
                                                   o_st, nb, B, C, T);
  return (int)cudaGetLastError();
}
