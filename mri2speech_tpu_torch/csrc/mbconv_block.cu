// One stride-1 SE-MBConv block with BatchNorm folded, for Hopper (sm_90a):
// fp32 or bf16 in and out (the output takes x's type), bf16 or fp32 operands
// for the four products.
//
// Replaces the TPU kernel mri2speech_tpu/ops/pallas_mbconv.py::
// mbconv_block_pallas (:128, pallas_call :175):
//   a = SiLU(x @ w1 + b1)                      pw 1x1, C -> E
//   d = SiLU(depthwise3x3_SAME(a; wd) + bd)    per-frame zero padding of a, fp32
//   s = mean over the frame's pixels of d      (per frame, per channel)
//   g = sigmoid(SiLU(s @ wr + br) @ we + be)   SE, E -> R -> E
//   out = x + (d * g) @ w3 + b3                pwl 1x1, E -> C, residual
// Operands are rounded to the operand type where the TPU kernel rounds: x
// before pw, s and the SE hidden before the SE products, d*g before pwl. The
// depthwise taps, every elementwise step and the residual stay fp32 (the
// residual adds the unrounded x).
//
// What bounds it: at the EfficientNetV2-B2 shapes (16x16 with C 104 / E 416
// and C 120 / E 720, 8x8 with C 208 / E 1248) the two 1x1 products are
// 4*N*HW*C*E FLOPs for the tensor cores, the 2*N*HW*E SiLUs (precise expf
// and an IEEE reciprocal: two special-function instructions each, EX2 and
// RCP, at 16 a clock per SM) are the longest pipe, and x in and out is
// small beside both. The TPU kernel kept a frame's whole E-wide map in VMEM;
// here no block can hold it (737 KB at 16x16 with E 720), and this design
// trades recompute for bytes: no E-wide tensor ever leaves the SM.
//
// Design: the block is split at the SE pool and the expansion is recomputed.
//   * A CTA owns a rectangle of one frame's pixels and computes the pw product
//     over it plus a 1-pixel halo clipped to the frame. The depthwise reads `a`
//     from a shared buffer padded by one pixel on every side, whose positions
//     outside the frame stay 0 (the zero padding of a, not SiLU(b1)). Halo
//     pixels are computed, never counted. The wrapper chooses each launch's
//     rectangles to fill the card (ops/mbconv.py::tile_plan): launch 1, which
//     holds no projection, takes whole frames where they fit (no halo).
//   * Launch 1 (mbconv_pool_kernel), grid (frame x tile, E split): for each
//     E chunk, pw into fp32 accumulators, + b1, SiLU, depthwise + bd, SiLU,
//     and the chunk's per-channel sums over the owned pixels in a fixed
//     order, written as partials (N, tiles, E) fp32.
//   * Launch 2 (mbconv_gate_kernel), grid (frame): reduces the frame's
//     partials in tile order to the mean and computes its SE gate once,
//     (N, Ep) fp32. A launch of its own: the gate's E x R weights are read
//     at load latency, which many small CTAs an SM hide.
//   * Launch 3 (mbconv_project_kernel), grid (frame x tile): the same E-chunk
//     loop (same chunks and K order, so d comes out bit for bit as in launch
//     1); each chunk's bf16(d*g) goes into a shared operand tile and is
//     multiplied by the chunk of w3 into a (pixels x C) fp32 accumulator held
//     in registers across the chunks. Epilogue: + b3 + x, stored in x's type
//     through strides (NCHW or NHWC).
//   * Weights stream, one E chunk (64 channels) at a time, through a two-stage
//     ring filled by the Tensor Memory Accelerator: the wrapper lays each
//     chunk of w1 and w3 out in global memory exactly as the shared tile, so
//     a chunk is one bulk copy per tensor, issued by one thread and counted
//     by the stage's mbarrier while the previous chunk computes. (cp.async
//     from every warp stalled the warps on the L2 whatever its order.)
//     The x tile is loaded once per launch.
//   * Products: bf16 operands run wgmma (Hopper's warpgroup products) from
//     shared memory in the core-matrix layout without swizzle: pw by one
//     warpgroup per 64-pixel tile over the chunk's 64 channels, the
//     projection by (64-pixel tile, N2-column part) units of the four
//     warpgroups. The first product of each chain starts from nothing
//     (scale-d 0), so no other instruction sets the accumulators and the
//     compiler does not serialize the chain. fp32 operands run FMAs on the
//     CUDA cores (mma.sync's m16n8 accumulator layout), on chunks of 32 channels.
//   * The elementwise phases are where the time goes (one CTA of 16 warps an
//     SM); each thread works on two adjacent channels (8-byte shared loads
//     and stores) with several independent chains in flight: the SiLU of `a`
//     is a pass of its own spread evenly over the threads, four pixels at a
//     time; the depthwise slides a 3x3 register window of channel pairs down
//     a column two rows at a time, with no div/mod in the loop; the SiLU's
//     reciprocal has no slow-path branch (tile_mma.cuh::rcp_ge1). Channels
//     past E are zero in every operand, so they need no branch. Sums over
//     pixels and over tiles run in a fixed order, with no atomics: a run
//     repeats bit for bit.
// Resources (nvcc -Xptxas -v, sm_90a): 16 warps; launch 3 uses 111-117
// registers a thread, launch 1 82-100, launch 2 32, no spills; shared memory
// per CTA at the B2 shapes 120-204 KB (launch 1) and 117-191 KB (launch 3),
// so one CTA an SM. Times in PERF.md.
//
// Built without --use_fast_math: SiLU and sigmoid use the precise expf and
// the IEEE reciprocal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "tile_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using m2s::allow_smem;
using m2s::bulk_copy;
using m2s::fence_to_wgmma;
using m2s::mbar_expect;
using m2s::mbar_init;
using m2s::mbar_init_fence;
using m2s::mbar_wait;
using m2s::wg_commit_wait;
using m2s::wg_desc;
using m2s::wg_fence;
using m2s::Wgmma;

constexpr int THREADS = 512;  // 16 warps
constexpr int M_CAP = 256;    // pixels (tile + halo) a CTA's pw covers: 4 wgmma tiles of 64
constexpr int MAX_C = 256;
constexpr int SMEM_LIMIT = 232448;

// E channels per chunk
template <typename T>
struct Chunk;
template <>
struct Chunk<bf16> {
  static constexpr int EC = 64;
};
template <>
struct Chunk<float> {
  static constexpr int EC = 32;
};

// Shared operand tiles (rows x K, K contiguous): bf16 in wgmma's core-matrix layout,
// rows padded to 64 (one wgmma M); fp32 row-major with rows K + 4 apart (16 bytes:
// the FMA loops' rows fall on distinct banks), rows padded to 16.
template <typename T>
struct Layout;
template <>
struct Layout<bf16> {
  static constexpr int ROWS = 64;
  __host__ __device__ static int size(int rows, int K) { return rows * K; }
  __device__ static int at(int r, int k, int K) {
    return (r >> 3) * (K * 8) + (k >> 3) * 64 + (r & 7) * 8 + (k & 7);
  }
};
template <>
struct Layout<float> {
  static constexpr int ROWS = 16;
  __host__ __device__ static int size(int rows, int K) { return rows * (K + 4); }
  __device__ static int at(int r, int k, int K) { return r * (K + 4) + k; }
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
// two adjacent operand elements, rounded to the operand type
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// d = A[rows 64*mt ..] @ B[rows n0 ..]^T over depth K (+ d if accumulate), both
// tiles in the core-matrix layout
template <int N>
__device__ __forceinline__ void wg_product(float (&d)[N / 2], const bf16* A, int mt,
                                           const bf16* B, int n0, int K, bool accumulate) {
  const uint64_t da = wg_desc(A + mt * 64 * K, K);
  const uint64_t db = wg_desc(B + n0 * K, K);
  wg_fence();
  Wgmma<N>::mma(d, da, db, accumulate);
  for (int k = 1; k < K / 16; ++k) Wgmma<N>::mma(d, da + 16 * k, db + 16 * k, 1);  // 2 core matrices
  wg_commit_wait();
}

// ---- fp32 products: FMAs on the CUDA cores ----
// acc[MI][NI][4] += A @ B^T over depth K, A [row][k] and B [col][k] in shared
// memory (leading dimensions lda, ldb), for the warp's first MR 16-row blocks
// (block i is mb = m0 + MS*i) and every pair j of 8-column fragments (pair pb =
// p0 + PS*j, columns pb*16 .. pb*16+15; the caller pads B so each exists), with
// mma.sync's m16n8 accumulator layout: acc[i][2j+h][q] is row mb*16 + g +
// 8*(q>>1), column pb*16 + h*8 + 2t + (q&1).
template <int MR, int MS, int PS, int MI, int NI>
__device__ __forceinline__ void mma_blocks(float (&acc)[MI][NI][4], const float* A, int lda,
                                           int m0, const float* B, int ldb, int p0, int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int k = 0; k < K; ++k) {
    float av[MR][2];
    float bv[NI][2];
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      av[i][0] = A[((m0 + MS * i) * 16 + g) * lda + k];
      av[i][1] = A[((m0 + MS * i) * 16 + g + 8) * lda + k];
    }
#pragma unroll
    for (int f = 0; f < NI; ++f) {
      const float* b = B + ((p0 + PS * (f >> 1)) * 16 + (f & 1) * 8 + 2 * t) * ldb + k;
      bv[f][0] = b[0];
      bv[f][1] = b[ldb];
    }
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int f = 0; f < NI; ++f) {
        acc[i][f][0] = fmaf(av[i][0], bv[f][0], acc[i][f][0]);
        acc[i][f][1] = fmaf(av[i][0], bv[f][1], acc[i][f][1]);
        acc[i][f][2] = fmaf(av[i][1], bv[f][0], acc[i][f][2]);
        acc[i][f][3] = fmaf(av[i][1], bv[f][1], acc[i][f][3]);
      }
  }
}

// The warp's blocks m0, m0 + MS, ... below nmb (a warp-uniform count), through
// mma_blocks with that count fixed at compile time.
template <int MS, int PS, int MI, int NI, typename T>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NI][4], const T* A, int lda, int m0,
                                         int nmb, const T* B, int ldb, int p0, int K) {
  static_assert(MI == 1 || MI == 2, "one or two 16-row blocks a warp");
  const int nb = m0 < nmb ? (nmb - 1 - m0) / MS + 1 : 0;
  if (nb >= MI) {
    mma_blocks<MI, MS, PS>(acc, A, lda, m0, B, ldb, p0, K);
  } else if constexpr (MI == 2) {
    if (nb == 1) mma_blocks<1, MS, PS>(acc, A, lda, m0, B, ldb, p0, K);
  }
}

struct Args {
  const void* x;  // element (n, c, p = h*W + w) at x[n*sn + c*sc + p*sp], x's type
  long long sn, sc, sp;
  void* out;      // x's type
  long long on, oc, op;
  const void* w1;  // operand type: chunk c's rows, Layout<T> of EC x Kp, at c * w1 tile
  const float* vec; // (Ep / EC, 11, EC): chunk c's taps 0-8 (dh*3 + dw), bd, b1; 0 past E
  const void* wr;  // (R, E) operand type
  const float* br; // (R)
  const void* we;  // (R, E) operand type (the SE expansion, transposed)
  const float* be; // (E)
  const void* w3;  // operand type: chunk c's columns, Layout<T> of Cw x EC (0 past C, E)
  const float* b3; // (C)
  float* part;     // (N, tiles, E): per-tile channel sums of d
  float* gate;     // (N, Ep): the SE gate of each frame
  int H, W, C, E, R;
  int Kp, Ep, Cw;  // C rounded up to 16; E to whole chunks; the projection's columns (64, 128, 256)
  int TH, TW, tiles_w, tiles;  // tile plan: owned rectangle, tiles per frame
  int mext, mown;  // largest tile's pw rows and owned pixels, each rounded up to 16
  int es_chunks;   // launch 1: E chunks per CTA
};

// One CTA's tile: owned rectangle (h0, w0, th, tw); pw rows = the owned
// rectangle plus its 1-pixel halo, clipped to the frame (er0, ec0, eh x ew),
// at (roff, coff) inside the padded (th + 2) x (tw + 2) depthwise buffer.
struct Tile {
  int n, h0, w0, th, tw, er0, ec0, eh, ew, roff, coff, pw;
};

__device__ __forceinline__ Tile tile_of(const Args& a) {
  Tile t;
  const int idx = blockIdx.x;
  t.n = idx / a.tiles;
  const int k = idx - t.n * a.tiles;
  const int ti = k / a.tiles_w;
  const int tj = k - ti * a.tiles_w;
  t.h0 = ti * a.TH;
  t.w0 = tj * a.TW;
  t.th = min(a.TH, a.H - t.h0);
  t.tw = min(a.TW, a.W - t.w0);
  t.er0 = max(t.h0 - 1, 0);
  t.ec0 = max(t.w0 - 1, 0);
  t.eh = min(t.h0 + t.th + 1, a.H) - t.er0;
  t.ew = min(t.w0 + t.tw + 1, a.W) - t.ec0;
  t.roff = t.er0 - (t.h0 - 1);
  t.coff = t.ec0 - (t.w0 - 1);
  t.pw = t.tw + 2;
  return t;
}

// Shared memory of launches 1 and 3, in order: the ring's 2 mbarriers, x tile [mext][Kp], w1 ring
// 2 x [EC][Kp + PAD], (launch 3: w3 ring 2 x [Cw][EC + PAD], d*g tile [mown][EC +
// PAD]), then fp32: the chunk's vectors, ring 2 x [VROWS][EC] (depthwise taps,
// bd, b1, launch 3 also the gate), the depthwise buffer [(TH + 2) * (TW + 2)][EC
// + 8], the pw pixels' buffer positions and frame pixels [2][mext] (int),
// (launch 1: sums [2 * THREADS]).
// The wrapper's tile plan mirrors this.
constexpr int VROWS = 12;  // rows of a chunk's vectors: taps 0-8, bd, b1, gate (launch 3)
constexpr int V_BD = 9;
constexpr int V_B1 = 10;
constexpr int V_GATE = 11;
template <typename T>
struct Smem {
  static constexpr int EC = Chunk<T>::EC;
  int w1_stage, w3_stage, lda;
  size_t bar, xs, w1s, w3s, dgs, vec, abuf, pos, tail, total;
  __host__ __device__ Smem(const Args& a, bool project) {
    w1_stage = Layout<T>::size(EC, a.Kp);
    w3_stage = Layout<T>::size(a.Cw, EC);
    lda = EC + 8;  // even, and 8 words mod 32: the pw's float2 stores hit distinct banks
    bar = 0;  // one mbarrier per ring stage
    xs = 16;
    w1s = xs + sizeof(T) * (size_t)Layout<T>::size(a.mext, a.Kp);
    w3s = w1s + sizeof(T) * 2 * (size_t)w1_stage;
    dgs = w3s + (project ? sizeof(T) * 2 * (size_t)w3_stage : 0);
    vec = dgs + (project ? sizeof(T) * (size_t)Layout<T>::size(a.mown, EC) : 0);
    abuf = vec + sizeof(float) * 2 * VROWS * EC;  // launch 1 leaves the gate row unused
    pos = abuf + sizeof(float) * (size_t)(a.TH + 2) * (a.TW + 2) * lda;
    tail = pos + sizeof(int) * 2 * (size_t)a.mext;
    total = tail + (project ? 0 : sizeof(float) * 2 * THREADS);
  }
};

// x tile (mext x Kp, Layout<T>) in the operand type, zero past the tile's pw pixels and
// past C. Lanes walk the axis contiguous in memory (pixels if sp == 1, else
// channels), warps the other; each thread keeps U loads in flight, stepping its
// (outer, inner) item counters without a division, and gpix[m] gives pixel m's
// index in the frame.
template <typename T, typename X>
__device__ void load_x_tile(const Args& a, const Tile& t, T* xs, const int* gpix) {
  constexpr int U = 16;
  constexpr int WARPS = THREADS / 32;
  const X* x = static_cast<const X*>(a.x) + t.n * a.sn;
  const int m_ext = t.eh * t.ew;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool pixel_major = a.sp == 1;
  const int n_in = pixel_major ? a.mext : a.Kp;
  const int n_out = pixel_major ? a.Kp : a.mext;
  const int ni = lane < n_in ? (n_in - 1 - lane) / 32 + 1 : 0;
  const int no = warp < n_out ? (n_out - 1 - warp) / WARPS + 1 : 0;
  int oi = 0, ii = 0;
  for (int done = 0; done < ni * no; done += U) {
    float v[U];
    int dst[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int o = warp + WARPS * oi;
      const int i = lane + 32 * ii;
      const int m = pixel_major ? i : o;
      const int k = pixel_major ? o : i;
      const bool item = done + u < ni * no;
      const bool ok = item && m < m_ext && k < a.C;
      const long long off = (long long)k * a.sc + (long long)gpix[ok ? m : 0] * a.sp;
      v[u] = ok ? to_f(x[off]) : 0.0f;
      dst[u] = item ? Layout<T>::at(m, k, a.Kp) : -1;
      if (++ii == ni) {
        ii = 0;
        ++oi;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (dst[u] >= 0) xs[dst[u]] = m2s::Operand<T>::round(v[u]);
  }
}

// The last warp's first thread (the pw keeps the first warps busier) issues the
// copies.
constexpr int ISSUER = THREADS - 32;

// ISSUER starts chunk c's copies into ring stage `stage`: w1's rows (and in
// launch 3 w3's columns) as the wrapper laid them out, the taps and biases, and in
// launch 3 frame n's gate. One bulk copy each; the stage's mbarrier counts the bytes.
template <typename T>
__device__ __forceinline__ void issue_chunk(const Args& a, int c, int stage, const Smem<T>& L,
                                            unsigned char* smem, const float* gate) {
  constexpr int EC = Chunk<T>::EC;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar) + stage;
  const unsigned w1_bytes = sizeof(T) * L.w1_stage;
  const unsigned w3_bytes = gate ? sizeof(T) * L.w3_stage : 0;
  const unsigned vec_bytes = sizeof(float) * (V_GATE + (gate ? 1 : 0)) * EC;
  mbar_expect(bar, w1_bytes + w3_bytes + vec_bytes);
  bulk_copy(smem + L.w1s + stage * w1_bytes,
            static_cast<const unsigned char*>(a.w1) + (size_t)c * w1_bytes, w1_bytes, bar);
  float* vec = reinterpret_cast<float*>(smem + L.vec) + stage * VROWS * EC;
  bulk_copy(vec, a.vec + (size_t)c * V_GATE * EC, sizeof(float) * V_GATE * EC, bar);
  if (gate) {
    bulk_copy(smem + L.w3s + stage * w3_bytes,
              static_cast<const unsigned char*>(a.w3) + (size_t)c * w3_bytes, w3_bytes, bar);
    bulk_copy(vec + V_GATE * EC, gate + (size_t)c * EC, sizeof(float) * EC, bar);
  }
}

// pw (fp32 operands) of chunk c over the tile's pw rows, stored raw into the
// padded depthwise buffer (positions outside the frame are never written: they
// stay 0). The warp takes 16-row blocks b0, b0 + BS and 16-column pairs p0,
// p0 + PS, ... (NI / 2 of them).
template <int MB, int NI, int BS, int PS>
__device__ __forceinline__ void expand_tile(const float* xs, const float* w1s, int Kp, float* abuf,
                                            int lda, const int* pos_tab, int m_ext, int nmb, int b0,
                                            int p0) {
  float acc[MB][NI][4];
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int f = 0; f < NI; ++f)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][f][q] = 0.0f;
  warp_mma<BS, PS>(acc, xs, Kp + 4, b0, nmb, w1s, Kp + 4, p0, Kp);
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = (b0 + BS * i) * 16 + g + 8 * r;
      if (m >= m_ext) continue;
      float* row = abuf + pos_tab[m] * lda;
#pragma unroll
      for (int f = 0; f < NI; ++f)
        *reinterpret_cast<float2*>(row + (p0 + PS * (f >> 1)) * 16 + (f & 1) * 8 + 2 * t) =
            make_float2(acc[i][f][2 * r], acc[i][f][2 * r + 1]);
    }
}

// pw (bf16 operands) by one warpgroup: pixels 64*mt .. 64*mt + 63, channels n0 ..
// n0 + N - 1 of the chunk, stored raw into the padded depthwise buffer
template <int N>
__device__ __forceinline__ void expand_wg(const bf16* xs, const bf16* w1s, int Kp, float* abuf,
                                          int lda, const int* pos_tab, int m_ext, int mt, int n0) {
  float d[N / 2];
  wg_product<N>(d, xs, mt, w1s, n0, Kp, false);
  const int row0 = mt * 64 + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
  const int col0 = n0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = row0 + 8 * r;
    if (m >= m_ext) continue;
    float* row = abuf + pos_tab[m] * lda + col0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
  }
}

// The pw of chunk c over the tile's pw pixels. bf16: warpgroup wg takes the
// 64-pixel tile wg, all 64 channels (wgmma reads each A tile once; splitting the
// channels over more warpgroups was slower: each rereads A). fp32: warp w takes
// 16-row blocks w/2, w/2 + 8 and the pair w%2 (blocks spread over the SM's four
// schedulers: warp w runs on scheduler w % 4).
template <typename T>
__device__ __forceinline__ void expand_chunk(const Args& a, const T* xs, const T* w1s, float* abuf,
                                             int lda, const int* pos_tab, int m_ext) {
  constexpr int EC = Chunk<T>::EC;
  const int warp = threadIdx.x >> 5;
  if constexpr (EC == 64) {
    const int wg = warp >> 2;
    if (wg < (m_ext + 63) / 64) expand_wg<64>(xs, w1s, a.Kp, abuf, lda, pos_tab, m_ext, wg, 0);
  } else {
    expand_tile<2, EC / 16, 8, 2>(xs, w1s, a.Kp, abuf, lda, pos_tab, m_ext, (m_ext + 15) / 16,
                                  warp >> 1, warp & 1);
  }
}

// a = SiLU(pw + b1) in place over the tile's pw pixels of chunk c, spread evenly
// over the threads (channels el, el + 1; pixels mg, mg + NG, ...). Channels past E
// need no care: their w1 rows and b1 are 0, so a is SiLU(0) = 0.
template <int EC>
__device__ __forceinline__ void silu_chunk(const float* vec, float* abuf, int lda,
                                           const int* pos_tab, int m_ext) {
  constexpr int EP = EC / 2;  // channel pairs
  constexpr int NG = THREADS / EP;
  constexpr int U = 4;  // independent pairs in flight: all loads, then all math, then all stores
  const int el = 2 * (threadIdx.x % EP);
  const float2 b = *reinterpret_cast<const float2*>(vec + V_B1 * EC + el);
  for (int m0 = threadIdx.x / EP; m0 < m_ext; m0 += U * NG) {
    float2* p[U];
    float2 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int m = m0 + u * NG;
      p[u] = reinterpret_cast<float2*>(abuf + pos_tab[m < m_ext ? m : m0] * lda + el);
      v[u] = *p[u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = make_float2(m2s::siluf_(v[u].x + b.x), m2s::siluf_(v[u].y + b.y));
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (m0 + u * NG < m_ext) *p[u] = v[u];
  }
}

// each pw pixel m of the tile: its position in the padded depthwise buffer and
// its pixel index in the frame
__device__ __forceinline__ void fill_positions(const Args& a, const Tile& t, int* pos_tab,
                                               int* gpix) {
  for (int m = threadIdx.x; m < t.eh * t.ew; m += THREADS) {
    const int eh = m / t.ew;
    const int ew = m - eh * t.ew;
    pos_tab[m] = (eh + t.roff) * t.pw + ew + t.coff;
    gpix[m] = (t.er0 + eh) * a.W + t.ec0 + ew;
  }
}

// Depthwise 3x3 + bd + SiLU over the owned pixels of chunk c: thread = (channels
// el, el + 1; columns cg, cg + NG, ...), a 3x3 window of channel pairs slid down
// the rows RS at a time (2 x RS independent outputs in flight), then one at a
// time. Calls emit(r, col, d) with d the pair (el, el + 1), for each owned pixel
// in a fixed order. Channels past E give d = 0 (their taps, bd and a are 0).
template <int EC, typename Emit>
__device__ __forceinline__ void depthwise_chunk(const Tile& t, const float* vec, const float* abuf,
                                                int lda, Emit emit) {
  constexpr int EP = EC / 2;
  constexpr int NG = THREADS / EP;
  constexpr int RS = 2;
  const int el = 2 * (threadIdx.x % EP);
  const int cg = threadIdx.x / EP;
  float2 w[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) w[k] = *reinterpret_cast<const float2*>(vec + k * EC + el);
  const float2 bias = *reinterpret_cast<const float2*>(vec + V_BD * EC + el);
  const int rs = t.pw * lda;  // row stride of the padded buffer
  auto out = [&](const float2 (&v)[RS + 2][3], int i) {
    float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      s.x = fmaf(v[i + k / 3][k % 3].x, w[k].x, s.x);
      s.y = fmaf(v[i + k / 3][k % 3].y, w[k].y, s.y);
    }
    return make_float2(m2s::siluf_(s.x + bias.x), m2s::siluf_(s.y + bias.y));
  };
  for (int col = cg; col < t.tw; col += NG) {
    const int r_end = t.th;
    int r = 0;
    const float* p = abuf + col * lda + el;  // padded (row 0, column col): left of (-1, col)
    float2 v[RS + 2][3];  // padded rows r .. r + RS + 1 of columns col .. col + 2
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      v[0][j] = *reinterpret_cast<const float2*>(p + j * lda);
      v[1][j] = *reinterpret_cast<const float2*>(p + rs + j * lda);
    }
    p += 2 * rs;
    for (; r + RS <= r_end; r += RS, p += RS * rs) {
#pragma unroll
      for (int i = 0; i < RS; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) v[i + 2][j] = *reinterpret_cast<const float2*>(p + i * rs + j * lda);
      float2 d[RS];
#pragma unroll
      for (int i = 0; i < RS; ++i) d[i] = out(v, i);
#pragma unroll
      for (int i = 0; i < RS; ++i) emit(r + i, col, d[i]);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        v[0][j] = v[RS][j];
        v[1][j] = v[RS + 1][j];
      }
    }
    for (; r < r_end; ++r, p += rs) {
#pragma unroll
      for (int j = 0; j < 3; ++j) v[2][j] = *reinterpret_cast<const float2*>(p + j * lda);
      emit(r, col, out(v, 0));
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        v[0][j] = v[1][j];
        v[1][j] = v[2][j];
      }
    }
  }
}

template <typename T, typename X>
__global__ void __launch_bounds__(THREADS, 1) mbconv_pool_kernel(Args a) {
  constexpr int EC = Chunk<T>::EC;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> L(a, false);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* w1s = reinterpret_cast<T*>(smem + L.w1s);
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  float* abuf = reinterpret_cast<float*>(smem + L.abuf);
  int* pos_tab = reinterpret_cast<int*>(smem + L.pos);
  int* gpix = pos_tab + a.mext;
  float* red = reinterpret_cast<float*>(smem + L.tail);

  const Tile t = tile_of(a);
  const int nch = a.Ep / EC;
  const int c0 = blockIdx.y * a.es_chunks;
  const int c1 = min(nch, c0 + a.es_chunks);
  if (c0 >= c1) return;
  const int m_ext = t.eh * t.ew;

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  if (threadIdx.x == ISSUER) {
    mbar_init(bar);
    mbar_init(bar + 1);
    mbar_init_fence();
    issue_chunk<T>(a, c0, 0, L, smem, nullptr);
  }
  for (int i = threadIdx.x; i < (a.TH + 2) * (a.TW + 2) * L.lda; i += THREADS) abuf[i] = 0.0f;
  fill_positions(a, t, pos_tab, gpix);
  __syncthreads();
  load_x_tile<T, X>(a, t, xs, gpix);
  fence_to_wgmma();
  __syncthreads();
  float* part = a.part + (size_t)blockIdx.x * a.E;

  for (int c = c0; c < c1; ++c) {
    const int s = (c - c0) & 1;
    mbar_wait(bar + s, ((c - c0) >> 1) & 1);  // chunk c landed
    __syncthreads();  // the previous chunk's readers are done with stage 1 - s
    if (threadIdx.x == ISSUER && c + 1 < c1) issue_chunk<T>(a, c + 1, 1 - s, L, smem, nullptr);
    const float* vc = vec + s * VROWS * EC;
    expand_chunk<T>(a, xs, w1s + s * L.w1_stage, abuf, L.lda, pos_tab, m_ext);
    __syncthreads();
    silu_chunk<EC>(vc, abuf, L.lda, pos_tab, m_ext);
    __syncthreads();
    float2 sum = make_float2(0.0f, 0.0f);
    depthwise_chunk<EC>(t, vc, abuf, L.lda, [&](int, int, float2 d) {
      sum.x += d.x;
      sum.y += d.y;
    });
    // [column group][channel]: thread = column group * EC/2 + channel pair
    *reinterpret_cast<float2*>(red + 2 * threadIdx.x) = sum;
    __syncthreads();
    if (threadIdx.x < EC && c * EC + threadIdx.x < a.E) {
      float total = 0.0f;
#pragma unroll
      for (int g = 0; g < 2 * THREADS / EC; ++g) total += red[g * EC + threadIdx.x];
      part[c * EC + threadIdx.x] = total;
    }
  }
}

// Launch 2: frame n's SE gate, once: the mean from the partials in tile order,
// then sigmoid(SiLU(bf16(s) @ wr + br) @ we + be), into gate (N, Ep), 0 past E.
template <typename T>
__global__ void __launch_bounds__(THREADS) mbconv_gate_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);  // [E]
  float* hid = sm + a.E;                        // [R]
  const int n = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* part = a.part + (size_t)n * a.tiles * a.E;
  for (int e = threadIdx.x; e < a.E; e += THREADS) {
    float s = 0.0f;
    for (int k = 0; k < a.tiles; ++k) s += part[(size_t)k * a.E + e];
    sm[e] = m2s::round_to<T>(s / (float)(a.H * a.W));
  }
  __syncthreads();
  const T* wr = static_cast<const T*>(a.wr);
  for (int r = warp; r < a.R; r += THREADS / 32) {
    float acc = 0.0f;
#pragma unroll 8
    for (int e = lane; e < a.E; e += 32)
      acc += sm[e] * m2s::Operand<T>::to_float(wr[(size_t)r * a.E + e]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) hid[r] = m2s::round_to<T>(m2s::siluf_(acc + a.br[r]));
  }
  __syncthreads();
  const T* we = static_cast<const T*>(a.we);
  for (int e = threadIdx.x; e < a.Ep; e += THREADS) {
    float acc = 0.0f;
    if (e < a.E) {
#pragma unroll 8
      for (int r = 0; r < a.R; ++r) acc += hid[r] * m2s::Operand<T>::to_float(we[(size_t)r * a.E + e]);
    }
    a.gate[(size_t)n * a.Ep + e] = e < a.E ? m2s::sigmoidf_(acc + a.be[e]) : 0.0f;
  }
}

// The projection. bf16: the four warpgroups take (64-pixel tile, N2-column part)
// units, Cw / N2 parts a tile. fp32: warps WM2 along pixels x (16 / WM2) along
// output channels, MI2 16-pixel blocks and NI2 8-column fragments each. Either
// way a thread's share of the (pixels x C) accumulator is 32 fp32 at most
// (ops/mbconv.py::owned_cap).
template <typename T, typename X, int WM2, int MI2, int NI2, int N2>
__global__ void __launch_bounds__(THREADS, 1) mbconv_project_kernel(Args a) {
  constexpr int EC = Chunk<T>::EC;
  constexpr bool WG = EC == 64;  // bf16: wgmma
  constexpr int WN2 = THREADS / 32 / WM2;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> L(a, true);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* w1s = reinterpret_cast<T*>(smem + L.w1s);
  T* w3s = reinterpret_cast<T*>(smem + L.w3s);
  T* dgs = reinterpret_cast<T*>(smem + L.dgs);
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  float* abuf = reinterpret_cast<float*>(smem + L.abuf);
  int* pos_tab = reinterpret_cast<int*>(smem + L.pos);
  int* gpix = pos_tab + a.mext;

  const Tile t = tile_of(a);
  const int nch = a.Ep / EC;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* gate = a.gate + (size_t)t.n * a.Ep;

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  if (threadIdx.x == ISSUER) {
    mbar_init(bar);
    mbar_init(bar + 1);
    mbar_init_fence();
    issue_chunk<T>(a, 0, 0, L, smem, gate);
  }
  // the d*g tile's padding rows stay 0
  for (int i = threadIdx.x; i < Layout<T>::size(a.mown, EC); i += THREADS)
    dgs[i] = m2s::Operand<T>::round(0.0f);
  for (int i = threadIdx.x; i < (a.TH + 2) * (a.TW + 2) * L.lda; i += THREADS) abuf[i] = 0.0f;
  fill_positions(a, t, pos_tab, gpix);
  __syncthreads();
  load_x_tile<T, X>(a, t, xs, gpix);
  fence_to_wgmma();
  __syncthreads();
  const int m_ext = t.eh * t.ew;
  const int m_own = t.th * t.tw;
  // fp32: pixel-block-major, so the blocks of a small tile spread over the four schedulers
  const int wm = warp / WN2;
  const int wn = warp % WN2;
  // bf16: warpgroup wg's unit (64-pixel tile mt, columns n2 .. n2 + N2 - 1), if the tile has it
  const int np2 = a.Cw / (N2 > 0 ? N2 : 1);
  const int mt = (warp >> 2) / np2;
  const int n2 = ((warp >> 2) % np2) * N2;
  const bool unit = mt < (m_own + 63) / 64;
  float out_wg[WG ? N2 / 2 : 1];  // set by the first chunk's products
  float out[WG ? 1 : MI2][WG ? 1 : NI2][4];
#pragma unroll
  for (int i = 0; i < (WG ? 1 : MI2); ++i)
#pragma unroll
    for (int f = 0; f < (WG ? 1 : NI2); ++f)
#pragma unroll
      for (int q = 0; q < 4; ++q) out[i][f][q] = 0.0f;

  for (int c = 0; c < nch; ++c) {
    const int s = c & 1;
    mbar_wait(bar + s, (c >> 1) & 1);  // chunk c landed
    __syncthreads();  // the previous chunk's readers are done with stage 1 - s
    if (threadIdx.x == ISSUER && c + 1 < nch) issue_chunk<T>(a, c + 1, 1 - s, L, smem, gate);
    const float* vc = vec + s * VROWS * EC;
    expand_chunk<T>(a, xs, w1s + s * L.w1_stage, abuf, L.lda, pos_tab, m_ext);
    __syncthreads();
    silu_chunk<EC>(vc, abuf, L.lda, pos_tab, m_ext);
    __syncthreads();
    const int tw = t.tw;
    const int el = 2 * (threadIdx.x % (EC / 2));
    const float2 g = *reinterpret_cast<const float2*>(vc + V_GATE * EC + el);
    depthwise_chunk<EC>(t, vc, abuf, L.lda, [&](int r, int col, float2 d) {
      store_pair(dgs + Layout<T>::at(r * tw + col, el, EC), d.x * g.x, d.y * g.y);
    });
    fence_to_wgmma();
    __syncthreads();
    if constexpr (WG) {
      if (unit) wg_product<N2>(out_wg, dgs, mt, w3s + s * L.w3_stage, n2, EC, c > 0);
    } else {
      warp_mma<WM2, WN2>(out, dgs, EC + 4, wm, (m_own + 15) / 16, w3s + s * L.w3_stage, EC + 4, wn,
                         EC);
    }
  }

  // out = x + (acc + b3), in x's type
  const X* x = static_cast<const X*>(a.x) + t.n * a.sn;
  X* o = static_cast<X*>(a.out) + t.n * a.on;
  const int g = lane >> 2;
  const int tq = lane & 3;
  if constexpr (WG) {
    if (!unit) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = mt * 64 + 16 * (warp & 3) + g + 8 * r;
      if (m >= m_own) continue;
      const int hh = m / t.tw;
      const int p = (t.h0 + hh) * a.W + t.w0 + (m - hh * t.tw);
#pragma unroll
      for (int j = 0; j < N2 / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n2 + 8 * j + 2 * tq + h;
          if (col < a.C)
            store(o + col * a.oc + p * a.op,
                  to_f(x[col * a.sc + p * a.sp]) + (out_wg[4 * j + 2 * r + h] + a.b3[col]));
        }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < MI2; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = (wm + WM2 * i) * 16 + g + 8 * r;
      if (m >= m_own) continue;
      const int hh = m / t.tw;
      const int p = (t.h0 + hh) * a.W + t.w0 + (m - hh * t.tw);
#pragma unroll
      for (int f = 0; f < NI2; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = (wn + WN2 * (f >> 1)) * 16 + (f & 1) * 8 + 2 * tq + h;
          if (col < a.C)
            store(o + col * a.oc + p * a.op,
                  to_f(x[col * a.sc + p * a.sp]) + (out[i][f][2 * r + h] + a.b3[col]));
        }
    }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t st, const Args& a) {
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// Tiles of th x tw over the frame into a; returns the largest tile's pw rows
// (owned + halo, clipped to the frame).
int set_tiles(Args& a, int th, int tw, int row_pad) {
  a.TH = th;
  a.TW = tw;
  a.tiles_w = (a.W + tw - 1) / tw;
  a.tiles = ((a.H + th - 1) / th) * a.tiles_w;
  int rows = 0, cols = 0;
  for (int h0 = 0; h0 < a.H; h0 += th)
    rows = std::max(rows, std::min(h0 + th + 1, a.H) - std::max(h0 - 1, 0));
  for (int w0 = 0; w0 < a.W; w0 += tw)
    cols = std::max(cols, std::min(w0 + tw + 1, a.W) - std::max(w0 - 1, 0));
  a.mext = (rows * cols + row_pad - 1) / row_pad * row_pad;
  a.mown = (th * tw + row_pad - 1) / row_pad * row_pad;
  return rows * cols;
}

template <typename T, typename X>
cudaError_t run(const Args& ap, const Args& a, int N, int e_splits, cudaStream_t st) {
  const Smem<T> pool(ap, false), project(a, true);
  const size_t gate_smem = sizeof(float) * ((size_t)a.E + a.R);
  if (pool.total > SMEM_LIMIT || project.total > SMEM_LIMIT || gate_smem > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  cudaError_t err = launch(mbconv_pool_kernel<T, X>, dim3((unsigned)N * ap.tiles, e_splits),
                           pool.total, st, ap);
  if (err != cudaSuccess) return err;
  err = launch(mbconv_gate_kernel<T>, dim3(N), gate_smem, st, ap);  // reduces launch 1's tiles
  if (err != cudaSuccess) return err;
  const unsigned ctas = (unsigned)N * (unsigned)a.tiles;
  if constexpr (Chunk<T>::EC == 64) {  // bf16: N2 so that the tile's units fill the 4 warpgroups
    const int n2 = a.Cw * ((a.mown + 63) / 64) / 4;
    if (n2 <= 16)
      return launch(mbconv_project_kernel<T, X, 8, 1, 8, 16>, dim3(ctas), project.total, st, a);
    if (n2 <= 32)
      return launch(mbconv_project_kernel<T, X, 8, 1, 8, 32>, dim3(ctas), project.total, st, a);
    return launch(mbconv_project_kernel<T, X, 8, 1, 8, 64>, dim3(ctas), project.total, st, a);
  } else {
    if (a.Cw == 64)
      return launch(mbconv_project_kernel<T, X, 8, 2, 4, 0>, dim3(ctas), project.total, st, a);
    if (a.Cw == 128)
      return launch(mbconv_project_kernel<T, X, 8, 1, 8, 0>, dim3(ctas), project.total, st, a);
    return launch(mbconv_project_kernel<T, X, 4, 1, 8, 0>, dim3(ctas), project.total, st, a);
  }
}

}  // namespace

// Runs one block on `stream` (three launches); returns the first cudaError_t
// seen (0 = ok). x and out (x's type: bf16 if x_bf16, else fp32) hold element
// (n, c, p = h*W + w) at [n*s_n + c*s_c + p*s_p]. Operands, as ops/mbconv.py's
// MBConvWeights.operands lays them out: in the operand type (bf16 if op_bf16,
// else fp32) w1 as Ep / EC chunks of EC x Kp and w3 as Ep / EC chunks of Cw x
// EC, each in the kernel's shared layout (Layout<T>) and zero-padded (Kp = C
// rounded up to 16, Ep = E rounded up to whole chunks of EC = 64 for bf16 or 32
// for fp32, Cw = 64, 128 or 256 by C), wr (R, E), we (R, E); fp32 vec (Ep / EC,
// 11, EC): the taps, bd and b1 of each chunk; br (R), be (E), b3 (C). partials:
// (N, launch 1's tiles, E) and gate: (N, Ep) fp32 scratch, both 16-byte aligned.
// Tile plans (ops/mbconv.py::tile_plan): launch 1 owns rectangles pth x ptw with E
// split in e_splits parts, launch 3 th x tw. C <= 256; a tile's pw rows (owned +
// halo, clipped) <= 256, and launch 3's owned pixels <= 256, 128 or 64 (C <= 64,
// 128, 256).
extern "C" int mbconv_block(const void* x, long long x_sn, long long x_sc, long long x_sp,
                            void* out, long long o_sn, long long o_sc, long long o_sp,
                            const void* w1, const float* vec,
                            const void* wr, const float* br, const void* we, const float* be,
                            const void* w3, const float* b3, float* partials, float* gate,
                            int N, int H, int W, int C, int E, int R, int th, int tw, int pth,
                            int ptw, int e_splits, int op_bf16, int x_bf16, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || C > MAX_C || E < 1 || R < 1 || th < 1 || th > H ||
      tw < 1 || tw > W || pth < 1 || pth > H || ptw < 1 || ptw > W || e_splits < 1)
    return (int)cudaErrorInvalidValue;
  const int EC = op_bf16 ? Chunk<bf16>::EC : Chunk<float>::EC;
  Args a{x, x_sn, x_sc, x_sp, out, o_sn, o_sc, o_sp, w1, vec, wr, br, we, be, w3, b3,
         partials, gate};
  a.H = H;
  a.W = W;
  a.C = C;
  a.E = E;
  a.R = R;
  a.Kp = (C + 15) / 16 * 16;
  a.Cw = a.Kp <= 64 ? 64 : a.Kp <= 128 ? 128 : 256;  // WN2 * NI2 * 8 of the kernel chosen below
  a.Ep = (E + EC - 1) / EC * EC;
  const int row_pad = op_bf16 ? Layout<bf16>::ROWS : Layout<float>::ROWS;
  // launch 1 (no projection) may own any tile whose pw rows fit; launch 3 at most owned_cap
  Args ap = a;
  const int owned_cap = a.Cw == 64 ? 256 : a.Cw == 128 ? 128 : 64;  // 32 fp32 a thread
  if (set_tiles(ap, pth, ptw, row_pad) > M_CAP || set_tiles(a, th, tw, row_pad) > M_CAP ||
      th * tw > owned_cap)
    return (int)cudaErrorInvalidValue;
  ap.es_chunks = (a.Ep / EC + e_splits - 1) / e_splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (op_bf16)
    err = x_bf16 ? run<bf16, bf16>(ap, a, N, e_splits, st) : run<bf16, float>(ap, a, N, e_splits, st);
  else
    err = x_bf16 ? run<float, bf16>(ap, a, N, e_splits, st) : run<float, float>(ap, a, N, e_splits, st);
  return (int)err;
}
