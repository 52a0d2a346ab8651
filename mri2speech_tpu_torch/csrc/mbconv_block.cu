// One stride-1 SE-MBConv block with BatchNorm folded, for Hopper (sm_90a):
// fp32 in and out, bf16 or fp32 operands for the four products.
//
// Replaces the TPU kernel mri2speech_tpu/ops/pallas_mbconv.py::
// mbconv_block_pallas (:128, pallas_call :175):
//   a = SiLU(x @ w1 + b1)                      pw 1x1, C -> E
//   d = SiLU(depthwise3x3_SAME(a; wd) + bd)    per-frame zero padding, fp32
//   s = mean over the frame's pixels of d      (per frame, per channel)
//   g = sigmoid(SiLU(s @ wr + br) @ we + be)   SE, E -> R -> E
//   out = x + (d * g) @ w3 + b3                pwl 1x1, E -> C, residual
// Operands are rounded to the operand type where the TPU kernel rounds: x
// before pw, s and the SE hidden before the SE products, d*g before pwl. The
// depthwise taps, every elementwise step and the residual stay fp32 (the
// residual adds the unrounded x).
//
// What bounds it: at the EfficientNetV2-B2 shapes (N = 256 frames; 16x16
// with C 104 / E 416 and C 120 / E 720, 8x8 with C 208 / E 1248) the two
// 1x1 products are 2*N*HW*2*C*E FLOPs on the tensor cores and the depthwise
// 2*N*HW*9*E FLOPs on the CUDA cores, against 2*N*HW*C*4 bytes of x in and
// out; the three shapes sit near the line between the two bounds.
//
// Design. The SE gate needs a whole frame's depthwise output before the
// projection, and one frame's E-wide map (16*16*720*4 = 737 KB at 16x16 with
// E 720) fits no block, so the block runs as two launches:
//   pass 1, block = (E chunk of 64 channels, frame): pw product for every
//     pixel of the frame (a 256-thread block holds up to 256 pixels) + SiLU
//     into shared memory, depthwise 3x3 + SiLU, d written to an (N, E, HW)
//     fp32 scratch, and the frame's channel means written by the block itself
//     in a fixed order (warp sums, then partials in order; no atomics);
//   pass 2, block = (64-pixel tile, 64 output channels, frame): the frame's
//     SE gate from the means (recomputed by each block, ~E*R*2 MACs), then
//     bf16(d*g) @ w3 + b3 + x over 32-channel chunks of E.
// d's round trip through device memory (L2 for the most part) is what the
// TPU kernel avoided; keeping it on chip (a cluster sharing the frame through
// distributed shared memory, or a split at the SE pool) is later work.
// Products: mma.sync m16n8k16 for bf16, FMAs for fp32 (tile_mma.cuh).
// x and out are read through strides, so the module's NCHW layout and the
// NHWC of the public entry point need no copies.
//
// Built without --use_fast_math.

#include <cuda_runtime.h>

#include "tile_mma.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps: 4 (pixels) x 2 (channels)
constexpr int KC = 32;
constexpr int EB = 64;        // pass 1: E channels per block
constexpr int PM = 64;        // pass 2: pixels per block
constexpr int CN = 64;        // pass 2: output channels per block
constexpr int MAX_HW = 256;

struct ExpandArgs {
  const float* x;  // element (n, c, p) at x[n*sn + c*sc + p*sp]
  long long sn, sc, sp;
  const void* w1;  // (E, C), operand type
  const float* b1; // (E)
  const float* wd; // (9, E) fp32, tap dh*3 + dw
  const float* bd; // (E)
  float* d;        // (N, E, HW) scratch
  float* s;        // (N, E) per-frame channel means
  int C, E, H, W;
};

template <typename T, int MI>
__global__ void __launch_bounds__(THREADS) mbconv_expand_kernel(ExpandArgs a) {
  constexpr int LD = KC + m2s::Operand<T>::kPad;
  constexpr int ROWS = MI * 64;
  constexpr int LDA = EB + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);                 // [ROWS][LD]
  T* Ws = As + ROWS * LD;                                 // [EB][LD]
  float* abuf = reinterpret_cast<float*>(Ws + EB * LD);   // [HW][LDA]
  float* psum = abuf + ROWS * LDA;                        // [EB][HW / 32]

  const int n = blockIdx.y;
  const int e0 = blockIdx.x * EB;
  const int HW = a.H * a.W;
  const int C = a.C, E = a.E;
  const float* x = a.x + n * a.sn;
  const T* w1 = reinterpret_cast<const T*>(a.w1);
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;

  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;

  const bool pixel_major = a.sp == 1;
  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < ROWS * KC; idx += THREADS) {
      int p, cc;
      if (pixel_major) {
        p = idx % ROWS;
        cc = idx / ROWS;
      } else {
        cc = idx % KC;
        p = idx / KC;
      }
      const int c = c0 + cc;
      As[p * LD + cc] = m2s::Operand<T>::round(p < HW && c < C ? x[c * a.sc + p * a.sp] : 0.0f);
    }
    for (int idx = threadIdx.x; idx < EB * KC; idx += THREADS) {
      const int cc = idx % KC;
      const int e = e0 + idx / KC;
      const int c = c0 + cc;
      Ws[(idx / KC) * LD + cc] =
          e < E && c < C ? w1[(long long)e * C + c] : m2s::Operand<T>::round(0.0f);
    }
    __syncthreads();
    m2s::warp_tile_mma<MI, 4>(acc, As + wm * (MI * 16) * LD, LD, Ws + wn * 32 * LD, LD, KC);
  }

  // a = SiLU(pw + b1) into shared memory; rows past the frame are dropped
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = wm * (MI * 16) + m2s::acc_row(mi, q);
        const int el = wn * 32 + m2s::acc_col(ni, q);
        const int e = e0 + el;
        if (p < HW) abuf[p * LDA + el] = e < E ? m2s::siluf_(acc[mi][ni][q] + a.b1[e]) : 0.0f;
      }
  __syncthreads();

  // depthwise 3x3 (zero outside the frame) + SiLU; warp sums for the mean.
  // HW % 32 == 0, so the 32 lanes of a warp share one channel.
  const int chunks = HW / 32;
  for (int idx = threadIdx.x; idx < HW * EB; idx += THREADS) {
    const int p = idx % HW;
    const int el = idx / HW;
    const int e = e0 + el;
    const int h = p / a.W;
    const int w = p % a.W;
    float v = 0.0f;
    if (e < E) {
      float s = 0.0f;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const int hh = h + dh - 1;
        if (hh < 0 || hh >= a.H) continue;
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const int ww = w + dw - 1;
          if (ww < 0 || ww >= a.W) continue;
          s += abuf[(hh * a.W + ww) * LDA + el] * a.wd[(dh * 3 + dw) * E + e];
        }
      }
      v = m2s::siluf_(s + a.bd[e]);
      a.d[((long long)n * E + e) * HW + p] = v;
    }
    float sum = v;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if ((threadIdx.x & 31) == 0) psum[el * chunks + p / 32] = sum;
  }
  __syncthreads();
  if (threadIdx.x < EB) {
    const int e = e0 + threadIdx.x;
    if (e < E) {
      float s = 0.0f;
      for (int i = 0; i < chunks; ++i) s += psum[threadIdx.x * chunks + i];
      a.s[(long long)n * E + e] = s / (float)HW;
    }
  }
}

struct ProjectArgs {
  const float* x;  // residual, element (n, c, p) at x[n*sn + c*sc + p*sp]
  long long sn, sc, sp;
  float* out;
  long long on, oc, op;
  const float* d;  // (N, E, HW)
  const float* s;  // (N, E)
  const void* wr;  // (R, E), operand type
  const float* br; // (R)
  const void* we;  // (E, R), operand type
  const float* be; // (E)
  const void* w3;  // (C, E), operand type
  const float* b3; // (C)
  int C, E, R, HW;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) mbconv_project_kernel(ProjectArgs a) {
  constexpr int LD = KC + m2s::Operand<T>::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);               // [PM][LD]
  T* Ws = As + PM * LD;                                 // [CN][LD]
  float* gate = reinterpret_cast<float*>(Ws + CN * LD); // [E]
  float* hid = gate + a.E;                              // [R]

  const int n = blockIdx.z;
  const int p0 = blockIdx.x * PM;
  const int c0 = blockIdx.y * CN;
  const int C = a.C, E = a.E, R = a.R, HW = a.HW;
  const T* wr = reinterpret_cast<const T*>(a.wr);
  const T* we = reinterpret_cast<const T*>(a.we);
  const T* w3 = reinterpret_cast<const T*>(a.w3);
  const float* s = a.s + (long long)n * E;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // SE gate of frame n
  for (int r = warp; r < R; r += THREADS / 32) {
    float acc = 0.0f;
    for (int e = lane; e < E; e += 32)
      acc += m2s::round_to<T>(s[e]) * m2s::Operand<T>::to_float(wr[(long long)r * E + e]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) hid[r] = m2s::siluf_(acc + a.br[r]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += THREADS) {
    float acc = 0.0f;
    for (int r = 0; r < R; ++r)
      acc += m2s::round_to<T>(hid[r]) * m2s::Operand<T>::to_float(we[(long long)e * R + r]);
    gate[e] = m2s::sigmoidf_(acc + a.be[e]);
  }

  const int wm = warp & 3;
  const int wn = warp >> 2;
  float acc[1][4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[0][ni][q] = 0.0f;

  const float* d = a.d + (long long)n * E * HW;
  for (int k0 = 0; k0 < E; k0 += KC) {
    __syncthreads();  // gate written; the previous chunk's products are done
    for (int idx = threadIdx.x; idx < PM * KC; idx += THREADS) {
      const int p = idx % PM;
      const int kk = idx / PM;
      const int e = k0 + kk;
      const int pp = p0 + p;
      As[p * LD + kk] =
          m2s::Operand<T>::round(pp < HW && e < E ? d[(long long)e * HW + pp] * gate[e] : 0.0f);
    }
    for (int idx = threadIdx.x; idx < CN * KC; idx += THREADS) {
      const int kk = idx % KC;
      const int c = c0 + idx / KC;
      const int e = k0 + kk;
      Ws[(idx / KC) * LD + kk] =
          c < C && e < E ? w3[(long long)c * E + e] : m2s::Operand<T>::round(0.0f);
    }
    __syncthreads();
    m2s::warp_tile_mma<1, 4>(acc, As + wm * 16 * LD, LD, Ws + wn * 32 * LD, LD, KC);
  }

  const float* x = a.x + n * a.sn;
  float* out = a.out + n * a.on;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = p0 + wm * 16 + m2s::acc_row(0, q);
      const int c = c0 + wn * 32 + m2s::acc_col(ni, q);
      if (p >= HW || c >= C) continue;
      out[c * a.oc + p * a.op] = x[c * a.sc + p * a.sp] + (acc[0][ni][q] + a.b3[c]);
    }
}

template <typename T, int MI>
cudaError_t launch_expand(const ExpandArgs& a, int N, cudaStream_t stream) {
  constexpr int LD = KC + m2s::Operand<T>::kPad;
  const int HW = a.H * a.W;
  const size_t smem = sizeof(T) * ((size_t)MI * 64 * LD + (size_t)EB * LD) +
                      sizeof(float) * ((size_t)MI * 64 * (EB + 1) + (size_t)EB * (HW / 32));
  cudaError_t err = cudaFuncSetAttribute(mbconv_expand_kernel<T, MI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.E + EB - 1) / EB, N);
  mbconv_expand_kernel<T, MI><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_block(const ExpandArgs& ea, const ProjectArgs& pa, int N, cudaStream_t st) {
  const int HW = ea.H * ea.W;
  cudaError_t err;
  switch ((HW + 63) / 64) {
    case 1: err = launch_expand<T, 1>(ea, N, st); break;
    case 2: err = launch_expand<T, 2>(ea, N, st); break;
    case 3: err = launch_expand<T, 3>(ea, N, st); break;
    case 4: err = launch_expand<T, 4>(ea, N, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  constexpr int LD = KC + m2s::Operand<T>::kPad;
  const size_t smem = sizeof(T) * (size_t)(PM + CN) * LD + sizeof(float) * (size_t)(pa.E + pa.R);
  err = cudaFuncSetAttribute(mbconv_project_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((HW + PM - 1) / PM, (pa.C + CN - 1) / CN, N);
  mbconv_project_kernel<T><<<grid, THREADS, smem, st>>>(pa);
  return cudaGetLastError();
}

}  // namespace

// Runs one block on `stream` (two launches); returns the first cudaError_t
// seen (0 = ok). x and out are fp32 with element (n, c, p = h*W + w) at
// [n*s_n + c*s_c + p*s_p]; w1 (E, C), wr (R, E), we (E, R), w3 (C, E) in the
// operand type (op_bf16: bf16, else fp32); wd (9, E) and every bias fp32;
// d_scratch (N, E, H*W) and s_scratch (N, E) fp32. H*W must be a multiple of
// 32 and at most 256.
extern "C" int mbconv_block_f32(const float* x, long long x_sn, long long x_sc, long long x_sp,
                                float* out, long long o_sn, long long o_sc, long long o_sp,
                                const void* w1, const float* b1, const float* wd,
                                const float* bd, const void* wr, const float* br,
                                const void* we, const float* be, const void* w3,
                                const float* b3, float* d_scratch, float* s_scratch, int N,
                                int H, int W, int C, int E, int R, int op_bf16, void* stream) {
  const int HW = H * W;
  if (N < 1 || HW < 32 || HW > MAX_HW || HW % 32 || C < 1 || E < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // frames go on grid.y / grid.z, which stop at 65535: larger calls run in chunks
  constexpr int MAX_FRAMES = 65535;
  for (int n0 = 0; n0 < N; n0 += MAX_FRAMES) {
    const int nc = N - n0 < MAX_FRAMES ? N - n0 : MAX_FRAMES;
    const float* xc = x + n0 * x_sn;
    float* dc = d_scratch + (long long)n0 * E * HW;
    float* sc = s_scratch + (long long)n0 * E;
    const ExpandArgs ea{xc, x_sn, x_sc, x_sp, w1, b1, wd, bd, dc, sc, C, E, H, W};
    const ProjectArgs pa{xc, x_sn, x_sc, x_sp, out + n0 * o_sn, o_sn, o_sc, o_sp, dc, sc,
                         wr, br, we, be, w3, b3, C, E, R, HW};
    const cudaError_t err = op_bf16 ? launch_block<__nv_bfloat16>(ea, pa, nc, st)
                                    : launch_block<float>(ea, pa, nc, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
