// One whole HiFi-GAN MRF stage for Hopper (sm_90a): fp32 in and out, bf16 or
// fp32 operands for the convolution products, fp32 accumulation.
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
// stay fp32 (where the TPU kernel rounds).
//
// What bounds it: operations. A stage does 2 * NU * sum(k_j) * T * C^2
// multiply-adds (252 * T * C^2 FLOPs at 3/7/11 and 1/3/5): ~200 GFLOP for
// the four stages of a 256-frame request, against a few tens of MB moved.
//
// Design. The TPU kernel packs the three branches into one block-diagonal
// (3C, 3C) matrix per tap, padded to k_max taps (~4.7x the useful FLOPs), and
// keeps one sequence tile with a 128-row halo in VMEM through all 18 convs.
// Here each conv is its own launch over all branches and batch rows
// (grid.z = B * NB), with per-branch taps, so no FLOP is padded; the stage's
// state goes through device memory (L2 at these sizes) between convs, which
// makes every tile independent without a halo chain: rows before t = 0 are
// read as literal zeros at every conv input, and the bias never reaches them.
// At C = 256 a k = 11 tile with the stage's halo would not fit next to one
// tap's C x C weights in 227 KB; per conv, a block needs only its rows plus
// (k-1)*d halo rows and the k taps of one 32-channel input chunk.
//
// Block: 256 threads, BM = 128 time rows x BN output channels (64, or 32
// when C < 64); 8 warps as 4 (rows) x 2 (columns), warp tile 32 x BN/2. For
// each 32-channel input chunk the block stages leaky(input) rows
// [t0 - (k-1)d, t0 + BM) and the k taps in shared memory, then runs k shifted
// tile products (tap m reads rows shifted by m*d). bf16 operands go through
// mma.sync m16n8k16; fp32 operands through FMAs (tile_mma.cuh). The branch
// mean is one more elementwise launch. wgmma/TMA, and keeping a unit's chain
// on chip, are later work.
//
// Built without --use_fast_math.

#include <cuda_runtime.h>

#include "tile_mma.cuh"

namespace {

constexpr int BM = 128;
constexpr int KC = 32;
constexpr int THREADS = 256;
constexpr int MAX_NB = 4;
constexpr float SLOPE = 0.1f;

struct Strided {  // element (b, branch j, channel c, time t) at p[b*sb + j*sj + c*sc + t*st]
  const float* p;
  long long sb, sj, sc, st;
};

struct ConvArgs {
  Strided in;         // conv input; leaky is applied as it is staged
  Strided res;        // residual base (p == nullptr: none)
  float* out;         // output, strides as `dst`
  long long ob, oj, oc, ot;
  const void* w;      // this conv's taps for every branch: [j][m][co][ci], operand type
  long long w_off[MAX_NB];
  int k[MAX_NB];
  const float* bias;  // [j][C]
  int NB, C, T, dil;
};

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS) causal_conv_kernel(ConvArgs a) {
  constexpr int LD = KC + m2s::Operand<T>::kPad;
  constexpr int NI = BN / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int b = blockIdx.z / a.NB;
  const int j = blockIdx.z % a.NB;
  const int t0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int k = a.k[j];
  const int d = a.dil;
  const int halo = (k - 1) * d;
  const int rows = BM + halo;
  const int C = a.C;

  T* As = reinterpret_cast<T*>(smem_raw);  // [rows][LD]
  T* Ws = As + rows * LD;                  // [k][BN][LD]

  const float* in = a.in.p + b * a.in.sb + j * a.in.sj;
  const T* W = reinterpret_cast<const T*>(a.w) + a.w_off[j];

  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;

  float acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;

  const bool time_major = a.in.st == 1;  // (B, C, T): consecutive threads walk t
  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the previous chunk's products are done with As and Ws
    for (int idx = threadIdx.x; idx < rows * KC; idx += THREADS) {
      int r, cc;
      if (time_major) {
        r = idx % rows;
        cc = idx / rows;
      } else {
        cc = idx % KC;
        r = idx / KC;
      }
      const int t = t0 - halo + r;
      const int ci = c0 + cc;
      float v = 0.0f;  // before t = 0: the causal zero padding of this conv's input
      if (t >= 0 && t < a.T && ci < C) {
        v = in[ci * a.in.sc + t * a.in.st];
        v = v >= 0.0f ? v : v * SLOPE;
      }
      As[r * LD + cc] = m2s::Operand<T>::round(v);
    }
    for (int idx = threadIdx.x; idx < k * BN * KC; idx += THREADS) {
      const int cc = idx % KC;
      const int rest = idx / KC;
      const int n = rest % BN;
      const int m = rest / BN;
      const int co = n0 + n;
      const int ci = c0 + cc;
      Ws[(m * BN + n) * LD + cc] =
          (co < C && ci < C) ? W[((long long)m * C + co) * C + ci] : m2s::Operand<T>::round(0.0f);
    }
    __syncthreads();
    for (int m = 0; m < k; ++m)
      m2s::warp_tile_mma<2, NI>(acc, As + (halo - m * d + wm * 32) * LD, LD,
                                Ws + (m * BN + wn * (BN / 2)) * LD, LD, KC);
  }

  const float* bias = a.bias + j * C;
  const float* res = a.res.p == nullptr ? nullptr : a.res.p + b * a.res.sb + j * a.res.sj;
  float* out = a.out + b * a.ob + j * a.oj;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = t0 + wm * 32 + m2s::acc_row(mi, q);
        const int co = n0 + wn * (BN / 2) + m2s::acc_col(ni, q);
        if (t >= a.T || co >= C) continue;
        float v = acc[mi][ni][q] + bias[co];
        if (res != nullptr) v = res[co * a.res.sc + t * a.res.st] + v;
        out[co * a.oc + t * a.ot] = v;
      }
}

// out(b, c, t) = (cur_0 + cur_1 + ...) * (1 / NB); cur is (NB, B, C, T) contiguous
__global__ void branch_mean_kernel(const float* __restrict__ cur, float* __restrict__ out,
                                   long long ob, long long oc, long long ot, int NB, int B,
                                   int C, int T) {
  const long long n = (long long)B * C * T;
  const float inv = 1.0f / (float)NB;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int t = (int)(i % T);
    const int c = (int)((i / T) % C);
    const int b = (int)(i / ((long long)T * C));
    float s = cur[i];
    for (int j = 1; j < NB; ++j) s = s + cur[(long long)j * n + i];
    out[b * ob + c * oc + t * ot] = s * inv;
  }
}

template <typename T, int BN>
cudaError_t launch_conv(const ConvArgs& a, int B, int k_max, cudaStream_t stream) {
  constexpr int LD = KC + m2s::Operand<T>::kPad;
  const size_t smem =
      sizeof(T) * ((size_t)(BM + (k_max - 1) * a.dil) * LD + (size_t)k_max * BN * LD);
  cudaError_t err = cudaFuncSetAttribute(causal_conv_kernel<T, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + BM - 1) / BM, (a.C + BN - 1) / BN, B * a.NB);
  causal_conv_kernel<T, BN><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_conv_any(const ConvArgs& a, int B, int k_max, cudaStream_t stream) {
  return a.C >= 64 ? launch_conv<T, 64>(a, B, k_max, stream)
                   : launch_conv<T, 32>(a, B, k_max, stream);
}

}  // namespace

// Runs one MRF stage on `stream`: 2 * nu conv launches and one mean launch.
// Returns the first cudaError_t seen (0 = ok).
//   x:   fp32, element (b, j, c, t) at x[b*x_sb + j*x_sj + c*x_sc + t*x_st]
//        (x_sj = 0: every branch starts from the same x);
//   out: fp32, element (b, c, t) at out[b*o_sb + c*o_sc + t*o_st];
//   cur, y: fp32 scratch, nb * B * C * T each;
//   w:   taps in the operand type (op_bf16: bf16, else fp32), conv q = 2u + (c-1)
//        of branch j at offset (q * sum(k) + sum_{i<j} k_i) * C * C, laid out
//        [m][co][ci] with tap m applied to input row t - m*d;
//   bias: fp32 (2 nu, nb, C).
extern "C" int mrf_stage_f32(const float* x, long long x_sb, long long x_sj, long long x_sc,
                             long long x_st, float* out, long long o_sb, long long o_sc,
                             long long o_st, float* cur, float* y, const void* w,
                             const float* bias, const int* kernels, int nb, const int* dils,
                             int nu, int B, int C, int T, int op_bf16, void* stream) {
  if (nb < 1 || nb > MAX_NB || nu < 1 || B < 1 || C < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int k_sum = 0, k_max = 0;
  for (int j = 0; j < nb; ++j) {
    k_sum += kernels[j];
    k_max = kernels[j] > k_max ? kernels[j] : k_max;
  }
  const long long CC = (long long)C * C;
  const long long sb = (long long)C * T, sj = (long long)B * C * T;  // scratch strides
  const Strided x_in{x, x_sb, x_sj, x_sc, x_st};
  const Strided cur_s{cur, sb, sj, T, 1};
  const Strided y_s{y, sb, sj, T, 1};

  for (int u = 0; u < nu; ++u) {
    for (int c = 0; c < 2; ++c) {
      ConvArgs a{};
      const int q = 2 * u + c;
      a.in = c == 0 ? (u == 0 ? x_in : cur_s) : y_s;
      a.res = c == 0 ? Strided{nullptr, 0, 0, 0, 0} : (u == 0 ? x_in : cur_s);
      a.out = c == 0 ? y : cur;
      a.ob = sb;
      a.oj = sj;
      a.oc = T;
      a.ot = 1;
      a.w = w;
      long long off = (long long)q * k_sum * CC;
      for (int j = 0; j < nb; ++j) {
        a.w_off[j] = off;
        a.k[j] = kernels[j];
        off += kernels[j] * CC;
      }
      a.bias = bias + (long long)q * nb * C;
      a.NB = nb;
      a.C = C;
      a.T = T;
      a.dil = c == 0 ? dils[u] : 1;
      cudaError_t err = op_bf16 ? launch_conv_any<__nv_bfloat16>(a, B, k_max, st)
                                : launch_conv_any<float>(a, B, k_max, st);
      if (err != cudaSuccess) return (int)err;
    }
  }
  const long long n = (long long)B * C * T;
  const int blocks = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  branch_mean_kernel<<<blocks, 256, 0, st>>>(cur, out, o_sb, o_sc, o_st, nb, B, C, T);
  return (int)cudaGetLastError();
}
