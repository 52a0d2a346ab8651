// Warp-level tile products shared by the port's kernels (mrf_stage.cu,
// mbconv_block.cu).
//
// warp_tile_mma accumulates a (MI*16) x (NI*8) tile of A @ B^T into acc,
// reading A as [row][k] and B as [col][k] from shared memory (k contiguous in
// both, leading dimensions lda / ldb in elements). The accumulator follows the
// m16n8 layout of mma.sync: acc[mi][ni][q] holds
//   row mi*16 + g + 8*(q >> 1), column ni*8 + 2*t + (q & 1),
// with g = lane / 4 and t = lane % 4, for both operand types, so one epilogue
// serves both:
//   * bf16 operands: mma.sync.m16n8k16 on the tensor cores (bf16 products are
//     exact in fp32; fp32 accumulation). depth % 16 == 0, lda and ldb even.
//   * fp32 operands: fp32 FMAs on the CUDA cores, the same tile, any depth.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace m2s {

template <typename T>
struct Operand;

template <>
struct Operand<float> {
  static constexpr int kPad = 1;  // odd row stride: rows fall on distinct banks
  __device__ __forceinline__ static float round(float v) { return v; }
  __device__ __forceinline__ static float to_float(float v) { return v; }
};

template <>
struct Operand<__nv_bfloat16> {
  static constexpr int kPad = 8;  // row stride of 20 words: the 8 rows of a fragment hit distinct banks
  __device__ __forceinline__ static __nv_bfloat16 round(float v) { return __float2bfloat16_rn(v); }
  __device__ __forceinline__ static float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
};

// v rounded to the operand type and back: what the product will see
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Operand<T>::to_float(Operand<T>::round(v));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int MI, int NI>
__device__ __forceinline__ void warp_tile_mma(float (&acc)[MI][NI][4],
                                              const __nv_bfloat16* a, int lda,
                                              const __nv_bfloat16* b, int ldb, int depth) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int k0 = 0; k0 < depth; k0 += 16) {
    uint32_t af[MI][4];
    uint32_t bf[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const __nv_bfloat16* p = a + (mi * 16 + g) * lda + k0 + 2 * t;
      af[mi][0] = ld_pair(p);
      af[mi][1] = ld_pair(p + 8 * lda);
      af[mi][2] = ld_pair(p + 8);
      af[mi][3] = ld_pair(p + 8 * lda + 8);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const __nv_bfloat16* q = b + (ni * 8 + g) * ldb + k0 + 2 * t;
      bf[ni][0] = ld_pair(q);
      bf[ni][1] = ld_pair(q + 8);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(acc[mi][ni][0]), "+f"(acc[mi][ni][1]), "+f"(acc[mi][ni][2]),
              "+f"(acc[mi][ni][3])
            : "r"(af[mi][0]), "r"(af[mi][1]), "r"(af[mi][2]), "r"(af[mi][3]),
              "r"(bf[ni][0]), "r"(bf[ni][1]));
  }
}

template <int MI, int NI>
__device__ __forceinline__ void warp_tile_mma(float (&acc)[MI][NI][4], const float* a, int lda,
                                              const float* b, int ldb, int depth) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int k = 0; k < depth; ++k) {
    float av[MI][2];
    float bv[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      av[mi][0] = a[(mi * 16 + g) * lda + k];
      av[mi][1] = a[(mi * 16 + g + 8) * lda + k];
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      bv[ni][0] = b[(ni * 8 + 2 * t) * ldb + k];
      bv[ni][1] = b[(ni * 8 + 2 * t + 1) * ldb + k];
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        acc[mi][ni][0] = fmaf(av[mi][0], bv[ni][0], acc[mi][ni][0]);
        acc[mi][ni][1] = fmaf(av[mi][0], bv[ni][1], acc[mi][ni][1]);
        acc[mi][ni][2] = fmaf(av[mi][1], bv[ni][0], acc[mi][ni][2]);
        acc[mi][ni][3] = fmaf(av[mi][1], bv[ni][1], acc[mi][ni][3]);
      }
  }
}

// Row and column (within the warp tile) of accumulator element acc[mi][ni][q].
__device__ __forceinline__ int acc_row(int mi, int q) {
  return mi * 16 + ((threadIdx.x & 31) >> 2) + 8 * (q >> 1);
}
__device__ __forceinline__ int acc_col(int ni, int q) {
  return ni * 8 + 2 * (threadIdx.x & 3) + (q & 1);
}

// 1 / d for d >= 1, rounded as the IEEE division 1.0f / d rounds, without the
// division's slow-path branch, so the compiler can interleave several: MUFU.RCP
// and one Newton step with FMA on d / 4 (exact, and 4 / d stays normal), then
// the exact * 1/4, which rounds a second time only where 1/d is subnormal (d >
// 2^126); 0 for d = inf. chip_smoke.py holds sigmoidf_ and siluf_ against the
// division for every fp32 x.
__device__ __forceinline__ float rcp_ge1(float d) {
  const float ds = d * 0.25f;
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(ds));
  r = fmaf(fmaf(-ds, r, 1.0f), r, r) * 0.25f;
  return d == __int_as_float(0x7f800000) ? 0.0f : r;
}

// precise expf (not __expf): built without --use_fast_math
__device__ __forceinline__ float sigmoidf_(float x) { return rcp_ge1(1.0f + expf(-x)); }
__device__ __forceinline__ float siluf_(float x) { return x * sigmoidf_(x); }

}  // namespace m2s
