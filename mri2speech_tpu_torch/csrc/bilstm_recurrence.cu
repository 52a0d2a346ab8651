// Fused bidirectional LSTM recurrence for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel mri2speech_tpu/ops/pallas_lstm.py::
// bilstm_recurrence_pallas_chunked (pallas_call at :348). Same contract:
// gate pre-activations xg_fwd, xg_bwd (T, B, 4H) with the input projection,
// the fused bias and the padded-step freeze already applied; recurrent
// weights w_hh (4H, H) row-major (the nn.LSTM weight_hh layout, so each gate
// row is one coalesced read); outputs h (T, B, H) per direction. Gate order
// i, f, g, o. Step s advances the forward cell at time s and the backward
// cell at time T-1-s, both starting from h = c = 0.
//
// What bounds it: T dependent steps, each of which needs all of h from the
// step before. The arithmetic (2 * 2 * 4H * H * B FLOPs a step) and the
// bytes (both w_hh, 13.1 MB at H=640, which stay in the 50 MB L2 across
// steps) are small next to the per-step latency of a launch plus one pass
// over w_hh from L2. This first version keeps the step boundary a kernel
// boundary: the host loop makes one launch per step on the caller's
// stream, and the launch boundary is the grid-wide barrier that makes
// h_{t-1} visible to every block. A persistent kernel with each SM's slice
// of w_hh resident in shared memory and a grid barrier per step is the
// follow-up.
//
// Grid: (ceil(H / UNITS), 2 directions). Each block owns UNITS hidden units;
// warp w of the block owns unit j and computes its 4 gate rows against h_{t-1}
// for every batch row, staged in shared memory BCHUNK rows at a time. After
// a warp reduction, lane b applies the cell update for batch row b, writes
// h_t to out[t] and c_t to the (2, B, H) state buffer. Each (direction, b, j)
// cell is owned by one thread for the whole sequence, so c needs no sync.
//
// Built without --use_fast_math: expf/tanhf are the precise versions, so
// sigmoid(+30) rounds to 1.0f and frozen (padded) steps keep c exactly.

#include <cuda_runtime.h>

namespace {

constexpr int UNITS = 4;             // hidden units (= warps) per block
constexpr int THREADS = 32 * UNITS;
constexpr int BCHUNK = 4;            // batch rows staged per pass

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(THREADS)
bilstm_step_kernel(const float* __restrict__ xg_f, const float* __restrict__ xg_b,
                   const float* __restrict__ w_f, const float* __restrict__ w_b,
                   float* __restrict__ out_f, float* __restrict__ out_b,
                   float* __restrict__ c_state, int T, int B, int H, int s) {
  extern __shared__ float h_sh[];  // [BCHUNK][H]

  const int dir = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * UNITS + warp;
  const bool active = j < H;

  const int t = dir == 0 ? s : T - 1 - s;
  const float* xg = dir == 0 ? xg_f : xg_b;
  const float* w = dir == 0 ? w_f : w_b;
  float* out = dir == 0 ? out_f : out_b;
  // h_{t-1} in processing order: out[t-1] forward, out[t+1] backward
  const float* h_prev = s == 0 ? nullptr
                               : out + (size_t)(dir == 0 ? t - 1 : t + 1) * B * H;
  float* c = c_state + (size_t)dir * B * H;

  const size_t G = 4 * (size_t)H;
  const float* w_i = w + (size_t)(0 * H + (active ? j : 0)) * H;
  const float* w_fg = w + (size_t)(1 * H + (active ? j : 0)) * H;
  const float* w_g = w + (size_t)(2 * H + (active ? j : 0)) * H;
  const float* w_o = w + (size_t)(3 * H + (active ? j : 0)) * H;

  for (int b0 = 0; b0 < B; b0 += BCHUNK) {
    __syncthreads();  // previous pass done reading h_sh
    for (int idx = threadIdx.x; idx < BCHUNK * H; idx += THREADS) {
      const int bb = idx / H;
      const int k = idx - bb * H;
      const int b = b0 + bb;
      h_sh[idx] = (h_prev != nullptr && b < B) ? h_prev[(size_t)b * H + k] : 0.0f;
    }
    __syncthreads();
    if (!active) continue;

    float acc[4][BCHUNK];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int bb = 0; bb < BCHUNK; ++bb) acc[q][bb] = 0.0f;

    if (h_prev != nullptr) {
      for (int k = lane; k < H; k += 32) {
        const float wi = w_i[k], wf = w_fg[k], wg = w_g[k], wo = w_o[k];
#pragma unroll
        for (int bb = 0; bb < BCHUNK; ++bb) {
          const float hv = h_sh[bb * H + k];
          acc[0][bb] = fmaf(wi, hv, acc[0][bb]);
          acc[1][bb] = fmaf(wf, hv, acc[1][bb]);
          acc[2][bb] = fmaf(wg, hv, acc[2][bb]);
          acc[3][bb] = fmaf(wo, hv, acc[3][bb]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int bb = 0; bb < BCHUNK; ++bb)
            acc[q][bb] += __shfl_xor_sync(0xffffffffu, acc[q][bb], off);
    }

#pragma unroll
    for (int bb = 0; bb < BCHUNK; ++bb) {
      const int b = b0 + bb;
      if (lane != bb || b >= B) continue;
      const float* x = xg + ((size_t)t * B + b) * G;
      const float gi = sigmoidf_(x[j] + acc[0][bb]);
      const float gf = sigmoidf_(x[H + j] + acc[1][bb]);
      const float gg = tanhf(x[2 * H + j] + acc[2][bb]);
      const float go = sigmoidf_(x[3 * H + j] + acc[3][bb]);
      const size_t cidx = (size_t)b * H + j;
      const float c_prev = s == 0 ? 0.0f : c[cidx];
      const float c_new = gf * c_prev + gi * gg;
      c[cidx] = c_new;
      out[((size_t)t * B + b) * H + j] = go * tanhf(c_new);
    }
  }
}

}  // namespace

// Runs all T steps on `stream`; returns the first cudaError_t seen (0 = ok).
// Pointers are device pointers; xg_* (T, B, 4H), w_* (4H, H), out_* (T, B, H),
// c_state (2, B, H) scratch, all fp32 and contiguous.
extern "C" int bilstm_recurrence_f32(const float* xg_f, const float* xg_b,
                                     const float* w_f, const float* w_b,
                                     float* out_f, float* out_b, float* c_state,
                                     int T, int B, int H, void* stream) {
  const size_t smem = sizeof(float) * BCHUNK * (size_t)H;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bilstm_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((H + UNITS - 1) / UNITS, 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int s = 0; s < T; ++s) {
    bilstm_step_kernel<<<grid, THREADS, smem, st>>>(xg_f, xg_b, w_f, w_b, out_f, out_b,
                                                    c_state, T, B, H, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
