// LSTM recurrences for Hopper (sm_90a), fp32: one kernel, two C entry points.
//
// Replaces the TPU kernels of mri2speech_tpu/ops/pallas_lstm.py:
//   K1  bilstm_recurrence_pallas_chunked (pallas_call at :348) and
//   K2b bilstm_recurrence_pallas (:196), both directions at once:
//       C entry bilstm_recurrence_f32;
//   K2a lstm_recurrence_pallas (:113), one direction with `reverse`, and the
//       scan of models/lstm.py::lstm_direction (hold mask, seed state, final
//       state; the online streaming path): C entry lstm_recurrence_f32.
// Inputs: gate pre-activations xg (T, B, 4H) with the input projection and
// the fused bias already applied; recurrent weights w (4H, H) row-major (the
// nn.LSTM weight_hh layout, so each gate row is one coalesced read); output
// h (T, B, H) per direction. Gate order i, f, g, o. Step s advances each
// direction's cell at time s (forward) or T-1-s (reverse).
//
// Masking comes in two modes. Freeze (K1, K2a, K2b): the caller has already
// overwritten the pre-activations of padded steps with the gate freeze and
// passes no mask; the kernel runs every step. Hold (the scan's semantics,
// mri2speech_tpu/models/lstm.py:108-127): with a (T, B) mask, 1 = valid, a
// padded step keeps (h, c) as they were and writes the held h to out[t].
// A direction may start from a seed (h0, c0) instead of zeros; its cell
// state buffer c (B, H) holds c after the last step on return, and h after
// the last step is out[T-1] (forward) or out[0] (reverse).
//
// What bounds it: T dependent steps, each of which needs all of h from the
// step before. The arithmetic (2 * 4H * H * B FLOPs a step and direction)
// and the bytes (w, 6.6 MB a direction at H=640, which stays in the 50 MB
// L2 across steps) are small next to the per-step latency of a launch plus
// one pass over w from L2. This first version keeps the step boundary a
// kernel boundary: the host loop makes one launch per step on the caller's
// stream, and the launch boundary is the grid-wide barrier that makes
// h_{t-1} visible to every block. A persistent kernel with each SM's slice
// of w resident in shared memory and a grid barrier per step is the
// follow-up.
//
// Grid: (ceil(H / UNITS), directions). Each block owns UNITS hidden units of
// one direction; warp w of the block owns unit j and computes its 4 gate
// rows against h_{t-1} for every batch row, staged in shared memory BCHUNK
// rows at a time. After a warp reduction, lane b applies the cell update for
// batch row b, writes h_t to out[t] and c_t to the state buffer. Each
// (direction, b, j) cell is owned by one thread for the whole sequence, so c
// needs no sync.
//
// Built without --use_fast_math: expf/tanhf are the precise versions, so
// sigmoid(+30) rounds to 1.0f and frozen (padded) steps keep c exactly; the
// hold selects the old (h, c), so held steps are exact too.
//
// The seed and the hold are a template parameter, so the freeze-mode launches
// carry no code for them. Loads are plain: with read-only loads (__ldg) K1's
// step took ~10 us of device time instead of ~7.5 (chip_smoke.py's profile
// of a 250-frame request, NVIDIA H100 80GB HBM3 at 700 W; see PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int UNITS = 4;             // hidden units (= warps) per block
constexpr int THREADS = 32 * UNITS;
constexpr int BCHUNK = 4;            // batch rows staged per pass

struct Direction {
  const float* xg;  // (T, B, 4H)
  const float* w;   // (4H, H)
  float* out;       // (T, B, H)
  float* c;         // (B, H) cell state; c after the last step on return
  const float* h0;  // (B, H) seed, or nullptr for zeros
  const float* c0;  // (B, H) seed, or nullptr for zeros
  int reverse;      // 1: step s is time T-1-s
};

struct Recurrence {
  Direction dir[2];   // blockIdx.y picks one
  const float* mask;  // (T, B), 1 = valid, hold mode; nullptr: every step runs
  int T, B, H;
};

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool HOLD>  // false: no seed, no mask (K1, K2a, K2b)
__global__ void __launch_bounds__(THREADS)
lstm_step_kernel(const Recurrence r, int s) {
  extern __shared__ float h_sh[];  // [BCHUNK][H]

  const Direction d = blockIdx.y == 0 ? r.dir[0] : r.dir[1];
  const int T = r.T, B = r.B, H = r.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * UNITS + warp;
  const bool active = j < H;

  const int t = d.reverse ? T - 1 - s : s;
  // h_{t-1} in processing order: the seed at step 0, else the output of the
  // step before (which, in hold mode, is the held h)
  const float* h_prev = s == 0 ? (HOLD ? d.h0 : nullptr)
                               : d.out + (size_t)(d.reverse ? t + 1 : t - 1) * B * H;

  const size_t G = 4 * (size_t)H;
  const float* w_i = d.w + (size_t)(0 * H + (active ? j : 0)) * H;
  const float* w_fg = d.w + (size_t)(1 * H + (active ? j : 0)) * H;
  const float* w_g = d.w + (size_t)(2 * H + (active ? j : 0)) * H;
  const float* w_o = d.w + (size_t)(3 * H + (active ? j : 0)) * H;

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
      const float* x = d.xg + ((size_t)t * B + b) * G;
      const float gi = sigmoidf_(x[j] + acc[0][bb]);
      const float gf = sigmoidf_(x[H + j] + acc[1][bb]);
      const float gg = tanhf(x[2 * H + j] + acc[2][bb]);
      const float go = sigmoidf_(x[3 * H + j] + acc[3][bb]);
      const size_t cidx = (size_t)b * H + j;
      const float c_prev = s > 0 ? d.c[cidx] : (HOLD && d.c0 != nullptr ? d.c0[cidx] : 0.0f);
      float c_new = gf * c_prev + gi * gg;
      float h_new = go * tanhf(c_new);
      if (HOLD && r.mask != nullptr && !(r.mask[(size_t)t * B + b] > 0.0f)) {
        c_new = c_prev;               // hold: the padded step changes nothing
        h_new = h_sh[bb * H + j];     // h_{t-1}[b, j] (zero when unseeded at step 0)
      }
      d.c[cidx] = c_new;
      d.out[((size_t)t * B + b) * H + j] = h_new;
    }
  }
}

// All T steps on `stream`, one launch per step; the first cudaError_t seen (0 = ok).
template <bool HOLD>
int run_recurrence(const Recurrence& r, int directions, cudaStream_t stream) {
  const size_t smem = sizeof(float) * BCHUNK * (size_t)r.H;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_step_kernel<HOLD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((r.H + UNITS - 1) / UNITS, directions);
  for (int s = 0; s < r.T; ++s) {
    lstm_step_kernel<HOLD><<<grid, THREADS, smem, stream>>>(r, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// Both directions, freeze mode, zero initial state (K1, K2b). Pointers are
// device pointers; xg_* (T, B, 4H), w_* (4H, H), out_* (T, B, H), c_state
// (2, B, H) scratch, all fp32 and contiguous. Returns the first cudaError_t
// seen (0 = ok).
extern "C" int bilstm_recurrence_f32(const float* xg_f, const float* xg_b,
                                     const float* w_f, const float* w_b,
                                     float* out_f, float* out_b, float* c_state,
                                     int T, int B, int H, void* stream) {
  Recurrence r{};
  r.dir[0] = {xg_f, w_f, out_f, c_state, nullptr, nullptr, 0};
  r.dir[1] = {xg_b, w_b, out_b, c_state + (size_t)B * H, nullptr, nullptr, 1};
  r.mask = nullptr;
  r.T = T;
  r.B = B;
  r.H = H;
  return run_recurrence<false>(r, 2, static_cast<cudaStream_t>(stream));
}

// One direction (K2a, and the scan's hold mode). xg (T, B, 4H), w (4H, H),
// out (T, B, H), c_state (B, H): c after the last step on return. h0, c0
// (B, H) or null for zeros; mask (T, B) or null (no hold). fp32, contiguous.
extern "C" int lstm_recurrence_f32(const float* xg, const float* w, float* out,
                                   float* c_state, const float* h0, const float* c0,
                                   const float* mask, int T, int B, int H, int reverse,
                                   void* stream) {
  Recurrence r{};
  r.dir[0] = {xg, w, out, c_state, h0, c0, reverse != 0};
  r.dir[1] = r.dir[0];
  r.mask = mask;
  r.T = T;
  r.B = B;
  r.H = H;
  const bool hold = h0 != nullptr || c0 != nullptr || mask != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hold ? run_recurrence<true>(r, 1, st) : run_recurrence<false>(r, 1, st);
}
