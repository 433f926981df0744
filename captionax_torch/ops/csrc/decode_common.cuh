// Helpers shared by the decode kernels (beam_decode.cu, greedy_decode.cu).
//
// - the JAX package's constants: NEG_INF, the 128-column vocab chunk;
// - bf16/f32 loads widened to f32, warp reductions, the first-occurrence
//   order (value desc, index asc) that lax.top_k and the reference's
//   first argmax both follow;
// - the vocab product tile of (b) and (b1): h[rows, H] . fc_w[H, Vp] for a
//   64 x 128 tile through shared memory, f32 on the CUDA cores;
// - the early-exit gate: `live` points at this step's flag in a device
//   array run[max_steps + 1] (run[0] = 1, the rest 0); every kernel of step
//   t returns at entry when run[t] == 0, and the select kernel of step t
//   stores 1 into run[t + 1] when some row can still change the outputs.
//   Readers of run[t] and the writer of run[t + 1] never touch the same
//   word in one launch, so the flag needs no reset and no host read.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace decode {

constexpr float kNegInf = -1e9f;  // the JAX package's NEG_INF
constexpr int kChunk = 128;       // vocab columns per partial (block width of (b), (b1))
constexpr int kRowTile = 64;      // rows per block of (b), (b1)
constexpr int kBK = 8;            // depth step of the product's shared-memory tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// (va, ia) ranks before (vb, ib): a greater value, or an equal value at a
// lower index (the first occurrence).
__device__ __forceinline__ bool ahead(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// True when this step runs: no gate, or the gate's flag is set.
__device__ __forceinline__ bool step_runs(const int* live) {
  return live == nullptr || *live != 0;
}

// acc[m][n] = sum_k h[row0 + ty + 16m, k] * fc_w[k, col0 + tx + 16n] for the
// block's 64 x 128 tile; 256 threads as 16 x 16 (tx = tid & 15, ty = tid >> 4).
// Rows past `rows` read zeros.
template <typename W>
__device__ __forceinline__ void vocab_tile_product(
    const float* __restrict__ h, const W* __restrict__ fc_w, int rows, int H, int Vp,
    int row0, int col0, float (&acc)[4][8]) {
  __shared__ float As[kBK][kRowTile];
  __shared__ float Bs[kBK][kChunk];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;

  for (int k0 = 0; k0 < H; k0 += kBK) {
    for (int e = tid; e < kRowTile * kBK; e += 256) {
      const int r = e / kBK, kk = e % kBK, gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < rows && gk < H) ? h[(size_t)gr * H + gk] : 0.f;
    }
    for (int e = tid; e < kBK * kChunk; e += 256) {
      const int kk = e / kChunk, c = e % kChunk, gk = k0 + kk;
      Bs[kk][c] = gk < H ? to_f(fc_w[(size_t)gk * Vp + col0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = As[kk][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < 8; ++n) b[n] = Bs[kk][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] += a[m] * b[n];
    }
    __syncthreads();
  }
}

}  // namespace decode
