// K2 for Hopper: one step of the styled greedy decode, as three kernels.
//
// Replaces the TPU kernel `_greedy_kernel` (captionax/ops/decode_kernel.py,
// launched by `fused_greedy`), which runs a whole greedy decode of up to
// max_len steps in one Pallas launch with the weights resident in VMEM.  As
// for K1 (beam_decode.cu), the weights stay in device memory / L2 and a host
// loop issues one step as three launches on the current stream:
//
//   (a)  cell_step            beam_decode.cu's cell kernel with one row per
//                             image and the embedding of token 0 at t=0;
//   (b1) logits_top1_partial  grid (vocab chunk of 128, row tile of 64): the
//                             product h_new . fc_w[:, chunk] + fc_b (the tile
//                             of (b), decode_common.cuh), then each row's
//                             maximum of the chunk and its first argmax;
//   (c1) greedy_select        one warp per row: merges the chunk partials,
//                             writes the emitted token, retires the row on
//                             </s>, keeps a retired row's h and token.
//
// What bounds it on this card: per step at B=1024 the product of (b1) is
// 2*1024*200*9728 = 4 GFLOP against ~5 MB, bound by operations as (b) is,
// and done in f32 on the CUDA cores (bf16 weights are widened on load);
// (c1) moves ~2.4 MB.  The logits of a row never reach device memory: (b1)
// leaves 2 numbers per (row, chunk).
//
// Semantics held to the reference: the merge keeps the greater value and,
// on equal values, the lower index, which is the global first argmax of the
// logits (the reference's "a later chunk wins only if strictly greater",
// decode_kernel.py:289-307).  Then emit = done ? 0 : next; done |= next ==
// end_id; a row that was done keeps h and its token.  The launch does not
// pad the batch, so no padding row can hold the exit back.
//
// Early exit (decode_kernel.py:381-394): (c1) of step t sets run[t + 1]
// while some row is not done, and every kernel of step t + 1 returns at
// entry when it is 0 (decode_common.cuh).  The tokens after the exit are
// the <pad> the output already holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "decode_common.cuh"

namespace {

using namespace decode;

// ---------------------------------------------------------------- (b1)
// Block (chunk c, row tile y), 256 threads as 16 x 16: thread (ty, tx) owns
// rows ty + 16m (m < 4) and columns tx + 16n (n < 8); the 16 threads of a
// row (one half-warp) merge their (max, first argmax) with shuffles.
template <typename W>
__global__ void __launch_bounds__(256) logits_top1_partial_kernel(
    const float* __restrict__ h, const W* __restrict__ fc_w,
    const float* __restrict__ fc_b, float* __restrict__ pv, int* __restrict__ pi,
    const int* __restrict__ live, int rows, int H, int Vp) {
  if (!step_runs(live)) return;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int col0 = chunk * kChunk, row0 = blockIdx.y * kRowTile;
  float acc[4][8];
  vocab_tile_product<W>(h, fc_w, rows, H, Vp, row0, col0, acc);

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = row0 + ty + 16 * m;
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = col0 + tx + 16 * n;
      const float l = acc[m][n] + fc_b[col];
      if (ahead(l, col, bv, bi)) {
        bv = l;
        bi = col;
      }
    }
    for (int o = 8; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, bv, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ahead(v2, i2, bv, bi)) {
        bv = v2;
        bi = i2;
      }
    }
    if (tx == 0 && row < rows) {
      const size_t o = (size_t)row * n_chunks + chunk;
      pv[o] = bv;
      pi[o] = bi;
    }
  }
}

// ---------------------------------------------------------------- (c1)
// One warp per row, 4 rows per block.  out is [rows, max_len]; column t is
// written here, the columns after an exit keep the zeros they start with.
// live[0] gates this step; live[1] is set while some row is not done.
__global__ void __launch_bounds__(128) greedy_select_kernel(
    const float* __restrict__ pv, const int* __restrict__ pi,
    const float* __restrict__ h_new, float* __restrict__ h, int* __restrict__ tok,
    int* __restrict__ done, int* __restrict__ out, int* __restrict__ live, int rows,
    int n_chunks, int H, int max_len, int t, int end_id) {
  if (!step_runs(live)) return;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp

  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int c = lane; c < n_chunks; c += 32) {
    const size_t o = (size_t)row * n_chunks + c;
    const float v = pv[o];
    const int i = pi[o];
    if (ahead(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, bv, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ahead(v2, i2, bv, bi)) {
      bv = v2;
      bi = i2;
    }
  }
  const int nxt = bi;
  const int was_done = done[row];
  if (!was_done) {
    const float* src = h_new + (size_t)row * H;
    float* dst = h + (size_t)row * H;
    for (int e = lane; e < H; e += 32) dst[e] = src[e];
  }
  __syncwarp();  // every lane has read done[row] above
  if (lane == 0) {
    const int now_done = was_done || nxt == end_id;
    out[(size_t)row * max_len + t] = was_done ? 0 : nxt;
    done[row] = now_done;
    if (!was_done) tok[row] = nxt;
    if (!now_done && live != nullptr) live[1] = 1;
  }
}

template <typename W>
int logits_top1_entry(const void* h, const void* fc_w, const void* fc_b, void* pv, void* pi,
                      const void* live, int rows, int H, int Vp, void* stream) {
  if (Vp % kChunk) return (int)cudaErrorInvalidValue;
  const dim3 grid(Vp / kChunk, (rows + kRowTile - 1) / kRowTile);
  logits_top1_partial_kernel<W><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)h, (const W*)fc_w, (const float*)fc_b, (float*)pv, (int*)pi,
      (const int*)live, rows, H, Vp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int logits_top1_partial_f32(const void* h, const void* fc_w, const void* fc_b, void* pv,
                            void* pi, const void* live, int rows, int H, int Vp,
                            void* stream) {
  return logits_top1_entry<float>(h, fc_w, fc_b, pv, pi, live, rows, H, Vp, stream);
}

int logits_top1_partial_bf16(const void* h, const void* fc_w, const void* fc_b, void* pv,
                             void* pi, const void* live, int rows, int H, int Vp,
                             void* stream) {
  return logits_top1_entry<__nv_bfloat16>(h, fc_w, fc_b, pv, pi, live, rows, H, Vp,
                                          stream);
}

int greedy_select(const void* pv, const void* pi, const void* h_new, void* h, void* tok,
                  void* done, void* out, void* live, int rows, int n_chunks, int H,
                  int max_len, int t, int end_id, void* stream) {
  const dim3 grid((rows + 3) / 4);
  greedy_select_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const float*)pv, (const int*)pi, (const float*)h_new, (float*)h, (int*)tok,
      (int*)done, (int*)out, (int*)live, rows, n_chunks, H, max_len, t, end_id);
  return (int)cudaGetLastError();
}

}  // extern "C"
