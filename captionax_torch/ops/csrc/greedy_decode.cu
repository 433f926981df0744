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
//   (b1) logits_top1_partial  the product h_new . fc_w + fc_b as in (b)
//                             (decode_common.cuh: bf16 weights on wgmma,
//                             f32 on the CUDA cores), then each row's
//                             maximum of each 128-column chunk and its
//                             first argmax;
//   (c1) greedy_select        a warp a row: merges the chunk partials on redux.sync,
//                             writes the emitted token, retires the row on
//                             </s>, keeps a retired row's h and token.
//
// What bounds it on this card: per step at B=1024 the product of (b1) is
// 2*1024*200*9728 = 4 GFLOP against ~5 MB, bound by operations as (b) is.
// With bf16 weights it runs on the tensor cores through (b)'s product, h
// split into three exact bf16 terms (3x the operations; the f32 function
// of the reference, not one of bf16(h)); its epilogue takes each lane's
// (max, first argmax) of 32 logits from the accumulators and merges a
// row's quad of lanes with two shuffles.  With f32 weights it stays in f32
// on the CUDA cores.  (c1) moves ~2.3 MB (0.0007 ms at the memory's rate)
// and is bound by latency: one round of loads (the exit flag tested after
// it), one redux.sync reduction, the copy of h; it is launched with
// programmatic dependent launch (decode_kernel.GREEDY_SELECT_PDL), so that it
// is scheduled while (b1) runs.  The logits of a row never reach device
// memory: (b1) leaves 2 numbers per (row, chunk).
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
// bf16 weights: the product on wgmma (vocab::product); lane l holds 32
// logits of rows r and r + 8 in ascending column order, so a strictly
// greater logit is the lane's new first argmax; the quad of lanes
// 4 (l / 4) .. + 3 holds a row's 128 and merges under the full order.
struct Top1Epilogue {
  const float* __restrict__ fc_b;
  float* __restrict__ pv;
  int* __restrict__ pi;
  int rows, n_chunks;

  __device__ __forceinline__ void operator()(float (&acc)[64], int row_base, int chunk) const {
    const int lane = threadIdx.x & 31, q = lane & 3;
    const int row_a = row_base + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
    const int col0 = chunk * kChunk + 2 * q;
    // rows r, r + 8 x the lane's first and last 16 columns: four chains
    float bv[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
    int bi[2][2] = {{INT_MAX, INT_MAX}, {INT_MAX, INT_MAX}};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(fc_b + col0 + 8 * j));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float l0 = acc[4 * j + 2 * i] + b.x, l1 = acc[4 * j + 2 * i + 1] + b.y;
        float& v = bv[i][j / 8];
        int& x = bi[i][j / 8];
        if (l0 > v) {
          v = l0;
          x = col0 + 8 * j;
        }
        if (l1 > v) {
          v = l1;
          x = col0 + 8 * j + 1;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (bv[i][1] > bv[i][0]) {  // the last 16 columns win only when strictly greater
        bv[i][0] = bv[i][1];
        bi[i][0] = bi[i][1];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float& v = bv[i][0];
      int& x = bi[i][0];
      for (int o = 1; o < 4; o <<= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
        const int x2 = __shfl_xor_sync(0xffffffffu, x, o);
        if (ahead(v2, x2, v, x)) {
          v = v2;
          x = x2;
        }
      }
      const int row = row_a + 8 * i;
      if (q == 0 && row < rows) {
        const size_t o = (size_t)row * n_chunks + chunk;
        pv[o] = v;
        pi[o] = x;
      }
    }
  }
};

template <int S>
__global__ void __launch_bounds__(vocab::kThreads, 1) logits_top1_wgmma_kernel(
    const float* __restrict__ h, const __nv_bfloat16* __restrict__ fc_w,
    const float* __restrict__ fc_b, float* __restrict__ pv, int* __restrict__ pi,
    const int* __restrict__ live, int rows, int H, int Vp, int per_block) {
  launch_dependents();  // (c1) may be scheduled now; it waits for this grid
  if (!step_runs(live)) return;
  vocab::product<S>(h, fc_w, rows, H, Vp, per_block,
                    Top1Epilogue{fc_b, pv, pi, rows, Vp / kChunk});
}

template <int S>
int logits_top1_wgmma(const void* h, const void* fc_w, const void* fc_b, void* pv, void* pi,
                      const void* live, int rows, int H, int Vp, int per_block,
                      cudaStream_t stream) {
  int grid = 0;
  const cudaError_t err =
      vocab::setup(logits_top1_wgmma_kernel<S>, fc_w, fc_b, rows, H, Vp, per_block, grid);
  if (err != cudaSuccess) return (int)err;
  logits_top1_wgmma_kernel<S><<<grid, vocab::kThreads, vocab::smem_bytes(H), stream>>>(
      (const float*)h, (const __nv_bfloat16*)fc_w, (const float*)fc_b, (float*)pv, (int*)pi,
      (const int*)live, rows, H, Vp, per_block);
  return (int)cudaGetLastError();
}

// f32 weights: block (chunk c, row tile y), 256 threads as 16 x 16: thread (ty, tx) owns
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
// A warp a row, `warps` warps a block (decode_kernel.greedy_select_warps).
// out is [rows, max_len]; column t is written here, the columns after an
// exit keep the zeros they start with.  live[0] gates this step; live[1] is set
// while some row is not done.
//
// The row's C maxima and indices arrive in one round of 16-byte loads (a
// scalar head and tail where the row's base is not 16-byte aligned:
// row_split), with done[row]; each lane keeps its first maximum under
// (key desc, index asc), and one first_max (redux.sync max of the keys,
// then min of the indices at the maximum) gives the row's first argmax.  A
// row not done copies h_new to h as float4 (4-byte words where H % 4 != 0
// or a base is not 16-byte aligned); its first 128 float4 of h_new are
// loaded in the first round, before done[row] is known.
__global__ void __launch_bounds__(512) greedy_select_kernel(
    const float* __restrict__ pv, const int* __restrict__ pi,
    const float* __restrict__ h_new, float* __restrict__ h, int* __restrict__ tok,
    int* __restrict__ done, int* __restrict__ out, int* __restrict__ live, int rows,
    int n_chunks, int H, int max_len, int t, int end_id) {
  wait_prior_grid();
  const bool runs = step_runs(live);  // tested once the first round of loads is issued
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp

  const int was_done = done[row];
  // h_new's row is loaded before done[row] is known, so that every load is
  // in the first round; a row that is done drops it
  const bool vec =
      (H & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(h_new) | reinterpret_cast<uintptr_t>(h)) & 15) == 0;
  const int H4 = vec ? H >> 2 : 0;
  const float4* src4 = reinterpret_cast<const float4*>(h_new + (size_t)row * H);
  float4* dst4 = reinterpret_cast<float4*>(h + (size_t)row * H);
  float4 hx[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (lane + 32 * u < H4) hx[u] = src4[lane + 32 * u];
  const float* rv = pv + (size_t)row * n_chunks;
  const int* ri = pi + (size_t)row * n_chunks;
  const RowSplit sp = row_split((size_t)row * n_chunks, n_chunks);
  const float4* rv4 = reinterpret_cast<const float4*>(rv + sp.head);
  const int4* ri4 = reinterpret_cast<const int4*>(ri + sp.head);
  unsigned bk = kNoKey;
  int bi = INT_MAX;
  auto take = [&](float v, int i) {
    const unsigned k = order_key(v);
    const bool a = key_ahead(k, i, bk, bi);
    bk = a ? k : bk;
    bi = a ? i : bi;
  };
  float4 v[2];
  int4 x[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = k0 + lane + 32 * u;
      if (k < sp.body) {
        v[u] = rv4[k];
        x[u] = ri4[k];
      }
    }
  };
  auto take4 = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (k0 + lane + 32 * u < sp.body) {
        take(v[u].x, x[u].x);
        take(v[u].y, x[u].y);
        take(v[u].z, x[u].z);
        take(v[u].w, x[u].w);
      }
  };
  load(0);
  if (!runs) return;  // a closed gate: nothing is written
  take4(0);
  for (int k0 = 64; k0 < sp.body; k0 += 64) {
    load(k0);
    take4(k0);
  }
  if (lane < sp.head) take(rv[lane], ri[lane]);
  const int tl = sp.head + 4 * sp.body;
  if (lane < sp.tail) take(rv[tl + lane], ri[tl + lane]);

  unsigned kmax;
  int nxt;
  first_max(0xffffffffu, bk, bi, kmax, nxt);

  if (!was_done) {
    if (vec) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (lane + 32 * u < H4) dst4[lane + 32 * u] = hx[u];
      for (int e = lane + 128; e < H4; e += 32) dst4[e] = src4[e];
    } else {
      for (int e = lane; e < H; e += 32) h[(size_t)row * H + e] = h_new[(size_t)row * H + e];
    }
  }
  __syncwarp();  // every lane of the row has read done[row] above
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

// per_block: items (128-row tile, 128-column chunk) per block
// (decode_kernel.vocab_items_per_block)
int logits_top1_partial_bf16(const void* h, const void* fc_w, const void* fc_b, void* pv,
                             void* pi, const void* live, int rows, int H, int Vp,
                             int per_block, void* stream) {
  if (vocab::stages(H) == 8)
    return logits_top1_wgmma<8>(h, fc_w, fc_b, pv, pi, live, rows, H, Vp, per_block,
                                (cudaStream_t)stream);
  return logits_top1_wgmma<4>(h, fc_w, fc_b, pv, pi, live, rows, H, Vp, per_block,
                              (cudaStream_t)stream);
}

// warps: warps a block (decode_kernel.greedy_select_warps); pdl: launch
// with programmatic stream serialization (see wait_prior_grid)
int greedy_select(const void* pv, const void* pi, const void* h_new, void* h, void* tok,
                  void* done, void* out, void* live, int rows, int n_chunks, int H,
                  int max_len, int t, int end_id, int warps, int pdl, void* stream) {
  if (rows < 1 || n_chunks < 1 || H < 1 || warps < 1 || warps > 16 ||
      ((reinterpret_cast<uintptr_t>(pv) | reinterpret_cast<uintptr_t>(pi)) & 15))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = launch_maybe_pdl(
      greedy_select_kernel, dim3((rows + warps - 1) / warps), dim3(warps * 32), 0,
      (cudaStream_t)stream, pdl != 0, pv, pi, h_new, h, tok, done, out, live, rows, n_chunks,
      H, max_len, t, end_id);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // extern "C"
