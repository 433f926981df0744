// Helpers shared by the decode kernels (beam_decode.cu, greedy_decode.cu).
//
// - the JAX package's constants: NEG_INF, the 128-column vocab chunk;
// - bf16/f32 loads widened to f32, warp reductions, the first-occurrence
//   order (value desc, index asc) that lax.top_k and the reference's
//   first argmax both follow;
// - the vocab products of (b) and (b1), h[rows, H] . fc_w[H, Vp]: with f32
//   weights a 64 x 128 tile through shared memory, f32 on the CUDA cores
//   (vocab_tile_product); with bf16 weights 128-row tiles on the tensor
//   cores, h split into three exact bf16 terms (vocab::product, wgmma),
//   that hand each 128-column chunk's f32 accumulators to an epilogue;
// - the select kernels' warp reductions (order_key, first_max on
//   redux.sync), the 16-byte split of a row of partials (row_split), and
//   programmatic dependent launch (wait_prior_grid, launch_maybe_pdl);
// - the early-exit gate: `live` points at this step's flag in a device
//   array run[max_steps + 1] (run[0] = 1, the rest 0); every kernel of step
//   t returns at entry when run[t] == 0 (the select kernels once their
//   first round of loads is issued, having written nothing), and the select
//   kernel of step t stores 1 into run[t + 1] when some row can still change
//   the outputs.
//   Readers of run[t] and the writer of run[t + 1] never touch the same
//   word in one launch, so the flag needs no reset and no host read.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "wgmma_common.cuh"

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

// ---------------------------------------------------------------- selection
// The select kernels (c) and (c1) merge per-chunk partials with warp
// reductions on redux.sync, which compare 32-bit integers.
//
// order_key(x) is an unsigned key whose order is x's: key(a) > key(b)
// exactly when a > b, with -0.0 and +0.0 one value (the reference's compare)
// and -inf (key 0x007FFFFF) below every finite value; kNoKey = 0 stands for
// "no candidate" and ranks below all of them.  NaN is not ordered.  The
// order (value desc, index asc) of `ahead` is then (key desc, index asc):
// the maximum key over the lanes, then the least index among the lanes that
// hold it.
constexpr unsigned kNoKey = 0u;

__device__ __forceinline__ unsigned order_key(float x) {
  unsigned b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;  // -0.0 -> +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ bool key_ahead(unsigned ka, int ia, unsigned kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// The first of the lanes of `mask` under (key desc, index asc), on every lane
// of the mask: its key and index.
__device__ __forceinline__ void first_max(unsigned mask, unsigned key, int idx, unsigned& kmax,
                                          int& imin) {
  kmax = __reduce_max_sync(mask, key);
  imin = __reduce_min_sync(mask, key == kmax ? idx : INT_MAX);
}

// A row's n partials from element `off` of arrays whose bases are 16-byte
// aligned: `head` scalars up to the first 16-byte boundary, `body` 16-byte
// vectors, `tail` scalars (decode_kernel.row_split).
struct RowSplit {
  int head, body, tail;
};

__device__ __forceinline__ RowSplit row_split(size_t off, int n) {
  const int head = min(n, (int)((4 - (off & 3)) & 3));
  const int body = (n - head) >> 2;
  return {head, body, n - head - 4 * body};
}

// Programmatic dependent launch: a kernel launched with the
// programmatic-serialization attribute may start before the kernel ahead of
// it ends; it waits here, before it reads anything, until that kernel has
// finished and its writes are visible.  Without the attribute, a no-op.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Lets the kernel that follows this one on the stream, when it is launched
// with the attribute, be scheduled now (it waits in wait_prior_grid).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// Launches `kernel`, with programmatic stream serialization when `pdl` is set.
template <typename... Params, typename... Args>
cudaError_t launch_maybe_pdl(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                             cudaStream_t stream, bool pdl, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
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


// ---------------------------------------------------------------- wgmma
// The bf16 vocab product of (b) and (b1) on the tensor cores.
//
// The function is the JAX reference's: h_new in f32 times fc_w in bf16,
// promoted to f32.  h is split into three bf16 terms, hi = bf16(h),
// mid = bf16(h - hi), lo = bf16(h - hi - mid).  Each difference is exact in
// f32 and each term holds 8 of h's 24 significant bits, so hi + mid + lo
// == h for every normal f32 (bf16 has f32's exponent range).  A product of
// two bf16 numbers is exact in f32, so the three products of the terms
// with one fc_w tile, summed into one f32 accumulator, give the f32
// product up to the order of the sums.  The tensor cores do 3x the
// function's operations, on the zero-padded depth Kp = H rounded up to 16
// (and to 32 for the ring's stages: 3 * 224 / 200 = 3.36x at H = 200).
//
// A block holds 128 rows (two warpgroups of 64) and walks `per_block`
// consecutive items (row tile, 128-column chunk), row-tile-major, so that it
// splits its rows' h once per row tile and reuses them for every chunk.
//   A: the split h in shared memory, K-major in the 128-byte swizzle, as one
//      operand [128, 3 Kp] = [hi | mid | lo], each term zero past H.  Its
//      k16 slices (32 bytes of a row) are packed four to a 128-byte atom row
//      (10 atoms of 16 KB at H = 200), and one more slice of zeros stands
//      for depths Kp .. Kp + 15 when Kp / 16 is odd.  Only rows below `rows`
//      are split: a row past it feeds only outputs that are not stored.
//   B: fc_w [H, Vp] as packed (N-major, read as a transposed operand),
//      through a ring of S stages of 32 depth rows x 128 columns (two
//      64-column blocks of 4 KB), two 16-byte cp.async copies per thread and
//      stage, zeros from H on.  S - 2 stages are in flight; the ring runs
//      across items, so the next chunk's first stages load during this
//      chunk's epilogue.
// Per stage, the three terms' products of its two k16 slices (six wgmma,
// one commit group) share the stage's B; wgmma.wait_group 1 frees the
// stage before.  No product sits on a branch (ptxas serializes wgmma
// on a path it cannot prove uniform): the missing slice of an odd Kp / 16
// is the zero slice, and a warpgroup whose rows all lie past `rows`
// multiplies what its shared memory holds.  After a chunk's last stage
// every product is waited for and epi(acc, first row of the warpgroup,
// chunk) runs from the registers.
//
// The accumulators (m64n128, f32): lane l of warp w of a warpgroup holds
// rows w * 16 + l / 4 and that + 8; acc[4 j + 2 i + e] is row + 8 i, column
// 8 j + 2 (l % 4) + e of the chunk.  A row's 128 columns lie in one quad,
// and a lane meets its 32 columns in ascending order when it walks j, then e.
namespace vocab {

using namespace hopper;

constexpr int kRows = 128;                  // rows per block: two warpgroups
constexpr int kThreads = 256;
constexpr int kColBlock = 32 * 128;         // 32 depth rows of 64 columns, 4 KB
constexpr int kStageBytes = 2 * kColBlock;  // 32 depths of a 128-column chunk, 8 KB
constexpr int kAtomBytes = kRows * 128;     // 64 depths of A for 128 rows, 16 KB
constexpr int kMaxH = 256;                  // 12 atoms of A and a 4-stage ring: 225 KB

__host__ __device__ constexpr int slices(int H) { return (H + 15) / 16; }  // k16 slices a term
// A's k16 slices: three terms, and the zero slice when a term's count is odd
__host__ __device__ constexpr int a_atoms(int H) {
  return (3 * slices(H) + slices(H) % 2 + 3) / 4;
}
// the ring's stages: 8 while A takes at most 10 atoms, else 4
__host__ __device__ constexpr int stages(int H) { return a_atoms(H) <= 10 ? 8 : 4; }
// A, the ring, and 1 KB to align them (the swizzle repeats every 1024 bytes)
__host__ __device__ constexpr int smem_bytes(int H) {
  return a_atoms(H) * kAtomBytes + stages(H) * kStageBytes + 1024;
}
__host__ __device__ constexpr int items(int rows, int Vp) {
  return (rows + kRows - 1) / kRows * (Vp / kChunk);
}

// the bit patterns of x's bf16 terms hi, mid, lo
__device__ __forceinline__ void split3(float x, unsigned (&t)[3]) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hi);
  const __nv_bfloat16 mid = __float2bfloat16_rn(r);
  const __nv_bfloat16 lo = __float2bfloat16_rn(r - __bfloat162float(mid));
  t[0] = __bfloat16_as_ushort(hi);
  t[1] = __bfloat16_as_ushort(mid);
  t[2] = __bfloat16_as_ushort(lo);
}

// A's 16 bytes at k16 slice `sl`, half `half`, of row r
__device__ __forceinline__ uint4* a_chunk(unsigned char* a, int sl, int half, int r) {
  const int c = (sl & 3) * 2 + half;
  return reinterpret_cast<uint4*>(a + (sl >> 2) * kAtomBytes + r * 128 + ((c ^ (r & 7)) << 4));
}

// The real rows among row0 .. row0 + 127 of h, split, into A (`a`: its
// first atom); nk slices a term.  Four 8-depth groups a thread are loaded
// before any is split, so that their loads are in flight together.
__device__ __forceinline__ void split_rows(const float* __restrict__ h, int rows, int H,
                                           int nk, int row0, unsigned char* a) {
  const int groups = nk * 2;  // 8 depths: one 16-byte chunk of a term's row
  const int n = min(kRows, rows - row0) * groups;
  for (int e0 = threadIdx.x; e0 < n; e0 += 4 * kThreads) {
    float x[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kThreads, r = e / groups, g = e - r * groups;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[u][j] = e < n && g * 8 + j < H ? h[(size_t)(row0 + r) * H + g * 8 + j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kThreads, r = e / groups, g = e - r * groups;
      if (e >= n) break;
      unsigned w[3][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        unsigned t0[3], t1[3];
        split3(x[u][2 * p], t0);
        split3(x[u][2 * p + 1], t1);
#pragma unroll
        for (int t = 0; t < 3; ++t) w[t][p] = t0[t] | (t1[t] << 16);
      }
#pragma unroll
      for (int t = 0; t < 3; ++t)
        *a_chunk(a, t * nk + g / 2, g % 2, r) = make_uint4(w[t][0], w[t][1], w[t][2], w[t][3]);
    }
  }
}

// Block blockIdx.x's items of h[rows, H] . fc_w[H, Vp] (see above) through a
// ring of S stages; epi is called per item by each warpgroup.
template <int S, class Epi>
__device__ __forceinline__ void product(const float* __restrict__ h,
                                        const __nv_bfloat16* __restrict__ fc_w, int rows,
                                        int H, int Vp, int per_block, const Epi& epi) {
  constexpr int kDist = S - 2;  // stages between a copy and its products
  extern __shared__ unsigned char vocab_smem[];
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nk = slices(H), ns = (nk + 1) / 2, zero = 3 * nk;  // slices, stages an item
  const int n_chunks = Vp / kChunk, item0 = blockIdx.x * per_block;
  const int n_items = max(0, min(per_block, items(rows, Vp) - item0)), total = n_items * ns;
  const uint32_t pad = (1024u - (smem_addr(vocab_smem) & 1023u)) & 1023u;
  unsigned char* a = vocab_smem + pad;
  const uint32_t sA = smem_addr(a), ring = sA + a_atoms(H) * kAtomBytes;
  if (nk % 2)
    for (int e = tid; e < 2 * kRows; e += kThreads) *a_chunk(a, zero, e & 1, e >> 1) = uint4{};

  // Loads the next stage (number lg, in order): depth rows 32 ls .. + 31 of
  // the chunk at column lcol, into ring slot lg % S; 32 rows x 16 chunks of
  // 16 bytes, two a thread.
  int lg = 0, ls = 0, lcol = item0 % n_chunks * kChunk;
  auto load = [&]() {
    const uint32_t dst = ring + lg % S * kStageBytes;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int kr = (tid >> 4) + 16 * p, cn = tid & 15, k = ls * 32 + kr;
      const bool ok = k < H;
      cp_async16(dst + (cn >> 3) * kColBlock + kr * 128 + (((cn & 7) ^ (kr & 7)) << 4),
                 ok ? fc_w + (size_t)k * Vp + lcol + cn * 8 : fc_w, ok);
    }
    ++lg;
    if (++ls == ns) {
      ls = 0;
      lcol = lcol + kChunk == Vp ? 0 : lcol + kChunk;
    }
  };

#pragma unroll
  for (int s = 0; s < kDist; ++s) {
    if (s < total) load();
    cp_async_commit();
  }
  float acc[64];
  int tile = -1, g = 0;
  for (int it = 0; it < n_items; ++it) {
    const int item = item0 + it, row0 = item / n_chunks * kRows;
    if (row0 != tile) {  // uniform across the block
      __syncthreads();   // every product of the previous row tile is done
      split_rows(h, rows, H, nk, row0, a);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      tile = row0;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int st = 0; st < ns; ++st, ++g) {
      cp_async_wait<kDist - 1>();  // this thread's copies of stage g have landed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // everyone's copies of g are in; the products of g - 2 are done
      if (g + kDist < total) load();  // stage g + kDist
      cp_async_commit();
      const uint32_t sB = ring + g % S * kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int ks = 2 * st + kk;                   // depths 16 ks .. 16 ks + 15
          const int sl = ks < nk ? t * nk + ks : zero;  // A's slice (a select, no branch)
          mma<128>(acc, desc(sA + (sl >> 2) * kAtomBytes + wg * 8192 + (sl & 3) * 32, 16, 1024),
                   desc(sB + kk * 2048, kColBlock, 1024));
        }
      wgmma_commit();
      wgmma_wait<1>();  // the products of stage g - 1 are done: it may be refilled
    }
    wgmma_wait<0>();
    fence_acc(acc);
    epi(acc, row0 + wg * 64, item % n_chunks);
  }
}

// Checks a launch of a kernel that runs `product` (fc_w is read 16 bytes
// and fc_b 8 bytes at a time) and sets its shared memory; -> cudaSuccess
// and the grid, or the error.
template <typename Kernel>
cudaError_t setup(Kernel* kernel, const void* fc_w, const void* fc_b, int rows, int H, int Vp,
                  int per_block, int& grid) {
  if (Vp % kChunk || H < 1 || H > kMaxH || rows < 1 || per_block < 1 ||
      reinterpret_cast<uintptr_t>(fc_w) % 16 || reinterpret_cast<uintptr_t>(fc_b) % 8)
    return cudaErrorInvalidValue;
  grid = (items(rows, Vp) + per_block - 1) / per_block;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(H));
}

}  // namespace vocab

}  // namespace decode
