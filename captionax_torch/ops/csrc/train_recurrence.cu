// K3 for Hopper: the teacher-forced attention-GRU recurrence of training,
// forward and backward (BPTT), for the autograd Function of
// captionax_torch/ops/train_kernel.py.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel`
// (captionax/ops/train_kernel.py, launched by `_fused_fwd_call` and
// `_fused_core_bwd`), which hold the whole T-step loop of a row tile in VMEM
// and accumulate the weight gradients into one output block that every
// (sequential) grid step revisits.  Five kernels here:
//
//   train_fwd             one launch for all T steps: a thread-block
//                         cluster of C CTAs per tile of M = 8 C rows (see
//                         "The recurrence kernels" below); hs[B, T, H] (f32)
//                         is written per step.
//   train_bwd_recurrence  one launch, the same clusters, the exact BPTT in
//                         reverse time, each step recomputed from h_{t-1}
//                         (read from hs).  It writes the per-row gradients
//                         (d_att1, accumulated in the compute type by a
//                         read-modify-write of the row's own slice, no
//                         atomics; d_h0; d_emb shifted back a step), the
//                         operands of the d_feats fold (the attention
//                         weights w_t and the rounded dctx_t of every step),
//                         for every (step t, row b) the operands of the
//                         weight gradients as row n = t*B + b of X = [word,
//                         ctx], dGI, Hprev, dGH_n and dATT2 (f32), and one
//                         partial of d(v_a) per 8 rows.
//   train_feats_fold      d_feats = the fold over t = T-1 .. 0 of
//                         d <- rnd(d + rnd(rnd(w_t) dctx_t)): the order and
//                         roundings of the JAX kernel's per-step sum, once
//                         per element instead of a read-modify-write of
//                         [B, R, F] at every step.  Bound by bytes (65.6 MB
//                         in f32 at B=1024, T=25), then by its separate mul
//                         and add; each item (an image's slice of regions)
//                         is copied to shared memory once, while the item
//                         before folds, where the first design read w_t
//                         and dctx_t from L1/L2 at every step for every
//                         region and feature (~1.25 GB; at "the fold").
//   train_wgrad_partial   the weight gradients as products over all T*B
//                         rows, [X|1]^T dGI, [Hprev|1]^T [dGI_rz|dGH_n] and
//                         [Hprev|1]^T dATT2 (the ones column gives the bias
//                         gradients): a pipelined f32 GEMM in 128 x 128
//                         output tiles, each over one of `splits` chunks of
//                         rows, into partials (design at pass 2 below).
//   train_wgrad_reduce    sums the partials over the chunks, and d(v_a)
//                         over the 8-row blocks, in a fixed order: the
//                         gradients are deterministic.
//
// What bounds it on this card.  Hopper's blocks run in parallel in no order,
// and d(w_ih) alone is 400 x 600 f32 (960 KB), beyond a block's 227 KB of
// shared memory, so the TPU's revisited accumulator becomes the second pass
// over rows in device memory (about 200 MB at B=1024, T=25).  Per row and
// step the recurrence does ~0.85 MFLOP (U_a, w_ih, w_hh products and the
// 49-region attention) forward and about twice that backward, 22 and 44
// GFLOP at B=1024, T=25, plus 0.25 G tanh per pass; att1 and feats (80 MB
// in f32) are read at every step.  Pass 2 is 20.6 GFLOP of f32 products at
// B=1024, T=25 (0.31 ms at the 67 TFLOP/s f32 peak), which the JAX kernel
// takes in f32 too.
//
// The recurrence kernels.  A cluster of C CTAs (C = 2, 4 or 8, launched with
// cudaLaunchKernelEx and a cluster dimension; train_kernel.cluster_shape
// picks C from what cudaOccupancyMaxActiveClusters reports) takes M = 8 C
// rows.  Its CTAs split the H / 8 groups of 8 hidden units (CTA c holds
// groups c U / C .. (c + 1) U / C - 1), each group's r, z and n columns side
// by side, and the rows of the attention, 8 a CTA.  A step of the forward:
//   1. [gh | att2] = rnd(h) [w_hh^T | U_a] for the CTA's groups and all M
//      rows (one product: a group's r, z, n and U_a columns are 32 columns
//      of the packed `wh`);
//   2. cluster barrier; each CTA copies its 8 rows' att2 from the owners of
//      the columns (distributed shared memory) and runs the attention for
//      them: scores, softmax, context;
//   3. cluster barrier; each CTA copies [word | ctx] of all M rows (the
//      words from device memory, the contexts from their rows' CTAs);
//      gi = rnd(x) w_ih^T for its groups, then the GRU from gi and gh;
//   4. cluster barrier; each CTA copies the new h of all M rows from the
//      owners of the units.
// The backward recomputes 1-3 and then reverses them with the same slices
// in the other direction: dx = dgi w_ih and dh = [dgh | datt2] [w_hh | U_a^T]
// (the packed `wxr`, `whr`: the transposes) are partial sums over the CTA's
// groups, added across the cluster through distributed shared memory in
// rank order (so the gradients are deterministic): dx for each CTA's 8 rows
// (the word part, then the context part, through one [M, max(E, F, H)]
// buffer), dh for each CTA's own units; between them the attention
// backward of the CTA's rows.  7 cluster barriers a step backward, 3 forward.
// Products: bf16 weights on the tensor cores, mma.sync m16n8k16 with f32
// accumulators, one bf16 term per operand (the JAX kernel rounds every
// product operand to the compute type, so the products are exact), A from
// shared memory by ldmatrix, B as fragments packed once per call
// (train_kernel.pack_recurrence) read from L2 by __ldg, a batch of k16
// tiles ahead; f32 weights as register-tiled FMAs on the CUDA cores (no
// TF32: the JAX kernel's f32 function), the slice streamed from L2 through
// a cp.async ring in shared memory (fma_product).  Each CTA reads its 1/C
// of the weights once per step and product: the whole weight set once per M
// rows and step (4 rows before).  The attention reads att1 and feats with
// 16-byte loads, several regions' loads in flight; d_att1 is accumulated in
// device memory per step (its term needs the tanh again).  Measured on the
// H100 (PERF.md): at B=1024 the card runs 66 clusters of 2 at once, 30 of 4
// and 15 of 8, so M = 16; with one 256-thread CTA an SM (~250 registers a
// thread), the scores' tanhf chains run latency-bound, and the f32 products
// are bound by shared-memory wavefronts.
//
// Rounding.  The kernels round to the compute type W where the JAX kernel
// keeps a value in it (rnd<W>): att2, the attention temporaries, the scores
// and context, the operands of the products, dctx, ds, da, d(pre-tanh), and
// the d_feats / d_att1 accumulators; sums are taken in f32 and rounded at
// their end.  For W = float every rnd is the identity.
//
// Plain C interface, loaded with ctypes; every entry returns
// cudaGetLastError() after its launches.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

#include "decode_common.cuh"

namespace {

using namespace decode;
namespace cg = cooperative_groups;

template <typename W>
struct Cvt {
  __device__ static float rnd(float x) { return x; }
  __device__ static float to_w(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  __device__ static float rnd(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  __device__ static __nv_bfloat16 to_w(float x) { return __float2bfloat16_rn(x); }
};

// 16 bytes of W: load (read-only, through the texture path or plain) and
// store (rounded to W), widened to f32.
template <typename W>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void ldg(const float* p, float (&v)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
  __device__ static void ld(const float* p, float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
  __device__ static void st(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& x, float (&v)[8]) {
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void ldg(const __nv_bfloat16* p, float (&v)[8]) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
  __device__ static void ld(const __nv_bfloat16* p, float (&v)[8]) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  __device__ static unsigned pair(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  __device__ static void st(__nv_bfloat16* p, const float (&v)[8]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pair(v[0], v[1]), pair(v[2], v[3]), pair(v[4], v[5]), pair(v[6], v[7]));
  }
};

// four values of W at p (16-byte aligned for f32, 8 for bf16), rounded to W
__device__ __forceinline__ void put4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void put4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(Vec<__nv_bfloat16>::pair(v.x, v.y), Vec<__nv_bfloat16>::pair(v.z, v.w));
}

// n (a multiple of 4) floats of shared memory at p (16-byte aligned): whole
// 16-byte loads, so that a warp reading consecutive chunks has no bank
// conflicts (a float a lane at a stride of n would have n-way ones)
template <int n>
__device__ __forceinline__ void ld_floats(const float* p, float (&v)[n]) {
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    v[i] = x.x, v[i + 1] = x.y, v[i + 2] = x.z, v[i + 3] = x.w;
  }
}

// ================================================================ the recurrence
namespace rec {

constexpr int kThreads = 256, kWarps = 8;
constexpr int kRowsA = 8;  // rows of the attention a CTA: a cluster of C CTAs takes M = 8 C
constexpr int kUnits = 8;  // hidden units of a group
constexpr int kStages = 4, kDepth = 8;  // f32 weights: a ring of 4 stages of 8 rows
constexpr int kMaxH = 256;  // widest H and F: a lane holds 2 (f32) or 1 (bf16) 16-byte chunks of a row
constexpr int kPairs = 4;   // (row, region) pairs a warp scores at once, their loads together
constexpr int kRegions = 8; // regions of the context whose feats load together
// `skip` bits: a part left out of every step, to time the parts; the output
// is then not the function
constexpr int kSkipAttention = 1;      // scores, softmax, context
constexpr int kSkipGates = 2;          // the h and x products and the GRU (and its backward)
constexpr int kSkipReverse = 4;        // the dx and dh products and their sums across the cluster
constexpr int kSkipAttentionBack = 8;  // the attention backward
constexpr int kSkipScores = 16;        // of the attention: the scores alone
constexpr int kSkipContext = 32;       // of the attention: the context alone

__host__ __device__ constexpr int ktiles(int n) { return (n + 15) / 16; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int take(int& off, int bytes) {
  const int o = off;
  off += (bytes + 15) & ~15;
  return o;
}

// The first group of CTA c, and the CTA that holds group u: groups
// c U / C .. (c + 1) U / C - 1 (a CTA may hold none when U < C).
__host__ __device__ inline int group_start(int c, int C, int U) { return c * U / C; }
__host__ __device__ inline int group_owner(int u, int C, int U) { return ((u + 1) * C - 1) / U; }

// Shared memory of a CTA (byte offsets; row strides in elements).  A
// operands of the products are row-major in W: ah = rnd(h) [M][ldh], ax =
// rnd([word | ctx]) [M][ldx] (the backward's partial sums P [M][ldp] f32
// take its place once x is used), adg_i / adg_h = rnd(dgi) / rnd([dgh |
// datt2]) [M][ldg] in the packed column order (per group r, z, n and a 4th
// slot: zero for dgi, datt2 for dgh).  bf16 rows carry 8 values of padding
// (a row stride of an odd multiple of 16 bytes: ldmatrix without bank
// conflicts), f32 rows 4.  gh [M][NG 24] (+ b_hh) and hown [M][NG 8] (h of
// the own units, f32), dh [M][NG 8] (dL/dh of the own units), a2 (att2 of
// the own units [M][NG 8], read by the peers; backward: then datt2 of the 8
// rows [8][H]), xpub (the 8 rows' contexts [8][F], read by the peers;
// backward: then dctx [8][F] and the d(v_a) terms [8][H]), att2 [8][H] of
// the 8 rows, the scores / weights w, dw and ds [8][Rp], d(v_a) [H],
// rnd(v_a) [H]; f32: the ring of the weights' stages (fma_product).
struct Layout {
  int ldh, ldx, ldg, ldp, ldr, ng;
  int ah, ax, adg_i, adg_h, gh, hown, dh, a2, xpub, att2, w, dw, ds, dva, vac, ring, total;
};

__host__ __device__ inline Layout layout(bool bwd, bool bf16, int C, int R, int F, int E, int H) {
  Layout L;
  const int ws = bf16 ? 2 : 4;
  const int M = kRowsA * C, U = H / kUnits, NG = (U + C - 1) / C, In = E + F;
  const int Rp = (R + 3) & ~3;
  L.ng = NG;
  L.ldh = bf16 ? ktiles(H) * 16 + 8 : H + 4;
  L.ldx = bf16 ? ktiles(In) * 16 + 8 : In + 4;
  L.ldg = NG * 32 + (bf16 ? 8 : 4);
  L.ldp = imax(E, imax(F, H)) + 4;
  int off = 0;
  L.ah = take(off, M * L.ldh * ws);
  L.ax = take(off, imax(M * L.ldx * ws, bwd ? M * L.ldp * 4 : 0));
  L.adg_i = bwd ? take(off, M * L.ldg * ws) : 0;
  L.adg_h = bwd ? take(off, M * L.ldg * ws) : 0;
  L.gh = take(off, M * NG * 24 * 4);
  L.hown = take(off, M * NG * 8 * 4);
  L.dh = bwd ? take(off, M * NG * 8 * 4) : 0;
  L.a2 = take(off, imax(M * NG * 8, bwd ? kRowsA * H : 0) * 4);
  L.xpub = take(off, kRowsA * (F + (bwd ? H : 0)) * 4);
  L.att2 = take(off, kRowsA * H * 4);
  L.w = take(off, kRowsA * Rp * 4);
  L.dw = bwd ? take(off, kRowsA * Rp * 4) : 0;
  L.ds = bwd ? take(off, kRowsA * Rp * 4) : 0;
  L.dva = bwd ? take(off, H * 4) : 0;
  L.vac = take(off, H * 4);
  L.ldr = imax(NG * 32, imax(E, imax(F, H)));
  L.ring = bf16 ? 0 : take(off, kStages * kDepth * L.ldr * 4);
  L.total = off;
  return L;
}

// d += a . b on the tensor cores, bf16 in, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint4& a, const uint2& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void ldmatrix4(uint4& a, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a.x), "=r"(a.y), "=r"(a.z), "=r"(a.w)
               : "r"(addr));
}

// out = A . B on the tensor cores for the M rows of A (bf16, row-major at
// shared address a_base, lda_bytes a row) over `kts` k16 tiles, into tasks
// of NT consecutive n8 tiles: task i takes n8 tiles nt0 + i NT .. + NT - 1
// of B, whose fragments `bpk` holds as mma.sync B fragments [KT][nt_tot][32
// lanes] (train_kernel.pack_recurrence), k16 tiles from kt0.  A warp takes
// tasks warp, warp + 8, ...; epi(task, acc) gets the f32 accumulators in the
// mma C layout (lane l: c0, c1 = row l/4, columns 2 (l%4) + 0, 1; c2, c3 =
// row l/4 + 8).  B fragments load in batches of KB k16 tiles, the next
// batch during this one's products.
template <int MT, int NT, class Epi>
__device__ __forceinline__ void mma_product(uint32_t a_base, int lda_bytes, int kts,
                                            const uint2* __restrict__ bpk, int nt_tot, int kt0,
                                            int nt0, int tasks, Epi epi) {
  constexpr int KB = NT >= 3 ? 4 : 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t a_lane = a_base + (lane & 15) * lda_bytes + (lane >> 4) * 16;
  for (int task = warp; task < tasks; task += kWarps) {
    float acc[NT][MT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][m][i] = 0.f;
    const uint2* bt = bpk + ((size_t)kt0 * nt_tot + nt0 + task * NT) * 32 + lane;
    uint2 b[KB][NT], nb[KB][NT];
    auto load = [&](uint2(&dst)[KB][NT], int k0) {
#pragma unroll
      for (int d = 0; d < KB; ++d)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          dst[d][n] = k0 + d < kts ? __ldg(bt + ((size_t)(k0 + d) * nt_tot + n) * 32)
                                   : make_uint2(0u, 0u);
    };
    load(b, 0);
    for (int k0 = 0; k0 < kts; k0 += KB) {
      load(nb, k0 + KB);  // in flight during this batch's products
#pragma unroll
      for (int d = 0; d < KB; ++d) {
        if (k0 + d >= kts) break;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint4 a;
          ldmatrix4(a, a_lane + m * 16 * lda_bytes + (k0 + d) * 32);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma(acc[n][m], a, b[d][n]);
        }
      }
#pragma unroll
      for (int d = 0; d < KB; ++d)
#pragma unroll
        for (int n = 0; n < NT; ++n) b[d][n] = nb[d][n];
    }
    epi(task, acc);
  }
}

// out = A . B on the CUDA cores in f32 for the M rows of A (f32, row-major
// [M][lda] in shared memory, K a multiple of 8) and columns of the slice of
// B (f32, row-major, `nb` contiguous columns from Bm, rows ldb apart, in
// device memory).  The slice streams through `ring` in shared memory
// (kStages stages of kDepth rows, ldr floats a row) by 16-byte cp.async,
// kStages - 1 stages ahead of the FMAs.  Item (row block of RB rows, ci)
// takes NV consecutive columns col(ci) + c cstride .. + NV - 1 for each of
// NC column groups c (NC NV accumulators a row); thread tid takes items tid
// + kThreads i, i < IT, all of them (IT kThreads >= items); epi(first row,
// ci, acc) gets acc[c][r][v].  What bounds it is shared memory: an A value
// is the same for a warp's threads (a broadcast, 4 bytes a wavefront), so
// each one read serves NC NV columns, while the stage's B values are
// distinct across the warp (NV of them in one load).
template <int NV>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[NV]) {
  if constexpr (NV == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = p[i];
  }
}

template <int RB, int NC, int NV, int IT, class Col, class Epi>
__device__ __forceinline__ void fma_product(const float* A, int lda, int M, int K,
                                            const float* __restrict__ Bm, int ldb, int nb,
                                            float* ring, int ldr, int ncols, Col col,
                                            int cstride, Epi epi) {
  const int tid = threadIdx.x, items = (M / RB) * ncols;
  float acc[IT][NC][RB][NV];
  int rb[IT], bc[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int item = min(tid + it * kThreads, max(items - 1, 0));
    rb[it] = item / max(ncols, 1), bc[it] = col(item - rb[it] * ncols);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int v = 0; v < NV; ++v) acc[it][c][r][v] = 0.f;
  }
  const int steps = K / kDepth, n4 = nb / 4;
  auto issue = [&](int st) {
    float* dst = ring + (st % kStages) * kDepth * ldr;
    for (int e = tid; e < kDepth * n4; e += kThreads) {
      const int d = e / n4, q = e - d * n4;
      hopper::cp_async16(hopper::smem_addr(dst + d * ldr + 4 * q),
                         Bm + (size_t)(st * kDepth + d) * ldb + 4 * q, true);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) issue(st);
    hopper::cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st is in; every thread is past stage st - 1's FMAs
    if (st + kStages - 1 < steps) issue(st + kStages - 1);
    hopper::cp_async_commit();
    const float* sb = ring + (st % kStages) * kDepth * ldr;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      if (tid + it * kThreads >= items) break;
      const float* ar = A + rb[it] * RB * lda + st * kDepth;
#pragma unroll
      for (int q = 0; q < kDepth / 4; ++q) {
        float bv[4][NC][NV];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            ld_vec<NV>(sb + (4 * q + i) * ldr + bc[it] + c * cstride, bv[i][c]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4 av = *reinterpret_cast<const float4*>(ar + r * lda + 4 * q);
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              float x = acc[it][c][r][v];
              x = fmaf(av.x, bv[0][c][v], x);
              x = fmaf(av.y, bv[1][c][v], x);
              x = fmaf(av.z, bv[2][c][v], x);
              acc[it][c][r][v] = fmaf(av.w, bv[3][c][v], x);
            }
        }
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next product
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int item = tid + it * kThreads;
    if (item < items) epi(rb[it] * RB, item - rb[it] * ncols, acc[it]);
  }
}

// The operands of both recurrence kernels.  Weights: `wx` = w_ih^T with
// each group's r, z, n columns side by side [In][U 24], `wh` = [w_hh^T |
// U_a] likewise [H][U 32], `wxr` = [w_ih^T | 0]^T [U 32][In], `whr` = wh^T
// [U 32][H]: row-major f32, or, with bf16 weights, packed as mma.sync B
// fragments (train_kernel.pack_recurrence).
template <typename W>
struct Args {
  const W *feats, *att1;
  const float *h0, *embeds, *ua_b, *va, *bih, *bhh;
  const void *wx, *wh, *wxr, *whr;
  const float *hs_in, *g;                           // backward
  float* hs;                                        // forward
  W* d_att1;                                        // backward, from here
  float *d_h0, *d_emb, *X, *DGI, *HP, *DGHN, *DATT2, *dva_part, *w_t;
  W* dctx_t;
  int B, T, R, F, E, H;
  int skip;  // parts left out, for timing them (kSkip*); 0 computes the function
};

// One CTA of a cluster: its rows, groups, shared memory and the phases of a
// step.  Phases that read a peer's shared memory run between two cluster
// barriers that also order the peer's writes before and after.
template <typename W, int C>
struct Cta {
  static constexpr bool kBf16 = std::is_same<W, __nv_bfloat16>::value;
  static constexpr int M = kRowsA * C, MT = M / 16;
  static constexpr int V = Vec<W>::N;
  static constexpr int kChunks = (kMaxH / V + 31) / 32;  // 16-byte chunks of a row a lane
  using Cv = Cvt<W>;

  const Args<W>& a;
  cg::cluster_group cl;
  Layout L;
  unsigned char* sm;
  int B, T, R, F, E, H, In, G, U, NG, Rp;
  int c, u0, ng, row0, b0, nr;
  int tid, lane, warp;
  W *ah, *ax, *adg_i, *adg_h;
  float *P, *gh, *hown, *dh, *a2, *xpub, *att2, *w, *dw, *ds, *dva, *vac, *ring;

  __device__ Cta(const Args<W>& args, unsigned char* smem, bool bwd)
      : a(args), cl(cg::this_cluster()), sm(smem) {
    B = a.B, T = a.T, R = a.R, F = a.F, E = a.E, H = a.H;
    In = E + F, G = 3 * H, U = H / kUnits;
    L = layout(bwd, kBf16, C, R, F, E, H);
    NG = L.ng, Rp = (R + 3) & ~3;
    c = (int)cl.block_rank();
    u0 = group_start(c, C, U), ng = group_start(c + 1, C, U) - u0;
    row0 = (int)(blockIdx.x / C) * M;
    b0 = row0 + kRowsA * c;
    nr = max(0, min(kRowsA, B - b0));
    tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    ah = reinterpret_cast<W*>(sm + L.ah);
    ax = reinterpret_cast<W*>(sm + L.ax);
    P = reinterpret_cast<float*>(sm + L.ax);
    adg_i = reinterpret_cast<W*>(sm + L.adg_i);
    adg_h = reinterpret_cast<W*>(sm + L.adg_h);
    gh = reinterpret_cast<float*>(sm + L.gh);
    hown = reinterpret_cast<float*>(sm + L.hown);
    dh = reinterpret_cast<float*>(sm + L.dh);
    a2 = reinterpret_cast<float*>(sm + L.a2);
    xpub = reinterpret_cast<float*>(sm + L.xpub);
    att2 = reinterpret_cast<float*>(sm + L.att2);
    w = reinterpret_cast<float*>(sm + L.w);
    dw = reinterpret_cast<float*>(sm + L.dw);
    ds = reinterpret_cast<float*>(sm + L.ds);
    dva = reinterpret_cast<float*>(sm + L.dva);
    vac = reinterpret_cast<float*>(sm + L.vac);
    ring = reinterpret_cast<float*>(sm + L.ring);
  }

  template <typename T_>
  __device__ T_* peer(T_* p, int rank) {
    return cl.map_shared_rank(p, rank);
  }

  // every byte 0 (the padding of the A operands stays 0 for all steps), then
  // rnd(v_a)
  __device__ void zero_smem() {
    uint4* p = reinterpret_cast<uint4*>(sm);
    for (int i = tid; i < L.total / 16; i += kThreads) p[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    for (int j = tid; j < H; j += kThreads) vac[j] = Cv::rnd(__ldg(a.va + j));
  }

  // h of all M rows from device memory (row b at src[b * stride]; rows past
  // B are 0): rnd(h) into ah, the own units in f32 into hown
  __device__ void load_h(const float* __restrict__ src, size_t stride) {
    const int n4 = H / 4;
    for (int e = tid; e < M * n4; e += kThreads) {
      const int m = e / n4, j = (e - m * n4) * 4, row = row0 + m;
      const float4 v = row < B ? __ldg(reinterpret_cast<const float4*>(src + row * stride + j))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      put4(ah + m * L.ldh + j, make_float4(Cv::rnd(v.x), Cv::rnd(v.y), Cv::rnd(v.z), Cv::rnd(v.w)));
      const int u = j >> 3;
      if (u >= u0 && u < u0 + ng)
        *reinterpret_cast<float4*>(hown + m * NG * 8 + (u - u0) * 8 + (j & 7)) = v;
    }
  }

  // h of all M rows from the owners of the units (the forward's next step)
  __device__ void gather_h() {
    const int n4 = H / 4;
    for (int e = tid; e < M * n4; e += kThreads) {
      const int m = e / n4, j = (e - m * n4) * 4, u = j >> 3, o = group_owner(u, C, U);
      const float4 v = *reinterpret_cast<const float4*>(
          peer(hown, o) + m * NG * 8 + (u - group_start(o, C, U)) * 8 + (j & 7));
      put4(ah + m * L.ldh + j, make_float4(Cv::rnd(v.x), Cv::rnd(v.y), Cv::rnd(v.z), Cv::rnd(v.w)));
    }
  }

  // 1. [gh | att2] = rnd(h) [w_hh^T | U_a] for the own groups: gh + b_hh into
  // gh, rnd(att2 + b) into a2
  __device__ void h_product() {
    auto put = [&](int m, int col, float v) {
      const int ul = col >> 5, slot = (col >> 3) & 3, k = col & 7, j = (u0 + ul) * kUnits + k;
      if (slot < 3)
        gh[m * NG * 24 + ul * 24 + slot * 8 + k] = v + a.bhh[slot * H + j];
      else
        a2[m * NG * 8 + ul * 8 + k] = Cv::rnd(v + a.ua_b[j]);
    };
    if constexpr (kBf16) {
      mma_product<MT, 4>(hopper::smem_addr(ah), L.ldh * 2, ktiles(H),
                         static_cast<const uint2*>(a.wh), U * 4, 0, 4 * u0, ng,
                         [&](int task, float (&acc)[4][MT][4]) {
#pragma unroll
                           for (int n = 0; n < 4; ++n)
#pragma unroll
                             for (int m = 0; m < MT; ++m)
#pragma unroll
                               for (int i = 0; i < 4; ++i)
                                 put(m * 16 + (lane >> 2) + 8 * (i >> 1),
                                     task * 32 + n * 8 + 2 * (lane & 3) + (i & 1), acc[n][m][i]);
                         });
    } else {
      fma_product<8, 1, 4, 1>(
          reinterpret_cast<const float*>(ah), L.ldh, M, H,
          static_cast<const float*>(a.wh) + u0 * 32, U * 32, ng * 32, ring, L.ldr, ng * 8,
          [](int ci) { return 4 * ci; }, 0, [&](int r0, int ci, float (&acc)[1][8][4]) {
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int v = 0; v < 4; ++v) put(r0 + r, 4 * ci + v, acc[0][r][v]);
          });
    }
  }

  // att2 of the 8 rows from the owners of its columns
  __device__ void gather_att2() {
    const int n4 = H / 4;
    for (int e = tid; e < kRowsA * n4; e += kThreads) {
      const int r = e / n4, j = (e - r * n4) * 4, u = j >> 3, o = group_owner(u, C, U);
      *reinterpret_cast<float4*>(att2 + r * H + j) = *reinterpret_cast<const float4*>(
          peer(a2, o) + (kRowsA * c + r) * NG * 8 + (u - group_start(o, C, U)) * 8 + (j & 7));
    }
  }

  // 2. the attention of the 8 rows: scores, softmax (weights in w), the
  // context rnd(sum rnd(rnd(w) feats)) into xpub (rows past B: 0) and, in
  // the backward, into the pass-2 rows X
  __device__ void attend(int t, bool bwd) {
    const int nv = H / V;
    for (int p0 = warp * kPairs; p0 < ((a.skip & kSkipScores) ? 0 : nr * R);
         p0 += kWarps * kPairs) {
      float x[kPairs][kChunks][V];  // att1 of kPairs (row, region) pairs, loaded together
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int p = min(p0 + q, nr * R - 1), r = p / R, rho = p - r * R;
        const W* a1 = a.att1 + ((size_t)(b0 + r) * R + rho) * H;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch)
          if (lane + 32 * ch < nv) Vec<W>::ldg(a1 + (lane + 32 * ch) * V, x[q][ch]);
      }
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int p = p0 + q, r = min(p, nr * R - 1) / R;
        float s = 0.f;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          if (lane + 32 * ch >= nv) break;
          const int j = (lane + 32 * ch) * V;
          float a2v[V], vv[V];
          ld_floats(att2 + r * H + j, a2v);
          ld_floats(vac + j, vv);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float v = Cv::rnd(tanhf(Cv::rnd(x[q][ch][i] + a2v[i])));
            s += Cv::rnd(v * vv[i]);
          }
        }
        s = warp_sum(s);
        if (lane == 0 && p < nr * R) w[r * Rp + p - r * R] = Cv::rnd(s);
      }
    }
    __syncthreads();
    for (int r = warp; r < nr; r += kWarps) {  // softmax over regions, in f32
      float mx = -INFINITY;
      for (int rho = lane; rho < R; rho += 32) mx = fmaxf(mx, w[r * Rp + rho]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int rho = lane; rho < R; rho += 32) {
        const float e = expf(w[r * Rp + rho] - mx);
        w[r * Rp + rho] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int rho = lane; rho < R; rho += 32) w[r * Rp + rho] = w[r * Rp + rho] / sum;
    }
    __syncthreads();
    const int fv = F / V;
    for (int e = tid; e < ((a.skip & kSkipContext) ? 0 : kRowsA * fv);
         e += kThreads) {  // the context, V features a thread
      const int r = e / fv, f = (e - r * fv) * V;
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      if (r < nr) {
        const W* fp = a.feats + (size_t)(b0 + r) * R * F + f;
        for (int rho0 = 0; rho0 < R; rho0 += kRegions) {
          float v[kRegions][V];
#pragma unroll
          for (int q = 0; q < kRegions; ++q)
            if (rho0 + q < R) Vec<W>::ldg(fp + (size_t)(rho0 + q) * F, v[q]);
#pragma unroll
          for (int q = 0; q < kRegions; ++q) {
            if (rho0 + q >= R) break;
            const float wr = Cv::rnd(w[r * Rp + rho0 + q]);
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] += Cv::rnd(wr * v[q][i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        acc[i] = Cv::rnd(acc[i]);
        xpub[r * F + f + i] = acc[i];
      }
      if (bwd && r < nr) {
        float* xr = a.X + ((size_t)t * B + b0 + r) * In + E + f;
#pragma unroll
        for (int i = 0; i < V; ++i) xr[i] = acc[i];
      }
    }
  }

  // x = [word | ctx] of all M rows into ax, rounded: the words from device
  // memory (zero at t = 0 and past B), the contexts from their rows' CTAs;
  // bf16: zeros in the depths past In of the last k16 tile (the backward's
  // partial sums P have been there since)
  __device__ void gather_x(int t) {
    const int e4 = E / 4, f4 = F / 4;
    if constexpr (kBf16) {
      const int p4 = (ktiles(In) * 16 - In) / 4;
      for (int e = tid; e < M * p4; e += kThreads)
        put4(ax + (e / p4) * L.ldx + In + (e % p4) * 4, make_float4(0.f, 0.f, 0.f, 0.f));
    }
    for (int e = tid; e < M * e4; e += kThreads) {
      const int m = e / e4, i = (e - m * e4) * 4, row = row0 + m;
      const float4 v =
          row < B && t > 0
              ? __ldg(reinterpret_cast<const float4*>(a.embeds + ((size_t)row * T + t - 1) * E + i))
              : make_float4(0.f, 0.f, 0.f, 0.f);
      put4(ax + m * L.ldx + i, make_float4(Cv::rnd(v.x), Cv::rnd(v.y), Cv::rnd(v.z), Cv::rnd(v.w)));
    }
    for (int e = tid; e < M * f4; e += kThreads) {
      const int m = e / f4, f = (e - m * f4) * 4;
      put4(ax + m * L.ldx + E + f, *reinterpret_cast<const float4*>(
                                        peer(xpub, m / kRowsA) + (m % kRowsA) * F + f));
    }
  }

  // 3. gi = rnd(x) w_ih^T for the own groups; epi(m, group, unit, gi_r,
  // gi_z, gi_n) for each (row, own unit)
  template <class Epi>
  __device__ void x_product(Epi epi) {
    if constexpr (kBf16) {
      mma_product<MT, 3>(hopper::smem_addr(ax), L.ldx * 2, ktiles(In),
                         static_cast<const uint2*>(a.wx), U * 3, 0, 3 * u0, ng,
                         [&](int task, float (&acc)[3][MT][4]) {
#pragma unroll
                           for (int m = 0; m < MT; ++m)
#pragma unroll
                             for (int i = 0; i < 4; ++i)
                               epi(m * 16 + (lane >> 2) + 8 * (i >> 1), task,
                                   2 * (lane & 3) + (i & 1), acc[0][m][i], acc[1][m][i],
                                   acc[2][m][i]);
                         });
    } else {
      fma_product<8, 3, 1, 1>(
          reinterpret_cast<const float*>(ax), L.ldx, M, In,
          static_cast<const float*>(a.wx) + u0 * 24, U * 24, ng * 24, ring, L.ldr, ng * 8,
          [](int ci) { return (ci >> 3) * 24 + (ci & 7); }, 8,
          [&](int r0, int ci, float (&acc)[3][8][1]) {
#pragma unroll
            for (int r = 0; r < 8; ++r)
              epi(r0 + r, ci >> 3, ci & 7, acc[0][r][0], acc[1][r][0], acc[2][r][0]);
          });
    }
  }

  // the GRU gates of (row m, unit k of own group ul) from gi (no bias) and gh
  __device__ __forceinline__ void gates(int m, int ul, int k, float gir, float giz, float gin,
                                        float& rg, float& zg, float& ngate, float& hn) {
    const int j = (u0 + ul) * kUnits + k;
    const float* g3 = gh + m * NG * 24 + ul * 24 + k;
    hn = g3[16];
    rg = sigmoidf((gir + a.bih[j]) + g3[0]);
    zg = sigmoidf((giz + a.bih[H + j]) + g3[8]);
    ngate = tanhf((gin + a.bih[2 * H + j]) + rg * hn);
  }

  // the forward's GRU: h' into hs and hown (rows past B keep 0)
  __device__ void step_fwd(int t) {
    x_product([&](int m, int ul, int k, float gir, float giz, float gin) {
      float rg, zg, ngate, hn;
      gates(m, ul, k, gir, giz, gin, rg, zg, ngate, hn);
      const int row = row0 + m;
      if (row >= B) return;
      float* hp = hown + m * NG * 8 + ul * 8 + k;
      const float h1 = (1.f - zg) * ngate + zg * *hp;
      *hp = h1;
      a.hs[((size_t)row * T + t) * H + (u0 + ul) * kUnits + k] = h1;
    });
  }

  // the backward's GRU step and its backward: dgi, dgh (rounded) into the A
  // operands, the pass-2 rows DGI and DGHN, and dL/dh_new z into dh
  __device__ void step_bwd(int t) {
    x_product([&](int m, int ul, int k, float gir, float giz, float gin) {
      float rg, zg, ngate, hn;
      gates(m, ul, k, gir, giz, gin, rg, zg, ngate, hn);
      const int row = row0 + m, j = (u0 + ul) * kUnits + k;
      const bool valid = row < B;
      const float gt = valid ? a.g[((size_t)row * T + t) * H + j] : 0.f;
      float* dhp = dh + m * NG * 8 + ul * 8 + k;
      const float dhn = gt + *dhp;
      const float dz = dhn * (hown[m * NG * 8 + ul * 8 + k] - ngate);
      const float dn = dhn * (1.f - zg);
      const float dpre_n = dn * (1.f - ngate * ngate);
      const float dr = dpre_n * hn;
      const float dpre_r = dr * rg * (1.f - rg);
      const float dpre_z = dz * zg * (1.f - zg);
      const float dghn = dpre_n * rg;
      *dhp = dhn * zg;
      W* di = adg_i + m * L.ldg + ul * 32 + k;
      W* dg = adg_h + m * L.ldg + ul * 32 + k;
      di[0] = dg[0] = Cv::to_w(dpre_r);
      di[8] = dg[8] = Cv::to_w(dpre_z);
      di[16] = Cv::to_w(dpre_n);
      dg[16] = Cv::to_w(dghn);
      if (valid) {
        float* drow = a.DGI + ((size_t)t * B + row) * G;
        drow[j] = dpre_r;
        drow[H + j] = dpre_z;
        drow[2 * H + j] = dpre_n;
        a.DGHN[((size_t)t * B + row) * H + j] = dghn;
      }
    });
  }

  // P[M][n0 .. n0 + ncols) = A_rev . (the own groups' rows of wr), A_rev =
  // adg_i or adg_h: this CTA's partial sum over its groups
  __device__ void rev_product(const W* A, const void* wr, int n_full, int n0, int ncols) {
    if constexpr (kBf16) {
      mma_product<MT, 1>(hopper::smem_addr(A), L.ldg * 2, 2 * ng,
                         static_cast<const uint2*>(wr), n_full / 8, 2 * u0, n0 / 8, ncols / 8,
                         [&](int task, float (&acc)[1][MT][4]) {
#pragma unroll
                           for (int m = 0; m < MT; ++m)
#pragma unroll
                             for (int i = 0; i < 4; ++i)
                               P[(m * 16 + (lane >> 2) + 8 * (i >> 1)) * L.ldp + task * 8 +
                                 2 * (lane & 3) + (i & 1)] = acc[0][m][i];
                         });
    } else {
      constexpr int RB = M / 4;  // 200 items at N = 200
      fma_product<RB, 1, 4, 2>(reinterpret_cast<const float*>(A), L.ldg, M, ng * 32,
                               static_cast<const float*>(wr) + (size_t)u0 * 32 * n_full + n0,
                               n_full, ncols, ring, L.ldr, ncols / 4,
                               [](int ci) { return 4 * ci; }, 0,
                               [&](int r0, int ci, float (&acc)[1][RB][4]) {
#pragma unroll
                                 for (int r = 0; r < RB; ++r)
                                   *reinterpret_cast<float4*>(P + (r0 + r) * L.ldp + 4 * ci) =
                                       make_float4(acc[0][r][0], acc[0][r][1], acc[0][r][2],
                                                   acc[0][r][3]);
                               });
    }
  }

  // out(r, i, sum) for the 8 rows and i < n (4 at a time): the sum of the C
  // CTAs' P, added in rank order
  template <class Out>
  __device__ void reduce_rows(int n, Out out) {
    const int n4 = n / 4;
    for (int e = tid; e < nr * n4; e += kThreads) {
      const int r = e / n4, i = (e - r * n4) * 4;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int o = 0; o < C; ++o) {
        const float4 v =
            *reinterpret_cast<const float4*>(peer(P, o) + (kRowsA * c + r) * L.ldp + i);
        s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
      }
      out(r, i, s);
    }
  }

  // dh (own units, all M rows) += the sum of the C CTAs' P, in rank order
  __device__ void reduce_cols() {
    const int n4 = ng * 2;
    for (int e = tid; e < M * n4; e += kThreads) {
      const int m = e / n4, ul = (e - m * n4) * 4;
      float4* d = reinterpret_cast<float4*>(dh + m * NG * 8 + ul);
      float4 s = *d;
      for (int o = 0; o < C; ++o) {
        const float4 v = *reinterpret_cast<const float4*>(peer(P, o) + m * L.ldp + u0 * 8 + ul);
        s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
      }
      *d = s;
    }
  }

  // the backward's pass-2 rows of the 8 rows that need no product: HP =
  // h_{t-1} and the word part of X
  __device__ void write_rows(int t, const float* __restrict__ src, size_t stride) {
    const int h4 = H / 4, e4 = E / 4;
    for (int e = tid; e < nr * h4; e += kThreads) {
      const int r = e / h4, j = (e - r * h4) * 4;
      *reinterpret_cast<float4*>(a.HP + ((size_t)t * B + b0 + r) * H + j) =
          __ldg(reinterpret_cast<const float4*>(src + (b0 + r) * stride + j));
    }
    for (int e = tid; e < nr * e4; e += kThreads) {
      const int r = e / e4, i = (e - r * e4) * 4;
      *reinterpret_cast<float4*>(a.X + ((size_t)t * B + b0 + r) * In + i) =
          t > 0 ? __ldg(reinterpret_cast<const float4*>(a.embeds +
                                                         ((size_t)(b0 + r) * T + t - 1) * E + i))
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // the attention backward of the 8 rows from rnd(dctx) in xpub: dw, ds, the
  // fold's operands w_t and dctx_t, d_att1 (read-modify-write in W, V units
  // a thread), datt2 = rnd(sum de) into a2 ([8][H]; rows past B 0) and
  // DATT2, and d(v_a)
  __device__ void attend_back(int t, bool first) {
    const float* dctx = xpub;
    float* dvar = xpub + kRowsA * F;
    const int fv = F / V;
    for (int p0 = warp * kPairs; p0 < nr * R; p0 += kWarps * kPairs) {  // dw = rnd(dctx . feats)
      float x[kPairs][kChunks][V];
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int p = min(p0 + q, nr * R - 1), r = p / R, rho = p - r * R;
        const W* fr = a.feats + ((size_t)(b0 + r) * R + rho) * F;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch)
          if (lane + 32 * ch < fv) Vec<W>::ldg(fr + (lane + 32 * ch) * V, x[q][ch]);
      }
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int p = p0 + q, r = min(p, nr * R - 1) / R;
        float s = 0.f;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
          if (lane + 32 * ch >= fv) break;
          float dc[V];
          ld_floats(dctx + r * F + (lane + 32 * ch) * V, dc);
#pragma unroll
          for (int i = 0; i < V; ++i) s += Cv::rnd(dc[i] * x[q][ch][i]);
        }
        s = warp_sum(s);
        if (lane == 0 && p < nr * R) dw[r * Rp + p - r * R] = Cv::rnd(s);
      }
    }
    for (int e = tid; e < nr * F; e += kThreads) {
      const int r = e / F, f = e - r * F;
      a.dctx_t[((size_t)(b0 + r) * T + t) * F + f] = Cv::to_w(dctx[r * F + f]);
    }
    __syncthreads();
    for (int r = warp; r < nr; r += kWarps) {  // ds = w (dw - sum w dw), in f32
      float s = 0.f;
      for (int rho = lane; rho < R; rho += 32) s += w[r * Rp + rho] * dw[r * Rp + rho];
      s = warp_sum(s);
      for (int rho = lane; rho < R; rho += 32) {
        ds[r * Rp + rho] = w[r * Rp + rho] * (dw[r * Rp + rho] - s);
        a.w_t[((size_t)(b0 + r) * T + t) * R + rho] = w[r * Rp + rho];
      }
    }
    __syncthreads();
    const int nv = H / V;
    for (int e = tid; e < kRowsA * nv; e += kThreads) {
      const int r = e / nv, j = (e - r * nv) * V;
      float dat[V], dvv[V];
#pragma unroll
      for (int i = 0; i < V; ++i) dat[i] = dvv[i] = 0.f;
      if (r < nr) {
        float vc[V], at2[V];
        ld_floats(vac + j, vc);
        ld_floats(att2 + r * H + j, at2);
        const W* a1 = a.att1 + (size_t)(b0 + r) * R * H + j;
        W* da1 = a.d_att1 + (size_t)(b0 + r) * R * H + j;
        constexpr int Q = kRegions / 2;
        for (int rho0 = 0; rho0 < R; rho0 += Q) {
          float x[Q][V], acc[Q][V];  // Q regions' att1 and d_att1, loaded together
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            if (rho0 + q >= R) break;
            Vec<W>::ldg(a1 + (size_t)(rho0 + q) * H, x[q]);
            if (first) {
#pragma unroll
              for (int i = 0; i < V; ++i) acc[q][i] = 0.f;
            } else {
              Vec<W>::ld(da1 + (size_t)(rho0 + q) * H, acc[q]);
            }
          }
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            if (rho0 + q >= R) break;
            const float dsv = ds[r * Rp + rho0 + q], dsc = Cv::rnd(dsv);
#pragma unroll
            for (int i = 0; i < V; ++i) {
              const float av = Cv::rnd(tanhf(Cv::rnd(x[q][i] + at2[i])));
              const float da = Cv::rnd(dsc * vc[i]);
              const float de = Cv::rnd(da * Cv::rnd(1.f - Cv::rnd(av * av)));
              acc[q][i] += de;
              dat[i] += de;
              dvv[i] += av * dsv;
            }
            Vec<W>::st(da1 + (size_t)(rho0 + q) * H, acc[q]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        dvar[r * H + j + i] = dvv[i];
        dat[i] = Cv::rnd(dat[i]);
        a2[r * H + j + i] = dat[i];
      }
      if (r < nr) {
        float* d2 = a.DATT2 + ((size_t)t * B + b0 + r) * H + j;
#pragma unroll
        for (int i = 0; i < V; ++i) d2[i] = dat[i];
      }
    }
    __syncthreads();
    for (int j = tid; j < H; j += kThreads) {
      float s = dva[j];
      for (int r = 0; r < nr; ++r) s += dvar[r * H + j];
      dva[j] = s;
    }
  }

  // rnd(datt2) of all M rows and the own units into the 4th slot of adg_h
  __device__ void gather_datt2() {
    const int n4 = ng * 2;
    for (int e = tid; e < M * n4; e += kThreads) {
      const int m = e / n4, ul = (e - m * n4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(peer(a2, m / kRowsA) +
                                                        (m % kRowsA) * H + u0 * 8 + ul);
      put4(adg_h + m * L.ldg + (ul >> 3) * 32 + 24 + (ul & 7), v);
    }
  }
};

template <typename W, int C>
__global__ void __launch_bounds__(kThreads, 1) train_fwd_kernel(const __grid_constant__ Args<W> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cta<W, C> s(a, smem_raw, false);
  s.zero_smem();
  s.load_h(a.h0, a.H);
  s.cl.sync();  // every CTA of the cluster runs before any reads a peer
  const bool attn = !(a.skip & kSkipAttention), gates = !(a.skip & kSkipGates);
  for (int t = 0; t < a.T; ++t) {
    if (gates) s.h_product();
    s.cl.sync();
    s.gather_att2();
    __syncthreads();
    if (attn) s.attend(t, false);
    s.cl.sync();
    s.gather_x(t);
    __syncthreads();
    if (gates) s.step_fwd(t);
    s.cl.sync();
    if (t + 1 < a.T) {
      s.gather_h();
      __syncthreads();
    }
  }
  s.cl.sync();  // no CTA leaves while a peer may read its shared memory
}

template <typename W, int C>
__global__ void __launch_bounds__(kThreads, 1) train_bwd_recurrence_kernel(const __grid_constant__ Args<W> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cta<W, C> s(a, smem_raw, true);
  using Cv = Cvt<W>;
  const int T = a.T, E = a.E, H = a.H;
  const bool attn = !(a.skip & kSkipAttention), gates = !(a.skip & kSkipGates);
  const bool rev = !(a.skip & kSkipReverse), back = !(a.skip & kSkipAttentionBack);
  s.zero_smem();
  s.cl.sync();
  for (int t = T - 1; t >= 0; --t) {
    const bool first = t == T - 1;
    const float* hsrc = t > 0 ? a.hs_in + (size_t)(t - 1) * H : a.h0;
    const size_t stride = t > 0 ? (size_t)T * H : (size_t)H;
    s.load_h(hsrc, stride);
    s.write_rows(t, hsrc, stride);
    __syncthreads();
    if (gates) s.h_product();
    s.cl.sync();
    s.gather_att2();
    __syncthreads();
    if (attn) s.attend(t, true);
    s.cl.sync();
    s.gather_x(t);
    __syncthreads();
    if (gates) s.step_bwd(t);
    __syncthreads();
    if (t > 0) {  // dword = the word part of dx; step 0's zero word has none
      if (rev) s.rev_product(s.adg_i, a.wxr, s.In, 0, E);
      s.cl.sync();
      if (rev)
        s.reduce_rows(E, [&](int r, int i, float4 v) {
          *reinterpret_cast<float4*>(a.d_emb + ((size_t)(s.b0 + r) * T + t - 1) * E + i) = v;
        });
      s.cl.sync();
    }
    if (first)
      for (int e = s.tid; e < s.nr * E; e += kThreads)
        a.d_emb[((size_t)(s.b0 + e / E) * T + T - 1) * E + e % E] = 0.f;
    if (rev) s.rev_product(s.adg_i, a.wxr, s.In, E, s.F);  // dctx = the context part of dx
    s.cl.sync();
    if (rev)
      s.reduce_rows(s.F, [&](int r, int i, float4 v) {
        *reinterpret_cast<float4*>(s.xpub + r * s.F + i) =
            make_float4(Cv::rnd(v.x), Cv::rnd(v.y), Cv::rnd(v.z), Cv::rnd(v.w));
      });
    __syncthreads();
    if (back) s.attend_back(t, first);
    s.cl.sync();
    s.gather_datt2();
    __syncthreads();
    if (rev) s.rev_product(s.adg_h, a.whr, H, 0, H);  // dh = [dgh | datt2] [w_hh | U_a^T]
    s.cl.sync();
    if (rev) s.reduce_cols();
    __syncthreads();
  }
  for (int e = s.tid; e < s.M * s.ng * 8; e += kThreads) {
    const int m = e / (s.ng * 8), ul = e - m * (s.ng * 8), row = s.row0 + m;
    if (row < a.B) a.d_h0[(size_t)row * H + s.u0 * 8 + ul] = s.dh[m * s.NG * 8 + ul];
  }
  if (s.nr > 0)
    for (int j = s.tid; j < H; j += kThreads) a.dva_part[(size_t)(s.b0 / kRowsA) * H + j] = s.dva[j];
  s.cl.sync();
}

// ---------------------------------------------------------------- the fold
// d_feats[b, rho, f] = the fold over t = T-1 .. 0 of d <- rnd(d + rnd(rnd(w)
// dctx)), each product and sum rounded on its own (no fused multiply-add), as
// the plain version takes them.  bf16 takes them as bf16x2 operations: a
// product of two bf16 values is exact in f32 and a sum of two rounds the same
// once as through f32, so they give the roundings of the f32 arithmetic, one
// instruction for two.  The order and the roundings leave no room for the
// tensor cores: this is a CUDA-core kernel.
//
// What bounds it: bytes, then its separate mul and add.  It reads w_t
// [B, T, R] (f32) and dctx_t [B, T, F] once and writes d_feats [B, R, F]:
// 65.6 MB in f32 at B=1024, T=25, R=49, F=200 (35.3 MB in bf16), 0.0196 ms
// (0.0105) at 3.35 TB/s.  Its 0.50 G f32 lane instructions (0.25 G bf16x2)
// take ~0.017 ms (~0.009) at the CUDA cores' issue rate, so loads, stores
// and arithmetic must overlap.  Measured on the H100 (PERF.md, the skip
// bits): the arithmetic alone takes ~0.027 ms in f32 (~0.016 bf16), the
// loads and stores alone ~0.026 (~0.013), and they overlap in part.  The
// first design (a thread per (image,
// region, 16 bytes of features), each step's w and dctx read from device
// memory) read every dctx row once per region and every w once per 16 bytes
// of features: ~1.25 GB through L1 and L2 for 65.6 MB of DRAM traffic; in a
// copy of it (ops/probe/fold_probe.cu) the loads alone took 99% of the time.
//
// This design reads each operand from device memory once, into shared
// memory.  An item is one image b, `nr` of its regions and `fc` 16-byte
// chunks of its features (train_kernel.fold_plan: a whole image once the
// batch fills the card, else the items of one wave; the plan's numbers are
// arguments); a block takes items blockIdx.x, + gridDim.x, ... through two
// buffers, copying the next item while it folds this one.  An item's
// dctx_t[b, :, chunks] comes by 16-byte cp.async (F * elt is a multiple of
// 16, so every row is aligned), its w_t[b, :, regions] by 4-byte cp.async
// (w_t[b] starts at b T R floats: off 16 bytes wherever T R is odd) into
// each region set's 16-byte-aligned slots.  A thread holds 16 bytes of
// features (4 f32, 8 bf16) of P consecutive regions in registers, S sets of
// regions by fc chunks a block; a step is one 16-byte shared load of dctx
// and ceil(P / 4) of w (bf16: turned into bf16x2 pairs once, in place, by
// the thread that copied them), then P x 4 products and sums.  Its stores
// are 16 bytes, neighbouring threads on neighbouring chunks.
constexpr int kFoldRegions = 8;    // regions a thread at most (P)
// threads a block at most (S * fc: 7 x 50 at full width in f32), and two such
// blocks an SM: at most 80 registers a thread (65536 / 768, in steps of 8)
constexpr int kFoldThreads = 384;
// `skip` bits, to time the parts (the output is then not the function): the
// arithmetic (the stores write zeros), the copies from device memory, the
// stores
constexpr int kFoldSkipArith = 1, kFoldSkipStage = 2, kFoldSkipStore = 4;

// The fold's launch (train_kernel.fold_plan) and the sizes it gives: a
// __grid_constant__ parameter, read in place (no copy to registers or local
// memory).
struct FoldArgs {
  const float* w_t;
  const void* dctx_t;
  void* d_feats;
  int T, R, F;
  int nr, fc, S;             // regions and 16-byte chunks an item, region sets a block
  int nv, nrb, nfb, items;   // chunks a row; region and feature blocks an image; items
  int skip;
};

// Item i: image i / (nrb nfb), region block (i / nfb) % nrb, feature block
// i % nfb; its first region and chunk, and how many it holds.
struct FoldItem {
  int b, r0, nrl, c0, fcl;
  __device__ FoldItem(int i, const FoldArgs& a) {
    const int fb = i % a.nfb, rb = (i / a.nfb) % a.nrb;
    b = i / (a.nfb * a.nrb);
    r0 = rb * a.nr, nrl = min(a.nr, a.R - r0), c0 = fb * a.fc, fcl = min(a.fc, a.nv - c0);
  }
};

// f(t, c) for e = tid, tid + nth, ... < T n with (t, c) = (e / n, e % n),
// stepped without a division an element
template <typename Fn>
__device__ __forceinline__ void for_each_tc(int T, int n, int tid, int nth, Fn f) {
  if (n <= 0) return;
  int t = tid / n, c = tid - t * n;
  const int dt = nth / n, dc = nth - dt * n;
  while (t < T) {
    f(t, c);
    t += dt, c += dc;
    if (c >= n) c -= n, ++t;
  }
}

template <typename W, int P>
__global__ void __launch_bounds__(kFoldThreads, 2)
    train_feats_fold_kernel(const __grid_constant__ FoldArgs a) {
  constexpr int V = Vec<W>::N, P4 = (P + 3) / 4;  // P4: float4s of a thread's w slots
  constexpr bool kBf16 = std::is_same<W, __nv_bfloat16>::value;
  extern __shared__ float4 fold_smem[];
  const int T = a.T, fc = a.fc, nw4 = a.S * P4, buf = T * (fc + nw4);  // float4s of a buffer
  const int tid = threadIdx.x, nth = blockDim.x;
  // Item i into buffer k: dctx [T][fc] chunks, then w [T][S][4 P4] (the
  // slots of set s at s 4 P4: 16-byte rows), as one group of copies (none
  // past the last item).  The w slots of no region keep what they held: the
  // accumulators that read them are not stored.
  auto stage = [&](int i, int k) {
    if (i < a.items && !(a.skip & kFoldSkipStage)) {
      float4* ds = fold_smem + k * buf;
      float* ws = reinterpret_cast<float*>(ds + T * fc);
      const FoldItem it(i, a);
      const W* dsrc = static_cast<const W*>(a.dctx_t) + (size_t)it.b * T * a.F + (size_t)it.c0 * V;
      for_each_tc(T, it.fcl, tid, nth, [&](int t, int c) {
        hopper::cp_async16(hopper::smem_addr(ds + t * fc + c), dsrc + (size_t)t * a.F + c * V,
                           true);
      });
      const float* wsrc = a.w_t + (size_t)it.b * T * a.R + it.r0;
      for_each_tc(T, it.nrl, tid, nth, [&](int t, int r) {
        cp_async4(hopper::smem_addr(ws + (t * nw4 + r / P * P4) * 4 + r % P),
                  wsrc + (size_t)t * a.R + r);
      });
    }
    hopper::cp_async_commit();
  };
  const int s = tid / fc, c = tid - s * fc;
  using Acc = typename std::conditional<kBf16, unsigned, float>::type;
  stage(blockIdx.x, 0);
  for (int i = blockIdx.x, k = 0; i < a.items; i += gridDim.x, k ^= 1) {
    stage(i + gridDim.x, k ^ 1);  // the next item's copies fly while this one folds
    const FoldItem it(i, a);
    const float4* ds = fold_smem + k * buf;
    float4* ws = fold_smem + k * buf + T * fc;
    hopper::cp_async_wait<1>();  // this thread's copies of item i
    if constexpr (kBf16)  // the w it copied, as bf16x2 pairs of rnd(w)
      if (!(a.skip & kFoldSkipStage))
        for_each_tc(T, it.nrl, tid, nth, [&](int t, int r) {
          float* slot = reinterpret_cast<float*>(ws + t * nw4 + r / P * P4) + r % P;
          *reinterpret_cast<unsigned*>(slot) = Vec<__nv_bfloat16>::pair(*slot, *slot);
        });
    __syncthreads();
    Acc acc[P][4];
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][j] = 0;
    const bool live = c < it.fcl;
    if (live && !(a.skip & kFoldSkipArith)) {
      const float4* wr = ws + s * P4;
      // a step: 1 + ceil(P / 4) 16-byte shared loads, then P x 4 products and
      // sums (.rn on each: no contraction into a fused multiply-add)
#pragma unroll 2
      for (int t = T - 1; t >= 0; --t) {
        float wv[4 * P4];
#pragma unroll
        for (int u = 0; u < P4; ++u) {
          const float4 w4 = wr[t * nw4 + u];
          wv[4 * u] = w4.x, wv[4 * u + 1] = w4.y, wv[4 * u + 2] = w4.z, wv[4 * u + 3] = w4.w;
        }
        const float4 x = ds[t * fc + c];
        if constexpr (kBf16) {
          const unsigned xv[4] = {__float_as_uint(x.x), __float_as_uint(x.y),
                                  __float_as_uint(x.z), __float_as_uint(x.w)};
#pragma unroll
          for (int q = 0; q < P; ++q) {
            const unsigned w2 = __float_as_uint(wv[q]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              unsigned p;
              asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(p) : "r"(w2), "r"(xv[j]));
              asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(acc[q][j]) : "r"(acc[q][j]), "r"(p));
            }
          }
        } else {
          const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int q = 0; q < P; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[q][j] = __fadd_rn(acc[q][j], __fmul_rn(wv[q], xv[j]));
        }
      }
    }
    if (live && !(a.skip & kFoldSkipStore))
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int rl = s * P + q;
        if (rl < it.nrl) {
          W* out = static_cast<W*>(a.d_feats) + ((size_t)it.b * a.R + it.r0 + rl) * a.F +
                   (size_t)(it.c0 + c) * V;
          if constexpr (kBf16)
            *reinterpret_cast<uint4*>(out) =
                make_uint4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
          else
            *reinterpret_cast<float4*>(out) =
                make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
        }
      }
    __syncthreads();  // buffer k is read: the item after next may be staged into it
  }
  hopper::cp_async_wait<0>();
}

// The launch configuration of a recurrence kernel: `clusters` clusters of C
// CTAs, the layout's dynamic shared memory (the attribute set first).
template <typename Kernel>
cudaError_t configure(Kernel kernel, int C, int clusters, int smem, cudaStream_t stream,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100 (227 KB)

// How many clusters of the kernel can run at once (0: none fits), or a
// negative CUDA error.
template <typename Kernel>
int max_clusters(Kernel kernel, int C, int smem) {
  if (smem > kMaxSmem) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kernel, C, 1, smem, nullptr, cfg, attr);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// Launches the kernel over ceil(B / M) clusters; an error when the cluster
// cannot be scheduled (no cluster fits on the card) or the launch fails.
template <typename W, int C>
int launch(bool bwd, const Args<W>& args, cudaStream_t stream) {
  const int smem = layout(bwd, std::is_same<W, __nv_bfloat16>::value, C, args.R, args.F, args.E,
                          args.H).total;
  auto kernel = bwd ? train_bwd_recurrence_kernel<W, C> : train_fwd_kernel<W, C>;
  if (max_clusters(kernel, C, smem) < 1) return (int)cudaErrorInvalidConfiguration;
  const int M = kRowsA * C;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kernel, C, (args.B + M - 1) / M, smem, stream, cfg, attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, args);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename W>
int launch_c(bool bwd, const Args<W>& args, int C, cudaStream_t stream) {
  if (args.H % 8 || args.E % 8 || args.F % 8 || args.H > kMaxH || args.F > kMaxH ||
      args.B < 1 || args.T < 1)
    return (int)cudaErrorInvalidValue;
  switch (C) {
    case 2: return launch<W, 2>(bwd, args, stream);
    case 4: return launch<W, 4>(bwd, args, stream);
    case 8: return launch<W, 8>(bwd, args, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename W>
int clusters_c(bool bwd, int C, int R, int F, int E, int H) {
  const int smem = layout(bwd, std::is_same<W, __nv_bfloat16>::value, C, R, F, E, H).total;
  switch (C) {
    case 2: return max_clusters(bwd ? train_bwd_recurrence_kernel<W, 2> : train_fwd_kernel<W, 2>, 2, smem);
    case 4: return max_clusters(bwd ? train_bwd_recurrence_kernel<W, 4> : train_fwd_kernel<W, 4>, 4, smem);
    case 8: return max_clusters(bwd ? train_bwd_recurrence_kernel<W, 8> : train_fwd_kernel<W, 8>, 8, smem);
    default: return -(int)cudaErrorInvalidValue;
  }
}

template <typename W>
Args<W> fwd_args(const void* const* p, void* hs, int B, int T, int R, int F, int E, int H,
                 int skip) {
  Args<W> a{};
  a.skip = skip;
  a.feats = (const W*)p[0], a.att1 = (const W*)p[1], a.h0 = (const float*)p[2];
  a.embeds = (const float*)p[3], a.ua_b = (const float*)p[4], a.va = (const float*)p[5];
  a.bih = (const float*)p[6], a.bhh = (const float*)p[7], a.wx = p[8], a.wh = p[9];
  a.hs = (float*)hs;
  a.B = B, a.T = T, a.R = R, a.F = F, a.E = E, a.H = H;
  return a;
}

template <typename W>
Args<W> bwd_args(const void* const* p, void* const* o, int B, int T, int R, int F, int E, int H,
                 int skip) {
  Args<W> a = fwd_args<W>(p, nullptr, B, T, R, F, E, H, skip);
  a.wxr = p[10], a.whr = p[11], a.hs_in = (const float*)p[12], a.g = (const float*)p[13];
  a.d_att1 = (W*)o[0], a.d_h0 = (float*)o[1], a.d_emb = (float*)o[2], a.X = (float*)o[3];
  a.DGI = (float*)o[4], a.HP = (float*)o[5], a.DGHN = (float*)o[6], a.DATT2 = (float*)o[7];
  a.dva_part = (float*)o[8], a.w_t = (float*)o[9], a.dctx_t = (W*)o[10];
  return a;
}

using FoldKernel = void (*)(FoldArgs);

// The fold's instance for P regions a thread, allowed `smem` bytes of dynamic
// shared memory; nullptr and the error where that fails.
template <typename W>
FoldKernel fold_kernel(int P, int smem, cudaError_t& err) {
  FoldKernel kernel = nullptr;
  switch (P) {
#define FOLD_CASE(p) \
  case p: kernel = train_feats_fold_kernel<W, p>; break;
    FOLD_CASE(1) FOLD_CASE(2) FOLD_CASE(3) FOLD_CASE(4)
    FOLD_CASE(5) FOLD_CASE(6) FOLD_CASE(7) FOLD_CASE(8)
#undef FOLD_CASE
    default: err = cudaErrorInvalidValue; return nullptr;
  }
  err = smem > 48 * 1024
            ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
            : cudaSuccess;
  return err == cudaSuccess ? kernel : nullptr;
}

// The bytes of shared memory of a fold block: two buffers, each T chunks of
// dctx and T rows of S sets of P w slots (each set's rounded up to 16 bytes).
inline long fold_bytes(int T, int fc, int S, int P) {
  return 2L * T * (fc + S * ((P + 3) / 4)) * 16;
}

// The fold on the plan of train_kernel.fold_plan: items of nr regions and fc
// 16-byte feature chunks, S sets of regions a block, `grid` blocks taking the
// items in turn; its dynamic shared memory must be the one these give.  An
// error for a plan it cannot take.
template <typename W>
int fold(const void* w_t, const void* dctx_t, void* d_feats, int B, int T, int R, int F, int nr,
         int fc, int S, int grid, int smem, int skip, cudaStream_t stream) {
  constexpr int V = Vec<W>::N;
  if (B < 1 || T < 1 || R < 1 || F < 8 || F % 8 || nr < 1 || nr > R || fc < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  const int nv = F / V, P = (nr + S - 1) / S, nrb = (R + nr - 1) / nr, nfb = (nv + fc - 1) / fc;
  if (fc > nv || P > kFoldRegions || (long)S * fc > kFoldThreads) return (int)cudaErrorInvalidValue;
  const long items = (long)B * nrb * nfb;
  if (items >= (1L << 31) || grid < 1 || grid > items || fold_bytes(T, fc, S, P) != smem ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const FoldArgs a{(const float*)w_t, dctx_t, d_feats, T, R, F, nr, fc, S, nv, nrb, nfb,
                   (int)items, skip};
  cudaError_t err;
  const FoldKernel kernel = fold_kernel<W>(P, smem, err);
  if (kernel == nullptr) return (int)err;
  kernel<<<grid, S * fc, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// How many blocks of the fold's instance (P regions a thread) of `threads`
// threads and `smem` bytes an SM runs at once, or a negative CUDA error.
template <typename W>
int fold_resident(int P, int threads, int smem) {
  if (threads < 1 || threads > kFoldThreads || smem < 0 || smem > kMaxSmem)
    return -(int)cudaErrorInvalidValue;
  cudaError_t err;
  const FoldKernel kernel = fold_kernel<W>(P, smem, err);
  int n = 0;
  if (kernel != nullptr)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace rec

// ------------------------------------------------------------ backward, pass 2
// out[m][k] = sum_n A'[n][m] * Bm[n][k] over a chunk of rows n, where A' is A
// with one more column of ones (m == m_data), whose row of out is the column
// sums of Bm: the bias gradient.  Columns k < b_split of Bm come from B, the
// rest from B2 (column k - b_split): [dGI_rz | dGH_n] is one product.
//
// An f32 GEMM for the CUDA cores (the JAX kernel takes these products in f32,
// so no TF32): a 128 x 128 output tile on 256 threads, each an 8 x 8
// register tile (rows ty*8.., columns tx*4.. and 64 + tx*4..), read from
// shared memory as four float4 per 64 FMAs.  The reduction runs over rows n
// and every operand is row-major in n, so a stage (kDepth rows of A' and of
// Bm) is copied straight from contiguous memory by 16-byte cp.async,
// kStages deep, zero-filled past the chunk's last row; with 96 KB of stages
// two blocks share an SM.  The ones column is a constant 1 written once into
// each stage's A slice at m_data (which no copy touches), so the bias row
// costs no tile of its own; a warp whose 16 rows of the tile all lie past
// m_data skips its FMAs, so the ragged edge of M (401 = 3 * 128 + 17,
// 201 = 128 + 73) costs little more than the rows it holds.  What bounds it
// is FMA issue, and about 12% of the FMAs it runs fall outside the products:
// the padding of the last column tile (600 = 4 * 128 + 88, 200 = 128 + 72)
// and the rows of the edge warps past m_data.
constexpr int kTile = 128;   // output rows (of A') and columns per block
constexpr int kDepth = 32;   // rows n per stage
constexpr int kStages = 3;
constexpr int kStageFloats = 2 * kDepth * kTile;
constexpr int kWgradSmem = kStages * kStageFloats * 4;  // 96 KB

struct Product {
  const float* A;
  const float* B;
  const float* B2;
  int lda, m_data, ldb, b_split, ldb2, k_cols, out_off, ldc, tiles_k, tiles;
};

struct Products {
  Product p[3];
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__global__ void __launch_bounds__(256, 2) train_wgrad_partial_kernel(Products prods,
                                                                     float* __restrict__ partial,
                                                                     int N, int total) {
  extern __shared__ float4 wgrad_smem[];
  float* sm = reinterpret_cast<float*>(wgrad_smem);
  int tile = blockIdx.x, q = 0;
  while (tile >= prods.p[q].tiles) tile -= prods.p[q++].tiles;
  const Product& pr = prods.p[q];
  const int m0 = (tile / pr.tiles_k) * kTile, k0 = (tile % pr.tiles_k) * kTile;
  const int per = (N + gridDim.y - 1) / gridDim.y;
  const int n0 = min(N, (int)blockIdx.y * per), n1 = min(N, n0 + per);
  const int steps = (n1 - n0 + kDepth - 1) / kDepth;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // the ones column: written once per stage, never overwritten by a copy
  if (tid < kStages * kDepth && pr.m_data >= m0 && pr.m_data < m0 + kTile)
    sm[(tid / kDepth) * kStageFloats + (tid % kDepth) * kTile + pr.m_data - m0] = 1.f;

  // this thread's copies: chunk c4 (4 floats) of depth rows d0 + 8 p, of A'
  // (columns m) and of Bm (columns k)
  const int c4 = (tid & 31) * 4, d0 = tid >> 5;
  const int m = m0 + c4, k = k0 + c4;
  const float* bsrc = k < pr.b_split ? pr.B + k : pr.B2 + (k - pr.b_split);
  const int ldb = k < pr.b_split ? pr.ldb : pr.ldb2;
  auto load = [&](int step, int stage) {
    float* sA = sm + stage * kStageFloats;
    float* sB = sA + kDepth * kTile;
#pragma unroll
    for (int p = 0; p < kDepth / 8; ++p) {
      const int d = d0 + 8 * p, n = n0 + step * kDepth + d;
      const bool in = n < n1;
      if (m < pr.m_data)
        cp_async16(sA + d * kTile + c4, in ? pr.A + (size_t)n * pr.lda + m : pr.A, in);
      if (k < pr.k_cols) cp_async16(sB + d * kTile + c4, in ? bsrc + (size_t)n * ldb : pr.B, in);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const bool active = m0 + 16 * (tid >> 5) <= pr.m_data;  // this warp holds a row of A'

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int step = 0; step < steps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();  // stage `step` is in; every thread is past step - 1's FMAs
    if (step + kStages - 1 < steps) load(step + kStages - 1, (step + kStages - 1) % kStages);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (!active) continue;
    const float* sA = sm + (step % kStages) * kStageFloats;
    const float* sB = sA + kDepth * kTile;
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const float4 a0 = *reinterpret_cast<const float4*>(sA + d * kTile + ty * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(sA + d * kTile + ty * 8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sB + d * kTile + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(sB + d * kTile + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  float* out = partial + (size_t)blockIdx.y * total + pr.out_off;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty * 8 + i;
    if (r > pr.m_data) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = k0 + 64 * h + tx * 4;
      if (c < pr.k_cols)
        *reinterpret_cast<float4*>(out + (size_t)r * pr.ldc + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

__global__ void train_wgrad_reduce_kernel(const float* __restrict__ partial,
                                          float* __restrict__ out, int total, int splits,
                                          const float* __restrict__ dva_part,
                                          float* __restrict__ d_va, int n_blocks, int H) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < total) {
    float s = 0.f;
    for (int q = 0; q < splits; ++q) s += partial[(size_t)q * total + e];
    out[e] = s;
  } else if (e < total + H) {
    const int j = e - total;
    float s = 0.f;
    for (int b = 0; b < n_blocks; ++b) s += dva_part[(size_t)b * H + j];
    d_va[j] = s;
  }
}

Product product(const float* A, int lda, int m_data, const float* B, int ldb, int b_split,
                const float* B2, int ldb2, int k_cols, int out_off, int ldc) {
  const int tiles_m = (m_data + 1 + kTile - 1) / kTile, tiles_k = (k_cols + kTile - 1) / kTile;
  return Product{A,     B,      B2,  lda,     m_data,           ldb,
                 b_split, ldb2, k_cols, out_off, ldc, tiles_k, tiles_m * tiles_k};
}

}  // namespace

extern "C" {

// hs[B, T, H] = the recurrence of (feats, att1, h0, embeds (unshifted, f32),
// U_a b, v_a, b_ih, b_hh) with the packed weights wx, wh
// (train_kernel.pack_recurrence), on clusters of C CTAs; `skip` (timing
// only) leaves parts out (rec::kSkip*).
#define FWD_PARAMS                                                                         \
  const void *feats, const void *att1, const void *h0, const void *embeds,                \
      const void *ua_b, const void *va, const void *bih, const void *bhh, const void *wx, \
      const void *wh, void *hs, int B, int T, int R, int F, int E, int H, int C, int skip,   \
      void *stream
#define FWD_ARGS(W)                                                                        \
  const void* p[] = {feats, att1, h0, embeds, ua_b, va, bih, bhh, wx, wh};                \
  return rec::launch_c<W>(false, rec::fwd_args<W>(p, hs, B, T, R, F, E, H, skip), C,      \
                          (cudaStream_t)stream);

int train_fwd_f32(FWD_PARAMS) { FWD_ARGS(float) }

int train_fwd_bf16(FWD_PARAMS) { FWD_ARGS(__nv_bfloat16) }

// Pass 1 of the BPTT for the cotangent g of hs: the per-row gradients, the
// fold's operands w_t [B, T, R] (f32) and dctx_t [B, T, F] (W), the pass-2
// rows and one d(v_a) partial per 8 rows.
#define BWD_PARAMS                                                                          \
  const void *feats, const void *att1, const void *h0, const void *embeds,                 \
      const void *ua_b, const void *va, const void *bih, const void *bhh, const void *wx,  \
      const void *wh, const void *wxr, const void *whr, const void *hs, const void *g,     \
      void *d_att1, void *d_h0, void *d_emb, void *X, void *DGI, void *HP, void *DGHN,      \
      void *DATT2, void *dva_part, void *w_t, void *dctx_t, int B, int T, int R, int F,     \
      int E, int H, int C, int skip, void *stream
#define BWD_ARGS(W)                                                                         \
  const void* p[] = {feats, att1, h0, embeds, ua_b, va, bih, bhh, wx, wh, wxr, whr, hs, g}; \
  void* o[] = {d_att1, d_h0, d_emb, X, DGI, HP, DGHN, DATT2, dva_part, w_t, dctx_t};       \
  return rec::launch_c<W>(true, rec::bwd_args<W>(p, o, B, T, R, F, E, H, skip), C,         \
                          (cudaStream_t)stream);

int train_bwd_recurrence_f32(BWD_PARAMS) { BWD_ARGS(float) }

int train_bwd_recurrence_bf16(BWD_PARAMS) { BWD_ARGS(__nv_bfloat16) }

#undef FWD_PARAMS
#undef FWD_ARGS
#undef BWD_PARAMS
#undef BWD_ARGS

// d_feats [B, R, F] (W) from the fold's operands, on a plan of
// train_kernel.fold_plan (regions and 16-byte feature chunks a block, region
// sets a block, the grid and the dynamic shared memory it gives)
#define FOLD_PARAMS                                                                          \
  const void *w_t, const void *dctx_t, void *d_feats, int B, int T, int R, int F, int nr,    \
      int fc, int S, int grid, int smem, int skip, void *stream
int train_feats_fold_f32(FOLD_PARAMS) {
  return rec::fold<float>(w_t, dctx_t, d_feats, B, T, R, F, nr, fc, S, grid, smem, skip,
                          (cudaStream_t)stream);
}

int train_feats_fold_bf16(FOLD_PARAMS) {
  return rec::fold<__nv_bfloat16>(w_t, dctx_t, d_feats, B, T, R, F, nr, fc, S, grid, smem,
                                  skip, (cudaStream_t)stream);
}
#undef FOLD_PARAMS

// How many blocks of the fold (per_thread regions a thread, `threads`
// threads, `smem` bytes) an SM of the current device runs at once, or a
// negative CUDA error.
int train_feats_fold_resident(int bf16, int per_thread, int threads, int smem) {
  return bf16 ? rec::fold_resident<__nv_bfloat16>(per_thread, threads, smem)
              : rec::fold_resident<float>(per_thread, threads, smem);
}

// How many clusters of C CTAs of the forward (bwd = 0) or pass 1 (bwd = 1)
// can run at once on the current device (0: none fits), or a negative CUDA
// error; and the dynamic shared memory of one of their CTAs (bytes).
int train_recurrence_clusters(int bwd, int bf16, int C, int R, int F, int E, int H) {
  return bf16 ? rec::clusters_c<__nv_bfloat16>(bwd != 0, C, R, F, E, H)
              : rec::clusters_c<float>(bwd != 0, C, R, F, E, H);
}

int train_recurrence_smem(int bwd, int bf16, int C, int R, int F, int E, int H) {
  return rec::layout(bwd != 0, bf16 != 0, C, R, F, E, H).total;
}


// The weight-gradient products over the N = T*B rows of pass 1, into
// `splits` partials of the layout of train_kernel.wgrad_layout: [In+1, 3H]
// (w_ih^T, b_ih), [H+1, 3H] (w_hh^T, b_hh), [H+1, H] (U_a w, U_a b).
int train_wgrad_partial(const void* X, const void* DGI, const void* HP, const void* DGHN,
                        const void* DATT2, void* partial, int N, int In, int H, int splits,
                        void* stream) {
  // 16-byte copies and stores: every row and offset a multiple of 4 floats
  if (N <= 0 || splits <= 0 || In % 4 || H % 4) return (int)cudaErrorInvalidValue;
  const int G = 3 * H;
  const int o1 = (In + 1) * G, o2 = o1 + (H + 1) * G, total = o2 + (H + 1) * H;
  const float *x = (const float*)X, *dgi = (const float*)DGI, *hp = (const float*)HP;
  const float *dghn = (const float*)DGHN, *datt2 = (const float*)DATT2;
  Products ps{{product(x, In, In, dgi, G, G, dgi, G, G, 0, G),
               product(hp, H, H, dgi, G, 2 * H, dghn, H, G, o1, G),
               product(hp, H, H, datt2, H, H, datt2, H, H, o2, H)}};
  int tiles = 0;
  for (const Product& pr : ps.p) tiles += pr.tiles;
  const cudaError_t err = cudaFuncSetAttribute(
      train_wgrad_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgradSmem);
  if (err != cudaSuccess) return (int)err;
  train_wgrad_partial_kernel<<<dim3(tiles, splits), 256, kWgradSmem, (cudaStream_t)stream>>>(
      ps, (float*)partial, N, total);
  return (int)cudaGetLastError();
}

// the dynamic shared memory of train_wgrad_partial's kernel (bytes)
int train_wgrad_smem() { return kWgradSmem; }

int train_wgrad_reduce(const void* partial, void* out, int total, int splits,
                       const void* dva_part, void* d_va, int n_blocks, int H, void* stream) {
  const int n = total + H;
  train_wgrad_reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)partial, (float*)out, total, splits, (const float*)dva_part,
      (float*)d_va, n_blocks, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
