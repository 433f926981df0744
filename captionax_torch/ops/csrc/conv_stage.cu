// K4 for Hopper: a chain of stride-1 ResNet bottleneck blocks (NHWC), the
// encoder's convolutions after the stem and the stride-2 first blocks, for
// captionax_torch/ops/conv_kernel.py.
//
// Replaces the TPU kernels `_stage_kernel` / `_stage_kernel_nodown`
// (captionax/ops/conv_kernel.py, launched by `fused_stage`), which keep a
// whole chain of blocks for a few images in 16 MB of VMEM.  On Hopper one
// image's stage-1 activation alone is 1.6 MB in bf16, against 227 KB of
// shared memory per block, so the chain is not kept on chip: each block is
// three launches (four for a block with a projection), and activations pass
// between them through device memory, where a B=64 stage-1 intermediate
// (25.7 MB in bf16) stays mostly in the 50 MB L2.
//
//   conv1x1_bn   out[r, n] = epi(sum_k A[r, k] W[k, n]): the 1x1 convs
//                (conv1 with ReLU; the projection without; conv3 with the
//                residual added before the ReLU).
//   conv3x3_bn   the 3x3 conv with pad 1 as an implicit GEMM with
//                K = 9 * M: column k = tap * M + c (tap = dy * 3 + dx, the
//                order of the JAX kernel's "bigk" patches) reads
//                y1[img, y + dy - 1, x + dx - 1, c], or zero outside the
//                image; no padded copy is written.
//
// Rounding follows the JAX kernel: every product accumulates in f32, the
// epilogue (acc * scale + bias, then + identity, then ReLU) runs in f32 from
// the f32 scale/bias rows, and each output is rounded once to the compute
// type (bf16, or f32).  The projection is rounded before it is added.
//
// What bounds it on this card.  On ResNet-152 at 224^2 the four chains of a
// batch do 20.6 GFLOP per image (1.32 TFLOP at B=64), while their inputs,
// weights and outputs come to 0.41 GB in bf16 (0.12 ms at 3.35 TB/s), so by
// that count they are bound by operations: 1.33 ms at the bf16 tensor-core
// peak (989 TFLOP/s), 19.6 ms at the f32 CUDA-core peak (67 TFLOP/s).  The
// f32 instance stays in full f32 on the CUDA cores (no TF32), 64 x 64
// tiles.  The bf16 instance runs on wgmma (below); what bounds it in
// practice is the traffic from L2 into shared memory, which a tiled GEMM
// multiplies: every block reads its rows of A and its columns of W, so a
// 128 x BN tile re-reads W once per row tile and A once per column tile
// (at B=64 stage 3's tiles read and write about 14 GB per call, counted
// from the shapes, against 0.13 GB of inputs, weights and outputs).  Sharing W between the two CTAs of a
// cluster by TMA multicast halves W's share; synchronised by a cluster
// barrier per depth step it ran slower than the ring below, and a
// warp-specialised pipeline that would not need that barrier is left for
// a later change.
//
// Host cost.  A batch runs 47 stride-1 blocks, ~142 launches; one C entry per
// chain (conv_stage_f32 / conv_stage_bf16) issues all of a chain's launches,
// so a batch costs four calls from Python, and each launch is counted into
// `launches` ([0]: conv1x1_bn, [1]: conv3x3_bn) only once it is issued.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_common.cuh"

namespace conv {

constexpr int kTile = 64;  // output rows and columns per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Where row `r` of the implicit im2col reads tap `tap`: the offset of
// y1[img, y + dy - 1, x + dx - 1, 0], or -1 outside the image.
__device__ __forceinline__ long long tap_offset(int img, int py, int px, int tap, int S, int Cm) {
  const int sy = py + tap / 3 - 1, sx = px + tap % 3 - 1;
  if (sy < 0 || sy >= S || sx < 0 || sx >= S) return -1;
  return ((static_cast<long long>(img) * S + sy) * S + sx) * Cm;
}

// The epilogue of four neighbouring outputs of row r, columns c..c+3:
// v = acc * s + b (+ res), ReLU when asked, rounded once to T.
template <typename T>
__device__ __forceinline__ void epilogue4(const float (&acc)[4], const float* __restrict__ sb,
                                          const T* __restrict__ res, T* __restrict__ out,
                                          long long r, int c, int N, int relu) {
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = acc[j] * sb[c + j] + sb[N + c + j];
  const long long o = r * N + c;
  if (res != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] += to_f(res[o + j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[o + j] = from_f<T>(relu ? fmaxf(v[j], 0.f) : v[j]);
}

// ---------------------------------------------------------------- f32
// 64 x 64 tile, 256 threads as 16 x 16, 4 x 4 outputs each, depth step 16,
// f32 FMA on the CUDA cores.  MODE 0: A is [rows, K] row-major (a 1x1 conv).
// MODE 1: A is the implicit im2col of y1 [B, S, S, Cm], K = 9 * Cm.
constexpr int kBK32 = 16;

template <int MODE>
__global__ void __launch_bounds__(256)
conv_gemm_f32(const float* __restrict__ A, const float* __restrict__ W,
              const float* __restrict__ sb, const float* __restrict__ res,
              float* __restrict__ out, int rows, int K, int N, int S, int Cm, int relu) {
  __shared__ __align__(16) float As[kBK32][kTile + 4];
  __shared__ __align__(16) float Bs[kBK32][kTile];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * kTile, col0 = blockIdx.y * kTile;
  // this thread's loads: 4 depths of A row a_r, 4 columns of W row b_k
  const int a_r = tid >> 2, a_k = (tid & 3) * 4;
  const int b_k = tid >> 4, b_n = (tid & 15) * 4;
  const int arow = row0 + a_r;
  const bool a_ok = arow < rows;
  int img = 0, py = 0, px = 0;
  if (MODE == 1 && a_ok) {
    img = arow / (S * S);
    const int rem = arow - img * S * S;
    py = rem / S;
    px = rem - py * S;
  }
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK32) {
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a_ok) {
      if (MODE == 0) {
        av = *reinterpret_cast<const float4*>(A + static_cast<long long>(arow) * K + k0 + a_k);
      } else {
        const int tap = k0 / Cm;
        const long long off = tap_offset(img, py, px, tap, S, Cm);
        if (off >= 0) av = *reinterpret_cast<const float4*>(A + off + (k0 - tap * Cm) + a_k);
      }
    }
    const float4 bv =
        *reinterpret_cast<const float4*>(W + static_cast<long long>(k0 + b_k) * N + col0 + b_n);
    __syncthreads();  // the previous step's reads are done
    As[a_k + 0][a_r] = av.x;
    As[a_k + 1][a_r] = av.y;
    As[a_k + 2][a_r] = av.z;
    As[a_k + 3][a_r] = av.w;
    *reinterpret_cast<float4*>(&Bs[b_k][b_n]) = bv;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {a.x, a.y, a.z, a.w}, br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r < rows) epilogue4<float>(acc[i], sb, res, out, r, col0 + tx * 4, N, relu);
  }
}

// ---------------------------------------------------------------- bf16
// wgmma (sm_90a): a 128 x BN output tile (BN = 64, 128 or 256, chosen per
// launch by conv_kernel.tile_width) on two warpgroups of 128 threads, each
// one m64nBNk16 product per 16 depths into f32 accumulators in registers.
// The operands come through a ring of kStages shared-memory stages of 64
// depths, filled by 16-byte cp.async copies from all 256 threads (zeros at
// the ragged row edge, past K, and at the 3x3 conv's halo).  Two stages are
// in flight while the tensor cores read a third and the previous step's
// products drain (wgmma.wait_group 1), with one __syncthreads per step.
//   A (rows x 64 depths, K-major): row r's 128 bytes at r * 128, its 16-byte
//     chunk c stored at chunk c ^ (r & 7) -- the 128-byte swizzle that the
//     wgmma descriptor names; 8-row groups 1024 bytes apart.
//   W (64 depths x BN, N-major, read by wgmma as a transposed B): W is
//     [K, N] with N contiguous, so a stage holds BN / 64 column blocks of
//     64 x 64, each 8 KB, depth row kr's 16-byte chunk c at c ^ (kr & 7).
//     The weights are used as packed, with no copy in another layout.
// The epilogue runs from the accumulator registers (see below).
namespace wg {

constexpr int kBM = 128;                 // output rows per block (two warpgroups)
constexpr int kBK = 64;                  // depths per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kABytes = kBM * kBK * 2;   // 16 KB
constexpr int kBlockBytes = kBK * 128;   // one 64 x 64 column block of W, 8 KB

__host__ __device__ constexpr int stage_bytes(int bn) { return kABytes + bn * kBK * 2; }
// the ring, and 1 KB to align it (the swizzle repeats every 1024 bytes)
__host__ __device__ constexpr int smem_bytes(int bn) { return kStages * stage_bytes(bn) + 1024; }

using namespace hopper;  // cp.async, descriptors, wgmma (wgmma_common.cuh)

// MODE 0: A is [rows, K] row-major (a 1x1 conv; K a multiple of 8).
// MODE 1: A is the implicit im2col of y1 [B, S, S, Cm], K = 9 * Cm (Cm a
// multiple of 64, so a stage's 64 depths lie in one tap).
template <int MODE, int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_gemm_bf16(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
               const float* __restrict__ sb, const __nv_bfloat16* __restrict__ res,
               __nv_bfloat16* __restrict__ out, int rows, int K, int N, int S, int Cm, int relu) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kStage = stage_bytes(BN);
  constexpr int kDist = kStages - 2;  // steps between a stage's copy and its products
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * BN;
  const int nk = (K + kBK - 1) / kBK;

  // this thread's A copies: 16-byte chunk ac of tile rows ar + 32 p
  const int ac = tid & 7, ar = tid >> 3;
  bool a_ok[4];
  int img[4], py[4], px[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = row0 + ar + 32 * p;
    a_ok[p] = r < rows;
    img[p] = py[p] = px[p] = 0;
    if (MODE == 1 && a_ok[p]) {
      img[p] = r / (S * S);
      const int rem = r - img[p] * S * S;
      py[p] = rem / S;
      px[p] = rem - py[p] * S;
    }
  }
  const uint32_t a_dst = ar * 128 + ((ac ^ (ar & 7)) << 4);  // + p * 32 rows = p * 4 KB

  auto load = [&](int kt, int stage) {
    const uint32_t sA = base + stage * kStage, sB = sA + kABytes;
    const int k0 = kt * kBK;
    if (MODE == 0) {
      const int k = k0 + ac * 8;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const bool ok = a_ok[p] && k < K;
        const __nv_bfloat16* src =
            ok ? A + static_cast<long long>(row0 + ar + 32 * p) * K + k : A;
        cp_async16(sA + a_dst + p * 4096, src, ok);
      }
    } else {
      const int tap = k0 / Cm, c = k0 - tap * Cm + ac * 8;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const long long off = a_ok[p] ? tap_offset(img[p], py[p], px[p], tap, S, Cm) : -1;
        cp_async16(sA + a_dst + p * 4096, off >= 0 ? A + off + c : A, off >= 0);
      }
    }
    // W: 64 depth rows x BN columns, BN / 8 chunks a row
#pragma unroll
    for (int p = 0; p < BN / 32; ++p) {
      const int idx = tid + kThreads * p, kr = idx / (BN / 8), cn = idx % (BN / 8);
      const bool ok = k0 + kr < K;
      const __nv_bfloat16* src = ok ? W + static_cast<long long>(k0 + kr) * N + col0 + cn * 8 : W;
      cp_async16(sB + (cn >> 3) * kBlockBytes + kr * 128 + (((cn & 7) ^ (kr & 7)) << 4), src, ok);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wgi = tid >> 7;  // this warpgroup's 64 rows of the tile

#pragma unroll
  for (int s = 0; s < kDist; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kDist - 1>();  // this thread's copies of step kt have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();  // everyone's copies of kt are in; the products of kt - 2 are done
    if (kt + kDist < nk) load(kt + kDist, (kt + kDist) % kStages);
    cp_async_commit();
    const uint32_t sA = base + (kt % kStages) * kStage, sB = sA + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      mma<BN>(acc, desc(sA + wgi * 64 * 128 + kk * 32, 16, 1024),
              desc(sB + kk * 16 * 128, kBlockBytes, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // the products of kt - 1 are done: their stage may be refilled
  }

  // The epilogue, from the registers, 16 bytes a lane.  Per pair of 8-column
  // groups jp, jp + 1 the four lanes of a quad hold two columns each of rows
  // r and r + 8 (acc[4 j + 2 i + e]: row r + 8 i, column 8 j + 2 q + e);
  // after a transpose within the quad, lane q holds the eight columns of
  // group jp + (q & 1) of row r + 8 (q >> 1), whose residual it reads and
  // whose bf16 it writes as one 16-byte access: whole 32-byte sectors.  The
  // residual and scale/bias loads of kPairs pairs are issued together, the
  // first ones before the last products end.
  const int t = tid & 127, q = t & 3, quad0 = (t & 31) & ~3;
  const int row = row0 + wgi * 64 + (t >> 5) * 16 + ((t & 31) >> 2) + 8 * (q >> 1);
  const bool row_ok = row < rows;
  const long long row_off = static_cast<long long>(row) * N + col0 + 8 * (q & 1);
  constexpr int kPairs = 2;
  uint4 rv[kPairs];
  float2 sc[kPairs][2], bi[kPairs][2];
  auto fetch = [&](int jp0) {
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      const int jp = jp0 + 2 * u;
      rv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (res != nullptr && row_ok) rv[u] = *reinterpret_cast<const uint4*>(res + row_off + 8 * jp);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = col0 + 8 * (jp + h) + 2 * q;
        sc[u][h] = *reinterpret_cast<const float2*>(sb + c);
        bi[u][h] = *reinterpret_cast<const float2*>(sb + N + c);
      }
    }
  };
  fetch(0);
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int jp0 = 0; jp0 < BN / 8; jp0 += 2 * kPairs) {
    if (jp0 > 0) fetch(jp0);
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      const int jp = jp0 + 2 * u;
      // v[i][h][e]: row r + 8 i, group jp + h, column 2 q + e, scaled and biased
      float v[2][2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          v[i][h][0] = acc[4 * (jp + h) + 2 * i] * sc[u][h].x + bi[u][h].x;
          v[i][h][1] = acc[4 * (jp + h) + 2 * i + 1] * sc[u][h].y + bi[u][h].y;
        }
      // lane q gathers item (q >> 1, q & 1) from every lane of the quad
      float o[8];
#pragma unroll
      for (int step = 0; step < 4; ++step) {
        const int dst = (q + step) & 3, src = (q - step) & 3;  // send to dst, get from src
        const int di = dst >> 1, dh = dst & 1;
        float x0 = di ? (dh ? v[1][1][0] : v[1][0][0]) : (dh ? v[0][1][0] : v[0][0][0]);
        float x1 = di ? (dh ? v[1][1][1] : v[1][0][1]) : (dh ? v[0][1][1] : v[0][0][1]);
        x0 = __shfl_sync(0xffffffffu, x0, quad0 + src);
        x1 = __shfl_sync(0xffffffffu, x1, quad0 + src);
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (w == src) {
            o[2 * w] = x0;
            o[2 * w + 1] = x1;
          }
      }
      const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv[u]);
      uint4 packed;
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 f = __bfloat1622float2(r2[w]);  // zeros without a residual
        float a = o[2 * w] + f.x, b = o[2 * w + 1] + f.y;
        if (relu) {
          a = fmaxf(a, 0.f);
          b = fmaxf(b, 0.f);
        }
        p2[w] = __floats2bfloat162_rn(a, b);
      }
      if (row_ok) *reinterpret_cast<uint4*>(out + row_off + 8 * jp) = packed;
    }
  }
}

}  // namespace wg

// Counts a launch into launches[mode] (0: conv1x1_bn, 1: conv3x3_bn) once it
// is issued; -> the launch's error.
inline int issued(int* launches, int mode) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++launches[mode];
  return 0;
}

// One product of a chain: mode 0 a 1x1 conv, mode 1 the 3x3 conv; `bn` is
// the bf16 tile's width (the f32 tile is 64 x 64).
struct F32Launch {
  int rows, S;
  cudaStream_t stream;
  int* launches;

  int operator()(int mode, int /*bn*/, const float* A, const float* W, const float* sb,
                 const float* res, float* out, int K, int N, int Cm, int relu) const {
    const dim3 grid((rows + kTile - 1) / kTile, N / kTile);
    if (mode == 0)
      conv_gemm_f32<0><<<grid, 256, 0, stream>>>(A, W, sb, res, out, rows, K, N, S, Cm, relu);
    else
      conv_gemm_f32<1><<<grid, 256, 0, stream>>>(A, W, sb, res, out, rows, K, N, S, Cm, relu);
    return issued(launches, mode);
  }
};

struct Bf16Launch {
  int rows, S;
  cudaStream_t stream;
  int* launches;

  template <int MODE, int BN>
  int go(const __nv_bfloat16* A, const __nv_bfloat16* W, const float* sb,
         const __nv_bfloat16* res, __nv_bfloat16* out, int K, int N, int Cm, int relu) const {
    constexpr int smem = wg::smem_bytes(BN);
    const cudaError_t err = cudaFuncSetAttribute(
        wg::conv_gemm_bf16<MODE, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((rows + wg::kBM - 1) / wg::kBM, N / BN);
    wg::conv_gemm_bf16<MODE, BN><<<grid, wg::kThreads, smem, stream>>>(A, W, sb, res, out, rows,
                                                                       K, N, S, Cm, relu);
    return issued(launches, MODE);
  }

  int operator()(int mode, int bn, const __nv_bfloat16* A, const __nv_bfloat16* W,
                 const float* sb, const __nv_bfloat16* res, __nv_bfloat16* out, int K, int N,
                 int Cm, int relu) const {
    if (bn <= 0 || N % bn != 0) return static_cast<int>(cudaErrorInvalidValue);
#define CONV_BF16_GO(BN)                                                               \
  case BN:                                                                             \
    return mode == 0 ? go<0, BN>(A, W, sb, res, out, K, N, Cm, relu)                   \
                     : go<1, BN>(A, W, sb, res, out, K, N, Cm, relu);
    switch (bn) {
      CONV_BF16_GO(64)
      CONV_BF16_GO(128)
      CONV_BF16_GO(256)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef CONV_BF16_GO
  }
};

// The chain: x [B, S, S, Cin] -> out [B, S, S, C] through n blocks.  Block i
// reads `cur` (x for block 0) and writes the buffer that makes the last block
// write `out` (out and tmp alternate); y1, y2 are [B*S*S, M]; idt holds the
// projection of block 0 when there is one.  w1r/sb1r hold blocks 1..n-1.
// bn_m is the bf16 tile width of the launches with N = M (conv1, conv2),
// bn_c of those with N = C (conv3, the projection).
template <typename T, typename Launch>
int run_stage(const Launch& launch, const T* x, const T* w1f, const float* sb1f, const T* wd,
              const float* sbd, const T* w1r, const float* sb1r, const T* w2, const float* sb2,
              const T* w3, const float* sb3, T* out, T* tmp, T* y1, T* y2, T* idt, int B, int S,
              int Cin, int C, int M, int n, int has_down, int* launches, int bn_m, int bn_c) {
  launches[0] = launches[1] = 0;
  const T* none = nullptr;
  int err = 0;
  const T* ident = x;
  if (has_down) {
    if ((err = launch(0, bn_c, x, wd, sbd, none, idt, Cin, C, 0, 0))) return err;
    ident = idt;
  }
  const T* cur = x;
  for (int i = 0; i < n; ++i) {
    const T* w1 = i == 0 ? w1f : w1r + static_cast<long long>(i - 1) * C * M;
    const float* s1 = i == 0 ? sb1f : sb1r + static_cast<long long>(i - 1) * 2 * M;
    T* dst = ((n - 1 - i) % 2 == 0) ? out : tmp;
    if ((err = launch(0, bn_m, cur, w1, s1, none, y1, i == 0 ? Cin : C, M, 0, 1))) return err;
    const long long b = i;
    if ((err = launch(1, bn_m, static_cast<const T*>(y1), w2 + b * 9 * M * M, sb2 + b * 2 * M,
                      none, y2, 9 * M, M, M, 1)))
      return err;
    if ((err = launch(0, bn_c, static_cast<const T*>(y2), w3 + b * M * C, sb3 + b * 2 * C,
                      i == 0 ? ident : cur, dst, M, C, 0, 1)))
      return err;
    cur = dst;
  }
  return 0;
}

}  // namespace conv

#define STAGE_PARAMS                                                                         \
  const void *x, const void *w1f, const void *sb1f, const void *wd, const void *sbd,        \
      const void *w1r, const void *sb1r, const void *w2, const void *sb2, const void *w3,   \
      const void *sb3, void *out, void *tmp, void *y1, void *y2, void *idt, int B, int S,   \
      int Cin, int C, int M, int n, int has_down, int *launches, void *stream

#define STAGE_ARGS(T)                                                                        \
  static_cast<const T*>(x), static_cast<const T*>(w1f), static_cast<const float*>(sb1f),    \
      static_cast<const T*>(wd), static_cast<const float*>(sbd), static_cast<const T*>(w1r), \
      static_cast<const float*>(sb1r), static_cast<const T*>(w2),                            \
      static_cast<const float*>(sb2), static_cast<const T*>(w3),                             \
      static_cast<const float*>(sb3), static_cast<T*>(out), static_cast<T*>(tmp),            \
      static_cast<T*>(y1), static_cast<T*>(y2), static_cast<T*>(idt), B, S, Cin, C, M, n,   \
      has_down, launches

extern "C" {

int conv_stage_f32(STAGE_PARAMS) {
  const conv::F32Launch launch{B * S * S, S, static_cast<cudaStream_t>(stream), launches};
  return conv::run_stage<float>(launch, STAGE_ARGS(float), 0, 0);
}

// bn_m, bn_c: the tile widths of conv_kernel.tile_width (64, 128 or 256)
int conv_stage_bf16(STAGE_PARAMS, int bn_m, int bn_c) {
  const conv::Bf16Launch launch{B * S * S, S, static_cast<cudaStream_t>(stream), launches};
  return conv::run_stage<__nv_bfloat16>(launch, STAGE_ARGS(__nv_bfloat16), bn_m, bn_c);
}

// the dynamic shared memory of the bf16 kernel at tile width bn (bytes)
int conv_stage_bf16_smem(int bn) { return conv::wg::smem_bytes(bn); }

}  // extern "C"
