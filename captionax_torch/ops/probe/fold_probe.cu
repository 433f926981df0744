// The first design of K3's d_feats fold (train_feats_fold up to the version
// that stages its operands in shared memory), kept to measure what bounds it
// (fold_times.py).  Not part of the library.
//
// A thread per (image b, region rho, 16 bytes of features) loops over
// t = T-1 .. 0 and reads w_t[b, t, rho] and 16 bytes of dctx_t[b, t, :] from
// device memory (L1/L2) at every step.  `mode` 0 is that kernel; 1 keeps its
// loads and folds their bits with one XOR an element (no mul or add: the
// loads alone); 2 keeps its arithmetic on operands loaded once (the
// arithmetic alone; w varies by one XOR of its low bits a step, so that
// each step's product is computed).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

template <typename W>
__global__ void __launch_bounds__(256) old_fold_kernel(const float* __restrict__ w_t,
                                                       const W* __restrict__ dctx_t,
                                                       W* __restrict__ d_feats, int B, int T,
                                                       int R, int F, int mode) {
  constexpr bool kBf16 = std::is_same<W, __nv_bfloat16>::value;
  constexpr int V = kBf16 ? 8 : 4;
  const int fv = F / V;
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long)B * R * fv) return;
  const int ch = (int)(e % fv);
  const long br = e / fv;
  const int rho = (int)(br % R), b = (int)(br / R);
  const float* wp = w_t + (size_t)b * T * R + rho;
  const W* dp = dctx_t + (size_t)b * T * F + ch * V;
  W* out = d_feats + ((size_t)b * R + rho) * F + ch * V;
  unsigned d[4] = {0u, 0u, 0u, 0u};  // bf16x2 pairs, or the bits of f32 sums
  const float w0 = __ldg(wp + (size_t)(T - 1) * R);
  const uint4 x0 = __ldg(reinterpret_cast<const uint4*>(dp + (size_t)(T - 1) * F));
  for (int t = T - 1; t >= 0; --t) {
    float wv = w0;
    uint4 x = x0;
    if (mode != 2) {
      wv = __ldg(wp + (size_t)t * R);
      x = __ldg(reinterpret_cast<const uint4*>(dp + (size_t)t * F));
    } else {
      wv = __uint_as_float(__float_as_uint(w0) ^ (unsigned)t);
    }
    const unsigned dc[4] = {x.x, x.y, x.z, x.w};
    if (mode == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] ^= dc[i] ^ __float_as_uint(wv);
    } else if constexpr (kBf16) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(wv, wv);
      const unsigned w2 = *reinterpret_cast<const unsigned*>(&h);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned p;
        asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(p) : "r"(w2), "r"(dc[i]));
        asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d[i]) : "r"(d[i]), "r"(p));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d[i] = __float_as_uint(
            __fadd_rn(__uint_as_float(d[i]), __fmul_rn(wv, __uint_as_float(dc[i]))));
    }
  }
  *reinterpret_cast<uint4*>(out) = make_uint4(d[0], d[1], d[2], d[3]);
}

}  // namespace

extern "C" int old_fold(int bf16, const void* w_t, const void* dctx_t, void* d_feats, int B,
                        int T, int R, int F, int mode, void* stream) {
  const int V = bf16 ? 8 : 4;
  if (F % V || B < 1 || T < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const long n = (long)B * R * (F / V);
  const unsigned grid = (unsigned)((n + 255) / 256);
  if (bf16)
    old_fold_kernel<__nv_bfloat16><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)w_t, (const __nv_bfloat16*)dctx_t, (__nv_bfloat16*)d_feats, B, T, R, F,
        mode);
  else
    old_fold_kernel<float><<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)w_t, (const float*)dctx_t, (float*)d_feats, B, T, R, F, mode);
  return (int)cudaGetLastError();
}
