// K3 for Hopper: the teacher-forced attention-GRU recurrence of training,
// forward and backward (BPTT), for the autograd Function of
// captionax_torch/ops/train_kernel.py.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel`
// (captionax/ops/train_kernel.py, launched by `_fused_fwd_call` and
// `_fused_core_bwd`), which hold the whole T-step loop of a row tile in VMEM
// and accumulate the weight gradients into one output block that every
// (sequential) grid step revisits.  Four kernels here:
//
//   train_fwd             one block per tile of RT rows loops over all T
//                         steps: att2 = U_a h, Bahdanau attention with att1
//                         precomputed, context, GRU; h stays in shared
//                         memory, hs[B, T, H] (f32) is written per step.
//   train_bwd_recurrence  one block per tile of RT rows runs the exact BPTT
//                         in reverse time, recomputing each step from
//                         h_{t-1} (read from hs).  It writes the per-row
//                         gradients (d_feats and d_att1, accumulated in the
//                         compute type by a read-modify-write of the row's
//                         own slice, no atomics; d_h0; d_emb shifted back a
//                         step), and for every (step t, row b) the operands
//                         of the weight gradients as row n = t*B + b of
//                         X = [word, ctx], dGI, Hprev, dGH_n and dATT2 (f32),
//                         and its block's partial of d(v_a).
//   train_wgrad_partial   the weight gradients as products over all T*B
//                         rows, [X|1]^T dGI, [Hprev|1]^T [dGI_rz|dGH_n] and
//                         [Hprev|1]^T dATT2 (the ones column gives the bias
//                         gradients): a pipelined f32 GEMM in 128 x 128
//                         output tiles, each over one of `splits` chunks of
//                         rows, into partials (design at pass 2 below).
//   train_wgrad_reduce    sums the partials over the chunks, and d(v_a)
//                         over the blocks of the recurrence, in a fixed
//                         order: the gradients are deterministic.
//
// What bounds it on this card.  Hopper's blocks run in parallel in no order,
// and d(w_ih) alone is 400 x 600 f32 (960 KB), beyond a block's 227 KB of
// shared memory, so the TPU's revisited accumulator becomes the second pass
// over rows in device memory (about 200 MB at B=1024, T=25).  Per row and
// step the recurrence does ~0.85 MFLOP (U_a, w_ih, w_hh products and the
// 49-region attention) forward and about twice that backward, 22 and 44
// GFLOP at B=1024, T=25, plus 0.25 G tanh per pass; the 0.8-1.6 MB of
// weights do not fit on chip either, so they are read from L2 once per tile
// and step and each weight is reused across the tile's RT rows (the design
// of K1's cell kernel).  The recurrence kernels compute in f32 on the CUDA
// cores, bf16 being a storage type; tensor cores (wgmma) are their next
// step.  Pass 2 is 20.6 GFLOP of f32 products at B=1024, T=25 (0.31 ms at
// the 67 TFLOP/s f32 peak), which the JAX kernel takes in f32 too.
//
// Rounding.  The kernels round to the compute type W where the JAX kernel
// keeps a value in it (rnd<W>): att2, the attention temporaries, the scores
// and context, the operands of the products, dctx, ds, da, d(pre-tanh), and
// the d_feats / d_att1 accumulators; sums are taken in f32 and rounded at
// their end.  For W = float every rnd is the identity.
//
// Plain C interface, loaded with ctypes; every entry returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "decode_common.cuh"

namespace {

using namespace decode;

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

// The forward of one step for the tile's rows, from sh/shc (h and h rounded
// to W) and the word in sx/sxc[0:E]: sa2 = rnd(rnd(h).U_a + b), the
// attention weights sw, the context into sx/sxc[E:].  Ends synchronised.
template <typename W, int RT>
__device__ void attend(const W* __restrict__ feats, const W* __restrict__ att1,
                       const W* __restrict__ ua_w, const float* __restrict__ ua_b,
                       const float* __restrict__ va, const float* shc, float* sx, float* sxc,
                       float* sa2, float* sw, int r0, int nr, int R, int F, int E, int H) {
  using C = Cvt<W>;
  const int In = E + F;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  for (int j = tid; j < H; j += nt) {
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    for (int i = 0; i < H; ++i) {
      const float w = to_f(ua_w[(size_t)i * H + j]);
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] += shc[r * H + i] * w;
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) sa2[r * H + j] = C::rnd(acc[r] + ua_b[j]);
  }
  __syncthreads();

  for (int p = warp; p < nr * R; p += nw) {  // scores: one warp per (row, region)
    const int r = p / R, rho = p % R;
    const W* a1 = att1 + ((size_t)(r0 + r) * R + rho) * H;
    float s = 0.f;
    for (int j = lane; j < H; j += 32) {
      const float a = C::rnd(tanhf(C::rnd(to_f(a1[j]) + sa2[r * H + j])));
      s += C::rnd(a * C::rnd(va[j]));
    }
    s = warp_sum(s);
    if (lane == 0) sw[r * R + rho] = C::rnd(s);
  }
  __syncthreads();

  for (int r = warp; r < nr; r += nw) {  // softmax over regions, in f32
    float m = -INFINITY;
    for (int rho = lane; rho < R; rho += 32) m = fmaxf(m, sw[r * R + rho]);
    m = warp_max(m);
    float sum = 0.f;
    for (int rho = lane; rho < R; rho += 32) {
      const float e = expf(sw[r * R + rho] - m);
      sw[r * R + rho] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int rho = lane; rho < R; rho += 32) sw[r * R + rho] = sw[r * R + rho] / sum;
  }
  __syncthreads();

  for (int e = tid; e < RT * F; e += nt) {  // context: one thread per (row, feature)
    const int r = e / F, f = e % F;
    float c = 0.f;
    if (r < nr) {
      const W* fp = feats + (size_t)(r0 + r) * R * F + f;
      for (int rho = 0; rho < R; ++rho)
        c += C::rnd(C::rnd(sw[r * R + rho]) * to_f(fp[(size_t)rho * F]));
    }
    c = C::rnd(c);
    sx[r * In + E + f] = c;
    sxc[r * In + E + f] = c;
  }
  __syncthreads();
}

// The three gate pre-activations of column j for the tile's rows:
// gi[k][r] = rnd(x_r) . w_ih^T[:, kH + j] + b_ih, gh likewise from rnd(h_r).
template <typename W, int RT>
__device__ __forceinline__ void gates(const W* __restrict__ wih, const W* __restrict__ whh,
                                      const float* __restrict__ bih,
                                      const float* __restrict__ bhh, const float* sxc,
                                      const float* shc, int j, int In, int H,
                                      float (&gi)[3][RT], float (&gh)[3][RT]) {
  const int G = 3 * H;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int r = 0; r < RT; ++r) gi[k][r] = gh[k][r] = 0.f;
  for (int i = 0; i < In; ++i) {
    const W* wr = wih + (size_t)i * G + j;
    const float w0 = to_f(wr[0]), w1 = to_f(wr[H]), w2 = to_f(wr[2 * H]);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float x = sxc[r * In + i];
      gi[0][r] += x * w0;
      gi[1][r] += x * w1;
      gi[2][r] += x * w2;
    }
  }
  for (int i = 0; i < H; ++i) {
    const W* wr = whh + (size_t)i * G + j;
    const float w0 = to_f(wr[0]), w1 = to_f(wr[H]), w2 = to_f(wr[2 * H]);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float x = shc[r * H + i];
      gh[0][r] += x * w0;
      gh[1][r] += x * w1;
      gh[2][r] += x * w2;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      gi[k][r] += bih[k * H + j];
      gh[k][r] += bhh[k * H + j];
    }
}

// Loads h_{t-1} (row r at src_h[(h_row0 + r) * h_stride]) and the word of
// step t (zero at t = 0, else embeds[b, t-1]) for the tile's rows, each
// also rounded to W.
template <typename W, int RT>
__device__ void load_step(const float* src_h, int h_row0, size_t h_stride,
                          const float* __restrict__ embeds, int t, int T, float* sh,
                          float* shc, float* sx, float* sxc, int r0, int nr, int E, int F,
                          int H) {
  using C = Cvt<W>;
  const int In = E + F;
  for (int e = threadIdx.x; e < RT * H; e += blockDim.x) {
    const int r = e / H;
    const float v = r < nr ? src_h[(size_t)(h_row0 + r) * h_stride + e % H] : 0.f;
    sh[e] = v;
    shc[e] = C::rnd(v);
  }
  for (int e = threadIdx.x; e < RT * E; e += blockDim.x) {
    const int r = e / E, j = e % E;
    const float v =
        (r < nr && t > 0) ? embeds[((size_t)(r0 + r) * T + t - 1) * E + j] : 0.f;
    sx[r * In + j] = v;
    sxc[r * In + j] = C::rnd(v);
  }
}

// ------------------------------------------------------------ forward
template <typename W, int RT>
__global__ void __launch_bounds__(256) train_fwd_kernel(
    const W* __restrict__ feats, const W* __restrict__ att1, const float* __restrict__ h0,
    const float* __restrict__ embeds, const W* __restrict__ ua_w,
    const float* __restrict__ ua_b, const float* __restrict__ va, const W* __restrict__ wih,
    const W* __restrict__ whh, const float* __restrict__ bih, const float* __restrict__ bhh,
    float* __restrict__ hs, int B, int T, int R, int F, int E, int H) {
  extern __shared__ float smem[];
  const int In = E + F;
  float* sh = smem;            // [RT, H]   h (f32)
  float* shc = sh + RT * H;    // [RT, H]   h rounded to W
  float* shn = shc + RT * H;   // [RT, H]   the new h
  float* sx = shn + RT * H;    // [RT, In]  x = [word, ctx]
  float* sxc = sx + RT * In;   // [RT, In]  x rounded to W
  float* sa2 = sxc + RT * In;  // [RT, H]   att2
  float* sw = sa2 + RT * H;    // [RT, R]   scores -> attention weights
  const int r0 = blockIdx.x * RT, nr = min(RT, B - r0);
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int t = 0; t < T; ++t) {
    if (t == 0)
      load_step<W, RT>(h0, r0, H, embeds, 0, T, sh, shc, sx, sxc, r0, nr, E, F, H);
    else
      load_step<W, RT>(shn, 0, H, embeds, t, T, sh, shc, sx, sxc, r0, nr, E, F, H);
    __syncthreads();
    attend<W, RT>(feats, att1, ua_w, ua_b, va, shc, sx, sxc, sa2, sw, r0, nr, R, F, E, H);
    for (int j = tid; j < H; j += nt) {
      float gi[3][RT], gh[3][RT];
      gates<W, RT>(wih, whh, bih, bhh, sxc, shc, j, In, H, gi, gh);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float rg = sigmoidf(gi[0][r] + gh[0][r]);
        const float zg = sigmoidf(gi[1][r] + gh[1][r]);
        const float ng = tanhf(gi[2][r] + rg * gh[2][r]);
        const float hn = (1.f - zg) * ng + zg * sh[r * H + j];
        shn[r * H + j] = hn;
        if (r < nr) hs[((size_t)(r0 + r) * T + t) * H + j] = hn;
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ backward, pass 1
template <typename W, int RT>
__global__ void __launch_bounds__(256) train_bwd_recurrence_kernel(
    const W* __restrict__ feats, const W* __restrict__ att1, const float* __restrict__ h0,
    const float* __restrict__ embeds, const W* __restrict__ ua_w,
    const float* __restrict__ ua_b, const float* __restrict__ va, const W* __restrict__ wih,
    const W* __restrict__ whh, const float* __restrict__ bih, const float* __restrict__ bhh,
    const float* __restrict__ hs, const float* __restrict__ g, W* __restrict__ d_feats,
    W* __restrict__ d_att1, float* __restrict__ d_h0, float* __restrict__ d_emb,
    float* __restrict__ X, float* __restrict__ DGI, float* __restrict__ HP,
    float* __restrict__ DGHN, float* __restrict__ DATT2, float* __restrict__ dva_part,
    int B, int T, int R, int F, int E, int H) {
  using C = Cvt<W>;
  extern __shared__ float smem[];
  const int In = E + F, G = 3 * H;
  float* sh = smem;              // [RT, H]   h_{t-1}
  float* shc = sh + RT * H;      // [RT, H]   h_{t-1} rounded to W
  float* sx = shc + RT * H;      // [RT, In]  x = [word, ctx]
  float* sxc = sx + RT * In;     // [RT, In]  x rounded to W
  float* sa2 = sxc + RT * In;    // [RT, H]   att2
  float* sw = sa2 + RT * H;      // [RT, R]   attention weights
  float* sdh = sw + RT * R;      // [RT, H]   dL/dh_t carried back from step t+1
  float* sdhp = sdh + RT * H;    // [RT, H]   dL/dh_{t-1}, being summed
  float* sdgi = sdhp + RT * H;   // [RT, G]   dgi rounded to W
  float* sdgh = sdgi + RT * G;   // [RT, G]   dgh rounded to W
  float* sdx = sdgh + RT * G;    // [RT, In]  dx = dgi . w_ih
  float* sdxc = sdx + RT * In;   // [RT, In]  dx rounded to W
  float* sdw = sdxc + RT * In;   // [RT, R]   dL/d(attention weights)
  float* sds = sdw + RT * R;     // [RT, R]   dL/d(scores)
  float* sdat = sds + RT * R;    // [RT, H]   datt2 (W-valued)
  float* sdva = sdat + RT * H;   // [H]       this block's d(v_a)
  const int r0 = blockIdx.x * RT, nr = min(RT, B - r0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;

  for (int e = tid; e < RT * H; e += nt) sdh[e] = 0.f;
  for (int j = tid; j < H; j += nt) sdva[j] = 0.f;

  for (int t = T - 1; t >= 0; --t) {
    const bool first = t == T - 1;
    if (t == 0)
      load_step<W, RT>(h0, r0, H, embeds, 0, T, sh, shc, sx, sxc, r0, nr, E, F, H);
    else
      load_step<W, RT>(hs + (size_t)(t - 1) * H, r0, (size_t)T * H, embeds, t, T, sh, shc,
                       sx, sxc, r0, nr, E, F, H);
    __syncthreads();
    attend<W, RT>(feats, att1, ua_w, ua_b, va, shc, sx, sxc, sa2, sw, r0, nr, R, F, E, H);

    // the pass-2 rows of x and h_{t-1}
    for (int e = tid; e < nr * In; e += nt) {
      const int r = e / In, i = e % In;
      X[((size_t)t * B + r0 + r) * In + i] = sx[r * In + i];
    }
    for (int e = tid; e < nr * H; e += nt) {
      const int r = e / H, i = e % H;
      HP[((size_t)t * B + r0 + r) * H + i] = sh[r * H + i];
    }

    // the GRU step and its backward, one thread per column j
    for (int j = tid; j < H; j += nt) {
      float gi[3][RT], gh[3][RT];
      gates<W, RT>(wih, whh, bih, bhh, sxc, shc, j, In, H, gi, gh);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float rg = sigmoidf(gi[0][r] + gh[0][r]);
        const float zg = sigmoidf(gi[1][r] + gh[1][r]);
        const float ng = tanhf(gi[2][r] + rg * gh[2][r]);
        const float gt = r < nr ? g[((size_t)(r0 + r) * T + t) * H + j] : 0.f;
        const float dh_new = gt + sdh[r * H + j];
        const float dz = dh_new * (sh[r * H + j] - ng);
        const float dn = dh_new * (1.f - zg);
        const float dpre_n = dn * (1.f - ng * ng);
        const float dr = dpre_n * gh[2][r];
        const float dpre_r = dr * rg * (1.f - rg);
        const float dpre_z = dz * zg * (1.f - zg);
        const float dghn = dpre_n * rg;
        sdhp[r * H + j] = dh_new * zg;
        sdgi[r * G + j] = C::rnd(dpre_r);
        sdgi[r * G + H + j] = C::rnd(dpre_z);
        sdgi[r * G + 2 * H + j] = C::rnd(dpre_n);
        sdgh[r * G + j] = C::rnd(dpre_r);
        sdgh[r * G + H + j] = C::rnd(dpre_z);
        sdgh[r * G + 2 * H + j] = C::rnd(dghn);
        if (r < nr) {
          float* dgi_row = DGI + ((size_t)t * B + r0 + r) * G;
          dgi_row[j] = dpre_r;
          dgi_row[H + j] = dpre_z;
          dgi_row[2 * H + j] = dpre_n;
          DGHN[((size_t)t * B + r0 + r) * H + j] = dghn;
        }
      }
    }
    __syncthreads();

    // dx = rnd(dgi) . w_ih (rows of w_ih^T) and dh += rnd(dgh) . w_hh: one
    // warp per input index, lanes along the gates
    for (int p = warp; p < In + H; p += nw) {
      const bool is_x = p < In;
      const int i = is_x ? p : p - In;
      const W* wr = is_x ? wih + (size_t)i * G : whh + (size_t)i * G;
      const float* d = is_x ? sdgi : sdgh;
      float acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = 0.f;
      for (int k = lane; k < G; k += 32) {
        const float w = to_f(wr[k]);
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] += d[r * G + k] * w;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = warp_sum(acc[r]);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (is_x) {
            sdx[r * In + i] = acc[r];
            sdxc[r * In + i] = C::rnd(acc[r]);
          } else {
            sdhp[r * H + i] += acc[r];
          }
        }
      }
    }
    __syncthreads();

    // d_emb (the word of step t is embeds[b, t-1]; step 0's zero word has none)
    for (int e = tid; e < nr * E; e += nt) {
      const int r = e / E, j = e % E;
      float* de = d_emb + (size_t)(r0 + r) * T * E + j;
      if (t > 0) de[(size_t)(t - 1) * E] = sdx[r * In + j];
      if (first) de[(size_t)(T - 1) * E] = 0.f;
    }
    // dw[rho] = rnd(dctx . feats[rho]): one warp per (row, region)
    for (int p = warp; p < nr * R; p += nw) {
      const int r = p / R, rho = p % R;
      const W* fr = feats + ((size_t)(r0 + r) * R + rho) * F;
      float s = 0.f;
      for (int f = lane; f < F; f += 32) s += C::rnd(sdxc[r * In + E + f] * to_f(fr[f]));
      s = warp_sum(s);
      if (lane == 0) sdw[r * R + rho] = C::rnd(s);
    }
    // d_feats += rnd(rnd(w) * dctx), accumulated in W
    for (int e = tid; e < nr * F; e += nt) {
      const int r = e / F, f = e % F;
      const float dc = sdxc[r * In + E + f];
      W* df = d_feats + (size_t)(r0 + r) * R * F + f;
      for (int rho = 0; rho < R; ++rho) {
        const float v = C::rnd(C::rnd(sw[r * R + rho]) * dc);
        const float old = first ? 0.f : to_f(df[(size_t)rho * F]);
        df[(size_t)rho * F] = C::to_w(old + v);
      }
    }
    __syncthreads();

    for (int r = warp; r < nr; r += nw) {  // ds = w * (dw - sum(w * dw)), in f32
      float s = 0.f;
      for (int rho = lane; rho < R; rho += 32) s += sw[r * R + rho] * sdw[r * R + rho];
      s = warp_sum(s);
      for (int rho = lane; rho < R; rho += 32)
        sds[r * R + rho] = sw[r * R + rho] * (sdw[r * R + rho] - s);
    }
    __syncthreads();

    // the attention backward per column j: d_att1, datt2 and d(v_a)
    for (int j = tid; j < H; j += nt) {
      const float vac = C::rnd(va[j]);
      float dva = sdva[j];
      for (int r = 0; r < nr; ++r) {
        const W* a1 = att1 + (size_t)(r0 + r) * R * H + j;
        W* da1 = d_att1 + (size_t)(r0 + r) * R * H + j;
        float dat = 0.f;
        for (int rho = 0; rho < R; ++rho) {
          const float a = C::rnd(tanhf(C::rnd(to_f(a1[(size_t)rho * H]) + sa2[r * H + j])));
          const float ds = sds[r * R + rho];
          const float da = C::rnd(C::rnd(ds) * vac);
          const float de = C::rnd(da * C::rnd(1.f - C::rnd(a * a)));
          const float old = first ? 0.f : to_f(da1[(size_t)rho * H]);
          da1[(size_t)rho * H] = C::to_w(old + de);
          dat += de;
          dva += a * ds;
        }
        dat = C::rnd(dat);
        sdat[r * H + j] = dat;
        DATT2[((size_t)t * B + r0 + r) * H + j] = dat;
      }
      sdva[j] = dva;
    }
    __syncthreads();

    // dh_{t-1} += datt2 . U_a^T: one warp per index of h
    for (int p = warp; p < H * nr; p += nw) {
      const int r = p / H, i = p % H;
      const W* wr = ua_w + (size_t)i * H;
      float acc = 0.f;
      for (int k = lane; k < H; k += 32) acc += sdat[r * H + k] * to_f(wr[k]);
      acc = warp_sum(acc);
      if (lane == 0) sdh[r * H + i] = sdhp[r * H + i] + acc;
    }
    __syncthreads();
  }

  for (int e = tid; e < nr * H; e += nt) d_h0[(size_t)r0 * H + e] = sdh[e];
  for (int j = tid; j < H; j += nt) dva_part[(size_t)blockIdx.x * H + j] = sdva[j];
}

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

size_t fwd_smem(int RT, int R, int F, int E, int H) {
  return sizeof(float) * (size_t)RT * (4 * H + 2 * (E + F) + R);
}

size_t bwd_smem(int RT, int R, int F, int E, int H) {
  return sizeof(float) * ((size_t)RT * (6 * H + 4 * (E + F) + 6 * H + 3 * R) + H);
}

template <typename W, int RT>
int launch_fwd(const void* const* p, void* hs, int B, int T, int R, int F, int E, int H,
               cudaStream_t stream) {
  const size_t smem = fwd_smem(RT, R, F, E, H);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(train_fwd_kernel<W, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  train_fwd_kernel<W, RT><<<(B + RT - 1) / RT, 256, smem, stream>>>(
      (const W*)p[0], (const W*)p[1], (const float*)p[2], (const float*)p[3], (const W*)p[4],
      (const float*)p[5], (const float*)p[6], (const W*)p[7], (const W*)p[8],
      (const float*)p[9], (const float*)p[10], (float*)hs, B, T, R, F, E, H);
  return (int)cudaGetLastError();
}

template <typename W, int RT>
int launch_bwd(const void* const* p, void* const* o, int B, int T, int R, int F, int E, int H,
               cudaStream_t stream) {
  const size_t smem = bwd_smem(RT, R, F, E, H);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(train_bwd_recurrence_kernel<W, RT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  train_bwd_recurrence_kernel<W, RT><<<(B + RT - 1) / RT, 256, smem, stream>>>(
      (const W*)p[0], (const W*)p[1], (const float*)p[2], (const float*)p[3], (const W*)p[4],
      (const float*)p[5], (const float*)p[6], (const W*)p[7], (const W*)p[8],
      (const float*)p[9], (const float*)p[10], (const float*)p[11], (const float*)p[12],
      (W*)o[0], (W*)o[1], (float*)o[2], (float*)o[3], (float*)o[4], (float*)o[5],
      (float*)o[6], (float*)o[7], (float*)o[8], (float*)o[9], B, T, R, F, E, H);
  return (int)cudaGetLastError();
}

// The one row tile instantiated (train_kernel.BLOCK_ROWS): B=1024 gives 256
// blocks on the 132 SMs.
constexpr int kTrainRows = 4;

template <typename W>
int fwd_entry(const void* const* p, void* hs, int B, int T, int R, int F, int E, int H,
              int block_rows, void* stream) {
  if (block_rows != kTrainRows) return (int)cudaErrorInvalidValue;
  return launch_fwd<W, kTrainRows>(p, hs, B, T, R, F, E, H, (cudaStream_t)stream);
}

template <typename W>
int bwd_entry(const void* const* p, void* const* o, int B, int T, int R, int F, int E, int H,
              int block_rows, void* stream) {
  if (block_rows != kTrainRows) return (int)cudaErrorInvalidValue;
  return launch_bwd<W, kTrainRows>(p, o, B, T, R, F, E, H, (cudaStream_t)stream);
}

Product product(const float* A, int lda, int m_data, const float* B, int ldb, int b_split,
                const float* B2, int ldb2, int k_cols, int out_off, int ldc) {
  const int tiles_m = (m_data + 1 + kTile - 1) / kTile, tiles_k = (k_cols + kTile - 1) / kTile;
  return Product{A,     B,      B2,  lda,     m_data,           ldb,
                 b_split, ldb2, k_cols, out_off, ldc, tiles_k, tiles_m * tiles_k};
}

}  // namespace

extern "C" {

// hs[B, T, H] = the recurrence of (feats, att1, h0, embeds, ua_w, ua_b, va,
// wih^T, whh^T, bih, bhh); embeds unshifted [B, T, E], f32.
#define FWD_PARAMS                                                                        \
  const void *feats, const void *att1, const void *h0, const void *embeds,               \
      const void *ua_w, const void *ua_b, const void *va, const void *wih,               \
      const void *whh, const void *bih, const void *bhh, void *hs, int B, int T, int R,  \
      int F, int E, int H, int block_rows, void *stream
#define FWD_ARGS                                                                          \
  const void* p[] = {feats, att1, h0, embeds, ua_w, ua_b, va, wih, whh, bih, bhh};        \
  return fwd_entry

int train_fwd_f32(FWD_PARAMS) {
  FWD_ARGS<float>(p, hs, B, T, R, F, E, H, block_rows, stream);
}

int train_fwd_bf16(FWD_PARAMS) {
  FWD_ARGS<__nv_bfloat16>(p, hs, B, T, R, F, E, H, block_rows, stream);
}

#define BWD_PARAMS                                                                        \
  const void *feats, const void *att1, const void *h0, const void *embeds,               \
      const void *ua_w, const void *ua_b, const void *va, const void *wih,               \
      const void *whh, const void *bih, const void *bhh, const void *hs, const void *g,  \
      void *d_feats, void *d_att1, void *d_h0, void *d_emb, void *X, void *DGI, void *HP, \
      void *DGHN, void *DATT2, void *dva_part, int B, int T, int R, int F, int E, int H,  \
      int block_rows, void *stream
#define BWD_ARGS                                                                          \
  const void* p[] = {feats, att1, h0, embeds, ua_w, ua_b, va, wih, whh, bih, bhh, hs, g}; \
  void* o[] = {d_feats, d_att1, d_h0, d_emb, X, DGI, HP, DGHN, DATT2, dva_part};          \
  return bwd_entry

int train_bwd_recurrence_f32(BWD_PARAMS) {
  BWD_ARGS<float>(p, o, B, T, R, F, E, H, block_rows, stream);
}

int train_bwd_recurrence_bf16(BWD_PARAMS) {
  BWD_ARGS<__nv_bfloat16>(p, o, B, T, R, F, E, H, block_rows, stream);
}

#undef FWD_PARAMS
#undef FWD_ARGS
#undef BWD_PARAMS
#undef BWD_ARGS

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
