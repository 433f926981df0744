// The cell kernel (a) as it stood before its redesign on the tensor cores,
// with switches that leave out one part at a time, so that a run can split
// its time into the U_a product, the attention (scores, softmax, context)
// and the gate products.  Built and timed by cell_parts.py; not part of the
// library.  MODE bits: 1 leaves out U_a h (att2 = b), 2 the attention
// (ctx = 0), 4 the gates (h_new = h).  Everything else is the old kernel;
// MODE is a template argument, so that MODE 0 compiles to the old kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "../csrc/decode_common.cuh"

namespace {

using namespace decode;

template <typename W, int RT, bool MULTI, int mode>
__global__ void __launch_bounds__(256) cell_parts_kernel(
    const W* __restrict__ feats, const W* __restrict__ att1, const float* __restrict__ h,
    const int* __restrict__ tok, const int* __restrict__ styles, int t,
    const W* __restrict__ emb, const W* __restrict__ ua_w, const float* __restrict__ ua_b,
    const float* __restrict__ va, const W* __restrict__ wih, const W* __restrict__ whh,
    const float* __restrict__ bih, const float* __restrict__ bhh, float* __restrict__ h_new,
    int rows, int rows_per_image, int R, int F, int E, int H, int S) {
  extern __shared__ float smem[];
  const int In = E + F, G = 3 * H;
  float* sh = smem;
  float* sx = sh + RT * H;
  float* sa2 = sx + RT * In;
  float* sw = sa2 + RT * H;
  const int r0 = blockIdx.x * RT;
  const int nr = min(RT, rows - r0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;

  for (int e = tid; e < RT * H; e += nt) {
    const int r = e / H;
    sh[e] = r < nr ? h[(size_t)(r0 + r) * H + e % H] : 0.f;
  }
  for (int e = tid; e < RT * E; e += nt) {
    const int r = e / E, j = e % E;
    float v = 0.f;
    if (r < nr && t > 0) v = to_f(emb[(size_t)tok[r0 + r] * E + j]);
    sx[r * In + j] = v;
  }
  __syncthreads();

  for (int j = tid; j < H; j += nt) {
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    if (!(mode & 1))
      for (int i = 0; i < H; ++i) {
        const float w = to_f(ua_w[(size_t)i * H + j]);
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] += sh[r * H + i] * w;
      }
#pragma unroll
    for (int r = 0; r < RT; ++r) sa2[r * H + j] = acc[r] + ua_b[j];
  }
  __syncthreads();

  if (!(mode & 2)) {
    for (int p = warp; p < nr * R; p += nw) {
      const int r = p / R, rho = p % R;
      const W* a1 = att1 + ((size_t)((r0 + r) / rows_per_image) * R + rho) * H;
      float s = 0.f;
      for (int j = lane; j < H; j += 32) s += tanhf(to_f(a1[j]) + sa2[r * H + j]) * va[j];
      s = warp_sum(s);
      if (lane == 0) sw[r * R + rho] = s;
    }
    __syncthreads();
    for (int r = warp; r < nr; r += nw) {
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
  }
  for (int e = tid; e < RT * F; e += nt) {
    const int r = e / F, f = e % F;
    float c = 0.f;
    if (r < nr && !(mode & 2)) {
      const W* fp = feats + (size_t)((r0 + r) / rows_per_image) * R * F + f;
      for (int rho = 0; rho < R; ++rho) c += sw[r * R + rho] * to_f(fp[(size_t)rho * F]);
    }
    sx[r * In + E + f] = c;
  }
  __syncthreads();

  for (int j = tid; j < H; j += nt) {
    if (mode & 4) {
      for (int r = 0; r < nr; ++r)
        h_new[(size_t)(r0 + r) * H + j] = sh[r * H + j] + sx[r * In + j] + sa2[r * H + j];
    } else if (!MULTI) {
      float gi[3][RT], gh[3][RT];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int r = 0; r < RT; ++r) gi[g][r] = gh[g][r] = 0.f;
      for (int i = 0; i < In; ++i) {
        const W* wr = wih + (size_t)i * G + j;
        const float w0 = to_f(wr[0]), w1 = to_f(wr[H]), w2 = to_f(wr[2 * H]);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float x = sx[r * In + i];
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
          const float x = sh[r * H + i];
          gh[0][r] += x * w0;
          gh[1][r] += x * w1;
          gh[2][r] += x * w2;
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r >= nr) break;
        const float rg = sigmoidf((gi[0][r] + bih[j]) + (gh[0][r] + bhh[j]));
        const float zg = sigmoidf((gi[1][r] + bih[H + j]) + (gh[1][r] + bhh[H + j]));
        const float ng = tanhf((gi[2][r] + bih[2 * H + j]) + rg * (gh[2][r] + bhh[2 * H + j]));
        h_new[(size_t)(r0 + r) * H + j] = (1.f - zg) * ng + zg * sh[r * H + j];
      }
    } else {
      for (int r = 0; r < nr; ++r) {
        const int s = min(max(styles[(r0 + r) / rows_per_image], 0), S - 1);
        const W* wi = wih + (size_t)s * In * G + j;
        const W* wh = whh + (size_t)s * H * G + j;
        const float* bi = bih + (size_t)s * G;
        const float* bh = bhh + (size_t)s * G;
        float i0 = 0.f, i1 = 0.f, i2 = 0.f, h0 = 0.f, h1 = 0.f, h2 = 0.f;
        for (int i = 0; i < In; ++i) {
          const float x = sx[r * In + i];
          const W* wr = wi + (size_t)i * G;
          i0 += x * to_f(wr[0]);
          i1 += x * to_f(wr[H]);
          i2 += x * to_f(wr[2 * H]);
        }
        for (int i = 0; i < H; ++i) {
          const float x = sh[r * H + i];
          const W* wr = wh + (size_t)i * G;
          h0 += x * to_f(wr[0]);
          h1 += x * to_f(wr[H]);
          h2 += x * to_f(wr[2 * H]);
        }
        const float rg = sigmoidf((i0 + bi[j]) + (h0 + bh[j]));
        const float zg = sigmoidf((i1 + bi[H + j]) + (h1 + bh[H + j]));
        const float ng = tanhf((i2 + bi[2 * H + j]) + rg * (h2 + bh[2 * H + j]));
        h_new[(size_t)(r0 + r) * H + j] = (1.f - zg) * ng + zg * sh[r * H + j];
      }
    }
  }
}

template <int RT, bool MULTI, int MODE>
int launch(const void* const* p, int rows, int rpi, int R, int F, int E, int H, int S,
           cudaStream_t stream) {
  using W = __nv_bfloat16;
  const size_t smem = sizeof(float) * (size_t)RT * (2 * H + E + F + R);
  cudaFuncSetAttribute(cell_parts_kernel<W, RT, MULTI, MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cell_parts_kernel<W, RT, MULTI, MODE><<<(rows + RT - 1) / RT, 256, smem, stream>>>(
      (const W*)p[0], (const W*)p[1], (const float*)p[2], (const int*)p[3], (const int*)p[4],
      1, (const W*)p[5], (const W*)p[6], (const float*)p[7], (const float*)p[8],
      (const W*)p[9], (const W*)p[10], (const float*)p[11], (const float*)p[12], (float*)p[13],
      rows, rpi, R, F, E, H, S);
  return (int)cudaGetLastError();
}

template <int RT, bool MULTI>
int launch_mode(const void* const* p, int rows, int rpi, int R, int F, int E, int H, int S,
                int mode, cudaStream_t st) {
  switch (mode) {
    case 0: return launch<RT, MULTI, 0>(p, rows, rpi, R, F, E, H, S, st);
    case 1: return launch<RT, MULTI, 1>(p, rows, rpi, R, F, E, H, S, st);
    case 2: return launch<RT, MULTI, 2>(p, rows, rpi, R, F, E, H, S, st);
    case 3: return launch<RT, MULTI, 3>(p, rows, rpi, R, F, E, H, S, st);
    case 4: return launch<RT, MULTI, 4>(p, rows, rpi, R, F, E, H, S, st);
    case 5: return launch<RT, MULTI, 5>(p, rows, rpi, R, F, E, H, S, st);
    case 6: return launch<RT, MULTI, 6>(p, rows, rpi, R, F, E, H, S, st);
    case 7: return launch<RT, MULTI, 7>(p, rows, rpi, R, F, E, H, S, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// p: feats, att1, h, tok, styles, emb, ua_w, ua_b, va, wih, whh, bih, bhh, h_new
// (bf16 weights); block_rows 3 or 12; S > 1 takes the bank path.
extern "C" int cell_parts_bf16(const void* const* p, int rows, int rows_per_image, int R,
                               int F, int E, int H, int S, int block_rows, int mode,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int rpi = rows_per_image;
  if (block_rows == 3)
    return S > 1 ? launch_mode<3, true>(p, rows, rpi, R, F, E, H, S, mode, st)
                 : launch_mode<3, false>(p, rows, rpi, R, F, E, H, S, mode, st);
  if (block_rows == 12)
    return S > 1 ? launch_mode<12, true>(p, rows, rpi, R, F, E, H, S, mode, st)
                 : launch_mode<12, false>(p, rows, rpi, R, F, E, H, S, mode, st);
  return (int)cudaErrorInvalidValue;
}
