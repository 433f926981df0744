// K1 for Hopper: one step of the styled k=3 beam decode, as three kernels.
//
// Replaces the TPU kernel `_beam_kernel` (captionax/ops/decode_kernel.py,
// launched by `fused_beam_search`), which runs a whole 50-step beam decode
// in one Pallas launch with every weight resident in VMEM.  A Hopper SM has
// 227 KB of shared memory, far below the ~9 MB bf16 weight set, so this port
// keeps the weights in device memory / L2 (50 MB) and splits a beam step in
// three launches that a host loop issues on the current stream:
//
//   (a) beam_cell_step       one block per tile of 3*block_images beam rows:
//                            embedding gather (zero at t=0), Bahdanau
//                            attention with att1 precomputed, GRU on the
//                            theta bank row picked by the clamped style.
//   (b) logits_top3_partial  grid (vocab chunk of 128, row tile of 64): the
//                            product h_new . fc_w[:, chunk] + fc_b in a
//                            shared-memory tiled loop, then each row's top-3
//                            (value, index) and (max, sum exp) of the chunk.
//   (c) beam_select          one warp per image: merges the partials into
//                            each row's top-3 and logsumexp, takes the
//                            image's top-3 of its 9 candidates, reorders h
//                            and the token history by parent, and retires
//                            completed beams into the best completion.
//
// What bounds it on this card: per step at B=1024 (3072 beam rows) the
// vocab product of (b) is 2*3072*200*9728 = 12 GFLOP against ~11 MB of
// bytes, so (b) is bound by operations; (a) moves the 49-region features
// (~40 MB in bf16) and does ~2.5 GFLOP, and (c) moves ~20 MB.  This first
// design does all arithmetic in f32 on the CUDA cores (bf16 is a storage
// type, widened with __bfloat162float), which keeps the f32 mode exactly
// comparable with the plain PyTorch version; (b) reuses each fc_w tile
// across 64 rows from shared memory, and (a) reuses each theta column
// across the rows of its tile, so device memory sees each weight about once
// per tile.  Tensor-core products (wgmma) are the next step for (b).
//
// The logits of a whole row never exist in device memory: (b) leaves
// 8 numbers per (row, chunk).  Ties go to the first occurrence, as
// lax.top_k: (value desc, vocab index asc) within a row, and beam-major
// order across an image's 9 candidates.
//
// Plain C interface, loaded with ctypes; every entry returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr float kNegInf = -1e9f;  // the JAX package's NEG_INF
constexpr int kChunk = 128;       // vocab columns per partial (block width of (b))
constexpr int kRowTile = 64;      // rows per block of (b)
constexpr int kBK = 8;            // depth step of (b)'s shared-memory tiles

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

// A descending top-3 list under the total order (value desc, index asc).
struct Top3 {
  float v[3];
  int i[3];
};

__device__ __forceinline__ void top3_init(Top3& t) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    t.v[q] = -INFINITY;
    t.i[q] = INT_MAX;
  }
}

__device__ __forceinline__ bool ahead(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void top3_insert(Top3& t, float v, int i) {
  if (!ahead(v, i, t.v[2], t.i[2])) return;
  if (ahead(v, i, t.v[1], t.i[1])) {
    t.v[2] = t.v[1];
    t.i[2] = t.i[1];
    if (ahead(v, i, t.v[0], t.i[0])) {
      t.v[1] = t.v[0];
      t.i[1] = t.i[0];
      t.v[0] = v;
      t.i[0] = i;
    } else {
      t.v[1] = v;
      t.i[1] = i;
    }
  } else {
    t.v[2] = v;
    t.i[2] = i;
  }
}

// Merge the lists of lanes `lane ^ o` for o < width (a butterfly); every lane
// ends with the top-3 of the union, which is exact because the lanes hold
// disjoint index sets and the order is total.
__device__ __forceinline__ void top3_butterfly(Top3& t, int width) {
  for (int o = width / 2; o > 0; o >>= 1) {
    Top3 u;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      u.v[q] = __shfl_xor_sync(0xffffffffu, t.v[q], o);
      u.i[q] = __shfl_xor_sync(0xffffffffu, t.i[q], o);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) top3_insert(t, u.v[q], u.i[q]);
  }
}

// Online logsumexp pair (max, sum of exp(x - max)); an empty pair is (-inf, 0).
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float n = fmaxf(m, m2);
  s = s * expf(m - n) + s2 * expf(m2 - n);
  m = n;
}

__device__ __forceinline__ void lse_butterfly(float& m, float& s, int width) {
  for (int o = width / 2; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    lse_merge(m, s, m2, s2);
  }
}

// ---------------------------------------------------------------- (a)
// Rows r0 .. r0+RT-1 of the beam batch (row = image*3 + beam).  feats/att1
// are per image ([B, R, F], [B, R, H]); the theta bank is [S, In, 3H] /
// [S, H, 3H] (S = 1 for a single theta), biases [S, 3H] in f32.
template <typename W, int RT, bool MULTI>
__global__ void __launch_bounds__(256) beam_cell_step_kernel(
    const W* __restrict__ feats, const W* __restrict__ att1,
    const float* __restrict__ h, const int* __restrict__ tok,
    const int* __restrict__ styles, int t, const W* __restrict__ emb,
    const W* __restrict__ ua_w, const float* __restrict__ ua_b,
    const float* __restrict__ va, const W* __restrict__ wih,
    const W* __restrict__ whh, const float* __restrict__ bih,
    const float* __restrict__ bhh, float* __restrict__ h_new, int rows, int R,
    int F, int E, int H, int S) {
  extern __shared__ float smem[];
  const int In = E + F, G = 3 * H;
  float* sh = smem;            // [RT, H]   h
  float* sx = sh + RT * H;     // [RT, In]  x = [word, ctx]
  float* sa2 = sx + RT * In;   // [RT, H]   U_a h + b
  float* sw = sa2 + RT * H;    // [RT, R]   attention scores -> weights
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
    for (int i = 0; i < H; ++i) {
      const float w = to_f(ua_w[(size_t)i * H + j]);
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] += sh[r * H + i] * w;
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) sa2[r * H + j] = acc[r] + ua_b[j];
  }
  __syncthreads();

  for (int p = warp; p < nr * R; p += nw) {
    const int r = p / R, rho = p % R;
    const W* a1 = att1 + ((size_t)((r0 + r) / 3) * R + rho) * H;
    float s = 0.f;
    for (int j = lane; j < H; j += 32) s += tanhf(to_f(a1[j]) + sa2[r * H + j]) * va[j];
    s = warp_sum(s);
    if (lane == 0) sw[r * R + rho] = s;
  }
  __syncthreads();

  for (int r = warp; r < nr; r += nw) {  // softmax over regions; lanes own their entries
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

  for (int e = tid; e < RT * F; e += nt) {
    const int r = e / F, f = e % F;
    float c = 0.f;
    if (r < nr) {
      const W* fp = feats + (size_t)((r0 + r) / 3) * R * F + f;
      for (int rho = 0; rho < R; ++rho) c += sw[r * R + rho] * to_f(fp[(size_t)rho * F]);
    }
    sx[r * In + E + f] = c;
  }
  __syncthreads();

  for (int j = tid; j < H; j += nt) {
    if (!MULTI) {
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
        const int s = min(max(styles[(r0 + r) / 3], 0), S - 1);
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

// ---------------------------------------------------------------- (b)
// Block (chunk c, row tile y), 256 threads as 16 x 16: thread (ty, tx) owns
// rows ty + 16m (m < 4) and columns tx + 16n (n < 8) of the 64 x 128 tile.
// The 16 threads of one row are one half-warp, which merges their top-3 and
// logsumexp pairs with shuffles.
template <typename W>
__global__ void __launch_bounds__(256) logits_top3_partial_kernel(
    const float* __restrict__ h, const W* __restrict__ fc_w,
    const float* __restrict__ fc_b, float* __restrict__ pv, int* __restrict__ pi,
    float* __restrict__ pm, float* __restrict__ ps, int rows, int H, int Vp) {
  __shared__ float As[kBK][kRowTile];
  __shared__ float Bs[kBK][kChunk];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int col0 = chunk * kChunk, row0 = blockIdx.y * kRowTile;
  float acc[4][8];
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

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = row0 + ty + 16 * m;
    Top3 t3;
    top3_init(t3);
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = col0 + tx + 16 * n;
      const float l = acc[m][n] + fc_b[col];
      acc[m][n] = l;
      top3_insert(t3, l, col);
      mx = fmaxf(mx, l);
    }
    float s = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) s += expf(acc[m][n] - mx);
    top3_butterfly(t3, 16);
    lse_butterfly(mx, s, 16);
    if (tx == 0 && row < rows) {
      const size_t o = (size_t)row * n_chunks + chunk;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        pv[o * 3 + q] = t3.v[q];
        pi[o * 3 + q] = t3.i[q];
      }
      pm[o] = mx;
      ps[o] = s;
    }
  }
}

// ---------------------------------------------------------------- (c)
// One warp per image, 4 images per block.  hist_in/hist_out are the token
// histories [rows, T] before and after this step (the host swaps them).
__global__ void __launch_bounds__(128) beam_select_kernel(
    const float* __restrict__ pv, const int* __restrict__ pi,
    const float* __restrict__ pm, const float* __restrict__ ps,
    const float* __restrict__ h_new, float* __restrict__ h, int* __restrict__ tok,
    float* __restrict__ score, const int* __restrict__ hist_in,
    int* __restrict__ hist_out, int* __restrict__ best_seq,
    float* __restrict__ best_val, int* __restrict__ best_len,
    int* __restrict__ found, int n_img, int n_chunks, int H, int T, int t,
    int end_id) {
  const int lane = threadIdx.x & 31;
  const int img = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (img >= n_img) return;  // uniform across the warp

  float v9[9];
  int i9[9];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const int row = img * 3 + b;
    Top3 t3;
    top3_init(t3);
    float m = -INFINITY, s = 0.f;
    for (int c = lane; c < n_chunks; c += 32) {
      const size_t o = (size_t)row * n_chunks + c;
#pragma unroll
      for (int q = 0; q < 3; ++q) top3_insert(t3, pv[o * 3 + q], pi[o * 3 + q]);
      lse_merge(m, s, pm[o], ps[o]);
    }
    top3_butterfly(t3, 32);
    lse_butterfly(m, s, 32);
    const float logz = m + logf(s);
    const float sc = score[row];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      v9[b * 3 + q] = sc + (t3.v[q] - logz);
      i9[b * 3 + q] = t3.i[q];
    }
  }

  Top3 g;  // the image's top-3 of its 9 candidates; index = beam*3 + rank
  top3_init(g);
#pragma unroll
  for (int q = 0; q < 9; ++q) top3_insert(g, v9[q], q);
  int ntok[3], par[3];
  bool done[3];
  float cbest = kNegInf;
  int win = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    int sel = g.i[j];
    ntok[j] = 0;
#pragma unroll
    for (int q = 0; q < 9; ++q)
      if (q == sel) ntok[j] = i9[q];  // static indexing keeps v9/i9 in registers
    par[j] = sel / 3;
    done[j] = ntok[j] == end_id && g.v[j] > kNegInf / 2;
    const float cval = done[j] ? g.v[j] : kNegInf;
    if (cval > cbest) {  // first maximum wins
      cbest = cval;
      win = j;
    }
  }
  const bool improve = cbest > best_val[img] && cbest > kNegInf / 2;

  for (int j = 0; j < 3; ++j) {
    const float* src = h_new + (size_t)(img * 3 + par[j]) * H;
    float* dst = h + (size_t)(img * 3 + j) * H;
    for (int e = lane; e < H; e += 32) dst[e] = src[e];
  }
  for (int j = 0; j < 3; ++j) {
    const int* src = hist_in + (size_t)(img * 3 + par[j]) * T;
    int* dst = hist_out + (size_t)(img * 3 + j) * T;
    for (int p = lane; p < T; p += 32) {
      const int v = p == t + 1 ? ntok[j] : src[p];
      dst[p] = v;
      if (improve && j == win) best_seq[(size_t)img * T + p] = v;
    }
  }
  __syncwarp();  // every lane has read score[] and best_val[] above
  if (lane == 0) {
    if (improve) {
      best_val[img] = cbest;
      best_len[img] = t + 2;
    }
    if (done[0] || done[1] || done[2]) found[img] = 1;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      score[img * 3 + j] = done[j] ? kNegInf : g.v[j];
      tok[img * 3 + j] = ntok[j];
    }
  }
}

template <typename W, int RT, bool MULTI>
void launch_cell_kernel(const void* feats, const void* att1, const void* h, const void* tok,
                        const void* styles, int t, const void* emb, const void* ua_w,
                        const void* ua_b, const void* va, const void* wih, const void* whh,
                        const void* bih, const void* bhh, void* h_new, int rows, int R,
                        int F, int E, int H, int S, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)RT * (2 * H + E + F + R);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(beam_cell_step_kernel<W, RT, MULTI>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  beam_cell_step_kernel<W, RT, MULTI><<<(rows + RT - 1) / RT, 256, smem, stream>>>(
      (const W*)feats, (const W*)att1, (const float*)h, (const int*)tok,
      (const int*)styles, t, (const W*)emb, (const W*)ua_w, (const float*)ua_b,
      (const float*)va, (const W*)wih, (const W*)whh, (const float*)bih,
      (const float*)bhh, (float*)h_new, rows, R, F, E, H, S);
}

template <typename W, int RT>
void launch_cell(const void* feats, const void* att1, const void* h, const void* tok,
                 const void* styles, int t, const void* emb, const void* ua_w,
                 const void* ua_b, const void* va, const void* wih, const void* whh,
                 const void* bih, const void* bhh, void* h_new, int rows, int R, int F,
                 int E, int H, int S, cudaStream_t stream) {
  if (S > 1)
    launch_cell_kernel<W, RT, true>(feats, att1, h, tok, styles, t, emb, ua_w, ua_b, va,
                                    wih, whh, bih, bhh, h_new, rows, R, F, E, H, S, stream);
  else
    launch_cell_kernel<W, RT, false>(feats, att1, h, tok, styles, t, emb, ua_w, ua_b, va,
                                     wih, whh, bih, bhh, h_new, rows, R, F, E, H, S, stream);
}

template <typename W>
int cell_entry(const void* feats, const void* att1, const void* h, const void* tok,
               const void* styles, int t, const void* emb, const void* ua_w,
               const void* ua_b, const void* va, const void* wih, const void* whh,
               const void* bih, const void* bhh, void* h_new, int rows, int R, int F,
               int E, int H, int S, int block_images, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CELL_ARGS feats, att1, h, tok, styles, t, emb, ua_w, ua_b, va, wih, whh, bih, bhh, \
                  h_new, rows, R, F, E, H, S, st
  switch (block_images) {
    case 1: launch_cell<W, 3>(CELL_ARGS); break;
    case 2: launch_cell<W, 6>(CELL_ARGS); break;
    case 4: launch_cell<W, 12>(CELL_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef CELL_ARGS
  return (int)cudaGetLastError();
}

template <typename W>
int logits_entry(const void* h, const void* fc_w, const void* fc_b, void* pv, void* pi,
                 void* pm, void* ps, int rows, int H, int Vp, void* stream) {
  if (Vp % kChunk) return (int)cudaErrorInvalidValue;
  const dim3 grid(Vp / kChunk, (rows + kRowTile - 1) / kRowTile);
  logits_top3_partial_kernel<W><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)h, (const W*)fc_w, (const float*)fc_b, (float*)pv, (int*)pi,
      (float*)pm, (float*)ps, rows, H, Vp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* beam_decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int beam_cell_step_f32(const void* feats, const void* att1, const void* h, const void* tok,
                       const void* styles, int t, const void* emb, const void* ua_w,
                       const void* ua_b, const void* va, const void* wih, const void* whh,
                       const void* bih, const void* bhh, void* h_new, int rows, int R,
                       int F, int E, int H, int S, int block_images, void* stream) {
  return cell_entry<float>(feats, att1, h, tok, styles, t, emb, ua_w, ua_b, va, wih, whh,
                           bih, bhh, h_new, rows, R, F, E, H, S, block_images, stream);
}

int beam_cell_step_bf16(const void* feats, const void* att1, const void* h, const void* tok,
                        const void* styles, int t, const void* emb, const void* ua_w,
                        const void* ua_b, const void* va, const void* wih, const void* whh,
                        const void* bih, const void* bhh, void* h_new, int rows, int R,
                        int F, int E, int H, int S, int block_images, void* stream) {
  return cell_entry<__nv_bfloat16>(feats, att1, h, tok, styles, t, emb, ua_w, ua_b, va,
                                   wih, whh, bih, bhh, h_new, rows, R, F, E, H, S,
                                   block_images, stream);
}

int logits_top3_partial_f32(const void* h, const void* fc_w, const void* fc_b, void* pv,
                            void* pi, void* pm, void* ps, int rows, int H, int Vp,
                            void* stream) {
  return logits_entry<float>(h, fc_w, fc_b, pv, pi, pm, ps, rows, H, Vp, stream);
}

int logits_top3_partial_bf16(const void* h, const void* fc_w, const void* fc_b, void* pv,
                             void* pi, void* pm, void* ps, int rows, int H, int Vp,
                             void* stream) {
  return logits_entry<__nv_bfloat16>(h, fc_w, fc_b, pv, pi, pm, ps, rows, H, Vp, stream);
}

int beam_select(const void* pv, const void* pi, const void* pm, const void* ps,
                const void* h_new, void* h, void* tok, void* score, const void* hist_in,
                void* hist_out, void* best_seq, void* best_val, void* best_len, void* found,
                int n_img, int n_chunks, int H, int T, int t, int end_id, void* stream) {
  const dim3 grid((n_img + 3) / 4);
  beam_select_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const float*)pv, (const int*)pi, (const float*)pm, (const float*)ps,
      (const float*)h_new, (float*)h, (int*)tok, (float*)score, (const int*)hist_in,
      (int*)hist_out, (int*)best_seq, (float*)best_val, (int*)best_len, (int*)found, n_img,
      n_chunks, H, T, t, end_id);
  return (int)cudaGetLastError();
}

}  // extern "C"
