// K1 for Hopper: one step of the styled k=3 beam decode, as three kernels,
// and the cell kernel (a) that K1 and K2 (greedy_decode.cu) share.
//
// Replaces the TPU kernel `_beam_kernel` (captionax/ops/decode_kernel.py,
// launched by `fused_beam_search`), which runs a whole 50-step beam decode
// in one Pallas launch with every weight resident in VMEM.  A Hopper SM has
// 227 KB of shared memory, far below the ~9 MB bf16 weight set, so this port
// keeps the weights in device memory / L2 (50 MB) and splits a beam step in
// three launches that a host loop issues on the current stream:
//
//   (a) cell_step            one block per tile of `block_rows` rows:
//                            embedding gather, Bahdanau attention with att1
//                            precomputed, GRU on the theta bank row picked
//                            by the clamped style.  Row r belongs to image
//                            r / rows_per_image (3 for beam rows, 1 for
//                            greedy rows); the word is zero at t=0 when
//                            zero_word_t0 is set (beam), the embedding of
//                            token 0 otherwise (greedy).
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
// Early exit (the reference's `improvable`, decode_kernel.py:750-759): (c)
// of step t sets run[t + 1] when some row's score exceeds its image's best
// completion (score - best > 0; NEG_INF - NEG_INF = 0 is not improvable),
// and every kernel of step t + 1 returns at entry when it is 0 (see
// decode_common.cuh).  The reference tests this per tile of images, the
// port once per batch: a finished image cannot change its outputs in
// later steps, so both give the outputs of a decode that runs every step.
//
// Plain C interface, loaded with ctypes; every entry returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "decode_common.cuh"

namespace {

using namespace decode;

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
// Rows r0 .. r0+RT-1 of the batch (row = image*rows_per_image + slot).
// feats/att1 are per image ([B, R, F], [B, R, H]); the theta bank is
// [S, In, 3H] / [S, H, 3H] (S = 1 for a single theta), biases [S, 3H] in f32.
template <typename W, int RT, bool MULTI>
__global__ void __launch_bounds__(256) cell_step_kernel(
    const W* __restrict__ feats, const W* __restrict__ att1,
    const float* __restrict__ h, const int* __restrict__ tok,
    const int* __restrict__ styles, int t, const W* __restrict__ emb,
    const W* __restrict__ ua_w, const float* __restrict__ ua_b,
    const float* __restrict__ va, const W* __restrict__ wih,
    const W* __restrict__ whh, const float* __restrict__ bih,
    const float* __restrict__ bhh, float* __restrict__ h_new,
    const int* __restrict__ live, int rows, int rows_per_image, int zero_word_t0,
    int R, int F, int E, int H, int S) {
  if (!step_runs(live)) return;
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
    if (r < nr && (t > 0 || !zero_word_t0)) v = to_f(emb[(size_t)tok[r0 + r] * E + j]);
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
    const W* a1 = att1 + ((size_t)((r0 + r) / rows_per_image) * R + rho) * H;
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
      const W* fp = feats + (size_t)((r0 + r) / rows_per_image) * R * F + f;
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

// ---------------------------------------------------------------- (b)
// Block (chunk c, row tile y), 256 threads as 16 x 16: thread (ty, tx) owns
// rows ty + 16m (m < 4) and columns tx + 16n (n < 8) of the 64 x 128 tile.
// The 16 threads of one row are one half-warp, which merges their top-3 and
// logsumexp pairs with shuffles.  At most 64 registers, so that 4 blocks
// fit on an SM: left to itself ptxas takes 78, only 3 fit, and the kernel
// ran 3-5% slower on the H100 (PERF.md).
template <typename W>
__global__ void __launch_bounds__(256, 4) logits_top3_partial_kernel(
    const float* __restrict__ h, const W* __restrict__ fc_w,
    const float* __restrict__ fc_b, float* __restrict__ pv, int* __restrict__ pi,
    float* __restrict__ pm, float* __restrict__ ps, const int* __restrict__ live,
    int rows, int H, int Vp) {
  if (!step_runs(live)) return;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int col0 = chunk * kChunk, row0 = blockIdx.y * kRowTile;
  float acc[4][8];
  vocab_tile_product<W>(h, fc_w, rows, H, Vp, row0, col0, acc);

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
// live[0] gates this step; live[1] is set when some row stays improvable.
__global__ void __launch_bounds__(128) beam_select_kernel(
    const float* __restrict__ pv, const int* __restrict__ pi,
    const float* __restrict__ pm, const float* __restrict__ ps,
    const float* __restrict__ h_new, float* __restrict__ h, int* __restrict__ tok,
    float* __restrict__ score, const int* __restrict__ hist_in,
    int* __restrict__ hist_out, int* __restrict__ best_seq,
    float* __restrict__ best_val, int* __restrict__ best_len,
    int* __restrict__ found, int* __restrict__ live, int n_img, int n_chunks, int H,
    int T, int t, int end_id) {
  if (!step_runs(live)) return;
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
  const float best_old = best_val[img];
  const bool improve = cbest > best_old && cbest > kNegInf / 2;

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
    const float best_new = improve ? cbest : best_old;
    if (done[0] || done[1] || done[2]) found[img] = 1;
    bool improvable = false;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float sc = done[j] ? kNegInf : g.v[j];
      score[img * 3 + j] = sc;
      tok[img * 3 + j] = ntok[j];
      improvable = improvable || sc - best_new > 0.f;
    }
    if (improvable && live != nullptr) live[1] = 1;
  }
}

// The arguments of every cell entry, in the order of the C interface.
struct CellArgs {
  const void *feats, *att1, *h, *tok, *styles;
  int t;
  const void *emb, *ua_w, *ua_b, *va, *wih, *whh, *bih, *bhh;
  void* h_new;
  const void* live;
  int rows, rows_per_image, zero_word_t0, R, F, E, H, S;
  cudaStream_t stream;
};

template <typename W, int RT, bool MULTI>
void launch_cell_kernel(const CellArgs& a) {
  const size_t smem = sizeof(float) * (size_t)RT * (2 * a.H + a.E + a.F + a.R);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(cell_step_kernel<W, RT, MULTI>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cell_step_kernel<W, RT, MULTI><<<(a.rows + RT - 1) / RT, 256, smem, a.stream>>>(
      (const W*)a.feats, (const W*)a.att1, (const float*)a.h, (const int*)a.tok,
      (const int*)a.styles, a.t, (const W*)a.emb, (const W*)a.ua_w, (const float*)a.ua_b,
      (const float*)a.va, (const W*)a.wih, (const W*)a.whh, (const float*)a.bih,
      (const float*)a.bhh, (float*)a.h_new, (const int*)a.live, a.rows, a.rows_per_image,
      a.zero_word_t0, a.R, a.F, a.E, a.H, a.S);
}

template <typename W, int RT>
void launch_cell(const CellArgs& a) {
  if (a.S > 1)
    launch_cell_kernel<W, RT, true>(a);
  else
    launch_cell_kernel<W, RT, false>(a);
}

template <typename W>
int cell_entry(const CellArgs& a, int block_rows) {
  if (a.rows_per_image < 1) return (int)cudaErrorInvalidValue;
  switch (block_rows) {
    case 3: launch_cell<W, 3>(a); break;
    case 6: launch_cell<W, 6>(a); break;
    case 12: launch_cell<W, 12>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename W>
int logits_entry(const void* h, const void* fc_w, const void* fc_b, void* pv, void* pi,
                 void* pm, void* ps, const void* live, int rows, int H, int Vp,
                 void* stream) {
  if (Vp % kChunk) return (int)cudaErrorInvalidValue;
  const dim3 grid(Vp / kChunk, (rows + kRowTile - 1) / kRowTile);
  logits_top3_partial_kernel<W><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)h, (const W*)fc_w, (const float*)fc_b, (float*)pv, (int*)pi,
      (float*)pm, (float*)ps, (const int*)live, rows, H, Vp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* decode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Cell step for rows of `rows_per_image` rows per image (3: beam, 1: greedy).
#define CELL_PARAMS                                                                     \
  const void *feats, const void *att1, const void *h, const void *tok,                 \
      const void *styles, int t, const void *emb, const void *ua_w, const void *ua_b,  \
      const void *va, const void *wih, const void *whh, const void *bih,               \
      const void *bhh, void *h_new, const void *live, int rows, int rows_per_image,    \
      int zero_word_t0, int R, int F, int E, int H, int S, int block_rows, void *stream
#define CELL_ARGS                                                                      \
  CellArgs{feats, att1, h, tok, styles, t, emb, ua_w, ua_b, va, wih, whh, bih, bhh,    \
           h_new, live, rows, rows_per_image, zero_word_t0, R, F, E, H, S,              \
           (cudaStream_t)stream},                                                      \
      block_rows

int cell_step_f32(CELL_PARAMS) { return cell_entry<float>(CELL_ARGS); }

int cell_step_bf16(CELL_PARAMS) { return cell_entry<__nv_bfloat16>(CELL_ARGS); }

#undef CELL_PARAMS
#undef CELL_ARGS

int logits_top3_partial_f32(const void* h, const void* fc_w, const void* fc_b, void* pv,
                            void* pi, void* pm, void* ps, const void* live, int rows,
                            int H, int Vp, void* stream) {
  return logits_entry<float>(h, fc_w, fc_b, pv, pi, pm, ps, live, rows, H, Vp, stream);
}

int logits_top3_partial_bf16(const void* h, const void* fc_w, const void* fc_b, void* pv,
                             void* pi, void* pm, void* ps, const void* live, int rows,
                             int H, int Vp, void* stream) {
  return logits_entry<__nv_bfloat16>(h, fc_w, fc_b, pv, pi, pm, ps, live, rows, H, Vp,
                                     stream);
}

int beam_select(const void* pv, const void* pi, const void* pm, const void* ps,
                const void* h_new, void* h, void* tok, void* score, const void* hist_in,
                void* hist_out, void* best_seq, void* best_val, void* best_len, void* found,
                void* live, int n_img, int n_chunks, int H, int T, int t, int end_id,
                void* stream) {
  const dim3 grid((n_img + 3) / 4);
  beam_select_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const float*)pv, (const int*)pi, (const float*)pm, (const float*)ps,
      (const float*)h_new, (float*)h, (int*)tok, (float*)score, (const int*)hist_in,
      (int*)hist_out, (int*)best_seq, (float*)best_val, (int*)best_len, (int*)found,
      (int*)live, n_img, n_chunks, H, T, t, end_id);
  return (int)cudaGetLastError();
}

}  // extern "C"
