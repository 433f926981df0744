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
//   (a) cell_step            embedding gather, Bahdanau attention with att1
//                            precomputed, GRU on the theta bank row picked
//                            by the clamped style: the TPU kernels'
//                            _cell_core / _cell_core_multi inside
//                            _beam_kernel and _greedy_kernel.  Row r
//                            belongs to image r / rows_per_image (3 for
//                            beam rows, 1 for greedy rows); the word is
//                            zero at t=0 when zero_word_t0 is set (beam),
//                            the embedding of token 0 otherwise (greedy).
//                            With bf16 weights two launches behind one C
//                            entry (namespace cell, below): an attention
//                            phase, a block per `block_rows` rows, and a
//                            gate phase on the tensor cores, a block per
//                            (row tile, group of hidden units).  With f32
//                            weights one launch, f32 on the CUDA cores
//                            (cell_step_kernel): the exactness path.
//   (b) logits_top3_partial  the product h_new . fc_w + fc_b, then for each
//                            row and 128-column chunk its top-3 (value,
//                            index) and (max, sum exp): with bf16 weights on
//                            wgmma (decode_common.cuh, vocab::product), 128
//                            rows and several chunks a block; with f32
//                            weights one 64-row x 128-column tile a block
//                            on the CUDA cores.
//   (c) beam_select          a warp per beam row (namespace sel): merges
//                            the partials into each row's top-3 and
//                            logsumexp on warp reductions, takes the
//                            image's top-3 of its 9 candidates, reorders h
//                            and the token history by parent, and retires
//                            completed beams into the best completion.
//
// What bounds it on this card: per step at B=1024 (3072 beam rows) the
// vocab product of (b) is 2*3072*200*9728 = 12 GFLOP against ~11 MB of
// bytes, so (b) is bound by operations; (a) moves the 49-region features
// (~40 MB in bf16), does 2.2 GFLOP of gate products, 0.25 of U_a h and 30M
// tanhf; (c) moves ~13.6 MB (0.0041 ms at the memory's rate) and is bound
// by latency: its first design ran a warp per image, the three rows' merges
// one after another as chains of shuffles and expf, then the copies;
// the redesign (namespace sel, below) runs a warp per row, issues every
// load in one round before it tests the exit flag, merges on redux.sync,
// and copies from shared memory.  (c) computes in f32 on the CUDA cores
// (bf16 is a storage type, widened with __bfloat162float).
//
// (a) with bf16 weights.  Its first design ran the gate products as f32
// FMAs, a thread per hidden column, every block reading all 720 KB of the
// theta from L2, and with a bank one row of a block at a time (at the
// service's 192 rows, 96% of a beam step).  Now:
// - the gate products and U_a h run on the tensor cores, mma.sync m16n8k16
//   (16-row tiles leave enough blocks at 64-192 rows, where wgmma's 64-row
//   tiles would not), [x | h] and h split into three exact bf16 terms as in
//   (b), so they are still the f32 products (3x the operations: 6.6 GFLOP
//   at B=1024, 0.007 ms at the bf16 peak);
// - the theta is packed once per decoder in fragment order with each group
//   of 8 hidden units' r, z and n columns side by side
//   (decode_kernel.pack_gate_theta), so the GRU runs from one warp's
//   accumulators and the gates never reach device memory;
// - a row tile takes the bank's product once per style present in it, the
//   other styles' rows zero in the A fragments (exact zeros);
// - the gate phase's grid is (row tile, group of hidden units),
//   decode_kernel.gate_tile: 156 blocks at 192 rows; the attention phase
//   reads each image's att1 and feats once for all its rows and writes
//   [x | h] split for the gate phase, which copies its rows' terms to
//   shared memory with cp.async and reads fragments with ldmatrix.
// What bounds it now (PERF.md): the attention phase, above all the 30M
// tanhf of the scores on the CUDA cores (tanhf, not tanh.approx), and the
// gate products at mma.sync's rate.  The f32 instance keeps f32 FMAs on the
// CUDA cores, exact against its plain version to the order of the sums.
//
// (b) with bf16 weights runs on the tensor cores: h_new is split
// into three exact bf16 terms, so the product is still the reference's f32
// product of f32 h and bf16 fc_w (not one of bf16(h)), at 3x the
// operations (36 GFLOP on 208 padded depths, 0.037 ms at the bf16 peak),
// and a block keeps its 128 rows' terms in shared memory while fc_w's
// chunks stream through a cp.async ring from L2.  Its epilogue works from
// the accumulators: a row's chunk lies in one quad of lanes, so each lane
// merges its 32 logits and two shuffles give the quad's top-3, exactly,
// then the quad's max and one expf per logit its sum.  With f32 weights
// (b) stays in f32 on the CUDA cores (no TF32), 64 x 128 tiles.
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
// f32 weights only: with bf16 weights (a) runs in namespace cell below.
template <int RT, bool MULTI>
__global__ void __launch_bounds__(256) cell_step_kernel(
    const float* __restrict__ feats, const float* __restrict__ att1,
    const float* __restrict__ h, const int* __restrict__ tok,
    const int* __restrict__ styles, int t, const float* __restrict__ emb,
    const float* __restrict__ ua_w, const float* __restrict__ ua_b,
    const float* __restrict__ va, const float* __restrict__ wih,
    const float* __restrict__ whh, const float* __restrict__ bih,
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
    const float* a1 = att1 + ((size_t)((r0 + r) / rows_per_image) * R + rho) * H;
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
      const float* fp = feats + (size_t)((r0 + r) / rows_per_image) * R * F + f;
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
        const float* wr = wih + (size_t)i * G + j;
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
        const float* wr = whh + (size_t)i * G + j;
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
        const float* wi = wih + (size_t)s * In * G + j;
        const float* wh = whh + (size_t)s * H * G + j;
        const float* bi = bih + (size_t)s * G;
        const float* bh = bhh + (size_t)s * G;
        float i0 = 0.f, i1 = 0.f, i2 = 0.f, h0 = 0.f, h1 = 0.f, h2 = 0.f;
        for (int i = 0; i < In; ++i) {
          const float x = sx[r * In + i];
          const float* wr = wi + (size_t)i * G;
          i0 += x * to_f(wr[0]);
          i1 += x * to_f(wr[H]);
          i2 += x * to_f(wr[2 * H]);
        }
        for (int i = 0; i < H; ++i) {
          const float x = sh[r * H + i];
          const float* wr = wh + (size_t)i * G;
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
// bf16 weights: the product on wgmma (vocab::product).  Per warpgroup and
// chunk each lane holds 32 logits of rows r and r + 8, met in ascending
// column order, and the quad of lanes 4 (l / 4) .. + 3 holds a row's 128
// (see decode_common.cuh).  In ascending order a later column ranks ahead
// only when strictly greater, so a lane keeps its top-3 with three float
// compares and no branch; the quad merges under the full order.
__device__ __forceinline__ void top3_push(Top3& t, float v, int i) {
  const bool a0 = v > t.v[0], a1 = v > t.v[1], a2 = v > t.v[2];
  t.v[2] = a1 ? t.v[1] : a2 ? v : t.v[2];
  t.i[2] = a1 ? t.i[1] : a2 ? i : t.i[2];
  t.v[1] = a0 ? t.v[0] : a1 ? v : t.v[1];
  t.i[1] = a0 ? t.i[0] : a1 ? i : t.i[1];
  t.v[0] = a0 ? v : t.v[0];
  t.i[0] = a0 ? i : t.i[0];
}

struct Top3Epilogue {
  const float* __restrict__ fc_b;
  float* __restrict__ pv;
  int* __restrict__ pi;
  float* __restrict__ pm;
  float* __restrict__ ps;
  int rows, n_chunks;

  // Four independent lists (rows r, r + 8 x the lane's first and last 16
  // columns), so that their select chains overlap; a last-16 list merges
  // into its row's first-16 list by pushes, its indices being the greater.
  __device__ __forceinline__ void operator()(float (&acc)[64], int row_base, int chunk) const {
    const int lane = threadIdx.x & 31, q = lane & 3;
    const int row_a = row_base + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
    const int col0 = chunk * kChunk + 2 * q;
    Top3 t3[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      top3_init(t3[i][0]);
      top3_init(t3[i][1]);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(fc_b + col0 + 8 * j));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float& l0 = acc[4 * j + 2 * i];
        float& l1 = acc[4 * j + 2 * i + 1];
        l0 += b.x;
        l1 += b.y;
        top3_push(t3[i][j / 8], l0, col0 + 8 * j);
        top3_push(t3[i][j / 8], l1, col0 + 8 * j + 1);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      Top3& t = t3[i][0];
#pragma unroll
      for (int k = 0; k < 3; ++k) top3_push(t, t3[i][1].v[k], t3[i][1].i[k]);
      float mx = t.v[0];  // the quad's max, then one expf per logit
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        s[j % 2] += expf(acc[4 * j + 2 * i] - mx) + expf(acc[4 * j + 2 * i + 1] - mx);
      float sum = s[0] + s[1];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      top3_butterfly(t, 4);
      const int row = row_a + 8 * i;
      if (q == 0 && row < rows) {
        const size_t o = (size_t)row * n_chunks + chunk;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          pv[o * 3 + k] = t.v[k];
          pi[o * 3 + k] = t.i[k];
        }
        pm[o] = mx;
        ps[o] = sum;
      }
    }
  }
};

template <int S>
__global__ void __launch_bounds__(vocab::kThreads, 1) logits_top3_wgmma_kernel(
    const float* __restrict__ h, const __nv_bfloat16* __restrict__ fc_w,
    const float* __restrict__ fc_b, float* __restrict__ pv, int* __restrict__ pi,
    float* __restrict__ pm, float* __restrict__ ps, const int* __restrict__ live, int rows,
    int H, int Vp, int per_block) {
  if (!step_runs(live)) return;
  vocab::product<S>(h, fc_w, rows, H, Vp, per_block,
                    Top3Epilogue{fc_b, pv, pi, pm, ps, rows, Vp / kChunk});
}

template <int S>
int logits_top3_wgmma(const void* h, const void* fc_w, const void* fc_b, void* pv, void* pi,
                      void* pm, void* ps, const void* live, int rows, int H, int Vp,
                      int per_block, cudaStream_t stream) {
  int grid = 0;
  const cudaError_t err =
      vocab::setup(logits_top3_wgmma_kernel<S>, fc_w, fc_b, rows, H, Vp, per_block, grid);
  if (err != cudaSuccess) return (int)err;
  logits_top3_wgmma_kernel<S><<<grid, vocab::kThreads, vocab::smem_bytes(H), stream>>>(
      (const float*)h, (const __nv_bfloat16*)fc_w, (const float*)fc_b, (float*)pv, (int*)pi,
      (float*)pm, (float*)ps, (const int*)live, rows, H, Vp, per_block);
  return (int)cudaGetLastError();
}

// f32 weights: block (chunk c, row tile y), 256 threads as 16 x 16: thread (ty, tx) owns
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
// A warp per beam row, an image's three warps a group with its own named
// barrier, `images` images a block (decode_kernel.select_images_per_block).
// hist_in/hist_out are the token histories [rows, T] before and after this
// step (the host swaps them).  live[0] gates this step; live[1] is set when
// some row stays improvable.
//
// 1. The image's three rows of h_new and of hist_in go to shared memory by
//    cp.async (16 bytes where H % 4 == 0 and h, h_new are 16-byte aligned,
//    else 4), in flight while the rows merge: the reorder reads them there.
// 2. Each warp loads its row's partials in one round of 16-byte vectors
//    (pv, pi: 3C words; pm, ps: C words; a scalar head and tail where a
//    row's base is not 16-byte aligned: row_split; the vectors past a
//    warp's 64 in further rounds), and each lane keeps the top-3 of its own
//    candidates under (key desc, index asc).
// 3. The row's top-3: three rounds of first_max (redux.sync max of the
//    lanes' head keys, then min of the head indices at that key); the
//    first lane at both pops its head.  The logsumexp in the plain
//    version's form: M by a max reduction, then sum s * exp(m - M), one expf
//    a chunk, and a shuffle sum.  Lanes 0-2 write the row's candidates
//    score + (v - logz) to shared memory at beam * 3 + rank.
// 4. After the image's barrier, every warp takes the image's top-3 of the 9
//    (lanes 0-8, beam-major order, three rounds of first_max), so every
//    thread knows the parents, tokens and the best completion (the first
//    maximum); all 96 threads then copy h (float4) and the histories by
//    parent, and best_seq on improvement; threads 0-2 write the scores and
//    tokens, thread 0 the best completion and the exit flag.
namespace sel {

using namespace hopper;

constexpr int kImageThreads = 96;  // three warps: one per beam row
constexpr int kMaxImages = 4;      // images a block: named barriers 1 .. 4
constexpr int kCandWords = 20;     // the 9 candidates' values and indices, padded

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }
// shared-memory words of an image: h_new's rows, hist_in's rows, candidates
__host__ __device__ constexpr int image_words(int H, int T) {
  return pad4(3 * H) + pad4(3 * T) + kCandWords;
}

__device__ __forceinline__ void image_sync(int slot) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(slot + 1), "n"(kImageThreads) : "memory");
}

// a lane's top-3 under (key desc, index asc), with the values
struct KeyTop3 {
  unsigned k[3];
  int i[3];
  float v[3];
};

__device__ __forceinline__ void key_top3_init(KeyTop3& t) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    t.k[q] = kNoKey;
    t.i[q] = INT_MAX;
    t.v[q] = -INFINITY;
  }
}

// branch-free: lanes of a warp never diverge here
__device__ __forceinline__ void key_top3_insert(KeyTop3& t, float v, int i) {
  const unsigned k = order_key(v);
  const bool a0 = key_ahead(k, i, t.k[0], t.i[0]), a1 = key_ahead(k, i, t.k[1], t.i[1]),
             a2 = key_ahead(k, i, t.k[2], t.i[2]);
  t.k[2] = a1 ? t.k[1] : (a2 ? k : t.k[2]);
  t.i[2] = a1 ? t.i[1] : (a2 ? i : t.i[2]);
  t.v[2] = a1 ? t.v[1] : (a2 ? v : t.v[2]);
  t.k[1] = a0 ? t.k[0] : (a1 ? k : t.k[1]);
  t.i[1] = a0 ? t.i[0] : (a1 ? i : t.i[1]);
  t.v[1] = a0 ? t.v[0] : (a1 ? v : t.v[1]);
  t.k[0] = a0 ? k : t.k[0];
  t.i[0] = a0 ? i : t.i[0];
  t.v[0] = a0 ? v : t.v[0];
}

template <typename T>
__device__ __forceinline__ T pick3(T a, T b, T c, int j) {
  return j == 0 ? a : (j == 1 ? b : c);
}

__global__ void __launch_bounds__(kMaxImages * kImageThreads) beam_select_kernel(
    const float* __restrict__ pv, const int* __restrict__ pi,
    const float* __restrict__ pm, const float* __restrict__ ps,
    const float* __restrict__ h_new, float* __restrict__ h, int* __restrict__ tok,
    float* __restrict__ score, const int* __restrict__ hist_in,
    int* __restrict__ hist_out, int* __restrict__ best_seq,
    float* __restrict__ best_val, int* __restrict__ best_len,
    int* __restrict__ found, int* __restrict__ live, int n_img, int n_chunks, int H, int T,
    int t, int end_id) {
  const bool runs = step_runs(live);  // tested once the first round of loads is issued
  extern __shared__ __align__(16) float sel_smem[];
  const int slot = threadIdx.x / kImageThreads, it = threadIdx.x % kImageThreads;
  const int beam = it >> 5, lane = threadIdx.x & 31;
  const int img = blockIdx.x * (blockDim.x / kImageThreads) + slot;
  if (img >= n_img) return;  // uniform across the image's three warps
  float* s_h = sel_smem + slot * image_words(H, T);
  int* s_hist = reinterpret_cast<int*>(s_h + pad4(3 * H));
  float* s_cv = reinterpret_cast<float*>(s_hist + pad4(3 * T));
  int* s_ci = reinterpret_cast<int*>(s_cv + 9);

  // 1. the image's rows of h_new and hist_in, in flight during the merge
  const bool vec =
      (H & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(h_new) | reinterpret_cast<uintptr_t>(h)) & 15) == 0;
  const size_t slab = (size_t)img * 3 * H;
  if (vec) {
    for (int e = it; e < 3 * H / 4; e += kImageThreads)
      cp_async16(smem_addr(s_h + 4 * e), h_new + slab + 4 * e, true);
  } else {
    for (int e = it; e < 3 * H; e += kImageThreads) cp_async4(smem_addr(s_h + e), h_new + slab + e);
  }
  for (int e = it; e < 3 * T; e += kImageThreads)
    cp_async4(smem_addr(s_hist + e), hist_in + (size_t)img * 3 * T + e);
  cp_async_commit();

  // 2. this warp's row: its loads in one round
  const int row = img * 3 + beam, n3 = 3 * n_chunks;
  const float sc = score[row];
  const float best_old = best_val[img];
  // the lane's chunks of pm, ps in the first round: two float4 (slots 0-7),
  // a head and a tail scalar (8, 9); each slot is valid where its load was
  // made.  Rows of more than 64 vectors (C > 256) read the rest after it.
  float m_[10], s_[10];
  bool ok[10];
  const float* rm = pm + (size_t)row * n_chunks;
  const float* rs = ps + (size_t)row * n_chunks;
  const RowSplit spm = row_split((size_t)row * n_chunks, n_chunks);
  const float4* rm4 = reinterpret_cast<const float4*>(rm + spm.head);
  const float4* rs4 = reinterpret_cast<const float4*>(rs + spm.head);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int k = lane + 32 * u;
    float4 a = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY), b = {};
    if (k < spm.body) a = rm4[k], b = rs4[k];
    m_[4 * u] = a.x, m_[4 * u + 1] = a.y, m_[4 * u + 2] = a.z, m_[4 * u + 3] = a.w;
    s_[4 * u] = b.x, s_[4 * u + 1] = b.y, s_[4 * u + 2] = b.z, s_[4 * u + 3] = b.w;
#pragma unroll
    for (int q = 0; q < 4; ++q) ok[4 * u + q] = k < spm.body;
  }
  {
    const int tl = spm.head + 4 * spm.body;
    ok[8] = lane < spm.head;
    ok[9] = lane < spm.tail;
    m_[8] = ok[8] ? rm[lane] : -INFINITY;
    s_[8] = ok[8] ? rs[lane] : 0.f;
    m_[9] = ok[9] ? rm[tl + lane] : -INFINITY;
    s_[9] = ok[9] ? rs[tl + lane] : 0.f;
  }

  // the lane's candidates of pv, pi: 16-byte vectors, two a lane per pass
  const float* rv = pv + (size_t)row * n3;
  const int* ri = pi + (size_t)row * n3;
  const RowSplit sp = row_split((size_t)row * n3, n3);
  const float4* rv4 = reinterpret_cast<const float4*>(rv + sp.head);
  const int4* ri4 = reinterpret_cast<const int4*>(ri + sp.head);
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
  KeyTop3 top;
  key_top3_init(top);
  auto insert = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (k0 + lane + 32 * u < sp.body) {
        key_top3_insert(top, v[u].x, x[u].x);
        key_top3_insert(top, v[u].y, x[u].y);
        key_top3_insert(top, v[u].z, x[u].z);
        key_top3_insert(top, v[u].w, x[u].w);
      }
  };
  load(0);
  if (!runs) {  // a closed gate: nothing is written (the copies land first)
    cp_async_wait<0>();
    return;
  }
  insert(0);
  for (int k0 = 64; k0 < sp.body; k0 += 64) {
    load(k0);
    insert(k0);
  }
  if (lane < sp.head) key_top3_insert(top, rv[lane], ri[lane]);
  const int tl = sp.head + 4 * sp.body;
  if (lane < sp.tail) key_top3_insert(top, rv[tl + lane], ri[tl + lane]);

  // 3. the row's logsumexp and top-3 (the sums in the lane's load order:
  // its vectors, then the head and the tail)
  float mx = -INFINITY;
#pragma unroll
  for (int q = 0; q < 10; ++q) mx = fmaxf(mx, m_[q]);
  for (int k = lane + 64; k < spm.body; k += 32) {
    const float4 a = rm4[k];
    mx = fmaxf(mx, fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)));
  }
  const float M = key_value(__reduce_max_sync(0xffffffffu, order_key(mx)));
  float sum = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (ok[q]) sum += s_[q] * expf(m_[q] - M);
  for (int k = lane + 64; k < spm.body; k += 32) {
    const float4 a = rm4[k], b = rs4[k];
    sum += b.x * expf(a.x - M);
    sum += b.y * expf(a.y - M);
    sum += b.z * expf(a.z - M);
    sum += b.w * expf(a.w - M);
  }
  if (ok[8]) sum += s_[8] * expf(m_[8] - M);
  if (ok[9]) sum += s_[9] * expf(m_[9] - M);
  const float logz = M + logf(warp_sum(sum));

  float got[3];
  int won[3], idx[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    unsigned kmax;
    first_max(0xffffffffu, top.k[0], top.i[0], kmax, idx[q]);
    won[q] = __ffs(__ballot_sync(0xffffffffu, top.k[0] == kmax && top.i[0] == idx[q])) - 1;
    got[q] = top.v[0];
    if (lane == won[q]) {  // pop the head
      top.k[0] = top.k[1], top.i[0] = top.i[1], top.v[0] = top.v[1];
      top.k[1] = top.k[2], top.i[1] = top.i[2], top.v[1] = top.v[2];
      top.k[2] = kNoKey, top.i[2] = INT_MAX, top.v[2] = -INFINITY;
    }
  }
  float val[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) val[q] = __shfl_sync(0xffffffffu, got[q], won[q]);
  if (lane < 3) {
    s_cv[beam * 3 + lane] = sc + (pick3(val[0], val[1], val[2], lane) - logz);
    s_ci[beam * 3 + lane] = pick3(idx[0], idx[1], idx[2], lane);
  }
  cp_async_wait<0>();
  image_sync(slot);

  // 4. the image's top-3 of its 9 candidates (beam-major; first maximum)
  unsigned ck = lane < 9 ? order_key(s_cv[lane]) : kNoKey;
  int cand[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    unsigned kmax;
    first_max(0xffffffffu, ck, lane, kmax, cand[j]);
    if (lane == cand[j]) ck = kNoKey;
  }
  float gv[3], cbest = kNegInf;
  int ntok[3], par[3], win = 0;
  bool done[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gv[j] = s_cv[cand[j]];
    ntok[j] = s_ci[cand[j]];
    par[j] = cand[j] / 3;
    done[j] = ntok[j] == end_id && gv[j] > kNegInf / 2;
    const float cval = done[j] ? gv[j] : kNegInf;
    if (cval > cbest) {  // first maximum wins
      cbest = cval;
      win = j;
    }
  }
  const bool improve = cbest > best_old && cbest > kNegInf / 2;

  // the reorder by parent, by all of the image's threads
  if (vec) {
    const int H4 = H >> 2;
    float4* dst = reinterpret_cast<float4*>(h + slab);
    const float4* src = reinterpret_cast<const float4*>(s_h);
    for (int e = it; e < 3 * H4; e += kImageThreads) {
      const int j = e / H4;
      dst[e] = src[pick3(par[0], par[1], par[2], j) * H4 + e - j * H4];
    }
  } else {
    for (int e = it; e < 3 * H; e += kImageThreads) {
      const int j = e / H;
      h[slab + e] = s_h[pick3(par[0], par[1], par[2], j) * H + e - j * H];
    }
  }
  int* out = hist_out + (size_t)img * 3 * T;
  for (int e = it; e < 3 * T; e += kImageThreads) {
    const int j = e / T, p = e - j * T;
    const int v = p == t + 1 ? pick3(ntok[0], ntok[1], ntok[2], j)
                             : s_hist[pick3(par[0], par[1], par[2], j) * T + p];
    out[e] = v;
    if (improve && j == win) best_seq[(size_t)img * T + p] = v;
  }
  const float best_new = improve ? cbest : best_old;
  bool improvable = false;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    improvable = improvable || (done[j] ? kNegInf : gv[j]) - best_new > 0.f;
  if (it < 3) {
    score[img * 3 + it] = pick3(done[0], done[1], done[2], it) ? kNegInf
                                                                : pick3(gv[0], gv[1], gv[2], it);
    tok[img * 3 + it] = pick3(ntok[0], ntok[1], ntok[2], it);
  }
  if (it == 0) {
    if (improve) {
      best_val[img] = cbest;
      best_len[img] = t + 2;
    }
    if (done[0] || done[1] || done[2]) found[img] = 1;
    if (improvable && live != nullptr) live[1] = 1;
  }
}

}  // namespace sel

// The arguments of the f32 cell entry, in the order of the C interface.
struct CellArgs {
  const void *feats, *att1, *h, *tok, *styles;
  int t;
  const void *emb, *ua_w, *ua_b, *va, *wih, *whh, *bih, *bhh;
  void* h_new;
  const void* live;
  int rows, rows_per_image, zero_word_t0, R, F, E, H, S;
  cudaStream_t stream;
};

template <int RT, bool MULTI>
void launch_cell_kernel(const CellArgs& a) {
  const size_t smem = sizeof(float) * (size_t)RT * (2 * a.H + a.E + a.F + a.R);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(cell_step_kernel<RT, MULTI>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cell_step_kernel<RT, MULTI><<<(a.rows + RT - 1) / RT, 256, smem, a.stream>>>(
      (const float*)a.feats, (const float*)a.att1, (const float*)a.h, (const int*)a.tok,
      (const int*)a.styles, a.t, (const float*)a.emb, (const float*)a.ua_w,
      (const float*)a.ua_b, (const float*)a.va, (const float*)a.wih, (const float*)a.whh,
      (const float*)a.bih, (const float*)a.bhh, (float*)a.h_new, (const int*)a.live, a.rows,
      a.rows_per_image, a.zero_word_t0, a.R, a.F, a.E, a.H, a.S);
}

template <int RT>
void launch_cell(const CellArgs& a) {
  if (a.S > 1)
    launch_cell_kernel<RT, true>(a);
  else
    launch_cell_kernel<RT, false>(a);
}

int cell_entry_f32(const CellArgs& a, int block_rows) {
  if (a.rows_per_image < 1) return (int)cudaErrorInvalidValue;
  switch (block_rows) {
    case 3: launch_cell<3>(a); break;
    case 6: launch_cell<6>(a); break;
    case 12: launch_cell<12>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- (a), bf16 weights
// Two launches behind one C entry (see the note at the head of this file):
//   attend  one block per `block_rows` rows: the word, U_a h on the tensor
//           cores, the scores, the softmax and the context, per image;
//           writes x = [word, ctx] in f32.
//   gates   one block per (row tile, group of hidden units): [x | h] split
//           into three bf16 terms in shared memory, the gate products on the
//           tensor cores (mma.sync m16n8k16) with the packed theta's
//           fragments read from L2 into registers, once for each style
//           present in the tile, then the GRU from the accumulators.
//
// The mma.sync fragments (lane l, g = l / 4, q = l % 4): A (16 x 16, row
// major) holds a0 = (row g, k 2q, 2q+1), a1 = (row g+8, k 2q..), a2 = (row
// g, k 2q+8..), a3 = (row g+8, k 2q+8..); B (16 x 8) b0 = (k 2q, 2q+1; n g),
// b1 = (k 2q+8, 2q+9; n g); C c0, c1 = (row g, n 2q, 2q+1), c2, c3 = (row
// g+8, ..).  Shared memory holds A "fragment-native": the 16 bytes of
// lane l's fragment at lane l's slot of a 512-byte record per (m16 tile,
// k16 tile, term), so a warp reads a fragment in one conflict-free load.
// The packed theta (decode_kernel.pack_gate_theta) holds B the same way in
// device memory: per (style, unit group, k16 tile, gate) 256 bytes, lane l's
// 8 at 8 l.
namespace cell {

constexpr int kThreads = 256, kWarps = 8;
constexpr int kUnits = 8;    // hidden units of a column group: its r, z and n columns are n8 tiles
constexpr int kBatch = 4;    // k16 tiles whose B fragments are loaded together
constexpr int kUaBatch = 2;  // k16 tiles of U_a's fragments loaded together
constexpr int kMaxH = 256;   // a lane keeps 8 of an att1 row's depths in registers
constexpr int kMaxStyles = 32;

__host__ __device__ constexpr int ktiles(int n) { return (n + 15) / 16; }
__host__ __device__ constexpr int groups(int H) { return (H + kUnits - 1) / kUnits; }

// d += a . b on the tensor cores, bf16 in, f32 accumulators (not volatile:
// the compiler may interleave the products with the loads of the next ones)
__device__ __forceinline__ void mma(float (&d)[4], const uint4& a, const uint2& b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// f32 (v0, v1) at depths k, k + 1 (k even) of row r -> the bf16x2 words of
// its three terms, stored in the fragment-native A at (row r, k16 tile kt,
// pair p = (k % 16) / 2); a term's record is 128 words after the one before.
__device__ __forceinline__ void put_pair(uint32_t* a, int KT, int r, int kt, int p, float v0,
                                         float v1) {
  unsigned t0[3], t1[3];
  vocab::split3(v0, t0);
  vocab::split3(v1, t1);
  const int rr = r & 15, lane = (rr & 7) * 4 + (p & 3), reg = (rr >> 3) + 2 * (p >> 2);
  uint32_t* w = a + ((size_t)(r >> 4) * KT + kt) * 3 * 128 + lane * 4 + reg;
#pragma unroll
  for (int t = 0; t < 3; ++t) w[t * 128] = t0[t] | (t1[t] << 16);
}

// the three terms' words of a pair of zeros, as put_pair
__device__ __forceinline__ void put_zero(uint32_t* a, int KT, int r, int kt, int p) {
  const int rr = r & 15, lane = (rr & 7) * 4 + (p & 3), reg = (rr >> 3) + 2 * (p >> 2);
  uint32_t* w = a + ((size_t)(r >> 4) * KT + kt) * 3 * 128 + lane * 4 + reg;
  w[0] = w[128] = w[256] = 0u;
}

// h's terms for U_a, h, U_a h, x and the scores
template <int RT>
__host__ __device__ constexpr int attend_smem(int H, int R, int In) {
  return ktiles(H) * 3 * 512 + (int)sizeof(float) * RT * (2 * H + In + R);
}

// Rows r0 .. r0 + RT - 1: x = [word, ctx] (f32, in shared memory), then
// [x | h] split into three bf16 terms, written to `apk` ([rows][3][KT * 16]
// bf16, zero past In and H) for the gate phase.  The block's images read
// their att1 and feats once, for all their rows.  At most 64 registers, so
// that four blocks share an SM: the scores' tanhf and the loads of att1 and
// feats need the warps.
template <int RT>
__global__ void __launch_bounds__(kThreads, 4) attend_kernel(
    const __nv_bfloat16* __restrict__ feats, const __nv_bfloat16* __restrict__ att1,
    const float* __restrict__ h, const int* __restrict__ tok, int t,
    const __nv_bfloat16* __restrict__ emb, const uint2* __restrict__ ua_pk,
    const float* __restrict__ ua_b, const float* __restrict__ va, uint32_t* __restrict__ apk,
    const int* __restrict__ live, int rows, int rpi, int zero_word_t0, int R, int F, int E,
    int H, int skip) {
  if (!step_runs(live)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int KTh = ktiles(H), In = E + F, KTx = ktiles(In), KT = KTx + KTh, U = groups(H);
  uint32_t* sa = reinterpret_cast<uint32_t*>(smem_raw);  // [KTh][3][128]: h's terms, rows 0..15
  float* sh = reinterpret_cast<float*>(sa + KTh * 3 * 128);  // [RT][H] h
  float* sa2 = sh + RT * H;                                  // [RT][H] U_a h + b
  float* sx = sa2 + RT * H;                                  // [RT][In] x
  float* sw = sx + RT * In;                                  // [RT][R] scores -> weights
  const int r0 = blockIdx.x * RT, nr = min(RT, rows - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = r0 / rpi, ni = (r0 + nr - 1) / rpi - i0 + 1;

#pragma unroll 4
  for (int e = tid; e < RT * H; e += kThreads) {
    const int r = e / H;
    sh[e] = r < nr ? h[(size_t)(r0 + r) * H + e - r * H] : 0.f;
  }
  for (int e = tid; e < nr * E; e += kThreads) {
    const int r = e / E, j = e - r * E;
    sx[r * In + j] = t > 0 || !zero_word_t0 ? to_f(emb[(size_t)tok[r0 + r] * E + j]) : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < 16 * KTh * 8; e += kThreads) {  // h's three terms for U_a
    const int r = e / (KTh * 8), rem = e - r * KTh * 8, kt = rem >> 3;
    const int k = kt * 16 + 2 * (rem & 7);
    if (r < nr)
      put_pair(sa, KTh, r, kt, rem & 7, k < H ? sh[r * H + k] : 0.f,
               k + 1 < H ? sh[r * H + k + 1] : 0.f);
    else
      put_zero(sa, KTh, r, kt, rem & 7);
  }
  __syncthreads();

  {  // att2 = U_a h + b: warp w takes the column groups w, w + 8, ...
    constexpr int kG = (kMaxH / kUnits + kWarps - 1) / kWarps;
    const uint4* a4 = reinterpret_cast<const uint4*>(sa);
    float acc[kG][4];
#pragma unroll
    for (int i = 0; i < kG; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    for (int kt0 = 0; kt0 < ((skip & 1) ? 0 : KTh); kt0 += kUaBatch) {
      uint2 b[kUaBatch][kG];
#pragma unroll
      for (int d = 0; d < kUaBatch; ++d)
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          const int u = warp + kWarps * i, kt = kt0 + d;
          b[d][i] = u < U && kt < KTh ? __ldg(ua_pk + ((size_t)u * KTh + kt) * 32 + lane)
                                      : make_uint2(0u, 0u);
        }
#pragma unroll
      for (int d = 0; d < kUaBatch; ++d) {
        if (kt0 + d >= KTh) break;
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          const uint4 a = a4[((kt0 + d) * 3 + term) * 32 + lane];
#pragma unroll
          for (int i = 0; i < kG; ++i)
            if (warp + kWarps * i < U) mma(acc[i], a, b[d][i]);
        }
      }
    }
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int i = 0; i < kG; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = g + 8 * (c >> 1), j = (warp + kWarps * i) * kUnits + 2 * q + (c & 1);
        if (r < nr && j < H) sa2[r * H + j] = acc[i][c] + ua_b[j];
      }
  }
  __syncthreads();

  // scores: a warp per (image, region); the lane's depths j = lane + 32 i
  constexpr int kJ = kMaxH / 32;
  const int nj = (H + 31) / 32;
  float vr[kJ];
#pragma unroll
  for (int i = 0; i < kJ; ++i)
    vr[i] = i < nj && lane + 32 * i < H ? va[lane + 32 * i] : 0.f;
  for (int p = warp; p < ((skip & 2) ? 0 : ni * R); p += kWarps) {
    const int il = p / R, img = i0 + il, rho = p - il * R;
    const __nv_bfloat16* a1 = att1 + ((size_t)img * R + rho) * H;
    float av[kJ];
#pragma unroll
    for (int i = 0; i < kJ; ++i)
      av[i] = i < nj && lane + 32 * i < H ? to_f(a1[lane + 32 * i]) : 0.f;
    const int ra = max(r0, img * rpi) - r0, rb = min(r0 + nr, (img + 1) * rpi) - r0;
    for (int r = ra; r < rb; ++r) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kJ; ++i)
        if (i < nj && lane + 32 * i < H) s += tanhf(av[i] + sa2[r * H + lane + 32 * i]) * vr[i];
      s = warp_sum(s);
      if (lane == 0) sw[r * R + rho] = s;
    }
  }
  __syncthreads();

  for (int r = warp; r < ((skip & 2) ? 0 : nr); r += kWarps) {  // softmax over regions
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

  // context: a thread per (image, pair of features), up to 4 of the image's
  // rows a pass
  const int F2 = (F + 1) / 2;
  for (int e = tid; e < ni * F2; e += kThreads) {
    const int il = e / F2, f = 2 * (e - il * F2), img = i0 + il;
    const int ra = max(r0, img * rpi) - r0, rb = min(r0 + nr, (img + 1) * rpi) - r0;
    const __nv_bfloat16* fp = feats + (size_t)img * R * F + f;
    const bool two = f + 1 < F;
    for (int rc = ra; rc < rb; rc += 4) {
      float c[4][2] = {};
#pragma unroll 7
      for (int rho = 0; rho < ((skip & 4) ? 0 : R); ++rho) {
        const float v0 = to_f(fp[(size_t)rho * F]);
        const float v1 = two ? to_f(fp[(size_t)rho * F + 1]) : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (rc + k < rb) {
            const float w = sw[(rc + k) * R + rho];
            c[k][0] += w * v0;
            c[k][1] += w * v1;
          }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (rc + k < rb) {
          sx[(rc + k) * In + E + f] = c[k][0];
          if (two) sx[(rc + k) * In + E + f + 1] = c[k][1];
        }
    }
  }
  __syncthreads();

  // [x | h] of the block's rows split, each term's bf16x2 words in a row of apk
  for (int e = tid; e < nr * KT * 8; e += kThreads) {
    const int r = e / (KT * 8), p = e - r * KT * 8;
    const bool xs = p < KTx * 8;
    const int k = (xs ? p : p - KTx * 8) * 2, n = xs ? In : H;
    const float* src = xs ? sx + r * In : sh + r * H;
    unsigned t0[3], t1[3];
    vocab::split3(k < n ? src[k] : 0.f, t0);
    vocab::split3(k + 1 < n ? src[k + 1] : 0.f, t1);
    uint32_t* dst = apk + (size_t)(r0 + r) * 3 * KT * 8 + p;
#pragma unroll
    for (int q = 0; q < 3; ++q) dst[q * KT * 8] = t0[q] | (t1[q] << 16);
  }
}

// The k16 tiles kb .. ke - 1 of the products of NG unit groups (the first
// nv of them real) for one style: gates r and z into acc[.][.][0], [1],
// gate n into acc[.][.][NQ] (2: x's part, gi_n; 3: h's part, gh_n).  A's
// fragments come from the row-major terms in shared memory by ldmatrix
// (`a_lane`: this lane's row and column block of term 0, m16 tile 0, k16
// tile 0; `term_bytes`, `m_bytes` the strides), each used for the NG
// groups' three gates.  keep: bit 2m (row g of m16 tile m) and 2m + 1 (row
// g + 8) are set when the lane's row has this style; the others' A is zero,
// and adds exact zeros.  B's fragments (wb: the first group's, the next
// group's `wstride` uint2 on) for the next kBatch / NG tiles load during
// this batch's products.
template <int MT, int NG, int NQ>
__device__ __forceinline__ void gate_part(float (&acc)[NG][MT][4][4], uint32_t a_lane,
                                          int term_bytes, int m_bytes,
                                          const uint2* __restrict__ wb, size_t wstride, int nv,
                                          int lane, unsigned keep, int kb, int ke) {
  constexpr int kB = kBatch / NG;
  uint2 b[kB][NG][3], nb[kB][NG][3];
  auto load = [&](uint2(&dst)[kB][NG][3], int kt0) {
#pragma unroll
    for (int d = 0; d < kB; ++d)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          dst[d][n][q] = kt0 + d < ke && n < nv
                             ? __ldg(wb + n * wstride + ((kt0 + d) * 3 + q) * 32 + lane)
                             : make_uint2(0u, 0u);
  };
  load(b, kb);
  for (int kt0 = kb; kt0 < ke; kt0 += kB) {
    load(nb, kt0 + kB);
#pragma unroll
    for (int d = 0; d < kB; ++d) {
      if (kt0 + d >= ke) break;
      uint4 a[MT][3];  // every fragment of this k16 tile, loaded back to back
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int term = 0; term < 3; ++term)
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(a[m][term].x), "=r"(a[m][term].y), "=r"(a[m][term].z),
                         "=r"(a[m][term].w)
                       : "r"(a_lane + term * term_bytes + m * m_bytes + (kt0 + d) * 32));
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          uint4 f = a[m][term];
          if (!(keep >> (2 * m) & 1u)) f.x = f.z = 0u;
          if (!(keep >> (2 * m + 1) & 1u)) f.y = f.w = 0u;
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            mma(acc[n][m][0], f, b[d][n][0]);
            mma(acc[n][m][1], f, b[d][n][1]);
            mma(acc[n][m][NQ], f, b[d][n][2]);
          }
        }
    }
#pragma unroll
    for (int d = 0; d < kB; ++d)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int q = 0; q < 3; ++q) b[d][n][q] = nb[d][n][q];
  }
}

// A's shared memory: per term 16 MT rows of KT * 16 bf16 and 8 of padding
// (a row stride of 16 mod 128 bytes keeps ldmatrix free of bank conflicts)
__host__ __device__ constexpr int gates_row_bytes(int KT) { return (KT * 16 + 8) * 2; }

// A, the sums of the parts of the depths (NG = 1), the tile's styles
__host__ __device__ constexpr int gates_smem(int MT, int NG, int In, int H) {
  return 3 * 16 * MT * gates_row_bytes(ktiles(In) + ktiles(H)) +
         (NG == 1 ? kWarps * MT * 16 * 32 * (int)sizeof(float) : 0) +
         16 * MT * (int)sizeof(int);
}

// h_new of rows row0 .. row0 + 16 MT - 1 and hidden units of the block's
// `gb` groups (fewer in the last column of blocks when gb does not divide
// the groups).  A warp takes NG groups at once.  With NG = 1 the 8 warps
// take (group, part of the depths), 8 / n parts a group for the block's n
// groups rounded up to a power of 2, the parts summed in shared memory in
// their order; with NG = 2 (gb = 16) a warp takes a pair of groups and all
// the depths.  `apk` holds [x | h] split (attend_kernel) for rows up to the
// grid's last row tile; a row past `rows` holds anything and is masked.
template <int MT, int NG>
__global__ void __launch_bounds__(kThreads) gates_kernel(
    const uint32_t* __restrict__ apk, const float* __restrict__ h,
    const int* __restrict__ styles, const uint2* __restrict__ wpk,
    const float* __restrict__ bih, const float* __restrict__ bhh, float* __restrict__ h_new,
    const int* __restrict__ live, int rows, int rpi, int In, int H, int S, int gb, int skip) {
  if (!step_runs(live)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned present;
  const int KTx = ktiles(In), KT = KTx + ktiles(H), U = groups(H);
  const int n = min(gb, U - (int)blockIdx.x * gb), items = (n + NG - 1) / NG;
  const int ks = NG > 1 ? 1 : items == 1 ? 8 : items == 2 ? 4 : items <= 4 ? 2 : 1;
  const int row_bytes = gates_row_bytes(KT), term_bytes = 16 * MT * row_bytes;
  float* red = reinterpret_cast<float*>(smem_raw + 3 * term_bytes);  // [8][MT][16][32], NG = 1
  int* srow = reinterpret_cast<int*>(red + (NG == 1 ? kWarps * MT * 16 * 32 : 0));  // [16 MT]
  const int row0 = blockIdx.y * 16 * MT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t sA = hopper::smem_addr(smem_raw);

  {  // A: the tile's rows of the split [x | h], 16-byte copies into padded rows
    const int chunks = KT * 2;  // 16 bytes: 8 depths of a term's row
    const uint32_t* src = apk + (size_t)row0 * 3 * KT * 8;
    for (int c = tid; c < ((skip & 8) ? 0 : 16 * MT * 3 * chunks); c += kThreads) {
      const int rt = c / chunks, j = c - rt * chunks, r = rt / 3, term = rt - r * 3;
      hopper::cp_async16(sA + term * term_bytes + r * row_bytes + 16 * j, src + 4 * c, true);
    }
    hopper::cp_async_commit();
  }
  if (tid == 0) present = 0u;
  __syncthreads();
  for (int r = tid; r < 16 * MT; r += kThreads) {
    const int row = row0 + r;
    int s = -1;
    if (row < rows) {
      s = min(max(styles[row / rpi], 0), S - 1);
      atomicOr(&present, 1u << s);
    }
    srow[r] = s;
  }
  hopper::cp_async_wait<0>();
  __syncthreads();

  const int item = warp / ks, part = warp % ks;
  const int u = item < items ? blockIdx.x * gb + item * NG : U;  // the warp's first group
  const int nv = min(NG, n - item * NG);                           // its groups that are real
  const int g = lane >> 2, q = lane & 3;
  float acc[NG][MT][4][4];
#pragma unroll
  for (int k = 0; k < NG; ++k)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[k][m][i][c] = 0.f;
  if (u < U) {  // uniform across the warp
    const int kb = part * KT / ks, ke = (part + 1) * KT / ks;
    const uint32_t a_lane = sA + (lane & 15) * row_bytes + (lane >> 4) * 16;
    const size_t wstride = (size_t)KT * 3 * 32;  // uint2 of a group's packed theta
    for (unsigned mask = present; mask; mask &= mask - 1) {  // each style present, in order
      const int s = __ffs(mask) - 1;
      unsigned keep = 0u;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        keep |= (unsigned)(srow[m * 16 + g] == s) << (2 * m);
        keep |= (unsigned)(srow[m * 16 + g + 8] == s) << (2 * m + 1);
      }
      const uint2* wb = wpk + ((size_t)s * U + u) * wstride;
      gate_part<MT, NG, 2>(acc, a_lane, term_bytes, 16 * row_bytes, wb, wstride, nv, lane, keep,
                           kb, min(ke, KTx));
      gate_part<MT, NG, 3>(acc, a_lane, term_bytes, 16 * row_bytes, wb, wstride, nv, lane, keep,
                           max(kb, KTx), ke);
    }
  }
  if (NG == 1 && ks > 1) {  // uniform across the block
    float* mine = red + warp * MT * 16 * 32;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) mine[((m * 4 + i) * 4 + c) * 32 + lane] = acc[0][m][i][c];
    __syncthreads();
    if (part != 0) return;
    for (int o = 1; o < ks; ++o) {
      const float* other = red + (warp + o) * MT * 16 * 32;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[0][m][i][c] += other[((m * 4 + i) * 4 + c) * 32 + lane];
    }
  }
  if (u >= U) return;

  const int G = 3 * H;
#pragma unroll
  for (int k = 0; k < NG; ++k)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = m * 16 + g + 8 * (c >> 1), row = row0 + r;
        const int j = (u + k) * kUnits + 2 * q + (c & 1);
        if (k >= nv || row >= rows || j >= H) continue;
        const float* bi = bih + (size_t)srow[r] * G;
        const float* bh = bhh + (size_t)srow[r] * G;
        const float rg = sigmoidf(acc[k][m][0][c] + (bi[j] + bh[j]));
        const float zg = sigmoidf(acc[k][m][1][c] + (bi[H + j] + bh[H + j]));
        const float ng =
            tanhf((acc[k][m][2][c] + bi[2 * H + j]) + rg * (acc[k][m][3][c] + bh[2 * H + j]));
        h_new[(size_t)row * H + j] = (1.f - zg) * ng + zg * h[(size_t)row * H + j];
      }
}

struct Args {
  const void *feats, *att1, *h, *tok, *styles;
  int t;
  const void *emb, *ua_pk, *ua_b, *va, *wpk, *bih, *bhh;
  void *apk, *h_new;
  const void* live;
  int rows, rpi, zero_word_t0, R, F, E, H, S, gate_rows, gate_groups, phases;
  cudaStream_t stream;
};

// Lets `kernel` take `bytes` of dynamic shared memory: above the default
// 48 KB it sets the attribute once per device and size (`granted`: the
// largest size set so far on each device, one array per kernel), since a
// decode step's host time is part of what a decode costs.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes, int (&granted)[16]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 16 && granted[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 16) granted[dev] = bytes;
  return err;
}

template <int RT>
int launch_attend(const Args& a) {
  static int granted[16] = {};
  const int smem = attend_smem<RT>(a.H, a.R, a.E + a.F);
  const cudaError_t err = allow_smem(attend_kernel<RT>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  attend_kernel<RT><<<(a.rows + RT - 1) / RT, kThreads, smem, a.stream>>>(
      (const __nv_bfloat16*)a.feats, (const __nv_bfloat16*)a.att1, (const float*)a.h,
      (const int*)a.tok, a.t, (const __nv_bfloat16*)a.emb, (const uint2*)a.ua_pk,
      (const float*)a.ua_b, (const float*)a.va, (uint32_t*)a.apk, (const int*)a.live, a.rows, a.rpi,
      a.zero_word_t0, a.R, a.F, a.E, a.H, a.phases >> 2);
  return (int)cudaGetLastError();
}

template <int MT, int NG>
int launch_gates(const Args& a) {
  static int granted[16] = {};
  const int In = a.E + a.F, smem = gates_smem(MT, NG, In, a.H);
  const cudaError_t err = allow_smem(gates_kernel<MT, NG>, smem, granted);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((groups(a.H) + a.gate_groups - 1) / a.gate_groups,
                  (a.rows + 16 * MT - 1) / (16 * MT));
  gates_kernel<MT, NG><<<grid, kThreads, smem, a.stream>>>(
      (const uint32_t*)a.apk, (const float*)a.h, (const int*)a.styles, (const uint2*)a.wpk,
      (const float*)a.bih, (const float*)a.bhh, (float*)a.h_new, (const int*)a.live, a.rows,
      a.rpi, In, a.H, a.S, a.gate_groups, a.phases >> 2);
  return (int)cudaGetLastError();
}

int entry(const Args& a, int block_rows) {
  const int gb = a.gate_groups;
  if (a.rpi < 1 || a.rows < 1 || a.H < 1 || a.H > kMaxH || a.S < 1 || a.S > kMaxStyles ||
      (gb != 1 && gb != 2 && gb != 4 && gb != 8 && gb != 16) ||
      reinterpret_cast<uintptr_t>(a.ua_pk) % 8 || reinterpret_cast<uintptr_t>(a.wpk) % 8 ||
      reinterpret_cast<uintptr_t>(a.apk) % 16)
    return (int)cudaErrorInvalidValue;
  if (block_rows != 3 && block_rows != 6 && block_rows != 12) return (int)cudaErrorInvalidValue;
  if (a.phases & 1) {
    const int rc = block_rows == 3    ? launch_attend<3>(a)
                   : block_rows == 6 ? launch_attend<6>(a)
                                     : launch_attend<12>(a);
    if (rc) return rc;
  }
  if (!(a.phases & 2)) return (int)cudaSuccess;
  if (gb == 16)  // a warp takes a pair of groups
    return a.gate_rows == 48 ? launch_gates<3, 2>(a) : (int)cudaErrorInvalidValue;
  switch (a.gate_rows) {
    case 16: return launch_gates<1, 1>(a);
    case 32: return launch_gates<2, 1>(a);
    case 48: return launch_gates<3, 1>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cell

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

// Cell step for rows of `rows_per_image` rows per image (3: beam, 1: greedy);
// f32 weights: one launch of the CUDA-core kernel, `block_rows` rows a block.
int cell_step_f32(const void* feats, const void* att1, const void* h, const void* tok,
                  const void* styles, int t, const void* emb, const void* ua_w,
                  const void* ua_b, const void* va, const void* wih, const void* whh,
                  const void* bih, const void* bhh, void* h_new, const void* live, int rows,
                  int rows_per_image, int zero_word_t0, int R, int F, int E, int H, int S,
                  int block_rows, void* stream) {
  return cell_entry_f32(CellArgs{feats, att1, h, tok, styles, t, emb, ua_w, ua_b, va, wih,
                                 whh, bih, bhh, h_new, live, rows, rows_per_image,
                                 zero_word_t0, R, F, E, H, S, (cudaStream_t)stream},
                        block_rows);
}

// bf16 weights: the attention phase (`block_rows` rows a block) writes
// [x | h] split into three bf16 terms to `apk` ([rows][3][KT * 16] bf16,
// KT = ceil(In / 16) + ceil(H / 16), rows up to the gate grid's last),
// then the gate phase (`gate_rows` rows x `gate_groups` groups of 8 hidden
// units a block; decode_kernel.gate_tile) reads it; ua_pk and wpk are the packed U_a and theta bank
// (decode_kernel.pack_ua, pack_gate_theta).  phases: 3 runs both; 1 (the
// attention) or 2 (the gates) runs one, to time it apart; adding 4, 8, 16
// or 32 leaves out U_a h, the scores and softmax, the context, or the gate
// phase's copy of [x | h], to time the parts (the result is then wrong).
int cell_step_bf16(const void* feats, const void* att1, const void* h, const void* tok,
                   const void* styles, int t, const void* emb, const void* ua_pk,
                   const void* ua_b, const void* va, const void* wpk, const void* bih,
                   const void* bhh, void* apk, void* h_new, const void* live, int rows,
                   int rows_per_image, int zero_word_t0, int R, int F, int E, int H, int S,
                   int block_rows, int gate_rows, int gate_groups, int phases,
                   void* stream) {
  return cell::entry(cell::Args{feats, att1, h, tok, styles, t, emb, ua_pk, ua_b, va, wpk, bih,
                                bhh, apk, h_new, live, rows, rows_per_image, zero_word_t0, R, F,
                                E, H, S, gate_rows, gate_groups, phases, (cudaStream_t)stream},
                     block_rows);
}

// the dynamic shared memory of the bf16 cell's two kernels (bytes)
int cell_attend_smem(int block_rows, int H, int R, int In) {
  switch (block_rows) {
    case 3: return cell::attend_smem<3>(H, R, In);
    case 6: return cell::attend_smem<6>(H, R, In);
    case 12: return cell::attend_smem<12>(H, R, In);
    default: return -1;
  }
}

int cell_gates_smem(int gate_rows, int gate_groups, int In, int H) {
  return cell::gates_smem(gate_rows / 16, gate_groups == 16 ? 2 : 1, In, H);
}

int logits_top3_partial_f32(const void* h, const void* fc_w, const void* fc_b, void* pv,
                            void* pi, void* pm, void* ps, const void* live, int rows,
                            int H, int Vp, void* stream) {
  return logits_entry<float>(h, fc_w, fc_b, pv, pi, pm, ps, live, rows, H, Vp, stream);
}

// per_block: items (128-row tile, 128-column chunk) per block
// (decode_kernel.vocab_items_per_block)
int logits_top3_partial_bf16(const void* h, const void* fc_w, const void* fc_b, void* pv,
                             void* pi, void* pm, void* ps, const void* live, int rows,
                             int H, int Vp, int per_block, void* stream) {
  if (vocab::stages(H) == 8)
    return logits_top3_wgmma<8>(h, fc_w, fc_b, pv, pi, pm, ps, live, rows, H, Vp, per_block,
                                (cudaStream_t)stream);
  return logits_top3_wgmma<4>(h, fc_w, fc_b, pv, pi, pm, ps, live, rows, H, Vp, per_block,
                              (cudaStream_t)stream);
}

// the dynamic shared memory of the bf16 vocab products at depth H (bytes)
int vocab_product_smem(int H) { return vocab::smem_bytes(H); }

// images: images a block (decode_kernel.select_images_per_block)
int beam_select(const void* pv, const void* pi, const void* pm, const void* ps,
                const void* h_new, void* h, void* tok, void* score, const void* hist_in,
                void* hist_out, void* best_seq, void* best_val, void* best_len, void* found,
                void* live, int n_img, int n_chunks, int H, int T, int t, int end_id,
                int images, void* stream) {
  if (images < 1 || images > sel::kMaxImages || n_img < 1 || n_chunks < 1 || H < 1 || T < 1 ||
      ((reinterpret_cast<uintptr_t>(pv) | reinterpret_cast<uintptr_t>(pi) |
        reinterpret_cast<uintptr_t>(pm) | reinterpret_cast<uintptr_t>(ps)) & 15))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * images * sel::image_words(H, T);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(sel::beam_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sel::beam_select_kernel<<<(n_img + images - 1) / images, images * sel::kImageThreads, smem,
                            (cudaStream_t)stream>>>(
      (const float*)pv, (const int*)pi, (const float*)pm, (const float*)ps, (const float*)h_new,
      (float*)h, (int*)tok, (float*)score, (const int*)hist_in, (int*)hist_out, (int*)best_seq,
      (float*)best_val, (int*)best_len, (int*)found, (int*)live, n_img, n_chunks, H, T, t,
      end_id);
  return (int)cudaGetLastError();
}

}  // extern "C"
