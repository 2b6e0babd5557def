// Windowed multi-head attention with SAM's decomposed rel-pos bias: the CUDA
// kernels behind K2 / K10 (window_attention_rows_grid) and K11-K13
// (window_attention_rows, window_attention_relpos,
// window_attention_relpos_batched) of sam_road_tpu_torch/ops/fused_block.py,
// and the tools' T2 / T3 (experiment_window_attn.py) and T4
// (experiment_relpos_kernel.py) of sam_road_tpu_torch/tools.
//
// K2 replaces sam_road_tpu/ops/fused_block.py::window_attention_rows_grid at
// its default granularity (_window_attn_rows_grid_kernel + _win_attn_body).
// One block per (image, window, head), as one Pallas program per (image,
// window) looped over heads. q, k and v are read with strides straight out
// of the bias-free qkv grid [B, Hp, Wp, 3C]; the qkv bias is added to every
// token, so the window-padding tokens become exactly `bias` (SAM's zero pad
// after norm1). The output is written back in grid layout [B, Hp, Wp, C].
//
// What bounds it on the H100: per block only 2 x 196 x 196 x 64 x 2 = 9.8
// MFLOP against 2 x 196 x 64 x 4 x 2 bytes, so the card is bound by latency
// and shared-memory traffic, not by HBM or the tensor cores. The design
// keeps every intermediate in shared memory: the 196 tokens are padded to
// Np = 208 rows (13 strips of 16) with the pad KEYS masked to -inf -- not
// to be confused with the window-padding tokens, which are real keys -- and
// each of 4 warps walks query strips of 16:
//   s = q.k^T * scale + bh[n, i'] + bw[n, j']     (fp32, key n' = (i', j'))
//   p = exp(s - max), l = sum p,  out = (bf16(p) . v) / l
// the score strip never leaves shared memory (a full 196 x 196 fp32 score
// tile would be 154 KB). Products use nvcuda::wmma bf16 fragments with fp32
// accumulation. The scale is a post-product fp32 multiply, the JAX body's
// non-merged branch, which is exact for every head_dim; at a power of two
// it equals the merged branch's pre-scaled q bit for bit.
//
// Head dims: the per-window body is attend<DQK, DV, BIAS, NORM_FIRST>, with
// the q/k and the v widths as template parameters. Every window kernel is
// instantiated at head_dim 64 (ViT-B, vit_l) and 80 (vit_h: 1280 / 16); at
// 80 the q/k/v rows are 88 bf16 apart in shared memory (16-byte rows), and
// the layout takes 192 KB (216 KB with K12 / K13's fp32 bias rows) of the
// 227 KB a block may use. Another head_dim has no instance and is refused.
//
// K10: the rolled_rows / group_batch granularities of the same function
// (_window_attn_rows_grid_rolled_kernel, _window_attn_rows_grid_gbatch_kernel)
// are choices of how blocks map to work, over the same per-window code
// (attend), so their outputs are bit-equal to K2's:
//   MODE_WINDOW  one block per (image, window, head)             (K2)
//   MODE_ROLLED  one block per (image, window row, head), looping over the
//                row's nJ windows
//   MODE_GBATCH  one block per (image group, window, head), looping over the
//                group's G images
// On the TPU they cut the program count of a latency-bound dispatch. Here
// nothing is shared across the loop's iterations (each window reloads its
// q/k/v), so they only trade parallelism for fewer, longer blocks.
//
// K11-K13 are modes of the same per-window code that differ from K2 in where
// the tokens live, where the bias rows come from and when p is normalised;
// each is bound like K2 by latency and shared memory (their HBM bound is
// 0.10-0.12 ms at nW = 288 windows of 196 tokens, C = 768, 12 heads):
//   K11 window_attention_rows (replaces fused_block.py::window_attention_rows,
//       _window_attn_rows_kernel): the materialised window layout
//       qkv [nW, N, 3C] with the bias already in, bias rows [nW, H, N, win]
//       bf16, output [nW, N, C];
//   K12 window_attention_relpos (replaces fused_block.py::
//       window_attention_relpos, _window_attn_kernel): K11's layout, the bias
//       rows built in the kernel from the expanded tables rh, rw [N, win, hd]:
//       bh[n, a] = sum_c q[n, c] rh[n, a, c] in fp32 into shared memory, never
//       rounded to bf16;
//   K13 window_attention_relpos_batched (replaces fused_block.py::
//       window_attention_relpos_batched, _window_attn_batched_kernel): K12's
//       function on head-split q, k, v [nW, H, N, hd] -> [nW, H, N, hd]. The
//       TPU pads 196 tokens to 256 with -1e30 keys for lane alignment; those
//       keys contribute exactly 0, and here the 208-row layout's -inf pad keys
//       do the same, so no padded copy is made.
// All three normalise p before p.v: p = exp(s - max) / l, rounded to bf16,
// then p.v (K2 divides after the product, so K11 equals K2 only within bf16
// rounding). `group` windows a block, the block looping over them, is the
// JAX kernels' windows-per-program and gives bit-equal outputs.
//
// The tools' kernels, two more modes of the same body:
//   T2 / T3 (replace tools/experiment_window_attn.py::pallas1 / pallasG,
//       kern1 / kernG): softmax(q.k^T) v over q, k [BH, N, 92] (the rel-pos
//       folded into the contraction) and v [BH, N, 64], no bias, no scale,
//       p unnormalised in bf16 and the division after p.v, as K2. The 92
//       columns are zero-padded to 96 in shared memory (the wmma depth is
//       16), and a 184-byte global row is only 8-byte aligned, so q and k
//       load in 8-byte pieces. G windows a block (T3) loop as K11's group
//       does, so every G gives T2's output to the bit.
//   T4 (replaces tools/experiment_relpos_kernel.py::sel_attention,
//       sel_kernel): K13's head-split addressing with K11's bias rows read,
//       p normalised first, scale 1 (q arrives pre-scaled): q, k, v
//       [BH, N, hd], qh, qw [BH, N, win] -> [BH, N, hd].
// Bound like K11: their HBM bounds are 0.11-0.13 ms at 3456 (window, head)
// pairs, against about 40 GFLOP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr size_t SMEM_MAX = 232448;  // a block's dynamic shared memory on Hopper
constexpr int FOLD_DQK = 96;         // T2 / T3: the folded q/k width, padded in shared memory
constexpr int FOLD_DV = 64;          // T2 / T3: the value width

enum Bias { BIAS_NONE = 0, BIAS_ROWS = 1, BIAS_TABLE = 2 };

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) & ~(size_t)127; }

struct Layout {  // dynamic shared memory carve-up, byte offsets
  int np, lds, ldp;
  size_t q, k, v, table, warp0, warp_bytes, s_off, p_off, l_off, total;
  // q/k rows dqk wide, v rows dv wide (each + 8 bf16 of row padding);
  // table_win > 0 reserves fp32 bias rows [np, 2 * table_win] (K12, K13).
  __host__ __device__ Layout(int N, int dqk, int dv, int table_win = 0) {
    np = (N + 15) & ~15;
    lds = (np > dv ? np : dv) + 4;  // fp32 row stride: np scores, then dv outputs
    ldp = np + 8;                   // bf16 probability row stride (multiple of 8)
    const size_t qk = (size_t)np * (dqk + 8) * sizeof(bf16);
    q = 0;
    k = qk;
    v = 2 * qk;
    table = v + (size_t)np * (dv + 8) * sizeof(bf16);
    warp0 = table + align128((size_t)np * 2 * table_win * sizeof(float));
    s_off = 0;
    p_off = align128(16 * lds * sizeof(float));
    l_off = p_off + align128(16 * ldp * sizeof(bf16));
    warp_bytes = l_off + 128;
    total = warp0 + WARPS * warp_bytes;
  }
};

enum Mode { MODE_WINDOW = 0, MODE_ROLLED = 1, MODE_GBATCH = 2 };

// Where one (window, head)'s tokens, bias rows and output live. Token
// n = (i, j) of the window sits at element i * row + j * col from q / k
// (in_*), v (in_*, or v_* where its width differs: T2 / T3) and out
// (out_*), channel 0 of this head.
struct Tile {
  const bf16 *q, *k, *v;
  bf16* out;
  int64_t in_row, in_col, v_row, v_col, out_row, out_col;
  const bf16 *bh, *bw;    // bias rows [N, win] (K2, K11, T4), expanded tables [N, win, hd]
                          // (K12, K13), or null
  const bf16* qkv_bias;   // this head's q bias, k's at +C and v's at +2C (K2), or null
  int C;
  int dqk;                // T2 / T3: the q/k width in memory, a multiple of 4 up to FOLD_DQK
};

template <int D>
__device__ __forceinline__ float dot_bf16(const bf16* a, const bf16* b) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 8) {
    const uint4 ua = *reinterpret_cast<const uint4*>(a + c);
    const uint4 ub = *reinterpret_cast<const uint4*>(b + c);
    const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&ua);
    const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&ub);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(ha[i]), y = __bfloat1622float2(hb[i]);
      acc += x.x * y.x;
      acc += x.y * y.y;
    }
  }
  return acc;
}

// Rows [0, np) x [0, D) of a shared-memory operand (row stride D + 8) from
// the window's tokens, VEC bf16 a load (8: 16 bytes; 4: 8 bytes); columns
// from dmem on and rows N..np-1 are zero (T2 / T3).
template <int D, int VEC>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t row, int64_t col,
                                          int N, int np, int win, int dmem) {
  typedef typename std::conditional<VEC == 8, uint4, uint2>::type Vec;
  for (int e = threadIdx.x; e < np * (D / VEC); e += THREADS) {
    const int n = e / (D / VEC), c = (e % (D / VEC)) * VEC;
    Vec u = Vec{};
    if (n < N && c < dmem)
      u = *reinterpret_cast<const Vec*>(src + (n / win) * row + (n % win) * col + c);
    *reinterpret_cast<Vec*>(dst + n * (D + 8) + c) = u;
  }
}

// Attention of one (window, head) with the whole block. DQK / DV: the q/k
// and v widths in shared memory; BIAS: none (T2 / T3), bias rows read (K2,
// K11, T4) or built here from the expanded tables (K12, K13); NORM_FIRST: p
// is normalised before p.v (K11-K13, T4), else after (K2, T2 / T3).
template <int DQK, int DV, int BIAS, bool NORM_FIRST>
__device__ __forceinline__ void attend(const Tile& t, unsigned char* smem, const Layout& L,
                                       int win, float scale) {
  constexpr int LDQK = DQK + 8, LDV = DV + 8;
  const int N = win * win;
  bf16 (*Qs)[LDQK] = reinterpret_cast<bf16 (*)[LDQK]>(smem + L.q);
  bf16 (*Ks)[LDQK] = reinterpret_cast<bf16 (*)[LDQK]>(smem + L.k);
  bf16 (*Vs)[LDV] = reinterpret_cast<bf16 (*)[LDV]>(smem + L.v);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if constexpr (DQK == DV) {
    // q/k/v of this (window, head), a 16-byte chunk of each per step (three
    // loads in flight), the qkv bias (if any) added to every token (pad
    // tokens included); rows N..Np-1 are zero. v shares q's strides.
    for (int e = tid; e < L.np * (DQK / 8); e += THREADS) {
      const int n = e / (DQK / 8), c = (e % (DQK / 8)) * 8;
      uint4 vals[3];
      if (n < N) {
        const int64_t off = (n / win) * t.in_row + (n % win) * t.in_col + c;
        const bf16* src[3] = {t.q, t.k, t.v};
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          uint4 u = *reinterpret_cast<const uint4*>(src[p] + off);
          if (t.qkv_bias) {
            const uint4 bu = *reinterpret_cast<const uint4*>(t.qkv_bias + p * t.C + c);
            __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
            const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&bu);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float2 x = __bfloat1622float2(h[i]), y = __bfloat1622float2(hb[i]);
              h[i] = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
            }
          }
          vals[p] = u;
        }
      } else {
        vals[0] = vals[1] = vals[2] = make_uint4(0u, 0u, 0u, 0u);
      }
      *reinterpret_cast<uint4*>(&Qs[n][c]) = vals[0];
      *reinterpret_cast<uint4*>(&Ks[n][c]) = vals[1];
      *reinterpret_cast<uint4*>(&Vs[n][c]) = vals[2];
    }
  } else {
    // T2 / T3: q/k rows t.dqk wide in memory (8-byte aligned), zero-padded
    // to DQK; v rows DV wide at their own strides
    load_rows<DQK, 4>(&Qs[0][0], t.q, t.in_row, t.in_col, N, L.np, win, t.dqk);
    load_rows<DQK, 4>(&Ks[0][0], t.k, t.in_row, t.in_col, N, L.np, win, t.dqk);
    load_rows<DV, 8>(&Vs[0][0], t.v, t.v_row, t.v_col, N, L.np, win, DV);
  }
  __syncthreads();

  // K12 / K13: bias rows [n][0, win) = q[n] . rh[n, a], [n][win, 2 win) =
  // q[n] . rw[n, a], fp32, one (n, a) a thread.
  float* table = reinterpret_cast<float*>(smem + L.table);
  if constexpr (BIAS == BIAS_TABLE) {
    for (int e = tid; e < N * 2 * win; e += THREADS) {
      const int n = e / (2 * win), a = e % (2 * win);
      const bf16* r = a < win ? t.bh + ((int64_t)n * win + a) * DQK
                              : t.bw + ((int64_t)n * win + a - win) * DQK;
      table[e] = dot_bf16<DQK>(&Qs[n][0], r);
    }
    __syncthreads();
  }

  unsigned char* wbase = smem + L.warp0 + warp * L.warp_bytes;
  float* S = reinterpret_cast<float*>(wbase + L.s_off);
  bf16* P = reinterpret_cast<bf16*>(wbase + L.p_off);
  float* lsum = reinterpret_cast<float*>(wbase + L.l_off);
  const int nstrips = L.np / 16;

  for (int strip = warp; strip < nstrips; strip += WARPS) {
    const int r0 = strip * 16;
    // scores of 16 queries against all Np keys
    for (int kb = 0; kb < L.np / 16; ++kb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int d = 0; d < DQK; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, &Qs[r0][d], LDQK);
        wmma::load_matrix_sync(fb, &Ks[kb * 16][d], LDQK);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(S + kb * 16, acc, L.lds, wmma::mem_row_major);
    }
    __syncwarp();
    // scale + rel-pos spread + pad-key mask, fp32 softmax numerator
    for (int r = 0; r < 16; ++r) {
      const int n = r0 + r;
      const int nb = n < N ? n : 0;
      float* srow = S + r * L.lds;
      float mx = -INFINITY;
      for (int m = lane; m < L.np; m += 32) {
        float s = -INFINITY;
        if (m < N) {
          s = srow[m] * scale;
          if (n < N) {
            if constexpr (BIAS == BIAS_TABLE)
              s += table[nb * 2 * win + m / win] + table[nb * 2 * win + win + m % win];
            else if constexpr (BIAS == BIAS_ROWS)
              s += __bfloat162float(t.bh[nb * win + m / win]) +
                   __bfloat162float(t.bw[nb * win + m % win]);
          }
        }
        srow[m] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int m = lane; m < L.np; m += 32) {
        const float p = m < N ? expf(srow[m] - mx) : 0.f;
        sum += p;
        if constexpr (NORM_FIRST)
          srow[m] = p;
        else
          P[r * L.ldp + m] = __float2bfloat16_rn(p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if constexpr (NORM_FIRST) {
        for (int m = lane; m < L.np; m += 32) P[r * L.ldp + m] = __float2bfloat16_rn(srow[m] / sum);
      } else {
        if (lane == 0) lsum[r] = sum;
      }
    }
    __syncwarp();
    // p . v (then / l unless p was normalised)
#pragma unroll
    for (int d = 0; d < DV; d += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kb = 0; kb < L.np / 16; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, P + kb * 16, L.ldp);
        wmma::load_matrix_sync(fb, &Vs[kb * 16][d], LDV);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(S + d, acc, L.lds, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * DV; e += 32) {
      const int r = e / DV, d = e % DV;
      const int n = r0 + r;
      if (n < N) {
        const float o = NORM_FIRST ? S[r * L.lds + d] : S[r * L.lds + d] / lsum[r];
        t.out[(n / win) * t.out_row + (n % win) * t.out_col + d] = __float2bfloat16_rn(o);
      }
    }
    __syncwarp();
  }
}

// K2 / K10: image b, window (wi, wj), head of the padded grid.
template <int HD>
__device__ __forceinline__ void attend_grid(const bf16* qkv, const bf16* qkv_bias, const bf16* bh,
                                            const bf16* bw, bf16* out, unsigned char* smem,
                                            const Layout& L, int b, int wi, int wj, int head,
                                            int Hp, int Wp, int C, int heads, int win,
                                            float scale) {
  const int N = win * win;
  const int nI = Hp / win, nJ = Wp / win;
  const int64_t row0 = ((int64_t)b * Hp + wi * win) * Wp + wj * win;  // token (0, 0)
  const int64_t rows = ((((int64_t)b * nI + wi) * nJ + wj) * heads + head) * N * win;
  Tile t;
  t.q = qkv + row0 * 3 * C + head * HD;
  t.k = t.q + C;
  t.v = t.q + 2 * C;
  t.out = out + row0 * C + head * HD;
  t.in_row = (int64_t)Wp * 3 * C;
  t.in_col = 3 * C;
  t.out_row = (int64_t)Wp * C;
  t.out_col = C;
  t.bh = bh + rows;
  t.bw = bw + rows;
  t.qkv_bias = qkv_bias + head * HD;
  t.C = C;
  attend<HD, HD, BIAS_ROWS, false>(t, smem, L, win, scale);
}

template <int MODE, int HD>
__global__ void __launch_bounds__(THREADS)
window_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qkv_bias,
                        const bf16* __restrict__ bh, const bf16* __restrict__ bw,
                        bf16* __restrict__ out, int Hp, int Wp, int C, int heads,
                        int win, int G, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(win * win, HD, HD);
  const int nI = Hp / win, nJ = Wp / win;
  int idx = blockIdx.x;
  const int head = idx % heads; idx /= heads;
  if constexpr (MODE == MODE_ROLLED) {
    const int wi = idx % nI, b = idx / nI;
    for (int wj = 0; wj < nJ; ++wj) {
      if (wj) __syncthreads();  // the previous window's q/k/v are consumed
      attend_grid<HD>(qkv, qkv_bias, bh, bw, out, smem, L, b, wi, wj, head, Hp, Wp, C, heads,
                      win, scale);
    }
  } else {
    const int wj = idx % nJ; idx /= nJ;
    const int wi = idx % nI;
    const int b0 = idx / nI;
    if constexpr (MODE == MODE_GBATCH) {
      for (int g = 0; g < G; ++g) {
        if (g) __syncthreads();
        attend_grid<HD>(qkv, qkv_bias, bh, bw, out, smem, L, b0 * G + g, wi, wj, head, Hp, Wp,
                        C, heads, win, scale);
      }
    } else {
      attend_grid<HD>(qkv, qkv_bias, bh, bw, out, smem, L, b0, wi, wj, head, Hp, Wp, C, heads,
                      win, scale);
    }
  }
}

// K11 (BIAS_ROWS), K12 (BIAS_TABLE) on the window layout, K13 (HEADSPLIT,
// BIAS_TABLE) and T4 (HEADSPLIT, BIAS_ROWS, one head) on head-split tensors:
// one block per (group of G windows, head), looping over the group's windows.
template <bool HEADSPLIT, int BIAS, int HD>
__global__ void __launch_bounds__(THREADS)
window_layout_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ bh,
                     const bf16* __restrict__ bw, bf16* __restrict__ out, int C, int heads,
                     int win, int G, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(win * win, HD, HD, BIAS == BIAS_TABLE ? win : 0);
  const int N = win * win;
  const int head = blockIdx.x % heads;
  const int w0 = blockIdx.x / heads * G;
  for (int g = 0; g < G; ++g) {
    if (g) __syncthreads();  // the previous window's q/k/v and bias rows are consumed
    const int64_t w = w0 + g;
    // token (0, 0) of this (window, head); q, k and v are the three thirds
    // of one qkv row (window layout) or three tensors (head-split)
    const int64_t in0 = HEADSPLIT ? (w * heads + head) * N * HD : w * N * 3 * C + head * HD;
    Tile t;
    t.q = q + in0;
    t.k = k + in0;
    t.v = v + in0;
    t.out = out + (HEADSPLIT ? in0 : w * N * C + head * HD);
    t.in_col = HEADSPLIT ? HD : 3 * C;
    t.out_col = HEADSPLIT ? HD : C;
    t.in_row = win * t.in_col;
    t.out_row = win * t.out_col;
    if constexpr (BIAS == BIAS_TABLE) {  // the expanded tables, shared by every window and head
      t.bh = bh;
      t.bw = bw;
    } else {
      t.bh = bh + (w * heads + head) * N * win;
      t.bw = bw + (w * heads + head) * N * win;
    }
    t.qkv_bias = nullptr;
    t.C = C;
    attend<HD, HD, BIAS, true>(t, smem, L, win, scale);
  }
}

// T2 / T3: one block per G (window, head) pairs, looping over them; q, k
// [BH, N, dqk], v and out [BH, N, FOLD_DV].
__global__ void __launch_bounds__(THREADS)
folded_window_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int dqk, int win,
                     int G) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(win * win, FOLD_DQK, FOLD_DV);
  const int N = win * win;
  for (int g = 0; g < G; ++g) {
    if (g) __syncthreads();  // the previous window's q/k/v are consumed
    const int64_t w = (int64_t)blockIdx.x * G + g;
    Tile t;
    t.q = q + w * N * dqk;
    t.k = k + w * N * dqk;
    t.v = v + w * N * FOLD_DV;
    t.out = out + w * N * FOLD_DV;
    t.in_col = dqk;
    t.in_row = (int64_t)win * dqk;
    t.v_col = t.out_col = FOLD_DV;
    t.v_row = t.out_row = win * FOLD_DV;
    t.bh = t.bw = nullptr;
    t.qkv_bias = nullptr;
    t.C = 0;
    t.dqk = dqk;
    attend<FOLD_DQK, FOLD_DV, BIAS_NONE, false>(t, smem, L, win, 1.0f);
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, const Layout& L, int blocks, cudaStream_t stream,
                   Args... args) {
  if (L.total > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.total);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, THREADS, L.total, stream>>>(args...);
  return cudaGetLastError();
}

template <int MODE, int HD>
cudaError_t launch_window(const void* qkv, const void* qkv_bias, const void* bh,
                          const void* bw, void* out, int blocks, int Hp, int Wp, int C,
                          int heads, int win, int G, cudaStream_t stream) {
  return launch(window_attention_kernel<MODE, HD>, Layout(win * win, HD, HD), blocks, stream,
                reinterpret_cast<const bf16*>(qkv), reinterpret_cast<const bf16*>(qkv_bias),
                reinterpret_cast<const bf16*>(bh), reinterpret_cast<const bf16*>(bw),
                reinterpret_cast<bf16*>(out), Hp, Wp, C, heads, win, G,
                1.0f / sqrtf((float)HD));
}

template <int HD>
int window_modes(const void* qkv, const void* qkv_bias, const void* bh, const void* bw,
                 void* out, int B, int Hp, int Wp, int C, int heads, int win, int mode, int G,
                 cudaStream_t s) {
  const int nI = Hp / win, nJ = Wp / win;
  if (mode == MODE_WINDOW)
    return (int)launch_window<MODE_WINDOW, HD>(qkv, qkv_bias, bh, bw, out, B * nI * nJ * heads,
                                               Hp, Wp, C, heads, win, 1, s);
  if (mode == MODE_ROLLED)
    return (int)launch_window<MODE_ROLLED, HD>(qkv, qkv_bias, bh, bw, out, B * nI * heads, Hp,
                                               Wp, C, heads, win, 1, s);
  if (mode == MODE_GBATCH && G > 0 && B % G == 0)
    return (int)launch_window<MODE_GBATCH, HD>(qkv, qkv_bias, bh, bw, out,
                                               (B / G) * nI * nJ * heads, Hp, Wp, C, heads, win,
                                               G, s);
  return (int)cudaErrorInvalidValue;
}

template <bool HEADSPLIT, int BIAS, int HD>
int launch_layout_hd(const void* q, const void* k, const void* v, const void* bh,
                     const void* bw, void* out, int nW, int C, int heads, int win, int G,
                     float scale, cudaStream_t stream) {
  return (int)launch(window_layout_kernel<HEADSPLIT, BIAS, HD>,
                     Layout(win * win, HD, HD, BIAS == BIAS_TABLE ? win : 0), nW / G * heads,
                     stream, reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
                     reinterpret_cast<const bf16*>(v), reinterpret_cast<const bf16*>(bh),
                     reinterpret_cast<const bf16*>(bw), reinterpret_cast<bf16*>(out), C, heads,
                     win, G, scale);
}

// scale <= 0: 1 / sqrt(head_dim)
template <bool HEADSPLIT, int BIAS>
int launch_layout(const void* q, const void* k, const void* v, const void* bh, const void* bw,
                  void* out, int nW, int C, int heads, int win, int G, float scale,
                  cudaStream_t stream) {
  if (heads <= 0 || C % heads || win <= 0 || win * win > 256 || G <= 0 || nW <= 0 || nW % G)
    return (int)cudaErrorInvalidValue;
  const int hd = C / heads;
  if (scale <= 0.f) scale = 1.0f / sqrtf((float)hd);
  if (hd == 64)
    return launch_layout_hd<HEADSPLIT, BIAS, 64>(q, k, v, bh, bw, out, nW, C, heads, win, G,
                                                 scale, stream);
  if (hd == 80)
    return launch_layout_hd<HEADSPLIT, BIAS, 80>(q, k, v, bh, bw, out, nW, C, heads, win, G,
                                                 scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// qkv [B, Hp, Wp, 3C] bf16 (bias-free, zero pads), qkv_bias [3C] bf16,
// bh / bw [B, Hp/win, Wp/win, heads, win*win, win] bf16,
// out [B, Hp, Wp, C] bf16. head_dim 64 or 80. mode: MODE_WINDOW (K2),
// MODE_ROLLED or MODE_GBATCH (K10; G images a block, G must divide B).
int samroad_window_attention(const void* qkv, const void* qkv_bias, const void* bh,
                             const void* bw, void* out, int B, int Hp, int Wp,
                             int C, int heads, int win, int mode, int G, void* stream) {
  if (heads <= 0 || C % heads || win <= 0 || Hp % win || Wp % win || win * win > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (C / heads == 64)
    return window_modes<64>(qkv, qkv_bias, bh, bw, out, B, Hp, Wp, C, heads, win, mode, G, s);
  if (C / heads == 80)
    return window_modes<80>(qkv, qkv_bias, bh, bw, out, B, Hp, Wp, C, heads, win, mode, G, s);
  return (int)cudaErrorInvalidValue;
}

// K11: qkv [nW, win*win, 3C] bf16 (bias in), bh / bw [nW, heads, win*win,
// win] bf16 -> out [nW, win*win, C] bf16; G windows a block (G divides nW).
int samroad_window_attention_rows(const void* qkv, const void* bh, const void* bw, void* out,
                                  int nW, int C, int heads, int win, int G, void* stream) {
  const bf16* p = reinterpret_cast<const bf16*>(qkv);
  return launch_layout<false, BIAS_ROWS>(p, p + C, p + 2 * C, bh, bw, out, nW, C, heads, win, G,
                                         0.f, reinterpret_cast<cudaStream_t>(stream));
}

// K12: K11's qkv and out, the expanded tables rh / rw [win*win, win, hd] bf16.
int samroad_window_attention_relpos(const void* qkv, const void* rh, const void* rw, void* out,
                                    int nW, int C, int heads, int win, int G, void* stream) {
  const bf16* p = reinterpret_cast<const bf16*>(qkv);
  return launch_layout<false, BIAS_TABLE>(p, p + C, p + 2 * C, rh, rw, out, nW, C, heads, win,
                                          G, 0.f, reinterpret_cast<cudaStream_t>(stream));
}

// K13: q, k, v, out [nW, heads, win*win, hd] bf16, rh / rw as K12's.
int samroad_window_attention_relpos_batched(const void* q, const void* k, const void* v,
                                            const void* rh, const void* rw, void* out, int nW,
                                            int heads, int hd, int win, int G, void* stream) {
  return launch_layout<true, BIAS_TABLE>(q, k, v, rh, rw, out, nW, heads * hd, heads, win, G,
                                         0.f, reinterpret_cast<cudaStream_t>(stream));
}

// T4: q (pre-scaled), k, v, out [BH, win*win, hd] bf16, bias rows qh, qw
// [BH, win*win, win] bf16; scale 1; one (window, head) a block.
int samroad_sel_attention(const void* q, const void* k, const void* v, const void* qh,
                          const void* qw, void* out, int BH, int hd, int win, void* stream) {
  return launch_layout<true, BIAS_ROWS>(q, k, v, qh, qw, out, BH, hd, 1, win, 1, 1.0f,
                                        reinterpret_cast<cudaStream_t>(stream));
}

// T2 / T3: q, k [BH, win*win, dqk] bf16 (dqk a multiple of 4 up to 96), v,
// out [BH, win*win, 64] bf16; G (window, head) pairs a block (G divides BH).
int samroad_window_attn_folded(const void* q, const void* k, const void* v, void* out, int BH,
                               int dqk, int win, int G, void* stream) {
  if (dqk <= 0 || dqk > FOLD_DQK || dqk % 4 || win <= 0 || win * win > 256 || G <= 0 ||
      BH <= 0 || BH % G)
    return (int)cudaErrorInvalidValue;
  return (int)launch(folded_window_kernel, Layout(win * win, FOLD_DQK, FOLD_DV), BH / G,
                     reinterpret_cast<cudaStream_t>(stream), reinterpret_cast<const bf16*>(q),
                     reinterpret_cast<const bf16*>(k), reinterpret_cast<const bf16*>(v),
                     reinterpret_cast<bf16*>(out), dqk, win, G);
}

}  // extern "C"
