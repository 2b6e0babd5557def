// Windowed multi-head attention with SAM's decomposed rel-pos bias: the CUDA
// kernels behind K2 / K10 (window_attention_rows_grid) and K11-K13
// (window_attention_rows, window_attention_relpos,
// window_attention_relpos_batched) of sam_road_tpu_torch/ops/fused_block.py,
// and the tools' T2 / T3 (experiment_window_attn.py), T4
// (experiment_relpos_kernel.py) and T5 on a window
// (experiment_block_variants.py) of sam_road_tpu_torch/tools.
//
// K2 replaces sam_road_tpu/ops/fused_block.py::window_attention_rows_grid at
// its default granularity (_window_attn_rows_grid_kernel + _win_attn_body).
// One block per (image, window, head). q, k and v are read with strides
// straight out of the bias-free qkv grid [B, Hp, Wp, 3C]; the qkv bias is
// added to every token of the window, so the window-padding tokens become
// exactly `bias` (SAM's zero pad after norm1). The output is written back in
// grid layout [B, Hp, Wp, C]: no partition or unpartition pass.
//   s = q.k^T * scale + bh[n, i'] + bw[n, j']     (fp32, key n' = (i', j'))
//   p = exp(s - max), l = sum p,  out = (bf16(p) . v) / l
//
// What bounds it on the H100: bytes. At the bench shape (3456 (window,
// head) pairs, head_dim 64) it moves 385 MB (0.115 ms at 3.35 TB/s) against
// 34 GFLOP (0.034 ms at the bf16 tensor peak), so mma.sync is enough and the
// work is in latency and shared-memory traffic. The design (FlashAttention-2
// style, but the whole 196-key row at once):
// - Register-resident attention. Each of a block's 4 warps owns 16-query
//   strips (196 tokens padded to Np = 208 rows, 13 strips). A strip's q
//   comes from global memory straight into mma A fragments (each q element
//   is read once, so shared memory would only add a trip). Its scores
//   against all Np keys stay in registers: 26 n8 tiles of
//   mma.sync.m16n8k16 (bf16 operands, fp32 accumulation), 104 floats a
//   thread. Scale, bias, the pad-key mask (keys 196..207 are exactly -inf),
//   row max and row sum are computed there; a row lives on one quad of
//   lanes, so each reduction is two shuffles. p becomes bf16 A fragments in
//   registers (the C layout of one product is the A layout of the next) and
//   p . v accumulates in registers, stored from them as bf16 pairs. As the
//   whole row is in registers before p is rounded, both orders keep their
//   meaning: NORM_FIRST rounds p / l, then p . v (K11-K13, T4, T5); else
//   p . v, then / l (K2, K10, T2 / T3).
// - exp2: log2(e) is folded into the fp32 scale and the bias, the same
//   arithmetic in every mode.
// - Shared memory holds this (window, head)'s k and v (rows D + 8 bf16
//   apart: an odd number of 16-byte chunks, so ldmatrix is conflict-free)
//   and its bias rows: bf16 [N, win] twice (BIAS_ROWS, copied as they are),
//   or fp32 [N, 2 win] built here (BIAS_TABLE). No score or probability
//   strip: at head_dim 64 a block takes 70 KB (80 KB at 80), so two to three
//   blocks (8-12 warps) stay resident on an SM, against one block of 4
//   warps and 172-216 KB before.
// - Loads are cp.async (16 bytes; 8 for T2 / T3's 184-byte q/k rows) with
//   zero-fill for the pad rows. A block that loops over items (MODE_ROLLED,
//   MODE_GBATCH, K11-K13's `group`, T3's G) keeps one shared-memory stage
//   and issues the next item's copies once the current item's products are
//   done: the two or three blocks resident on an SM hide each other's
//   loads, where a second stage to prefetch into would double a block's
//   shared memory and leave one block an SM.
//   K2's qkv bias is added in a pass over the landed k / v tiles (and to q
//   in registers).
//
// Structure: one per-item body (attend_strips, looped by attend_items) whose arithmetic
// order does not depend on the mode, so every mode that shares an instance
// gives bit-equal outputs (K10 = K2, K11-K13 at every group, T3 = T2).
//
// Head dims: every window kernel has instances at head_dim 64 (ViT-B,
// vit_l) and 80 (vit_h: 1280 / 16); T2 / T3 at q/k width 96 (92
// zero-padded) and v width 64. Windows up to 14 x 14 (SAM's): the score
// strip is sized for Np <= 208; a larger window is refused.
//
// K10: the rolled_rows / group_batch granularities of the same function
// (_window_attn_rows_grid_rolled_kernel, _window_attn_rows_grid_gbatch_kernel):
//   MODE_WINDOW  one block per (image, window, head)             (K2)
//   MODE_ROLLED  one block per (image, window row, head), looping over the
//                row's nJ windows
//   MODE_GBATCH  one block per (image group, window, head), looping over the
//                group's G images
//
// K11-K13 differ from K2 in where the tokens live, where the bias rows come
// from and when p is normalised (their HBM bound is 0.10-0.12 ms at nW = 288
// windows of 196 tokens, C = 768, 12 heads):
//   K11 window_attention_rows (replaces fused_block.py::window_attention_rows,
//       _window_attn_rows_kernel): qkv [nW, N, 3C] with the bias already in,
//       bias rows [nW, H, N, win] bf16, output [nW, N, C];
//   K12 window_attention_relpos (replaces fused_block.py::
//       window_attention_relpos, _window_attn_kernel): K11's layout, the bias
//       rows built in the kernel from the expanded tables rh, rw [N, win, hd]:
//       bh[n, a] = sum_c q[n, c] rh[n, a, c] in fp32, never rounded;
//   K13 window_attention_relpos_batched (replaces fused_block.py::
//       window_attention_relpos_batched, _window_attn_batched_kernel): K12's
//       function on head-split q, k, v [nW, H, N, hd]. The TPU pads 196
//       tokens to 256 with -1e30 keys; those contribute exactly 0, as the
//       -inf pad keys here do, so no padded copy is made.
// `group` windows a block, looping, gives bit-equal outputs.
//
// The tools' kernels, two more modes of the same body:
//   T2 / T3 (replace tools/experiment_window_attn.py::pallas1 / pallasG,
//       kern1 / kernG): softmax(q.k^T) v over q, k [BH, N, 92] (the rel-pos
//       folded into the contraction) and v [BH, N, 64], no bias, no scale,
//       the division after p.v. G (window, head) pairs a block (T3) loop.
//   T4 (replaces tools/experiment_relpos_kernel.py::sel_attention,
//       sel_kernel): K13's head-split addressing with K11's bias rows, p
//       normalised first, scale 1 (q arrives pre-scaled).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

using namespace samroad_mma;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int NP_MAX = 208;       // 14 x 14 tokens padded to 13 strips of 16
constexpr int KT = NP_MAX / 8;    // n8 key tiles of a strip's scores
constexpr size_t SMEM_MAX = 232448;  // a block's dynamic shared memory on Hopper
constexpr int FOLD_DQK = 96;      // T2 / T3: the folded q/k width, padded in shared memory
constexpr int FOLD_DV = 64;       // T2 / T3: the value width

enum Bias { BIAS_NONE = 0, BIAS_ROWS = 1, BIAS_TABLE = 2 };
enum Mode { MODE_WINDOW = 0, MODE_ROLLED = 1, MODE_GBATCH = 2 };

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) & ~(size_t)127; }

// Dynamic shared memory, byte offsets: k [np][dqk + 8] at 0, v [np][dv + 8],
// the bias rows bf16 [2][N * win] (BIAS_ROWS), the fp32 bias table
// [N][2 win] (BIAS_TABLE).
struct Layout {
  int np;
  size_t v, rows, table, total;
  __host__ __device__ Layout(int N, int win, int dqk, int dv, int bias) {
    np = (N + 15) & ~15;
    v = align128((size_t)np * (dqk + 8) * sizeof(bf16));
    rows = v + align128((size_t)np * (dv + 8) * sizeof(bf16));
    table = rows + (bias == BIAS_ROWS ? align128((size_t)2 * N * win * sizeof(bf16)) : 0);
    total = table + (bias == BIAS_TABLE ? align128((size_t)N * 2 * win * sizeof(float)) : 0);
  }
};

// Where one (window, head)'s tokens, bias rows and output live. Token
// n = (i, j) of the window sits at element i * row + j * col from q / k
// (in_*), v (v_*) and out (out_*), channel 0 of this head.
struct Tile {
  const bf16 *q, *k, *v;
  bf16* out;
  int64_t in_row, in_col, v_row, v_col, out_row, out_col;
  const bf16 *bh, *bw;    // bias rows [N, win] (K2, K11, T4), expanded tables [N, win, hd]
                          // (K12, K13), or null
  const bf16* qkv_bias;   // this head's q bias, k's at +C and v's at +2C (K2), or null
  int C;
  int dqk;                // the q/k width in memory (T2 / T3: a multiple of 4 up to FOLD_DQK)
};

// Issue the cp.async copies of one item's k, v (rows N..np-1 and q/k
// columns from t.dqk on zero-filled) and BIAS_ROWS' bias rows into `smem`.
template <int DQK, int DV, int BIAS>
__device__ __forceinline__ void issue_loads(const Tile& t, unsigned char* smem, const Layout& L,
                                            int N, int win) {
  constexpr int VK = DQK == DV ? 8 : 4;  // bf16 a copy: T2 / T3's q/k rows are 8-byte aligned
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  for (int e = threadIdx.x; e < L.np * (DQK / VK); e += THREADS) {
    const int n = e / (DQK / VK), c = (e % (DQK / VK)) * VK;
    const bool ok = n < N && c < t.dqk;
    const bf16* src = ok ? t.k + (n / win) * t.in_row + (n % win) * t.in_col + c : t.k;
    cp_async<VK * 2>(Ks + n * (DQK + 8) + c, src, ok);
  }
  for (int e = threadIdx.x; e < L.np * (DV / 8); e += THREADS) {
    const int n = e / (DV / 8), c = (e % (DV / 8)) * 8;
    const bool ok = n < N;
    const bf16* src = ok ? t.v + (n / win) * t.v_row + (n % win) * t.v_col + c : t.v;
    cp_async<16>(Vs + n * (DV + 8) + c, src, ok);
  }
  if constexpr (BIAS == BIAS_ROWS) {
    bf16* rows = reinterpret_cast<bf16*>(smem + L.rows);
    const int count = N * win;
    if ((((uintptr_t)t.bh | (uintptr_t)t.bw) & 15) == 0 && count % 8 == 0) {
      for (int e = threadIdx.x; e < count / 4; e += THREADS) {  // 16 bytes a copy, bh then bw
        const int half = e / (count / 8), c = (e % (count / 8)) * 8;
        cp_async<16>(rows + half * count + c, (half ? t.bw : t.bh) + c, true);
      }
    } else {  // an odd window: rows not 16-byte aligned, plain loads
      for (int e = threadIdx.x; e < 2 * count; e += THREADS)
        rows[e] = e < count ? t.bh[e] : t.bw[e - count];
    }
  }
}

// A fragments of q rows n0 = r0 + g and n1 = n0 + 8 over all DQK columns,
// from global memory; rows past N and columns from t.dqk on are zero, K2's
// qkv bias is added (fp32 sum rounded to bf16, as on the k / v tiles).
template <int DQK>
__device__ __forceinline__ void load_q(uint32_t (&qa)[DQK / 16][4], const Tile& t, int n0, int N,
                                       int win, int tq) {
  const bf16* rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + 8 * h;
    rows[h] = n < N ? t.q + (n / win) * t.in_row + (n % win) * t.in_col : nullptr;
  }
#pragma unroll
  for (int c = 0; c < DQK / 16; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // reg r: row n0 + 8 (r & 1), columns + 8 (r >> 1)
      const int col = c * 16 + (r >> 1) * 8 + 2 * tq;
      const bf16* p = rows[r & 1];
      uint32_t u = 0u;
      if (p != nullptr && col < t.dqk) {
        u = *reinterpret_cast<const uint32_t*>(p + col);
        if (t.qkv_bias) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
          const float2 y =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t.qkv_bias + col));
          u = pack_bf16(x.x + y.x, x.y + y.y);
        }
      }
      qa[c][r] = u;
    }
  }
}

// K2: the qkv bias added to the landed k and v rows of the real tokens.
template <int D>
__device__ __forceinline__ void add_kv_bias(const Tile& t, unsigned char* smem, const Layout& L,
                                            int N) {
  for (int e = threadIdx.x; e < 2 * N * (D / 8); e += THREADS) {
    const int which = e / (N * (D / 8)), rem = e % (N * (D / 8));  // k, then v
    const int n = rem / (D / 8), c = (rem % (D / 8)) * 8;
    uint4* dst = reinterpret_cast<uint4*>(smem + which * L.v) + (n * (D + 8) + c) / 8;
    uint4 u = *dst;
    const uint4 bu = *reinterpret_cast<const uint4*>(t.qkv_bias + (which + 1) * t.C + c);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
    const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&bu);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]), y = __bfloat1622float2(hb[i]);
      h[i] = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
    }
    *dst = u;
  }
}

// sum_c a[c] b[c] over D bf16 values (16-byte aligned rows), in fp32
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

// K12 / K13: table[n][a] = q[n] . rh[n, a] (a < win), q[n] . rw[n, a - win]
// (a >= win), fp32, a dot a thread, q from global memory.
template <int D>
__device__ __forceinline__ void build_table(const Tile& t, float* table, int N, int win) {
  for (int e = threadIdx.x; e < N * 2 * win; e += THREADS) {
    const int n = e / (2 * win), a = e % (2 * win);
    table[e] = dot_bf16<D>(t.q + (n / win) * t.in_row + (n % win) * t.in_col,
                           a < win ? t.bh + ((int64_t)n * win + a) * D
                                   : t.bw + ((int64_t)n * win + a - win) * D);
  }
}

// The 16-query strips of one item, each warp its own: scores in registers,
// softmax, p . v, output. sl2 = scale * log2(e).
template <int DQK, int DV, int BIAS, bool NORM_FIRST>
__device__ __forceinline__ void attend_strips(const Tile& t, const unsigned char* smem,
                                              const float* table, const Layout& L, int N, int win,
                                              float sl2) {
  constexpr int LDK = DQK + 8, LDV = DV + 8;
  const bf16* Ks = reinterpret_cast<const bf16*>(smem);
  const bf16* Vs = reinterpret_cast<const bf16*>(smem + L.v);
  const bf16* bh_s = reinterpret_cast<const bf16*>(smem + L.rows);
  const bf16* bw_s = bh_s + N * win;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row of matrix lm
  const int nkt = L.np / 8;
  const int si = 8 / win, sj = 8 % win;  // key + 8 in window coordinates

  for (int strip = warp; strip < L.np / 16; strip += WARPS) {
    const int r0 = strip * 16;
    uint32_t qa[DQK / 16][4];
    load_q<DQK>(qa, t, r0 + g, N, win, tq);

    float s[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < KT; j += 2) {
      if (j < nkt) {
#pragma unroll
        for (int c = 0; c < DQK / 16; ++c) {
          uint32_t b[4];  // keys 8j.. (cols c*16, +8), then keys 8(j+1).. (the same)
          ldmatrix_x4(b, Ks + ((j + (lm >> 1)) * 8 + lr) * LDK + c * 16 + (lm & 1) * 8);
          mma_bf16(s[j], qa[c], b[0], b[1]);
          mma_bf16(s[j + 1], qa[c], b[2], b[3]);
        }
      }
    }

    // scale, bias, pad-key mask in the log2 domain; the bias row of a pad
    // query row (discarded) is the last real one
    const int nq[2] = {min(r0 + g, N - 1), min(r0 + g + 8, N - 1)};
    int ki = (2 * tq) / win, kj = (2 * tq) % win;  // key 8j + 2tq as (i', j')
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j < nkt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j * 8 + 2 * tq + e;
          int ei = ki, ej = kj + e;
          if (ej >= win) {
            ej -= win;
            ++ei;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = -INFINITY;
            if (key < N) {
              float b = 0.f;
              if constexpr (BIAS == BIAS_ROWS)
                b = __bfloat162float(bh_s[nq[h] * win + ei]) +
                    __bfloat162float(bw_s[nq[h] * win + ej]);
              else if constexpr (BIAS == BIAS_TABLE)
                b = table[nq[h] * 2 * win + ei] + table[nq[h] * 2 * win + win + ej];
              v = fmaf(s[j][2 * h + e], sl2, b * LOG2E);
            }
            s[j][2 * h + e] = v;
            mx[h] = fmaxf(mx[h], v);
          }
        }
        kj += sj;
        ki += si;
        if (kj >= win) {
          kj -= win;
          ++ki;
        }
      }
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j < nkt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = ex2(s[j][i] - mx[i >> 1]);
          l[i >> 1] += s[j][i];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    const float inv[2] = {1.f / l[0], 1.f / l[1]};

    // p as bf16 A fragments: keys 16kk.. are C tiles 2kk (cols 2tq) and 2kk + 1 (+8)
    uint32_t pa[KT / 2][4];
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk) {
      const float f0 = NORM_FIRST ? inv[0] : 1.f, f1 = NORM_FIRST ? inv[1] : 1.f;
      pa[kk][0] = pack_bf16(s[2 * kk][0] * f0, s[2 * kk][1] * f0);
      pa[kk][1] = pack_bf16(s[2 * kk][2] * f1, s[2 * kk][3] * f1);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0] * f0, s[2 * kk + 1][1] * f0);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2] * f1, s[2 * kk + 1][3] * f1);
    }

    float o[DV / 8][4];
#pragma unroll
    for (int d = 0; d < DV / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk) {
      if (2 * kk < nkt) {
#pragma unroll
        for (int d = 0; d < DV / 16; ++d) {
          uint32_t b[4];  // v rows 16kk.. (+8) at cols 16d, then at cols 16d + 8
          ldmatrix_x4_trans(b, Vs + (kk * 16 + (lm & 1) * 8 + lr) * LDV + d * 16 + (lm >> 1) * 8);
          mma_bf16(o[2 * d], pa[kk], b[0], b[1]);
          mma_bf16(o[2 * d + 1], pa[kk], b[2], b[3]);
        }
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = r0 + g + 8 * h;
      if (n < N) {
        const float f = NORM_FIRST ? 1.f : inv[h];
        bf16* dst = t.out + (n / win) * t.out_row + (n % win) * t.out_col + 2 * tq;
#pragma unroll
        for (int d = 0; d < DV / 8; ++d)
          *reinterpret_cast<uint32_t*>(dst + d * 8) =
              pack_bf16(o[d][2 * h] * f, o[d][2 * h + 1] * f);
      }
    }
  }
}

// The block's `count` items in turn (item(i) gives item i's Tile), through
// one shared-memory stage: the next item's copies are issued once the
// current item's products are done. The arithmetic of an item does not
// depend on count.
template <int DQK, int DV, int BIAS, bool NORM_FIRST, class Items>
__device__ __forceinline__ void attend_items(const Items& item, int count, unsigned char* smem,
                                             int N, int win, float scale) {
  const Layout L(N, win, DQK, DV, BIAS);
  float* table = reinterpret_cast<float*>(smem + L.table);
  const float sl2 = scale * LOG2E;
  issue_loads<DQK, DV, BIAS>(item(0), smem, L, N, win);
  cp_async_commit();
  for (int i = 0; i < count; ++i) {
    const Tile t = item(i);
    cp_async_wait<0>();
    __syncthreads();  // this item's copies (and plain bias-row stores) are visible
    if (t.qkv_bias != nullptr || BIAS == BIAS_TABLE) {
      if constexpr (BIAS == BIAS_TABLE)
        build_table<DQK>(t, table, N, win);
      else if constexpr (DQK == DV)
        add_kv_bias<DQK>(t, smem, L, N);
      __syncthreads();
    }
    attend_strips<DQK, DV, BIAS, NORM_FIRST>(t, smem, table, L, N, win, sl2);
    if (i + 1 < count) {
      __syncthreads();  // the tiles and the table are consumed
      issue_loads<DQK, DV, BIAS>(item(i + 1), smem, L, N, win);
      cp_async_commit();
    }
  }
}

// K2 / K10: image b, window (wi, wj), head of the padded grid.
template <int HD>
struct GridItems {
  const bf16 *qkv, *qkv_bias, *bh, *bw;
  bf16* out;
  int Hp, Wp, C, heads, win, head;
  int b0, db, wi, wj0, dwj;  // item i: image b0 + i db, window (wi, wj0 + i dwj)
  __device__ Tile operator()(int i) const {
    const int b = b0 + i * db, wj = wj0 + i * dwj;
    const int N = win * win, nI = Hp / win, nJ = Wp / win;
    const int64_t row0 = ((int64_t)b * Hp + wi * win) * Wp + wj * win;  // token (0, 0)
    const int64_t rows = ((((int64_t)b * nI + wi) * nJ + wj) * heads + head) * N * win;
    Tile t;
    t.q = qkv + row0 * 3 * C + head * HD;
    t.k = t.q + C;
    t.v = t.q + 2 * C;
    t.out = out + row0 * C + head * HD;
    t.in_row = t.v_row = (int64_t)Wp * 3 * C;
    t.in_col = t.v_col = 3 * C;
    t.out_row = (int64_t)Wp * C;
    t.out_col = C;
    t.bh = bh + rows;
    t.bw = bw + rows;
    t.qkv_bias = qkv_bias + head * HD;
    t.C = C;
    t.dqk = HD;
    return t;
  }
};

template <int MODE, int HD>
__global__ void __launch_bounds__(THREADS)
window_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qkv_bias,
                        const bf16* __restrict__ bh, const bf16* __restrict__ bw,
                        bf16* __restrict__ out, int Hp, int Wp, int C, int heads,
                        int win, int G, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nI = Hp / win, nJ = Wp / win;
  int idx = blockIdx.x;
  GridItems<HD> items{qkv, qkv_bias, bh, bw, out, Hp, Wp, C, heads, win, idx % heads};
  idx /= heads;
  int count = 1;
  if constexpr (MODE == MODE_ROLLED) {  // the row's nJ windows
    items.wi = idx % nI;
    items.b0 = idx / nI;
    items.db = 0;
    items.wj0 = 0;
    items.dwj = 1;
    count = nJ;
  } else {
    items.wj0 = idx % nJ;
    idx /= nJ;
    items.wi = idx % nI;
    items.dwj = 0;
    const int g = MODE == MODE_GBATCH ? G : 1;  // the group's G images
    items.b0 = idx / nI * g;
    items.db = 1;
    count = g;
  }
  attend_items<HD, HD, BIAS_ROWS, false>(items, count, smem, win * win, win, scale);
}

// K11 (BIAS_ROWS), K12 (BIAS_TABLE) on the window layout, K13 (HEADSPLIT,
// BIAS_TABLE) and T4 (HEADSPLIT, BIAS_ROWS, one head) on head-split tensors.
template <bool HEADSPLIT, int BIAS, int HD>
struct LayoutItems {
  const bf16 *q, *k, *v, *bh, *bw;
  bf16* out;
  int C, heads, win, head;
  int64_t w0;
  __device__ Tile operator()(int i) const {
    const int N = win * win;
    const int64_t w = w0 + i;
    // token (0, 0) of this (window, head); q, k and v are the three thirds
    // of one qkv row (window layout) or three tensors (head-split)
    const int64_t in0 = HEADSPLIT ? (w * heads + head) * N * HD : w * N * 3 * C + head * HD;
    Tile t;
    t.q = q + in0;
    t.k = k + in0;
    t.v = v + in0;
    t.out = out + (HEADSPLIT ? in0 : w * N * C + head * HD);
    t.in_col = t.v_col = HEADSPLIT ? HD : 3 * C;
    t.out_col = HEADSPLIT ? HD : C;
    t.in_row = t.v_row = win * t.in_col;
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
    t.dqk = HD;
    return t;
  }
};

// one block per (group of G windows, head), looping over the group (two
// blocks an SM asked for: ptxas's own choice of 168 registers spilled here)
template <bool HEADSPLIT, int BIAS, int HD>
__global__ void __launch_bounds__(THREADS, 2)
window_layout_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ bh,
                     const bf16* __restrict__ bw, bf16* __restrict__ out, int C, int heads,
                     int win, int G, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutItems<HEADSPLIT, BIAS, HD> items{q, k, v, bh, bw, out, C, heads, win,
                                               (int)(blockIdx.x % heads),
                                               (int64_t)(blockIdx.x / heads) * G};
  attend_items<HD, HD, BIAS, true>(items, G, smem, win * win, win, scale);
}

// T2 / T3: G (window, head) pairs a block; q, k [BH, N, dqk], v and out
// [BH, N, FOLD_DV].
struct FoldedItems {
  const bf16 *q, *k, *v;
  bf16* out;
  int dqk, win;
  int64_t w0;
  __device__ Tile operator()(int i) const {
    const int N = win * win;
    const int64_t w = w0 + i;
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
    return t;
  }
};

__global__ void __launch_bounds__(THREADS)
folded_window_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int dqk, int win,
                     int G) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FoldedItems items{q, k, v, out, dqk, win, (int64_t)blockIdx.x * G};
  attend_items<FOLD_DQK, FOLD_DV, BIAS_NONE, false>(items, G, smem, win * win, win, 1.0f);
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

bool window_ok(int win) { return win > 0 && ((win * win + 15) & ~15) <= NP_MAX; }

template <int MODE, int HD>
cudaError_t launch_window(const void* qkv, const void* qkv_bias, const void* bh,
                          const void* bw, void* out, int blocks, int Hp, int Wp, int C,
                          int heads, int win, int G, cudaStream_t stream) {
  return launch(window_attention_kernel<MODE, HD>, Layout(win * win, win, HD, HD, BIAS_ROWS),
                blocks, stream, reinterpret_cast<const bf16*>(qkv),
                reinterpret_cast<const bf16*>(qkv_bias),
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
                     Layout(win * win, win, HD, HD, BIAS), nW / G * heads, stream,
                     reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
                     reinterpret_cast<const bf16*>(v), reinterpret_cast<const bf16*>(bh),
                     reinterpret_cast<const bf16*>(bw), reinterpret_cast<bf16*>(out), C, heads,
                     win, G, scale);
}

// scale <= 0: 1 / sqrt(head_dim)
template <bool HEADSPLIT, int BIAS>
int launch_layout(const void* q, const void* k, const void* v, const void* bh, const void* bw,
                  void* out, int nW, int C, int heads, int win, int G, float scale,
                  cudaStream_t stream) {
  if (heads <= 0 || C % heads || !window_ok(win) || G <= 0 || nW <= 0 || nW % G)
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
// out [B, Hp, Wp, C] bf16. head_dim 64 or 80, win <= 14. mode: MODE_WINDOW
// (K2), MODE_ROLLED or MODE_GBATCH (K10; G images a block, G must divide B).
int samroad_window_attention(const void* qkv, const void* qkv_bias, const void* bh,
                             const void* bw, void* out, int B, int Hp, int Wp,
                             int C, int heads, int win, int mode, int G, void* stream) {
  if (heads <= 0 || C % heads || !window_ok(win) || Hp % win || Wp % win)
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
  if (dqk <= 0 || dqk > FOLD_DQK || dqk % 4 || !window_ok(win) || G <= 0 || BH <= 0 || BH % G)
    return (int)cudaErrorInvalidValue;
  return (int)launch(folded_window_kernel,
                     Layout(win * win, win, FOLD_DQK, FOLD_DV, BIAS_NONE), BH / G,
                     reinterpret_cast<cudaStream_t>(stream), reinterpret_cast<const bf16*>(q),
                     reinterpret_cast<const bf16*>(k), reinterpret_cast<const bf16*>(v),
                     reinterpret_cast<bf16*>(out), dqk, win, G);
}

}  // extern "C"
