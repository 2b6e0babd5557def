// Global attention with decomposed relative-position bias rows: the CUDA
// kernel behind K3 (attention_relpos_rows) of
// sam_road_tpu_torch/ops/attention.py (and K6's attention_relpos_rows_d
// forward), and, as further modes of the same loop, K5 (fused_attention) of
// the same module, the tool kernels T1 (diag_attn) of
// sam_road_tpu_torch/tools/experiment_group_window.py and T5's global case
// (inker_attention) of sam_road_tpu_torch/tools/experiment_block_variants.py.
//
// K3 replaces sam_road_tpu/ops/attention.py::attention_relpos_rows
// (_relpos_rows_kernel), which holds all N x N scores of one (image, head)
// in VMEM (N = 1024 at 512 px: 4 MB fp32). A Hopper SM has 227 KB of shared
// memory, so this kernel tiles the keys with an online softmax (flash
// attention):
//   s = q.k^T + bh[n, m // W] + bw[n, m % W]       (q arrives pre-scaled)
//   running max / sum in fp32, bf16(p) . v accumulated in fp32, / sum
//
// What bounds it on the H100: operations. 4 N^2 hd per (image, head): 103
// GFLOP at the bench shape (384 (image, head) pairs x 1024 tokens), 0.104 ms
// at the bf16 tensor peak, against 0.5 MB of q/k/v a pair. Only Hopper's
// warpgroup product (wgmma) reaches that rate, so the loop is shaped like
// FlashAttention-3 without its warp specialisation:
// - One block per (image x head, 128-query tile): two warpgroups of 64
//   query rows, each warp 16 rows. A warp's q fragments are loaded once
//   (ldmatrix) and stay in registers: both products are wgmma's
//   register-A form (m64n64k16 for S = q.k^T, m64n{hd}k16 for p.v).
// - 64-key k / v tiles in a 3-stage cp.async ring: tile j + 2 is in flight
//   while tile j is multiplied. The tiles sit in shared memory in wgmma's
//   no-swizzle layout (8 x 8 core matrices of 128 contiguous bytes, filled
//   in order by consecutive threads), which takes head_dim 80's 160-byte
//   rows as it takes 64's: no 128-byte swizzle to fit. k is a K-major B
//   operand, v an MN-major (transposed) one, each behind a descriptor.
// - The online softmax lives in registers: the accumulator gives each quad
//   of lanes one row, so a row max or sum is two shuffles; the running max
//   m, sum l and rescale factor are per thread, the output is rescaled in
//   its accumulator, and p becomes bf16 A fragments in registers (wgmma's
//   C layout is its register-A layout). exp2 with log2(e) folded into the
//   fp32 scale and the bias. The output is divided by l and stored as bf16
//   pairs at the end.
// - The block's bias rows are staged once as fp32 in shared memory,
//   column-major ([Hg + Wg][128 + 4]: a quad's 8 rows and 4 columns fall
//   in 32 distinct banks); a score adds two shared-memory reads. With
//   Wg % 8 == 0 the 8 keys of an n8 tile share one grid row, so no score
//   pays a division (MODE_DIAG walks window, row and column by 8 keys a
//   tile).
// - Shared memory: q 18 KB, the ring 48 KB, the bias columns 33 KB at
//   head_dim 64 and a 32 x 32 grid (99 KB a block).
//
// Head dims: instantiated at 64 (ViT-B, vit_l) and 80 (vit_h: at 256 px its
// global blocks are N = 256 tokens, 16 x 16). The q tile's rows are hd + 8
// bf16 apart (an odd number of 16-byte chunks: conflict-free ldmatrix).
//
// T1 (MODE_DIAG) replaces tools/experiment_group_window.py::diag_attn
// (_diag_kernel): g windows of N tokens folded into the rows of one product,
// qkv [nG, g N, 3C] in the window layout, bias rows bhw [nG, heads, g N,
// 2 win] ([bh | bw], bf16). Per (group, head) every query meets every one of
// the g N keys, as the TPU kernel's one (g N) x (g N) product does:
//   s = q.k^T * scale + bh[n, (m % N) // win] + bw[n, (m % N) % win]
//   if the key's window differs from the query's: s = -1e30
// The cross-window scores are computed and masked, not skipped: what folding
// g windows into M costs is the tool's question. g N is no multiple of the
// tiles, so the last query and key tiles are ragged (rows past g N load as
// zeros, keys past it are -inf; a tile wholly past g N leaves m as it was).
// The online softmax rounds p to bf16 before it is normalised, where
// _diag_kernel normalises first: equal within bf16 rounding. Its masks are
// selects, and every warp reconverges (__syncwarp) before wgmma.fence: a
// first build with branches there gave wrong outputs on every row at every
// g on the card, as wgmma's .aligned forms need converged warps. Bound: its HBM
// bytes (385 MB at the tool's shapes, 0.115 ms) up to g = 2, its g-fold
// score work (34 g GFLOP) beyond.
//
// K5 (MODE_FOLDED) replaces sam_road_tpu/ops/attention.py::fused_attention
// (_flash_forward: the whole-N _flash_kernel and the kv-tiled
// _blocked_kernel): softmax(q~.k~^T).v over the folded
// q~ = [q scale, q.Rh, q.Rw] and k~ = [k, onehot(row), onehot(col)]
// (models/vit.py::fold_rel_pos_qk), every attention of the eager encoder.
// The contraction width D = head_dim + H + W is a template parameter DQK of
// its own beside the value width HD: instances (DQK, HD) = (96, 64) (ViT-B /
// vit_l 14 x 14 windows, D 92, and 16 x 16 global grids), (128, 64) (32 x 32),
// (192, 64) (64 x 64, the 1024 px config), (112, 80) (vit_h's windows, D
// 108, and 16 x 16 grid) and (64, 32) (vit_t's windows: head_dim 32, D 60).
// A D below DQK is zero-filled to it in shared memory. At HD 32 the p.v
// product is m64n32k16 and a v row is 64 bytes, four 16-byte chunks: the
// no-swizzle layout, the accumulator (16 floats a thread) and the stores
// take it as they take 64 and 80. q~ arrives scaled, so the scale is 1 and there are no bias rows.
// Rows of D 92 or 108 bf16 (184, 216 bytes) are 8-byte aligned only, which
// 16-byte cp.async cannot read: fold_rel_pos_qk pads q~ and k~ with zero
// columns to a multiple of 16 while it concatenates (zero columns add
// nothing to a score, and the concatenation writes the padded tensor in the
// same pass), so the kernel takes any D % 8 == 0 up to DQK and every copy
// stays 16 bytes. Windows are ragged (N = 196 = 3 x 64 + 4), with T1's
// select masks: keys past N are -inf, query rows past N load as zeros and
// are not stored. At DQK 192 the q fragments take 48 registers a thread
// beside 32 of S and 32 of O; the block holds q 51 KB, the k ring 72 KB and
// the v ring 24 KB (146 KB: one block an SM). Bound: operations at the
// global grids (2 N^2 (D + HD) a (image, head): 0.078 ms at 512 px, 0.209 at
// 1024 px), bytes at the windows (0.063 ms).
//
// T5's global case (MODE_TABLE) replaces
// tools/experiment_block_variants.py::inker_attention (make_inker_kernel)
// at N = 1024 tokens (a 32 x 32 grid): K3's function with the bias rows built
// in the kernel from the expanded tables rh [N, Hg, hd], rw [N, Wg, hd]
// (bf16), from the unscaled q in shared memory, never rounded:
//   bh[n, a] = sum_c q[n, c] rh[n, a, c],  bw[n, a] = sum_c q[n, c] rw[n, a, c]
// then K3's loop with s = q.k^T * scale + bh[n, m // Wg] + bw[n, m % Wg]. A
// block reads its 128 rows' 1 MB slice of the tables once, from L2 (they
// are shared by every image and head). The Pallas body normalises p before
// p.v; the online softmax divides after: equal within bf16 rounding. Bound
// at the tool's shapes (384 (image, head) pairs): 106 GFLOP, 0.107 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

using namespace samroad_mma;

namespace {

// the query tile (two warpgroups of 64 rows) and the k / v ring's depth
constexpr int BQ = 128, BKV = 64, STAGES = 3;
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr int SMEM_MAX = 232448;  // a block's dynamic shared memory on Hopper

enum Mode { MODE_RELPOS = 0, MODE_DIAG = 1, MODE_TABLE = 2, MODE_FOLDED = 3 };
constexpr int TABLE_W = 64;    // MODE_TABLE: bias-row floats per query row (Hg + Wg at most)
// the fp32 bias rows sit column-major, column c of row r at c * TAB_LD + r:
// a quad's 8 rows and 4 columns fall in 32 distinct banks
constexpr int TAB_LD = BQ + 4;

struct Args {
  const bf16 *q, *k, *v;     // MODE_DIAG: k = q + C, v = q + 2C (one qkv tensor)
  const bf16 *bh, *bw;       // MODE_DIAG: bh = bhw, bw unused; MODE_TABLE: rh, rw
  bf16* out;
  int N;                     // queries = keys per (image, head) or per group (g N)
  int Hg, Wg;                // K3, MODE_TABLE: the token grid; MODE_DIAG: tokens per window, win
  int C, heads;              // MODE_DIAG
  float scale;               // MODE_DIAG, MODE_TABLE
  int D;                     // MODE_FOLDED: q~ / k~ row length (<= DQK); else head_dim
};

// fp32 bias values per query row: [bh | bw]; none in MODE_FOLDED
template <int MODE>
__host__ __device__ int bias_width(const Args& a) {
  return MODE == MODE_DIAG ? 2 * a.Wg : MODE == MODE_FOLDED ? 0 : a.Hg + a.Wg;
}

// dynamic shared memory: q [BQ][DQK + 8], k [STAGES][BKV * DQK] and v
// [STAGES][BKV * HD] (bf16), then the fp32 bias columns [bias_width][TAB_LD]
template <int DQK, int HD, int MODE>
__host__ __device__ int smem_bytes(const Args& a) {
  return (BQ * (DQK + 8) + STAGES * BKV * (DQK + HD)) * (int)sizeof(bf16) +
         TAB_LD * bias_width<MODE>(a) * 4;
}

// rows [0, BQ) of the q tile, row-major W + 8 apart (for ldmatrix), by
// cp.async; rows from `valid` on and columns from `cols` on are zero-filled
template <int W>
__device__ __forceinline__ void load_q_tile(bf16* dst, const bf16* src, int64_t stride,
                                            int valid, int cols) {
  for (int e = threadIdx.x; e < BQ * (W / 8); e += THREADS) {
    const int r = e / (W / 8), c = (e % (W / 8)) * 8;
    const bool ok = r < valid && c < cols;
    cp_async<16>(dst + r * (W + 8) + c, ok ? src + r * stride + c : src, ok);
  }
}

// a 64-row k or v tile, W wide, in wgmma's no-swizzle layout: 16-byte chunk
// c of row r at element ((r / 8) (W / 8) + c) 64 + (r % 8) 8, so
// consecutive threads fill consecutive shared-memory chunks; rows from
// `valid` on and columns from `cols` on are zero-filled
template <int W>
__device__ __forceinline__ void load_kv_tile(bf16* dst, const bf16* src, int64_t stride,
                                             int valid, int cols = W) {
  for (int e = threadIdx.x; e < BKV * (W / 8); e += THREADS) {
    const int r = (e >> 3) / (W / 8) * 8 + (e & 7), c = (e >> 3) % (W / 8) * 8;
    const bool ok = r < valid && c < cols;
    cp_async<16>(dst + e * 8, ok ? src + r * stride + c : src, ok);
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

// MODE_DIAG: a key's place, window w, row i, column j, advanced by 8 keys
// at a time; rows wrap at I (MODE_DIAG's window side, else never).
struct KeyPos {
  int w, i, j;
  __device__ __forceinline__ void advance(int si, int sj, int I, int J) {
    j += sj;
    i += si;
    if (j >= J) {
      j -= J;
      ++i;
    }
    if (i >= I) {
      i -= I;
      ++w;
    }
  }
};

// DQK: the q / k width (head_dim but in MODE_FOLDED); HD: v's and the output's
template <int DQK, int HD, int MODE>
__global__ void __launch_bounds__(THREADS) relpos_attention_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = DQK + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  constexpr int KT = BKV * DQK, VT = BKV * HD;  // bf16 elements of a k, a v tile
  bf16* Ks = Qs + BQ * LD;  // [STAGES][KT]
  bf16* Vs = Ks + STAGES * KT;
  float* tab = reinterpret_cast<float*>(Vs + STAGES * VT);
  const int nb = bias_width<MODE>(a);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row of matrix lm
  const int64_t bhid = blockIdx.y;          // image x head, or group x head
  const int q0 = blockIdx.x * BQ;
  const int N = a.N;
  // token 0 of this (image, head) in q / k, v and out, and the token strides
  int64_t base, vbase, out_base, stride, vstride, out_stride;
  if constexpr (MODE == MODE_DIAG) {
    const int64_t grp = bhid / a.heads, head = bhid % a.heads;
    base = vbase = grp * N * 3 * a.C + head * HD;
    out_base = grp * N * a.C + head * HD;
    stride = vstride = 3 * a.C;
    out_stride = a.C;
  } else {
    base = bhid * N * (MODE == MODE_FOLDED ? a.D : HD);
    stride = MODE == MODE_FOLDED ? a.D : HD;
    vbase = out_base = bhid * N * HD;
    vstride = out_stride = HD;
  }
  // q / k columns to load: MODE_FOLDED's D (the rest of DQK is zero-filled);
  // the other modes' whole head, a constant
  const int D = MODE == MODE_FOLDED ? a.D : DQK;

  // the q tile, then the first STAGES - 1 k / v tiles, one group each
  load_q_tile<DQK>(Qs, a.q + base + q0 * stride, stride, N - q0, D);
  cp_async_commit();
  const int nt = (N + BKV - 1) / BKV;
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nt) {
      load_kv_tile<DQK>(Ks + t * KT, a.k + base + (int64_t)t * BKV * stride, stride,
                        N - t * BKV, D);
      load_kv_tile<HD>(Vs + t * VT, a.v + vbase + (int64_t)t * BKV * vstride, vstride,
                       N - t * BKV);
    }
    cp_async_commit();
  }
  // the bias rows of the block's queries, fp32; rows past N repeat the last
  if constexpr (MODE == MODE_RELPOS) {
    for (int e = tid; e < BQ * nb; e += THREADS) {
      const int r = e / nb, c = e % nb;
      const int64_t n = bhid * N + min(q0 + r, N - 1);
      tab[c * TAB_LD + r] =
          __bfloat162float(c < a.Hg ? a.bh[n * a.Hg + c] : a.bw[n * a.Wg + c - a.Hg]);
    }
  } else if constexpr (MODE == MODE_DIAG) {
    for (int e = tid; e < BQ * nb; e += THREADS) {
      const int r = e / nb, c = e % nb;
      const int64_t n = bhid * N + min(q0 + r, N - 1);
      tab[c * TAB_LD + r] = __bfloat162float(a.bh[n * nb + c]);
    }
  }
  cp_async_wait<STAGES - 1>();  // the q tile has landed
  __syncthreads();
  if constexpr (MODE == MODE_TABLE) {
    // tab[r][c] = q[r] . (c < Hg ? rh[n, c] : rw[n, c - Hg]), a dot a thread
    for (int e = tid; e < BQ * nb; e += THREADS) {
      const int r = e / nb, c = e % nb;
      const int64_t n = min(q0 + r, N - 1);
      tab[c * TAB_LD + r] = dot_bf16<HD>(Qs + r * LD,
                            c < a.Hg ? a.bh + (n * a.Hg + c) * HD : a.bw + (n * a.Wg + c - a.Hg) * HD);
    }
  }

  // this warp's q fragments (rows warp * 16 ..)
  uint32_t qa[DQK / 16][4];
#pragma unroll
  for (int c = 0; c < DQK / 16; ++c)
    ldmatrix_x4(qa[c], Qs + (warp * 16 + (lm & 1) * 8 + lr) * LD + c * 16 + (lm >> 1) * 8);

  const float sl2 = (MODE == MODE_RELPOS || MODE == MODE_FOLDED ? 1.f : a.scale) * LOG2E;
  const int rq[2] = {warp * 16 + g, warp * 16 + g + 8};  // this thread's two rows in the tile
  const int hoff = MODE == MODE_DIAG ? a.Wg : a.Hg;  // bw's offset in a bias row
  // MODE_DIAG: the query's window (rows past N: the last row's) and the
  // place of key 2tq, advanced 8 keys an n8 tile. Else Wg % 8 == 0: the 8
  // keys of n8 tile t' share grid row ki and start at column kjb.
  // MODE_FOLDED walks no grid (J is 1 there only to keep the divisions defined).
  const int Nw = a.Hg, I = a.Wg, J = MODE == MODE_FOLDED ? 1 : a.Wg;
  int qw[2] = {0, 0};
  KeyPos kp{0, (2 * tq) / J, (2 * tq) % J};
  if constexpr (MODE == MODE_DIAG) {
#pragma unroll
    for (int h = 0; h < 2; ++h) qw[h] = min(q0 + rq[h], N - 1) / Nw;
  }
  const int si = 8 / J, sj = 8 % J;
  int ki = 0, kjb = 0;

  float o[HD / 2];  // the warpgroup's p . v accumulator: n8 tile d at o[4d ..]
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // byte strides of core matrices: along K, and along N of k (ROW8K) and of v (ROW8)
  constexpr uint32_t CORE = 128, ROW8K = DQK / 8 * 128, ROW8 = HD / 8 * 128;

  for (int j = 0; j < nt; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j has landed
    fence_proxy_async();          // ... and is visible to wgmma
    __syncthreads();              // for every thread; tile j - 1's stage is consumed
    {
      const int jn = j + STAGES - 1;
      if (jn < nt) {
        const int st = jn % STAGES;
        load_kv_tile<DQK>(Ks + st * KT, a.k + base + (int64_t)jn * BKV * stride, stride,
                          N - jn * BKV, D);
        load_kv_tile<HD>(Vs + st * VT, a.v + vbase + (int64_t)jn * BKV * vstride, vstride,
                         N - jn * BKV);
      }
      cp_async_commit();
    }
    const bf16* Kt = Ks + (j % STAGES) * KT;
    const bf16* Vt = Vs + (j % STAGES) * VT;

    // S = q . k^T: k is B, K-major (d contiguous); step c takes d chunks 2c, 2c + 1
    float s[BKV / 2];  // n8 tile t at s[4t ..]
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    __syncwarp();  // wgmma.fence and wgmma are .aligned: the warp must be converged
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DQK / 16; ++c)
      wgmma_rs<BKV, 0>(s, qa[c], wgmma_desc(Kt + c * 2 * 64, CORE, ROW8K));
    wgmma_commit_and_wait();
    fence_regs(s);

    // bias and mask in the log2 domain
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < BKV / 8; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* row = tab + rq[h];  // column c at row[c * TAB_LD]
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = s[4 * t + 2 * h + e];
          if constexpr (MODE == MODE_DIAG) {  // selects, no branch: see __syncwarp below
            const int key = j * BKV + t * 8 + 2 * tq + e;
            KeyPos p = kp;
            if (e) p.advance(0, 1, I, J);
            const float sv =
                fmaf(v, sl2, (row[p.i * TAB_LD] + row[(hoff + p.j) * TAB_LD]) * LOG2E);
            v = key >= N ? -INFINITY         // past g N: not a key
                : p.w != qw[h] ? -1e30f      // another window's key
                : sv;
          } else if constexpr (MODE == MODE_FOLDED) {  // a select: keys past N are -inf
            const int key = j * BKV + t * 8 + 2 * tq + e;
            v = key >= N ? -INFINITY : v * sl2;
          } else {
            v = fmaf(v, sl2,
                     (row[ki * TAB_LD] + row[(hoff + kjb + 2 * tq + e) * TAB_LD]) * LOG2E);
          }
          mx[h] = fmaxf(mx[h], v);
        }
      }
      if constexpr (MODE == MODE_DIAG) {
        kp.advance(si, sj, I, J);
      } else if constexpr (MODE != MODE_FOLDED) {
        kjb += 8;
        if (kjb == J) {
          kjb = 0;
          ++ki;
        }
      }
    }

    // online softmax: new max, rescale, p
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      const float mu = mn == -INFINITY ? 0.f : mn;  // no key yet: keep -inf - -inf out
      alpha[h] = ex2(m[h] - mu);
      m[h] = mn;
      mx[h] = mu;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int t = 0; t < BKV / 8; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[4 * t + i] = ex2(s[4 * t + i] - mx[i >> 1]);
        l[i >> 1] += s[4 * t + i];
      }
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // p . v: p's A fragment of keys 16kk.. is C tiles 2kk (cols 2tq) and
    // 2kk + 1 (+8); v is B, MN-major (d contiguous), transposed
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(o);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs<HD, 1>(o, pa[kk], wgmma_desc(Vt + kk * 2 * (HD / 8) * 64, ROW8, CORE));
    wgmma_commit_and_wait();
    fence_regs(o);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int n = q0 + rq[h];
    if (n < N) {
      const float f = 1.f / l[h];
      bf16* dst = a.out + out_base + n * out_stride + 2 * tq;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<uint32_t*>(dst + d * 8) =
            pack_bf16(o[4 * d + 2 * h] * f, o[4 * d + 2 * h + 1] * f);
    }
  }
}

template <int DQK, int HD, int MODE>
int launch(const Args& a, int BH, cudaStream_t stream) {
  const int bytes = smem_bytes<DQK, HD, MODE>(a);
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(relpos_attention_kernel<DQK, HD, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + BQ - 1) / BQ, BH);
  relpos_attention_kernel<DQK, HD, MODE><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_hd(const Args& a, int hd, int BH, cudaStream_t stream) {
  if (hd == 64) return launch<64, 64, MODE>(a, BH, stream);
  if (hd == 80) return launch<80, 80, MODE>(a, BH, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (pre-scaled), k, v, out: [B*heads, N, hd] bf16, hd 64 or 80; bh
// [B*heads, N, Hg], bw [B*heads, N, Wg] bf16 with N == Hg * Wg,
// N % 64 == 0 and Wg % 8 == 0.
int samroad_relpos_attention(const void* q, const void* k, const void* v,
                             const void* bh, const void* bw, void* out, int BH,
                             int N, int Hg, int Wg, int hd, void* stream) {
  if (N != Hg * Wg || N % BKV || Wg % 8 || BH <= 0) return (int)cudaErrorInvalidValue;
  Args a{reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
         reinterpret_cast<const bf16*>(v), reinterpret_cast<const bf16*>(bh),
         reinterpret_cast<const bf16*>(bw), reinterpret_cast<bf16*>(out), N, Hg, Wg, 0, 0, 1.f,
         hd};
  return launch_hd<MODE_RELPOS>(a, hd, BH, reinterpret_cast<cudaStream_t>(stream));
}

// T1: qkv [nG, g*win*win, 3C] bf16 (g windows stacked), bhw [nG, heads,
// g*win*win, 2*win] bf16 -> out [nG, g*win*win, C] bf16; head_dim 64 or 80;
// scale 1 / sqrt(head_dim).
int samroad_diag_attention(const void* qkv, const void* bhw, void* out, int nG, int g, int C,
                           int heads, int win, void* stream) {
  if (nG <= 0 || g <= 0 || heads <= 0 || C % heads || win < 3) return (int)cudaErrorInvalidValue;
  const int hd = C / heads, Nw = win * win;
  const bf16* p = reinterpret_cast<const bf16*>(qkv);
  Args a{p, p + C, p + 2 * C, reinterpret_cast<const bf16*>(bhw), nullptr,
         reinterpret_cast<bf16*>(out), g * Nw, Nw, win, C, heads, 1.0f / sqrtf((float)hd), hd};
  return launch_hd<MODE_DIAG>(a, hd, nG * heads, reinterpret_cast<cudaStream_t>(stream));
}

// T5 global: q (unscaled), k, v, out [BH, N, hd] bf16, hd 64 or 80; rh
// [N, Hg, hd], rw [N, Wg, hd] bf16 (the expanded rel-pos tables) with
// N == Hg * Wg, N % 64 == 0, Wg % 8 == 0 and Hg + Wg <= 64; scale 1 / sqrt(hd).
int samroad_relpos_attention_table(const void* q, const void* k, const void* v,
                                   const void* rh, const void* rw, void* out, int BH, int N,
                                   int Hg, int Wg, int hd, void* stream) {
  if (N != Hg * Wg || N % BKV || Wg % 8 || Hg + Wg > TABLE_W || BH <= 0 || hd <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
         reinterpret_cast<const bf16*>(v), reinterpret_cast<const bf16*>(rh),
         reinterpret_cast<const bf16*>(rw), reinterpret_cast<bf16*>(out), N, Hg, Wg, 0, 0,
         1.0f / sqrtf((float)hd), hd};
  return launch_hd<MODE_TABLE>(a, hd, BH, reinterpret_cast<cudaStream_t>(stream));
}

// K5: q~ (scaled), k~ [BH, N, D] and v [BH, N, dv] -> out [BH, N, dv], bf16;
// (D, dv) within an instance: dv 64 with D <= 96, 128 or 192, dv 80 with
// D <= 112, dv 32 with D <= 64; D % 8 == 0 (16-byte rows). Any N.
int samroad_folded_attention(const void* q, const void* k, const void* v, void* out, int BH,
                             int N, int D, int dv, void* stream) {
  if (BH <= 0 || N <= 0 || D <= 0 || D % 8) return (int)cudaErrorInvalidValue;
  Args a{reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
         reinterpret_cast<const bf16*>(v), nullptr, nullptr, reinterpret_cast<bf16*>(out), N,
         0, 0, 0, 0, 1.f, D};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dv == 64 && D <= 96) return launch<96, 64, MODE_FOLDED>(a, BH, s);
  if (dv == 64 && D <= 128) return launch<128, 64, MODE_FOLDED>(a, BH, s);
  if (dv == 64 && D <= 192) return launch<192, 64, MODE_FOLDED>(a, BH, s);
  if (dv == 80 && D <= 112) return launch<112, 80, MODE_FOLDED>(a, BH, s);
  if (dv == 32 && D <= 64) return launch<64, 32, MODE_FOLDED>(a, BH, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
