// Global attention with decomposed relative-position bias rows: the CUDA
// kernel behind K3 (attention_relpos_rows) of
// sam_road_tpu_torch/ops/attention.py, and, as further modes of the same
// loop, the tool kernels T1 (diag_attn) of
// sam_road_tpu_torch/tools/experiment_group_window.py and T5's global case
// (inker_attention) of sam_road_tpu_torch/tools/experiment_block_variants.py.
//
// K3 replaces sam_road_tpu/ops/attention.py::attention_relpos_rows
// (_relpos_rows_kernel). The Pallas kernel holds all N x N scores of one
// (image, head) in VMEM (N = 1024 at 512 px: 4 MB fp32); a Hopper SM has
// 227 KB of shared memory, so this kernel tiles the keys and keeps an
// online softmax instead (flash attention): one block per (image x head,
// 64-query tile), 4 warps of 16 query rows, 64-key tiles of k and v in
// shared memory.
//   s = q.k^T + bh[n, m // W] + bw[n, m % W]       (q arrives pre-scaled)
//   running max / sum in fp32, bf16(p) . v accumulated in fp32, / sum
// What bounds it on the H100: 2 x N^2 x 64 x 2 FLOP per (image, head) =
// 268 MFLOP against 0.5 MB of q/k/v: compute, at the rate this simple wmma
// (mma.sync) version reaches; the per-tile fp32 rescale of the output
// through shared memory is its main overhead, to remove in a later PR.
// The online tiling also works past the TPU's 1225-token VMEM limit, so
// the fused encoder runs the 1024 px config's 4096-token grid here too (not
// measured yet), where the JAX package switches to K5.
//
// Head dims: instantiated at 64 (ViT-B, vit_l) and 80 (vit_h: at 256 px its
// global blocks are N = 256 tokens, 16 x 16); the tiles' row strides follow
// the head dim, the score and probability tiles the 64-key tile.
//
// T1 (MODE_DIAG) replaces tools/experiment_group_window.py::diag_attn
// (_diag_kernel): g windows of N tokens folded into the rows of one product,
// qkv [nG, g N, 3C] in the window layout (the stacking is a reshape done
// outside), bias rows bhw [nG, heads, g N, 2 win] ([bh | bw], bf16). Per
// (group, head) every query meets every one of the g N keys, as the TPU
// kernel's one (g N) x (g N) product does:
//   s = q.k^T * scale + bh[n, (m % N) // win] + bw[n, (m % N) % win]
//   if the key's window differs from the query's: s = -1e30
// then fp32 softmax and p.v. The cross-window scores are computed and
// masked, not skipped: what folding g windows into M costs is the tool's
// question. g N is no multiple of 64, so the last query and key tiles are
// ragged (rows past g N load as zeros, keys past it are -inf). The online
// softmax rounds p to bf16 before it is normalised, where _diag_kernel
// normalises first: equal within bf16 rounding. Bound: its HBM bytes (385 MB
// at the tool's shapes, 0.115 ms) up to g = 2, its g-fold score work (34 g
// GFLOP) beyond.
//
// T5's global case (MODE_TABLE) replaces
// tools/experiment_block_variants.py::inker_attention (make_inker_kernel)
// at N = 1024 tokens (a 32 x 32 grid): K3's function with the bias rows built
// in the kernel from the expanded tables rh [N, Hg, hd], rw [N, Wg, hd]
// (bf16). Each warp first builds its 16 query rows' bias rows in fp32 into
// shared memory after the block's other buffers (16 x (Hg + Wg) floats a
// warp, 4 KB at a 32 x 32 grid):
//   bh[n, a] = sum_c q[n, c] rh[n, a, c],  bw[n, a] = sum_c q[n, c] rw[n, a, c]
// from the unscaled q, never rounded; then K3's loop with
//   s = q.k^T * scale + bh[n, m // Wg] + bw[n, m % Wg]
// (q arrives unscaled; the scale is a post-product fp32 multiply, as
// MODE_DIAG's). The tables are 4 MiB each at N 1024; a block reads its 64
// rows' 256 KB slice of each once, from L2 (they are shared by every image
// and head). The Pallas body normalises p before p.v; the online softmax
// divides after: equal within bf16 rounding, as T1's. Bound at the tool's
// shapes (384 (image, head) pairs): 106 GFLOP, 0.107 ms of operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64, BKV = 64;
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr int LDP = BKV + 8;   // bf16 probability row stride

enum Mode { MODE_RELPOS = 0, MODE_DIAG = 1, MODE_TABLE = 2 };
constexpr int TABLE_W = 64;    // MODE_TABLE: bias-row floats per query row (Hg + Wg at most)

template <int HD>
struct Smem {
  static constexpr int LDT = HD + 8;                     // bf16 tile row stride
  static constexpr int LDF = (HD > BKV ? HD : BKV) + 4;  // fp32 rows: BKV scores, then HD outputs
  struct Warp {
    float S[16][LDF];          // scores, then the (p . v) of one tile
    float O[16][LDF];          // running output
    bf16 P[16][LDP];           // probabilities of one tile
    float m[16], l[16], alpha[16];
  };
  static_assert(sizeof(Warp) % 32 == 0 && (3 * BQ * LDT * sizeof(bf16)) % 32 == 0,
                "wmma tiles need 32-byte alignment");
  bf16 Q[BQ][LDT];
  bf16 K[BKV][LDT];
  bf16 V[BKV][LDT];
  Warp w[WARPS];
};

struct Args {
  const bf16 *q, *k, *v;     // MODE_DIAG: k = q + C, v = q + 2C (one qkv tensor)
  const bf16 *bh, *bw;       // MODE_DIAG: bh = bhw, bw unused; MODE_TABLE: rh, rw
  bf16* out;
  int N;                     // queries = keys per (image, head) or per group (g N)
  int Hg, Wg;                // K3, MODE_TABLE: the token grid; MODE_DIAG: tokens per window, win
  int C, heads;              // MODE_DIAG
  float scale;               // MODE_DIAG, MODE_TABLE
};

// rows [0, 64) of a tile, `stride` elements apart; rows from `valid` on are zero
template <int HD>
__device__ __forceinline__ void load_tile(bf16 (*dst)[Smem<HD>::LDT], const bf16* src,
                                          int64_t stride, int valid, int tid) {
  for (int e = tid; e < 64 * (HD / 8); e += THREADS) {
    const int r = e / (HD / 8), c = (e % (HD / 8)) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) u = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = u;
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

// dynamic shared memory of one block: Smem<HD>, then MODE_TABLE's bias rows
template <int HD, int MODE>
constexpr int smem_bytes() {
  return (int)sizeof(Smem<HD>) + (MODE == MODE_TABLE ? WARPS * 16 * TABLE_W * 4 : 0);
}

template <int HD, int MODE>
__global__ void __launch_bounds__(THREADS) relpos_attention_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using Sm = Smem<HD>;
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  typename Sm::Warp& ws = sm.w[threadIdx.x >> 5];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t bhid = blockIdx.y;          // image x head, or group x head
  const int q0 = blockIdx.x * BQ;
  const int N = a.N;
  // token 0 of this (image, head) in q / k / v / out, and the token stride
  int64_t base, out_base, stride, out_stride;
  if constexpr (MODE == MODE_DIAG) {
    const int64_t grp = bhid / a.heads, head = bhid % a.heads;
    base = grp * N * 3 * a.C + head * HD;
    out_base = grp * N * a.C + head * HD;
    stride = 3 * a.C;
    out_stride = a.C;
  } else {
    base = out_base = bhid * N * HD;
    stride = out_stride = HD;
  }

  load_tile<HD>(sm.Q, a.q + base + q0 * stride, stride, N - q0, tid);
  for (int e = lane; e < 16 * HD; e += 32) ws.O[e / HD][e % HD] = 0.f;
  // MODE_TABLE: this warp's bias rows [16][Hg + Wg], fp32, one (row, a) a lane
  float(*tab)[TABLE_W] =
      reinterpret_cast<float(*)[TABLE_W]>(smem_raw + sizeof(Sm)) + warp * 16;
  if constexpr (MODE == MODE_TABLE) {
    __syncthreads();  // the q tile is in
    const int nb = a.Hg + a.Wg;
    for (int e = lane; e < 16 * nb; e += 32) {
      const int r = e / nb, c = e % nb;
      const int64_t n = q0 + warp * 16 + r;
      const bf16* row = c < a.Hg ? a.bh + (n * a.Hg + c) * HD : a.bw + (n * a.Wg + c - a.Hg) * HD;
      tab[r][c] = dot_bf16<HD>(&sm.Q[warp * 16 + r][0], row);
    }
    __syncwarp();
  }
  if (lane < 16) {
    ws.m[lane] = -INFINITY;
    ws.l[lane] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += BKV) {
    __syncthreads();  // previous k/v tiles consumed
    load_tile<HD>(sm.K, a.k + base + k0 * stride, stride, N - k0, tid);
    load_tile<HD>(sm.V, a.v + base + k0 * stride, stride, N - k0, tid);
    __syncthreads();

#pragma unroll
    for (int kb = 0; kb < BKV / 16; ++kb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int d = 0; d < HD; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, &sm.Q[warp * 16][d], Sm::LDT);
        wmma::load_matrix_sync(fb, &sm.K[kb * 16][d], Sm::LDT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(&ws.S[0][kb * 16], acc, Sm::LDF, wmma::mem_row_major);
    }
    __syncwarp();

    for (int r = 0; r < 16; ++r) {
      const int64_t n = q0 + warp * 16 + r;
      float s[BKV / 32];
      float mx = -INFINITY;
      if constexpr (MODE == MODE_DIAG) {
        // rows past g N (a ragged query tile) read the last row's bias
        const int64_t nb = n < N ? n : N - 1;
        const bf16* bhw = a.bh + (bhid * N + nb) * 2 * a.Wg;
        const int qwin = (int)(nb / a.Hg);
#pragma unroll
        for (int t = 0; t < BKV / 32; ++t) {
          const int m = lane + 32 * t, key = k0 + m;
          float v = -INFINITY;  // past g N: not a key
          if (key < N) {
            v = -1e30f;        // another window's key
            if (key / a.Hg == qwin) {
              const int kk = key % a.Hg;
              v = ws.S[r][m] * a.scale + (__bfloat162float(bhw[kk / a.Wg]) +
                                          __bfloat162float(bhw[a.Wg + kk % a.Wg]));
            }
          }
          s[t] = v;
          mx = fmaxf(mx, s[t]);
        }
      } else if constexpr (MODE == MODE_TABLE) {
#pragma unroll
        for (int t = 0; t < BKV / 32; ++t) {
          const int m = lane + 32 * t, key = k0 + m;
          s[t] = ws.S[r][m] * a.scale + tab[r][key / a.Wg] + tab[r][a.Hg + key % a.Wg];
          mx = fmaxf(mx, s[t]);
        }
      } else {
        const bf16* bhr = a.bh + (bhid * N + n) * a.Hg;
        const bf16* bwr = a.bw + (bhid * N + n) * a.Wg;
#pragma unroll
        for (int t = 0; t < BKV / 32; ++t) {
          const int m = lane + 32 * t, key = k0 + m;
          s[t] = ws.S[r][m] + __bfloat162float(bhr[key / a.Wg]) +
                 __bfloat162float(bwr[key % a.Wg]);
          mx = fmaxf(mx, s[t]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ws.m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < BKV / 32; ++t) {
        const float p = expf(s[t] - m_new);
        sum += p;
        ws.P[r][lane + 32 * t] = __float2bfloat16_rn(p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        ws.alpha[r] = al;
        ws.l[r] = ws.l[r] * al + sum;
        ws.m[r] = m_new;
      }
      __syncwarp();
    }
    __syncwarp();

#pragma unroll
    for (int d = 0; d < HD; d += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kb = 0; kb < BKV / 16; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, &ws.P[0][kb * 16], LDP);
        wmma::load_matrix_sync(fb, &sm.V[kb * 16][d], Sm::LDT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(&ws.S[0][d], acc, Sm::LDF, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * HD; e += 32) {
      const int r = e / HD, d = e % HD;
      ws.O[r][d] = ws.O[r][d] * ws.alpha[r] + ws.S[r][d];
    }
    __syncwarp();
  }

  for (int e = lane; e < 16 * HD; e += 32) {
    const int r = e / HD, d = e % HD;
    const int64_t n = q0 + warp * 16 + r;
    if (n < N) a.out[out_base + n * out_stride + d] = __float2bfloat16_rn(ws.O[r][d] / ws.l[r]);
  }
}

template <int HD, int MODE>
int launch(const Args& a, int BH, cudaStream_t stream) {
  const int bytes = smem_bytes<HD, MODE>();
  cudaError_t e = cudaFuncSetAttribute(relpos_attention_kernel<HD, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + BQ - 1) / BQ, BH);
  relpos_attention_kernel<HD, MODE><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_hd(const Args& a, int hd, int BH, cudaStream_t stream) {
  if (hd == 64) return launch<64, MODE>(a, BH, stream);
  if (hd == 80) return launch<80, MODE>(a, BH, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (pre-scaled), k, v, out: [B*heads, N, hd] bf16, hd 64 or 80; bh
// [B*heads, N, Hg], bw [B*heads, N, Wg] bf16 with N == Hg * Wg and
// N % 64 == 0.
int samroad_relpos_attention(const void* q, const void* k, const void* v,
                             const void* bh, const void* bw, void* out, int BH,
                             int N, int Hg, int Wg, int hd, void* stream) {
  if (N != Hg * Wg || N % BQ || BH <= 0) return (int)cudaErrorInvalidValue;
  Args a{reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
         reinterpret_cast<const bf16*>(v), reinterpret_cast<const bf16*>(bh),
         reinterpret_cast<const bf16*>(bw), reinterpret_cast<bf16*>(out), N, Hg, Wg, 0, 0, 1.f};
  return launch_hd<MODE_RELPOS>(a, hd, BH, reinterpret_cast<cudaStream_t>(stream));
}

// T1: qkv [nG, g*win*win, 3C] bf16 (g windows stacked), bhw [nG, heads,
// g*win*win, 2*win] bf16 -> out [nG, g*win*win, C] bf16; head_dim 64 or 80;
// scale 1 / sqrt(head_dim).
int samroad_diag_attention(const void* qkv, const void* bhw, void* out, int nG, int g, int C,
                           int heads, int win, void* stream) {
  if (nG <= 0 || g <= 0 || heads <= 0 || C % heads || win <= 0) return (int)cudaErrorInvalidValue;
  const int hd = C / heads, Nw = win * win;
  const bf16* p = reinterpret_cast<const bf16*>(qkv);
  Args a{p, p + C, p + 2 * C, reinterpret_cast<const bf16*>(bhw), nullptr,
         reinterpret_cast<bf16*>(out), g * Nw, Nw, win, C, heads, 1.0f / sqrtf((float)hd)};
  return launch_hd<MODE_DIAG>(a, hd, nG * heads, reinterpret_cast<cudaStream_t>(stream));
}

// T5 global: q (unscaled), k, v, out [BH, N, hd] bf16, hd 64 or 80; rh
// [N, Hg, hd], rw [N, Wg, hd] bf16 (the expanded rel-pos tables) with
// N == Hg * Wg, N % 64 == 0 and Hg + Wg <= 64; scale 1 / sqrt(hd).
int samroad_relpos_attention_table(const void* q, const void* k, const void* v,
                                   const void* rh, const void* rw, void* out, int BH, int N,
                                   int Hg, int Wg, int hd, void* stream) {
  if (N != Hg * Wg || N % BQ || Hg + Wg > TABLE_W || BH <= 0 || hd <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
         reinterpret_cast<const bf16*>(v), reinterpret_cast<const bf16*>(rh),
         reinterpret_cast<const bf16*>(rw), reinterpret_cast<bf16*>(out), N, Hg, Wg, 0, 0,
         1.0f / sqrtf((float)hd)};
  return launch_hd<MODE_TABLE>(a, hd, BH, reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
