// Windowed multi-head attention on the zero-padded token grid: the CUDA
// kernel behind K2 (window_attention_rows_grid) of
// sam_road_tpu_torch/ops/fused_block.py.
//
// Replaces sam_road_tpu/ops/fused_block.py::window_attention_rows_grid at
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
// Np = 208 rows (13 strips of 16; K13's padded layout) with the pad KEYS
// masked to -inf -- not to be confused with the window-padding tokens,
// which are real keys -- and each of 4 warps walks query strips of 16:
//   s = q.k^T * scale + bh[n, i'] + bw[n, j']     (fp32, key n' = (i', j'))
//   p = exp(s - max), l = sum p,  out = (bf16(p) . v) / l
// the score strip never leaves shared memory (a full 196 x 196 fp32 score
// tile would be 154 KB). Products use nvcuda::wmma bf16 fragments with fp32
// accumulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 64;             // head dim the kernel is written for
constexpr int LDQ = HD + 8;        // smem row stride of q/k/v (bf16)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

struct Layout {  // dynamic shared memory carve-up, byte offsets
  int np, lds, ldp;
  size_t q, k, v, warp0, warp_bytes, s_off, p_off, l_off, total;
  __host__ __device__ Layout(int N) {
    np = (N + 15) & ~15;
    lds = np + 4;   // fp32 score row stride (multiple of 4)
    ldp = np + 8;   // bf16 probability row stride (multiple of 8)
    const size_t qkv = (size_t)np * LDQ * sizeof(bf16);
    q = 0;
    k = qkv;
    v = 2 * qkv;
    warp0 = 3 * qkv;
    s_off = 0;
    p_off = (16 * lds * sizeof(float) + 127) & ~(size_t)127;
    l_off = p_off + ((16 * ldp * sizeof(bf16) + 127) & ~(size_t)127);
    warp_bytes = l_off + 128;
    total = warp0 + WARPS * warp_bytes;
  }
};

__global__ void __launch_bounds__(THREADS)
window_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qkv_bias,
                        const bf16* __restrict__ bh, const bf16* __restrict__ bw,
                        bf16* __restrict__ out, int Hp, int Wp, int C, int heads,
                        int win, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = win * win;
  const Layout L(N);
  bf16 (*Qs)[LDQ] = reinterpret_cast<bf16 (*)[LDQ]>(smem + L.q);
  bf16 (*Ks)[LDQ] = reinterpret_cast<bf16 (*)[LDQ]>(smem + L.k);
  bf16 (*Vs)[LDQ] = reinterpret_cast<bf16 (*)[LDQ]>(smem + L.v);

  const int nI = Hp / win, nJ = Wp / win;
  int idx = blockIdx.x;
  const int head = idx % heads; idx /= heads;
  const int wj = idx % nJ; idx /= nJ;
  const int wi = idx % nI;
  const int b = idx / nI;
  const int C3 = 3 * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // q/k/v of this (window, head), bias added to every token (pad tokens
  // included); rows N..Np-1 are zero.
  for (int e = tid; e < L.np * (HD / 8); e += THREADS) {
    const int n = e / (HD / 8), c = (e % (HD / 8)) * 8;
    uint4 vals[3];
    if (n < N) {
      const int gy = wi * win + n / win, gx = wj * win + n % win;
      const bf16* base = qkv + ((int64_t)(b * Hp + gy) * Wp + gx) * C3 + head * HD + c;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        uint4 u = *reinterpret_cast<const uint4*>(base + t * C);
        const uint4 bu = *reinterpret_cast<const uint4*>(qkv_bias + t * C + head * HD + c);
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
        const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&bu);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __bfloat1622float2(h[i]), y = __bfloat1622float2(hb[i]);
          h[i] = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
        }
        vals[t] = u;
      }
    } else {
      vals[0] = vals[1] = vals[2] = make_uint4(0u, 0u, 0u, 0u);
    }
    *reinterpret_cast<uint4*>(&Qs[n][c]) = vals[0];
    *reinterpret_cast<uint4*>(&Ks[n][c]) = vals[1];
    *reinterpret_cast<uint4*>(&Vs[n][c]) = vals[2];
  }
  __syncthreads();

  unsigned char* wbase = smem + L.warp0 + warp * L.warp_bytes;
  float* S = reinterpret_cast<float*>(wbase + L.s_off);
  bf16* P = reinterpret_cast<bf16*>(wbase + L.p_off);
  float* lsum = reinterpret_cast<float*>(wbase + L.l_off);
  const int64_t rows_base = ((((int64_t)b * nI + wi) * nJ + wj) * heads + head) * N;
  const int nstrips = L.np / 16;

  for (int strip = warp; strip < nstrips; strip += WARPS) {
    const int r0 = strip * 16;
    // scores of 16 queries against all Np keys
    for (int kb = 0; kb < L.np / 16; ++kb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int d = 0; d < HD; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, &Qs[r0][d], LDQ);
        wmma::load_matrix_sync(fb, &Ks[kb * 16][d], LDQ);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(S + kb * 16, acc, L.lds, wmma::mem_row_major);
    }
    __syncwarp();
    // scale + rel-pos spread + pad-key mask, fp32 softmax numerator
    for (int r = 0; r < 16; ++r) {
      const int n = r0 + r;
      const bf16* bhr = bh + (rows_base + (n < N ? n : 0)) * win;
      const bf16* bwr = bw + (rows_base + (n < N ? n : 0)) * win;
      float* srow = S + r * L.lds;
      float mx = -INFINITY;
      for (int m = lane; m < L.np; m += 32) {
        float s = -INFINITY;
        if (m < N) {
          s = srow[m] * scale;
          if (n < N) s += __bfloat162float(bhr[m / win]) + __bfloat162float(bwr[m % win]);
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
        P[r * L.ldp + m] = __float2bfloat16_rn(p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) lsum[r] = sum;
    }
    __syncwarp();
    // (p . v), normalised after the product
#pragma unroll
    for (int d = 0; d < HD; d += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kb = 0; kb < L.np / 16; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, P + kb * 16, L.ldp);
        wmma::load_matrix_sync(fb, &Vs[kb * 16][d], LDQ);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(S + d, acc, L.lds, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * HD; e += 32) {
      const int r = e / HD, d = e % HD;
      const int n = r0 + r;
      if (n < N) {
        const int gy = wi * win + n / win, gx = wj * win + n % win;
        out[((int64_t)(b * Hp + gy) * Wp + gx) * C + head * HD + d] =
            __float2bfloat16_rn(S[r * L.lds + d] / lsum[r]);
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// qkv [B, Hp, Wp, 3C] bf16 (bias-free, zero pads), qkv_bias [3C] bf16,
// bh / bw [B, Hp/win, Wp/win, heads, win*win, win] bf16,
// out [B, Hp, Wp, C] bf16. head_dim must be 64.
int samroad_window_attention(const void* qkv, const void* qkv_bias, const void* bh,
                             const void* bw, void* out, int B, int Hp, int Wp,
                             int C, int heads, int win, void* stream) {
  if (C != heads * HD || Hp % win || Wp % win || win <= 0 || win * win > 256)
    return (int)cudaErrorInvalidValue;
  const Layout L(win * win);
  cudaError_t e = cudaFuncSetAttribute(window_attention_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.total);
  if (e != cudaSuccess) return (int)e;
  const int blocks = B * (Hp / win) * (Wp / win) * heads;
  window_attention_kernel<<<blocks, THREADS, L.total, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const bf16*>(qkv), reinterpret_cast<const bf16*>(qkv_bias),
      reinterpret_cast<const bf16*>(bh), reinterpret_cast<const bf16*>(bw),
      reinterpret_cast<bf16*>(out), Hp, Wp, C, heads, win, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // extern "C"
