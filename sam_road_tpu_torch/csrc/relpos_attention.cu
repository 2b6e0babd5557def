// Global attention with decomposed relative-position bias rows: the CUDA
// kernel behind K3 (attention_relpos_rows) of
// sam_road_tpu_torch/ops/attention.py.
//
// Replaces sam_road_tpu/ops/attention.py::attention_relpos_rows
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 64;
constexpr int BQ = 64, BKV = 64;
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr int LDT = HD + 8;    // bf16 tile row stride
constexpr int LDF = HD + 4;    // fp32 row stride (BKV == HD == 64)

struct WarpSmem {
  float S[16][LDF];            // scores, then the (p . v) of one tile
  float O[16][LDF];            // running output
  bf16 P[16][LDT];             // probabilities of one tile
  float m[16], l[16], alpha[16];
};

struct Smem {
  bf16 Q[BQ][LDT];
  bf16 K[BKV][LDT];
  bf16 V[BKV][LDT];
  WarpSmem w[WARPS];
};

__device__ __forceinline__ void load_tile(bf16 (*dst)[LDT], const bf16* src, int tid) {
  for (int e = tid; e < 64 * (HD / 8); e += THREADS) {
    const int r = e / (HD / 8), c = (e % (HD / 8)) * 8;
    *reinterpret_cast<uint4*>(&dst[r][c]) =
        *reinterpret_cast<const uint4*>(src + (int64_t)r * HD + c);
  }
}

__global__ void __launch_bounds__(THREADS)
relpos_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ bh,
                        const bf16* __restrict__ bw, bf16* __restrict__ out,
                        int N, int Hg, int Wg) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t bhid = blockIdx.y;          // image x head
  const int q0 = blockIdx.x * BQ;
  const int64_t base = bhid * N * HD;
  WarpSmem& ws = sm.w[warp];

  load_tile(sm.Q, q + base + (int64_t)q0 * HD, tid);
  for (int e = lane; e < 16 * HD; e += 32) ws.O[e / HD][e % HD] = 0.f;
  if (lane < 16) {
    ws.m[lane] = -INFINITY;
    ws.l[lane] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += BKV) {
    __syncthreads();  // previous k/v tiles consumed
    load_tile(sm.K, k + base + (int64_t)k0 * HD, tid);
    load_tile(sm.V, v + base + (int64_t)k0 * HD, tid);
    __syncthreads();

#pragma unroll
    for (int kb = 0; kb < BKV / 16; ++kb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int d = 0; d < HD; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, &sm.Q[warp * 16][d], LDT);
        wmma::load_matrix_sync(fb, &sm.K[kb * 16][d], LDT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(&ws.S[0][kb * 16], acc, LDF, wmma::mem_row_major);
    }
    __syncwarp();

    for (int r = 0; r < 16; ++r) {
      const int64_t n = q0 + warp * 16 + r;
      const bf16* bhr = bh + (bhid * N + n) * Hg;
      const bf16* bwr = bw + (bhid * N + n) * Wg;
      float s[BKV / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < BKV / 32; ++t) {
        const int m = lane + 32 * t, key = k0 + m;
        s[t] = ws.S[r][m] + __bfloat162float(bhr[key / Wg]) + __bfloat162float(bwr[key % Wg]);
        mx = fmaxf(mx, s[t]);
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
        const float a = expf(m_old - m_new);
        ws.alpha[r] = a;
        ws.l[r] = ws.l[r] * a + sum;
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
        wmma::load_matrix_sync(fa, &ws.P[0][kb * 16], LDT);
        wmma::load_matrix_sync(fb, &sm.V[kb * 16][d], LDT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(&ws.S[0][d], acc, LDF, wmma::mem_row_major);
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
    out[base + (int64_t)(q0 + warp * 16 + r) * HD + d] =
        __float2bfloat16_rn(ws.O[r][d] / ws.l[r]);
  }
}

}  // namespace

extern "C" {

// q (pre-scaled), k, v, out: [B*heads, N, 64] bf16; bh [B*heads, N, Hg],
// bw [B*heads, N, Wg] bf16 with N == Hg * Wg and N % 64 == 0.
int samroad_relpos_attention(const void* q, const void* k, const void* v,
                             const void* bh, const void* bw, void* out, int BH,
                             int N, int Hg, int Wg, void* stream) {
  if (N != Hg * Wg || N % BQ || BH <= 0) return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(relpos_attention_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / BQ, BH);
  relpos_attention_kernel<<<grid, THREADS, bytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
      reinterpret_cast<const bf16*>(v), reinterpret_cast<const bf16*>(bh),
      reinterpret_cast<const bf16*>(bw), reinterpret_cast<bf16*>(out), N, Hg, Wg);
  return (int)cudaGetLastError();
}

}  // extern "C"
