// K5's fp32 instance: fused_attention (sam_road_tpu_torch/ops/attention.py)
// on fp32 q~, k~ and v, beside csrc/relpos_attention.cu's MODE_FOLDED, which
// takes bf16 only.
//
// Replaces sam_road_tpu/ops/attention.py::fused_attention (_flash_forward:
// _flash_kernel and _blocked_kernel) where it runs on fp32 inputs: the JAX
// kernel takes any dtype (it writes v.dtype), so the eager encoder runs it
// at COMPUTE_DTYPE float32 too, as models/vit.py does for the fp32 reference
// encoders and the checkpoint parity report (tools/verify_real_ckpt.py).
// It computes softmax(q~.k~^T).v over the folded
// q~ = [q scale, q.Rh, q.Rw], k~ = [k, onehot(row), onehot(col)], with
// every product, the softmax and the accumulator in fp32.
//
// What bounds it on the H100: operations, 2 N^2 (D + dv) a (image, head),
// at the fp32 rate outside the tensor cores (67 TFLOP/s): wgmma's TF32 keeps
// about three decimal digits, which an fp32 tolerance cannot take. So the
// products are fp32 FMAs on the CUDA cores, in a flash-attention loop:
// - One block of 256 threads per (image x head, 64-query tile). A thread
//   holds 4 query rows x 4 keys of the 64 x 64 score tile (keys tx + 16 i,
//   tx = tid % 16) and 4 rows x dv / 16 columns of the output (columns
//   4 tx .. 4 tx + 3, and 64 + tx at dv 80); the 16 threads of a row group
//   are one half-warp, so a row's max and sum are four shuffles.
// - The q tile and each 64-key k tile sit row-major in shared memory, rows
//   DQK + 4 floats apart, so the float4 reads of 8 consecutive keys' rows
//   fall in 32 distinct banks. A step of the score loop takes 4 columns:
//   4 float4 reads of q (broadcast over the row group) and 4 of k feed 64
//   FMAs. v sits as it comes ([64][dv]); p goes through shared memory
//   ([64][64 + 4]) from the score layout to the p.v layout, where a step
//   reads one float4 of p and one of v (and one scalar at dv 80) for 16
//   (20) FMAs. Every tile is loaded in float4s (rows of D % 8 == 0 floats).
// - The online softmax keeps the running max per row in every thread of
//   its row group and a partial sum per thread (the same rescale factor
//   reaches all 16 partial sums, which are added once at the end).
// - Keys past N are -inf; their k and v rows and query rows past N load as
//   zeros, and columns from D to DQK are zero-filled (the same instance set
//   as the bf16 kernel: (DQK, dv) = (96, 64), (128, 64), (192, 64),
//   (112, 80)). Shared memory: 134 KB a block at (192, 64), 97 KB at
//   (112, 80), 85 KB at (96, 64).
// A first design that is right, not the fastest: no load overlaps the
// products (one stage, two barriers a tile), and the query tiles of a
// 196-token window are 23 % rows past N.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 256;
constexpr int RQ = BQ / (THREADS / 16);  // query rows a thread: 4
constexpr int KC = BKV / 16;             // keys a thread: 4
constexpr int PLD = BQ + 4;              // p rows (one per key): float4-aligned reads
constexpr int SMEM_MAX = 232448;         // a block's dynamic shared memory on Hopper
static_assert(RQ == 4, "a row group's rows are one float4 of p");

template <int DQK, int HD>
constexpr int smem_bytes() {
  return ((BQ + BKV) * (DQK + 4) + BKV * HD + BKV * PLD) * (int)sizeof(float);
}

// rows [0, R) of a [rows][W] fp32 tile, rows `ld` floats apart, in float4s;
// rows from `valid` on and columns from `cols` on (a multiple of 4) are zeros
template <int R, int W>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int64_t stride,
                                          int valid, int cols) {
  for (int e = threadIdx.x; e < R * (W / 4); e += THREADS) {
    const int r = e / (W / 4), c = e % (W / 4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid && c < cols) x = *reinterpret_cast<const float4*>(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

template <int DQK, int HD>
__global__ void __launch_bounds__(THREADS)
    folded_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ out, int N,
                                int D) {
  static_assert(HD == 64 || HD == 80, "value widths 64 and 80");
  constexpr int LD = DQK + 4;      // q and k rows
  constexpr int OC = HD / 16;      // output columns a thread: 4 tx .. 4 tx + 3 (+ 64 + tx)
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [BQ][LD]
  float* Ks = Qs + BQ * LD;        // [BKV][LD]
  float* Vs = Ks + BKV * LD;       // [BKV][HD]
  float* Ps = Vs + BKV * HD;       // [BKV][PLD]: Ps[j PLD + r] = p[r, j]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const float* kb = k + bh * N * D;
  const float* vb = v + bh * N * HD;

  load_tile<BQ, DQK>(Qs, LD, q + (bh * N + q0) * D, D, N - q0, D);

  float o[RQ][OC], m[RQ], l[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) o[r][c] = 0.f;
  }

  const int nt = (N + BKV - 1) / BKV;
  for (int j = 0; j < nt; ++j) {
    const int k0 = j * BKV;
    __syncthreads();  // the q tile is stored; the last tile's k, v and p are consumed
    load_tile<BKV, DQK>(Ks, LD, kb + (int64_t)k0 * D, D, N - k0, D);
    load_tile<BKV, HD>(Vs, HD, vb + (int64_t)k0 * HD, HD, N - k0, HD);
    __syncthreads();

    float s[RQ][KC];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int i = 0; i < KC; ++i) s[r][i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DQK; d += 4) {
      float4 a[RQ], b[KC];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
        a[r] = *reinterpret_cast<const float4*>(Qs + (ty * RQ + r) * LD + d);
#pragma unroll
      for (int i = 0; i < KC; ++i)
        b[i] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * i) * LD + d);
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int i = 0; i < KC; ++i) fma4(s[r][i], a[r], b[i]);
    }

    // online softmax; key k0 < N is in every tile, so each row's max is finite
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        if (k0 + tx + 16 * i >= N) s[r][i] = -INFINITY;
        mx = fmaxf(mx, s[r][i]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - mn);  // 0 on the first tile (m = -inf)
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        s[r][i] = expf(s[r][i] - mn);
        sum += s[r][i];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int c = 0; c < OC; ++c) o[r][c] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < KC; ++i)
      *reinterpret_cast<float4*>(Ps + (tx + 16 * i) * PLD + ty * RQ) =
          make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(Ps + kk * PLD + ty * RQ);
      const float* vk = Vs + kk * HD;
      const float4 b = *reinterpret_cast<const float4*>(vk + 4 * tx);
      const float pr[RQ] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        o[r][0] = fmaf(pr[r], b.x, o[r][0]);
        o[r][1] = fmaf(pr[r], b.y, o[r][1]);
        o[r][2] = fmaf(pr[r], b.z, o[r][2]);
        o[r][3] = fmaf(pr[r], b.w, o[r][3]);
        if constexpr (HD == 80) o[r][4] = fmaf(pr[r], vk[64 + tx], o[r][4]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int n = q0 + ty * RQ + r;
    if (n < N) {
      const float f = 1.f / lt;
      float* dst = out + (bh * N + n) * HD;
      *reinterpret_cast<float4*>(dst + 4 * tx) =
          make_float4(o[r][0] * f, o[r][1] * f, o[r][2] * f, o[r][3] * f);
      if constexpr (HD == 80) dst[64 + tx] = o[r][4] * f;
    }
  }
}

template <int DQK, int HD>
int launch(const float* q, const float* k, const float* v, float* out, int BH, int N, int D,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DQK, HD>();
  static_assert(bytes <= SMEM_MAX, "the block's tiles exceed Hopper's shared memory");
  cudaError_t e = cudaFuncSetAttribute(folded_attention_f32_kernel<DQK, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BQ - 1) / BQ, BH);
  folded_attention_f32_kernel<DQK, HD><<<grid, THREADS, bytes, stream>>>(q, k, v, out, N, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5 in fp32: q~ (scaled), k~ [BH, N, D] and v [BH, N, dv] -> out [BH, N, dv],
// fp32; the bf16 kernel's instance set (dv 64 with D <= 96, 128 or 192, dv 80
// with D <= 112; D % 8 == 0). Any N; BH <= 65535 (the grid's y).
int samroad_folded_attention_f32(const void* q, const void* k, const void* v, void* out,
                                 int BH, int N, int D, int dv, void* stream) {
  if (BH <= 0 || BH > 65535 || N <= 0 || D <= 0 || D % 8) return (int)cudaErrorInvalidValue;
  const float* qf = reinterpret_cast<const float*>(q);
  const float* kf = reinterpret_cast<const float*>(k);
  const float* vf = reinterpret_cast<const float*>(v);
  float* of = reinterpret_cast<float*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dv == 64 && D <= 96) return launch<96, 64>(qf, kf, vf, of, BH, N, D, s);
  if (dv == 64 && D <= 128) return launch<128, 64>(qf, kf, vf, of, BH, N, D, s);
  if (dv == 64 && D <= 192) return launch<192, 64>(qf, kf, vf, of, BH, N, D, s);
  if (dv == 80 && D <= 112) return launch<112, 80>(qf, kf, vf, of, BH, N, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
