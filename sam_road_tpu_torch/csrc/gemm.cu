// bf16 tensor-core GEMM with LayerNorm prologue and bias / GELU / residual
// epilogues: the CUDA kernels behind K1 (ln_dense) and K4
// (proj_ln_mlp_residual) of sam_road_tpu_torch/ops/fused_ln.py.
//
// Replaces sam_road_tpu/ops/fused_ln.py::ln_dense (_ln_dense_kernel) and
// ::proj_ln_mlp_residual (_proj_ln_mlp_kernel). On the TPU both keep their
// weights resident in VMEM for the whole grid; a Hopper SM has 227 KB of
// shared memory, so here the weights stream through shared memory in K
// tiles and L2 (50 MB) holds them across blocks.
//
// What bounds it on the H100: tensor-core rate. At the bench geometry
// (M = 32 x 1024 tokens, C = 768) LN1+qkv is 116 GFLOP per call against
// 0.2 GB of activations, far above the card's ~295 FLOP/byte balance point.
// This first version issues mma.sync through nvcuda::wmma fragments
// (16x16x16 bf16, fp32 accumulate) on a 128x128 block tile with one K tile
// prefetched into registers; wgmma, TMA and a deeper pipeline are later work.
//
// C = epilogue(prologue(A) . B^T):  A [M, K], B [N, K] (nn.Linear layout),
// both K-contiguous. Prologue modes:
//   A_BF16     A as it is (bf16);
//   A_LN_BF16  LayerNorm(A) with fp32 statistics (eps 1e-6), bf16 A;
//   A_LN_F32   the same over an fp32 A (K4's x1, kept in fp32).
// The LN output is rounded to bf16 before the product, as the Pallas
// kernels do. Epilogue, in fp32 and in this order: + bias, GELU (exact
// erf), + residual (bf16 or fp32); stored as bf16 or fp32.
// Requires N % 128 == 0, K % 32 == 0 and 16-byte aligned pointers (the
// Python wrapper checks); M is arbitrary.
//
// Grid addressing (the PAD_FREE path of the windowed blocks): the M rows are
// the tokens m = (b, y, x) of a [B, H, W] grid, and A (A_GRID) or C (C_GRID)
// lives on the window-padded [B, Hp, Wp] grid, so row m is read or written
// at padded row (b * Hp + y) * Wp + x. Only the address changes: the K loop,
// the accumulation order and the epilogue are those of the flat mode, so
// real tokens come out bit-equal to it.
//   K7 ln_dense_padded (replaces sam_road_tpu/ops/fused_ln.py::ln_dense_padded,
//      _ln_dense_padded_kernel): K1 with C_GRID, then zero_pad_kernel writes
//      the pad positions (and only those) with zeros. Bound like K1 by the
//      tensor cores; it saves the F.pad pass over the padded qkv grid.
//   K8 proj_ln_mlp_residual_grid (replaces fused_ln.py::proj_ln_mlp_residual_grid,
//      _proj_ln_mlp_grid_kernel): K4 whose first launch reads the attention
//      output with A_GRID; it saves the crop copy before the tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;          // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;       // warp tile
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int LDS = BK + 8;           // smem row stride in bf16 (80 bytes)

enum AMode { A_BF16 = 0, A_LN_BF16 = 1, A_LN_F32 = 2 };
enum ResMode { RES_NONE = 0, RES_BF16 = 1, RES_F32 = 2 };

// Token m = (b, y, x) of a [B, H, W] grid -> its row of the [B, Hp, Wp] grid.
struct GridMap {
  int H, W, Hp, Wp;
  __device__ __forceinline__ int64_t row(int m) const {
    const int hw = H * W;
    const int b = m / hw, r = m - b * hw, y = r / W, x = r - y * W;
    return ((int64_t)b * Hp + y) * Wp + x;
  }
};

template <bool GRID>
__device__ __forceinline__ int64_t map_row(int m, const GridMap& g) {
  if constexpr (GRID) return g.row(m);
  else return m;
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 float_to_bf16x8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// Eight consecutive A values starting at element offset `off`, as floats.
template <int AM>
__device__ __forceinline__ void load_a8(const void* A, int64_t off, float* f) {
  if constexpr (AM == A_LN_F32) {
    const float4* p = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(A) + off);
    float4 a = p[0], b = p[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    uint4 u = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const bf16*>(A) + off);
    bf16x8_to_float(u, f);
  }
}

// Raw registers of one thread's share of an A tile (2 chunks of 8 values).
template <int AM> struct ARaw { uint4 v[2]; };
template <> struct ARaw<A_LN_F32> { float4 v[4]; };

template <int AM, bool A_GRID>
__device__ __forceinline__ void fetch_a(ARaw<AM>& r, const void* A, int m0,
                                        int k0, int M, int K, int tid,
                                        const GridMap& g) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int idx = c * THREADS + tid;
    const int row = idx >> 2, col = (idx & 3) * 8;
    const int gm = m0 + row;
    const int64_t off = (gm < M ? map_row<A_GRID>(gm, g) : 0) * K + k0 + col;
    if constexpr (AM == A_LN_F32) {
      if (gm < M) {
        const float4* p = reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(A) + off);
        r.v[2 * c] = p[0];
        r.v[2 * c + 1] = p[1];
      } else {
        r.v[2 * c] = make_float4(0.f, 0.f, 0.f, 0.f);
        r.v[2 * c + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      r.v[c] = gm < M ? *reinterpret_cast<const uint4*>(
                            reinterpret_cast<const bf16*>(A) + off)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <int AM>
__device__ __forceinline__ void store_a(const ARaw<AM>& r, bf16 (*As)[LDS],
                                        const float* mean, const float* rstd,
                                        const bf16* ln_s, const bf16* ln_b,
                                        int k0, int tid) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int idx = c * THREADS + tid;
    const int row = idx >> 2, col = (idx & 3) * 8;
    uint4 out;
    if constexpr (AM == A_BF16) {
      out = r.v[c];
    } else {
      float f[8];
      if constexpr (AM == A_LN_F32) {
        const float4 a = r.v[2 * c], b = r.v[2 * c + 1];
        f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
        f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
      } else {
        bf16x8_to_float(r.v[c], f);
      }
      float s[8], b[8];
      bf16x8_to_float(*reinterpret_cast<const uint4*>(ln_s + k0 + col), s);
      bf16x8_to_float(*reinterpret_cast<const uint4*>(ln_b + k0 + col), b);
      const float mu = mean[row], rs = rstd[row];
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = (f[i] - mu) * rs * s[i] + b[i];
      out = float_to_bf16x8(f);
    }
    *reinterpret_cast<uint4*>(&As[row][col]) = out;
  }
}

template <int AM, bool HAS_BIAS, bool GELU, int RES, bool OUT_F32, bool A_GRID,
          bool C_GRID>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const void* __restrict__ A, const bf16* __restrict__ B,
            const bf16* __restrict__ bias, const void* __restrict__ res,
            const bf16* __restrict__ ln_s, const bf16* __restrict__ ln_b,
            void* __restrict__ C, int M, int N, int K, GridMap g) {
  __shared__ __align__(128) bf16 As[BM][LDS];
  __shared__ __align__(128) bf16 Bs[BN][LDS];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];
  __shared__ float mean[BM], rstd[BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wm = warp / 4, wn = warp % 4;

  if constexpr (AM != A_BF16) {
    // LayerNorm statistics of this block's rows, two-pass in fp32 (the
    // Pallas kernel's mean((x - mu)^2)); one warp per row.
    for (int row = warp; row < BM; row += THREADS / 32) {
      const int gm = m0 + row;
      float mu = 0.f, rs = 0.f;
      if (gm < M) {
        float sum = 0.f;
        const int64_t arow = map_row<A_GRID>(gm, g) * K;
        for (int k = lane * 8; k < K; k += 256) {
          float f[8];
          load_a8<AM>(A, arow + k, f);
#pragma unroll
          for (int i = 0; i < 8; ++i) sum += f[i];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        mu = sum / K;
        float sq = 0.f;
        for (int k = lane * 8; k < K; k += 256) {
          float f[8];
          load_a8<AM>(A, arow + k, f);
#pragma unroll
          for (int i = 0; i < 8; ++i) sq += (f[i] - mu) * (f[i] - mu);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
        rs = rsqrtf(sq / K + 1e-6f);
      }
      if (lane == 0) {
        mean[row] = mu;
        rstd[row] = rs;
      }
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  ARaw<AM> ra;
  uint4 rb[2];
  auto fetch_b = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int idx = c * THREADS + tid;
      const int row = idx >> 2, col = (idx & 3) * 8;
      rb[c] = *reinterpret_cast<const uint4*>(B + (int64_t)(n0 + row) * K + k0 + col);
    }
  };
  fetch_a<AM, A_GRID>(ra, A, m0, 0, M, K, tid, g);
  fetch_b(0);

  const int KT = K / BK;
  for (int kt = 0; kt < KT; ++kt) {
    __syncthreads();  // previous tile consumed (and LN stats visible)
    store_a<AM>(ra, As, mean, rstd, ln_s, ln_b, kt * BK, tid);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int idx = c * THREADS + tid;
      *reinterpret_cast<uint4*>(&Bs[idx >> 2][(idx & 3) * 8]) = rb[c];
    }
    __syncthreads();
    if (kt + 1 < KT) {  // next tile's loads fly while this one computes
      fetch_a<AM, A_GRID>(ra, A, m0, (kt + 1) * BK, M, K, tid, g);
      fetch_b((kt + 1) * BK);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &As[wm * WM + i * 16][kk], LDS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[wn * WN + j * 16][kk], LDS);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  // Epilogue through a per-warp 16x16 staging tile: lane -> (row, 8 cols).
  float* cs = Cs[warp];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * WM + i * 16 + r;
      const int gn = n0 + wn * WN + j * 16 + c0;
      if (gm < M) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = cs[r * 16 + c0 + e];
        if constexpr (HAS_BIAS) {
          float bv[8];
          bf16x8_to_float(*reinterpret_cast<const uint4*>(bias + gn), bv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += bv[e];
        }
        if constexpr (GELU) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = gelu_erf(v[e]);
        }
        const int64_t off = (int64_t)gm * N + gn;
        const int64_t c_off = map_row<C_GRID>(gm, g) * N + gn;
        if constexpr (RES == RES_BF16) {
          float rv[8];
          bf16x8_to_float(*reinterpret_cast<const uint4*>(
                              reinterpret_cast<const bf16*>(res) + off), rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += rv[e];
        } else if constexpr (RES == RES_F32) {
          float rv[8];
          load_a8<A_LN_F32>(res, off, rv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += rv[e];
        }
        if constexpr (OUT_F32) {
          float4* o = reinterpret_cast<float4*>(reinterpret_cast<float*>(C) + c_off);
          o[0] = make_float4(v[0], v[1], v[2], v[3]);
          o[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(C) + c_off) = float_to_bf16x8(v);
        }
      }
      __syncwarp();
    }
  }
}

template <int AM, bool HAS_BIAS, bool GELU, int RES, bool OUT_F32, bool A_GRID = false,
          bool C_GRID = false>
void launch(const void* A, const void* B, const void* bias, const void* res,
            const void* ln_s, const void* ln_b, void* C, int M, int N, int K,
            cudaStream_t stream, GridMap g = GridMap{0, 0, 0, 0}) {
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_kernel<AM, HAS_BIAS, GELU, RES, OUT_F32, A_GRID, C_GRID><<<grid, THREADS, 0, stream>>>(
      A, reinterpret_cast<const bf16*>(B), reinterpret_cast<const bf16*>(bias),
      res, reinterpret_cast<const bf16*>(ln_s), reinterpret_cast<const bf16*>(ln_b),
      C, M, N, K, g);
}

// Zeros at the pad positions of out [B, Hp, Wp, F] (rows y >= H, columns
// x >= W), and nowhere else; 16 bytes a thread, grid-stride.
__global__ void zero_pad_kernel(bf16* __restrict__ out, int B, GridMap g, int F) {
  const int chunks = F / 8;
  const int right = g.H * (g.Wp - g.W);          // pad columns of the real rows
  const int per_img = right + (g.Hp - g.H) * g.Wp;  // then the whole pad rows
  const int64_t total = (int64_t)B * per_img * chunks;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % chunks);
    const int64_t t = i / chunks;
    const int b = (int)(t / per_img);
    int p = (int)(t - (int64_t)b * per_img), y, x;
    if (p < right) {
      y = p / (g.Wp - g.W);
      x = g.W + p % (g.Wp - g.W);
    } else {
      p -= right;
      y = g.H + p / g.Wp;
      x = p % g.Wp;
    }
    *reinterpret_cast<uint4*>(out + (((int64_t)b * g.Hp + y) * g.Wp + x) * F + c * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// K4's three launches; A_GRID reads the attention output `a` on the padded grid.
template <bool A_GRID>
int proj_ln_mlp_residual(const void* x, const void* a, const void* wp, const void* bp,
                         const void* ln_s, const void* ln_b, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* x1, void* mid, void* out,
                         int M, int C, int F, cudaStream_t s, GridMap g) {
  if (C % BN || F % BN || C % BK || F % BK || M <= 0) return (int)cudaErrorInvalidValue;
  launch<A_BF16, true, false, RES_BF16, true, A_GRID>(a, wp, bp, x, nullptr, nullptr, x1, M, C,
                                                      C, s, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  launch<A_LN_F32, true, true, RES_NONE, false>(x1, w1, b1, nullptr, ln_s, ln_b, mid, M, F, C, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  launch<A_BF16, true, false, RES_F32, false>(mid, w2, b2, x1, nullptr, nullptr, out, M, C, F, s);
  return (int)cudaGetLastError();
}

bool bad_grid(int B, int H, int W, int Hp, int Wp) {
  return B <= 0 || H <= 0 || W <= 0 || Hp < H || Wp < W;
}

}  // namespace

extern "C" {

// K1: out[M, N] bf16 = LN(x[M, K]) . w[N, K]^T (+ bias[N] when not null).
int samroad_ln_dense(const void* x, const void* ln_s, const void* ln_b,
                     const void* w, const void* bias, void* out, int M, int N,
                     int K, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (N % BN || K % BK || M <= 0) return (int)cudaErrorInvalidValue;
  if (bias)
    launch<A_LN_BF16, true, false, RES_NONE, false>(x, w, bias, nullptr, ln_s, ln_b, out, M, N, K, s);
  else
    launch<A_LN_BF16, false, false, RES_NONE, false>(x, w, nullptr, nullptr, ln_s, ln_b, out, M, N, K, s);
  return (int)cudaGetLastError();
}

// K4 in three launches on one stream:
//   x1[M, C] f32   = x + a . wp^T + bp
//   mid[M, F] bf16 = GELU(LN2(x1) . w1^T + b1)
//   out[M, C] bf16 = x1 + b2 + mid . w2^T
// x1 and mid are caller-allocated scratch.
int samroad_proj_ln_mlp_residual(const void* x, const void* a, const void* wp,
                                 const void* bp, const void* ln_s,
                                 const void* ln_b, const void* w1,
                                 const void* b1, const void* w2, const void* b2,
                                 void* x1, void* mid, void* out, int M, int C,
                                 int F, void* stream) {
  return proj_ln_mlp_residual<false>(x, a, wp, bp, ln_s, ln_b, w1, b1, w2, b2, x1, mid, out, M,
                                     C, F, reinterpret_cast<cudaStream_t>(stream),
                                     GridMap{0, 0, 0, 0});
}

// K7: out[B, Hp, Wp, N] bf16 = LN(x[B, H, W, K]) . w[N, K]^T on the real
// tokens (bias-free), zeros at the pad positions.
int samroad_ln_dense_padded(const void* x, const void* ln_s, const void* ln_b,
                            const void* w, void* out, int B, int H, int W, int Hp,
                            int Wp, int N, int K, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (N % BN || K % BK || bad_grid(B, H, W, Hp, Wp)) return (int)cudaErrorInvalidValue;
  const GridMap g{H, W, Hp, Wp};
  launch<A_LN_BF16, false, false, RES_NONE, false, false, true>(x, w, nullptr, nullptr, ln_s, ln_b,
                                                                out, B * H * W, N, K, s, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t pad_chunks = (int64_t)B * (Hp * Wp - H * W) * (N / 8);
  if (pad_chunks > 0) {
    const int blocks = (int)((pad_chunks + 255) / 256 < 132 * 16 ? (pad_chunks + 255) / 256
                                                                 : 132 * 16);
    zero_pad_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<bf16*>(out), B, g, N);
  }
  return (int)cudaGetLastError();
}

// K8: K4 over x[B, H, W, C] with the attention output a[B, Hp, Wp, C] read
// on the padded grid; out [B, H, W, C].
int samroad_proj_ln_mlp_residual_grid(const void* x, const void* a, const void* wp,
                                      const void* bp, const void* ln_s, const void* ln_b,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, void* x1, void* mid, void* out, int B,
                                      int H, int W, int Hp, int Wp, int C, int F,
                                      void* stream) {
  if (bad_grid(B, H, W, Hp, Wp)) return (int)cudaErrorInvalidValue;
  return proj_ln_mlp_residual<true>(x, a, wp, bp, ln_s, ln_b, w1, b1, w2, b2, x1, mid, out,
                                    B * H * W, C, F, reinterpret_cast<cudaStream_t>(stream),
                                    GridMap{H, W, Hp, Wp});
}

}  // extern "C"
