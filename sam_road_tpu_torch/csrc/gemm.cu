// bf16 tensor-core GEMM with LayerNorm prologue and bias / GELU / residual
// epilogues: the CUDA kernels behind K1 (ln_dense) and K4
// (proj_ln_mlp_residual) of sam_road_tpu_torch/ops/fused_ln.py, their grid
// modes K7 and K8, K9 (ln_mlp_residual) and the tool kernel T6
// (merge_dense).
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
// Only the warpgroup product (wgmma) reaches that rate, so the main loop is
// built on it, warp-specialised:
// - A block computes a 128 x BN tile of C (BN 256 where N % 256 == 0, else
//   128) with two consumer warpgroups of 64 rows; each issues
//   wgmma.mma_async m64n{BN}k16 with both operands read from shared memory
//   through descriptors and the fp32 accumulator in registers (128 floats a
//   thread at BN 256). A third, producer warpgroup fills the ring.
// - K tiles are BK = 64 deep, so a tile row is exactly 128 bytes, and A and
//   B tiles sit in wgmma's 128-byte-swizzled K-major layout (chunk c of row
//   r at chunk c ^ (r % 8)): conflict-free for the copies and for wgmma.
//   They rotate through a 4-stage ring (48 KB a stage at BN 256: 193 KB a
//   block, one block an SM), each stage with a full and an empty mbarrier:
//   the producer waits for a stage's release, fills it and signals it full;
//   the consumers wait for it, issue its products and release it once those
//   have completed (one wgmma group stays in flight). A warp arrives once
//   (lane 0, after the warp-wide wgmma wait or __syncwarp). No block-wide
//   barrier in the loop.
// - Copies: B (the weights, [N, K] K-major) arrives by TMA, one 64 x BN box
//   a stage, and so does A where it is bf16 on flat rows (A_BF16); the
//   tensor maps are encoded on the host per launch (cuTensorMapEncodeTiled,
//   reached through cudaGetDriverEntryPoint, so no -lcuda) and passed as
//   __grid_constant__ parameters. Otherwise (the LN modes, and A_GRID's
//   mapped rows) the producer's 128 threads load A's chunks into registers
//   one tile ahead (through map_row), apply the LN and round to bf16 there,
//   store them into the swizzled slot, and arrive on the stage's barrier
//   after a proxy fence.
// - LN statistics are computed once per row by ln_stats_kernel (one warp a
//   row, two-pass fp32: the Pallas kernel's mean((x - mu)^2), eps 1e-6) into
//   a caller-allocated [M] float2 scratch, not once per column block.
// - The epilogue runs straight from the accumulators: each thread owns two
//   rows and pairs of neighbouring columns (mma.sync's C layout per warp).
//
// C = epilogue(prologue(A) . B^T):  A [M, K], B [N, K] (nn.Linear layout),
// both K-contiguous. Prologue modes:
//   A_BF16     A as it is (bf16);
//   A_LN_BF16  LayerNorm(A) with fp32 statistics (eps 1e-6), bf16 A;
//   A_LN_F32   the same over an fp32 A (K4's x1, kept in fp32).
// The LN output is rounded to bf16 before the product, as the Pallas
// kernels do. Epilogue, in fp32 and in this order: + bias, GELU (exact
// erf), + residual (bf16 or fp32); stored as bf16 or fp32.
// Requires N % 128 == 0, K % 64 == 0 and 16-byte aligned pointers (the
// Python wrapper checks); M is arbitrary.
//
// Grid addressing (the PAD_FREE path of the windowed blocks): the M rows are
// the tokens m = (b, y, x) of a [B, H, W] grid, and A (A_GRID) or C (C_GRID)
// lives on the window-padded [B, Hp, Wp] grid, so row m is read or written
// at padded row (b * Hp + y) * Wp + x. Only the address changes: the
// instruction sequence, the k order of the product and the epilogue depend
// on the prologue and epilogue modes alone, so real tokens come out
// bit-equal to the flat mode.
//   K7 ln_dense_padded (replaces sam_road_tpu/ops/fused_ln.py::ln_dense_padded,
//      _ln_dense_padded_kernel): K1 with C_GRID, then zero_pad_kernel writes
//      the pad positions (and only those) with zeros. Bound like K1 by the
//      tensor cores; it saves the F.pad pass over the padded qkv grid.
//   K8 proj_ln_mlp_residual_grid (replaces fused_ln.py::proj_ln_mlp_residual_grid,
//      _proj_ln_mlp_grid_kernel): K4 whose first launch reads the attention
//      output with A_GRID; it saves the crop copy before the tail.
//
// K9 ln_mlp_residual (replaces sam_road_tpu/ops/fused_ln.py::ln_mlp_residual,
// _ln_mlp_kernel): K4's last launches over a bf16 input, with no new
// arithmetic: mid = GELU(LN(x) . W1 + b1) with A_LN_BF16, then
// out = x + b2 + mid . W2 with RES_BF16 (the residual is x itself, where K4's
// is its fp32 x1). Bound by the tensor cores (309 GFLOP per call at
// M = 32768, C = 768, hidden 3072); the TPU kernel keeps the hidden in VMEM,
// here it makes one bf16 round trip through HBM (0.4 GB).
//
// T6 merge_dense (replaces tools/probe_mosaic.py::mk_merge, the probe of a
// (G, NP, C) -> (G NP, C) merge in VMEM before a dot): out = x . W^T over
// the rows of x [32, NP, 256] read flat (the merge is a view here), A_BF16
// with no bias or residual. W is read as [N, K] like every other instance;
// the caller transposes the probe's [in, out] W once. M = 32 NP is 6272 =
// 49 x 128 at NP 196 and 6400 = 50 x 128 at NP 200, so neither has a ragged
// row tile (the Mosaic question has no counterpart here). Bound by launch
// latency: 0.8 GFLOP against 6.6 MB, about 2 us at the HBM peak.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

using namespace samroad_mma;

namespace {

constexpr int BM = 128, BK = 64, STAGES = 4;
constexpr int PRODUCER = 128, CONSUMERS = 256;  // one producer, two consumer warpgroups
constexpr int THREADS = PRODUCER + CONSUMERS;
constexpr int A_TILE = BM * BK * 2;             // bytes of an A stage
constexpr int PCHUNKS = BM * BK / 8 / PRODUCER; // 16-byte A chunks a producer thread a tile

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

struct Params {
  const bf16* bias;    // [N] or null
  const void* res;     // [M, N] bf16 or fp32 (RES_*), flat rows
  void* C;             // [M, N] (or the padded grid, C_GRID)
  const bf16 *ln_s, *ln_b;  // [K], LN modes
  const float2* stats;      // [M] (mean, rstd), LN modes
  int M, N, K;
  GridMap g;
};

// dynamic shared memory: 1024 bytes of alignment slack, the A ring, the B
// ring, two mbarriers a stage (full, empty)
template <int BN>
constexpr int smem_bytes() {
  return 1024 + STAGES * (A_TILE + BN * BK * 2) + STAGES * 16;
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
    const float4* p = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(A) + off);
    float4 a = p[0], b = p[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    uint4 u = *reinterpret_cast<const uint4*>(reinterpret_cast<const bf16*>(A) + off);
    bf16x8_to_float(u, f);
  }
}

// LayerNorm statistics of rows [0, M) of A [M, K], one warp a row, two-pass
// in fp32: stats[m] = (mean, rsqrt(mean((x - mean)^2) + 1e-6)).
template <int AM>
__global__ void __launch_bounds__(256) ln_stats_kernel(const void* __restrict__ A,
                                                       float2* __restrict__ stats, int M, int K) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const int64_t arow = (int64_t)row * K;
  float sum = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    float f[8];
    load_a8<AM>(A, arow + k, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += f[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mu = sum / K;
  float sq = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    float f[8];
    load_a8<AM>(A, arow + k, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) sq += (f[i] - mu) * (f[i] - mu);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if (lane == 0) stats[row] = make_float2(mu, rsqrtf(sq / K + 1e-6f));
}

// a 64 x rows box of A [M, K] or B [N, K] at (k0, row0) into a swizzled
// stage, by TMA; rows past the tensor's end arrive as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int k0, int n0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0), "r"(n0)
      : "memory");
}

template <int BN, int AM, bool GELU, int RES, bool OUT_F32, bool A_GRID, bool C_GRID>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
            const void* __restrict__ A, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int B_TILE = BN * BK * 2;  // bytes of a B stage
  constexpr bool A_TMA = AM == A_BF16 && !A_GRID;  // else A goes through the producer's registers
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* As = base;                      // [STAGES][BM rows of 128 bytes]
  unsigned char* Bs = base + STAGES * A_TILE;    // [STAGES][BN rows of 128 bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * B_TILE);  // stage landed
  uint64_t* empty = full + STAGES;                                     // stage consumed

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int M = p.M, N = p.N, K = p.K, KT = K / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // full: the TMA arrival (+ each producer warp's); empty: each consumer warp's
      mbar_init(&full[s], A_TMA ? 1 : 1 + PRODUCER / 32);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();  // the last block-wide barrier: the roles part here for good

  if (wg == 0) {
    // ---- producer warpgroup: fills stage t % STAGES with K tile t once the
    // consumers have released it (round r waits for the release of round r - 1)
    if constexpr (A_TMA) {
      if (tid != 0) return;
      for (int t = 0; t < KT; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], A_TILE + B_TILE);
        tma_load_2d(As + s * A_TILE, &tma, &full[s], t * BK, m0);  // rows past M: zeros
        tma_load_2d(Bs + s * B_TILE, &tmb, &full[s], t * BK, n0);
      }
    } else {
      // A through registers: this thread's chunks are rows i * 16 + tid / 8
      // of the tile, 16-byte column chunk tid % 8; one tile ahead in flight
      const int cc = tid & 7;
      int64_t arow[PCHUNKS];  // the row's element offset in A, or -1 past M
      float mu[PCHUNKS], rs[PCHUNKS];
#pragma unroll
      for (int i = 0; i < PCHUNKS; ++i) {
        const int gm = m0 + i * 16 + (tid >> 3);
        arow[i] = gm < M ? map_row<A_GRID>(gm, p.g) * K : -1;
        if constexpr (AM != A_BF16) {
          const float2 st = gm < M ? p.stats[gm] : make_float2(0.f, 0.f);
          mu[i] = st.x;
          rs[i] = st.y;
        }
      }
      constexpr int RAW = AM == A_LN_F32 ? 2 * PCHUNKS : PCHUNKS;
      uint4 raw[RAW];
      uint4 lns = make_uint4(0u, 0u, 0u, 0u), lnb = lns;
      auto fetch = [&](int t) {  // the raw chunks of tile t (and its LN scale / bias)
        const int k = t * BK + cc * 8;
#pragma unroll
        for (int i = 0; i < PCHUNKS; ++i) {
          const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
          if constexpr (AM == A_LN_F32) {
            const uint4* src =
                reinterpret_cast<const uint4*>(reinterpret_cast<const float*>(A) + arow[i] + k);
            raw[2 * i] = arow[i] >= 0 ? src[0] : zero;
            raw[2 * i + 1] = arow[i] >= 0 ? src[1] : zero;
          } else {
            raw[i] = arow[i] >= 0 ? *reinterpret_cast<const uint4*>(
                                        reinterpret_cast<const bf16*>(A) + arow[i] + k)
                                  : zero;
          }
        }
        if constexpr (AM != A_BF16) {
          lns = *reinterpret_cast<const uint4*>(p.ln_s + k);
          lnb = *reinterpret_cast<const uint4*>(p.ln_b + k);
        }
      };
      fetch(0);
      const uint32_t swz = (uint32_t)((cc ^ ((tid >> 3) & 7)) << 4);  // rows i * 16 + tid / 8
      for (int t = 0; t < KT; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        if (tid == 0) {
          mbar_arrive_expect_tx(&full[s], B_TILE);
          tma_load_2d(Bs + s * B_TILE, &tmb, &full[s], t * BK, n0);
        }
        // A_BF16 (A_GRID) stores the chunks as they are; the LN modes store
        // (x - mean) * rstd * scale + bias, rounded to bf16
        float sv[8], bv[8];
        if constexpr (AM != A_BF16) {
          bf16x8_to_float(lns, sv);
          bf16x8_to_float(lnb, bv);
        }
#pragma unroll
        for (int i = 0; i < PCHUNKS; ++i) {
          uint4 out;
          if constexpr (AM == A_BF16) {
            out = raw[i];
          } else {
            float f[8];
            if constexpr (AM == A_LN_F32) {
              const uint4 a = raw[2 * i], b = raw[2 * i + 1];
              f[0] = __uint_as_float(a.x); f[1] = __uint_as_float(a.y);
              f[2] = __uint_as_float(a.z); f[3] = __uint_as_float(a.w);
              f[4] = __uint_as_float(b.x); f[5] = __uint_as_float(b.y);
              f[6] = __uint_as_float(b.z); f[7] = __uint_as_float(b.w);
            } else {
              bf16x8_to_float(raw[i], f);
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) f[e] = (f[e] - mu[i]) * rs[i] * sv[e] + bv[e];
            out = float_to_bf16x8(f);
          }
          *reinterpret_cast<uint4*>(As + s * A_TILE + (i * 16 + (tid >> 3)) * 128 + swz) = out;
        }
        fence_proxy_async();  // the stores, visible to wgmma (the async proxy)
        __syncwarp();         // ... from the whole warp, which arrives once
        if (lane == 0) mbar_arrive(&full[s]);
        if (t + 1 < KT) fetch(t + 1);  // in flight while the next stage is awaited
      }
    }
    return;
  }

  // ---- consumer warpgroups 1 and 2: rows (wg - 1) * 64 .. of the tile
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const uint32_t a_wg = (wg - 1) * 64 * 128;  // this warpgroup's 64 rows of an A stage
  for (int t = 0; t < KT; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint64_t da = wgmma_desc_sw128(As + s * A_TILE + a_wg);
    const uint64_t db = wgmma_desc_sw128(Bs + s * B_TILE);
    __syncwarp();  // wgmma.fence and wgmma are .aligned: the warp must be converged
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_ss<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // tile t - 1's products have completed (the whole warpgroup's)
    if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);  // release its stage
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue from the accumulators: warp w of the warpgroup holds rows
  // 16 w + g and 16 w + g + 8, n8 tile t's columns 8 t + 2 tq, + 1
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = m0 + (wg - 1) * 64 + (warp & 3) * 16 + g + 8 * h;
    if (gm >= M) continue;
    const int64_t off = (int64_t)gm * N, c_off = map_row<C_GRID>(gm, p.g) * N;
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
      const int n = n0 + 8 * t + 2 * tq;
      float v0 = acc[4 * t + 2 * h], v1 = acc[4 * t + 2 * h + 1];
      if (p.bias) {
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.bias + n));
        v0 += b.x;
        v1 += b.y;
      }
      if constexpr (GELU) {
        v0 = gelu_erf(v0);
        v1 = gelu_erf(v1);
      }
      if constexpr (RES == RES_BF16) {
        const bf16* res = reinterpret_cast<const bf16*>(p.res) + off + n;
        const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res));
        v0 += r.x;
        v1 += r.y;
      } else if constexpr (RES == RES_F32) {
        const float* res = reinterpret_cast<const float*>(p.res) + off + n;
        const float2 r = *reinterpret_cast<const float2*>(res);
        v0 += r.x;
        v1 += r.y;
      }
      if constexpr (OUT_F32)
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.C) + c_off + n) = make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(p.C) + c_off + n) = pack_bf16(v0, v1);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, without linking libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                                                : nullptr;
  }();
  return fn;
}

// X [N, K] bf16 as 64 x rows boxes (one K tile of `rows` rows), 128-byte swizzle
int encode_tiles(CUtensorMap* map, const void* B, int N, int K, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(B), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

constexpr int MAX_DEVICES = 64;

template <int BN, int AM, bool GELU, int RES, bool OUT_F32, bool A_GRID, bool C_GRID>
int launch_bn(const void* A, const void* B, const Params& p, cudaStream_t stream) {
  CUtensorMap ma{}, mb{};  // ma only where A arrives by TMA (A_BF16 on flat rows)
  int e = encode_tiles(&mb, B, p.N, p.K, BN);
  if (!e && AM == A_BF16 && !A_GRID) e = encode_tiles(&ma, A, p.M, p.K, BM);
  if (e) return e;
  auto kernel = gemm_kernel<BN, AM, GELU, RES, OUT_F32, A_GRID, C_GRID>;
  constexpr int bytes = smem_bytes<BN>();
  // once per instance and device: one process may launch on several cards
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    const int attr =
        (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr) return attr;
    attr_set[dev] = true;
  }
  dim3 grid(p.N / BN, (p.M + BM - 1) / BM);
  kernel<<<grid, THREADS, bytes, stream>>>(ma, mb, A, p);
  return (int)cudaGetLastError();
}

// C = epilogue(prologue(A) . B^T), the block 256 wide where N allows
template <int AM, bool GELU, int RES, bool OUT_F32, bool A_GRID = false, bool C_GRID = false>
int launch(const void* A, const void* B, Params p, cudaStream_t stream) {
  if (p.N % 256 == 0)
    return launch_bn<256, AM, GELU, RES, OUT_F32, A_GRID, C_GRID>(A, B, p, stream);
  return launch_bn<128, AM, GELU, RES, OUT_F32, A_GRID, C_GRID>(A, B, p, stream);
}

// stats[m] = the LN statistics of row m of A [M, K]
template <int AM>
int ln_stats(const void* A, void* stats, int M, int K, cudaStream_t stream) {
  ln_stats_kernel<AM><<<(M + 7) / 8, 256, 0, stream>>>(A, reinterpret_cast<float2*>(stats), M, K);
  return (int)cudaGetLastError();
}

Params params(const void* bias, const void* res, void* C, const void* ln_s, const void* ln_b,
              const void* stats, int M, int N, int K, GridMap g = GridMap{0, 0, 0, 0}) {
  return Params{reinterpret_cast<const bf16*>(bias), res, C, reinterpret_cast<const bf16*>(ln_s),
                reinterpret_cast<const bf16*>(ln_b), reinterpret_cast<const float2*>(stats),
                M, N, K, g};
}

bool bad_shape(int M, int N, int K) { return M <= 0 || N <= 0 || K <= 0 || N % 128 || K % BK; }

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

// K4's launches; A_GRID reads the attention output `a` on the padded grid.
template <bool A_GRID>
int proj_ln_mlp_residual(const void* x, const void* a, const void* wp, const void* bp,
                         const void* ln_s, const void* ln_b, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* x1, void* stats, void* mid,
                         void* out, int M, int C, int F, cudaStream_t s, GridMap g) {
  if (bad_shape(M, C, C) || bad_shape(M, F, F)) return (int)cudaErrorInvalidValue;
  int e = launch<A_BF16, false, RES_BF16, true, A_GRID>(
      a, wp, params(bp, x, x1, nullptr, nullptr, nullptr, M, C, C, g), s);
  if (!e) e = ln_stats<A_LN_F32>(x1, stats, M, C, s);
  if (!e)
    e = launch<A_LN_F32, true, RES_NONE, false>(
        x1, w1, params(b1, nullptr, mid, ln_s, ln_b, stats, M, F, C), s);
  if (!e)
    e = launch<A_BF16, false, RES_F32, false>(
        mid, w2, params(b2, x1, out, nullptr, nullptr, nullptr, M, C, F), s);
  return e;
}

bool bad_grid(int B, int H, int W, int Hp, int Wp) {
  return B <= 0 || H <= 0 || W <= 0 || Hp < H || Wp < W;
}

}  // namespace

extern "C" {

// K1: out[M, N] bf16 = LN(x[M, K]) . w[N, K]^T (+ bias[N] when not null);
// stats is [M] float2 scratch.
int samroad_ln_dense(const void* x, const void* ln_s, const void* ln_b, const void* w,
                     const void* bias, void* stats, void* out, int M, int N, int K,
                     void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bad_shape(M, N, K)) return (int)cudaErrorInvalidValue;
  int e = ln_stats<A_LN_BF16>(x, stats, M, K, s);
  if (!e)
    e = launch<A_LN_BF16, false, RES_NONE, false>(
        x, w, params(bias, nullptr, out, ln_s, ln_b, stats, M, N, K), s);
  return e;
}

// K4 on one stream:
//   x1[M, C] f32   = x + a . wp^T + bp
//   stats          = the LN statistics of x1's rows
//   mid[M, F] bf16 = GELU(LN2(x1) . w1^T + b1)
//   out[M, C] bf16 = x1 + b2 + mid . w2^T
// x1, stats ([M] float2) and mid are caller-allocated scratch.
int samroad_proj_ln_mlp_residual(const void* x, const void* a, const void* wp, const void* bp,
                                 const void* ln_s, const void* ln_b, const void* w1,
                                 const void* b1, const void* w2, const void* b2, void* x1,
                                 void* stats, void* mid, void* out, int M, int C, int F,
                                 void* stream) {
  return proj_ln_mlp_residual<false>(x, a, wp, bp, ln_s, ln_b, w1, b1, w2, b2, x1, stats, mid,
                                     out, M, C, F, reinterpret_cast<cudaStream_t>(stream),
                                     GridMap{0, 0, 0, 0});
}

// K9 on one stream:
//   mid[M, F] bf16 = GELU(LN(x) . w1^T + b1)
//   out[M, C] bf16 = x + b2 + mid . w2^T
// stats ([M] float2) and mid are caller-allocated scratch.
int samroad_ln_mlp_residual(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* stats,
                            void* mid, void* out, int M, int C, int F, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bad_shape(M, C, C) || bad_shape(M, F, F)) return (int)cudaErrorInvalidValue;
  int e = ln_stats<A_LN_BF16>(x, stats, M, C, s);
  if (!e)
    e = launch<A_LN_BF16, true, RES_NONE, false>(
        x, w1, params(b1, nullptr, mid, ln_s, ln_b, stats, M, F, C), s);
  if (!e)
    e = launch<A_BF16, false, RES_BF16, false>(
        mid, w2, params(b2, x, out, nullptr, nullptr, nullptr, M, C, F), s);
  return e;
}

// K7: out[B, Hp, Wp, N] bf16 = LN(x[B, H, W, K]) . w[N, K]^T on the real
// tokens (bias-free), zeros at the pad positions; stats is [B H W] float2.
int samroad_ln_dense_padded(const void* x, const void* ln_s, const void* ln_b, const void* w,
                            void* stats, void* out, int B, int H, int W, int Hp, int Wp, int N,
                            int K, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bad_grid(B, H, W, Hp, Wp) || bad_shape(B * H * W, N, K)) return (int)cudaErrorInvalidValue;
  const GridMap g{H, W, Hp, Wp};
  const int M = B * H * W;
  int e = ln_stats<A_LN_BF16>(x, stats, M, K, s);
  if (!e)
    e = launch<A_LN_BF16, false, RES_NONE, false, false, true>(
        x, w, params(nullptr, nullptr, out, ln_s, ln_b, stats, M, N, K, g), s);
  if (e) return e;
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
                                      const void* b2, void* x1, void* stats, void* mid,
                                      void* out, int B, int H, int W, int Hp, int Wp, int C,
                                      int F, void* stream) {
  if (bad_grid(B, H, W, Hp, Wp)) return (int)cudaErrorInvalidValue;
  return proj_ln_mlp_residual<true>(x, a, wp, bp, ln_s, ln_b, w1, b1, w2, b2, x1, stats, mid,
                                    out, B * H * W, C, F, reinterpret_cast<cudaStream_t>(stream),
                                    GridMap{H, W, Hp, Wp});
}

// T6: out[M, N] bf16 = x[M, K] . w[N, K]^T, no bias.
int samroad_merge_dense(const void* x, const void* w, void* out, int M, int N, int K,
                        void* stream) {
  if (bad_shape(M, N, K)) return (int)cudaErrorInvalidValue;
  return launch<A_BF16, false, RES_NONE, false>(
      x, w, params(nullptr, nullptr, out, nullptr, nullptr, nullptr, M, N, K),
      reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
