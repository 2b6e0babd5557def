// softmax(q . k^T) . v with the decomposed rel-pos already folded into the
// contraction: the CUDA kernel behind K5 (fused_attention) of
// sam_road_tpu_torch/ops/attention.py.
//
// Replaces sam_road_tpu/ops/attention.py::fused_attention (_flash_forward:
// the whole-N _flash_kernel and the kv-tiled _blocked_kernel). The Pallas
// kernels hold a whole (batch, head)'s N x N fp32 scores in VMEM when they
// fit and tile the keys otherwise; a Hopper SM has 227 KB of shared memory,
// so this kernel tiles the keys at every N (flash attention): one block per
// (batch x head, 64-query tile), 4 warps of 16 query rows, 64-key tiles of k
// and v in shared memory, an fp32 online softmax, bf16(p) . v accumulated in
// fp32 and divided by the running sum at the end.
//
// q and k are [BH, N, D] and v is [BH, N, DV], bf16 and contiguous. D and N
// are runtime values: D = head_dim + H + W (92 for 14 x 14 windows, 128 for
// the 32 x 32 global grid at 512 px, 192 for 64 x 64 at 1024 px), N = H * W
// (196, 1024, 4096). N need not be a multiple of the tile: keys past N are
// masked with -inf and queries past N are not stored. D need not be a
// multiple of the mma depth 16: the tiles are zero-filled up to it in shared
// memory. The one-hot position columns of k arrive as they are (exact in
// bf16). q arrives scaled.
// What bounds it on the H100: 2 x N^2 x (D + DV) FLOP per (batch, head)
// against 2 x N x (2 D + 2 DV) bytes, so compute, at the rate this simple
// wmma (mma.sync) version reaches. Its overheads, left for later work: the
// Q fragments are reloaded from shared memory for every 16-key slice, k and
// v tiles are not double-buffered, and the output is rescaled through
// shared memory on every key tile.

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
constexpr int MAX_DV = 128;
constexpr size_t MAX_SMEM = 232448;  // 227 KB a block can use on Hopper

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout for one (D, DV): the block's Q, K and V tiles, then
// one region per warp with its scores (also its p . v), running output,
// probabilities and row statistics. Strides are padded by 8 bf16 / 4 fp32
// elements, multiples of 16 bytes as wmma needs.
struct Layout {
  int dp;                 // D rounded up to 16
  int ldq, ldv, ldp;      // bf16 row strides of Q/K, V, P
  int lds, ldo;           // fp32 row strides of S (scores, p . v), O
  size_t off_k, off_v, off_w, warp_bytes;
  size_t off_o, off_p, off_st;  // inside a warp's region
  size_t total;
};

__host__ __device__ inline Layout make_layout(int D, int DV) {
  Layout L;
  L.dp = (D + 15) / 16 * 16;
  L.ldq = L.dp + 8;
  L.ldv = DV + 8;
  L.ldp = BKV + 8;
  L.lds = (BKV > DV ? BKV : DV) + 4;
  L.ldo = DV + 4;
  L.off_k = align128((size_t)BQ * L.ldq * sizeof(bf16));
  L.off_v = L.off_k + align128((size_t)BKV * L.ldq * sizeof(bf16));
  L.off_w = L.off_v + align128((size_t)BKV * L.ldv * sizeof(bf16));
  L.off_o = align128((size_t)16 * L.lds * sizeof(float));
  L.off_p = L.off_o + align128((size_t)16 * L.ldo * sizeof(float));
  L.off_st = L.off_p + align128((size_t)16 * L.ldp * sizeof(bf16));
  L.warp_bytes = L.off_st + align128(3 * 16 * sizeof(float));
  L.total = L.off_w + WARPS * L.warp_bytes;
  return L;
}

// Rows [r0, r0 + 64) of a row-major [N, W] bf16 matrix into a [64][ld]
// shared tile, zero-filling rows >= N and columns [W, WP). With vec (W % 8
// == 0 and a 16-byte aligned matrix) 8 elements move per load, otherwise 2
// (W is even).
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, int r0, int N,
                                          int W, int WP, bool vec, int tid) {
  if (vec) {
    const int per_row = WP / 8;
    for (int e = tid; e < 64 * per_row; e += THREADS) {
      const int r = e / per_row, c = (e % per_row) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < N && c < W)
        val = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * W + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    const int per_row = WP / 2;
    for (int e = tid; e < 64 * per_row; e += THREADS) {
      const int r = e / per_row, c = (e % per_row) * 2;
      uint32_t val = 0u;
      if (r0 + r < N && c < W)
        val = *reinterpret_cast<const uint32_t*>(src + (int64_t)(r0 + r) * W + c);
      *reinterpret_cast<uint32_t*>(dst + r * ld + c) = val;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int N, int D,
                       int DV) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(D, DV);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + L.off_k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L.off_v);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* wbase = smem + L.off_w + warp * L.warp_bytes;
  float* S = reinterpret_cast<float*>(wbase);
  float* O = reinterpret_cast<float*>(wbase + L.off_o);
  bf16* P = reinterpret_cast<bf16*>(wbase + L.off_p);
  float* row_m = reinterpret_cast<float*>(wbase + L.off_st);
  float* row_l = row_m + 16;
  float* row_a = row_m + 32;

  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + bh * N * D;
  const bf16* kb = k + bh * N * D;
  const bf16* vb = v + bh * N * DV;
  const bool vec_qk = (D % 8) == 0;

  load_tile(sQ, L.ldq, qb, q0, N, D, L.dp, vec_qk, tid);
  for (int e = lane; e < 16 * DV; e += 32) O[(e / DV) * L.ldo + e % DV] = 0.f;
  if (lane < 16) {
    row_m[lane] = -INFINITY;
    row_l[lane] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += BKV) {
    __syncthreads();  // the previous k / v tiles are consumed
    load_tile(sK, L.ldq, kb, k0, N, D, L.dp, vec_qk, tid);
    load_tile(sV, L.ldv, vb, k0, N, DV, DV, true, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 queries and the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int d = 0; d < L.dp; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + warp * 16 * L.ldq + d, L.ldq);
        wmma::load_matrix_sync(fb, sK + kk * 16 * L.ldq + d, L.ldq);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(S + kk * 16, acc, L.lds, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time; lane j holds keys j and j + 32
    const int nvalid = min(BKV, N - k0);
    for (int r = 0; r < 16; ++r) {
      const float s0 = lane < nvalid ? S[r * L.lds + lane] : -INFINITY;
      const float s1 = lane + 32 < nvalid ? S[r * L.lds + lane + 32] : -INFINITY;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);  // finite: every tile has a valid key
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      P[r * L.ldp + lane] = __float2bfloat16_rn(p0);
      P[r * L.ldp + lane + 32] = __float2bfloat16_rn(p1);
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        row_a[r] = a;
        row_l[r] = row_l[r] * a + sum;
        row_m[r] = m_new;
      }
      __syncwarp();
    }

    // S = P V (16 x DV), then O = O * alpha + S
    for (int d = 0; d < DV; d += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, P + kk * 16, L.ldp);
        wmma::load_matrix_sync(fb, sV + kk * 16 * L.ldv + d, L.ldv);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(S + d, acc, L.lds, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * DV; e += 32) {
      const int r = e / DV, d = e % DV;
      O[r * L.ldo + d] = O[r * L.ldo + d] * row_a[r] + S[r * L.lds + d];
    }
    __syncwarp();
  }

  for (int e = lane; e < 16 * DV; e += 32) {
    const int r = e / DV, d = e % DV;
    const int n = q0 + warp * 16 + r;
    if (n < N) out[(bh * N + n) * DV + d] = __float2bfloat16_rn(O[r * L.ldo + d] / row_l[r]);
  }
}

}  // namespace

extern "C" {

// q, k: [BH, N, D] bf16 (q scaled); v, out: [BH, N, DV] bf16; all contiguous
// and 16-byte aligned. D even, DV a multiple of 16 up to 128.
int samroad_flash_attention(const void* q, const void* k, const void* v, void* out, int BH,
                            int N, int D, int DV, void* stream) {
  if (BH <= 0 || N <= 0 || D <= 0 || D % 2 || DV <= 0 || DV % 16 || DV > MAX_DV)
    return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(D, DV);
  if (L.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int bytes = (int)L.total;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BQ - 1) / BQ, BH);
  flash_attention_kernel<<<grid, THREADS, bytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const bf16*>(q), reinterpret_cast<const bf16*>(k),
      reinterpret_cast<const bf16*>(v), reinterpret_cast<bf16*>(out), N, D, DV);
  return (int)cudaGetLastError();
}

}  // extern "C"
